"""Carry data and solver state across from the JAX package as numpy.

The JAX package's fields come over as numpy arrays (``np.asarray`` of a
JAX array), so tests and users can feed one problem or resume one state
in both packages. bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) are
carried bit for bit. ``device=None`` means :func:`runtime.default_device`:
the card when there is one.

The TPU kernels keep per-row (N,) vectors — coefficient tables, offsets,
dequant scales — in an (8, N/8) slab whose row-major flattening is the
natural order (entry i at (i // (N/8), i % (N/8))); the port's are flat
(N,), so every per-row field is flattened row-major on the way in.
"""

from __future__ import annotations

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.solvers.base import Status
from ciao_tpu_torch.solvers.fb import FBState
from ciao_tpu_torch.solvers.saga import SAGAState
from ciao_tpu_torch.solvers.svrg import SVRGState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A tensor with the array's dtype and values on ``device``."""
    device = runtime.default_device() if device is None else device
    a = np.array(a, order="C")  # a copy: the tensor never aliases the array
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _flat(a, device):
    return tensor_from_numpy(np.asarray(a).reshape(-1), device)


def least_squares_from_numpy(A, b, scale, row_scale=None,
                             device=None) -> LeastSquaresRows:
    """``LeastSquaresRows`` from the JAX oracle's fields ``A`` (f32,
    bf16 or int8), ``b``, ``scale`` and, for int8 rows, ``row_scale``."""
    return LeastSquaresRows(
        tensor_from_numpy(A, device), tensor_from_numpy(b, device),
        tensor_from_numpy(scale, device),
        None if row_scale is None else tensor_from_numpy(row_scale, device),
    )


def saga_state_from_numpy(s, z, av, gamma, it, seed: int = 0,
                          device=None, qcum=None, qinv=None) -> SAGAState:
    """``SAGAState`` from the JAX state's ``s``, ``z``, ``av``, ``gamma``
    and ``it`` (and, under importance sampling, ``qcum`` and ``qinv``).
    A coefficient table in the slab layout is flattened; the streamed
    route's table is (N,) already."""
    return SAGAState(
        s=_flat(s, device), gamma=tensor_from_numpy(gamma, device),
        av=_flat(av, device), z=_flat(z, device),
        seed=int(seed), it=int(it), status=int(Status.RUNNING),
        qcum=None if qcum is None else tensor_from_numpy(qcum, device),
        qinv=None if qinv is None else tensor_from_numpy(qinv, device),
    )


def svrg_state_from_numpy(gamma, m, av, z, z_full, w, it, seed: int = 0,
                          canch=None, device=None) -> SVRGState:
    """``SVRGState`` from the JAX state's fields. The fused route's anchor
    coefficients ``canch``, an (8, N/8) slab there, become the flat (N,)
    table; None (the stepwise routes) stays None."""
    return SVRGState(
        gamma=tensor_from_numpy(gamma, device), m=int(m),
        av=_flat(av, device), z=_flat(z, device),
        z_full=_flat(z_full, device), w=_flat(w, device),
        seed=int(seed), it=int(it), status=int(Status.RUNNING),
        canch=None if canch is None else _flat(canch, device),
    )


def fb_state_from_numpy(gamma, t, x, y, it, device=None) -> FBState:
    """``FBState`` from the JAX state's ``gamma``, ``t``, ``x``, ``y`` and
    ``it``."""
    return FBState(
        gamma=tensor_from_numpy(gamma, device),
        t=tensor_from_numpy(t, device), x=_flat(x, device),
        y=_flat(y, device), it=int(it), status=int(Status.RUNNING),
    )
