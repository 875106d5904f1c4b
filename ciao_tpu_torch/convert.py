"""Carry data and solver state across from the JAX package as numpy.

The JAX package's fields come over as numpy arrays (``np.asarray`` of a
JAX array), so tests and users can feed one problem or resume one state
in both packages. bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) are
carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.solvers.base import Status
from ciao_tpu_torch.solvers.saga import SAGAState


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A tensor with the array's dtype and values on ``device``."""
    a = np.array(a, order="C")  # a copy: the tensor never aliases the array
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def least_squares_from_numpy(A, b, scale, row_scale=None,
                             device="cpu") -> LeastSquaresRows:
    """``LeastSquaresRows`` from the JAX oracle's fields ``A`` (f32,
    bf16 or int8), ``b``, ``scale`` and, for int8 rows, ``row_scale``."""
    return LeastSquaresRows(
        tensor_from_numpy(A, device), tensor_from_numpy(b, device),
        tensor_from_numpy(scale, device),
        None if row_scale is None else tensor_from_numpy(row_scale, device),
    )


def saga_state_from_numpy(s, z, av, gamma, it, seed: int = 0,
                          device="cpu", qcum=None, qinv=None) -> SAGAState:
    """``SAGAState`` from the JAX state's ``s``, ``z``, ``av``, ``gamma``
    and ``it`` (and, under importance sampling, ``qcum`` and ``qinv``).
    A coefficient table in the TPU's (8, N/8) slab layout is flattened
    row-major, which is its natural order (c_i at (i // (N/8),
    i % (N/8))); the streamed route's table is (N,) already."""
    return SAGAState(
        s=tensor_from_numpy(np.asarray(s).reshape(-1), device),
        gamma=tensor_from_numpy(gamma, device),
        av=tensor_from_numpy(np.asarray(av).reshape(-1), device),
        z=tensor_from_numpy(np.asarray(z).reshape(-1), device),
        seed=int(seed), it=int(it), status=int(Status.RUNNING),
        qcum=None if qcum is None else tensor_from_numpy(qcum, device),
        qinv=None if qinv is None else tensor_from_numpy(qinv, device),
    )
