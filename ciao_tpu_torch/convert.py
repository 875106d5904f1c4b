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
Tables of rows ((N, n) tables, Finito's (d, n) anchors ``zb``) and
per-block vectors (``invg``) come over as they are. A sweep state brings
its ``pos`` and ``order``; JAX's PRNG key does not come over (the port's
draws are its own, from ``seed``).
"""

from __future__ import annotations

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles import (
    HuberRows, LeastSquaresRows, LogisticRows, PoissonRows, SquaredHingeRows,
)
from ciao_tpu_torch.solvers.base import Status
from ciao_tpu_torch.sampling import SweepState
from ciao_tpu_torch.solvers.fb import FBState
from ciao_tpu_torch.solvers.katyusha import KatyushaState
from ciao_tpu_torch.solvers.panoc import PANOCState
from ciao_tpu_torch.solvers.lsvrg import LKatyushaState, LSVRGState
from ciao_tpu_torch.solvers.sarah import SARAHState
from ciao_tpu_torch.solvers.finito import (
    FinitoAdaptiveState, FinitoBasicState, FinitoCoeffState, LFinitoState,
)
from ciao_tpu_torch.solvers.point_saga import PointSAGAState
from ciao_tpu_torch.solvers.proshi import ProshiState
from ciao_tpu_torch.solvers.saga import SAGAState
from ciao_tpu_torch.solvers.ssnm import SSNMState
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


def least_squares_from_numpy(A, b, scale, row_scale=None, device=None,
                             supports_coeff: bool = True) -> LeastSquaresRows:
    """``LeastSquaresRows`` from the JAX oracle's fields ``A`` (f32,
    bf16 or int8), ``b``, ``scale``, for int8 rows ``row_scale``, and
    ``supports_coeff``."""
    return LeastSquaresRows(
        tensor_from_numpy(A, device), tensor_from_numpy(b, device),
        tensor_from_numpy(scale, device),
        None if row_scale is None else tensor_from_numpy(row_scale, device),
        supports_coeff=supports_coeff,
    )


def _rs(row_scale, device):
    return None if row_scale is None else tensor_from_numpy(row_scale, device)


def logistic_from_numpy(X, y, row_scale=None, device=None,
                        supports_coeff: bool = True) -> LogisticRows:
    """``LogisticRows`` from the JAX oracle's fields ``X`` (f32, bf16 or
    int8), ``y``, for int8 rows ``row_scale``, and ``supports_coeff``."""
    return LogisticRows(tensor_from_numpy(X, device),
                        tensor_from_numpy(y, device),
                        row_scale=_rs(row_scale, device),
                        supports_coeff=supports_coeff)


def huber_from_numpy(A, b, delta, scale, row_scale=None, device=None,
                     supports_coeff: bool = True) -> HuberRows:
    """``HuberRows`` from the JAX oracle's fields ``A``, ``b``, ``delta``,
    ``scale``, for int8 rows ``row_scale``, and ``supports_coeff``."""
    return HuberRows(tensor_from_numpy(A, device), tensor_from_numpy(b, device),
                     delta=tensor_from_numpy(delta, device),
                     scale=tensor_from_numpy(scale, device),
                     row_scale=_rs(row_scale, device),
                     supports_coeff=supports_coeff)


def sqhinge_from_numpy(A, y, scale, row_scale=None, device=None,
                       supports_coeff: bool = True) -> SquaredHingeRows:
    """``SquaredHingeRows`` from the JAX oracle's fields ``A``, ``y``,
    ``scale``, for int8 rows ``row_scale``, and ``supports_coeff``."""
    return SquaredHingeRows(tensor_from_numpy(A, device),
                            tensor_from_numpy(y, device),
                            scale=tensor_from_numpy(scale, device),
                            row_scale=_rs(row_scale, device),
                            supports_coeff=supports_coeff)


def poisson_from_numpy(A, y, scale, row_scale=None, device=None,
                       supports_coeff: bool = True) -> PoissonRows:
    """``PoissonRows`` from the JAX oracle's fields ``A``, ``y``,
    ``scale``, for int8 rows ``row_scale``, and ``supports_coeff``."""
    return PoissonRows(tensor_from_numpy(A, device),
                       tensor_from_numpy(y, device),
                       scale=tensor_from_numpy(scale, device),
                       row_scale=_rs(row_scale, device),
                       supports_coeff=supports_coeff)


def saga_state_from_numpy(s, z, av, gamma, it, seed: int = 0,
                          device=None, qcum=None, qinv=None,
                          table: str = "coeff") -> SAGAState:
    """``SAGAState`` from the JAX state's ``s``, ``z``, ``av``, ``gamma``
    and ``it`` (and, under importance sampling, ``qcum`` and ``qinv``).
    A coefficient table in the slab layout is flattened; the streamed
    route's table is (N,) already; ``table="full"`` keeps the (N, n)
    gradient table as it is."""
    if table not in ("coeff", "full"):
        raise ValueError(f"table must be 'coeff' or 'full', not {table!r}")
    return SAGAState(
        s=(tensor_from_numpy(s, device) if table == "full"
           else _flat(s, device)),
        gamma=tensor_from_numpy(gamma, device),
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


def _sweep(pos, order, seed, device) -> SweepState:
    return SweepState(pos=int(pos),
                      order=_flat(order, device).to(torch.int32),
                      seed=int(seed))


def _common(gamma, hat_gamma, av, z, pos, order, it, seed, device):
    return dict(gamma=_flat(gamma, device),
                hat_gamma=tensor_from_numpy(hat_gamma, device),
                av=_flat(av, device), z=_flat(z, device),
                sweep=_sweep(pos, order, seed, device), it=int(it),
                status=int(Status.RUNNING))


def finito_basic_state_from_numpy(s, gamma, hat_gamma, av, z, pos, order,
                                  it, seed: int = 0,
                                  device=None) -> FinitoBasicState:
    """``FinitoBasicState`` from the JAX state's ``s`` (N, n), ``gamma``,
    ``hat_gamma``, ``av``, ``z``, ``sweep.pos``, ``sweep.order`` and
    ``it``."""
    return FinitoBasicState(s=tensor_from_numpy(s, device),
                            **_common(gamma, hat_gamma, av, z, pos, order,
                                      it, seed, device))


def finito_coeff_state_from_numpy(c, zb, invg, gamma, hat_gamma, av, z, pos,
                                  order, it, seed: int = 0, qcum=None,
                                  qinv=None, device=None) -> FinitoCoeffState:
    """``FinitoCoeffState`` from the JAX state's fields: ``c`` flattened
    (an (8, N/8) slab or (N,)), the (d, n) anchors ``zb`` and the (d,)
    ``invg`` as they are, and under importance sampling ``qcum`` and
    ``qinv``."""
    return FinitoCoeffState(
        c=_flat(c, device), zb=tensor_from_numpy(zb, device),
        invg=_flat(invg, device),
        **_common(gamma, hat_gamma, av, z, pos, order, it, seed, device),
        qcum=None if qcum is None else tensor_from_numpy(qcum, device),
        qinv=None if qinv is None else tensor_from_numpy(qinv, device))


def lfinito_state_from_numpy(gamma, hat_gamma, av, z, z_full, pos, order, it,
                             seed: int = 0, device=None) -> LFinitoState:
    """``LFinitoState`` from the JAX state's fields."""
    return LFinitoState(z_full=_flat(z_full, device),
                        **_common(gamma, hat_gamma, av, z, pos, order, it,
                                  seed, device))


def finito_adaptive_state_from_numpy(s, gradf, fi_x, gamma, hat_gamma, av, z,
                                     pos, order, it, seed: int = 0,
                                     device=None) -> FinitoAdaptiveState:
    """``FinitoAdaptiveState`` from the JAX state's tables ``s`` and
    ``gradf`` (N, n), ``fi_x`` (N,) and the other fields."""
    return FinitoAdaptiveState(
        s=tensor_from_numpy(s, device), gradf=tensor_from_numpy(gradf, device),
        fi_x=_flat(fi_x, device),
        **_common(gamma, hat_gamma, av, z, pos, order, it, seed, device))


def proshi_state_from_numpy(s, gamma, hat_gamma, av, z, pos, order, it,
                            seed: int = 0, device=None) -> ProshiState:
    """``ProshiState`` from the JAX state's block table ``s`` (N, n),
    ``gamma``, ``hat_gamma``, ``av``, ``z``, ``sweep.pos``,
    ``sweep.order`` and ``it``."""
    return ProshiState(s=tensor_from_numpy(s, device),
                       **_common(gamma, hat_gamma, av, z, pos, order, it,
                                 seed, device))


def _anchor(canch, device):
    """A fused state's anchor coefficients, an (8, N/8) slab in the JAX
    package, as the flat (N,) table; None (the stepwise routes) stays
    None."""
    return None if canch is None else _flat(canch, device)


def katyusha_state_from_numpy(Lmax, tau1, tau2, av, x_tilde, y, z, it,
                              seed: int = 0, canch=None,
                              device=None) -> KatyushaState:
    """``KatyushaState`` from the JAX state's fields (``canch`` flattened,
    as :func:`svrg_state_from_numpy`'s)."""
    return KatyushaState(
        Lmax=tensor_from_numpy(Lmax, device),
        tau1=tensor_from_numpy(tau1, device),
        tau2=tensor_from_numpy(tau2, device), av=_flat(av, device),
        x_tilde=_flat(x_tilde, device), y=_flat(y, device),
        z=_flat(z, device), seed=int(seed), it=int(it),
        status=int(Status.RUNNING), canch=_anchor(canch, device))


def sarah_state_from_numpy(gamma, eta, x_tilde, it, seed: int = 0,
                           device=None) -> SARAHState:
    """``SARAHState`` from the JAX state's ``gamma``, ``eta``,
    ``x_tilde`` and ``it``."""
    return SARAHState(gamma=tensor_from_numpy(gamma, device),
                      eta=tensor_from_numpy(eta, device),
                      x_tilde=_flat(x_tilde, device), seed=int(seed),
                      it=int(it), status=int(Status.RUNNING))


def lsvrg_state_from_numpy(gamma, p, av, z, w, it, seed: int = 0,
                           canch=None, device=None) -> LSVRGState:
    """``LSVRGState`` from the JAX state's fields; ``p`` comes over as a
    number (the port compares its coins with it in f32)."""
    return LSVRGState(
        gamma=tensor_from_numpy(gamma, device), p=float(np.asarray(p)),
        av=_flat(av, device), z=_flat(z, device), w=_flat(w, device),
        seed=int(seed), it=int(it), status=int(Status.RUNNING),
        canch=_anchor(canch, device))


def lkatyusha_state_from_numpy(Lmax, sigma, theta1, theta2, p, av, w_anchor,
                               y, z, it, seed: int = 0, canch=None,
                               device=None) -> LKatyushaState:
    """``LKatyushaState`` from the JAX state's fields; ``p`` as in
    :func:`lsvrg_state_from_numpy`."""
    return LKatyushaState(
        Lmax=tensor_from_numpy(Lmax, device),
        sigma=tensor_from_numpy(sigma, device),
        theta1=tensor_from_numpy(theta1, device),
        theta2=tensor_from_numpy(theta2, device), p=float(np.asarray(p)),
        av=_flat(av, device), w_anchor=_flat(w_anchor, device),
        y=_flat(y, device), z=_flat(z, device), seed=int(seed), it=int(it),
        status=int(Status.RUNNING), canch=_anchor(canch, device))


def ssnm_state_from_numpy(tau, eta, c, zb, gbar, x, it, seed: int = 0,
                          device=None) -> SSNMState:
    """``SSNMState`` from the JAX state's fields: ``c`` flattened (an
    (8, N/8) slab or (N,)), the (d, n) stored points ``zb`` as they are
    (a copy the state owns, even of a broadcast view)."""
    return SSNMState(
        tau=tensor_from_numpy(tau, device), eta=tensor_from_numpy(eta, device),
        c=_flat(c, device), zb=tensor_from_numpy(zb, device),
        gbar=_flat(gbar, device), x=_flat(x, device), seed=int(seed),
        it=int(it), status=int(Status.RUNNING))


def point_saga_state_from_numpy(gamma, c, av, x, it, seed: int = 0,
                                na8=None, qcum=None, qinv=None,
                                device=None) -> PointSAGAState:
    """``PointSAGAState`` from the JAX state's fields: ``c`` and the kernel
    routes' row square-norms ``na8`` (an (8, N/8) slab or a (1, N) row)
    flattened; under importance sampling ``qcum`` and ``qinv``."""
    return PointSAGAState(
        gamma=tensor_from_numpy(gamma, device), c=_flat(c, device),
        av=_flat(av, device), x=_flat(x, device), seed=int(seed), it=int(it),
        status=int(Status.RUNNING),
        na8=None if na8 is None else _flat(na8, device),
        qcum=None if qcum is None else tensor_from_numpy(qcum, device),
        qinv=None if qinv is None else tensor_from_numpy(qinv, device))


def panoc_state_from_numpy(gamma, sigma, x, fx, gradx, z, gz, fbe, S, Y, rho,
                           head, count, pbase, presid, tau, ls_ewma, it,
                           status, device=None) -> PANOCState:
    """``PANOCState`` from the JAX state's fields (``S``, ``Y`` (mem, n) as
    they are, the ring cursors as int64, the status as an int), so that a
    JAX trajectory goes on in the port."""
    def t(a):
        return tensor_from_numpy(a, device)

    return PANOCState(
        gamma=t(gamma), sigma=t(sigma), x=_flat(x, device), fx=t(fx),
        gradx=_flat(gradx, device), z=_flat(z, device), gz=t(gz), fbe=t(fbe),
        S=t(S), Y=t(Y), rho=_flat(rho, device),
        head=t(np.asarray(head, np.int64)),
        count=t(np.asarray(count, np.int64)), pbase=_flat(pbase, device),
        presid=_flat(presid, device), tau=t(tau),
        ls_ewma=t(np.asarray(ls_ewma, np.float32)), it=int(it),
        status=int(status))
