"""Deep accuracy for the primal-dual class: h(Kx) problems to rel ≤ 1e-6
and far below in f32.

Counterpart of ``ciao_tpu/solvers/deep_pd.py``. Finite-sum problems have
:func:`ciao_tpu_torch.deep_solve`, sharing problems
:func:`ciao_tpu_torch.deep_solve_sharing`, and analysis sparsity gets
:func:`deep_solve_pd`. Two f32 obstacles stand between Condat-Vũ and a
deep target:

* the full-gradient reduction rounds at ~√N·eps relative. Every step
  here takes the compensated chunked mean
  (:func:`solvers.polish.grad_mean_chunked`: exact f32 products a chunk,
  a two-sum carry across chunks) through ``_pd_step``'s ``grad_fn``
  hook, in place of the one-pass gradient of kernel #6;
* the facade's default L_f = mean(L) is the trace of the mean Hessian on
  a dense design, ~n times too conservative a τ. The stepsize here comes
  from the spectral bound :func:`solvers.polish.power_lmax`, with a 1.2
  margin.

A third floor is structural: Condat-Vũ reaches Dx = 0 on the flat runs
only in the limit, so the f32 iterate carries |Dxᵢ| ~ eps·|x| on every
flat coordinate and h(Dx) pays it to first order (rel ≈ (n/jumps)·eps).
Identification of the jump set is finite for this polyhedral problem, so
once the iterate plateaus :func:`tv_refine` solves the k-segment reduced
problem exactly (compensated chunked Gram and right-hand side on the
device, a k×k solve in f64 on the host), certifies it through the
recovered dual and returns the piecewise-constant point, whose flat runs
are exact. :func:`tv_refine3` does the same for λ₁‖x‖₁ + λ₂‖Dx‖₁, with an
interval-propagation certificate.

No kernel serves this route, in either package: the JAX module computes
its products with XLA dots outside Pallas, and the port runs them as
PyTorch ops. The reduced system's A·S is an exact f32 product against
the one-hot (n, k) segment indicator, not a scatter-add, so the
certificate's bits repeat from run to run on the card. Every product
here needs exact f32 (``runtime.require_exact_f32_matmul``); the f64
solves, the iterative refinement and the certificates run on the host in
numpy. Not ported yet: the DP/TP variants (ROADMAP.md, queue 1 item 18).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.ops.fused_block import _two_sum
from ciao_tpu_torch.solvers.base import facade_device
from ciao_tpu_torch.solvers.polish import (
    _require_wide_rows, grad_mean_chunked, power_lmax,
)
from ciao_tpu_torch.solvers.primal_dual import CondatVu, _pd_step, pd_run


def _chunk_of(N: int, chunk: int) -> int:
    c = min(chunk, N)
    while N % c:
        c -= 1
    return c


def pd_run_compensated(F, g, h, K, state, cfg, steps: int, chunk: int):
    """``steps`` Condat-Vũ steps whose full gradient is the compensated
    chunked mean (``grad_mean_chunked``) in place of the one f32
    reduction: ``_pd_step``'s body otherwise, through its ``grad_fn``
    hook. Queued on the device with no host read."""
    def grad_fn(x):
        return grad_mean_chunked(F, x, chunk).to(x.dtype)

    for _ in range(steps):
        state = _pd_step(F, g, h, K, cfg, state, grad_fn=grad_fn)
    return state


def _to_host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _reduced_rows(F, who: str):
    """(rows, offsets) of a least-squares rows oracle with wide storage,
    on a device whose f32 products are exact."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    if not isinstance(F, LeastSquaresRows):
        # the reduced solve is the quadratic normal-equation system: a
        # margin loss would be silently mis-solved
        raise ValueError(
            f"{who} solves the least-squares reduced system; "
            f"{type(F).__name__} is not a LeastSquaresRows oracle")
    _require_wide_rows(F, who)
    rows, offs = F.coeff_rows_data()
    runtime.require_exact_f32_matmul(rows.device, who)
    return rows, offs


def _segments(x, jump_rtol: float, floor: float):
    """(x in f64, jump set J, signs s, k, segment ids) with d = Dx: J =
    {i : |dᵢ| > jump_rtol·max(max|d|, floor)}, s = sign(d)|_J, k = |J| + 1
    segments."""
    x_np = _to_host(x)
    n = x_np.shape[0]
    d = np.diff(x_np)
    theta = jump_rtol * max(np.max(np.abs(d)), floor)
    J = np.nonzero(np.abs(d) > theta)[0]
    s = np.sign(d[J])
    seg_id = np.zeros(n, np.int32)
    seg_id[J + 1] = 1
    seg_id = np.cumsum(seg_id).astype(np.int32)
    return x_np, J, s, len(J) + 1, seg_id


def _indicator(seg_id, k: int, device):
    """The one-hot (n, k) f32 segment indicator S."""
    ids = torch.from_numpy(seg_id.astype(np.int64)).to(device)
    return torch.nn.functional.one_hot(ids, k).to(torch.float32)


def _segment_normal_eq(rows, offs, S, chunk: int):
    """Compensated chunked G = A_SᵀA_S (k, k) and r = A_Sᵀb (k,) for the
    segment-collapsed design A_S = A·S: exact f32 products a chunk,
    two-sum carries across chunks, the (hi, lo) halves added in host f64.
    The reduced system must be deep-grade, or the λ·sᵀDz term pays the
    Gram's rounding to first order."""
    N = rows.shape[0]
    k = S.shape[1]
    Ghi = torch.zeros((k, k), dtype=torch.float32, device=rows.device)
    Glo = torch.zeros_like(Ghi)
    rhi = torch.zeros(k, dtype=torch.float32, device=rows.device)
    rlo = torch.zeros_like(rhi)
    for start in range(0, N, chunk):
        A_B = rows.narrow(0, start, chunk).to(torch.float32)
        b_B = offs.narrow(0, start, chunk).to(torch.float32)
        AS = A_B @ S
        Ghi, Glo = _two_sum(Ghi, Glo, AS.T @ AS)
        rhi, rlo = _two_sum(rhi, rlo, b_B @ AS)
    return _to_host(Ghi) + _to_host(Glo), _to_host(rhi) + _to_host(rlo)


def _tv_cert_grad(rows, offs, S, z, chunk: int):
    """∇(½‖A·Sz − b‖²) = Aᵀ(A_S z − b) at the exact reduced solution ``z``
    (host f64): z rides as a double-single (hi, lo) pair so that its f32
    cast error, which the curvature amplifies to ~0.1·λ through the
    certificate's cumulative sums, cancels. Margins are ordered
    ((m_hi − b) + m_lo); chunks add with a two-sum carry. Returns the
    gradient in host f64 (hi + lo)."""
    N, n = rows.shape
    z_hi = np.asarray(z, np.float32)
    z_lo = np.asarray(z - z_hi.astype(np.float64), np.float32)
    z_hi = torch.from_numpy(z_hi).to(rows.device)
    z_lo = torch.from_numpy(z_lo).to(rows.device)
    hi = torch.zeros(n, dtype=torch.float32, device=rows.device)
    lo = torch.zeros_like(hi)
    for start in range(0, N, chunk):
        A_B = rows.narrow(0, start, chunk).to(torch.float32)
        b_B = offs.narrow(0, start, chunk).to(torch.float32)
        AS = A_B @ S
        r = ((AS @ z_hi) - b_B) + (AS @ z_lo)
        hi, lo = _two_sum(hi, lo, r @ A_B)
    return _to_host(hi) + _to_host(lo)


def tv_refine(F, x, lam: float, *, chunk: int = 4096,
              jump_rtol: float = 1e-3, cert_rtol: float = 0.01):
    """Exact reduced solve of ½‖Ax−b‖² + λ‖Dx‖₁ on the jump set that the
    plateaued iterate identifies:

    1. J = {i : |Dxᵢ| > jump_rtol·max|Dx|}, signs s = sign(Dx)|_J, k =
       |J| + 1 segments;
    2. solve A_SᵀA_S z = A_Sᵀb − λ·D_kᵀs (Gram and right-hand side by
       compensated chunked exact-f32 products on the device, the k×k
       solve on the host in f64), with three rounds of iterative
       refinement;
    3. certify: recover the dual on the flat runs from the compensated
       gradient at x̂ = Sz by the cumulative-sum inverse of Dᵀ, and check
       |vᵢ| ≤ λ(1 + cert_rtol) off J, v = λs on J, and that the solved
       jumps take the assumed signs with a material size.

    Returns ``(x_hat, certified, v)``: x̂ the f32 piecewise-constant
    point on the rows' device, whether the certificate held, and the
    recovered dual (host f64, (n − 1,)). On a failed certificate callers
    keep the unrefined iterate. Least-squares rows with f32 or bf16
    storage only."""
    rows, offs = _reduced_rows(F, "tv_refine")
    N, n = rows.shape
    c = _chunk_of(N, chunk)

    _, J, s, k, seg_id = _segments(x, jump_rtol, 0.0)
    S = _indicator(seg_id, k, rows.device)
    G, r = _segment_normal_eq(rows, offs, S, c)
    # the user objective (1/N)Σfᵢ + λ‖Dx‖₁ is (scale/N)·½‖Ax−b‖² + λ‖Dx‖₁:
    # fold the loss scale into the λ side of the reduced stationarity
    # (scale/N)(Gz − r) + λ·D_kᵀs = 0
    sc = float(F.scale) if hasattr(F, "scale") else float(N)
    lam_eff = lam * N / sc
    # D_kᵀs in segment space: (D_kᵀs)_j = s_{j-1} − s_j (ends pinned)
    Dk_t_s = np.zeros(k)
    Dk_t_s[:-1] -= s
    Dk_t_s[1:] += s
    z = np.linalg.solve(G, r - lam_eff * Dk_t_s)

    # iterative refinement: the f32 Gram's ~eps relative entries leave a
    # z error that the certificate would amplify to first order; each
    # round evaluates the residual with the double-single margin pass
    # (Sᵀw = Gz − r exactly) and corrects
    S_host = np.eye(k)[seg_id]
    for _ in range(3):
        w_un = _tv_cert_grad(rows, offs, S, z, c)
        rho = -(S_host.T @ w_un) - lam_eff * Dk_t_s
        dz = np.linalg.solve(G, rho)
        z = z + dz
        if np.max(np.abs(dz)) <= 1e-9 * max(np.max(np.abs(z)), 1e-30):
            break

    x_hat = torch.as_tensor(z[seg_id], dtype=torch.float32,
                            device=rows.device)
    # certificate: ∇f(x̂) + Dᵀv = 0 with ∇f the user's mean gradient, at
    # the refined z itself (the f32 cast of x̂ would shift v by far more
    # than the tolerance): v_i = Σ_{j≤i} w_j, Σw = 0
    w = _tv_cert_grad(rows, offs, S, z, c) * (sc / N)
    v = np.cumsum(w[:-1])
    off = np.ones(n - 1, bool)
    off[J] = False
    # v_J = λs is near-tautological (the reduced solve enforces it): the
    # load-bearing checks are λ-interiority off J and that the solved
    # jumps take the assumed signs with a material magnitude
    dz = np.diff(z)
    if k == 1:          # no jumps identified: nothing to sign-check
        sign_ok = True
    else:
        sign_ok = bool(
            np.all(np.sign(dz) == s)
            and np.min(np.abs(dz)) > cert_rtol * np.max(np.abs(dz)))
    certified = bool(
        sign_ok
        and np.all(np.abs(v[off]) <= lam * (1.0 + cert_rtol))
        and np.all(np.abs(v[J] - lam * s) <= lam * cert_rtol)
        and abs(v[-1] + w[-1]) <= lam * cert_rtol
    )
    return x_hat, certified, v


@dataclasses.dataclass
class DeepPDInfo:
    """What the deep primal-dual solve did."""

    steps: int            # Condat-Vũ steps run
    dx_rels: List[float]  # relative primal motion ‖Δx‖/‖x‖ per round
    lam_hat: Optional[float]  # spectral curvature bound used for τ
    tau: float
    sigma: float
    refined: bool = False    # the reduced solve ran and its certificate held
    certified: bool = False  # the certificate's verdict (when it ran)


def deep_solve_pd(
    x0,
    F=None,
    g=None,
    h=None,
    K=None,
    L=None,
    N: Optional[int] = None,
    *,
    tau: Optional[float] = None,
    sigma: Optional[float] = None,
    chunk: int = 4096,
    chunk_steps: int = 512,
    max_steps: int = 131_072,
    plateau_rtol: float = 5e-8,
    refine_try_rtol: float = 3e-5,
    power_iters: int = 12,
    refine: bool = True,
    jump_rtol: float = 1e-3,
    cert_rtol: float = 0.01,
    seed: int = 0,
    device=None,
) -> Tuple[torch.Tensor, DeepPDInfo]:
    """Solve ``min (1/N)Σ fᵢ(x) + g(x) + h(Kx)`` to deep relative accuracy
    in f32: Condat-Vũ at the spectral stepsize with a compensated chunked
    full gradient every step, until the relative primal motion of a round
    of ``chunk_steps`` steps plateaus.

    For the fused lasso (g absent, h = λ‖·‖₁, K = FirstDifference,
    least-squares rows) the plateaued iterate then goes through
    :func:`tv_refine`, and with g = λ₁‖·‖₁ through :func:`tv_refine3`:
    the certified exact reduced solve, tried as soon as the motion falls
    under ``refine_try_rtol`` and the iterate shows a sparse jump set. On
    a failed certificate the unrefined iterate is returned
    (``info.refined`` and ``info.certified`` say which).

    Parameters mirror :class:`ciao_tpu_torch.CondatVu` (omit K for K = I,
    omit F for the Chambolle-Pock case); ``chunk`` is the compensated
    reduction's chunk (rounded down to a divisor of N). τ comes from
    1.2·``power_lmax`` (``power_iters`` iterations from a start drawn with
    ``seed``) with σ = 1/‖K‖; explicit ``tau``/``sigma`` override it.
    ``jump_rtol``/``cert_rtol`` pass through to the refinement. ``device``
    is where the run happens (default: x0's device for a tensor x0, else
    the card when there is one). Returns ``(x, DeepPDInfo)``."""
    from ciao_tpu_torch.ops.linmap import FirstDifference, IdentityMap
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1, Zero

    dev = facade_device(device, x0)
    x0 = torch.as_tensor(x0, device=dev)
    dense_rows = F is not None and hasattr(F, "coeff_rows_data")
    lam_hat = None
    if tau is None and dense_rows:
        # spectral τ. The 1.2 margin matters: power iterations approach
        # λmax from below, and at a random design's Marchenko-Pastur edge
        # the eigengap is tiny, so a dozen iterations can sit several
        # percent short; an overlarge τ makes Condat-Vũ oscillate on the
        # top eigenmode and identification never happens
        F = F.to(dev)
        lam_hat = 1.2 * float(power_lmax(F, x0.to(torch.float32), seed,
                                         iters=power_iters))
        Kn = K if K is not None else IdentityMap()
        normK = float(Kn.opnorm_bound(x0.shape[0]))
        sigma = 1.0 / max(normK, 1e-12) if sigma is None else sigma
        tau = 0.99 / (lam_hat / 2.0 + sigma * normK * normK)

    facade = CondatVu(tau=tau, sigma=sigma, device=dev)
    x0, F, g, h, K, cfg, init = facade._setup(x0, F, g, h, K, L, N)
    state = init()
    c = _chunk_of(cfg.N, chunk)

    refinable = (
        refine and dense_rows
        and isinstance(F, LeastSquaresRows)
        and isinstance(h, NormL1)
        and isinstance(K, FirstDifference)
    )
    tv_shape = refinable and isinstance(g, Zero)
    # the full three-term objective (λ₁‖x‖₁ + λ₂‖Dx‖₁): both structures
    # identified, interval-propagation certificate
    three_term = refinable and isinstance(g, NormL1)

    dx_rels: List[float] = []
    steps = 0
    rounds = max(1, max_steps // chunk_steps)
    info = DeepPDInfo(steps=0, dx_rels=dx_rels, lam_hat=lam_hat,
                      tau=float(state.tau), sigma=float(state.sigma))
    for _ in range(rounds):
        x_prev = state.x
        if dense_rows:
            state = pd_run_compensated(F, g, h, K, state, cfg, chunk_steps,
                                       c)
        else:
            # no finite-sum rows (Chambolle-Pock): nothing to compensate
            state = pd_run(F, g, h, K, state, cfg, chunk_steps)
        steps += chunk_steps
        info.steps = steps
        dx = float(torch.linalg.vector_norm(state.x - x_prev)
                   / torch.clamp(torch.linalg.vector_norm(state.x),
                                 min=1e-30))
        dx_rels.append(dx)
        if (tv_shape or three_term) and dx <= refine_try_rtol:
            # identification, not deep convergence, is all the reduced
            # solve needs: try it once the iterate settles and shows a
            # sparse jump set (a non-converged iterate flags about every
            # coordinate), and return on the first valid certificate
            d = torch.abs(torch.diff(state.x))
            n_jumps = int(torch.sum(d > 1e-3 * torch.max(d)))
            if 4 * n_jumps <= state.x.shape[0]:
                if three_term:
                    x_hat, certified = tv_refine3(
                        F, state.x, float(g.lam), float(h.lam), chunk=c,
                        jump_rtol=jump_rtol, cert_rtol=cert_rtol)
                else:
                    x_hat, certified, _ = tv_refine(
                        F, state.x, float(h.lam), chunk=c,
                        jump_rtol=jump_rtol, cert_rtol=cert_rtol)
                info.certified = certified
                if certified:
                    info.refined = True
                    return x_hat, info
        if dx <= plateau_rtol:
            break
    return state.x, info


def tv_refine3(F, x, lam1: float, lam2: float, *, chunk: int = 4096,
               jump_rtol: float = 1e-3, zero_rtol: float = 1e-3,
               cert_rtol: float = 0.01):
    """Certified exact reduced solve of the three-term objective
    ``½‖Ax−b‖² + λ₁‖x‖₁ + λ₂‖Dx‖₁``: the plateaued iterate identifies
    both the jump set J (segments) and the exact-zero segments (the ℓ1
    sparsity). Nonzero segment levels solve the linear stationarity
    system (a segment m: Σ_m w + λ₁|m|·t_m + λ₂(s_left − s_right) = 0),
    zero segments are pinned; the compensated Gram and the iterative
    refinement are :func:`tv_refine`'s.

    On zero coordinates the ℓ1 dual u is free in [−λ₁, λ₁], so the TV
    dual is determined only up to an interval: a valid (u, v) pair is
    checked by forward interval propagation of v_i = v_{i−1} + w_i + u_i
    (nonzero coordinates shift by λ₁t, zero coordinates widen by ±λ₁;
    each step meets [−λ₂, λ₂], is pinned to λ₂s at identified jumps, and
    the last virtual v must reach 0). With λ₁ = 0 this is the two-term
    cumsum certificate. Returns ``(x_hat, certified)``."""
    rows, offs = _reduced_rows(F, "tv_refine3")
    N, n = rows.shape
    c = _chunk_of(N, chunk)

    x_np, J, s, k, seg_id = _segments(x, jump_rtol, 1e-30)
    widths = np.bincount(seg_id, minlength=k).astype(np.float64)
    seg_mean = np.bincount(seg_id, weights=x_np, minlength=k) / widths
    zmax = max(np.max(np.abs(seg_mean)), 1e-30)
    nz = np.abs(seg_mean) > zero_rtol * zmax       # nonzero segments
    t = np.sign(seg_mean) * nz

    # per-segment TV boundary signs: s_left (jump entering) − s_right
    s_left = np.zeros(k)
    s_left[1:] = s
    s_right = np.zeros(k)
    s_right[:-1] = s
    mult = lam1 * widths * t + lam2 * (s_left - s_right)

    S = _indicator(seg_id, k, rows.device)
    G, r = _segment_normal_eq(rows, offs, S, c)
    sc = float(F.scale) if hasattr(F, "scale") else float(N)
    fac = N / sc

    idx = np.nonzero(nz)[0]
    z = np.zeros(k)
    if len(idx):
        z[idx] = np.linalg.solve(G[np.ix_(idx, idx)],
                                 (r - fac * mult)[idx])

    S_host = np.eye(k)[seg_id]
    for _ in range(3):
        w_un = _tv_cert_grad(rows, offs, S, z, c)
        rho = -(S_host.T @ w_un) - fac * mult
        if len(idx):
            z[idx] += np.linalg.solve(G[np.ix_(idx, idx)], rho[idx])

    x_hat = torch.as_tensor(z[seg_id], dtype=torch.float32,
                            device=rows.device)
    w = _tv_cert_grad(rows, offs, S, z, c) * (sc / N)

    # solved-structure checks (the near-tautological equalities are
    # enforced by the solve; these are the load-bearing ones)
    dz = np.diff(z)
    if k > 1 and not (np.all(np.sign(dz) == s)
                      and np.min(np.abs(dz))
                      > cert_rtol * np.max(np.abs(dz))):
        return x_hat, False
    if len(idx) and not np.all(np.sign(z[idx]) == t[idx]):
        return x_hat, False

    # forward interval propagation for the joint (u, v) feasibility
    eps1 = cert_rtol * lam1
    eps2 = cert_rtol * lam2
    lo = hi = 0.0                 # v_{-1} = 0 (virtual)
    jump_set = set(J.tolist())
    x_seg_nz = nz[seg_id]
    t_coord = t[seg_id]
    for i in range(n):
        wi = w[i]
        if x_seg_nz[i]:
            lo = lo + wi + lam1 * t_coord[i] - eps1
            hi = hi + wi + lam1 * t_coord[i] + eps1
        else:
            lo = lo + wi - lam1 - eps1
            hi = hi + wi + lam1 + eps1
        if i < n - 1:
            if i in jump_set:
                pin = lam2 * s[np.searchsorted(J, i)]
                lo2, hi2 = (max(lo, pin - eps2), min(hi, pin + eps2))
            else:
                lo2, hi2 = max(lo, -lam2 - eps2), min(hi, lam2 + eps2)
        else:
            lo2, hi2 = max(lo, -eps2), min(hi, eps2)   # v_{n-1} = 0
        if lo2 > hi2:
            return x_hat, False
        lo, hi = lo2, hi2
    return x_hat, True
