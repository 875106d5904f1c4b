"""``deep_solve_dp``, ``deep_solve_pd_dp``, ``deep_solve_tp`` and
``deep_solve_pd_tp``: the deep-accuracy endgames over a data mesh and a
(data, model) mesh.

Counterpart of ``ciao_tpu/parallel/deep.py``'s four plans
(:func:`deep_solve_pd_dp` and :func:`deep_solve_pd_tp`, the primal-dual
routes, and :func:`deep_solve_tp`, the same plan with the iterate cut
over coordinates, have their own notes).
``deep_solve_dp`` is the
single-card plan (:func:`ciao_tpu_torch.deep_solve`, stochastic stage to
the f32 gradient floor, then compensated-gradient FISTA polish) built
from the DP pieces:

1. **Stochastic stage**: :class:`DPSAGA` in LOCAL-UPDATE mode
   (``local_steps`` coefficient-SAGA steps a collective, one #3 launch a
   round on the card), run in chunks of rounds until the full-pass
   objective plateaus. The objective is one local value pass and one
   scalar all-reduce.
2. **Curvature bound**: the power iteration of ``solvers.polish.
   power_lmax`` with its collective written out (JAX lets GSPMD insert
   it): the start vector is the same on every rank (drawn from the
   seed), each rank takes its rows' margins, and the back-projection is
   all-reduced (:func:`power_lmax_dp`).
3. **Polish**: :class:`DPForwardBackward` with ``polish_chunk``: each
   rank sums its rows' gradient in compensated chunks and one all-reduce
   adds the D partial sums, which adds only ~√D·eps.

Same accuracy contract as ``deep_solve`` (rel ≤ 1e-6 past the f32
floor). f32 rows only (the staged narrow-storage start is single-card).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.parallel.dp import DPSAGA, DPForwardBackward, _psum
from ciao_tpu_torch.parallel.mesh import make_mesh
from ciao_tpu_torch.solvers.deep import DeepSolveInfo, _largest_divisor_leq
from ciao_tpu_torch.solvers.polish import _require_wide_rows, _start_vector
from ciao_tpu_torch.solvers.staged import StagedInfo


def power_lmax_dp(mesh, F, x, seed: int, N: int, iters: int = 6,
                  margin_slack=0.0):
    """λmax bound of the mean Hessian (1/N)·Aᵀ diag(w̄ᵢ) A over every
    rank's rows: ``solvers.polish.power_lmax`` with its sum over rows an
    all-reduce. ``F`` is the rank's part of a dense-rows margin oracle;
    the start vector, a normal draw seeded by ``seed``, is the same on
    every rank, and so is each iterate. One all-reduce an iteration.
    Returns a 0-d tensor."""
    _require_wide_rows(F, "power_lmax_dp")
    A, _ = F.coeff_rows_data()
    runtime.require_exact_f32_matmul(A.device, "power_lmax_dp")
    A = A.to(torch.promote_types(A.dtype, torch.float32))
    w = F.hess_weight_from_margin(A @ x.to(torch.float32).to(A.dtype),
                                  margin_slack)
    v = _start_vector(A.shape[1], seed, A.device, A.dtype)
    lam = None
    for _ in range(iters):
        hv = _psum(mesh, (w * (A @ v)) @ A) / N
        lam = torch.linalg.vector_norm(hv)
        v = hv / torch.clamp(lam, min=torch.finfo(hv.dtype).tiny)
    return lam


def deep_solve_dp(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh=None,
    batch: int = 0,
    local_steps: int = 16,
    chunk_rounds: int = 64,
    plateau_rtol: float = 1e-5,
    max_rounds: int = 8192,
    gamma: Optional[float] = None,
    polish_steps: int = 16,
    polish_chunk: int = 32_768,
    power_iters: int = 6,
    eta_safety: float = 0.9,
    margin_slack: float = 0.0,
    seed: int = 0,
    observe=None,
) -> Tuple[torch.Tensor, DeepSolveInfo]:
    """Solve ``min (1/N) Σ f_i + g`` to deep relative accuracy over a DP
    mesh. ``F`` is the rank's part (``shard_finite_sum``) of an oracle
    with dense f32 rows, or the whole oracle, cut here; ``g`` needs
    ``prox_only``. ``local_steps`` sets the steps a collective of the
    stochastic stage; the polish is ``polish_steps`` DP-FISTA passes with
    compensated chunks on each rank. Every rank returns the same
    ``(x, DeepSolveInfo)`` (``staged`` holds the stochastic stage's
    objectives, one a chunk)."""
    if mesh is None:
        mesh = make_mesh()
    D = mesh.size
    if N is None:
        shard = getattr(F, "dp_shard", None)
        N = shard[0] if shard is not None else F.num_terms
    # global batch: splits evenly over the ranks and tiles each shard
    b = batch or min(4096, N // D * D)
    b = max(D, (b // D) * D)
    while (N // D) % (b // D):
        b -= D

    solver = DPSAGA(mesh=mesh, batch=b, block_sampling=True,
                    local_steps=local_steps, gamma=gamma, seed=seed)
    _, Fd, g, init, _, run, _ = solver._setup(x0, F, g, L, N)
    state = init()

    def obj(z):
        return float(_psum(mesh, Fd.value_sum_all(z)) / N + g.value(z))

    objs: List[float] = []
    chunks = 0
    prev = obj(state.z)
    plateaued = False
    while chunks * chunk_rounds < max_rounds:
        state = run(state, chunk_rounds)
        cur = obj(state.z)
        chunks += 1
        objs.append(cur)
        if observe is not None:
            observe(state.z)
        if prev - cur < plateau_rtol * max(abs(prev), 1e-30):
            plateaued = True
            prev = cur
            break
        prev = cur

    sinfo = StagedInfo(storages=["f32"],
                       epochs=[chunks * chunk_rounds * local_steps * b
                               // max(N, 1)],
                       objectives=objs or [prev],
                       switched_early=[plateaued])

    lmax = float(power_lmax_dp(mesh, Fd, state.z, seed + 1, N,
                               iters=power_iters, margin_slack=margin_slack))
    eta = eta_safety / lmax
    pchunk = _largest_divisor_leq(N // D, polish_chunk)
    pol = DPForwardBackward(mesh=mesh, maxit=polish_steps, fast=True,
                            gamma=eta, polish_chunk=pchunk)
    x, _ = pol(state.z, F=Fd, g=g, N=N)
    if observe is not None:
        observe(x)
    return x, DeepSolveInfo(staged=sinfo, lmax=lmax, eta=eta,
                            polish_steps=polish_steps, fp_res=[])


def power_lmax_tp(mesh, F, x, seed: int, N: int, iters: int = 6,
                  margin_slack=0.0):
    """:func:`power_lmax_dp` on a (data, model) mesh, its collectives
    written out as GSPMD places them for JAX: the margins summed over
    "model", the back-projection over "data", the norm's square over
    "model". ``F`` is the rank's block of a dense-rows margin oracle and
    ``x`` its columns; the start vector is drawn whole from the seed and
    cut to the rank's columns, so the bound does not depend on M. Three
    all-reduces an iteration. Returns a 0-d tensor, the same on every
    rank."""
    from ciao_tpu_torch.parallel.tp import _psum_d, _psum_m

    _require_wide_rows(F, "power_lmax_tp")
    A, _ = F.coeff_rows_data()
    runtime.require_exact_f32_matmul(A.device, "power_lmax_tp")
    A = A.to(torch.promote_types(A.dtype, torch.float32))
    w = F.hess_weight_from_margin(
        _psum_m(mesh, A @ x.to(torch.float32).to(A.dtype)), margin_slack)
    n_loc = A.shape[1]
    lo = mesh.m * n_loc
    v = _start_vector(n_loc * mesh.M, seed, A.device, A.dtype)[lo:lo + n_loc]
    lam = None
    for _ in range(iters):
        hv = _psum_d(mesh, (w * _psum_m(mesh, A @ v)) @ A) / N
        lam = torch.sqrt(_psum_m(mesh, torch.sum(hv * hv)))
        v = hv / torch.clamp(lam, min=torch.finfo(hv.dtype).tiny)
    return lam


def deep_solve_tp(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh,
    batch: int = 0,
    chunk_steps: int = 2048,
    plateau_rtol: float = 1e-5,
    max_steps: int = 262_144,
    gamma: Optional[float] = None,
    polish_steps: int = 16,
    polish_chunk: int = 32_768,
    power_iters: int = 6,
    eta_safety: float = 0.9,
    margin_slack: float = 0.0,
    seed: int = 0,
    observe=None,
) -> Tuple[torch.Tensor, DeepSolveInfo]:
    """The deep-accuracy plan on a (data, model) mesh, the iterate itself
    cut over coordinates (JAX's ``deep_solve_tp``):

    1. :class:`~ciao_tpu_torch.parallel.TPSAGA` in chunks of
       ``chunk_steps`` steps to the objective's plateau; the objective is
       the margins summed over "model", the row values over "data" and
       g's value over "model";
    2. the curvature bound of :func:`power_lmax_tp`;
    3. TP-FISTA with ``polish_chunk`` (``_largest_divisor_leq(N/D,
       polish_chunk)``): each rank's compensated chunked gradient, its hi
       and lo carries summed over "data" separately.

    ``x0`` is the whole (n,) iterate; ``F`` a whole dense f32-rows oracle
    or the rank's block (``shard_finite_sum_2d``); ``g`` separable;
    ``batch`` the per-data-row block size (D by default, as JAX's).
    ``observe`` sees the whole iterate, gathered over "model" (one
    all-gather a chunk, made only when ``observe`` is given), as JAX's
    sees its global array. Every rank returns the same whole ``(x,
    DeepSolveInfo)``."""
    from ciao_tpu_torch.parallel.mesh import Mesh2D
    from ciao_tpu_torch.parallel.tp import (
        TPCfg, TPSAGA, _num_terms, _psum_d, _psum_m, build_tp_functions,
        gather_model,
    )

    if not isinstance(mesh, Mesh2D):
        raise ValueError("deep_solve_tp needs a ('data','model') mesh")
    N = _num_terms(F, N)
    D = mesh.D
    b = batch or D
    solver = TPSAGA(mesh=mesh, batch=b, gamma=gamma, seed=seed)
    _, Fd, g, init, _, run, _ = solver._setup(x0, F, g, L, N)
    state = init()

    def obj(z):
        v = _psum_d(mesh, Fd.value_from_margin_all(
            _psum_m(mesh, Fd.margin_all(z))))
        return float(v / N + _psum_m(mesh, torch.as_tensor(
            g.value(z), device=z.device)))

    objs: List[float] = []
    chunks = 0
    prev = obj(state.z)
    plateaued = False
    while chunks * chunk_steps < max_steps:
        state = run(state, chunk_steps)
        cur = obj(state.z)
        chunks += 1
        objs.append(cur)
        if observe is not None:
            observe(gather_model(mesh, state.z))
        if prev - cur < plateau_rtol * max(abs(prev), 1e-30):
            plateaued = True
            prev = cur
            break
        prev = cur

    sinfo = StagedInfo(storages=["f32"],
                       epochs=[chunks * chunk_steps * b // max(N, 1)],
                       objectives=objs or [prev],
                       switched_early=[plateaued])

    lmax = float(power_lmax_tp(mesh, Fd, state.z, seed + 1, N,
                               iters=power_iters, margin_slack=margin_slack))
    eta = eta_safety / lmax
    pchunk = _largest_divisor_leq(N // D, polish_chunk)
    # the polish facade's loop: its init is iterate 1, then polish_steps − 1
    # steps
    p_init, _, p_run, _ = build_tp_functions(
        "fb", mesh, Fd, g, TPCfg(N=N, D=D, M=mesh.M, fast=True,
                                 polish_chunk=pchunk))
    pol = p_run(p_init(state.z, torch.as_tensor(
        eta, dtype=state.z.dtype.to_real(), device=state.z.device), 0),
        polish_steps - 1)
    x = gather_model(mesh, pol.x)
    if observe is not None:
        observe(x)
    return x, DeepSolveInfo(staged=sinfo, lmax=lmax, eta=eta,
                            polish_steps=polish_steps, fp_res=[])


def deep_solve_pd_dp(
    x0,
    F,
    g=None,
    h=None,
    K=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh=None,
    tau: Optional[float] = None,
    sigma: Optional[float] = None,
    chunk_steps: int = 256,
    max_steps: int = 8192,
    refine_try_rtol: float = 3e-5,
    plateau_rtol: float = 5e-8,
    polish_chunk: int = 32_768,
    power_iters: int = 12,
    seed: int = 0,
):
    """The primal-dual deep route (:func:`ciao_tpu_torch.deep_solve_pd`)
    over a DP mesh: :class:`DPCondatVu` with ``polish_chunk`` (each rank's
    gradient in compensated chunks and ONE all-reduce a step) at the
    spectral stepsize of :func:`power_lmax_dp`, run in rounds of
    ``chunk_steps`` steps, with the same early certified ``tv_refine``
    tries once the iterate settles. The refinement runs over each rank's
    rows: the compensated segment Gram, right-hand side and certificate
    gradient are summed over the ranks as f64 (hi, lo) halves before the
    k×k f64 solve, which every rank does alike on the host.

    ``F`` is the rank's part (``shard_finite_sum``) of a dense-rows
    oracle, or the whole oracle, cut here. As in the JAX package, the
    refinement takes its default ``jump_rtol``/``cert_rtol`` and the
    three-term objective gets no ``tv_refine3``. Every rank returns the
    same ``(x, DeepPDInfo)``; on a failed certificate the unrefined
    iterate (``info.certified``)."""
    from ciao_tpu_torch.ops.linmap import FirstDifference, IdentityMap
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.parallel.dp import DPCondatVu, _dp_problem
    from ciao_tpu_torch.prox import NormL1, Zero
    from ciao_tpu_torch.solvers.deep_pd import DeepPDInfo, _tv_refine

    mesh, x0, Fd, _, N = _dp_problem(mesh, x0, F, None, N,
                                     "deep_solve_pd_dp")
    D = mesh.size
    lam_hat = None
    if tau is None:
        # spectral τ with deep_solve_pd's 1.2 margin: the power iteration
        # approaches λmax from below, and an overlarge τ oscillates
        lam_hat = 1.2 * float(power_lmax_dp(mesh, Fd, x0.to(torch.float32),
                                            seed, N, iters=power_iters))
        Kn = K if K is not None else IdentityMap()
        normK = float(Kn.opnorm_bound(x0.shape[0]))
        sigma = 1.0 / max(normK, 1e-12) if sigma is None else sigma
        tau = 0.99 / (lam_hat / 2.0 + sigma * normK * normK)

    pchunk = _largest_divisor_leq(N // D, polish_chunk)
    solver = DPCondatVu(mesh=mesh, tau=tau, sigma=sigma, polish_chunk=pchunk)
    _, Fd, (g_r, h_r, K_r), init, _, run, _ = solver._setup(x0, Fd, g, h, K,
                                                            L, N)
    state = init()
    tv_shape = (isinstance(Fd, LeastSquaresRows) and isinstance(g_r, Zero)
                and isinstance(h_r, NormL1)
                and isinstance(K_r, FirstDifference))

    dx_rels: List[float] = []
    info = DeepPDInfo(steps=0, dx_rels=dx_rels, lam_hat=lam_hat,
                      tau=float(tau), sigma=float(sigma))
    for _ in range(max(1, max_steps // chunk_steps)):
        x_prev = state.x
        state = run(state, chunk_steps)
        info.steps += chunk_steps
        # the iterate is the same on every rank, so is each branch below
        dx = float(torch.linalg.vector_norm(state.x - x_prev)
                   / torch.clamp(torch.linalg.vector_norm(state.x),
                                 min=1e-30))
        dx_rels.append(dx)
        if tv_shape and dx <= refine_try_rtol:
            d = torch.abs(torch.diff(state.x))
            n_jumps = int(torch.sum(d > 1e-3 * torch.max(d)))
            if 4 * n_jumps <= state.x.shape[0]:
                x_hat, certified, _ = _tv_refine(
                    Fd, state.x, float(h_r.lam), pchunk, 1e-3, 0.01,
                    N_total=N, reduce=lambda t: _psum(mesh, t))
                info.certified = certified
                if certified:
                    info.refined = True
                    return x_hat, info
        if dx <= plateau_rtol:
            break
    return state.x, info


def deep_solve_pd_tp(
    x0,
    F,
    g=None,
    h=None,
    K=None,
    L=None,
    N: Optional[int] = None,
    *,
    mesh,
    tau: Optional[float] = None,
    sigma: Optional[float] = None,
    chunk_steps: int = 256,
    max_steps: int = 8192,
    refine_try_rtol: float = 3e-5,
    plateau_rtol: float = 5e-8,
    refine_chunk: int = 32_768,
    power_iters: int = 12,
    seed: int = 0,
):
    """The primal-dual deep route on a (data, model) mesh (JAX's
    ``deep_solve_pd_tp``): :class:`~ciao_tpu_torch.parallel.TPCondatVu`
    (the stencil K, one one-element halo per neighbour and product) in
    rounds of ``chunk_steps`` steps to identification, at the spectral
    stepsize of :func:`power_lmax_tp` (1.2 margin), then the certified
    reduced solve: ``tv_refine`` for the fused lasso and ``tv_refine3``
    for the three-term objective (g = λ₁‖·‖₁), as in JAX. The plain TP
    step serves identification (the reduced solve does the deep part).

    JAX lets GSPMD partition the reduced solve; here its collectives are
    written out (``solvers.deep_pd.ColumnCut``): the whole iterate is
    gathered over "model" for the segments, each chunk's A·S is the
    rank's exact f32 product A[:, cols]·S[cols] summed over "model" in
    f64, the compensated Gram and right-hand side are summed over "data"
    as f64 (hi, lo) halves, and the certificate gradient is summed over
    "data" and joined over "model". Every rank takes the same host f64
    solves and the same verdict.

    ``x0`` is the whole (n,) iterate; ``F`` a whole dense-rows oracle or
    the rank's block (``shard_finite_sum_2d``); ``g``/``h`` separable;
    ``refine_chunk`` the reduced solve's chunk of the rank's rows (rounded
    down to a divisor of N/D). Every rank returns the same whole ``(x,
    DeepPDInfo)``."""
    from ciao_tpu_torch.ops.linmap import FirstDifference, IdentityMap
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.parallel.mesh import Mesh2D
    from ciao_tpu_torch.parallel.tp import (
        TPCondatVu, _num_terms, _psum_d, _psum_m, gather_model,
        shard_finite_sum_2d,
    )
    from ciao_tpu_torch.prox import NormL1, Zero
    from ciao_tpu_torch.solvers.deep_pd import (
        ColumnCut, DeepPDInfo, _tv_refine, _tv_refine3,
    )

    if not isinstance(mesh, Mesh2D):
        raise ValueError("deep_solve_pd_tp needs a ('data','model') mesh")
    N = _num_terms(F, N)
    x0 = torch.as_tensor(x0, device=mesh.device)
    n = x0.shape[0]
    if getattr(F, "tp_shard", None) is None:
        F = shard_finite_sum_2d(F, mesh, N)
    lo, hi = mesh.cols(n)

    lam_hat = None
    if tau is None:
        lam_hat = 1.2 * float(power_lmax_tp(
            mesh, F, x0[lo:hi].to(torch.float32), seed, N,
            iters=power_iters))
        Kn = K if K is not None else IdentityMap()
        normK = float(Kn.opnorm_bound(n))
        sigma = 1.0 / max(normK, 1e-12) if sigma is None else sigma
        tau = 0.99 / (lam_hat / 2.0 + sigma * normK * normK)

    solver = TPCondatVu(mesh=mesh, tau=tau, sigma=sigma)
    _, Fd, (g_r, h_r), init, _, run, _ = solver._setup(x0, F, g, h, K, L, N)
    state = init()
    refinable = (isinstance(Fd, LeastSquaresRows)
                 and isinstance(K, FirstDifference)
                 and isinstance(h_r, NormL1))
    tv_shape = refinable and isinstance(g_r, Zero)
    three_term = refinable and isinstance(g_r, NormL1)
    rchunk = _largest_divisor_leq(N // mesh.D, refine_chunk)
    cut = ColumnCut(lo=lo, hi=hi, msum=lambda t: _psum_m(mesh, t),
                    gather=lambda v: gather_model(
                        mesh, torch.from_numpy(v).to(mesh.device)
                    ).cpu().numpy())

    def norm(v):
        return torch.sqrt(_psum_m(mesh, torch.sum(v * v)))

    dx_rels: List[float] = []
    info = DeepPDInfo(steps=0, dx_rels=dx_rels, lam_hat=lam_hat,
                      tau=float(tau), sigma=float(sigma))
    for _ in range(max(1, max_steps // chunk_steps)):
        x_prev = state.x
        state = run(state, chunk_steps)
        info.steps += chunk_steps
        # whole norms, so every rank takes each branch below alike
        dx = float(norm(state.x - x_prev) / torch.clamp(norm(state.x),
                                                        min=1e-30))
        dx_rels.append(dx)
        if (tv_shape or three_term) and dx <= refine_try_rtol:
            x = gather_model(mesh, state.x)
            d = torch.abs(torch.diff(x))
            n_jumps = int(torch.sum(d > 1e-3 * torch.max(d)))
            if 4 * n_jumps <= n:
                reduce = lambda t: _psum_d(mesh, t)  # noqa: E731
                if three_term:
                    x_hat, certified = _tv_refine3(
                        Fd, x, float(g_r.lam), float(h_r.lam), rchunk, 1e-3,
                        1e-3, 0.01, N_total=N, reduce=reduce, cut=cut)
                else:
                    x_hat, certified, _ = _tv_refine(
                        Fd, x, float(h_r.lam), rchunk, 1e-3, 0.01,
                        N_total=N, reduce=reduce, cut=cut)
                info.certified = certified
                if certified:
                    info.refined = True
                    return x_hat, info
        if dx <= plateau_rtol:
            break
    return gather_model(mesh, state.x), info
