"""``deep_solve_dp``: the deep-accuracy endgame over a data mesh.

Counterpart of ``ciao_tpu/parallel/deep.py``'s ``deep_solve_dp``: the
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
