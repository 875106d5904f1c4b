"""Finito/MISO solver family — basic, low-memory (LFinito) and adaptive
(backtracking) variants, with minibatching and three sweeping strategies.

Counterpart of ``ciao_tpu/solvers/finito.py``, a re-design of the
reference's kernels:

  * basic:    reference ``src/algorithms/Finito/Finito_basic.jl`` — the
              table s_i = x_i − (γ_i/N) ∇f_i(x_i) kept as ONE (N, n)
              tensor (``table="full"``), or, for a rank-1 oracle, as its
              exact (N,) coefficients c and (d, n) per-block anchors zb
              (``table="coeff"``, variant ``basic_coeff``); every i of a
              batch reads the same z (Finito_basic.jl:110-118).
  * LFinito:  reference ``Finito_LFinito.jl`` — O(n) memory; one iterate
              is a full-gradient pass and a sweep over the blocks.
  * adaptive: reference ``Finito_adaptive.jl`` — per-index backtracking;
              an abort on γ underflow is ``Status.GAMMA_UNDERFLOW``.

Stepsize algebra (Finito_basic.jl:82-84): γ_i = α N / L_i,
hat_γ = 1 / Σ(1/γ_i), av = hat_γ Σ s_i/γ_i, z = prox_g(av, hat_γ).

Kernels, on a CUDA device with their gates open (``ops.fused_block``):
the full table's block refresh on ``finito_block_update``; the
coefficient variant's steps on ``finito_coeff_multistep`` up to JAX's
resident bounds (:func:`_resident`), else on
``finito_coeff_multistep_streamed``; LFinito's epoch on
``coeff_apply_all`` (the anchor) and ``lfinito_sweep_multistep`` (the
sweep). The schedules are the port's own draws (``ciao_tpu_torch.
sampling``); :func:`finito_run` also takes an explicit schedule, so the
parity tests can replay JAX's key chain.

Complex iterates (complex64, complex128) take the stepwise paths of every
variant, as in the JAX package: the kernels' gates take f32 iterates
alone, and no fallback warning is raised for them. The stepsizes stay
real, and the adaptive line search's model takes Re⟨∇f_i, z − s_i⟩.
Importance sampling refuses them, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ciao_tpu_torch.sampling import (
    Sweep,
    SweepState,
    _mix32,
    _seed_key,
    gen_block_ids,
    init_sweep,
    next_block,
    next_block_id,
    num_blocks,
    reshuffled,
)
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    default_terms,
    facade_device,
    rdiv,
    real_dtype_of,
    resolve_gamma_array,
    run_solver_loop,
)
from ciao_tpu_torch.solvers.saga import (
    LAUNCH_STEPS,
    RESIDENT_MAX_ROWS,
    _importance_setup,
    _warn_fallback as _warn_finito_fallback,
    importance_draws,
)

# JAX's resident-kernel bounds beyond N ≤ RESIDENT_MAX_ROWS: its (1, d)
# SMEM row of Σ 1/γ and its VMEM-resident (d, n) anchors. The port's
# kernels serve any shape; these only pick the resident one, as JAX does.
RESIDENT_MAX_BLOCKS = 1024
RESIDENT_MAX_ANCHOR_BYTES = 2 * 1024 * 1024


class FinitoCfg(NamedTuple):
    """Static solver configuration."""

    N: int
    batch: int
    sweeping: int
    alpha: float
    tol_b: float = 1e-9
    cyclic_pos0: int = 1  # basic starts its cyclic sweep at block 2
    fused: bool = False   # full table: kernel #2; coefficients: kernel #9;
    # LFinito: kernels #6 and #8
    fused_precision: str = "highest"  # dots in the kernels: exact f32 / bf16
    fused_stream: bool = False  # coefficients beyond the resident bounds: #14
    # Lipschitz-proportional block draws over the RANDOM sweep: the SAGA
    # systematic-πps clipped schedule picks which anchors refresh. Finito's
    # fixed point is schedule-independent, so no weight corrects the draws.
    importance: bool = False
    istrat: bool = True
    iwin: int = 64


class FinitoBasicState(NamedTuple):
    s: torch.Tensor          # (N, n) table of x_j − (γ_j/N) ∇f_j(x_j)
    gamma: torch.Tensor      # (N,)
    hat_gamma: torch.Tensor  # scalar
    av: torch.Tensor         # (n,) running average
    z: torch.Tensor          # (n,) prox point
    sweep: SweepState
    it: int
    status: int

    @property
    def solution(self):  # reference: solution(state) = state.z
        return self.z


class FinitoCoeffState(NamedTuple):
    """The basic variant in the coefficient parameterization (rank-1 row
    gradients): s_i = zb_b(i) − (γ_i/N)·c_i·a_i from the (N,) coefficients
    ``c`` and the (d, n) per-block eval points ``zb`` — exact under
    contiguous block sweeps, with 1/n the memory."""

    c: torch.Tensor          # (N,) gradient coefficients
    zb: torch.Tensor         # (d, n) eval point of each block's last update
    invg: torch.Tensor       # (d,) per-block Σ 1/γ_i
    gamma: torch.Tensor      # (N,)
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    sweep: SweepState
    it: int
    status: int
    # importance sampling only: the π-scale CDF of the clipped block
    # distribution and the 1/(d·q̃) row of the SAGA schedule (Finito
    # ignores the weight); None otherwise
    qcum: Optional[torch.Tensor] = None
    qinv: Optional[torch.Tensor] = None

    @property
    def solution(self):
        return self.z


class LFinitoState(NamedTuple):
    gamma: torch.Tensor
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    z_full: torch.Tensor
    sweep: SweepState
    it: int
    status: int

    @property
    def solution(self):
        return self.z


class FinitoAdaptiveState(NamedTuple):
    s: torch.Tensor          # (N, n) table of x_j
    gradf: torch.Tensor      # (N, n) gradient table
    fi_x: torch.Tensor       # (N,) value table
    gamma: torch.Tensor      # (N,)
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    sweep: SweepState
    it: int
    status: int

    @property
    def solution(self):
        return self.z


def _init_sweep(seed, cfg: FinitoCfg, batch: int, device, cyclic_pos0):
    sweep = init_sweep(seed, cfg.N, batch, cfg.sweeping, device)
    if cfg.sweeping == Sweep.CYCLIC:
        sweep = sweep._replace(pos=cyclic_pos0)
    return sweep


def _next_block(cfg: FinitoCfg, sweep: SweepState, block=None):
    """The step's block id and the advanced sweep; an explicit ``block``
    replaces the draw, and the sweep advances as it would."""
    drawn, sweep = next_block_id(sweep, cfg.N, cfg.batch, cfg.sweeping)
    return (drawn if block is None else block), sweep


def _block_rows(block, N: int, B: int, device):
    """(rows, mask) of block ``block``: B consecutive row ids, those past
    a ragged end clamped to N − 1 and masked."""
    idx = torch.as_tensor(block, device=device).long() * B + torch.arange(
        B, device=device)
    return idx.clamp(max=N - 1), idx < N


# ---------------------------------------------------------------------------
# basic variant
# ---------------------------------------------------------------------------

def finito_basic_init(F, g, x0, gamma, seed: int,
                      cfg: FinitoCfg) -> FinitoBasicState:
    """Cold start (reference Finito_basic.jl:44-89): a full gradient pass
    fills the table, then the aggregate/prox bootstrap."""
    N = cfg.N
    G = F.grad_all(x0)                                   # (N, n)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = 1.0 / torch.sum(1.0 / gamma)
    av = hat_gamma * torch.sum(s / gamma[:, None], dim=0)
    z = g.prox_only(av, hat_gamma)
    return FinitoBasicState(
        s=s, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z,
        sweep=_init_sweep(seed, cfg, cfg.batch, x0.device, cfg.cyclic_pos0),
        it=1, status=int(Status.RUNNING))


def _use_contiguous(cfg) -> bool:
    """Cyclic/shuffled sweeps with evenly dividing batches pick static
    contiguous blocks (Finito_basic.jl:50-58)."""
    return cfg.sweeping != Sweep.RANDOM and cfg.N % cfg.batch == 0


def _finito_basic_step(F, g, cfg: FinitoCfg, state: FinitoBasicState,
                       block=None, idx=None, inplace=False):
    """Hot step (reference Finito_basic.jl:91-121), batched exactly:
    s_i ← z − (γ_i/N) ∇f_i(z); av += Σ_i (s_i^new − s_i^old)·hat_γ/γ_i;
    z ← prox_g(av, hat_γ). ``block`` (block sweeps) or ``idx`` (RANDOM
    rows) replace the step's draw. The table is replaced, not written in
    place, unless the caller owns it (``inplace``)."""
    N, B = cfg.N, cfg.batch
    hat, dev = state.hat_gamma, state.z.device
    sweep = state.sweep
    if cfg.sweeping == Sweep.RANDOM:
        if idx is None:
            idx, mask, sweep = next_block(sweep, N, B, cfg.sweeping)
        else:
            mask = torch.ones(B, dtype=torch.bool, device=dev)
            sweep = sweep._replace(pos=sweep.pos + 1)
    else:
        block, sweep = _next_block(cfg, sweep, block)
    s = state.s if inplace else state.s.clone()
    if _use_contiguous(cfg) and cfg.fused:
        # kernel #2: gradient, table write and innovation in one pass
        s, innov = F.fused_finito_block(s, state.gamma, state.z, block * B, B,
                                        1.0 / N, hat,
                                        precision=cfg.fused_precision)
        av = state.av + innov
    else:
        if cfg.sweeping != Sweep.RANDOM:
            idx, mask = _block_rows(block, N, B, dev)
        gi = state.gamma[idx]
        if _use_contiguous(cfg):
            G_B = F.grad_block(state.z, block * B, B)
        else:
            G_B = F.grad_batch(state.z, idx)
        s_new = state.z[None, :] - (gi / N)[:, None] * G_B
        delta = s_new - s[idx]
        if not _use_contiguous(cfg):
            # padded duplicates of a ragged block add 0
            delta = torch.where(mask[:, None], delta, 0)
        av = state.av + torch.sum(delta * (hat / gi)[:, None], dim=0)
        if _use_contiguous(cfg):
            s.index_copy_(0, idx, s_new)
        else:
            s.index_add_(0, idx, delta)
    z = g.prox_only(av, hat)
    return state._replace(s=s, av=av, z=z, sweep=sweep, it=state.it + 1)


# ---------------------------------------------------------------------------
# coefficient-compressed basic variant (rank-1 row-gradient oracles)
# ---------------------------------------------------------------------------

def finito_coeff_init(F, g, x0, gamma, seed: int,
                      cfg: FinitoCfg) -> FinitoCoeffState:
    """The bootstrap of :func:`finito_basic_init` (Finito_basic.jl:44-89)
    in the coefficient parameterization: s_i = x0 − (γ_i/N)c_i·a_i, so
    av = hat_γ·(Σ1/γ_i)·x0 − (hat_γ/N)·Σ c_i a_i."""
    N, B = cfg.N, cfg.batch
    d = N // B
    c = F.coeff_all(x0)
    inv_gamma = 1.0 / gamma
    hat_gamma = 1.0 / torch.sum(inv_gamma)
    av = hat_gamma * torch.sum(inv_gamma) * x0 - (hat_gamma / N) * F.apply_all(c)
    z = g.prox_only(av, hat_gamma)
    invg = torch.sum(inv_gamma.reshape(d, B), dim=1)
    # JAX broadcasts x0; the kernels write rows of zb, so each is its own
    zb = x0.expand(d, x0.shape[0]).clone()
    return FinitoCoeffState(
        c=c, zb=zb, invg=invg, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z,
        sweep=_init_sweep(seed, cfg, B, x0.device, cfg.cyclic_pos0),
        it=1, status=int(Status.RUNNING))


def finito_rebase(F, g, state, cfg: FinitoCfg):
    """Make the running average consistent with the table under ``F``'s
    row storage (see ``saga.saga_rebase``: after a mid-run storage swap
    the delta-maintained ``av`` keeps the old operator's bias).
    Coefficient-mode identity:

        av = hat_γ·(Σ_j invg_j·zb_j − (1/N)·Σ_i c_i·a_i)

    so one pass over A repairs it, and ``z`` is re-proxed. LFinito
    recomputes its anchor every epoch and the full table stores the s_i
    themselves: any other state is returned unchanged."""
    if not isinstance(state, FinitoCoeffState):
        return state
    hat = state.hat_gamma
    av = hat * (state.invg @ state.zb) - (hat / cfg.N) * F.apply_all(state.c)
    return state._replace(av=av, z=g.prox_only(av, hat))


def _finito_coeff_step(F, g, cfg: FinitoCfg, state: FinitoCoeffState,
                       block=None, inplace=False):
    """Exact re-parameterization of the basic hot step over a contiguous
    block (Finito_basic.jl:110-118):

        Σ_B (s_new−s_old)·hat_γ/γ_i
          = hat_γ·(Σ_B 1/γ_i)(z − z_b) − (hat_γ/N)·Σ_B (c_new−c_old)·a_i

    two products over the same rows. Under importance sampling the block
    is the (seed, it) draw of ``saga.importance_draws``."""
    N, B = cfg.N, cfg.batch
    hat, dev = state.hat_gamma, state.z.device
    sweep = state.sweep
    if block is None and cfg.importance:
        starts, _ = importance_draws(sweep.seed, state.it, 1, cfg, state.qcum,
                                     state.qinv)
        block = starts[0] // B
    elif not cfg.importance:
        block, sweep = _next_block(cfg, sweep, block)
    idx, _ = _block_rows(block, N, B, dev)
    j = torch.as_tensor(block, device=dev).long().view(1)
    c_new = F.coeff_block(state.z, block * B, B)
    innov = hat * state.invg[j[0]] * (
        state.z - state.zb.index_select(0, j)[0]) - (hat / N) * (
        F.apply_rows_block(c_new - state.c[idx], block * B, B))
    av = state.av + innov
    c, zb = (state.c, state.zb) if inplace else (state.c.clone(),
                                                  state.zb.clone())
    c.index_copy_(0, idx, c_new)
    zb.index_copy_(0, j, state.z[None, :])
    z = g.prox_only(av, hat)
    return state._replace(c=c, zb=zb, av=av, z=z, sweep=sweep,
                          it=state.it + 1)


# ---------------------------------------------------------------------------
# LFinito (low-memory) variant
# ---------------------------------------------------------------------------

def lfinito_init(F, g, x0, gamma, seed: int, cfg: FinitoCfg) -> LFinitoState:
    """Reference Finito_LFinito.jl:39-74. The init state's z is av itself
    (no prox): solution(init) == av, a quirk the streaming API keeps."""
    N = cfg.N
    hat_gamma = 1.0 / torch.sum(1.0 / gamma)
    av = x0 - (hat_gamma / N) * F.grad_sum_all(x0)
    return LFinitoState(
        gamma=gamma, hat_gamma=hat_gamma, av=av, z=av, z_full=av,
        sweep=init_sweep(seed, N, cfg.batch, cfg.sweeping, x0.device),
        it=1, status=int(Status.RUNNING))


def _epoch_order(cfg: FinitoCfg, state: LFinitoState, order=None):
    """The epoch's visit order and the advanced sweep: a fresh permutation
    at the start of EVERY shuffled epoch, the first included
    (Finito_LFinito.jl:86-89); natural order otherwise (sweeping 1
    degenerates to cyclic, as in the reference, :36,89). An explicit
    ``order`` replaces the draw."""
    sweep = state.sweep
    if cfg.sweeping == Sweep.SHUFFLED:
        sweep = reshuffled(sweep, num_blocks(cfg.N, cfg.batch))
    return (sweep.order if order is None else order), sweep


def _lfinito_step(F, g, cfg: FinitoCfg, state: LFinitoState, order=None):
    """One epoch (reference Finito_LFinito.jl:77-103): a full-gradient
    refresh of av at z_full, then a block sweep where each block's update
    is

        av += (hat_γ/N) Σ_B [∇f_i(z_full) − ∇f_i(z)] + hat_γ (Σ_B 1/γ_i)(z − z_full)

    the bracketed sum one ``grad_sum_diff`` read of the block's rows."""
    if cfg.fused:
        return _lfinito_step_fused(F, g, cfg, state, order)
    N, B = cfg.N, cfg.batch
    hat = state.hat_gamma
    z_full = g.prox_only(state.av, hat)
    av = z_full - (hat / N) * F.grad_sum_all(z_full)
    order, sweep = _epoch_order(cfg, state, order)
    z = state.z
    for j in order.tolist():
        z = g.prox_only(av, hat)
        if N % B == 0:  # contiguous blocks
            diff = F.grad_sum_diff_block(z_full, z, j * B, B)
            inv_g = torch.sum(1.0 / state.gamma[j * B:(j + 1) * B])
        else:
            idx, mask = _block_rows(j, N, B, z.device)
            diff = F.grad_sum_diff(z_full, z, idx, mask)
            inv_g = torch.sum(torch.where(mask, 1.0 / state.gamma[idx], 0))
        av = av + (hat / N) * diff + hat * inv_g * (z - z_full)
    return state._replace(av=av, z=z, z_full=z_full, sweep=sweep,
                          it=state.it + 1)


def _lfinito_step_fused(F, g, cfg: FinitoCfg, state: LFinitoState,
                        order=None):
    """One LFinito epoch on two kernels: the anchor refresh (coefficients
    and full gradient sum in one pass, ``ops.coeff_apply_all``) and the
    block sweep (``ops.lfinito_sweep_chunked``: launches of at most 512
    blocks of ``ops.lfinito_sweep_multistep``, av carried) — two passes
    over the rows an epoch. Visit order and draws are those of
    :func:`_lfinito_step`."""
    from ciao_tpu_torch.ops.fused_block import (
        lfinito_sweep_chunked, oracle_apply_all, oracle_scalar_consts,
    )

    N, B = cfg.N, cfg.batch
    d = num_blocks(N, B)
    hat = state.hat_gamma
    rows, offs = F.coeff_rows_data()
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    z_full = g.prox_only(state.av, hat)
    c1, gsum = oracle_apply_all(F, z_full, cfg.fused_precision)
    av = z_full - (hat / N) * gsum
    order, sweep = _epoch_order(cfg, state, order)
    order = order.long()
    invg = torch.sum((1.0 / state.gamma).reshape(d, B), dim=1)
    hat32 = hat.to(rows.device).float()
    scalars = torch.stack([scale, hat32, hat32 * lam.float(),
                           torch.full_like(scale, 1.0 / N), mode, aux])
    av, z = lfinito_sweep_chunked(
        rows, offs, c1, (order * B).to(torch.int32), invg[order].float(), av,
        z_full, scalars, B, precision=cfg.fused_precision,
        rs=F.coeff_rows_scale())
    return state._replace(av=av, z=z, z_full=z_full, sweep=sweep,
                          it=state.it + 1)


# ---------------------------------------------------------------------------
# adaptive variant
# ---------------------------------------------------------------------------

def _rademacher(seed: int, draw: int, shape, dtype, device):
    """±1 signs of the probe's ``draw``'th retry, from a generator seeded
    by (seed, draw)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((_seed_key(seed) << 32) | _mix32(draw ^ 0x2545F491))
    bits = torch.randint(0, 2, shape, generator=gen, device=device)
    return (2 * bits - 1).to(dtype)


def finito_adaptive_init(F, g, x0, seed: int,
                         cfg: FinitoCfg) -> FinitoAdaptiveState:
    """Reference Finito_adaptive.jl:60-97: finite-difference probe of the
    smoothness moduli with the doubling-perturbation retry, then the
    aggregate bootstrap with the gradient and value tables."""
    N, dev = cfg.N, x0.device
    rdt = real_dtype_of(x0)
    fi_x, G0 = F.value_and_grad_all(x0)                 # tables at x0
    s = x0.expand(G0.shape).clone()

    # probe L_i ≈ ||∇f_i(x0 + δ) − ∇f_i(x0)|| / (t √n) / N
    G1 = F.grad_all(x0 + torch.ones_like(x0))
    nmg = torch.sqrt(torch.sum(torch.abs(G1 - G0) ** 2, dim=1)).to(rdt)
    eps = torch.finfo(rdt).eps
    t = torch.ones(N, dtype=rdt, device=dev)
    draw = 0
    while bool((nmg < eps).any()):
        # rows whose probe collapsed get a fresh ±t perturbation with t
        # doubled afterwards — the reference's loop at :78-84, including
        # its quirk that the final L uses the post-doubled t
        draw += 1
        signs = _rademacher(seed, draw, G0.shape, rdt, dev)
        xs = x0[None, :] + t[:, None] * signs.to(x0.dtype)
        Gp = F.grad_pointwise(xs, torch.arange(N, device=dev))
        nmg_new = torch.sqrt(torch.sum(torch.abs(Gp - G0) ** 2, dim=1)).to(rdt)
        bad = nmg < eps
        nmg, t = torch.where(bad, nmg_new, nmg), torch.where(bad, t * 2, t)

    sqrt_n = torch.full((), float(x0.numel()), dtype=rdt, device=dev).sqrt()
    L_int = nmg / (t * sqrt_n) / N
    gamma = rdiv(cfg.alpha, L_int)
    hat_gamma = 1.0 / torch.sum(1.0 / gamma)
    av = hat_gamma * (
        torch.sum(s / gamma[:, None], dim=0) - torch.sum(G0, dim=0) / N)
    z = g.prox_only(av, hat_gamma)
    # adaptive cyclic starts at index 1 (state idxr init 0, :106-108)
    return FinitoAdaptiveState(
        s=s, gradf=G0, fi_x=fi_x, gamma=gamma, hat_gamma=hat_gamma, av=av,
        z=z, sweep=_init_sweep(seed, cfg, 1, dev, 0), it=1,
        status=int(Status.RUNNING))


def _finito_adaptive_step(F, g, cfg: FinitoCfg, state: FinitoAdaptiveState,
                          block=None, idx=None, inplace=False):
    """Reference Finito_adaptive.jl:100-155: single-index selection,
    backtracking on the descent-lemma model with closed-form rescaling of
    (av, hat_γ), γ-underflow abort, then the table/average/prox update.
    The line search reads its test on the host every round. ``block``
    (sweeps 2, 3) or ``idx`` (sweeping 1) replace the index's draw."""
    N = cfg.N
    rdt = state.gamma.dtype
    eps = torch.finfo(rdt).eps
    sweep = state.sweep
    if cfg.sweeping == Sweep.RANDOM:
        if idx is None:
            idx, _, sweep = next_block(sweep, N, 1, cfg.sweeping)
        else:
            sweep = sweep._replace(pos=sweep.pos + 1)
        i = int(torch.as_tensor(idx).reshape(-1)[0])
    else:
        i, sweep = _next_block(cfg, sweep, block)
        i = int(i)
    s_i = state.s[i].clone()
    gradf_i = state.gradf[i].clone()
    fi_xi = state.fi_x[i]

    gi, hat, av, z = state.gamma[i], state.hat_gamma, state.av, state.z
    res = z - s_i
    while True:
        abort = bool(gi < cfg.tol_b / N)
        fi_z = F.value_i(z, i).to(rdt)
        model = (fi_xi + torch.real(torch.vdot(gradf_i, res)).to(rdt)
                 + rdiv(0.5 * N * cfg.alpha, gi)
                 * torch.sum(torch.abs(res) ** 2).to(rdt))
        tolv = 10 * eps * (1 + torch.abs(fi_z))
        if abort or bool(fi_z <= model + tolv):
            break
        # shrink γ_i and rescale the aggregate in closed form
        gi_new = gi * 0.8
        av1 = av / hat
        av1 = av1 + s_i / gi_new - s_i / gi
        hat_new = 1.0 / (1.0 / hat + 1.0 / gi_new - 1.0 / gi)
        av = av1 * hat_new
        z = g.prox_only(av, hat_new)
        res = z - s_i
        gi, hat = gi_new, hat_new
    if abort:
        return state._replace(sweep=sweep,
                              status=int(Status.GAMMA_UNDERFLOW))

    tables = [state.s, state.gradf, state.fi_x, state.gamma]
    if not inplace:
        tables = [t.clone() for t in tables]
    s, gradf, fi_x, gamma = tables
    gamma[i] = gi
    av = av + (hat / gi) * (z - s_i)
    s[i] = z
    av = av + (hat / N) * gradf_i
    fi_z, g_new = F.value_and_grad_i(z, i)
    fi_x[i] = fi_z.to(rdt)
    gradf[i] = g_new
    av = av - (hat / N) * g_new
    return FinitoAdaptiveState(
        s=s, gradf=gradf, fi_x=fi_x, gamma=gamma, hat_gamma=hat, av=av,
        z=g.prox_only(av, hat), sweep=sweep, it=state.it + 1,
        status=state.status)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

_STEPS = {
    "basic": _finito_basic_step,
    "basic_coeff": _finito_coeff_step,
    "lfinito": _lfinito_step,
    "adaptive": _finito_adaptive_step,
}

# the tables a run owns once it has copied them (updated in place after)
_TABLES = {
    "basic": ("s",),
    "basic_coeff": ("c", "zb"),
    "lfinito": (),
    "adaptive": ("s", "gradf", "fi_x", "gamma"),
}


def _resident(N: int, n: int, B: int) -> bool:
    """Whether a coefficient run takes kernel #9 (else #14): JAX's bounds
    of its resident kernel (``finito_multistep_available``'s shape rules:
    N ≤ 1,048,576, d ≤ 1,024, 2 MB of f32 anchors)."""
    d = N // B
    return (N <= RESIDENT_MAX_ROWS and d <= RESIDENT_MAX_BLOCKS
            and d * n * 4 <= RESIDENT_MAX_ANCHOR_BYTES)


def _finito_run_fused(F, g, state: FinitoCoeffState, cfg: FinitoCfg,
                      steps: int, blocks=None):
    """Multistep driver of the coefficient variant, the counterpart of
    both JAX drivers (``_finito_run_fused`` and
    ``_finito_run_fused_streamed``): ``LAUNCH_STEPS`` steps a call of
    ``ops.finito_coeff_multistep_streamed`` when ``cfg.fused_stream``,
    else of ``ops.finito_coeff_multistep``, the last call the remainder.
    The blocks are the explicit ``blocks``, else the importance draws of
    (seed, it), else ``gen_block_ids`` windows of the sweep — the
    stepwise stream, vectorized. c, zb, z and av are copied once and
    then updated in place.

    No clamp: JAX's streamed driver stops each launch at its first
    same-launch revisit because its TPU kernel streams c through aliased
    windows, and aligns importance windows for the same reason. Here c
    and zb live in device memory and a revisit within a call reads the
    previous visit's values (#9 and #14: the persistent engine's grid
    barriers order them), so every call commits all its steps (``f`` =
    None). Both packages commit the stepwise stream."""
    from ciao_tpu_torch.ops import fused_block as fb

    N, B = cfg.N, cfg.batch
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    scale, mode, lam, aux = fb.oracle_scalar_consts(F, g)
    hat = state.hat_gamma.to(rows.device).float()
    scalars = torch.stack([scale, torch.full_like(scale, 1.0 / N), hat,
                           hat * lam.float(), mode, aux])
    invg = state.invg.float().contiguous()
    c, zb, z, av = (t.clone() for t in (state.c, state.zb, state.z, state.av))
    sweep, it = state.sweep, state.it
    for k0 in range(0, steps, LAUNCH_STEPS):
        K = min(LAUNCH_STEPS, steps - k0)
        if cfg.importance and blocks is None:
            blk = importance_draws(sweep.seed, it, K, cfg, state.qcum,
                                   state.qinv)[0] // B
        elif cfg.importance:
            blk = blocks[k0:k0 + K]
        else:
            drawn, sweep = gen_block_ids(sweep, K, N, B, cfg.sweeping)
            blk = drawn if blocks is None else blocks[k0:k0 + K]
        starts = (blk.long() * B).to(torch.int32)
        if cfg.fused_stream:
            fb.finito_coeff_multistep_streamed(
                rows, offs, starts, invg[blk.long()], c, zb, z, av, scalars,
                B, precision=cfg.fused_precision, rs=rs)
        else:
            fb.finito_coeff_multistep(rows, offs, starts, c, zb, invg, z, av,
                                      scalars, B,
                                      precision=cfg.fused_precision, rs=rs)
        it += K
    return state._replace(c=c, zb=zb, z=z, av=av, sweep=sweep, it=it)


def _schedule(x, steps: int, device, name: str):
    """An explicit schedule as a tensor on ``device`` with ``steps``
    leading entries."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    x = x.to(device=device, dtype=torch.int64)
    if x.shape[0] != steps:
        raise ValueError(f"{name} has {x.shape[0]} entries, expected {steps}")
    return x


def finito_run(F, g, state, cfg: FinitoCfg, variant: str, steps: int,
               blocks=None, idx=None):
    """Advance ``steps`` steps of ``variant`` (``basic``, ``basic_coeff``,
    ``lfinito``, ``adaptive``); a state that is not RUNNING stays as it is.
    An explicit schedule replaces the draws (the sweep state advances as
    it would): ``blocks`` the (steps,) block ids of a block sweep (the row
    ids of the adaptive variant, the importance draws' blocks), or for
    LFinito the (steps, d) per-epoch visit orders; ``idx`` the RANDOM
    sweep's rows, (steps, B) for the basic variant, (steps,) for the
    adaptive one. A coefficient run whose kernel gate is open takes the
    multistep driver; the other runs copy their tables once and step."""
    if state.status != Status.RUNNING:
        return state
    dev = state.z.device
    if blocks is not None:
        blocks = _schedule(blocks, steps, dev, "blocks")
    if idx is not None:
        idx = _schedule(idx, steps, dev, "idx")
    if variant == "basic_coeff" and (cfg.fused or cfg.fused_stream):
        return _finito_run_fused(F, g, state, cfg, steps, blocks)
    step = _STEPS[variant]
    state = state._replace(**{name: getattr(state, name).clone()
                              for name in _TABLES[variant]})
    for t in range(steps):
        kw = {}
        if variant == "lfinito":
            kw = dict(order=None if blocks is None else blocks[t])
        else:
            if blocks is not None:
                kw["block"] = blocks[t]
            if idx is not None:
                kw["idx"] = idx[t]
            kw["inplace"] = True
        state = step(F, g, cfg, state, **kw)
        if state.status != Status.RUNNING:
            break
    return state


def finito_step(F, g, state, cfg: FinitoCfg, variant: str):
    """One step of ``variant``; the state passed in stays valid."""
    return _STEPS[variant](F, g, cfg, state)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finito:
    """Finito/MISO solver facade (reference ``Finito.jl:32-64``).

    Keyword knobs mirror the reference: γ (scalar or per-index array),
    ``sweeping`` (1 random / 2 cyclic / 3 shuffled), ``LFinito``,
    ``adaptive``, ``minibatch=(flag, size)`` (the flag is dead in the
    reference — only the size is consulted, Finito.jl:89 — kept for API
    parity), ``maxit``, ``verbose``, ``freq``, ``α``, ``tol``, ``tol_b``.
    ``tol`` is declared but unused in the reference step, kept for
    parity. ``seed`` seeds the port's own draws. ``device`` is where the
    run happens (default: x0's device for a tensor x0, else the card when
    there is one)."""

    gamma: Optional[object] = None
    sweeping: int = 1
    LFinito: bool = False
    adaptive: bool = False
    minibatch: Tuple[bool, int] = (False, 1)
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    tol: float = 1e-8
    tol_b: float = 1e-9
    table: str = "auto"  # "full" (N, n) | "coeff" (N,) | "auto" (coeff if rank-1)
    # Lipschitz-proportional block draws over the RANDOM sweep: needs
    # sweeping=1, the coefficient table, L and N % batch == 0
    importance_sampling: bool = False
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")
        if self.table not in ("auto", "full", "coeff"):
            raise ValueError(f"table must be 'auto', 'full' or 'coeff', not "
                             f"{self.table!r}")
        if self.importance_sampling:
            if self.sweeping != 1:
                raise ValueError(
                    "Finito importance_sampling replaces the RANDOM "
                    "sweep — set sweeping=1")
            if self.LFinito or self.adaptive:
                raise ValueError(
                    "Finito importance_sampling: basic variant only")
            if self.table == "full":
                raise ValueError(
                    "Finito importance_sampling needs the coefficient "
                    "table (table='auto' or 'coeff')")
        if self.gamma is not None and not float(
                np.min(np.asarray(torch.as_tensor(self.gamma).cpu()))) > 0:
            raise ValueError("γ must be positive")
        if self.maxit < 1 or self.freq < 1 or self.minibatch[1] < 1:
            raise ValueError("maxit, freq and the minibatch size must be at "
                             "least 1")
        if not (self.tol > 0 and self.tol_b > 0):
            raise ValueError("tol and tol_b must be positive")
        if self.sweeping not in (1, 2, 3):
            raise ValueError(f"sweeping must be 1, 2 or 3, not "
                             f"{self.sweeping}")

    @property
    def _variant(self):
        if self.LFinito:
            return "lfinito"
        if self.adaptive:
            return "adaptive"
        return "basic"

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block as fb

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rdt = real_dtype_of(x0)
        B = self.minibatch[1]
        variant = self._variant
        coeff_rows = (getattr(F, "supports_coeff", False)
                      and hasattr(F, "coeff_rows_data"))
        fused = False
        if (variant == "basic" and self.sweeping != Sweep.RANDOM
                and N % B == 0):
            # full-table kernel: f32/bf16 rows (int8 rows take the
            # coefficient table: the f32 table traffic dominates)
            fused = fb.finito_block_available(F, x0, B)
        elif variant == "lfinito" and N % B == 0 and coeff_rows:
            # whole-epoch kernels: anchor pass and in-kernel prox sweep
            fused = fb.lfinito_sweep_available(F, g, x0, B)
            if not fused:
                _warn_finito_fallback("Finito(LFinito=True)", F, g, x0)
        cfg = FinitoCfg(N=N, batch=B, sweeping=self.sweeping,
                        alpha=float(self.alpha), tol_b=float(self.tol_b),
                        fused=fused, fused_precision=self.fused_precision)
        seed = self.seed
        if variant == "adaptive":
            return x0, F, g, cfg, (lambda: finito_adaptive_init(
                F, g, x0, seed, cfg)), variant
        gamma = resolve_gamma_array(self.gamma, L, N, self.alpha, rdt,
                                    device)
        if variant == "lfinito":
            return x0, F, g, cfg, (lambda: lfinito_init(
                F, g, x0, gamma, seed, cfg)), variant
        coeff_ok = ((self.sweeping != Sweep.RANDOM
                     or self.importance_sampling)
                    and N % B == 0 and getattr(F, "supports_coeff", False))
        if self.table == "coeff" and not coeff_ok:
            raise ValueError(
                "Finito table='coeff' needs a rank-1 oracle and "
                "cyclic/shuffled sweeping with N divisible by batch")
        if self.importance_sampling and not coeff_ok:
            raise ValueError("Finito importance_sampling needs a rank-1 "
                             "oracle and N divisible by batch")
        if not (self.table in ("auto", "coeff") and coeff_ok):
            return x0, F, g, cfg, (lambda: finito_basic_init(
                F, g, x0, gamma, seed, cfg)), variant
        qcum = qinv = None
        if self.importance_sampling:
            # the SAGA facade's schedule construction (f64 host build,
            # clipped, π-scale CDF)
            if L is None:
                raise ValueError("Finito importance_sampling: provide L")
            if x0.is_complex():
                raise ValueError(
                    "Finito importance_sampling: real dtypes only")
            qcum, qinv, _, iwin = _importance_setup(L, N, B, True, rdt,
                                                    device)
            cfg = cfg._replace(importance=True, istrat=True, iwin=iwin)
        kernel_ok = fb.finito_multistep_available(F, g, x0, B)
        resident = kernel_ok and _resident(N, x0.numel(), B)
        cfg = cfg._replace(fused=resident,
                           fused_stream=kernel_ok and not resident)
        if not kernel_ok:
            _warn_finito_fallback("Finito", F, g, x0)
        return x0, F, g, cfg, (lambda: finito_coeff_init(
            F, g, x0, gamma, seed, cfg)._replace(qcum=qcum, qinv=qinv)), (
            "basic_coeff")

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init, variant = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return finito_run(F, g, state, cfg, variant, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.hat_gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init, variant = self._setup(x0, F, g, L, N)
        return SolverIterable(
            x0_orig, init, lambda s: finito_step(F, g, s, cfg, variant),
            rebase_fn=lambda s: finito_rebase(F, g, s, cfg),
            can_abort=(variant == "adaptive"),
        )
