"""Data-parallel (index-block sharded) solver paths on ``torch.distributed``.

Counterpart of ``ciao_tpu/parallel/dp.py``: the reference's own families
(SAGA/SAG, SVRG/SVRG++, Finito basic, coefficient, LFinito and adaptive,
ProShI), the forward-backward/FISTA polish of
:func:`~ciao_tpu_torch.parallel.deep.deep_solve_dp`, and the families
beyond the reference (Katyusha, SARAH, L-SVRG, L-Katyusha, Point-SAGA,
SSNM, Davis-Yin/Douglas-Rachford, Condat-Vũ/Chambolle-Pock,
PANOC/ZeroFPR; Condat-Vũ's compensated route serves
:func:`~ciao_tpu_torch.parallel.deep.deep_solve_pd_dp`). JAX runs each step
under ``shard_map`` on a device mesh; here each rank is a process that
holds its own rows (:func:`~ciao_tpu_torch.parallel.mesh.shard_finite_sum`)
and runs the same local step:

  * the (N, n) tables, the per-index stepsizes γ_i and the oracle's rows
    live cut by index block: rank r owns N/D contiguous rows, touches
    only those, and its state's table fields hold only those;
  * each step draws the rank's minibatch from its own block;
  * every JAX ``psum`` is one ``all_reduce`` sum over the mesh's group
    (:func:`_psum`), the only traffic between ranks. A predicate that
    picks a branch is a function of replicated values alone (the step
    count, the sums' results), so every rank calls the same collectives
    in the same order.

There is no jit: :func:`build_dp_functions` returns plain ``init``,
``step``, ``run`` and ``rebase`` closures over the rank's tensors.

Schedules are the port's own counter hash (``ciao_tpu_torch.sampling``),
a pure function of (seed, step, rank): the rank is folded into the seed
(:func:`_rank_seed`) as JAX folds ``axis_index`` into its key. torch
cannot draw threefry, so every ``run`` also takes the rank's explicit
schedule (``starts`` or ``idx``), which the parity tests derive from
JAX's own (key, it, axis_index) draws. L-SVRG's and L-Katyusha's anchor
coins are drawn from (seed, it) alone, the same on every rank, as JAX's
are from (key, it); ``coins`` replaces them.

Sweeping over the local block (reference ``Finito.jl:153``): 1 = a fresh
uniform draw a step; 2 = cyclic over static contiguous sub-blocks; 3 =
a shuffled sub-block order each local epoch.

Kernels (on the card, gates open on the LOCAL shard): SAGA's local
rounds run on #3 ``saga_coeff_multistep``, coefficient Finito's on #9
``finito_coeff_multistep``, LFinito's local epoch on #6
``coeff_apply_all`` and #8 (``lfinito_sweep_chunked``), SVRG's local
inner loop on #5 (``svrg_inner_chunked``, SVRG++ too: launches of
min(64, m) steps and a stepwise remainder) with its anchor on #6,
ProShI's cyclic local rounds on #18 ``proshi_multistep``, and
Katyusha's local inner loop on #10 (``katyusha_inner_chunked``) and
SARAH's on #11 (``sarah_inner_chunked``), their anchor and bootstrap on
#6. Each launch
runs on the rank's own rows; a kernel that fails raises. The other
families beyond the reference run no kernel over the mesh, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ciao_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, make_mesh, shard_finite_sum,
)
from ciao_tpu_torch.prox import Zero
from ciao_tpu_torch.sampling import (
    Sweep, _M32, _mix32, _permutation, _random_rows, _seed_key,
)
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    rdiv,
    real_dtype_of,
    resolve_gamma_array,
    run_solver_loop,
)
from ciao_tpu_torch.solvers.finito import _rademacher
from ciao_tpu_torch.solvers.proshi import _coupling as _proshi_coupling
from ciao_tpu_torch.solvers.saga import (
    LAUNCH_STEPS, SAGACfg, _scalars_row, _warn_fallback, block_starts,
)
from ciao_tpu_torch.solvers.svrg import _outer_seed


# ---------------------------------------------------------------------------
# collectives and stateless per-rank schedules
# ---------------------------------------------------------------------------

def _psum(mesh: Mesh, x):
    """The sum of ``x`` over the mesh's ranks: one ``all_reduce``, on a
    copy (the collective works in place)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y


def _rank_seed(seed: int, rank: int) -> int:
    """The 64-bit seed of rank ``rank``'s draws: (seed, rank) through
    the counter hash, as JAX folds ``axis_index`` into its key."""
    return (_seed_key(seed) << 32) | _mix32((rank & _M32) ^ 0x7F4A7C15)


def _local_round_starts(seed: int, it0: int, n_loc: int, B: int, K: int,
                        sweeping: int, rank: int, device):
    """The rank's block starts of steps it0..it0+K-1 in one vectorized
    pass, (K,) int32 on ``device``: iid uniform sub-blocks (random), the
    cyclic walk, or a fresh shuffled order each local epoch of n_loc/B
    steps."""
    d = n_loc // B
    rs = _rank_seed(seed, rank)
    if sweeping == Sweep.RANDOM:
        return block_starts(rs, it0, K, d, B, device)
    its = torch.arange(it0 - 1, it0 - 1 + K, dtype=torch.int64,
                       device=device)
    pos = its % d
    if sweeping == Sweep.CYCLIC:
        return (pos * B).to(torch.int32)
    e0 = (it0 - 1) // d
    orders = torch.stack([_permutation(rs, e, d, device)
                          for e in range(e0, (it0 + K - 2) // d + 1)])
    return (orders[its // d - e0, pos].long() * B).to(torch.int32)


def local_block_start(seed: int, it: int, n_loc: int, b_loc: int,
                      sweeping: int, rank: int, device="cpu"):
    """The rank's contiguous-block START for step ``it`` (a 0-d int32
    tensor): random, cyclic or per-epoch-shuffled sub-blocks of its
    [0, n_loc) rows. Deterministic in (seed, it, rank)."""
    return _local_round_starts(seed, it, n_loc, b_loc, 1, sweeping, rank,
                               device)[0]


def local_indices(seed: int, it: int, n_loc: int, b_loc: int, sweeping: int,
                  rank: int, device="cpu"):
    """The rank's (b_loc,) row draw for step ``it`` from its own
    [0, n_loc) block: b_loc distinct rows (random), else the rows of
    :func:`local_block_start`'s sub-block. Deterministic in (seed, it,
    rank)."""
    if sweeping == Sweep.RANDOM:
        return _random_rows(_rank_seed(seed, rank), it, n_loc, b_loc, device)
    start = local_block_start(seed, it, n_loc, b_loc, sweeping, rank, device)
    return start.long() + torch.arange(b_loc, device=device)


def _global_single_index(seed: int, it: int, N: int, sweeping: int) -> int:
    """The adaptive variant's one GLOBAL index for step ``it``, the same
    on every rank (no rank folded in): cyclic from index 0, shuffled with
    the first epoch in natural order, or iid uniform."""
    if sweeping == Sweep.CYCLIC:
        return (it - 1) % N
    if sweeping == Sweep.SHUFFLED:
        epoch, pos = divmod(it - 1, N)
        if epoch == 0:
            return pos
        return int(_permutation(seed, epoch, N, "cpu")[pos])
    return int(block_starts(seed, it, 1, N, 1, "cpu")[0])


def _rows(F, x, n_loc: int):
    """(n_loc, n) per-row gradients of the LOCAL rows, all at x, through
    the pointwise entry: oracles whose data serves every term (a
    ``SqrDistBox`` in a ``SumOracle``) keep a global static term count
    and still give locally-shaped outputs."""
    return F.grad_pointwise(x.expand(n_loc, x.shape[0]),
                            torch.arange(n_loc, device=x.device))


def _block(start, B: int, device):
    """The rows of the block at ``start`` (a tensor or an int)."""
    return torch.as_tensor(start, device=device).long() + torch.arange(
        B, device=device)


# ---------------------------------------------------------------------------
# config and states
# ---------------------------------------------------------------------------

class DPCfg(NamedTuple):
    """Static config of every DP family."""

    N: int          # global term count
    D: int          # ranks on the data axis
    b_loc: int      # per-rank minibatch
    sweeping: int
    alpha: float
    sag: bool = False
    plus: bool = False
    block: bool = False  # contiguous-block sampling
    coeff: bool = False  # (N,) coefficient table (rank-1 oracles)
    local_steps: int = 1  # >1: local-update rounds (see _saga_local_round)
    fused: bool = False   # the kernel path of the local round
    rebase_every: int = 0  # local rounds between exact av recomputes
    local: bool = False   # LFinito local sweep / SVRG local inner loop
    m_inner: int = 0      # Katyusha/SARAH inner steps; PANOC's L-BFGS memory
    variant: str = "basic"
    tol_b: float = 1e-9   # adaptive backtracking underflow bound
    max_ls: int = 10      # PANOC/ZeroFPR line-search trial bound
    adaptive: bool = False  # PANOC/ZeroFPR γ-backtracking mode
    polish_chunk: int = 0  # FB/FISTA/Condat-Vũ: compensated chunked gradient

    @property
    def n_loc(self):
        return self.N // self.D


class DPFinitoState(NamedTuple):
    s: torch.Tensor          # (n_loc, n) this rank's table rows
    gamma: torch.Tensor      # (n_loc,)
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.z


class DPFinitoCoeffState(NamedTuple):
    """Coefficient-compressed sharded Finito state (cf.
    ``solvers.finito.FinitoCoeffState``): the rank's (n_loc,)
    coefficients, (d_loc, n) per-block anchors and (d_loc,) Σ1/γ sums."""

    c: torch.Tensor
    zb: torch.Tensor
    invg: torch.Tensor
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.z


class DPFinitoAdaptiveState(NamedTuple):
    """Sharded adaptive-Finito state: the three tables (s, gradf, fi_x)
    and the stepsizes hold the rank's rows; hat_γ, av and z are the same
    on every rank, the backtracking running in lockstep against the
    owner's row, sent to all."""

    s: torch.Tensor
    gradf: torch.Tensor
    fi_x: torch.Tensor
    gamma: torch.Tensor
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.z


class DPLFinitoState(NamedTuple):
    gamma: torch.Tensor      # (n_loc,)
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    z_full: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.z


class DPSAGAState(NamedTuple):
    s: torch.Tensor          # (n_loc,) coefficients or (n_loc, n) rows
    gamma: torch.Tensor      # scalar
    av: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.z


class DPSVRGState(NamedTuple):
    gamma: torch.Tensor
    m: int
    av: torch.Tensor
    z: torch.Tensor
    z_full: torch.Tensor
    w: torch.Tensor
    canch: Optional[torch.Tensor]  # (n_loc,) anchor coefficients (coeff)
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.z_full


class DPProshiState(NamedTuple):
    s: torch.Tensor          # (n_loc, n) this rank's blocks
    gamma: torch.Tensor      # (n_loc,)
    hat_gamma: torch.Tensor
    av: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        """This rank's block solutions x_i = s_i + γ_i z, (n_loc, n)."""
        return self.s + self.gamma[:, None] * self.z[None, :]


class DPFBState(NamedTuple):
    gamma: torch.Tensor     # scalar stepsize
    t: torch.Tensor         # scalar Nesterov sequence (1.0 when not fast)
    x: torch.Tensor         # (n,) iterate, the same on every rank
    y: torch.Tensor         # (n,) extrapolated point
    it: int
    status: int

    @property
    def solution(self):
        return self.x


# ---------------------------------------------------------------------------
# Finito: basic (full table) and coefficient
# ---------------------------------------------------------------------------

def _finito_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded Finito bootstrap (reference Finito_basic.jl:44-89): the
    rank's table rows, then the harmonic-mean and weighted-average sums
    as two x-sized all-reduces."""
    n_loc, N = cfg.n_loc, cfg.N
    G = _rows(F, x0, n_loc)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = 1.0 / _psum(mesh, torch.sum(1.0 / gamma))
    av = hat_gamma * _psum(mesh, torch.sum(s / gamma[:, None], dim=0))
    z = g.prox_only(av, hat_gamma)
    return DPFinitoState(s=s, gamma=gamma, hat_gamma=hat_gamma, av=av, z=z,
                         seed=int(seed), it=1, status=int(Status.RUNNING))


def _finito_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                       idx=None):
    """Sharded Finito step (reference Finito_basic.jl:91-121): each rank
    refreshes b_loc of its own table rows against the shared z; the av
    innovation is one all-reduce."""
    N, B = cfg.N, cfg.b_loc
    dev = state.z.device
    if cfg.sweeping != Sweep.RANDOM:
        start = starts if starts is not None else local_block_start(
            state.seed, state.it, cfg.n_loc, B, cfg.sweeping, mesh.rank, dev)
        idx = _block(start, B, dev)
        G_B = F.grad_block(state.z, start, B)
    else:
        if idx is None:
            idx = local_indices(state.seed, state.it, cfg.n_loc, B,
                                cfg.sweeping, mesh.rank, dev)
        idx = torch.as_tensor(idx, device=dev).long()
        G_B = F.grad_batch(state.z, idx)
    gi = state.gamma[idx]
    s_new = state.z[None, :] - (gi / N)[:, None] * G_B
    delta = s_new - state.s[idx]
    state.s.index_copy_(0, idx, s_new)
    av = state.av + _psum(mesh, torch.sum(
        delta * (state.hat_gamma / gi)[:, None], dim=0))
    z = g.prox_only(av, state.hat_gamma)
    return state._replace(av=av, z=z, it=state.it + 1)


def _finito_coeff_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded coefficient-Finito bootstrap (the algebra of
    ``solvers.finito.finito_coeff_init`` with its sums all-reduced;
    hat_γ·Σ(1/γ) = 1 simplifies av to x0 − (hat/N)·Σ cᵢaᵢ)."""
    n_loc, N, B = cfg.n_loc, cfg.N, cfg.b_loc
    d_loc = n_loc // B
    c = F.coeff_all(x0)
    inv_gamma = 1.0 / gamma
    hat_gamma = 1.0 / _psum(mesh, torch.sum(inv_gamma))
    av = x0 - (hat_gamma / N) * _psum(mesh, F.apply_all(c))
    z = g.prox_only(av, hat_gamma)
    invg = torch.sum(inv_gamma.reshape(d_loc, B), dim=1)
    zb = x0.expand(d_loc, x0.shape[0]).clone()
    return DPFinitoCoeffState(c=c, zb=zb, invg=invg, hat_gamma=hat_gamma,
                              av=av, z=z, seed=int(seed), it=1,
                              status=int(Status.RUNNING))


def _finito_coeff_update(F, cfg: DPCfg, c, zb, invg, z, start, hat):
    """One coefficient-Finito block refresh of the LOCAL tables (in
    place): returns the rank's av innovation."""
    N, B = cfg.N, cfg.b_loc
    idx = _block(start, B, z.device)
    j = (torch.as_tensor(start, device=z.device).long() // B).view(1)
    c_new = F.coeff_block(z, start, B)
    innov = (hat * invg[j[0]] * (z - zb.index_select(0, j)[0])
             - (hat / N) * F.apply_rows_block(c_new - c[idx], start, B))
    c.index_copy_(0, idx, c_new)
    zb.index_copy_(0, j, z[None, :])
    return innov


def _finito_coeff_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                             idx=None):
    """Sharded coefficient-Finito step: each rank refreshes ONE of its
    blocks against the shared z; one x-sized all-reduce of the combined
    anchor and coefficient innovation."""
    start = starts if starts is not None else local_block_start(
        state.seed, state.it, cfg.n_loc, cfg.b_loc, cfg.sweeping, mesh.rank,
        state.z.device)
    hat = state.hat_gamma
    innov = _finito_coeff_update(F, cfg, state.c, state.zb, state.invg,
                                 state.z, start, hat)
    av = state.av + _psum(mesh, innov)
    return state._replace(av=av, z=g.prox_only(av, hat), it=state.it + 1)


def _round_boundary_av(mesh, cfg: DPCfg, it0: int, av0, av_loc, exact_fn):
    """Round-boundary av sync of the local-update modes: the delta resync
    ``av0 + psum(av_loc − av0)``, and every ``cfg.rebase_every`` rounds
    the EXACT recompute from the local tables (``exact_fn``, summed).
    The delta form is exact in real arithmetic, but in f32 its rounding
    accumulates across rounds with no restoring force. The branch is a
    function of the step count alone, the same on every rank, and each
    takes one all-reduce."""
    if cfg.rebase_every > 0:
        r = (it0 - 1) // cfg.local_steps
        if r % cfg.rebase_every == cfg.rebase_every - 1:
            return _psum(mesh, exact_fn())
    return av0 + _psum(mesh, av_loc - av0)


def _round_starts(mesh, cfg: DPCfg, state, starts):
    """The round's (K,) int32 block starts on the state's device: the
    explicit ``starts``, else the rank's draws."""
    dev = state.z.device
    if starts is not None:
        return torch.as_tensor(starts).to(device=dev,
                                          dtype=torch.int32).contiguous()
    return _local_round_starts(state.seed, state.it, cfg.n_loc, cfg.b_loc,
                               cfg.local_steps, cfg.sweeping, mesh.rank, dev)


def _finito_scalars(F, g, N: int, hat):
    """Kernel #9's (6,) scalars row [scale, 1/N, hat, hat·λ, mode, aux]."""
    from ciao_tpu_torch.ops.fused_block import oracle_scalar_consts

    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    hat = hat.to(scale.device).float()
    return torch.stack([scale, torch.full_like(scale, 1.0 / N), hat,
                        hat * lam.float(), mode, aux])


def _finito_coeff_local_round(F, g, mesh, cfg: DPCfg, state, starts=None,
                              idx=None):
    """LOCAL-UPDATE round of coefficient Finito (beyond the reference):
    K steps against the rank's own av and z with NO collective, then one
    round-boundary sync av ← av₀ + psum(av_d − av₀), z ← prox(av). Exact:
    every table row and block anchor is owned by one rank. On the card
    the K steps are ONE launch of #9 ``finito_coeff_multistep``."""
    K = cfg.local_steps
    hat = state.hat_gamma
    av0 = state.av
    st = _round_starts(mesh, cfg, state, starts)
    c, zb = state.c, state.zb
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import finito_coeff_multistep

        rows, offs = F.coeff_rows_data()
        z, av = state.z.clone(), av0.clone()
        finito_coeff_multistep(rows, offs, st, c, zb,
                               state.invg.float().contiguous(), z, av,
                               _finito_scalars(F, g, cfg.N, hat), cfg.b_loc,
                               rs=F.coeff_rows_scale())
    else:
        av, z = av0, state.z
        for k in range(K):
            av = av + _finito_coeff_update(F, cfg, c, zb, state.invg, z,
                                           st[k], hat)
            z = g.prox_only(av, hat)
    av = _round_boundary_av(
        mesh, cfg, state.it, av0, av,
        lambda: hat * (state.invg @ zb - F.apply_all(c) / cfg.N))
    return state._replace(av=av, z=g.prox_only(av, hat), it=state.it + K)


def _finito_coeff_step_or_round(F, g, mesh, cfg, state, starts=None,
                                idx=None):
    if cfg.local_steps > 1:
        return _finito_coeff_local_round(F, g, mesh, cfg, state, starts)
    return _finito_coeff_step_local(F, g, mesh, cfg, state, starts)


def _finito_coeff_rebase_local(F, g, mesh, cfg: DPCfg, state):
    """Sharded ``solvers.finito.finito_rebase``: av = hat_γ·Σ(invg_j·zb_j
    − c_i·a_i/N) with the sums all-reduced; z re-proxed."""
    hat = state.hat_gamma
    av = hat * _psum(mesh, state.invg @ state.zb
                     - F.apply_all(state.c) / cfg.N)
    return state._replace(av=av, z=g.prox_only(av, hat))


# ---------------------------------------------------------------------------
# adaptive Finito
# ---------------------------------------------------------------------------

def _finito_adaptive_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded adaptive-Finito bootstrap (reference Finito_adaptive.jl:
    60-97): the finite-difference L probe with its doubling retry runs on
    the rank's rows alone (trip counts may differ between ranks; no
    collective inside), then hat_γ and av are one stacked all-reduce.
    ``gamma`` is ignored: the probe gives the stepsizes."""
    del gamma
    N, n_loc, dev = cfg.N, cfg.n_loc, x0.device
    rdt = real_dtype_of(x0)
    fi_x, G0 = F.value_and_grad_all(x0)
    s = x0.expand(G0.shape).clone()
    G1 = F.grad_all(x0 + torch.ones_like(x0))
    nmg = torch.sqrt(torch.sum(torch.abs(G1 - G0) ** 2, dim=1)).to(rdt)
    eps = torch.finfo(rdt).eps
    t = torch.ones(n_loc, dtype=rdt, device=dev)
    probe_seed = _rank_seed(seed, mesh.rank)
    draw = 0
    while bool((nmg < eps).any()):
        draw += 1
        signs = _rademacher(probe_seed, draw, G0.shape, rdt, dev)
        xs = x0[None, :] + t[:, None] * signs.to(x0.dtype)
        Gp = F.grad_pointwise(xs, torch.arange(n_loc, device=dev))
        nmg_new = torch.sqrt(torch.sum(torch.abs(Gp - G0) ** 2,
                                       dim=1)).to(rdt)
        bad = nmg < eps
        nmg, t = torch.where(bad, nmg_new, nmg), torch.where(bad, t * 2, t)
    sqrt_n = torch.full((), float(x0.numel()), dtype=rdt, device=dev).sqrt()
    L_int = nmg / (t * sqrt_n) / N
    gam = rdiv(cfg.alpha, L_int)
    # one stacked all-reduce: [Σ 1/γ, Σ s/γ − Σ G0/N] over the ranks
    part = torch.cat([torch.sum(1.0 / gam)[None].to(x0.dtype),
                      torch.sum(s / gam[:, None], dim=0)
                      - torch.sum(G0, dim=0) / N])
    tot = _psum(mesh, part)
    hat_gamma = (1.0 / torch.real(tot[0])).to(rdt)
    av = hat_gamma * tot[1:]
    z = g.prox_only(av, hat_gamma)
    return DPFinitoAdaptiveState(
        s=s, gradf=G0, fi_x=fi_x.to(rdt), gamma=gam, hat_gamma=hat_gamma,
        av=av, z=z, seed=int(seed), it=1, status=int(Status.RUNNING))


def _finito_adaptive_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                                idx=None):
    """One sharded adaptive-Finito step (reference Finito_adaptive.jl:
    100-155), in LOCKSTEP: the owner of the global index sends its row
    (s_i, ∇f_i) in one stacked all-reduce and (f_i(x_i), γ_i) in another;
    every rank then runs the same backtracking loop on the same values,
    each trial paying one scalar all-reduce for f_i(z) (only the owner
    holds row i). The table writes land on the owner's rows. ``idx``
    replaces the step's global index."""
    if state.status != Status.RUNNING:
        return state
    N = cfg.N
    rdt = real_dtype_of(state.av)
    eps = torch.finfo(rdt).eps
    i_glob = (int(idx) if idx is not None else _global_single_index(
        state.seed, state.it, N, cfg.sweeping))
    owner, i_loc = divmod(i_glob, cfg.n_loc)
    mine = mesh.rank == owner

    def bcast(v):
        return _psum(mesh, v if mine else torch.zeros_like(v))

    rows = bcast(torch.stack([state.s[i_loc], state.gradf[i_loc]]))
    s_i, gradf_i = rows[0], rows[1]
    scal = bcast(torch.stack([state.fi_x[i_loc].to(rdt),
                              state.gamma[i_loc].to(rdt)]))
    fi_xi, gi = scal[0], scal[1]
    hat, av, z = state.hat_gamma, state.av, state.z
    res = z - s_i
    while True:
        abort = bool(gi < cfg.tol_b / N)
        fi_z = bcast(F.value_i(z, i_loc).to(rdt))
        model = (fi_xi + torch.real(torch.vdot(gradf_i, res)).to(rdt)
                 + rdiv(0.5 * N * cfg.alpha, gi)
                 * torch.sum(torch.abs(res) ** 2).to(rdt))
        tolv = 10 * eps * (1 + torch.abs(fi_z))
        if abort or bool(fi_z <= model + tolv):
            break
        gi_new = gi * 0.8
        av1 = av / hat + s_i / gi_new - s_i / gi
        hat_new = 1.0 / (1.0 / hat + 1.0 / gi_new - 1.0 / gi)
        av = av1 * hat_new
        z = g.prox_only(av, hat_new)
        res = z - s_i
        gi, hat = gi_new, hat_new
    if abort:
        return state._replace(status=int(Status.GAMMA_UNDERFLOW))
    av = av + (hat / gi) * (z - s_i)
    av = av + (hat / N) * gradf_i
    fi_new_loc, g_new_loc = F.value_and_grad_i(z, i_loc)
    g_new = bcast(g_new_loc)
    fi_new = bcast(fi_new_loc.to(rdt))
    if mine:
        state.gamma[i_loc] = gi
        state.s[i_loc] = z
        state.fi_x[i_loc] = fi_new
        state.gradf[i_loc] = g_new
    av = av - (hat / N) * g_new
    return state._replace(hat_gamma=hat, av=av, z=g.prox_only(av, hat),
                          it=state.it + 1)


# ---------------------------------------------------------------------------
# LFinito
# ---------------------------------------------------------------------------

def _lfinito_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded LFinito bootstrap (reference Finito_LFinito.jl:39-74):
    O(n) memory a rank, only γ is cut."""
    hat_gamma = 1.0 / _psum(mesh, torch.sum(1.0 / gamma))
    av = x0 - (hat_gamma / cfg.N) * _psum(mesh, F.grad_sum_all(x0))
    return DPLFinitoState(gamma=gamma, hat_gamma=hat_gamma, av=av, z=av,
                          z_full=av, seed=int(seed), it=1,
                          status=int(Status.RUNNING))


def _lfinito_order(mesh, cfg: DPCfg, state, starts):
    """The epoch's (d_loc,) visit order as block ids (int64): the explicit
    ``starts`` (block starts in visit order) divided by B, else a fresh
    rank-folded permutation (shuffled) or the natural order."""
    dev = state.z.device
    d_loc = cfg.n_loc // cfg.b_loc
    if starts is not None:
        return torch.as_tensor(starts, device=dev).long() // cfg.b_loc
    if cfg.sweeping == Sweep.SHUFFLED:
        return _permutation(_rank_seed(state.seed, mesh.rank), state.it,
                            d_loc, dev).long()
    return torch.arange(d_loc, device=dev)


def _lfinito_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                        idx=None):
    """Sharded LFinito epoch (reference Finito_LFinito.jl:77-103): the
    all-reduced full-gradient refresh, then a lockstep sweep whose inner
    step takes D sub-blocks (one a rank) against the same z, one
    all-reduce a block."""
    N, B = cfg.N, cfg.b_loc
    hat = state.hat_gamma
    z_full = g.prox_only(state.av, hat)
    av = z_full - (hat / N) * _psum(mesh, F.grad_sum_all(z_full))
    z = state.z
    for j in _lfinito_order(mesh, cfg, state, starts).tolist():
        z = g.prox_only(av, hat)
        diff = F.grad_sum_diff_block(z_full, z, j * B, B)
        inv_g = torch.sum(1.0 / state.gamma[j * B:(j + 1) * B])
        av = av + _psum(mesh, (hat / N) * diff + hat * inv_g * (z - z_full))
    return state._replace(av=av, z=z, z_full=z_full, it=state.it + 1)


def _lfinito_local_epoch(F, g, mesh, cfg: DPCfg, state, starts=None,
                         idx=None):
    """LOCAL-SWEEP LFinito epoch (beyond the reference): after the exact
    all-reduced anchor refresh, each rank sweeps ONLY its own blocks with
    a private av, and the epoch ends with one delta all-reduce
    av ← av₀ + psum(av_d − av₀): two collectives an epoch. The next
    epoch's refresh recomputes av from z_full, so no rebase is needed.
    On the card the refresh is one #6 ``coeff_apply_all`` pass and the
    sweep runs on #8 (``lfinito_sweep_chunked``)."""
    N, B = cfg.N, cfg.b_loc
    d_loc = cfg.n_loc // B
    hat = state.hat_gamma
    z_full = g.prox_only(state.av, hat)
    order = _lfinito_order(mesh, cfg, state, starts)
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import (
            lfinito_sweep_chunked, oracle_apply_all, oracle_scalar_consts,
        )

        rows, offs = F.coeff_rows_data()
        scale, mode, lam, aux = oracle_scalar_consts(F, g)
        c1, gsum = oracle_apply_all(F, z_full)
        av0 = z_full - (hat / N) * _psum(mesh, gsum)
        invg = torch.sum((1.0 / state.gamma).reshape(d_loc, B), dim=1)
        hat32 = hat.to(rows.device).float()
        scalars = torch.stack([scale, hat32, hat32 * lam.float(),
                               torch.full_like(scale, 1.0 / N), mode, aux])
        av_d, _ = lfinito_sweep_chunked(
            rows, offs, c1, (order * B).to(torch.int32).contiguous(),
            invg[order].float().contiguous(), av0.clone(), z_full, scalars,
            B, rs=F.coeff_rows_scale())
    else:
        av0 = z_full - (hat / N) * _psum(mesh, F.grad_sum_all(z_full))
        av_d = av0
        for j in order.tolist():
            z = g.prox_only(av_d, hat)
            diff = F.grad_sum_diff_block(z_full, z, j * B, B)
            inv_g = torch.sum(1.0 / state.gamma[j * B:(j + 1) * B])
            av_d = av_d + (hat / N) * diff + hat * inv_g * (z - z_full)
    av = av0 + _psum(mesh, av_d - av0)
    return state._replace(av=av, z=g.prox_only(av, hat), z_full=z_full,
                          it=state.it + 1)


def _lfinito_step_or_local(F, g, mesh, cfg, state, starts=None, idx=None):
    if cfg.local:
        return _lfinito_local_epoch(F, g, mesh, cfg, state, starts)
    return _lfinito_step_local(F, g, mesh, cfg, state, starts)


# ---------------------------------------------------------------------------
# SAGA / SAG
# ---------------------------------------------------------------------------

def _saga_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded SAGA bootstrap (reference SAGA_basic.jl:41-48). In coeff
    mode the rank's table is its (n_loc,) coefficients and the mean is
    one apply and one all-reduce."""
    if cfg.coeff:
        s = F.coeff_all(x0)
        av = _psum(mesh, F.apply_all(s)) / cfg.N
    else:
        s = _rows(F, x0, cfg.n_loc)
        av = _psum(mesh, torch.sum(s, dim=0)) / cfg.N
    z = g.prox_only((1 - gamma) * x0, gamma)
    return DPSAGAState(s=s, gamma=gamma, av=av, z=z, seed=int(seed), it=1,
                       status=int(Status.RUNNING))


def _saga_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """Sharded minibatch SAGA/SAG step (reference SAGA_basic.jl:53-67;
    minibatching is the reference's TODO at :74), the biased SAG /
    unbiased SAGA order kept. ``starts`` (block sampling) or ``idx``
    replace the rank's draw."""
    N, B = cfg.N, cfg.b_loc
    dev = state.z.device
    if cfg.block:
        start = starts if starts is not None else local_block_start(
            state.seed, state.it, cfg.n_loc, B, Sweep.RANDOM, mesh.rank, dev)
        rows = _block(start, B, dev)
        if cfg.coeff:
            c_new = F.coeff_block(state.z, start, B)
            innov = _psum(mesh, F.apply_rows_block(c_new - state.s[rows],
                                                   start, B))
            state.s.index_copy_(0, rows, c_new)
        else:
            G_B = F.grad_block(state.z, start, B)
            innov = _psum(mesh, torch.sum(G_B - state.s[rows], dim=0))
            state.s.index_copy_(0, rows, G_B)
    else:
        if idx is None:
            idx = local_indices(state.seed, state.it, cfg.n_loc, B,
                                cfg.sweeping, mesh.rank, dev)
        idx = torch.as_tensor(idx, device=dev).long()
        G_B = F.grad_batch(state.z, idx)
        innov = _psum(mesh, torch.sum(G_B - state.s[idx], dim=0))
        state.s.index_copy_(0, idx, G_B)
    diff = innov / (B * cfg.D)
    if cfg.sag:
        av = state.av + innov / N
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (diff + state.av)
        av = state.av + innov / N
    return state._replace(av=av, z=g.prox_only(w, state.gamma),
                          it=state.it + 1)


def _saga_local_round(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """LOCAL-UPDATE round (beyond the reference; the multi-GPU throughput
    mode): ``local_steps`` coefficient-SAGA steps on the rank's own rows,
    the direction the LOCAL minibatch's innovation plus the (stale)
    global table mean, each rank adding only its own rows' share to av;
    then ONE sync: av ← av₀ + psum(av_d − av₀) (exact: every row is
    owned by one rank) and z ← psum(z_d)/D (iterate averaging). On the
    card the K steps are ONE launch of #3 ``saga_coeff_multistep``."""
    N, B, K = cfg.N, cfg.b_loc, cfg.local_steps
    av0 = state.av
    st = _round_starts(mesh, cfg, state, starts)
    s = state.s
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import saga_coeff_multistep

        rows, offs = F.coeff_rows_data()
        z, av = state.z.clone(), av0.clone()
        saga_coeff_multistep(rows, offs, st, s, z, av,
                             _scalars_row(F, g, state, SAGACfg(
                                 N=N, sag=cfg.sag, batch=B)),
                             B, rs=F.coeff_rows_scale())
    else:
        z, av = state.z, av0
        for k in range(K):
            start = st[k]
            rows = _block(start, B, z.device)
            c_new = F.coeff_block(z, start, B)
            innov = F.apply_rows_block(c_new - s[rows], start, B)
            s.index_copy_(0, rows, c_new)
            if cfg.sag:
                av = av + innov / N
                w = z - state.gamma * av
            else:
                w = z - state.gamma * (innov / B + av)
                av = av + innov / N
            z = g.prox_only(w, state.gamma)
    av = _round_boundary_av(mesh, cfg, state.it, av0, av,
                            lambda: F.apply_all(s) / N)
    z = _psum(mesh, z) / cfg.D
    return state._replace(av=av, z=z, it=state.it + K)


def _saga_step_or_round(F, g, mesh, cfg, state, starts=None, idx=None):
    if cfg.local_steps > 1:
        return _saga_local_round(F, g, mesh, cfg, state, starts)
    return _saga_step_local(F, g, mesh, cfg, state, starts, idx)


def _saga_rebase_local(F, g, mesh, cfg: DPCfg, state):
    """Sharded ``solvers.saga.saga_rebase``: recompute av from the
    rank's coefficients (one apply, one all-reduce) after a row-storage
    swap; the full table is storage-consistent, returned unchanged."""
    if not cfg.coeff:
        return state
    return state._replace(av=_psum(mesh, F.apply_all(state.s)) / cfg.N)


# ---------------------------------------------------------------------------
# SVRG / SVRG++
# ---------------------------------------------------------------------------

def _svrg_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed, m):
    """Sharded SVRG bootstrap (reference SVRG_basic.jl:58-67): the
    anchor's full gradient is one local pass and one all-reduce; in coeff
    mode (the kernel path) the anchor's (n_loc,) coefficients are kept."""
    av = _psum(mesh, F.grad_sum_all(x0)) / cfg.N
    canch = F.coeff_all(x0) if cfg.coeff else None
    return DPSVRGState(gamma=gamma, m=int(m), av=av, z=torch.zeros_like(x0),
                       z_full=x0, w=x0, canch=canch, seed=int(seed), it=1,
                       status=int(Status.RUNNING))


def _inner_schedule(mesh, cfg: DPCfg, seed: int, it: int, m: int, k0: int,
                    k: int, starts, idx, dev):
    """Inner steps k0..k0+k-1 of outer step ``it`` (of m): block starts
    (k,) int32, or iid rows (k, b_loc) drawn with replacement from the
    rank's block; the explicit ``starts``/``idx`` when given. SVRG's,
    Katyusha's and SARAH's inner loops share it."""
    if cfg.block:
        if starts is not None:
            return torch.as_tensor(starts).to(dev, torch.int32)[k0:k0 + k]
        return _local_round_starts(_outer_seed(seed, it), k0 + 1, cfg.n_loc,
                                   cfg.b_loc, k, Sweep.RANDOM, mesh.rank, dev)
    if idx is not None:
        return torch.as_tensor(idx, device=dev).long()[k0:k0 + k]
    gen = torch.Generator(device=dev)
    gen.manual_seed(_rank_seed(_outer_seed(seed, it), mesh.rank)
                    & ((1 << 63) - 1))
    full = torch.randint(cfg.n_loc, (m, cfg.b_loc), generator=gen,
                         device=dev)
    return full[k0:k0 + k]


def _svrg_schedule(mesh, cfg: DPCfg, state, k0: int, k: int, starts, idx):
    return _inner_schedule(mesh, cfg, state.seed, state.it, state.m, k0, k,
                           starts, idx, state.z.device)


def _inner_diff(F, cfg: DPCfg, x1, x2, sched_k):
    """Σ over an inner step's rows of ∇f_i(x1) − ∇f_i(x2), the rank's:
    a block start or iid rows."""
    if cfg.block:
        return F.grad_sum_diff_block(x1, x2, sched_k, cfg.b_loc)
    return F.grad_sum_diff(x1, x2, sched_k)


def _svrg_direction(F, cfg: DPCfg, state, w, sched_k):
    """Σ over the step's rows of ∇f_i(z_full) − ∇f_i(w), the rank's."""
    return _inner_diff(F, cfg, state.z_full, w, sched_k)


def _svrg_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """Sharded SVRG outer step (reference SVRG_basic.jl:71-96): each inner
    step draws b_loc rows a rank from its block and the variance-reduced
    direction is all-reduced: distributed minibatch SVRG with global
    inner batch b_loc·D."""
    gamma, av = state.gamma, state.av
    sched = _svrg_schedule(mesh, cfg, state, 0, state.m, starts, idx)
    w, zsum = state.w, state.z
    for k in range(state.m):
        d = _psum(mesh, _svrg_direction(F, cfg, state, w, sched[k])) / (
            cfg.b_loc * cfg.D)
        w = g.prox_only(w + gamma * (d - av), gamma)
        zsum = zsum + w
    z_full = zsum / state.m
    return state._replace(
        m=state.m * 2 if cfg.plus else state.m,
        av=_psum(mesh, F.grad_sum_all(z_full)) / cfg.N,
        z=torch.zeros_like(zsum), z_full=z_full,
        w=w if cfg.plus else z_full, it=state.it + 1)


def _svrg_scalars(F, g, gamma, B: int):
    """Kernel #5's (6,) scalars row [scale, γ, γλ, 1/B, mode, aux]."""
    from ciao_tpu_torch.ops.fused_block import oracle_scalar_consts

    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    gamma = gamma.to(scale.device).float()
    return torch.stack([scale, gamma, gamma * lam.float(),
                        torch.full_like(scale, 1.0 / B), mode, aux])


# Steps a launch of #5 on SVRG's local inner loop (JAX's K).
SVRG_LAUNCH_STEPS = 64


def _svrg_local_outer(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """LOCAL-INNER SVRG outer step (beyond the reference): the whole
    inner loop runs on the rank's own rows, the direction its local
    anchor-minus-live diff plus the GLOBAL anchor mean, and only the
    outer boundary pays collectives (the iterate average and the anchor
    refresh; SVRG++ adds the w average). On the card the inner steps run
    on #5 ``svrg_coeff_multistep`` against the anchor coefficients, as
    :func:`~ciao_tpu_torch.ops.fused_block.svrg_inner_chunked` for SVRG
    and SVRG++ alike (m is a host int here, where JAX's SVRG++ traces it);
    the remainder is stepwise, on the same start stream. The anchor refresh is one #6
    ``coeff_apply_all`` pass."""
    N, B = cfg.N, cfg.b_loc
    gamma, av, m = state.gamma, state.av, state.m

    def inner_unfused(k0, steps, w, zsum):
        sched = _svrg_schedule(mesh, cfg, state, k0, steps, starts, idx)
        for k in range(steps):
            d = _svrg_direction(F, cfg, state, w, sched[k]) / B
            w = g.prox_only(w + gamma * (d - av), gamma)
            zsum = zsum + w
        return w, zsum

    canch = state.canch
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import (
            oracle_apply_all, svrg_inner_chunked,
        )

        rows, offs = F.coeff_rows_data()
        rs = F.coeff_rows_scale()
        scalars = _svrg_scalars(F, g, gamma, B)
        w, zsum = state.w.clone(), state.z.clone()

        # the outer step's m block starts in one pass (one hash, not one a
        # launch)
        sched = _svrg_schedule(mesh, cfg, state, 0, m, starts,
                               None).contiguous()

        def starts_fn(k0, K):
            return sched[k0:k0 + K]

        w, zsum, done = svrg_inner_chunked(
            rows, offs, canch, w, zsum, av, scalars, B, m, starts_fn,
            rs=rs, launch_steps=SVRG_LAUNCH_STEPS)
        if done < m:
            w, zsum = inner_unfused(done, m - done, w, zsum)
    else:
        w, zsum = inner_unfused(0, m, state.w, state.z)
    z_full = _psum(mesh, zsum) / (m * cfg.D)
    if cfg.fused:
        canch, gsum = oracle_apply_all(F, z_full)
        av_next = _psum(mesh, gsum) / N
    else:
        av_next = _psum(mesh, F.grad_sum_all(z_full)) / N
        if cfg.coeff:
            canch = F.coeff_all(z_full)
    return state._replace(
        m=m * 2 if cfg.plus else m, av=av_next, z=torch.zeros_like(zsum),
        z_full=z_full, w=(_psum(mesh, w) / cfg.D) if cfg.plus else z_full,
        canch=canch, it=state.it + 1)


def _svrg_step_or_local(F, g, mesh, cfg, state, starts=None, idx=None):
    if cfg.local:
        return _svrg_local_outer(F, g, mesh, cfg, state, starts, idx)
    return _svrg_step_local(F, g, mesh, cfg, state, starts, idx)


# ---------------------------------------------------------------------------
# ProShI
# ---------------------------------------------------------------------------

def _proshi_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded ProShI bootstrap (reference ProShI_basic.jl:45-90):
    hat_γ = Σγ and av = Σ s_i are the two all-reduces; z is the same on
    every rank."""
    n_loc, N = cfg.n_loc, cfg.N
    G = _rows(F, x0, n_loc)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = _psum(mesh, torch.sum(gamma))
    av = _psum(mesh, torch.sum(s, dim=0))
    return DPProshiState(s=s, gamma=gamma, hat_gamma=hat_gamma, av=av,
                         z=_proshi_coupling(g, av, hat_gamma),
                         seed=int(seed), it=1, status=int(Status.RUNNING))


def _proshi_update(F, cfg: DPCfg, s, gamma, z, rows, start=None):
    """One ProShI block refresh of the LOCAL table (in place): the rows'
    s_i ← s_i + γ_i z − (γ_i/N)∇f_i(s_i + γ_i z); returns Σ(s_new − s_old).
    ``start`` takes the contiguous-block entry of the oracle."""
    gi = gamma[rows]
    s_old = s[rows]
    s_tmp = s_old + gi[:, None] * z[None, :]
    G_B = (F.grad_pointwise_block(s_tmp, start, rows.shape[0])
           if start is not None else F.grad_pointwise(s_tmp, rows))
    s_new = s_tmp - (gi / cfg.N)[:, None] * G_B
    s.index_copy_(0, rows, s_new)
    return torch.sum(s_new - s_old, dim=0)


def _proshi_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                       idx=None):
    """Sharded ProShI step (reference ProShI_basic.jl:93-125): the block
    variables stay on their rank; the coupling delta is one all-reduce,
    the prox of the sum and z are computed alike on every rank."""
    B, dev = cfg.b_loc, state.z.device
    if cfg.sweeping != Sweep.RANDOM:
        start = starts if starts is not None else local_block_start(
            state.seed, state.it, cfg.n_loc, B, cfg.sweeping, mesh.rank, dev)
        delta = _proshi_update(F, cfg, state.s, state.gamma, state.z,
                               _block(start, B, dev), start)
    else:
        if idx is None:
            idx = local_indices(state.seed, state.it, cfg.n_loc, B,
                                cfg.sweeping, mesh.rank, dev)
        delta = _proshi_update(F, cfg, state.s, state.gamma, state.z,
                               torch.as_tensor(idx, device=dev).long())
    av = state.av + _psum(mesh, delta)
    return state._replace(av=av, z=_proshi_coupling(g, av, state.hat_gamma),
                          it=state.it + 1)


def _proshi_local_round(F, g, mesh, cfg: DPCfg, state, starts=None,
                        idx=None):
    """LOCAL-UPDATE ProShI round (beyond the reference): ``local_steps``
    block updates on the rank's own rows against a STALE coupling (its
    private av: the global av₀ plus its own s-deltas, z re-derived from
    it), then ONE all-reduce resyncs the exact global sum
    av ← av₀ + psum(av_d − av₀) and z is recomputed. ``rebase_every``
    rounds recompute av = Σ s_i from the table shards. On the card
    (cyclic sweeps, as JAX's gate) the K steps run on #18
    ``proshi_multistep``, ``LAUNCH_STEPS`` a launch."""
    B, K = cfg.b_loc, cfg.local_steps
    av0 = state.av
    st = _round_starts(mesh, cfg, state, starts)
    s = state.s
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import proshi_multistep
        from ciao_tpu_torch.solvers.proshi import _scalars_row

        rows, offs = F.coeff_rows_data()
        # [scale, 1/N, 1/hat, mode, glo, ghi, gmode, aux]: the single
        # card's row, from the state's hat_γ and the global N
        scalars = _scalars_row(F, g, state, cfg)
        gam = state.gamma.float().contiguous()
        av, z = av0.clone(), state.z.clone()
        for k0 in range(0, K, LAUNCH_STEPS):
            proshi_multistep(rows, offs, gam, s, st[k0:k0 + LAUNCH_STEPS],
                             av, z, scalars, B, rs=F.coeff_rows_scale())
    else:
        av, z = av0, state.z
        for k in range(K):
            av = av + _proshi_update(F, cfg, s, state.gamma, z,
                                     _block(st[k], B, z.device), st[k])
            z = _proshi_coupling(g, av, state.hat_gamma)
    av = _round_boundary_av(mesh, cfg, state.it, av0, av,
                            lambda: torch.sum(s, dim=0))
    return state._replace(av=av, z=_proshi_coupling(g, av, state.hat_gamma),
                          it=state.it + K)


def _proshi_step_or_round(F, g, mesh, cfg, state, starts=None, idx=None):
    if cfg.local_steps > 1:
        return _proshi_local_round(F, g, mesh, cfg, state, starts)
    return _proshi_step_local(F, g, mesh, cfg, state, starts, idx)


# ---------------------------------------------------------------------------
# forward-backward / FISTA
# ---------------------------------------------------------------------------

def _fb_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded ISTA/FISTA bootstrap: table-free, only the rows are cut."""
    rdt = real_dtype_of(x0)
    return DPFBState(gamma=gamma, t=torch.ones((), dtype=rdt,
                                               device=x0.device),
                     x=x0, y=x0, it=1, status=int(Status.RUNNING))


def _fb_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """One sharded forward-backward step: the full gradient is one local
    pass and ONE x-sized all-reduce; the prox and the extrapolation are
    computed alike on every rank. ``polish_chunk`` takes the local pass
    through the compensated chunked sum (``solvers.polish``): each
    rank's partial sum is compensated, and the D-way sum adds only
    ~√D·eps."""
    gamma = state.gamma
    if cfg.polish_chunk:
        from ciao_tpu_torch.solvers.polish import grad_sum_chunked

        part = grad_sum_chunked(F, state.y, cfg.polish_chunk)
    else:
        part = F.grad_sum_all(state.y)
    grad = _psum(mesh, part) / cfg.N
    x_new = g.prox_only(state.y - gamma * grad, gamma)
    if cfg.variant == "fista":
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.t * state.t))
        y_new = x_new + ((state.t - 1.0) / t_new) * (x_new - state.x)
    else:
        t_new, y_new = state.t, x_new
    return state._replace(t=t_new, x=x_new, y=y_new, it=state.it + 1)


# ---------------------------------------------------------------------------
# Katyusha
# ---------------------------------------------------------------------------

class DPKatyushaState(NamedTuple):
    Lmax: torch.Tensor
    tau1: torch.Tensor
    tau2: torch.Tensor
    av: torch.Tensor        # (n,) anchor μ = ∇f(x̃), the same on every rank
    x_tilde: torch.Tensor   # (n,) outer iterate
    y: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int
    # fused local-inner mode only: the rank's (n_loc,) anchor
    # coefficients c(x̃); None otherwise
    canch: Optional[torch.Tensor] = None

    @property
    def solution(self):
        return self.x_tilde


def _as_real(v, x0):
    """``v`` as a 0-d tensor of x0's real dtype on x0's device."""
    return torch.as_tensor(v, dtype=real_dtype_of(x0), device=x0.device)


def _katyusha_init_local(F, g, mesh, cfg: DPCfg, x0, Lmax, seed, tau1,
                         tau2):
    """Sharded Katyusha bootstrap: the anchor's full gradient is one local
    pass and one all-reduce; fused, the rank's anchor coefficients are
    kept."""
    canch = None
    if cfg.fused:
        canch = F.coeff_all(x0)
        av = _psum(mesh, F.apply_all(canch)) / cfg.N
    else:
        av = _psum(mesh, F.grad_sum_all(x0)) / cfg.N
    return DPKatyushaState(
        Lmax=_as_real(Lmax, x0), tau1=_as_real(tau1, x0),
        tau2=_as_real(tau2, x0), av=av, x_tilde=x0, y=x0, z=x0,
        seed=int(seed), it=1, status=int(Status.RUNNING), canch=canch)


def _katyusha_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                         idx=None):
    """One sharded Katyusha outer step. LOCKSTEP: each of the m inner
    steps draws one block (or b_loc rows) a rank and all-reduces the
    variance-reduced direction (global inner batch b_loc·D). LOCAL
    (``cfg.local``): the inner loop runs on the rank's rows against the
    global anchor, and the boundary averages (y, z, Σy) in one stacked
    all-reduce and refreshes the anchor in another. Fused (local only, on
    the card): the m inner steps are launches of #10
    (``katyusha_inner_chunked``, ``LAUNCH_STEPS`` a launch, the last the
    remainder) against the rank's anchor coefficients, and the anchor is
    one #6 ``coeff_apply_all`` pass. ``starts`` ((m,)) or ``idx`` ((m,
    b_loc)) replace the outer step's draws."""
    from ciao_tpu_torch.solvers.katyusha import KatyushaCfg, _katyusha_schedule

    N, B, m = cfg.N, cfg.b_loc, cfg.m_inner
    dev = state.y.device
    tau1, tau2, alpha, beta = _katyusha_schedule(
        KatyushaCfg(N=N, ns=cfg.variant == "ns"), state)
    av, xt = state.av, state.x_tilde
    sched = _inner_schedule(mesh, cfg, state.seed, state.it, m, 0, m, starts,
                            idx, dev)
    canch = state.canch
    if cfg.local and cfg.fused:
        from ciao_tpu_torch.ops.fused_block import (
            katyusha_inner_chunked, oracle_scalar_consts,
        )

        rows, offs = F.coeff_rows_data()
        scale, mode, lam, aux = oracle_scalar_consts(F, g)
        f32 = lambda v: v.to(device=rows.device, dtype=torch.float32)  # noqa: E731
        lam = lam.float()
        scalars = torch.stack([scale, f32(alpha), f32(beta),
                               f32(alpha * lam), f32(beta * lam),
                               torch.full_like(scale, 1.0 / B), mode,
                               f32(tau1), f32(tau2), aux])
        y, z = state.y.clone(), state.z.clone()
        ysum = torch.zeros_like(y)
        katyusha_inner_chunked(rows, offs, canch, xt, y, z, ysum, av,
                               scalars, B, sched.contiguous(), LAUNCH_STEPS,
                               rs=F.coeff_rows_scale())
    else:
        y, z = state.y, state.z
        ysum = torch.zeros_like(y)
        for k in range(m):
            x = tau1 * z + tau2 * xt + (1.0 - tau1 - tau2) * y
            diff = _inner_diff(F, cfg, x, xt, sched[k])
            gr = av + (diff / B if cfg.local
                       else _psum(mesh, diff) / (B * cfg.D))
            z = g.prox_only(z - alpha * gr, alpha)
            y = g.prox_only(x - beta * gr, beta)
            ysum = ysum + y
    if cfg.local:
        y, z, ysum = (_psum(mesh, torch.stack([y, z, ysum])) / cfg.D).unbind()
    x_tilde = ysum / m
    if cfg.local and cfg.fused:
        from ciao_tpu_torch.ops.fused_block import oracle_apply_all

        canch, gsum = oracle_apply_all(F, x_tilde)
        av = _psum(mesh, gsum) / N
    else:
        av = _psum(mesh, F.grad_sum_all(x_tilde)) / N
    return state._replace(
        tau1=tau1.to(state.tau1.dtype) if cfg.variant == "ns" else state.tau1,
        av=av, x_tilde=x_tilde, y=y, z=z, it=state.it + 1, canch=canch)


# ---------------------------------------------------------------------------
# SARAH
# ---------------------------------------------------------------------------

class DPSARAHState(NamedTuple):
    gamma: torch.Tensor
    eta: torch.Tensor       # ProxSARAH damping
    x_tilde: torch.Tensor   # (n,) outer iterate, the same on every rank
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.x_tilde


def _sarah_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed, eta):
    """Sharded SARAH bootstrap: table-free and no gradient work (the
    full pass v₀ belongs to the outer step)."""
    return DPSARAHState(gamma=_as_real(gamma, x0), eta=_as_real(eta, x0),
                        x_tilde=x0, seed=int(seed), it=1,
                        status=int(Status.RUNNING))


def _sarah_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """One sharded SARAH outer step: v₀ is the all-reduced full gradient
    (fused, one #6 pass), then m recursive inner steps. LOCKSTEP: each
    inner step all-reduces the estimator's innovation (global inner batch
    b_loc·D). LOCAL (``cfg.local``): each rank runs its own chain on its
    rows from the shared bootstrap (fused, on #11 ``sarah_inner_chunked``)
    and the boundary averages the chains' last iterates: with the next
    v₀, two all-reduces an outer step."""
    from ciao_tpu_torch.solvers.sarah import _damped_prox

    N, B, m = cfg.N, cfg.b_loc, cfg.m_inner
    gamma, eta = state.gamma, state.eta
    dev = state.x_tilde.device
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import oracle_apply_all

        v0 = _psum(mesh, oracle_apply_all(F, state.x_tilde)[1]) / N
    else:
        v0 = _psum(mesh, F.grad_sum_all(state.x_tilde)) / N
    w_prev = state.x_tilde
    w = _damped_prox(g, w_prev, v0, gamma, eta)
    sched = _inner_schedule(mesh, cfg, state.seed, state.it, m, 0, m, starts,
                            idx, dev)
    if cfg.local and cfg.fused:
        from ciao_tpu_torch.ops.fused_block import (
            oracle_scalar_consts, sarah_inner_chunked,
        )

        rows, offs = F.coeff_rows_data()
        scale, mode, lam, aux = oracle_scalar_consts(F, g)
        f32 = lambda t: t.to(device=rows.device, dtype=torch.float32)  # noqa: E731
        scalars = torch.stack([scale, f32(gamma), f32(gamma * lam.float()),
                               f32(eta), torch.full_like(scale, 1.0 / B),
                               mode, aux])
        ww = torch.stack([w_prev, w])
        sarah_inner_chunked(rows, offs, ww, v0.clone(), scalars, B,
                            sched.contiguous(), LAUNCH_STEPS,
                            rs=F.coeff_rows_scale())
        w = ww[1]
    else:
        v = v0
        for k in range(m):
            diff = _inner_diff(F, cfg, w, w_prev, sched[k])
            v = v + (diff / B if cfg.local
                     else _psum(mesh, diff) / (B * cfg.D))
            w_prev, w = w, _damped_prox(g, w, v, gamma, eta)
    if cfg.local:
        w = _psum(mesh, w) / cfg.D
    return state._replace(x_tilde=w, it=state.it + 1)


# ---------------------------------------------------------------------------
# L-SVRG / L-Katyusha
# ---------------------------------------------------------------------------

class DPLSVRGState(NamedTuple):
    gamma: torch.Tensor
    p: float                # anchor-refresh probability (compared in f32)
    av: torch.Tensor        # (n,) anchor gradient, the same on every rank
    z: torch.Tensor         # (n,) anchor point
    w: torch.Tensor         # (n,) iterate
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.w


class DPLKatyushaState(NamedTuple):
    Lmax: torch.Tensor
    sigma: torch.Tensor
    theta1: torch.Tensor
    theta2: torch.Tensor
    p: float
    av: torch.Tensor        # (n,) anchor gradient ∇f(w_anchor)
    w_anchor: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.y


def _loopless_draws(mesh, cfg: DPCfg, state, starts, idx, coins):
    """(the rank's sample, the step's coin): a block start or b_loc rows
    drawn with replacement from the rank's block, folded with the rank;
    and the Bernoulli(p) anchor coin of ``solvers.lsvrg.draw_coins``,
    a function of (seed, it) alone, so the same on every rank. The
    explicit ``starts``/``idx``/``coins`` when given."""
    from ciao_tpu_torch.solvers.lsvrg import _step_rows, draw_coins

    dev = state.av.device
    if cfg.block:
        sample = starts if starts is not None else local_block_start(
            state.seed, state.it, cfg.n_loc, cfg.b_loc, Sweep.RANDOM,
            mesh.rank, dev)
    elif idx is not None:
        sample = torch.as_tensor(idx, device=dev).long()
    else:
        sample = _step_rows(_rank_seed(state.seed, mesh.rank), state.it,
                            cfg.n_loc, cfg.b_loc, dev)
    flip = (bool(coins) if coins is not None
            else bool(draw_coins(state.seed, state.it, 1, state.p)[0]))
    return sample, flip


def _loopless_sums(F, mesh, cfg: DPCfg, x1, x2, sample, flip, anchor_at):
    """The step's ONE stacked all-reduce: the rank's Σ ∇f_i(x1) − ∇f_i(x2)
    over its sample, and on a coin flip its rows' full gradient at
    ``anchor_at`` (zeros otherwise): the branch hangs on the replicated
    coin, the collective does not."""
    d_loc = _inner_diff(F, cfg, x1, x2, sample)
    ref = F.grad_sum_all(anchor_at) if flip else torch.zeros_like(d_loc)
    return _psum(mesh, torch.stack([d_loc, ref])).unbind()


def _lsvrg_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed, p):
    """Sharded L-SVRG bootstrap: the anchor gradient is one local pass
    and one all-reduce."""
    av = _psum(mesh, F.grad_sum_all(x0)) / cfg.N
    return DPLSVRGState(gamma=_as_real(gamma, x0), p=float(p), av=av, z=x0,
                        w=x0, seed=int(seed), it=1,
                        status=int(Status.RUNNING))


def _lsvrg_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None,
                      coins=None):
    """One sharded loopless-SVRG step: the variance-reduced direction
    (global batch b_loc·D) and the coin-gated refresh partial in one
    all-reduce; on a flip the anchor jumps to the pre-update w."""
    N, B = cfg.N, cfg.b_loc
    gamma, w = state.gamma, state.w
    sample, flip = _loopless_draws(mesh, cfg, state, starts, idx, coins)
    d, ref = _loopless_sums(F, mesh, cfg, state.z, w, sample, flip, w)
    w_new = g.prox_only(w + gamma * (d / (B * cfg.D) - state.av), gamma)
    if flip:
        return state._replace(av=ref / N, z=w, w=w_new, it=state.it + 1)
    return state._replace(w=w_new, it=state.it + 1)


def _lsvrg_rebase_local(F, g, mesh, cfg: DPCfg, state):
    """Exact anchor gradient at the anchor point (one local pass and one
    all-reduce), after a row-storage swap: at small p the carried μ keeps
    the old rows' gradient until the next flip."""
    return state._replace(av=_psum(mesh, F.grad_sum_all(state.z)) / cfg.N)


def _lkatyusha_init_local(F, g, mesh, cfg: DPCfg, x0, Lmax, seed, sigma,
                          theta1, theta2, p):
    """Sharded L-Katyusha bootstrap: one local pass and one all-reduce
    for the anchor gradient."""
    av = _psum(mesh, F.grad_sum_all(x0)) / cfg.N
    return DPLKatyushaState(
        Lmax=_as_real(Lmax, x0), sigma=_as_real(sigma, x0),
        theta1=_as_real(theta1, x0), theta2=_as_real(theta2, x0),
        p=float(p), av=av, w_anchor=x0, y=x0, z=x0, seed=int(seed), it=1,
        status=int(Status.RUNNING))


def _lkatyusha_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                          idx=None, coins=None):
    """One sharded loopless-Katyusha step: the momentum coupling and the
    prox are computed alike on every rank; the block's anchor-to-live
    diff and the coin-gated refresh partial (at y) are one all-reduce."""
    N, B = cfg.N, cfg.b_loc
    th1, th2, sig = state.theta1, state.theta2, state.sigma
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / state.Lmax
    w = state.w_anchor
    x = th1 * state.z + th2 * w + (1.0 - th1 - th2) * state.y
    sample, flip = _loopless_draws(mesh, cfg, state, starts, idx, coins)
    d, ref = _loopless_sums(F, mesh, cfg, x, w, sample, flip, state.y)
    gr = state.av + d / (B * cfg.D)
    denom = 1.0 + eta * sig
    z_new = g.prox_only((state.z + (eta * sig) * x - step * gr) / denom,
                        step / denom)
    y_new = x + th1 * (z_new - state.z)
    if flip:
        state = state._replace(av=ref / N, w_anchor=state.y)
    return state._replace(y=y_new, z=z_new, it=state.it + 1)


def _lkatyusha_rebase_local(F, g, mesh, cfg: DPCfg, state):
    """Exact anchor gradient at the anchor point (cf.
    :func:`_lsvrg_rebase_local`)."""
    return state._replace(
        av=_psum(mesh, F.grad_sum_all(state.w_anchor)) / cfg.N)


# ---------------------------------------------------------------------------
# Point-SAGA and SSNM
# ---------------------------------------------------------------------------

class DPPointSAGAState(NamedTuple):
    gamma: torch.Tensor
    c: torch.Tensor         # (n_loc,) this rank's prox coefficients
    av: torch.Tensor        # (n,) table mean, the same on every rank
    x: torch.Tensor         # (n,) iterate
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.x


class DPSSNMState(NamedTuple):
    tau: torch.Tensor       # momentum weight
    eta: torch.Tensor       # stepsize
    c: torch.Tensor         # (n_loc,) this rank's coefficients
    zb: torch.Tensor        # (d_loc, n) this rank's blocks' stored points
    gbar: torch.Tensor      # (n,) global table mean
    x: torch.Tensor         # (n,) iterate
    seed: int
    it: int
    status: int

    @property
    def solution(self):
        return self.x


def _step_start(mesh, cfg: DPCfg, state, starts):
    """The step's block start: the explicit one, else the rank's draw."""
    if starts is not None:
        return starts
    return local_block_start(state.seed, state.it, cfg.n_loc, cfg.b_loc,
                             cfg.sweeping, mesh.rank, state.x.device)


def _point_saga_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed):
    """Sharded Point-SAGA bootstrap: the rank's coefficients and one
    all-reduced table mean."""
    c = F.coeff_all(x0)
    av = _psum(mesh, F.apply_all(c)) / cfg.N
    return DPPointSAGAState(gamma=_as_real(gamma, x0), c=c, av=av, x=x0,
                            seed=int(seed), it=1, status=int(Status.RUNNING))


def _point_saga_step_local(F, g, mesh, cfg: DPCfg, state, starts=None,
                           idx=None):
    """One sharded Point-SAGA step: each rank proxes a block of its rows
    around the shared shifted iterate (``pointprox_block``); the block
    contributions u = Σ(c − θ)·a are ONE all-reduce."""
    N, B = cfg.N, cfg.b_loc
    gamma = state.gamma
    v = state.x - gamma * state.av
    start = _step_start(mesh, cfg, state, starts)
    rows = _block(start, B, v.device)
    theta, u_loc = F.pointprox_block(v, state.c[rows], gamma, start, B)
    state.c.index_copy_(0, rows, theta)
    u = _psum(mesh, u_loc)
    return state._replace(x=v + (gamma / (B * cfg.D)) * u,
                          av=state.av - u / N, it=state.it + 1)


def _point_saga_rebase_local(F, g, mesh, cfg: DPCfg, state):
    """Exact table mean from the rank's coefficients (one apply and one
    all-reduce), after a row-storage swap."""
    return state._replace(av=_psum(mesh, F.apply_all(state.c)) / cfg.N)


def _ssnm_init_local(F, g, mesh, cfg: DPCfg, x0, tau, seed, eta):
    """Sharded SSNM bootstrap: the rank's coefficients and one all-reduced
    table mean; each of its d_loc blocks' stored point x0."""
    c = F.coeff_all(x0)
    gbar = _psum(mesh, F.apply_all(c)) / cfg.N
    zb = x0.expand(cfg.n_loc // cfg.b_loc, x0.shape[0]).clone()
    return DPSSNMState(tau=_as_real(tau, x0), eta=_as_real(eta, x0), c=c,
                       zb=zb, gbar=gbar, x=x0, seed=int(seed), it=1,
                       status=int(Status.RUNNING))


def _ssnm_rebase_local(F, g, mesh, cfg: DPCfg, state):
    """Exact ḡ from the rank's coefficients (cf.
    :func:`_point_saga_rebase_local`)."""
    return state._replace(gbar=_psum(mesh, F.apply_all(state.c)) / cfg.N)


def _ssnm_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """One sharded SSNM step: each rank draws a block of its rows and
    forms its OWN momentum point y_r = τx + (1 − τ)·φ_j from that block's
    stored point (each term anchored at its own point, so the averaged
    direction stays unbiased); the innovation is ONE all-reduce, the
    mirror step and the table-mean update are computed alike on every
    rank."""
    N, B = cfg.N, cfg.b_loc
    tau, eta = state.tau, state.eta
    start = _step_start(mesh, cfg, state, starts)
    rows = _block(start, B, state.x.device)
    j = rows[:1] // B
    y = tau * state.x + (1.0 - tau) * state.zb.index_select(0, j)[0]
    c_new = F.coeff_block(y, start, B)
    innov = _psum(mesh, F.apply_rows_block(c_new - state.c[rows], start, B))
    x = g.prox_only(state.x - eta * (innov / (B * cfg.D) + state.gbar), eta)
    state.c.index_copy_(0, rows, c_new)
    state.zb.index_copy_(0, j, y[None])
    return state._replace(gbar=state.gbar + innov / N, x=x, it=state.it + 1)


# ---------------------------------------------------------------------------
# Davis-Yin, Condat-Vũ, PANOC/ZeroFPR: full-gradient methods
# ---------------------------------------------------------------------------

def _full_grad_fn(F, mesh, cfg: DPCfg):
    """∇f(x) = psum(the rank's Σ∇f_i(x))/N: one local pass (compensated
    chunks with ``polish_chunk``, as :func:`_fb_step_local`) and ONE
    all-reduce."""
    if cfg.polish_chunk:
        from ciao_tpu_torch.solvers.polish import grad_sum_chunked

        return lambda x: _psum(mesh, grad_sum_chunked(
            F, x, cfg.polish_chunk)) / cfg.N
    return lambda x: _psum(mesh, F.grad_sum_all(x)) / cfg.N


def _dys_init_local(F, gh, mesh, cfg: DPCfg, x0, gamma, seed, lam):
    """Sharded Davis-Yin bootstrap: table-free, only the rows are cut.
    ``gh`` is the pair (g, h) of proximable terms; ``seed`` is unused
    (the method draws nothing)."""
    from ciao_tpu_torch.solvers.dys import DYSState

    return DYSState(gamma=_as_real(gamma, x0), lam=_as_real(lam, x0), z=x0,
                    xg=x0, it=1, status=int(Status.RUNNING))


def _dys_step_local(F, gh, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """One sharded Davis-Yin step: ``solvers.dys._dys_step`` with the
    full gradient one local pass and ONE all-reduce (its ``grad_fn``);
    both proxes are computed alike on every rank."""
    from ciao_tpu_torch.solvers.dys import _dys_step

    g, h = gh
    return _dys_step(F, g, h, None, state, grad_fn=_full_grad_fn(F, mesh,
                                                                  cfg))


def _pd_init_local(F, ghk, mesh, cfg: DPCfg, x0, tau, seed, sigma):
    """Sharded Condat-Vũ bootstrap: table-free. ``ghk`` is (g, h, K);
    ``seed`` is unused."""
    from ciao_tpu_torch.solvers.primal_dual import PDState

    K = ghk[2]
    return PDState(tau=_as_real(tau, x0), sigma=_as_real(sigma, x0), x=x0,
                   y=torch.zeros(K.out_dim(x0.shape[0]), dtype=x0.dtype,
                                 device=x0.device),
                   it=1, status=int(Status.RUNNING))


def _pd_step_local(F, ghk, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """One sharded Condat-Vũ step: ``solvers.primal_dual._pd_step`` with
    the full gradient one local pass (compensated chunks with
    ``polish_chunk``) and ONE all-reduce; K's products, both proxes and
    the dual update are computed alike on every rank."""
    from ciao_tpu_torch.solvers.primal_dual import _pd_step

    g, h, K = ghk
    return _pd_step(F, g, h, K, None, state,
                    grad_fn=_full_grad_fn(F, mesh, cfg))


class _PsumFBEOracle:
    """The oracle PANOC's step sees on a rank: each entry it uses runs on
    the rank's rows and all-reduces its sums, so ``solvers.panoc``'s step
    (L-BFGS, line search, adaptive γ) runs unchanged and alike on every
    rank. Every value its host reads (a trial's accept test, a halving's
    descent test) is computed from all-reduced sums, so every rank takes
    the same trial count and the same branch."""

    def __init__(self, mesh, F):
        self._mesh, self._F = mesh, F

    def value_sum_and_grad_sum_all(self, u):
        v, gsum = self._F.value_sum_and_grad_sum_all(u)
        return _psum(self._mesh, v), _psum(self._mesh, gsum)

    def value_sum_all(self, u):
        return _psum(self._mesh, self._F.value_sum_all(u))

    def grad_sum_all(self, u):
        return _psum(self._mesh, self._F.grad_sum_all(u))


def _panoc_cfg(cfg: DPCfg):
    """The single-card config of the DP step: no ``tol`` and no kernel
    (JAX's DP config leaves ``fused`` off)."""
    from ciao_tpu_torch.solvers.panoc import PANOCCfg

    return PANOCCfg(N=cfg.N, mem=cfg.m_inner, max_ls=cfg.max_ls,
                    zerofpr=cfg.variant == "zerofpr", tol=None,
                    adaptive=cfg.adaptive)


def _panoc_init_local(F, g, mesh, cfg: DPCfg, x0, gamma, seed, sigma):
    """Sharded PANOC/ZeroFPR bootstrap: ``solvers.panoc.panoc_init`` on
    :class:`_PsumFBEOracle`; the L-BFGS ring and every iterate are the
    same on every rank. ``seed`` is unused."""
    from ciao_tpu_torch.solvers.panoc import panoc_init

    return panoc_init(_PsumFBEOracle(mesh, F), g, x0, _as_real(gamma, x0),
                      _as_real(sigma, x0), _panoc_cfg(cfg))


def _panoc_step_local(F, g, mesh, cfg: DPCfg, state, starts=None, idx=None):
    """One sharded PANOC/ZeroFPR step: every FBE evaluation is one local
    pass and two all-reduces (the value and the gradient)."""
    from ciao_tpu_torch.solvers.panoc import _panoc_step

    return _panoc_step(_PsumFBEOracle(mesh, F), g, _panoc_cfg(cfg), state)


def _rebase_identity_local(F, g, mesh, cfg: DPCfg, state):
    """Families whose anchor is recomputed from a full pass every epoch
    (LFinito, SVRG) repair themselves in one epoch; the full-table Finito
    and ProShI states are storage-consistent by construction."""
    return state


# family -> (init, step, rebase, the table fields a run owns)
_FAMILY = {
    "finito": (_finito_init_local, _finito_step_local,
               _rebase_identity_local, ("s",)),
    "finito_coeff": (_finito_coeff_init_local, _finito_coeff_step_or_round,
                     _finito_coeff_rebase_local, ("c", "zb")),
    "finito_adaptive": (_finito_adaptive_init_local,
                        _finito_adaptive_step_local, _rebase_identity_local,
                        ("s", "gradf", "fi_x", "gamma")),
    "lfinito": (_lfinito_init_local, _lfinito_step_or_local,
                _rebase_identity_local, ()),
    "saga": (_saga_init_local, _saga_step_or_round, _saga_rebase_local,
             ("s",)),
    "svrg": (_svrg_init_local, _svrg_step_or_local, _rebase_identity_local,
             ()),
    "fb": (_fb_init_local, _fb_step_local, _rebase_identity_local, ()),
    "proshi": (_proshi_init_local, _proshi_step_or_round,
               _rebase_identity_local, ("s",)),
    "katyusha": (_katyusha_init_local, _katyusha_step_local,
                 _rebase_identity_local, ()),
    "lsvrg": (_lsvrg_init_local, _lsvrg_step_local, _lsvrg_rebase_local, ()),
    "lkatyusha": (_lkatyusha_init_local, _lkatyusha_step_local,
                  _lkatyusha_rebase_local, ()),
    "sarah": (_sarah_init_local, _sarah_step_local, _rebase_identity_local,
              ()),
    "dys": (_dys_init_local, _dys_step_local, _rebase_identity_local, ()),
    "pd": (_pd_init_local, _pd_step_local, _rebase_identity_local, ()),
    "panoc": (_panoc_init_local, _panoc_step_local, _rebase_identity_local,
              ()),
    "point_saga": (_point_saga_init_local, _point_saga_step_local,
                   _point_saga_rebase_local, ("c",)),
    "ssnm": (_ssnm_init_local, _ssnm_step_local, _ssnm_rebase_local,
             ("c", "zb")),
}
# the families whose steps flip the replicated anchor coin
_COIN_FAMILIES = ("lsvrg", "lkatyusha")


def _draws_blocks(family: str, cfg: DPCfg) -> bool:
    """Whether each step (round) of ``family`` draws contiguous block
    starts from :func:`_local_round_starts`'s stream."""
    if family in ("saga", "lsvrg", "lkatyusha"):
        return cfg.block
    if family in ("point_saga", "ssnm"):
        return True
    if family in ("finito", "proshi"):
        return cfg.sweeping != Sweep.RANDOM or (
            family == "proshi" and cfg.local_steps > 1)
    return family == "finito_coeff"


def _owned(state, names):
    """``state`` with copies of its table fields ``names``, which the
    steps then write in place."""
    return state._replace(**{k: getattr(state, k).clone() for k in names})


def build_dp_functions(family: str, mesh: Mesh, F, g, cfg: DPCfg):
    """``(init, step, run, rebase)`` of a family on this rank: plain
    closures over the rank's oracle part ``F``, the prox ``g`` (Davis-
    Yin's pair (g, h), Condat-Vũ's (g, h, K)), the mesh and the config
    (the counterpart of JAX's jitted ``shard_map`` bodies).

      * ``init(x0, a, seed, *extra)``, ``a`` the family's first scalar:
        γ (SAGA, SVRG, Finito, ProShI, FB, L-SVRG, SARAH, Point-SAGA,
        Davis-Yin, PANOC), L_max (Katyusha, L-Katyusha), τ (SSNM,
        Condat-Vũ); ``extra``: SVRG's m, Katyusha's (τ₁, τ₂), L-SVRG's p,
        L-Katyusha's (σ, θ₁, θ₂, p), SARAH's η, SSNM's η, Davis-Yin's λ,
        Condat-Vũ's σ, PANOC's σ;
      * ``step(state, starts=None, idx=None, coins=None)``: one step (a
        local round, an outer step), the state passed in left valid;
      * ``run(state, steps, starts=None, idx=None, coins=None)``:
        ``steps`` steps, the tables copied once and then written in place;
        a state that is not RUNNING stays as it is;
      * ``rebase(state)``: the storage-swap repair.

    ``starts``/``idx`` give the rank's explicit schedule, one entry a
    step: a block start (a round's (K,) starts; SVRG's, Katyusha's and
    SARAH's (m,) inner starts; LFinito's (d_loc,) starts in visit order),
    or rows ((b_loc,) for SAGA, Finito, ProShI, L-SVRG and L-Katyusha;
    the (m, b_loc) inner rows of SVRG, Katyusha and SARAH; the adaptive
    variant's global index). ``coins`` gives L-SVRG's and L-Katyusha's
    anchor coins, one a step; by default they are drawn from (seed, it)
    alone, the same on every rank."""
    init_local, step_local, rebase_local, tables = _FAMILY[family]

    def init(x0, a, seed, *extra):
        return init_local(F, g, mesh, cfg, x0, a, seed, *extra)

    def one(state, starts, idx, coin):
        if coin is None:
            return step_local(F, g, mesh, cfg, state, starts, idx)
        return step_local(F, g, mesh, cfg, state, starts, idx, coin)

    def step(state, starts=None, idx=None, coins=None):
        if state.status != Status.RUNNING:
            return state
        return one(_owned(state, tables), starts, idx, coins)

    def run(state, steps, starts=None, idx=None, coins=None):
        if state.status != Status.RUNNING:
            return state
        state = _owned(state, tables)
        if starts is None and idx is None and _draws_blocks(family, cfg):
            # the run's block starts in one vectorized pass: the same
            # (seed, it, rank) stream as a step's own draw
            K = max(cfg.local_steps, 1)
            starts = _local_round_starts(
                state.seed, state.it, cfg.n_loc, cfg.b_loc, steps * K,
                cfg.sweeping, mesh.rank, _device_of(state))
            starts = starts.view(steps, K) if K > 1 else starts
        if coins is None and family in _COIN_FAMILIES:
            from ciao_tpu_torch.solvers.lsvrg import draw_coins

            coins = draw_coins(state.seed, state.it, steps, state.p)
        for t in range(steps):
            state = one(state, None if starts is None else starts[t],
                        None if idx is None else idx[t],
                        None if coins is None else coins[t])
            if state.status != Status.RUNNING:
                break
        return state

    def rebase(state):
        return rebase_local(F, g, mesh, cfg, state)

    return init, step, run, rebase


def _device_of(state):
    """The device of a state's first tensor field."""
    return next(v for v in state if isinstance(v, torch.Tensor)).device


# ---------------------------------------------------------------------------
# facades
# ---------------------------------------------------------------------------

def _validate_mesh_batch(N, mesh, batch, sweeping, who):
    D = mesh.shape[DATA_AXIS]
    if N % D != 0:
        raise ValueError(
            f"{who}: N={N} must divide evenly over the {D}-device data axis "
            f"(pad the problem or pick a different mesh)")
    if batch % D != 0:
        raise ValueError(f"{who}: global batch={batch} must be divisible "
                         f"by D={D}")
    b_loc = batch // D
    n_loc = N // D
    if sweeping in (Sweep.CYCLIC, Sweep.SHUFFLED) and n_loc % b_loc != 0:
        raise ValueError(
            f"{who}: cyclic/shuffled sweeps need N/D={n_loc} divisible by "
            f"the per-device batch {b_loc}")
    if sweeping == Sweep.RANDOM and b_loc > n_loc:
        raise ValueError(f"{who}: per-device batch {b_loc} exceeds local "
                         f"block {n_loc}")
    return D, b_loc


def _dp_problem(mesh, x0, F, g, N, who):
    """(mesh, x0, the rank's oracle part, g, N) of a facade call. ``F``
    is the part :func:`shard_finite_sum` made for this rank, or a whole
    oracle, which is cut here (N must divide evenly either way)."""
    mesh = mesh if mesh is not None else make_mesh()
    x0 = torch.as_tensor(x0, device=mesh.device)
    g = (Zero() if g is None else g).to(mesh.device)
    shard = getattr(F, "dp_shard", None)
    if N is None:
        N = shard[0] if shard is not None else F.num_terms
    D = mesh.size
    if N % D != 0:
        raise ValueError(
            f"{who}: N={N} must divide evenly over the {D}-device data axis "
            f"(pad the problem or pick a different mesh)")
    if shard is None:
        F = shard_finite_sum(F, mesh, N)
    elif shard[1:] != (D, mesh.rank):
        raise ValueError(f"{who}: F is the part of rank {shard[2]} of "
                         f"{shard[1]}, not of rank {mesh.rank} of {D}")
    return mesh, x0, F.to(mesh.device), g, N


def _local_gamma(gamma_all, mesh, N):
    lo, hi = mesh.rows(N)
    return gamma_all[lo:hi].contiguous()


def _facade_fns(family, mesh, F, g, cfg, x0, gamma, seed, *extra):
    init_c, step_c, run_c, rebase_c = build_dp_functions(family, mesh, F, g,
                                                         cfg)
    return (lambda: init_c(x0, gamma, seed, *extra), step_c, run_c,
            rebase_c)


class _DPRun:
    """``__call__`` and ``iterator`` of a DP facade whose ``_setup``
    returns ``(x0, F, g, init, step, run, rebase)``; ``_shown`` names the
    state field that ``verbose`` prints."""

    _shown = "gamma"
    _can_abort = False

    @property
    def _maxit(self):
        return self.maxit

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, init, step, run, _ = self._setup(x0, F, g, L, N)
        shown = self._shown
        disp = lambda it, st: print(  # noqa: E731
            f"{it:5d} | {float(getattr(st, shown)):.3e}")
        state, it = run_solver_loop(init, run, self._maxit, self.verbose,
                                    self.freq, disp, observe)
        self._after(state)
        return self._result(state), it

    def _after(self, state):
        """A hook on the final state of ``__call__``."""

    def _result(self, state):
        """What ``__call__`` returns of the final state."""
        return state.solution

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, init, step, run, rebase = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase,
                              can_abort=self._can_abort)


@dataclasses.dataclass(frozen=True)
class DPFinito(_DPRun):
    """Data-parallel Finito/MISO (basic or LFinito, or adaptive) over a
    mesh. Same knobs as :class:`ciao_tpu_torch.solvers.Finito` where
    they apply; ``batch`` is the GLOBAL minibatch (split evenly over the
    ranks).

    ``adaptive=True`` runs the backtracking variant (reference
    ``Finito_adaptive.jl``) with its three tables cut by rows: one global
    index a step, whose owner sends its row state to all, and a lockstep
    backtracking loop with one scalar all-reduce a trial.

    ``local_steps > 1``: the LOCAL-UPDATE mode (beyond the reference),
    that many purely local coefficient-Finito steps a round (one #9
    launch on the card), then one av resync (see
    :func:`_finito_coeff_local_round`); ``maxit`` counts ROUNDS. Needs
    coefficient mode (rank-1 oracle, cyclic/shuffled sweeping,
    non-LFinito). Every ``rebase_every`` rounds the resync recomputes av
    exactly from the tables.

    ``local_sweep=True`` (LFinito only): each rank sweeps only its own
    blocks against a private av, two collectives an epoch (on the card
    #6 and #8; see :func:`_lfinito_local_epoch`).

    Each rank returns the same solution."""

    mesh: object = None
    gamma: Optional[object] = None
    sweeping: int = 1
    LFinito: bool = False
    adaptive: bool = False
    batch: int = 0          # 0 -> one index a rank
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    tol_b: float = 1e-9
    table: str = "auto"  # "full" (N,n) | "coeff" (N,) | "auto" (rank-1: coeff)
    local_steps: int = 1
    rebase_every: int = 50  # local rounds between exact av recomputes
    local_sweep: bool = False  # LFinito: local epoch sweeps (2 collectives)
    seed: int = 0
    _shown = "hat_gamma"

    @property
    def _can_abort(self):
        # adaptive Finito is the reference families' only DP variant that
        # can abort
        return self.adaptive

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block as fb

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPFinito")
        rdt = real_dtype_of(x0)
        if self.adaptive:
            return self._setup_adaptive(mesh, x0, F, g, N)
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping,
                                        "DPFinito")
        gamma = _local_gamma(resolve_gamma_array(
            self.gamma, L, N, self.alpha, rdt, mesh.device), mesh, N)
        coeff_ok = (not self.LFinito and self.sweeping != Sweep.RANDOM
                    and getattr(F, "supports_coeff", False))
        if self.table == "coeff" and not coeff_ok:
            raise ValueError(
                "DPFinito table='coeff' needs a rank-1 oracle, cyclic/"
                "shuffled sweeping and the basic (non-LFinito) variant")
        coeff = self.table in ("auto", "coeff") and coeff_ok
        fused = False
        if self.local_steps > 1:
            if not coeff:
                raise ValueError(
                    "DPFinito local_steps > 1 needs coefficient mode: a "
                    "rank-1 oracle, cyclic/shuffled sweeping and the "
                    "basic (non-LFinito) variant")
            # the single-card gate, on the rank's own rows
            fused = fb.finito_multistep_available(F, g, x0, b_loc)
            if not fused:
                _warn_fallback("DPFinito", F, g, x0)
        local = False
        if self.local_sweep:
            if not self.LFinito:
                raise ValueError(
                    "DPFinito local_sweep=True is the LFinito epoch mode "
                    "(set LFinito=True); the basic variant's local mode "
                    "is local_steps > 1")
            if (N // D) % b_loc != 0:
                raise ValueError(
                    "DPFinito local_sweep needs N/D divisible by batch/D")
            local = True
            fused = (getattr(F, "supports_coeff", False)
                     and fb.lfinito_sweep_available(F, g, x0, b_loc))
            if not fused:
                _warn_fallback("DPFinito(LFinito=True)", F, g, x0)
        cfg = DPCfg(
            N=N, D=D, b_loc=b_loc, sweeping=self.sweeping,
            alpha=float(self.alpha), coeff=coeff,
            local_steps=self.local_steps, fused=fused,
            rebase_every=self.rebase_every if self.local_steps > 1 else 0,
            local=local, variant="lfinito" if self.LFinito else "basic")
        if self.LFinito:
            family = "lfinito"
        else:
            family = "finito_coeff" if coeff else "finito"
        return (x0, F, g) + _facade_fns(family, mesh, F, g, cfg, x0, gamma,
                                        self.seed)

    def _setup_adaptive(self, mesh, x0, F, g, N):
        """The backtracking variant over the mesh: stepsizes from the
        sharded probe (γ and L unused, as in the reference) and one
        GLOBAL index a step."""
        if self.LFinito or self.local_steps > 1 or self.local_sweep:
            raise ValueError(
                "DPFinito adaptive=True is exclusive with LFinito/"
                "local_steps/local_sweep (reference Finito.jl:80-116)")
        if self.batch not in (0, 1):
            raise ValueError(
                "DPFinito adaptive=True is single-index (the reference "
                "adaptive variant has no minibatch, Finito_adaptive.jl:162)")
        cfg = DPCfg(N=N, D=mesh.size, b_loc=1, sweeping=self.sweeping,
                    alpha=float(self.alpha), tol_b=float(self.tol_b),
                    variant="adaptive")
        return (x0, F, g) + _facade_fns("finito_adaptive", mesh, F, g, cfg,
                                        x0, None, self.seed)


@dataclasses.dataclass(frozen=True)
class DPSAGA(_DPRun):
    """Data-parallel minibatch SAGA/SAG over a mesh.

    ``local_steps > 1``: the LOCAL-UPDATE mode (beyond the reference;
    the multi-GPU throughput path), that many purely local
    coefficient-SAGA steps a round (one #3 launch on the card), then one
    sync of av and of the iterate (see :func:`_saga_local_round`);
    ``maxit`` counts ROUNDS. Needs ``block_sampling`` and a rank-1
    (coefficient) oracle."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    SAG_flag: bool = False
    block_sampling: bool = False  # contiguous-block minibatches
    table: str = "auto"  # "full" (N,n) | "coeff" (N,) | "auto" (rank-1: coeff)
    local_steps: int = 1
    rebase_every: int = 50  # local rounds between exact av recomputes
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block as fb

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPSAGA")
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPSAGA")
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=mesh.device)
        else:
            if L is None:
                raise ValueError("DPSAGA: provide L or γ")
            L_max = torch.max(torch.as_tensor(L, dtype=rdt,
                                              device=mesh.device))
            gamma = 1.0 / ((16.0 if self.SAG_flag else 3.0) * L_max)
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPSAGA block_sampling needs N/D divisible by batch/D")
        coeff = (getattr(F, "supports_coeff", False) and self.block_sampling
                 if self.table == "auto" else self.table == "coeff")
        if coeff and not self.block_sampling:
            raise ValueError("DPSAGA table='coeff' requires block_sampling")
        fused = False
        if self.local_steps > 1:
            if not (coeff and self.block_sampling):
                raise ValueError(
                    "DPSAGA local_steps > 1 needs block_sampling and a "
                    "rank-1 (coefficient) oracle")
            # the single-card gate, on the rank's own rows
            fused = fb.saga_multistep_available(F, g, x0, b_loc)
            if not fused:
                _warn_fallback("DPSAGA", F, g, x0)
        cfg = DPCfg(
            N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM, alpha=0.999,
            sag=self.SAG_flag, block=self.block_sampling, coeff=coeff,
            local_steps=self.local_steps, fused=fused,
            rebase_every=self.rebase_every if self.local_steps > 1 else 0)
        return (x0, F, g) + _facade_fns("saga", mesh, F, g, cfg, x0, gamma,
                                        self.seed)


def DPSAG(**kwargs):
    """``DPSAGA(SAG_flag=True)``."""
    return DPSAGA(SAG_flag=True, **kwargs)


@dataclasses.dataclass(frozen=True)
class DPSVRG(_DPRun):
    """Data-parallel SVRG/SVRG++: all-reduced full-gradient anchors,
    averaged variance-reduced inner directions (global inner batch
    D·b_loc).

    ``local_inner=True``: the LOCAL-INNER mode (beyond the reference),
    the whole m-step inner loop on each rank's own rows and two
    collectives an outer step (three with ``plus``; see
    :func:`_svrg_local_outer`). With ``block_sampling=True``, a rank-1
    oracle, f32 iterates and a NormL1/Zero prox on the card the inner
    loop runs on #5 and the anchor on #6."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    m: Optional[int] = None
    plus: bool = False
    local_inner: bool = False
    block_sampling: bool = False  # contiguous local inner blocks
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block as fb

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPSVRG")
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPSVRG")
        if self.gamma is None:
            if L is None:
                raise ValueError("DPSVRG: provide L or γ")
            gamma = 1.0 / (10.0 * torch.max(torch.as_tensor(
                L, dtype=rdt, device=mesh.device)))
        else:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=mesh.device)
        m = N if self.m is None else self.m
        if self.block_sampling and (N // D) % b_loc != 0:
            raise ValueError(
                "DPSVRG block_sampling needs N/D divisible by batch/D")
        fused = False
        if self.local_inner and self.block_sampling:
            # the single-card gate, on the rank's own rows
            fused = (getattr(F, "supports_coeff", False)
                     and fb.svrg_multistep_available(F, g, x0, b_loc))
            if not fused:
                _warn_fallback("DPSVRG", F, g, x0)
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, plus=self.plus, block=self.block_sampling,
                    coeff=fused, local=self.local_inner, fused=fused)
        return (x0, F, g) + _facade_fns("svrg", mesh, F, g, cfg, x0, gamma,
                                        self.seed, m)

    @property
    def _maxit(self):
        return min(self.maxit, 25) if self.plus else self.maxit


@dataclasses.dataclass(frozen=True)
class DPProshi(_DPRun):
    """Data-parallel ProShI: the block variables x_i cut by i over the
    ranks; the coupling Σ s_i is an all-reduce and z is computed alike on
    every rank: the sharing problem's all-reduce and broadcast.

    ``local_steps > 1``: the LOCAL-UPDATE mode (beyond the reference),
    that many contiguous-block updates a round against a stale local
    coupling, then one resync (see :func:`_proshi_local_round`; on the
    card with cyclic sweeps, #18); ``maxit`` counts ROUNDS. Every
    ``rebase_every`` rounds av = Σ s_i is recomputed from the table.

    The solution a rank returns is ITS blocks' (n_loc, n) rows."""

    mesh: object = None
    gamma: Optional[object] = None
    sweeping: int = 1
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    local_steps: int = 1
    rebase_every: int = 50  # local rounds between exact av recomputes
    seed: int = 0
    _shown = "hat_gamma"

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block as fb

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPProshi")
        rdt = real_dtype_of(x0)
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping,
                                        "DPProshi")
        gamma = _local_gamma(resolve_gamma_array(
            self.gamma, L, N, self.alpha, rdt, mesh.device, who="DPProshi"),
            mesh, N)
        if self.local_steps > 1 and (N // D) % b_loc != 0:
            # the local round samples contiguous blocks only
            raise ValueError(
                "DPProshi local_steps > 1 needs N/D divisible by batch/D")
        fused = (self.local_steps > 1 and self.sweeping == Sweep.CYCLIC
                 and fb.proshi_multistep_available(F, g, x0, b_loc))
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=self.sweeping,
                    alpha=float(self.alpha), local_steps=self.local_steps,
                    fused=fused,
                    rebase_every=self.rebase_every if self.local_steps > 1
                    else 0)
        return (x0, F, g) + _facade_fns("proshi", mesh, F, g, cfg, x0, gamma,
                                        self.seed)


@dataclasses.dataclass(frozen=True)
class DPForwardBackward(_DPRun):
    """Data-parallel ISTA/FISTA (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.ForwardBackward`): each step one local
    pass over the rank's rows and ONE x-sized all-reduce; ``fast=True``
    is FISTA. ``polish_chunk`` > 0 takes the local pass through the
    compensated chunked sum of ``solvers.polish``."""

    mesh: object = None
    gamma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    fast: bool = False
    polish_chunk: int = 0

    def __post_init__(self):
        if self.gamma is not None and not self.gamma > 0:
            raise ValueError(f"gamma must be positive, not {self.gamma}")
        if self.maxit < 1 or self.freq < 1 or self.polish_chunk < 0:
            raise ValueError("maxit and freq must be at least 1 and "
                             "polish_chunk at least 0")

    def _setup(self, x0, F, g, L, N):
        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N,
                                        "DPForwardBackward")
        rdt = real_dtype_of(x0)
        D = mesh.size
        if self.polish_chunk:
            if (N // D) % self.polish_chunk:
                raise ValueError(
                    f"DPForwardBackward: polish_chunk={self.polish_chunk} "
                    f"must divide the per-device shard N/D={N // D}")
            if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
                raise ValueError(
                    "DPForwardBackward: polish_chunk needs f32/bf16 rows "
                    "(rebase off int8 storage first)")
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=mesh.device)
        else:
            if L is None:
                raise ValueError(
                    "DPForwardBackward: provide the smoothness moduli L, "
                    "or a stepsize γ")
            gamma = 1.0 / torch.mean(torch.as_tensor(L, dtype=rdt,
                                                     device=mesh.device))
        cfg = DPCfg(N=N, D=D, b_loc=1, sweeping=Sweep.RANDOM, alpha=0.999,
                    variant="fista" if self.fast else "ista",
                    polish_chunk=self.polish_chunk)
        return (x0, F, g) + _facade_fns("fb", mesh, F, g, cfg, x0, gamma, 0)


def DPFISTA(**kwargs) -> DPForwardBackward:
    """``DPForwardBackward(fast=True)``."""
    return DPForwardBackward(fast=True, **kwargs)


# ---------------------------------------------------------------------------
# facades of the families beyond the reference
# ---------------------------------------------------------------------------

def _check_loop(maxit: int, freq: int):
    if maxit < 1 or freq < 1:
        raise ValueError("maxit and freq must be at least 1")


def _check_positive(**kw):
    for k, v in kw.items():
        if v is not None and not v > 0:
            raise ValueError(f"{k} must be positive, not {v}")


def _check_blocks(N, D, b_loc, block_sampling: bool, who: str):
    if block_sampling and (N // D) % b_loc != 0:
        raise ValueError(f"{who} block_sampling needs N/D divisible by "
                         f"batch/D")


def _L_max(L, x0, who: str):
    if L is None:
        raise ValueError(f"{who}: provide the smoothness moduli L")
    return torch.max(torch.as_tensor(L, dtype=real_dtype_of(x0),
                                     device=x0.device))


@dataclasses.dataclass(frozen=True)
class DPKatyusha(_DPRun):
    """Data-parallel Katyusha (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.Katyusha`).

    Lockstep (default): each inner step draws one block (or b_loc rows) a
    rank and all-reduces the variance-reduced direction (global inner
    batch = D·b_loc, one all-reduce an inner step). ``local_inner=True``
    runs the m-step inner loop on each rank's rows and pays two
    collectives an outer step (see :func:`_katyusha_step_local`); with
    ``block_sampling=True``, a rank-1 oracle, f32 iterates and a
    NormL1/Zero prox on the card the inner loop runs on #10 and the
    anchor on #6. ``m`` counts inner steps an outer step and defaults to
    2N/batch; ``maxit`` counts outer steps."""

    mesh: object = None
    batch: int = 0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    tau1: Optional[float] = None
    tau2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False
    local_inner: bool = False
    seed: int = 0
    _shown = "tau1"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        if not 0.0 < self.tau2 < 1.0:
            raise ValueError(f"tau2 must lie in (0, 1), not {self.tau2}")
        if self.tau1 is not None and not 0.0 < self.tau1 <= 1.0 - self.tau2:
            raise ValueError(f"tau1 must lie in (0, 1 - tau2], not "
                             f"{self.tau1}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.solvers.svrg import fused_inner_gate

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPKatyusha")
        Lmax = _L_max(L, x0, "DPKatyusha")
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPKatyusha")
        _check_blocks(N, D, b_loc, self.block_sampling, "DPKatyusha")
        m = (2 * N) // batch if self.m is None else self.m
        if m < 1:
            raise ValueError("DPKatyusha: m must be >= 1")
        ns = self.tau1 is None and self.sigma is None
        if self.tau1 is not None:
            tau1 = _as_real(self.tau1, x0)
        elif self.sigma is not None:
            tau1 = torch.clamp(torch.sqrt(
                m * batch * _as_real(self.sigma, x0) / (3.0 * Lmax)), max=0.5)
        else:
            tau1 = _as_real(0.5, x0)
        # the single-card gate, on the rank's own rows
        fused = self.local_inner and fused_inner_gate(
            "DPKatyusha", self.block_sampling, b_loc, F, g, x0)
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling, coeff=fused,
                    local=self.local_inner, m_inner=m, fused=fused,
                    variant="ns" if ns else "sc")
        return (x0, F, g) + _facade_fns("katyusha", mesh, F, g, cfg, x0,
                                        Lmax, self.seed, tau1, self.tau2)


@dataclasses.dataclass(frozen=True)
class DPLSVRG(_DPRun):
    """Data-parallel loopless SVRG (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.LSVRG`): each step a block (or b_loc
    rows) a rank, the direction averaged over the ranks (global batch
    D·b_loc). The anchor coin is the same on every rank (drawn from
    (seed, it) alone) and the refresh partial rides the direction's
    all-reduce: one collective a step. ``p`` defaults to batch/N;
    ``maxit`` counts steps. No kernel, as in the JAX package."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    block_sampling: bool = False
    seed: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if self.p is not None and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], not {self.p}")

    def _setup(self, x0, F, g, L, N):
        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPLSVRG")
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPLSVRG")
        if self.gamma is None:
            if L is None:
                raise ValueError("DPLSVRG: provide L or γ")
            gamma = 1.0 / (6.0 * _L_max(L, x0, "DPLSVRG"))
        else:
            gamma = _as_real(self.gamma, x0)
        _check_blocks(N, D, b_loc, self.block_sampling, "DPLSVRG")
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling)
        p = batch / N if self.p is None else self.p
        return (x0, F, g) + _facade_fns("lsvrg", mesh, F, g, cfg, x0, gamma,
                                        self.seed, p)


@dataclasses.dataclass(frozen=True)
class DPLKatyusha(_DPRun):
    """Data-parallel loopless Katyusha (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.LKatyusha`), with :class:`DPLSVRG`'s
    collectives: the coin the same on every rank, the refresh partial in
    the direction's all-reduce, one collective a step."""

    mesh: object = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    theta1: Optional[float] = None
    theta2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False
    seed: int = 0
    _shown = "theta1"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        if not 0.0 < self.theta2 < 1.0:
            raise ValueError(f"theta2 must lie in (0, 1), not {self.theta2}")
        if self.p is not None and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], not {self.p}")
        if self.theta1 is not None and not (
                0.0 < self.theta1 <= 1.0 - self.theta2):
            raise ValueError(f"theta1 must lie in (0, 1 - theta2], not "
                             f"{self.theta1}")

    def _setup(self, x0, F, g, L, N):
        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N,
                                        "DPLKatyusha")
        Lmax = _L_max(L, x0, "DPLKatyusha")
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPLKatyusha")
        _check_blocks(N, D, b_loc, self.block_sampling, "DPLKatyusha")
        sigma = _as_real(0.0 if self.sigma is None else self.sigma, x0)
        if self.theta1 is not None:
            theta1 = _as_real(self.theta1, x0)
        elif self.sigma is not None:
            theta1 = torch.clamp(torch.sqrt(2.0 * sigma * N / (3.0 * batch)),
                                 max=0.5)
        else:
            theta1 = _as_real(1.0 / 3.0, x0)
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling)
        p = batch / N if self.p is None else self.p
        return (x0, F, g) + _facade_fns("lkatyusha", mesh, F, g, cfg, x0,
                                        Lmax, self.seed, sigma, theta1,
                                        self.theta2, p)


@dataclasses.dataclass(frozen=True)
class DPSARAH(_DPRun):
    """Data-parallel SARAH/ProxSARAH (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.SARAH`).

    Lockstep (default): each inner step draws one block (or b_loc rows) a
    rank and all-reduces the estimator's innovation (global inner batch
    D·b_loc). ``local_inner=True`` runs each rank's recursive chain on its
    rows from the shared full-gradient bootstrap and pays two collectives
    an outer step (see :func:`_sarah_step_local`); with the gate of
    :class:`DPKatyusha` open on the card, the chain runs on #11 and the
    bootstrap on #6. ``m`` defaults to N // batch; ``maxit`` counts outer
    steps."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    eta: float = 1.0
    block_sampling: bool = False
    local_inner: bool = False
    seed: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if not 0.0 < self.eta <= 1.0:
            raise ValueError(f"eta must lie in (0, 1], not {self.eta}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.solvers.svrg import fused_inner_gate

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPSARAH")
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPSARAH")
        _check_blocks(N, D, b_loc, self.block_sampling, "DPSARAH")
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
        elif L is None:
            raise ValueError("DPSARAH: provide the smoothness moduli L, or a "
                             "stepsize γ")
        else:
            gamma = 1.0 / (2.0 * _L_max(L, x0, "DPSARAH"))
        m = N // batch if self.m is None else self.m
        if m < 1:
            raise ValueError("DPSARAH: m must be >= 1")
        fused = self.local_inner and fused_inner_gate(
            "DPSARAH", self.block_sampling, b_loc, F, g, x0)
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=self.block_sampling, coeff=fused,
                    local=self.local_inner, m_inner=m, fused=fused)
        return (x0, F, g) + _facade_fns("sarah", mesh, F, g, cfg, x0, gamma,
                                        self.seed, self.eta)


@dataclasses.dataclass(frozen=True)
class DPPointSAGA(_DPRun):
    """Data-parallel Point-SAGA (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.PointSAGA`): the (N,) prox-coefficient
    table cut by rows; each step every rank proxes one contiguous block
    of its rows (global batch D·b_loc) and the only traffic is one
    x-sized all-reduce. Solves min (1/N)Σf_i (no composite g); needs a
    ``supports_pointprox`` oracle. No kernel, as in the JAX package."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    sweeping: int = 1
    seed: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)

    def _setup(self, x0, F, g, L, N):
        if g is not None and not isinstance(g, Zero):
            raise ValueError("DPPointSAGA solves min (1/N)Σ f_i(x): no "
                             "separate composite g (see PointSAGA)")
        if not getattr(F, "supports_pointprox", False):
            raise ValueError(
                "DPPointSAGA needs a scalar-loss row oracle with the "
                f"pointprox protocol; {type(F).__name__} does not support "
                "it")
        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, None, N,
                                        "DPPointSAGA")
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping,
                                        "DPPointSAGA")
        if (N // D) % b_loc != 0:
            raise ValueError("DPPointSAGA: per-device block batch/D must "
                             "divide N/D")
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
        elif L is None:
            raise ValueError("DPPointSAGA: provide the smoothness moduli L, "
                             "or a stepsize γ")
        else:
            gamma = 1.0 / (3.0 * _L_max(L, x0, "DPPointSAGA"))
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=self.sweeping,
                    alpha=0.999)
        return (x0, F, g) + _facade_fns("point_saga", mesh, F, g, cfg, x0,
                                        gamma, self.seed)


@dataclasses.dataclass(frozen=True)
class DPSSNM(_DPRun):
    """Data-parallel SSNM (SAGA with sampled negative momentum, beyond
    the reference; see :class:`ciao_tpu_torch.solvers.SSNM`): the
    coefficient table and the per-block stored points cut by rows; each
    rank forms its own momentum point from its sampled block's stored
    point; ONE x-sized all-reduce a step. ``batch`` is the GLOBAL
    minibatch. No kernel, as in the JAX package."""

    mesh: object = None
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    tau: Optional[float] = None
    sigma: Optional[float] = None
    eta: Optional[float] = None
    seed: int = 0
    _shown = "tau"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)

    def _setup(self, x0, F, g, L, N):
        if not getattr(F, "supports_coeff", False):
            raise ValueError("DPSSNM needs a rank-1 (coefficient) oracle; "
                             f"{type(F).__name__} is not")
        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPSSNM")
        batch = self.batch or mesh.size
        D, b_loc = _validate_mesh_batch(N, mesh, batch, Sweep.RANDOM,
                                        "DPSSNM")
        if (N // D) % b_loc != 0:
            raise ValueError("DPSSNM: per-device batch must divide N/D")
        if L is None and (self.eta is None or self.tau is None):
            raise ValueError("DPSSNM: provide L, or both τ and η")
        Lmax = None if L is None else _L_max(L, x0, "DPSSNM")
        if self.tau is not None:
            tau = _as_real(self.tau, x0)
        elif self.sigma is not None:
            tau = torch.clamp(torch.sqrt(N * _as_real(self.sigma, x0)
                                         / (3.0 * Lmax)), max=0.5)
        else:
            tau = _as_real(0.5, x0)
        eta = (_as_real(self.eta, x0) if self.eta is not None
               else 1.0 / (3.0 * tau * Lmax))
        cfg = DPCfg(N=N, D=D, b_loc=b_loc, sweeping=Sweep.RANDOM,
                    alpha=0.999, block=True, coeff=True)
        return (x0, F, g) + _facade_fns("ssnm", mesh, F, g, cfg, x0, tau,
                                        self.seed, eta)


def _dp_terms(mesh, x0, F, N, who):
    """A splitting facade's (mesh, x0, the rank's oracle part, N): F =
    ``ZeroOracle(n_terms=N)`` when omitted."""
    from ciao_tpu_torch.oracles import ZeroOracle

    if F is None:
        if N is None:
            raise ValueError(f"{who}: provide F or N")
        F = ZeroOracle(n_terms=N)
    mesh, x0, F, _, N = _dp_problem(mesh, x0, F, None, N, who)
    return mesh, x0, F, N


def _prox_or_zero(p, mesh):
    return (Zero() if p is None else p).to(mesh.device)


@dataclasses.dataclass(frozen=True)
class DPDavisYin:
    """Data-parallel Davis-Yin splitting (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.DavisYin`): minimize (1/N)Σf_i + g + h.
    Each step is one local pass over the rank's rows and ONE x-sized
    all-reduce; both proxes are computed alike on every rank, so the
    trajectory is the single card's to reduction order.
    ``DPDouglasRachford`` is the f = 0 case (pass no F or L)."""

    mesh: object = None
    gamma: Optional[float] = None
    lam: float = 1.0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if not 0 < self.lam < 2:
            raise ValueError(f"lam must lie in (0, 2), not {self.lam}")

    def _setup(self, x0, F, g, h, L, N):
        from ciao_tpu_torch.oracles import ZeroOracle

        mesh, x0, F, N = _dp_terms(self.mesh, x0, F, N, "DPDavisYin")
        gh = (_prox_or_zero(g, mesh), _prox_or_zero(h, mesh))
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
        elif L is not None:
            gamma = 1.0 / torch.mean(torch.as_tensor(
                L, dtype=real_dtype_of(x0), device=x0.device))
        elif isinstance(F, ZeroOracle):
            gamma = _as_real(1.0, x0)  # f = 0: Douglas-Rachford
        else:
            raise ValueError("DPDavisYin: provide the smoothness moduli L, "
                             "or a stepsize γ")
        cfg = DPCfg(N=N, D=mesh.size, b_loc=1, sweeping=Sweep.RANDOM,
                    alpha=0.999)
        return (x0, F, gh) + _facade_fns("dys", mesh, F, gh, cfg, x0, gamma,
                                         0, self.lam)

    def __call__(self, x0, F=None, g=None, h=None, L=None, N=None,
                 observe=None):
        x0, F, gh, init, step, run, _ = self._setup(x0, F, g, h, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.gamma):.3e}")  # noqa: E731
        state, it = run_solver_loop(init, run, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, L=None, N=None):
        x0_orig = x0
        x0, F, gh, init, step, run, rebase = self._setup(x0, F, g, h, L, N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPDouglasRachford(**kwargs) -> DPDavisYin:
    """``DPDavisYin`` with f = 0 (Douglas-Rachford over the mesh)."""
    return DPDavisYin(**kwargs)


@dataclasses.dataclass(frozen=True)
class DPCondatVu:
    """Data-parallel Condat-Vũ splitting (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.CondatVu`): minimize (1/N)Σf_i + g(x) +
    h(Kx). Each step is one local pass over the rank's rows and ONE
    x-sized all-reduce; K's products, both proxes and the dual update are
    computed alike on every rank, so the trajectory is the single card's
    to reduction order. ``polish_chunk`` > 0 takes the local pass through
    compensated chunks (the deep route, :func:`deep_solve_pd_dp`).
    ``DPChambollePock`` is the f = 0 case (pass no F or L)."""

    mesh: object = None
    tau: Optional[float] = None
    sigma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    polish_chunk: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(tau=self.tau, sigma=self.sigma)
        if self.polish_chunk < 0:
            raise ValueError("polish_chunk must be at least 0")

    def _setup(self, x0, F, g, h, K, L, N):
        from ciao_tpu_torch.ops.linmap import IdentityMap
        from ciao_tpu_torch.oracles import ZeroOracle
        from ciao_tpu_torch.solvers.primal_dual import CondatVu

        mesh, x0, F, N = _dp_terms(self.mesh, x0, F, N, "DPCondatVu")
        D = mesh.size
        K = (IdentityMap() if K is None else K).to(mesh.device)
        ghk = (_prox_or_zero(g, mesh), _prox_or_zero(h, mesh), K)
        if L is not None:
            Lf = float(torch.mean(torch.as_tensor(L,
                                                  dtype=real_dtype_of(x0))))
        elif isinstance(F, ZeroOracle) or self.tau is not None:
            Lf = 0.0  # Chambolle-Pock, or the caller owns the condition
        else:
            raise ValueError("DPCondatVu: provide the smoothness moduli L, "
                             "or an explicit stepsize τ")
        # the single card's stepsize rule, so the trajectories agree
        tau, sigma = CondatVu(tau=self.tau, sigma=self.sigma)._stepsizes(
            Lf, float(K.opnorm_bound(x0.shape[0])))
        if self.polish_chunk:
            if isinstance(F, ZeroOracle):
                raise ValueError(
                    "DPCondatVu: polish_chunk compensates the finite-sum "
                    "gradient; there is none with F omitted")
            if (N // D) % self.polish_chunk:
                raise ValueError(
                    f"DPCondatVu: polish_chunk={self.polish_chunk} must "
                    f"divide the per-device shard N/D={N // D}")
            if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
                raise ValueError(
                    "DPCondatVu: polish_chunk needs f32/bf16 rows")
        cfg = DPCfg(N=N, D=D, b_loc=1, sweeping=Sweep.RANDOM, alpha=0.999,
                    polish_chunk=self.polish_chunk)
        return (x0, F, ghk) + _facade_fns("pd", mesh, F, ghk, cfg, x0, tau,
                                          0, sigma)

    def __call__(self, x0, F=None, g=None, h=None, K=None, L=None, N=None,
                 observe=None):
        x0, F, ghk, init, step, run, _ = self._setup(x0, F, g, h, K, L, N)
        disp = lambda it, st: print(f"{it:5d} | {float(st.tau):.3e}")  # noqa: E731
        state, it = run_solver_loop(init, run, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, K=None, L=None, N=None):
        x0_orig = x0
        x0, F, ghk, init, step, run, rebase = self._setup(x0, F, g, h, K, L,
                                                          N)
        return SolverIterable(x0_orig, init, step, rebase_fn=rebase)


def DPChambollePock(**kwargs) -> DPCondatVu:
    """``DPCondatVu`` with f = 0 (Chambolle-Pock over the mesh)."""
    return DPCondatVu(**kwargs)


@dataclasses.dataclass(frozen=True)
class DPPANOC(_DPRun):
    """Data-parallel PANOC/ZeroFPR (beyond the reference; see
    :class:`ciao_tpu_torch.solvers.PANOC`). Each FBE evaluation is one
    local pass over the rank's rows and two all-reduces (the value and
    the gradient); the L-BFGS direction and the line search are computed
    alike on every rank, so the trajectory is the single card's to
    reduction order. No kernel: JAX's DP PANOC leaves ``fused`` off, and
    has no ``tol``."""

    mesh: object = None
    gamma: Optional[float] = None
    alpha: float = 0.95
    beta: float = 0.5
    maxit: int = 100
    mem: int = 5
    max_ls: int = 10
    verbose: bool = False
    freq: int = 10
    zerofpr: bool = False
    adaptive: bool = False  # γ-backtracking (on when neither γ nor L)

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if not (0 < self.alpha < 1 and 0 < self.beta < 1):
            raise ValueError("alpha and beta must lie in (0, 1)")
        if self.mem < 1 or self.max_ls < 1:
            raise ValueError("mem and max_ls must be at least 1")

    @property
    def _can_abort(self):
        return self.adaptive

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.solvers.panoc import _probe_gamma

        mesh, x0, F, g, N = _dp_problem(self.mesh, x0, F, g, N, "DPPANOC")
        rdt = real_dtype_of(x0)
        adaptive = self.adaptive or (self.gamma is None and L is None)
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
            if L is not None:
                Lf = torch.mean(torch.as_tensor(L, dtype=rdt,
                                                device=x0.device))
                sigma = self.beta * torch.clamp(1.0 - gamma * Lf,
                                                min=0.05) / (2.0 * gamma)
            else:
                sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        elif L is not None:
            Lf = torch.mean(torch.as_tensor(L, dtype=rdt, device=x0.device))
            gamma = rdiv(self.alpha, Lf)
            sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        else:
            # the one-time probe, its two gradient passes all-reduced
            gamma = _probe_gamma(_PsumFBEOracle(mesh, F), x0, N, self.alpha,
                                 rdt)
            sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        cfg = DPCfg(N=N, D=mesh.size, b_loc=1, sweeping=Sweep.RANDOM,
                    alpha=0.999, m_inner=self.mem, max_ls=self.max_ls,
                    adaptive=adaptive,
                    variant="zerofpr" if self.zerofpr else "panoc")
        return (x0, F, g) + _facade_fns("panoc", mesh, F, g, cfg, x0, gamma,
                                        0, sigma)

    def _after(self, state):
        from ciao_tpu_torch.solvers.panoc import warn_if_thrashing

        warn_if_thrashing(state, type(self).__name__)


def DPZeroFPR(**kwargs) -> DPPANOC:
    """``DPPANOC(zerofpr=True)``."""
    return DPPANOC(zerofpr=True, **kwargs)
