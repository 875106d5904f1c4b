"""Tensor-parallel (coordinate-sharded) solver paths on a (data, model)
mesh of ``torch.distributed`` groups.

Counterpart of ``ciao_tpu/parallel/tp.py``'s reference families: SAGA/SAG,
coefficient Finito (sweeps 1/2/3), LFinito, SVRG/SVRG++, ProShI on
coordinate-separable oracles, and the ISTA/FISTA of ``deep_solve_tp``'s
polish. Rank (d, m) of a (D, M) mesh (:func:`~ciao_tpu_torch.parallel.
mesh.make_mesh_2d`) holds its block of rows cut over BOTH axes:

  * the oracle's (N, n) rows are cut to rows [d·N/D, (d+1)·N/D) and
    columns [m·n/M, (m+1)·n/M); its (N,) leaves (offsets, int8 row
    scales) to the rows, whole rows' scales kept: the (B,) margins are
    summed over "model" before the scale is applied
    (``coeff_from_margin``);
  * the iterate, the averages and the prox's (n,) parameters are cut to
    the rank's columns (separable proxes only: coordinatewise, no
    collective);
  * the (N,) coefficient tables and stepsizes are cut to the rows, the
    same on every rank of a data row's model group.

Per block step the collectives are JAX's: a (B,)-sized sum of the
partial margins over "model" (:func:`_psum_m`, one ``all_reduce`` on the
rank's model group) and an x-shard-sized sum of the innovation over
"data" (:func:`_psum_d`, one on its data group). ProShI's oracles are
coordinate-separable, so it sums over "data" alone. D = 1 is pure TP,
M = 1 the data-parallel layout.

The states are the DP path's (``DPSAGAState``, ``DPFinitoCoeffState``,
``DPLFinitoState``, ``DPSVRGState``, ``DPProshiState``, ``DPFBState``):
their x-sized fields hold the rank's columns, their tables its rows.

Schedules are the port's counter hash with the rank's DATA row folded
into the seed, the same on every rank of a model group (all members of
a data row must pick the same block, as JAX's ``tp.py:137-141``); they
are drawn on the host, so every block start is a host int and every
row slice a view. torch cannot draw threefry: ``step``/``run`` take
explicit schedules, which the parity tests read from JAX's draws.

No kernel: JAX's TP path runs its steps through the oracle's margin
protocol outside any Pallas kernel, and so does this one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ciao_tpu_torch import runtime
from ciao_tpu_torch.parallel.dp import (
    DPFBState, DPFinitoCoeffState, DPLFinitoState, DPProshiState,
    DPSAGAState, DPSVRGState, _DPRun, _block, _check_loop, _local_gamma,
    _local_round_starts, _owned, _proshi_update, _rank_seed, _rows,
    _validate_mesh_batch, local_indices,
)
from ciao_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh2D, _named_leaves, put_specs,
)
from ciao_tpu_torch.prox import Zero
from ciao_tpu_torch.sampling import Sweep, _permutation
from ciao_tpu_torch.solvers.base import (
    Status, real_dtype_of, resolve_gamma_array,
)
from ciao_tpu_torch.solvers.proshi import _coupling as _proshi_coupling
from ciao_tpu_torch.solvers.svrg import _outer_seed


class TPCfg(NamedTuple):
    """Static config of every TP family."""

    N: int              # global term count
    D: int              # ranks on the data axis
    M: int              # ranks on the model axis
    b_loc: int = 1      # per-data-row block size
    sweeping: int = 1
    sag: bool = False
    plus: bool = False  # SVRG++
    fast: bool = False  # FISTA
    polish_chunk: int = 0  # FB/FISTA: compensated chunked gradient

    @property
    def n_loc(self):
        return self.N // self.D


# ---------------------------------------------------------------------------
# collectives and placement
# ---------------------------------------------------------------------------

def _allreduce(group, x):
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _psum_d(mesh: Mesh2D, x):
    """The sum of ``x`` over the rank's data group (JAX's psum over
    "data"): one ``all_reduce``, on a copy."""
    return _allreduce(mesh.data_group, x)


def _psum_m(mesh: Mesh2D, x):
    """The sum of ``x`` over the rank's model group (JAX's psum over
    "model"): one ``all_reduce``, on a copy."""
    return _allreduce(mesh.model_group, x)


def gather_model(mesh: Mesh2D, x):
    """The whole of ``x`` from the rank's columns: one ``all_gather``
    over the model group, the parts joined along the last dimension (x
    itself at M = 1). Every rank of a model group gets the same tensor."""
    if mesh.M == 1:
        return x
    x = x.contiguous()
    if x.is_complex():
        parts = [torch.empty_like(torch.view_as_real(x))
                 for _ in range(mesh.M)]
        dist.all_gather(parts, torch.view_as_real(x), group=mesh.model_group)
        parts = [torch.view_as_complex(p) for p in parts]
    else:
        parts = [torch.empty_like(x) for _ in range(mesh.M)]
        dist.all_gather(parts, x, group=mesh.model_group)
    return torch.cat(parts, dim=-1)


def data_model_specs(F, N: int) -> dict:
    """The 2-D placement of each leaf, by name: ``("data", "model")`` for
    a stacked (N, n) leaf, ``("data",)`` for a stacked (N,) leaf (int8
    row scales among them: each row keeps its whole row's scale), ``()``
    for the rest (whole on each rank)."""
    specs = {}
    for name, t in _named_leaves(F):
        if t.dim() == 2 and t.shape[0] == N:
            specs[name] = (DATA_AXIS, MODEL_AXIS)
        elif t.dim() == 1 and t.shape[0] == N:
            specs[name] = (DATA_AXIS,)
        else:
            specs[name] = ()
    return specs


def model_prox_specs(g, n: int) -> dict:
    """The placement of the prox's leaves under coordinate sharding:
    (n,) parameters (a vector λ, box bounds, weights) cut to the rank's
    columns with the iterate; scalars and the rest whole."""
    return {name: (MODEL_AXIS,) if t.dim() == 1 and t.shape[0] == n else ()
            for name, t in _named_leaves(g)}


def shard_finite_sum_2d(F, mesh: Mesh2D, N: Optional[int] = None):
    """This rank's block of the oracle ``F`` (:func:`data_model_specs`),
    on the mesh's device. The block keeps the global constants (a
    least-squares ``scale`` of N stays N) and records (N, D, M, rank), so
    a TP facade takes it as it is. Never store the block with
    ``with_storage``: int8 quantizes whole rows, before the cut."""
    if N is None:
        N = F.num_terms
    if N % mesh.D:
        raise ValueError(f"shard_finite_sum_2d: N={N} must be divisible by "
                         f"the {mesh.D} ranks of the data axis")
    for name, t in _named_leaves(F):
        if t.dim() == 2 and t.shape[0] == N and t.shape[1] % mesh.M:
            raise ValueError(
                f"shard_finite_sum_2d: {name}'s n={t.shape[1]} must be "
                f"divisible by the {mesh.M} ranks of the model axis")
    part = put_specs(F, mesh, data_model_specs(F, N))
    part.tp_shard = (int(N), mesh.D, mesh.M, mesh.rank)
    return part


# ---------------------------------------------------------------------------
# schedules: host ints, the data row folded into the seed
# ---------------------------------------------------------------------------

def _starts(mesh: Mesh2D, cfg: TPCfg, seed: int, it0: int, k: int,
            sweeping: int) -> list:
    """Block starts of steps it0..it0+k-1 of the rank's data row, as host
    ints (``dp._local_round_starts`` with the row for the rank)."""
    return _local_round_starts(seed, it0, cfg.n_loc, cfg.b_loc, k, sweeping,
                               mesh.d, "cpu").tolist()


def _start_of(mesh, cfg: TPCfg, state, starts, sweeping: int) -> int:
    if starts is not None:
        return int(starts)
    return _starts(mesh, cfg, state.seed, state.it, 1, sweeping)[0]


# ---------------------------------------------------------------------------
# SAGA / SAG
# ---------------------------------------------------------------------------

def _anchor(F, mesh, x):
    """The rank's (n_loc,) coefficients at x: the full margins summed
    over "model", then the loss."""
    return F.coeff_from_margin_all(_psum_m(mesh, F.margin_all(x)))


def _saga_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed):
    """Coefficient bootstrap with column-partial margins (``tp.py:120``):
    r = A x0 summed over "model", av = Σ cᵢaᵢ/N summed over "data"."""
    c = _anchor(F, mesh, x0)
    av = _psum_d(mesh, F.apply_all(c)) / cfg.N
    z = g.prox_only((1 - gamma) * x0, gamma)
    return DPSAGAState(s=c, gamma=gamma, av=av, z=z, seed=int(seed), it=1,
                       status=int(Status.RUNNING))


def _saga_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One block step (``tp.py:131-162``): the (B,) margins summed over
    "model", the innovation over "data"; the biased SAG / unbiased SAGA
    order kept."""
    N, B = cfg.N, cfg.b_loc
    start = _start_of(mesh, cfg, state, starts, Sweep.RANDOM)
    r = _psum_m(mesh, F.margin_block(state.z, start, B))
    c_new = F.coeff_from_margin(r, start, B)
    c_old = state.s.narrow(0, start, B)
    innov = _psum_d(mesh, F.apply_rows_block(c_new - c_old, start, B))
    c_old.copy_(c_new)
    if cfg.sag:
        av = state.av + innov / N
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (innov / (B * cfg.D) + state.av)
        av = state.av + innov / N
    return state._replace(av=av, z=g.prox_only(w, state.gamma),
                          it=state.it + 1)


def _saga_rebase(F, g, mesh, cfg: TPCfg, state):
    """After a row-storage swap: av recomputed from the coefficient rows
    (``tp.py:172``)."""
    return state._replace(av=_psum_d(mesh, F.apply_all(state.s)) / cfg.N)


# ---------------------------------------------------------------------------
# Finito (coefficient mode) and LFinito
# ---------------------------------------------------------------------------

def _finito_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed):
    """Coefficient-Finito bootstrap (``tp.py:219-238``): hat_γ·Σ(1/γ) = 1
    simplifies av to x0 − (hat/N)·Σ cᵢaᵢ."""
    N, B = cfg.N, cfg.b_loc
    c = _anchor(F, mesh, x0)
    inv_gamma = 1.0 / gamma
    hat = 1.0 / _psum_d(mesh, torch.sum(inv_gamma))
    av = x0 - (hat / N) * _psum_d(mesh, F.apply_all(c))
    d_loc = cfg.n_loc // B
    return DPFinitoCoeffState(
        c=c, zb=x0.expand(d_loc, x0.shape[0]).clone(),
        invg=torch.sum(inv_gamma.reshape(d_loc, B), dim=1), hat_gamma=hat,
        av=av, z=g.prox_only(av, hat), seed=int(seed), it=1,
        status=int(Status.RUNNING))


def _finito_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One block step (``tp.py:241-265``): the (B,) margins over "model"
    and one sum over "data" of the anchor and coefficient innovation."""
    N, B = cfg.N, cfg.b_loc
    hat = state.hat_gamma
    start = _start_of(mesh, cfg, state, starts, cfg.sweeping)
    j = start // B
    r = _psum_m(mesh, F.margin_block(state.z, start, B))
    c_new = F.coeff_from_margin(r, start, B)
    c_old = state.c.narrow(0, start, B)
    zb = state.zb[j]
    innov = _psum_d(mesh, hat * state.invg[j] * (state.z - zb)
                    - (hat / N) * F.apply_rows_block(c_new - c_old, start, B))
    av = state.av + innov
    c_old.copy_(c_new)
    zb.copy_(state.z)
    return state._replace(av=av, z=g.prox_only(av, hat), it=state.it + 1)


def _finito_rebase(F, g, mesh, cfg: TPCfg, state):
    """av = hat_γ·Σ(invg_j·zb_j − cᵢaᵢ/N) from the rank's tables, summed
    over "data"; z re-proxed (``tp.py:268``)."""
    hat = state.hat_gamma
    av = hat * _psum_d(mesh, state.invg @ state.zb
                       - F.apply_all(state.c) / cfg.N)
    return state._replace(av=av, z=g.prox_only(av, hat))


def _lfinito_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed):
    """LFinito bootstrap (``tp.py:475``): no table; the init z is a copy
    of av (no prox), the reference's quirk."""
    hat = 1.0 / _psum_d(mesh, torch.sum(1.0 / gamma))
    av = x0 - (hat / cfg.N) * _psum_d(mesh, F.apply_all(_anchor(F, mesh, x0)))
    return DPLFinitoState(gamma=gamma, hat_gamma=hat, av=av, z=av, z_full=av,
                          seed=int(seed), it=1, status=int(Status.RUNNING))


def _lfinito_order(mesh, cfg: TPCfg, state, starts) -> list:
    """The epoch's block starts in visit order: the explicit ``starts``,
    else a fresh permutation of the data row's blocks (shuffled) or the
    natural order (cyclic and random, as JAX's ``tp.py:507-512``)."""
    B = cfg.b_loc
    if starts is not None:
        return [int(s) for s in starts]
    d_loc = cfg.n_loc // B
    if cfg.sweeping == Sweep.SHUFFLED:
        order = _permutation(_rank_seed(state.seed, mesh.d), state.it, d_loc,
                             "cpu")
        return (order.long() * B).tolist()
    return list(range(0, cfg.n_loc, B))


def _lfinito_epoch(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One lockstep epoch (``tp.py:488-529``): the anchor refresh, then a
    sweep of the data row's own blocks, each a (B,) margin sum over
    "model" and a sum over "data" of the combined innovation."""
    N, B = cfg.N, cfg.b_loc
    hat = state.hat_gamma
    z_full = g.prox_only(state.av, hat)
    cf = _anchor(F, mesh, z_full)
    av = z_full - (hat / N) * _psum_d(mesh, F.apply_all(cf))
    z = state.z
    for start in _lfinito_order(mesh, cfg, state, starts):
        z = g.prox_only(av, hat)
        cb = F.coeff_from_margin(_psum_m(mesh, F.margin_block(z, start, B)),
                                 start, B)
        inv_g = torch.sum(1.0 / state.gamma.narrow(0, start, B))
        av = av + _psum_d(mesh, (hat / N) * F.apply_rows_block(
            cf.narrow(0, start, B) - cb, start, B)
            + hat * inv_g * (z - z_full))
    return state._replace(av=av, z=z, z_full=z_full, it=state.it + 1)


# ---------------------------------------------------------------------------
# SVRG / SVRG++
# ---------------------------------------------------------------------------

def _svrg_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed, m):
    """SVRG bootstrap (``tp.py:665``): the anchor's full gradient is one
    margin sum over "model" and one sum over "data"."""
    av = _psum_d(mesh, F.apply_all(_anchor(F, mesh, x0))) / cfg.N
    return DPSVRGState(gamma=gamma, m=int(m), av=av, z=torch.zeros_like(x0),
                       z_full=x0, w=x0, canch=None, seed=int(seed), it=1,
                       status=int(Status.RUNNING))


def _svrg_outer(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One outer step (``tp.py:678-713``): the anchor coefficients once,
    then m inner steps, each a (B,) margin sum at w over "model" and a
    sum over "data" of the variance-reduced direction (global inner batch
    B·D, each data row its own block)."""
    N, B, m = cfg.N, cfg.b_loc, state.m
    gamma, av = state.gamma, state.av
    if starts is None:
        starts = _starts(mesh, cfg, _outer_seed(state.seed, state.it), 1, m,
                         Sweep.RANDOM)
    cf = _anchor(F, mesh, state.z_full)
    w, zsum = state.w, state.z
    for start in starts:
        start = int(start)
        cb = F.coeff_from_margin(_psum_m(mesh, F.margin_block(w, start, B)),
                                 start, B)
        d = _psum_d(mesh, F.apply_rows_block(cf.narrow(0, start, B) - cb,
                                             start, B)) / (B * cfg.D)
        w = g.prox_only(w + gamma * (d - av), gamma)
        zsum = zsum + w
    z_full = zsum / m
    av_next = _psum_d(mesh, F.apply_all(_anchor(F, mesh, z_full))) / N
    return state._replace(
        m=m * 2 if cfg.plus else m, av=av_next, z=torch.zeros_like(zsum),
        z_full=z_full, w=w if cfg.plus else z_full, it=state.it + 1)


# ---------------------------------------------------------------------------
# ProShI (coordinate-separable oracles)
# ---------------------------------------------------------------------------

def _proshi_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed):
    """ProShI bootstrap (``tp.py:1352-1370``): the oracle's gradients are
    coordinatewise, so the rank's table columns are exact with no "model"
    collective; hat_γ = Σγ and av = Σ s_i are sums over "data"."""
    G = _rows(F, x0, cfg.n_loc)
    s = x0[None, :] - (gamma / cfg.N)[:, None] * G
    hat = _psum_d(mesh, torch.sum(gamma))
    av = _psum_d(mesh, torch.sum(s, dim=0))
    return DPProshiState(s=s, gamma=gamma, hat_gamma=hat, av=av,
                         z=_proshi_coupling(g, av, hat), seed=int(seed),
                         it=1, status=int(Status.RUNNING))


def _proshi_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One block step (``tp.py:1378-1407``): the schedule folds only the
    data row, so every member of a model group refreshes the same rows;
    one (n/M)-sized sum over "data" of the coupling delta."""
    B, dev = cfg.b_loc, state.z.device
    if cfg.sweeping != Sweep.RANDOM:
        start = _start_of(mesh, cfg, state, starts, cfg.sweeping)
        delta = _proshi_update(F, cfg, state.s, state.gamma, state.z,
                               _block(start, B, dev), start)
    else:
        if idx is None:
            idx = local_indices(state.seed, state.it, cfg.n_loc, B,
                                cfg.sweeping, mesh.d, dev)
        delta = _proshi_update(F, cfg, state.s, state.gamma, state.z,
                               torch.as_tensor(idx, device=dev).long())
    av = state.av + _psum_d(mesh, delta)
    return state._replace(av=av, z=_proshi_coupling(g, av, state.hat_gamma),
                          it=state.it + 1)


def _proshi_rebase(F, g, mesh, cfg: TPCfg, state):
    """av = Σ s_i recomputed exactly (``tp.py:1410``)."""
    av = _psum_d(mesh, torch.sum(state.s, dim=0))
    return state._replace(av=av, z=_proshi_coupling(g, av, state.hat_gamma))


# ---------------------------------------------------------------------------
# forward-backward / FISTA
# ---------------------------------------------------------------------------

def _fb_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed):
    return DPFBState(gamma=gamma, t=torch.ones((), dtype=real_dtype_of(x0),
                                               device=x0.device),
                     x=x0, y=x0, it=1, status=int(Status.RUNNING))


def full_gradient_tp(F, mesh: Mesh2D, cfg: TPCfg, y):
    """(1/N)·Σᵢ ∇fᵢ(y), the rank's columns. Plain: the full margins over
    "model", the gradient columns over "data". ``polish_chunk``
    (``tp.py:1003-1038``): per chunk of rows a margin sum over "model"
    and the partial sum carried with a two-sum; the hi and lo carries
    are summed over "data" SEPARATELY (one all-reduce of the two
    stacked), so the D-way sum keeps what the compensation kept."""
    if not cfg.polish_chunk:
        return _psum_d(mesh, F.apply_all(_anchor(F, mesh, y))) / cfg.N
    from ciao_tpu_torch.ops.fused_block import _two_sum

    C = cfg.polish_chunk
    hi = torch.zeros_like(y)
    lo = torch.zeros_like(y)
    for start in range(0, cfg.n_loc, C):
        c = F.coeff_from_margin(_psum_m(mesh, F.margin_block(y, start, C)),
                                start, C)
        hi, lo = _two_sum(hi, lo, F.apply_rows_block(c, start, C))
    hl = _psum_d(mesh, torch.stack([hi, lo]))
    return (hl[0] + hl[1]) / cfg.N


def _fb_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One ISTA/FISTA step (``tp.py:1041-1058``): prox and extrapolation
    on the rank's columns (separable g)."""
    gamma = state.gamma
    grad = full_gradient_tp(F, mesh, cfg, state.y)
    x_new = g.prox_only(state.y - gamma * grad, gamma)
    if cfg.fast:
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.t * state.t))
        y_new = x_new + ((state.t - 1.0) / t_new) * (x_new - state.x)
    else:
        t_new, y_new = state.t, x_new
    return state._replace(t=t_new, x=x_new, y=y_new, it=state.it + 1)


def _identity(F, g, mesh, cfg, state):
    """LFinito and SVRG recompute their anchor every epoch (outer step):
    a storage swap heals after one iterate."""
    return state


# family -> (init, step, rebase, the table fields a run owns)
_FAMILY = {
    "saga": (_saga_init, _saga_step, _saga_rebase, ("s",)),
    "finito": (_finito_init, _finito_step, _finito_rebase, ("c", "zb")),
    "lfinito": (_lfinito_init, _lfinito_epoch, _identity, ()),
    "svrg": (_svrg_init, _svrg_outer, _identity, ()),
    "proshi": (_proshi_init, _proshi_step, _proshi_rebase, ("s",)),
    "fb": (_fb_init, _fb_step, _identity, ()),
}


def _run_sweep(family: str, cfg: TPCfg):
    """The sweep of the block starts a run of ``family`` draws in one pass,
    or None where each step draws its own (or none)."""
    if family == "saga":
        return Sweep.RANDOM
    if family == "finito" or (family == "proshi"
                              and cfg.sweeping != Sweep.RANDOM):
        return cfg.sweeping
    return None


def build_tp_functions(family: str, mesh: Mesh2D, F, g, cfg: TPCfg):
    """``(init, step, run, rebase)`` of a family on this rank, the
    counterpart of JAX's ``_compiled_tp_family``: plain closures over
    the rank's oracle block ``F`` (:func:`shard_finite_sum_2d`), its prox
    ``g`` (columns of its (n,) parameters), the mesh and the config.

      * ``init(x0, a, seed, *extra)``: x0 the rank's columns; ``a`` γ (a
        scalar for SAGA, SVRG and FB; the rank's (n_loc,) rows for
        Finito, LFinito and ProShI); SVRG's ``extra`` is m;
      * ``step(state, starts=None, idx=None)``: one step, the state passed
        in left valid;
      * ``run(state, steps, starts=None, idx=None)``: ``steps`` steps,
        the tables copied once and then written in place;
      * ``rebase(state)``: the storage-swap repair.

    ``starts``/``idx`` give the rank's schedule, one entry a step: a
    block start (SAGA, Finito, ProShI's cyclic and shuffled sweeps), the
    epoch's block starts in visit order (LFinito), the outer step's m
    inner starts (SVRG), or ProShI's random (b_loc,) rows."""
    init_fn, step_fn, rebase_fn, tables = _FAMILY[family]
    runtime.require_exact_f32_matmul(mesh.device, f"TP {family}")
    sweep = _run_sweep(family, cfg)

    def init(x0, a, seed, *extra):
        return init_fn(F, g, mesh, cfg, x0, a, seed, *extra)

    def step(state, starts=None, idx=None):
        if state.status != Status.RUNNING:
            return state
        return step_fn(F, g, mesh, cfg, _owned(state, tables), starts, idx)

    def run(state, steps, starts=None, idx=None):
        if state.status != Status.RUNNING:
            return state
        state = _owned(state, tables)
        if starts is None and idx is None and sweep is not None:
            # the run's block starts in one pass of the hash
            starts = _starts(mesh, cfg, state.seed, state.it, steps, sweep)
        for t in range(steps):
            state = step_fn(F, g, mesh, cfg, state,
                            None if starts is None else starts[t],
                            None if idx is None else idx[t])
        return state

    def rebase(state):
        return rebase_fn(F, g, mesh, cfg, state)

    return init, step, run, rebase


# ---------------------------------------------------------------------------
# facades
# ---------------------------------------------------------------------------

def _num_terms(F, N):
    if N is not None:
        return N
    shard = getattr(F, "tp_shard", None)
    return shard[0] if shard is not None else F.num_terms


def _tp_args(mesh, x0, F, g, N, who: str, oracle: str):
    """The validated arguments of a facade call, before the cut: (mesh,
    x0 whole, F, g, N). ``oracle`` names the protocol the family needs:
    "coeff" (rank-1 rows with the margin protocol), "margin" (the margin
    protocol) or "coordinate" (coordinate-separable terms)."""
    if not isinstance(mesh, Mesh2D):
        raise ValueError(f"{who} needs a ('data','model') mesh (make_mesh_2d)")
    x0 = torch.as_tensor(x0, device=mesh.device)
    N = _num_terms(F, N)
    g = Zero() if g is None else g
    if not getattr(g, "separable", False):
        raise ValueError(f"{who} shards coordinates — the prox must be "
                         f"separable (got {type(g).__name__})")
    if oracle == "coordinate":
        if not getattr(F, "coordinate_separable", False):
            raise ValueError(
                f"{who} needs a coordinate-separable oracle (gradients "
                "coordinatewise in x: DiagQuadratic, SqrDistBox, sums "
                f"thereof) — got {type(F).__name__}")
        return mesh, x0, F, g, N
    if oracle == "coeff" and not getattr(F, "supports_coeff", False):
        raise ValueError(f"{who} needs a rank-1 (coefficient) oracle")
    if not (hasattr(F, "margin_all") and hasattr(F, "margin_block")):
        # sparse ELL layouts carry GLOBAL column ids in their index tables:
        # a coordinate block cannot evaluate its slots alone
        raise ValueError(
            f"{who} shards coordinates and needs the margin protocol "
            "(margin_block/coeff_from_margin — dense row oracles); "
            f"{type(F).__name__} is DP-only")
    return mesh, x0, F, g, N


def _tp_cut(mesh: Mesh2D, x0, F, g, N, who: str):
    """(x0's columns, the rank's oracle block, the prox's columns): a
    whole oracle is cut here, a block made by :func:`shard_finite_sum_2d`
    is checked against the mesh."""
    shard = getattr(F, "tp_shard", None)
    if shard is None:
        F = shard_finite_sum_2d(F, mesh, N)
    elif shard[1:] != (mesh.D, mesh.M, mesh.rank):
        raise ValueError(
            f"{who}: F is the block of rank {shard[3]} of a ({shard[1]}, "
            f"{shard[2]}) mesh, not of rank {mesh.rank} of ({mesh.D}, "
            f"{mesh.M})")
    n = x0.shape[-1]
    g = put_specs(g, mesh, model_prox_specs(g, n))
    lo, hi = mesh.cols(n)
    return x0[..., lo:hi].contiguous(), F.to(mesh.device), g


def _check_n(mesh: Mesh2D, x0, who: str):
    if x0.numel() % mesh.M:
        raise ValueError(f"{who}: need n divisible by the model axis")


def _check_rows(mesh: Mesh2D, N: int, batch: int, who: str):
    if N % mesh.D or (N // mesh.D) % batch:
        raise ValueError(f"{who}: need N divisible by D and N/D by batch")


def _fns(family, mesh, F, g, cfg, x0, a, seed, *extra):
    init_c, step_c, run_c, rebase_c = build_tp_functions(family, mesh, F, g,
                                                         cfg)
    return (x0, F, g, lambda: init_c(x0, a, seed, *extra), step_c, run_c,
            rebase_c)


class _TPRun(_DPRun):
    """``__call__`` returns the whole iterate, gathered over "model" once
    at the end; the iterator's states hold the rank's columns."""

    def _result(self, state):
        return gather_model(self.mesh, state.solution)


@dataclasses.dataclass(frozen=True)
class TPSAGA(_TPRun):
    """Coefficient-mode SAGA/SAG on a (data, model) mesh: samples AND
    coordinates cut. Needs a rank-1 oracle and a separable prox;
    ``batch`` is the per-data-row contiguous block size."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 1
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    SAG_flag: bool = False
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, "TPSAGA",
                                     "coeff")
        _check_rows(mesh, N, self.batch, "TPSAGA")
        _check_n(mesh, x0, "TPSAGA")
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=mesh.device)
        else:
            if L is None:
                raise ValueError("TPSAGA: provide L or γ")
            L_max = torch.max(torch.as_tensor(L, dtype=rdt,
                                              device=mesh.device))
            gamma = 1.0 / ((16.0 if self.SAG_flag else 3.0) * L_max)
        x0, F, g = _tp_cut(mesh, x0, F, g, N, "TPSAGA")
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M, b_loc=self.batch,
                    sag=self.SAG_flag)
        return _fns("saga", mesh, F, g, cfg, x0, gamma, self.seed)


@dataclasses.dataclass(frozen=True)
class TPFinito(_TPRun):
    """Coefficient-mode Finito/MISO on a (data, model) mesh. Needs a
    rank-1 oracle and a separable prox; ``batch`` is the per-data-row
    contiguous block size; sweeping ∈ {1 random, 2 cyclic, 3 shuffled}
    runs over the data row's own blocks."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 1
    sweeping: int = 1
    alpha: float = 0.999
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    seed: int = 0
    _shown = "hat_gamma"
    _who = "TPFinito"
    _family = "finito"

    def _setup(self, x0, F, g, L, N):
        who = self._who
        mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, who, "coeff")
        if self.sweeping not in (1, 2, 3):
            raise ValueError(f"sweeping must be 1, 2 or 3; got {self.sweeping}")
        _check_rows(mesh, N, self.batch, who)
        _check_n(mesh, x0, who)
        gamma = _local_gamma(resolve_gamma_array(
            self.gamma, L, N, self.alpha, real_dtype_of(x0), mesh.device),
            mesh, N)
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M, b_loc=self.batch,
                    sweeping=self.sweeping)
        return _fns(self._family, mesh, F, g, cfg, x0, gamma, self.seed)


@dataclasses.dataclass(frozen=True)
class TPLFinito(TPFinito):
    """O(n)-memory LFinito on a (data, model) mesh: no table. One iterate
    is one epoch (``maxit`` counts epochs); the same knobs as
    :class:`TPFinito`."""

    _who = "TPLFinito"
    _family = "lfinito"


@dataclasses.dataclass(frozen=True)
class TPSVRG(_TPRun):
    """SVRG/SVRG++ on a (data, model) mesh: no table. Needs a rank-1
    oracle and a separable prox; ``batch`` is the per-data-row inner block
    size (global inner batch batch·D); ``m`` counts inner batches (N by
    default) and doubles each outer step with ``plus``, which caps
    ``maxit`` at 25."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 1
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    m: Optional[int] = None
    plus: bool = False
    seed: int = 0

    def _setup(self, x0, F, g, L, N):
        mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, "TPSVRG",
                                     "coeff")
        _check_rows(mesh, N, self.batch, "TPSVRG")
        _check_n(mesh, x0, "TPSVRG")
        rdt = real_dtype_of(x0)
        if self.gamma is None:
            if L is None:
                raise ValueError("TPSVRG: provide L or γ")
            gamma = 1.0 / (10.0 * torch.max(torch.as_tensor(
                L, dtype=rdt, device=mesh.device)))
        else:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=mesh.device)
        x0, F, g = _tp_cut(mesh, x0, F, g, N, "TPSVRG")
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M, b_loc=self.batch,
                    plus=self.plus)
        return _fns("svrg", mesh, F, g, cfg, x0, gamma, self.seed,
                    N if self.m is None else self.m)

    @property
    def _maxit(self):
        return min(self.maxit, 25) if self.plus else self.maxit


@dataclasses.dataclass(frozen=True)
class TPProshi(_TPRun):
    """ProShI (sharing formulation) on a (data, model) mesh: the N block
    variables cut over "data" AND their coordinates over "model". Needs a
    coordinate-separable oracle (``F.coordinate_separable``: diagonal
    quadratics, box distances, sums of them) and a separable prox, so
    that the gradients and the coupling are coordinatewise and the one
    collective a step is the (n/M)-sized sum over "data". ``batch`` is
    GLOBAL (split over the data axis); at M = 1 the trajectory is
    :class:`~ciao_tpu_torch.parallel.DPProshi`'s.

    The solution a rank returns is its blocks' (n_loc, n) rows, their
    columns gathered over "model"."""

    mesh: object = None
    gamma: Optional[object] = None
    sweeping: int = 1
    batch: int = 0
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    seed: int = 0
    _shown = "hat_gamma"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        if self.sweeping not in (1, 2, 3):
            raise ValueError(f"sweeping must be 1, 2 or 3; got {self.sweeping}")

    def _setup(self, x0, F, g, L, N):
        mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, "TPProshi",
                                     "coordinate")
        if x0.numel() % mesh.M:
            raise ValueError("TPProshi: need n divisible by the model axis")
        batch = self.batch or mesh.D
        D, b_loc = _validate_mesh_batch(N, mesh, batch, self.sweeping,
                                        "TPProshi")
        gamma = _local_gamma(resolve_gamma_array(
            self.gamma, L, N, self.alpha, real_dtype_of(x0), mesh.device,
            who="TPProshi"), mesh, N)
        x0, F, g = _tp_cut(mesh, x0, F, g, N, "TPProshi")
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=b_loc, sweeping=self.sweeping)
        return _fns("proshi", mesh, F, g, cfg, x0, gamma, self.seed)


@dataclasses.dataclass(frozen=True)
class TPForwardBackward(_TPRun):
    """ISTA/FISTA on a (data, model) mesh: a full-gradient step is one
    margin sum over "model" and one gradient sum over "data";
    ``fast=True`` is FISTA. ``polish_chunk`` > 0 takes the compensated
    chunked gradient of :func:`full_gradient_tp` (f32/bf16 rows, a
    divisor of N/D). Needs the margin protocol and a separable prox."""

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
        _check_loop(self.maxit, self.freq)
        if self.polish_chunk < 0:
            raise ValueError("polish_chunk must be at least 0")

    def _setup(self, x0, F, g, L, N):
        who = "TPForwardBackward"
        mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, who, "margin")
        if N % mesh.D:
            raise ValueError(f"{who}: need N divisible by D")
        _check_n(mesh, x0, who)
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=mesh.device)
        else:
            if L is None:
                raise ValueError(f"{who}: provide the smoothness moduli L, "
                                 "or a stepsize γ")
            gamma = 1.0 / torch.mean(torch.as_tensor(L, dtype=rdt,
                                                     device=mesh.device))
        if self.polish_chunk:
            if (N // mesh.D) % self.polish_chunk:
                raise ValueError(
                    f"{who}: polish_chunk={self.polish_chunk} must divide "
                    f"the per-device row count {N // mesh.D}")
            if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
                raise ValueError(
                    f"{who}: polish_chunk needs f32/bf16 rows (int8 dequant "
                    "defines a different operator)")
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M, fast=self.fast,
                    polish_chunk=self.polish_chunk)
        return _fns("fb", mesh, F, g, cfg, x0, gamma, 0)


def TPFISTA(**kwargs) -> TPForwardBackward:
    """``TPForwardBackward(fast=True)``."""
    return TPForwardBackward(fast=True, **kwargs)
