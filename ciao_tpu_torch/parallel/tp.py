"""Tensor-parallel (coordinate-sharded) solver paths on a (data, model)
mesh of ``torch.distributed`` groups.

Counterpart of ``ciao_tpu/parallel/tp.py``: the reference's families
(SAGA/SAG, coefficient Finito (sweeps 1/2/3), LFinito, SVRG/SVRG++,
ProShI on coordinate-separable oracles, and the ISTA/FISTA of
``deep_solve_tp``'s polish) and those beyond it (Katyusha, SARAH, L-SVRG,
L-Katyusha, Point-SAGA, SSNM, Davis-Yin/Douglas-Rachford, Condat-Vũ/
Chambolle-Pock on a stencil K, PANOC/ZeroFPR). Rank (d, m) of a (D, M)
mesh (:func:`~ciao_tpu_torch.parallel.mesh.make_mesh_2d`) holds its block
of rows cut over BOTH axes:

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
rank's model group; the loopless pair, SARAH and Point-SAGA stack two
(B,) rows into it) and an x-shard-sized sum of the innovation over
"data" (:func:`_psum_d`, one on its data group). ProShI's oracles are
coordinate-separable, so it sums over "data" alone. Condat-Vũ's stencil
adds two one-element halos over "model" a step (:func:`_halo`), and
PANOC's every inner product is a scalar sum over "model". D = 1 is pure
TP, M = 1 the data-parallel layout.

The states are the DP path's (``DPSAGAState``, ``DPFinitoCoeffState``,
``DPLFinitoState``, ``DPSVRGState``, ``DPProshiState``, ``DPFBState``,
``DPKatyushaState``, ``DPSARAHState``, ``DPLSVRGState``,
``DPLKatyushaState``, ``DPPointSAGAState``, ``DPSSNMState``) and the
single card's ``DYSState``, ``PDState`` and ``PANOCState``: their x-sized
fields (and PANOC's L-BFGS ring) hold the rank's columns, their tables
its rows (SSNM's stored points its rows and columns), Condat-Vũ's dual
the rank's columns of the dual padded to (n,).

Schedules are the port's counter hash with the rank's DATA row folded
into the seed, the same on every rank of a model group (all members of
a data row must pick the same block, as JAX's ``tp.py:137-141``); they
are drawn on the host, so every block start is a host int and every
row slice a view. torch cannot draw threefry: ``step``/``run`` take
explicit schedules, which the parity tests read from JAX's draws.
L-SVRG's and L-Katyusha's anchor coin is a function of (seed, it) alone,
the same on every rank, so a refresh's collectives run on all or none.

No kernel: JAX's TP path runs its steps through the oracle's margin
protocol outside any Pallas kernel (its TP PANOC leaves ``fused`` off),
and so does this one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ciao_tpu_torch import runtime
from ciao_tpu_torch.parallel.dp import (
    DPFBState, DPFinitoCoeffState, DPKatyushaState, DPLFinitoState,
    DPLKatyushaState, DPLSVRGState, DPPointSAGAState, DPProshiState,
    DPSAGAState, DPSARAHState, DPSSNMState, DPSVRGState, _as_real, _DPRun,
    _block, _check_loop, _check_positive, _L_max, _local_gamma,
    _local_round_starts, _owned, _proshi_update, _rank_seed, _rows,
    _validate_mesh_batch, local_indices,
)
from ciao_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh2D, _named_leaves, put_specs,
)
from ciao_tpu_torch.prox import Zero
from ciao_tpu_torch.sampling import Sweep, _permutation
from ciao_tpu_torch.solvers.base import (
    SolverIterable, Status, real_dtype_of, resolve_gamma_array,
    run_solver_loop,
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
    m_inner: int = 0    # Katyusha/SARAH inner steps; PANOC's L-BFGS memory
    variant: str = ""   # Katyusha "ns"/"sc"; PANOC "panoc"/"zerofpr";
    #                     Condat-Vũ's K "identity"/"firstdiff"
    max_ls: int = 10    # PANOC line-search trials
    adaptive: bool = False  # PANOC's γ-backtracking

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


# ---------------------------------------------------------------------------
# Katyusha and SARAH: outer steps of m inner steps
# ---------------------------------------------------------------------------

def _inner_starts(mesh, cfg: TPCfg, state, starts) -> list:
    """The outer step's m inner block starts, as host ints: the explicit
    ones, else the data row's draws under the outer step's seed (TPSVRG's
    stream, ``tp.py:780-791``)."""
    if starts is not None:
        return [int(s) for s in starts]
    return _starts(mesh, cfg, _outer_seed(state.seed, state.it), 1,
                   cfg.m_inner, Sweep.RANDOM)


def _katyusha_init(F, g, mesh, cfg: TPCfg, x0, Lmax, seed, tau1, tau2):
    """Katyusha bootstrap (``tp.py:753``): the anchor's full gradient is
    one margin sum over "model" and one sum over "data"."""
    return DPKatyushaState(
        Lmax=_as_real(Lmax, x0), tau1=_as_real(tau1, x0),
        tau2=_as_real(tau2, x0), av=full_gradient_tp(F, mesh, cfg, x0),
        x_tilde=x0, y=x0, z=x0, seed=int(seed), it=1,
        status=int(Status.RUNNING))


def _katyusha_outer(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One outer step (``tp.py:765-811``): the anchor coefficients once,
    then m inner steps, each a (B,) margin sum at the coupled point over
    "model" and a sum over "data" of the variance-reduced direction; the
    three sequences move on the rank's columns (separable g)."""
    from ciao_tpu_torch.solvers.katyusha import (
        KatyushaCfg, _katyusha_schedule,
    )

    N, B = cfg.N, cfg.b_loc
    tau1, tau2, alpha, beta = _katyusha_schedule(
        KatyushaCfg(N=N, ns=cfg.variant == "ns"), state)
    av, xt = state.av, state.x_tilde
    cf = _anchor(F, mesh, xt)
    y, z = state.y, state.z
    ysum = torch.zeros_like(y)
    for start in _inner_starts(mesh, cfg, state, starts):
        x = tau1 * z + tau2 * xt + (1.0 - tau1 - tau2) * y
        cb = F.coeff_from_margin(_psum_m(mesh, F.margin_block(x, start, B)),
                                 start, B)
        gr = av + _psum_d(mesh, F.apply_rows_block(
            cb - cf.narrow(0, start, B), start, B)) / (B * cfg.D)
        z = g.prox_only(z - alpha * gr, alpha)
        y = g.prox_only(x - beta * gr, beta)
        ysum = ysum + y
    x_tilde = ysum / cfg.m_inner
    return state._replace(
        tau1=tau1.to(state.tau1.dtype) if cfg.variant == "ns" else state.tau1,
        av=full_gradient_tp(F, mesh, cfg, x_tilde), x_tilde=x_tilde, y=y,
        z=z, it=state.it + 1)


def _sarah_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed, eta):
    """SARAH bootstrap (``tp.py:845``): no gradient work, so
    solution(init) == x0."""
    return DPSARAHState(gamma=_as_real(gamma, x0), eta=_as_real(eta, x0),
                        x_tilde=x0, seed=int(seed), it=1,
                        status=int(Status.RUNNING))


def _sarah_outer(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One outer step (``tp.py:855-893``): v₀ the full gradient, then m
    recursive inner steps, each the block margins at w_t and w_{t−1} in
    ONE stacked (2, B) sum over "model" and one sum over "data" of the
    estimator's innovation; the damped prox on the rank's columns."""
    from ciao_tpu_torch.solvers.sarah import _damped_prox

    B = cfg.b_loc
    gamma, eta = state.gamma, state.eta
    v = full_gradient_tp(F, mesh, cfg, state.x_tilde)
    w_prev = state.x_tilde
    w = _damped_prox(g, w_prev, v, gamma, eta)
    for start in _inner_starts(mesh, cfg, state, starts):
        r2 = _psum_m(mesh, torch.stack([F.margin_block(w, start, B),
                                        F.margin_block(w_prev, start, B)]))
        cb = F.coeff_from_margin(r2[0], start, B)
        cp = F.coeff_from_margin(r2[1], start, B)
        v = v + _psum_d(mesh, F.apply_rows_block(cb - cp, start, B)) / (
            B * cfg.D)
        w_prev, w = w, _damped_prox(g, w, v, gamma, eta)
    return state._replace(x_tilde=w, it=state.it + 1)


# ---------------------------------------------------------------------------
# L-SVRG / L-Katyusha: the anchor coin is the same on every rank
# ---------------------------------------------------------------------------

def _coin_of(state, coins) -> bool:
    """The step's anchor coin: the explicit one, else ``solvers.lsvrg.
    draw_coins`` of (seed, it) alone, the same on every rank, so every
    rank takes the refresh's collectives or none."""
    from ciao_tpu_torch.solvers.lsvrg import draw_coins

    if coins is not None:
        return bool(coins)
    return bool(draw_coins(state.seed, state.it, 1, state.p)[0])


def _live_anchor(F, mesh, cfg: TPCfg, x1, x2, start):
    """Σ over the block of ∇f_i(x1) − ∇f_i(x2), the rank's columns,
    summed over "data": the margins at both points in ONE stacked (2, B)
    sum over "model" (no anchor-coefficient cache: the anchor moves at
    random times), then one sum over "data"."""
    B = cfg.b_loc
    r2 = _psum_m(mesh, torch.stack([F.margin_block(x1, start, B),
                                    F.margin_block(x2, start, B)]))
    c1 = F.coeff_from_margin(r2[0], start, B)
    c2 = F.coeff_from_margin(r2[1], start, B)
    return _psum_d(mesh, F.apply_rows_block(c1 - c2, start, B))


def _lsvrg_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed, p):
    """L-SVRG bootstrap (``tp.py:1447``)."""
    return DPLSVRGState(gamma=_as_real(gamma, x0), p=float(p),
                        av=full_gradient_tp(F, mesh, cfg, x0), z=x0, w=x0,
                        seed=int(seed), it=1, status=int(Status.RUNNING))


def _lsvrg_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None,
                coins=None):
    """One step (``tp.py:1468-1497``): the direction from the stacked
    margins, and on a coin flip the anchor jumps to the pre-update w with
    its full gradient (one more margin sum over "model" and one over
    "data")."""
    gamma, w = state.gamma, state.w
    start = _start_of(mesh, cfg, state, starts, Sweep.RANDOM)
    d = _live_anchor(F, mesh, cfg, state.z, w, start) / (cfg.b_loc * cfg.D)
    w_new = g.prox_only(w + gamma * (d - state.av), gamma)
    if _coin_of(state, coins):
        state = state._replace(av=full_gradient_tp(F, mesh, cfg, w), z=w)
    return state._replace(w=w_new, it=state.it + 1)


def _lsvrg_rebase(F, g, mesh, cfg: TPCfg, state):
    """The exact anchor gradient at the anchor (``tp.py:1500``)."""
    return state._replace(av=full_gradient_tp(F, mesh, cfg, state.z))


def _lkatyusha_init(F, g, mesh, cfg: TPCfg, x0, Lmax, seed, sigma, theta1,
                    theta2, p):
    """L-Katyusha bootstrap (``tp.py:1531``)."""
    return DPLKatyushaState(
        Lmax=_as_real(Lmax, x0), sigma=_as_real(sigma, x0),
        theta1=_as_real(theta1, x0), theta2=_as_real(theta2, x0),
        p=float(p), av=full_gradient_tp(F, mesh, cfg, x0), w_anchor=x0,
        y=x0, z=x0, seed=int(seed), it=1, status=int(Status.RUNNING))


def _lkatyusha_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None,
                    coins=None):
    """One step (``tp.py:1542-1580``): the coupling and the proximal
    mirror step on the rank's columns; on a coin flip the anchor jumps to
    the pre-update y."""
    th1, th2, sig = state.theta1, state.theta2, state.sigma
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / state.Lmax
    w = state.w_anchor
    x = th1 * state.z + th2 * w + (1.0 - th1 - th2) * state.y
    start = _start_of(mesh, cfg, state, starts, Sweep.RANDOM)
    gr = state.av + _live_anchor(F, mesh, cfg, x, w, start) / (
        cfg.b_loc * cfg.D)
    denom = 1.0 + eta * sig
    z_new = g.prox_only((state.z + (eta * sig) * x - step * gr) / denom,
                        step / denom)
    y_new = x + th1 * (z_new - state.z)
    if _coin_of(state, coins):
        state = state._replace(av=full_gradient_tp(F, mesh, cfg, state.y),
                               w_anchor=state.y)
    return state._replace(y=y_new, z=z_new, it=state.it + 1)


def _lkatyusha_rebase(F, g, mesh, cfg: TPCfg, state):
    return state._replace(av=full_gradient_tp(F, mesh, cfg, state.w_anchor))


# ---------------------------------------------------------------------------
# Point-SAGA and SSNM
# ---------------------------------------------------------------------------

def _point_saga_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed):
    """Point-SAGA bootstrap (``tp.py:927``)."""
    c = _anchor(F, mesh, x0)
    return DPPointSAGAState(gamma=_as_real(gamma, x0), c=c,
                            av=_psum_d(mesh, F.apply_all(c)) / cfg.N, x=x0,
                            seed=int(seed), it=1, status=int(Status.RUNNING))


def _point_saga_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One block step (``tp.py:940-965``): the margins at the shifted
    iterate and the rows' square-norms are both partial over the columns,
    so they ride ONE stacked (2, B) sum over "model" (int8 row scales go
    on after it, inside ``pointprox_theta_block``); θ is solved alike on
    every rank of the model group; u = Σ(c − θ)·a is one sum over
    "data"."""
    N, B = cfg.N, cfg.b_loc
    gamma = state.gamma
    v = state.x - gamma * state.av
    start = _start_of(mesh, cfg, state, starts, cfg.sweeping)
    c_B = state.c.narrow(0, start, B)
    mv = F.margin_block(v, start, B)
    r2 = _psum_m(mesh, torch.stack(
        [mv, F.pointprox_sqnorm_block(start, B).to(mv.dtype)]))
    theta = F.pointprox_theta_block(r2[0], torch.real(r2[1]), c_B, gamma,
                                    start, B)
    u = _psum_d(mesh, F.apply_rows_block(c_B - theta, start, B))
    c_B.copy_(theta)
    return state._replace(x=v + (gamma / (B * cfg.D)) * u,
                          av=state.av - u / N, it=state.it + 1)


def _point_saga_rebase(F, g, mesh, cfg: TPCfg, state):
    """The exact table mean from the rank's rows (``tp.py:968``)."""
    return state._replace(av=_psum_d(mesh, F.apply_all(state.c)) / cfg.N)


def _ssnm_init(F, g, mesh, cfg: TPCfg, x0, tau, seed, eta):
    """SSNM bootstrap (``tp.py:1623``): every stored point x0, cut over
    the rank's blocks AND its columns."""
    c = _anchor(F, mesh, x0)
    return DPSSNMState(
        tau=_as_real(tau, x0), eta=_as_real(eta, x0), c=c,
        zb=x0.expand(cfg.n_loc // cfg.b_loc, x0.shape[0]).clone(),
        gbar=_psum_d(mesh, F.apply_all(c)) / cfg.N, x=x0, seed=int(seed),
        it=1, status=int(Status.RUNNING))


def _ssnm_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One block step (``tp.py:1637-1660``): the momentum point y = τx +
    (1 − τ)·zb[j] on the rank's columns, its (B,) margins summed over
    "model", the innovation over "data"; the mirror step and prox on the
    rank's columns."""
    N, B = cfg.N, cfg.b_loc
    tau, eta = state.tau, state.eta
    start = _start_of(mesh, cfg, state, starts, Sweep.RANDOM)
    zb = state.zb[start // B]
    y = tau * state.x + (1.0 - tau) * zb
    c_new = F.coeff_from_margin(_psum_m(mesh, F.margin_block(y, start, B)),
                                start, B)
    c_old = state.c.narrow(0, start, B)
    innov = _psum_d(mesh, F.apply_rows_block(c_new - c_old, start, B))
    x = g.prox_only(state.x - eta * (innov / (B * cfg.D) + state.gbar), eta)
    c_old.copy_(c_new)
    zb.copy_(y)
    return state._replace(gbar=state.gbar + innov / N, x=x, it=state.it + 1)


def _ssnm_rebase(F, g, mesh, cfg: TPCfg, state):
    return state._replace(gbar=_psum_d(mesh, F.apply_all(state.c)) / cfg.N)


# ---------------------------------------------------------------------------
# Davis-Yin, Condat-Vũ (a stencil K), PANOC/ZeroFPR: full-gradient methods
# ---------------------------------------------------------------------------

def _grad_or_zero(F, mesh, cfg: TPCfg, x):
    """∇f(x), the rank's columns; zero for f = 0 (``ZeroOracle`` has no
    margin protocol, so the f = 0 path skips the oracle, ``tp.py:1097``)."""
    from ciao_tpu_torch.oracles import ZeroOracle

    if isinstance(F, ZeroOracle):
        return torch.zeros_like(x)
    return full_gradient_tp(F, mesh, cfg, x)


def _dys_init(F, gh, mesh, cfg: TPCfg, x0, gamma, seed, lam):
    """Davis-Yin bootstrap (``tp.py:1079``): ``gh`` is the pair (g, h)."""
    from ciao_tpu_torch.solvers.dys import DYSState

    return DYSState(gamma=_as_real(gamma, x0), lam=_as_real(lam, x0), z=x0,
                    xg=x0, it=1, status=int(Status.RUNNING))


def _dys_step(F, gh, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One step (``tp.py:1089-1107``): ``solvers.dys._dys_step`` with the
    full gradient one margin sum over "model" and one sum over "data";
    both proxes on the rank's columns."""
    from ciao_tpu_torch.solvers.dys import _dys_step as step

    g, h = gh
    return step(F, g, h, None, state,
                grad_fn=lambda x: _grad_or_zero(F, mesh, cfg, x))


def _pd_init(F, gh, mesh, cfg: TPCfg, x0, tau, seed, sigma):
    """Condat-Vũ bootstrap (``tp.py:1136``): the dual is carried PADDED to
    (n,), cut like x; its virtual last element (the last rank's last)
    stays 0."""
    from ciao_tpu_torch.solvers.primal_dual import PDState

    return PDState(tau=_as_real(tau, x0), sigma=_as_real(sigma, x0), x=x0,
                   y=torch.zeros_like(x0), it=1, status=int(Status.RUNNING))


def _halo(mesh: Mesh2D, v, offset: int):
    """The element ``v`` (a (1,) tensor) of the model neighbour at
    ``offset`` (−1 left, +1 right), zero past either end: ONE all-gather
    of a one-element tensor over the model group, which every rank of it
    calls (JAX's ``lax.ppermute`` of one scalar on the ring, ``tp.py:
    1183-1207``); zero with no collective at M = 1."""
    at = mesh.m + offset
    if mesh.M == 1:
        return torch.zeros_like(v)
    every = gather_model(mesh, v)
    return every.narrow(0, at, 1) if 0 <= at < mesh.M else torch.zeros_like(v)


def _pd_step(F, gh, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One step (``tp.py:1143-1206``) with K = FirstDifference's stencil:

        (Kx)_i = x_{i+1} − x_i (the virtual row n−1 → 0),
        (Kᵀy)_j = y_{j−1} − y_j (y_{−1} = y_{n−1} = 0),

    each rank needing ONE element of a neighbour per product: Kᵀy takes
    the left rank's last dual element, then K(2x⁺ − x) the right rank's
    first primal one (two halos, in JAX's order: the second depends on
    x⁺). K = I has none. The gradient is one margin sum over "model" and
    one sum over "data" (none for f = 0); both proxes on the rank's
    columns, the dual's by the Moreau identity."""
    from ciao_tpu_torch.solvers.primal_dual import prox_conjugate

    g, h = gh
    tau, sigma = state.tau, state.sigma
    x, y = state.x, state.y
    grad = _grad_or_zero(F, mesh, cfg, x)
    stencil = cfg.variant != "identity"
    if stencil:
        kty = torch.cat([_halo(mesh, y[-1:], -1), y[:-1]]) - y
    else:
        kty = y
    x_new = g.prox_only(x - tau * (grad + kty), tau)
    v = 2.0 * x_new - x
    last = stencil and mesh.m == mesh.M - 1
    if stencil:
        kx = torch.cat([v[1:], _halo(mesh, v[:1], 1)]) - v
        if last:
            kx[-1] = 0.0
    else:
        kx = v
    y_new = prox_conjugate(h, y + sigma * kx, sigma)
    if last:
        # the pad's virtual element stays exactly 0 (prox_{σh*}(0) = 0 for
        # every norm here; pinned against an exotic h)
        y_new[-1] = 0.0
    return state._replace(x=x_new, y=y_new, it=state.it + 1)


class _TPFBEOracle:
    """The oracle PANOC's step sees on a rank (``tp.py:1225``): the raw
    margins summed over "model", then the value and the gradient each
    summed over "data" (the gradient stays the rank's columns). Every
    value the host reads is of these sums, so every rank takes the same
    trials."""

    def __init__(self, mesh, F):
        self._mesh, self._F = mesh, F

    def value_sum_and_grad_sum_all(self, u):
        F, mesh = self._F, self._mesh
        r = _psum_m(mesh, F.margin_all(u))
        val = _psum_d(mesh, F.value_from_margin_all(r))
        return val, _psum_d(mesh, F.apply_all(F.coeff_from_margin_all(r)))

    def value_sum_all(self, u):
        F, mesh = self._F, self._mesh
        return _psum_d(mesh, F.value_from_margin_all(
            _psum_m(mesh, F.margin_all(u))))

    def grad_sum_all(self, u):
        return _psum_d(self._mesh, self._F.apply_all(
            _anchor(self._F, self._mesh, u)))


class _TPProxAdapter:
    """A separable prox on the rank's columns whose VALUE is summed over
    "model" (``tp.py:1246``): the envelope's g(z) must be the whole
    value, or the line search's test would differ across the ranks."""

    def __init__(self, mesh, g):
        self._mesh, self._g = mesh, g

    def prox(self, x, gamma):
        z = self._g.prox_only(x, gamma)
        val = torch.as_tensor(self._g.value(z), device=z.device)
        return z, _psum_m(self._mesh, val.to(real_dtype_of(z)))


def _rdot_tp(mesh: Mesh2D):
    """Re⟨a, b⟩ of vectors cut over "model": the rank's part, summed over
    the model group (``tp.py:1259``)."""
    def rdot(a, b):
        return _psum_m(mesh, torch.real(torch.vdot(a, b)))
    return rdot


def _panoc_cfg(cfg: TPCfg):
    """The single-card config of the TP step: no ``tol`` and no kernel
    (JAX's TP config leaves ``fused`` off, ``tp.py:1272``)."""
    from ciao_tpu_torch.solvers.panoc import PANOCCfg

    return PANOCCfg(N=cfg.N, mem=cfg.m_inner, max_ls=cfg.max_ls,
                    zerofpr=cfg.variant == "zerofpr", tol=None,
                    adaptive=cfg.adaptive)


def _panoc_init(F, g, mesh, cfg: TPCfg, x0, gamma, seed, sigma):
    """PANOC/ZeroFPR bootstrap (``tp.py:1264``): ``solvers.panoc.
    panoc_init`` on :class:`_TPFBEOracle`; the L-BFGS ring is (mem, the
    rank's columns)."""
    from ciao_tpu_torch.solvers.panoc import panoc_init

    return panoc_init(_TPFBEOracle(mesh, F), _TPProxAdapter(mesh, g), x0,
                      _as_real(gamma, x0), _as_real(sigma, x0),
                      _panoc_cfg(cfg), _rdot_tp(mesh))


def _panoc_step(F, g, mesh, cfg: TPCfg, state, starts=None, idx=None):
    """One step (``tp.py:1293``): ``solvers.panoc._panoc_step`` with every
    inner product summed over "model"; each FBE evaluation is one margin
    sum over "model" and two sums over "data"."""
    from ciao_tpu_torch.solvers.panoc import _panoc_step as step

    return step(_TPFBEOracle(mesh, F), _TPProxAdapter(mesh, g),
                _panoc_cfg(cfg), state, _rdot_tp(mesh))


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
    "katyusha": (_katyusha_init, _katyusha_outer, _identity, ()),
    "sarah": (_sarah_init, _sarah_outer, _identity, ()),
    "lsvrg": (_lsvrg_init, _lsvrg_step, _lsvrg_rebase, ()),
    "lkatyusha": (_lkatyusha_init, _lkatyusha_step, _lkatyusha_rebase, ()),
    "point_saga": (_point_saga_init, _point_saga_step, _point_saga_rebase,
                   ("c",)),
    "ssnm": (_ssnm_init, _ssnm_step, _ssnm_rebase, ("c", "zb")),
    "dys": (_dys_init, _dys_step, _identity, ()),
    "pd": (_pd_init, _pd_step, _identity, ()),
    "panoc": (_panoc_init, _panoc_step, _identity, ()),
}
# the families whose steps flip the replicated anchor coin
_COIN_FAMILIES = ("lsvrg", "lkatyusha")


def _run_sweep(family: str, cfg: TPCfg):
    """The sweep of the block starts a run of ``family`` draws in one pass,
    or None where each step draws its own (or none)."""
    if family in ("saga", "lsvrg", "lkatyusha", "ssnm"):
        return Sweep.RANDOM
    if family in ("finito", "point_saga") or (
            family == "proshi" and cfg.sweeping != Sweep.RANDOM):
        return cfg.sweeping
    return None


def build_tp_functions(family: str, mesh: Mesh2D, F, g, cfg: TPCfg):
    """``(init, step, run, rebase)`` of a family on this rank, the
    counterpart of JAX's ``_compiled_tp_family``: plain closures over
    the rank's oracle block ``F`` (:func:`shard_finite_sum_2d`), its prox
    ``g`` (columns of its (n,) parameters), the mesh and the config.

      * ``init(x0, a, seed, *extra)``: x0 the rank's columns; ``a`` γ (a
        scalar for SAGA, SVRG, FB, SARAH, L-SVRG, Point-SAGA, Davis-Yin
        and PANOC; the rank's (n_loc,) rows for Finito, LFinito and
        ProShI), L_max (Katyusha, L-Katyusha) or τ (SSNM, Condat-Vũ);
        ``extra``: SVRG's m, Katyusha's (τ₁, τ₂), SARAH's η, L-SVRG's p,
        L-Katyusha's (σ, θ₁, θ₂, p), SSNM's η, Davis-Yin's λ, Condat-Vũ's
        σ, PANOC's σ. Davis-Yin's ``g`` is the pair (g, h), Condat-Vũ's
        too (K's kind is ``cfg.variant``);
      * ``step(state, starts=None, idx=None, coins=None)``: one step, the
        state passed in left valid;
      * ``run(state, steps, starts=None, idx=None, coins=None)``:
        ``steps`` steps, the tables copied once and then written in
        place; a state that is not RUNNING stays as it is;
      * ``rebase(state)``: the storage-swap repair.

    ``starts``/``idx`` give the rank's schedule, one entry a step: a
    block start (SAGA, Finito, ProShI's cyclic and shuffled sweeps,
    L-SVRG, L-Katyusha, Point-SAGA, SSNM), the epoch's block starts in
    visit order (LFinito), the outer step's m inner starts (SVRG,
    Katyusha, SARAH), or ProShI's random (b_loc,) rows. ``coins`` gives
    L-SVRG's and L-Katyusha's anchor coins, one a step; by default they
    are drawn from (seed, it) alone, the same on every rank."""
    init_fn, step_fn, rebase_fn, tables = _FAMILY[family]
    runtime.require_exact_f32_matmul(mesh.device, f"TP {family}")
    sweep = _run_sweep(family, cfg)

    def init(x0, a, seed, *extra):
        return init_fn(F, g, mesh, cfg, x0, a, seed, *extra)

    def one(state, starts, idx, coin):
        if coin is None:
            return step_fn(F, g, mesh, cfg, state, starts, idx)
        return step_fn(F, g, mesh, cfg, state, starts, idx, coin)

    def step(state, starts=None, idx=None, coins=None):
        if state.status != Status.RUNNING:
            return state
        return one(_owned(state, tables), starts, idx, coins)

    def run(state, steps, starts=None, idx=None, coins=None):
        if state.status != Status.RUNNING:
            return state
        state = _owned(state, tables)
        if starts is None and idx is None and sweep is not None:
            # the run's block starts in one pass of the hash
            starts = _starts(mesh, cfg, state.seed, state.it, steps, sweep)
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


# ---------------------------------------------------------------------------
# facades of the families beyond the reference
# ---------------------------------------------------------------------------

def _cut_setup(self, who: str, x0, F, g, N, oracle: str = "coeff"):
    """A block family's validated call before its scalars: (mesh, x0
    whole, F, g, N, D) with N/D divisible by ``batch`` and n by M."""
    mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, who, oracle)
    _check_rows(mesh, N, self.batch, who)
    _check_n(mesh, x0, who)
    return mesh, x0, F, g, N, mesh.D


@dataclasses.dataclass(frozen=True)
class TPKatyusha(_TPRun):
    """Katyusha on a (data, model) mesh: samples AND coordinates cut.
    Needs a rank-1 oracle with the margin protocol and a separable prox.
    ``batch`` is the per-data-row inner block size (global inner batch
    batch·D); ``m`` counts inner batches an outer step and defaults to
    2N/(batch·D); ``maxit`` counts outer steps. ``sigma`` sets the
    strongly convex τ₁; without it and ``tau1`` the τ₁ = 2/(s+4)
    schedule runs. Per inner step one (B,) sum over "model" and one
    (n/M,) sum over "data"; no kernel, as in the JAX package."""

    mesh: object = None
    batch: int = 1
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    tau1: Optional[float] = None
    tau2: float = 0.5
    sigma: Optional[float] = None
    seed: int = 0
    _shown = "tau1"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        if self.batch < 1:
            raise ValueError("batch must be at least 1")
        if not 0.0 < self.tau2 < 1.0:
            raise ValueError(f"tau2 must lie in (0, 1), not {self.tau2}")
        if self.tau1 is not None and not 0.0 < self.tau1 <= 1.0 - self.tau2:
            raise ValueError(f"tau1 must lie in (0, 1 - tau2], not "
                             f"{self.tau1}")

    def _setup(self, x0, F, g, L, N):
        who = "TPKatyusha"
        mesh, x0, F, g, N, D = _cut_setup(self, who, x0, F, g, N)
        Lmax = _L_max(L, x0, who)
        m = (2 * N) // (self.batch * D) if self.m is None else self.m
        if m < 1:
            raise ValueError(f"{who}: m must be >= 1")
        if self.tau1 is not None:
            tau1 = _as_real(self.tau1, x0)
        elif self.sigma is not None:
            tau1 = torch.clamp(torch.sqrt(
                m * self.batch * D * _as_real(self.sigma, x0)
                / (3.0 * Lmax)), max=0.5)
        else:
            tau1 = _as_real(0.5, x0)  # epoch 0's 2/(s+4)
        ns = self.tau1 is None and self.sigma is None
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=self.batch, m_inner=m,
                    variant="ns" if ns else "sc")
        return _fns("katyusha", mesh, F, g, cfg, x0, Lmax, self.seed, tau1,
                    self.tau2)


@dataclasses.dataclass(frozen=True)
class TPSARAH(_TPRun):
    """SARAH/ProxSARAH on a (data, model) mesh. Needs a rank-1 oracle
    with the margin protocol and a separable prox. ``batch`` is the
    per-data-row inner block size; ``m`` counts inner steps an outer step
    and defaults to N/(batch·D); ``maxit`` counts outer steps. Per inner
    step one stacked (2, B) sum over "model" (the margins at w_t and
    w_{t−1}) and one (n/M,) sum over "data"."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 1
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    eta: float = 1.0
    seed: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if self.batch < 1:
            raise ValueError("batch must be at least 1")
        if not 0.0 < self.eta <= 1.0:
            raise ValueError(f"eta must lie in (0, 1], not {self.eta}")

    def _setup(self, x0, F, g, L, N):
        who = "TPSARAH"
        mesh, x0, F, g, N, D = _cut_setup(self, who, x0, F, g, N)
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
        elif L is None:
            raise ValueError(f"{who}: provide the smoothness moduli L, or a "
                             "stepsize γ")
        else:
            gamma = 1.0 / (2.0 * _L_max(L, x0, who))
        m = N // (self.batch * D) if self.m is None else self.m
        if m < 1:
            raise ValueError(f"{who}: m must be >= 1")
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=self.batch, m_inner=m)
        return _fns("sarah", mesh, F, g, cfg, x0, gamma, self.seed, self.eta)


@dataclasses.dataclass(frozen=True)
class TPLSVRG(_TPRun):
    """Loopless SVRG on a (data, model) mesh. Per step one stacked (2, B)
    sum over "model" (the live and anchor margins) and one (n/M,) sum over
    "data"; the anchor coin is the same on every rank (drawn from (seed,
    it) alone), so a refresh's collectives (one more of each) run on every
    rank or on none. ``p`` defaults to batch·D/N; ``maxit`` counts
    steps."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 1
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if self.batch < 1:
            raise ValueError("batch must be at least 1")
        if self.p is not None and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], not {self.p}")

    def _setup(self, x0, F, g, L, N):
        who = "TPLSVRG"
        mesh, x0, F, g, N, D = _cut_setup(self, who, x0, F, g, N)
        if self.gamma is None:
            if L is None:
                raise ValueError(f"{who}: provide L or γ")
            gamma = 1.0 / (6.0 * _L_max(L, x0, who))
        else:
            gamma = _as_real(self.gamma, x0)
        p = (self.batch * D) / N if self.p is None else self.p
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=self.batch)
        return _fns("lsvrg", mesh, F, g, cfg, x0, gamma, self.seed, p)


@dataclasses.dataclass(frozen=True)
class TPLKatyusha(_TPRun):
    """Loopless Katyusha on a (data, model) mesh, with :class:`TPLSVRG`'s
    collectives; the coupling and the proximal mirror step run on the
    rank's columns. ``p`` defaults to batch·D/N; ``maxit`` counts
    steps."""

    mesh: object = None
    batch: int = 1
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    theta1: Optional[float] = None
    theta2: float = 0.5
    sigma: Optional[float] = None
    seed: int = 0
    _shown = "theta1"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        if self.batch < 1:
            raise ValueError("batch must be at least 1")
        if not 0.0 < self.theta2 < 1.0:
            raise ValueError(f"theta2 must lie in (0, 1), not {self.theta2}")
        if self.p is not None and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], not {self.p}")
        if self.theta1 is not None and not (
                0.0 < self.theta1 <= 1.0 - self.theta2):
            raise ValueError(f"theta1 must lie in (0, 1 - theta2], not "
                             f"{self.theta1}")

    def _setup(self, x0, F, g, L, N):
        who = "TPLKatyusha"
        mesh, x0, F, g, N, D = _cut_setup(self, who, x0, F, g, N)
        Lmax = _L_max(L, x0, who)
        sigma = _as_real(0.0 if self.sigma is None else self.sigma, x0)
        if self.theta1 is not None:
            theta1 = _as_real(self.theta1, x0)
        elif self.sigma is not None:
            theta1 = torch.clamp(torch.sqrt(
                2.0 * sigma * N / (3.0 * self.batch * D)), max=0.5)
        else:
            theta1 = _as_real(1.0 / 3.0, x0)
        p = (self.batch * D) / N if self.p is None else self.p
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=self.batch)
        return _fns("lkatyusha", mesh, F, g, cfg, x0, Lmax, self.seed, sigma,
                    theta1, self.theta2, p)


@dataclasses.dataclass(frozen=True)
class TPPointSAGA(_TPRun):
    """Point-SAGA on a (data, model) mesh: min (1/N)Σf_i (no composite
    g). Needs the pointprox margin protocol (dense least-squares,
    logistic, Huber, squared-hinge rows). Per step one stacked (2, B) sum
    over "model" (the margins at the shifted iterate and the rows' square
    norms), the θ solve alike on every rank of the model group, one
    (n/M,) sum over "data". ``batch`` is the per-data-row block;
    ``sweeping`` ∈ {1 random, 2 cyclic, 3 shuffled}."""

    mesh: object = None
    gamma: Optional[float] = None
    batch: int = 1
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    sweeping: int = 1
    seed: int = 0

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(gamma=self.gamma)
        if self.batch < 1:
            raise ValueError("batch must be at least 1")

    def _setup(self, x0, F, g, L, N):
        who = "TPPointSAGA"
        if not isinstance(self.mesh, Mesh2D):
            raise ValueError(f"{who} needs a ('data','model') mesh "
                             "(make_mesh_2d)")
        if g is not None and not isinstance(g, Zero):
            raise ValueError(f"{who} solves min (1/N)Σ f_i(x) — no separate "
                             "composite g (see PointSAGA)")
        if not (getattr(F, "supports_pointprox", False)
                and hasattr(F, "pointprox_sqnorm_block")):
            raise ValueError(
                f"{who} needs a scalar-loss row oracle with the pointprox "
                f"margin protocol; {type(F).__name__} does not support it")
        mesh, x0, F, g, N, D = _cut_setup(self, who, x0, F, None, N,
                                          "margin")
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
        elif L is None:
            raise ValueError(f"{who}: provide the smoothness moduli L, or a "
                             "stepsize γ")
        else:
            gamma = 1.0 / (3.0 * _L_max(L, x0, who))
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=self.batch,
                    sweeping=self.sweeping)
        return _fns("point_saga", mesh, F, g, cfg, x0, gamma, self.seed)


@dataclasses.dataclass(frozen=True)
class TPSSNM(_TPRun):
    """SSNM (SAGA with sampled negative momentum) on a (data, model) mesh:
    the coefficient table cut by rows, the stored points by rows AND
    columns. Needs a rank-1 oracle with the margin protocol and a
    separable prox; ``batch`` is the per-data-row block size."""

    mesh: object = None
    batch: int = 1
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
        who = "TPSSNM"
        mesh, x0, F, g, N, D = _cut_setup(self, who, x0, F, g, N)
        if L is None and (self.eta is None or self.tau is None):
            raise ValueError(f"{who}: provide L, or both τ and η")
        Lmax = None if L is None else _L_max(L, x0, who)
        if self.tau is not None:
            tau = _as_real(self.tau, x0)
        elif self.sigma is not None:
            tau = torch.clamp(torch.sqrt(N * _as_real(self.sigma, x0)
                                         / (3.0 * Lmax)), max=0.5)
        else:
            tau = _as_real(0.5, x0)
        eta = (_as_real(self.eta, x0) if self.eta is not None
               else 1.0 / (3.0 * tau * Lmax))  # the mirror coupling
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        cfg = TPCfg(N=N, D=D, M=mesh.M, b_loc=self.batch)
        return _fns("ssnm", mesh, F, g, cfg, x0, tau, self.seed, eta)


def _tp_terms(mesh, x0, F, g, h, N, who: str):
    """A splitting facade's validated call, before the cut: (mesh, x0
    whole, F (``ZeroOracle(n_terms=N)`` when omitted), g, h, N); g and h
    separable, F with the margin protocol unless f = 0."""
    from ciao_tpu_torch.oracles import ZeroOracle

    if not isinstance(mesh, Mesh2D):
        raise ValueError(f"{who} needs a ('data','model') mesh (make_mesh_2d)")
    x0 = torch.as_tensor(x0, device=mesh.device)
    if F is None:
        if N is None:
            raise ValueError(f"{who}: provide F or N")
        F = ZeroOracle(n_terms=N)
    N = _num_terms(F, N)
    g = Zero() if g is None else g
    h = Zero() if h is None else h
    for term, name in ((g, "g"), (h, "h")):
        if not getattr(term, "separable", False):
            raise ValueError(f"{who} shards coordinates — {name} must be "
                             f"separable (got {type(term).__name__})")
    if not isinstance(F, ZeroOracle) and not (
            hasattr(F, "margin_all") and hasattr(F, "margin_block")):
        # the port's sparse rows have margin_all (for the deep route) but
        # GLOBAL column ids in their index tables: refused, as JAX refuses
        # its sparse rows, which lack margin_all
        raise ValueError(f"{who} needs the margin protocol (dense row "
                         f"oracles); {type(F).__name__} is DP-only")
    if N % mesh.D:
        raise ValueError(f"{who}: need N divisible by D")
    _check_n(mesh, x0, who)
    return mesh, x0, F, g, h, N


class _TPSplit:
    """``__call__`` and ``iterator`` of a splitting facade (two proximable
    terms g and h) whose ``_setup`` returns ``(x0, F, (g, h), init, step,
    run, rebase)``: the result whole, gathered over "model"."""

    _shown = "gamma"

    def _run(self, setup, observe):
        x0, F, gh, init, step, run, _ = setup
        shown = self._shown
        disp = lambda it, st: print(  # noqa: E731
            f"{it:5d} | {float(getattr(st, shown)):.3e}")
        state, it = run_solver_loop(init, run, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return gather_model(self.mesh, state.solution), it

    def _iterator(self, x0, setup):
        _, _, _, init, step, run, rebase = setup
        return SolverIterable(x0, init, step, rebase_fn=rebase)


@dataclasses.dataclass(frozen=True)
class TPDavisYin(_TPSplit):
    """Davis-Yin three-operator splitting on a (data, model) mesh:
    minimize (1/N)Σf_i + g + h with g and h proximable and separable.
    Each step one margin sum over "model" and one (n/M,) sum over "data"
    for ∇f (none for f = 0); both proxes on the rank's columns, so the
    trajectory is the single card's to reduction order. Needs the margin
    protocol. ``TPDouglasRachford`` is the f = 0 case (no F, give N)."""

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

        who = "TPDavisYin"
        mesh, x0, F, g, h, N = _tp_terms(self.mesh, x0, F, g, h, N, who)
        if self.gamma is not None:
            gamma = _as_real(self.gamma, x0)
        elif L is not None:
            gamma = 1.0 / torch.mean(torch.as_tensor(
                L, dtype=real_dtype_of(x0), device=x0.device))
        elif isinstance(F, ZeroOracle):
            gamma = _as_real(1.0, x0)  # f = 0: Douglas-Rachford
        else:
            raise ValueError(f"{who}: provide the smoothness moduli L, or a "
                             "stepsize γ")
        n = x0.shape[0]
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        h = put_specs(h, mesh, model_prox_specs(h, n))
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M)
        return _fns("dys", mesh, F, (g, h), cfg, x0, gamma, 0, self.lam)

    def __call__(self, x0, F=None, g=None, h=None, L=None, N=None,
                 observe=None):
        return self._run(self._setup(x0, F, g, h, L, N), observe)

    def iterator(self, x0, F=None, g=None, h=None, L=None, N=None):
        return self._iterator(x0, self._setup(x0, F, g, h, L, N))


def TPDouglasRachford(**kwargs) -> TPDavisYin:
    """``TPDavisYin`` with f = 0 (Douglas-Rachford over the 2-D mesh)."""
    return TPDavisYin(**kwargs)


@dataclasses.dataclass(frozen=True)
class TPCondatVu(_TPSplit):
    """Condat-Vũ on a (data, model) mesh for the stencil maps: minimize
    (1/N)Σf_i + g(x) + h(Kx) with K = ``FirstDifference`` or
    ``IdentityMap`` (omitted). The stencil touches adjacent coordinates
    only, so a rank needs ONE element of a model neighbour per product of
    K: two halos a step, each one all-gather of a one-element tensor over
    the model group (none at M = 1, none for K = I). A ``DenseMap`` K
    mixes every coordinate: use ``DPCondatVu``. The dual is carried
    padded to (n,), cut like x. The stepsizes are the single card's
    (``CondatVu._stepsizes``), so the trajectory is its to reduction
    order. ``TPChambollePock`` is the f = 0 case (no F, give N)."""

    mesh: object = None
    tau: Optional[float] = None
    sigma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    _shown = "tau"

    def __post_init__(self):
        _check_loop(self.maxit, self.freq)
        _check_positive(tau=self.tau, sigma=self.sigma)

    def _setup(self, x0, F, g, h, K, L, N):
        from ciao_tpu_torch.ops.linmap import FirstDifference, IdentityMap
        from ciao_tpu_torch.oracles import ZeroOracle
        from ciao_tpu_torch.solvers.primal_dual import CondatVu

        who = "TPCondatVu"
        K = IdentityMap() if K is None else K
        if isinstance(K, IdentityMap):
            kind = "identity"
        elif isinstance(K, FirstDifference):
            kind = "firstdiff"
        else:
            raise ValueError(
                f"{who} serves stencil maps only (FirstDifference / "
                "IdentityMap) — a dense K mixes coordinates and needs an "
                "n-sized all-gather per step under a coordinate shard; use "
                f"DPCondatVu for DenseMap (got {type(K).__name__})")
        mesh, x0, F, g, h, N = _tp_terms(self.mesh, x0, F, g, h, N, who)
        if L is not None:
            Lf = float(torch.mean(torch.as_tensor(L,
                                                  dtype=real_dtype_of(x0))))
        elif isinstance(F, ZeroOracle) or self.tau is not None:
            Lf = 0.0  # Chambolle-Pock, or the caller owns the condition
        else:
            raise ValueError(f"{who}: provide the smoothness moduli L, or an "
                             "explicit stepsize τ")
        # the single card's stepsize rule, so the trajectories agree
        tau, sigma = CondatVu(tau=self.tau, sigma=self.sigma)._stepsizes(
            Lf, float(K.opnorm_bound(x0.shape[0])))
        n = x0.shape[0]
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
        h = put_specs(h, mesh, model_prox_specs(h, n))
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M, variant=kind)
        return _fns("pd", mesh, F, (g, h), cfg, x0, tau, 0, sigma)

    def __call__(self, x0, F=None, g=None, h=None, K=None, L=None, N=None,
                 observe=None):
        return self._run(self._setup(x0, F, g, h, K, L, N), observe)

    def iterator(self, x0, F=None, g=None, h=None, K=None, L=None, N=None):
        return self._iterator(x0, self._setup(x0, F, g, h, K, L, N))


def TPChambollePock(**kwargs) -> TPCondatVu:
    """``TPCondatVu`` with f = 0 (Chambolle-Pock over the 2-D mesh)."""
    return TPCondatVu(**kwargs)


@dataclasses.dataclass(frozen=True)
class TPPANOC(_TPRun):
    """PANOC/ZeroFPR on a (data, model) mesh: the rows cut over "data",
    the iterate, the gradient and the L-BFGS ring over "model". Each FBE
    evaluation is one margin sum over "model" and two sums over "data";
    every inner product of the direction and the envelope is one scalar
    sum over "model", so the line search's host reads (one a trial) are
    of whole values and every rank takes the same trials; the trajectory
    is the single card's to reduction order. No γ and no L turns the
    γ-backtracking on, its start probed on the whole gradients. Needs the
    margin-value protocol (dense row oracles) and a separable prox; no
    kernel, as in the JAX package."""

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
        from ciao_tpu_torch.solvers.base import rdiv
        from ciao_tpu_torch.solvers.panoc import _probe_gamma

        who = "TPZeroFPR" if self.zerofpr else "TPPANOC"
        mesh, x0, F, g, N = _tp_args(self.mesh, x0, F, g, N, who, "margin")
        if not hasattr(F, "value_from_margin_all"):
            raise ValueError(
                f"{who} needs the margin-value protocol (margin_all/"
                "value_from_margin_all — dense row oracles); "
                f"{type(F).__name__} is DP-only")
        if N % mesh.D:
            raise ValueError(f"{who}: need N divisible by D")
        _check_n(mesh, x0, who)
        rdt = real_dtype_of(x0)
        adaptive = self.adaptive or (self.gamma is None and L is None)
        x0, F, g = _tp_cut(mesh, x0, F, g, N, who)
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
            # the one-time probe on the whole gradients: each summed over
            # "data" and its norm over "model"
            gamma = _probe_gamma(_TPFBEOracle(mesh, F), x0, N, self.alpha,
                                 rdt, _rdot_tp(mesh))
            sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        cfg = TPCfg(N=N, D=mesh.D, M=mesh.M, m_inner=self.mem,
                    max_ls=self.max_ls, adaptive=adaptive,
                    variant="zerofpr" if self.zerofpr else "panoc")
        return _fns("panoc", mesh, F, g, cfg, x0, gamma, 0, sigma)

    def _after(self, state):
        from ciao_tpu_torch.solvers.panoc import warn_if_thrashing

        warn_if_thrashing(state, "TPZeroFPR" if self.zerofpr else "TPPANOC",
                          _rdot_tp(self.mesh))


def TPZeroFPR(**kwargs) -> TPPANOC:
    """``TPPANOC(zerofpr=True)``."""
    return TPPANOC(zerofpr=True, **kwargs)
