"""SAGA / SAG solver family.

Counterpart of ``ciao_tpu/solvers/saga.py``, a re-design of reference
``src/algorithms/SAGA_SAG/SAGA_basic.jl``. The gradient table is one
(N, n) tensor (``table="full"``) or, for a rank-1 oracle, its exact (N,)
coefficient vector (``table="coeff"``): one step draws a block (or an
iid minibatch), refreshes its table rows, forms the SAG (biased) or SAGA
(unbiased) direction and applies the prox.

Defaults (SAGA_basic.jl:34-35): γ = 1/(3 L_max) for SAGA, 1/(16 L_max)
for SAG. Init (SAGA_basic.jl:41-48): table = coefficients at x0, av =
their mean row gradient, z = prox_g((1-γ) x0, γ).

Block schedules are a pure function of (seed, it) (:func:`block_starts`,
:func:`importance_draws`), or explicit ``starts`` (and ``wgts``) tensors
handed to :func:`saga_run` — the JAX package draws with threefry, which
torch cannot reproduce, so parity tests pass JAX's schedule. With block
sampling, coefficient tables and a CUDA device, :func:`saga_run` hands K
steps at a time to a hand-written kernel: ``ops.saga_coeff_multistep``
(N ≤ ``RESIDENT_MAX_ROWS``) or ``ops.saga_coeff_multistep_streamed``
(larger N). Importance sampling (block j drawn with probability
q_j ∝ L_j, direction weighted by 1/(d·q_j)) rides both. The full table's
block steps run on ``ops.saga_block_update`` (one call a step) when its
gate is open (f32 or bf16 rows, block sampling, no importance sampling).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.sampling import (
    _M32, _mix32, _random_rows as _iid_indices, _seed_key,
)
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    default_terms,
    facade_device,
    real_dtype_of,
    run_solver_loop,
)

# Steps per kernel launch of the multistep driver (K in the JAX package).
LAUNCH_STEPS = 128
# Largest N the facade runs on the resident kernel; above it, the
# streamed kernel. It is the JAX package's cap on its VMEM-resident
# coefficient slab (4·N bytes ≤ 4 MB). Both of the port's kernels serve
# any N, so here it only names the kernel, and, with STREAM_MIN_BLOCKS,
# the importance schedule JAX's route would give (:func:`_route`).
RESIDENT_MAX_ROWS = 1 << 20
# Fewest blocks of JAX's streamed route (its birthday clamp needs them).
STREAM_MIN_BLOCKS = 64


class SAGACfg(NamedTuple):
    N: int
    sag: bool
    batch: int = 1
    block: bool = False  # uniform CONTIGUOUS block instead of iid subset
    # coefficient table: K steps per launch of the resident kernel; full
    # table: each block step on kernel #1
    fused: bool = False
    coeff: bool = False  # (N,) coefficient table instead of (N, n) rows
    fused_precision: str = "highest"  # dots in the kernel: exact f32 / bf16
    importance: bool = False  # blocks drawn ∝ L_j, direction · 1/(d·q_j)
    fused_stream: bool = False  # K steps per launch of the streamed kernel
    # systematic importance schedule (JAX's streamed route): step it is slot
    # it % K of window it // K (K = min(iwin, d)); the window draws one
    # uniform U and slot k takes the block whose interval of the π-scale
    # CDF cumsum(K·q̃) holds U + k, with q̃ clipped to at most 1/K per
    # block, so the draws of one window are distinct
    istrat: bool = False
    iwin: int = 64


class SAGAState(NamedTuple):
    s: torch.Tensor        # (N,) coefficient table, or the (N, n) full table
    gamma: torch.Tensor    # scalar
    av: torch.Tensor       # (n,) running average of the table
    z: torch.Tensor        # (n,)
    seed: int              # schedule seed: draws are a function of (seed, it)
    it: int
    status: int
    # importance sampling only: the (d,) inclusive CDF of the block
    # distribution (the π-scale CDF under istrat, last entry exactly K)
    # and the (d,) direction weights 1/(d·q_j); None otherwise
    qcum: Optional[torch.Tensor] = None
    qinv: Optional[torch.Tensor] = None

    @property
    def solution(self):  # reference: solution(state) = state.z
        return self.z


# ---------------------------------------------------------------------------
# stateless schedules
# ---------------------------------------------------------------------------

def block_starts(seed: int, it0: int, k: int, d: int, B: int, device):
    """Block starts of steps it0..it0+k-1: a pure function of (seed, it),
    uniform over the d = N/B blocks, computed on ``device`` in one
    vectorized pass (no host sync). Returns a (k,) int32 tensor."""
    its = torch.arange(it0, it0 + k, dtype=torch.int64, device=device)
    h = _mix32((its & _M32) ^ _seed_key(seed))
    h = _mix32(h ^ 0x9E3779B9)
    return ((h * d) >> 32).mul_(B).to(torch.int32)


def _uniforms(seed: int, ctr, dtype):
    """Uniforms in [0, 1) of the int64 counters ``ctr``: a pure function
    of (seed, counter), exact in ``dtype`` and never 1 (24 bits for f32,
    32 bits for f64)."""
    h = _mix32(_mix32((ctr & _M32) ^ _seed_key(seed)) ^ 0x632BE5AB)
    bits = 24 if dtype == torch.float32 else 32
    return (h >> (32 - bits)).to(dtype) * 2.0 ** -bits


def importance_draws(seed: int, it0: int, k: int, cfg: SAGACfg, qcum,
                     qinv):
    """The (starts, wgts) of steps it0..it0+k-1 under the importance
    schedule, in one vectorized pass on ``qcum``'s device (no host
    sync): block j = searchsorted(qcum, u, right) clamped to d − 1, its
    start j·B as (k,) int32 and its weight ``qinv[j]``. iid: u is the
    uniform of (seed, it). ``istrat``: u = it % K + the uniform of
    (seed, it // K), K = min(iwin, d) — the systematic draw of JAX's
    ``_gen_importance_draws`` with the port's own counter hash in place
    of threefry."""
    d = cfg.N // cfg.batch
    its = torch.arange(it0, it0 + k, dtype=torch.int64, device=qcum.device)
    if cfg.istrat:
        K = min(cfg.iwin, d)
        u = (its % K).to(qcum.dtype) + _uniforms(seed, its // K, qcum.dtype)
    else:
        u = _uniforms(seed, its, qcum.dtype)
    j = torch.searchsorted(qcum, u, right=True).clamp_(max=d - 1)
    return (j * cfg.batch).to(torch.int32), qinv[j]


def stream_launch_K(d: int, factor: float = 1.0) -> int:
    """Launch size of the JAX package's clamped streamed launches: K ≤ d
    (its masked-redirect contract) and about √d, which keeps the
    birthday clamp's committed share high. The port's drivers do not
    clamp and launch ``LAUNCH_STEPS``, so no path of the port calls this:
    it and ``sampling.first_duplicate`` let the tests hold the kernels'
    masked steps to JAX's clamped stream."""
    return min(64, d, max(8, (int(factor * d ** 0.5) // 8) * 8))


# ---------------------------------------------------------------------------
# init / steps
# ---------------------------------------------------------------------------

def saga_init(F, g, x0, gamma, seed: int, cfg: SAGACfg) -> SAGAState:
    """Reference SAGA_basic.jl:41-48. The gradient table
    s_i = ∇f_i(x0) is the (N, n) table of F.grad_all, or in coefficient
    mode (oracles with ``supports_coeff``) the exact (N,) coefficient
    vector c with s_i = c_i·a_i; the full passes are plain products."""
    gamma = torch.as_tensor(gamma, dtype=real_dtype_of(x0), device=x0.device)
    if cfg.coeff:
        s = F.coeff_all(x0)
        av = F.apply_all(s) / cfg.N
    else:
        s = F.grad_all(x0)
        av = torch.mean(s, dim=0)
    z = g.prox_only((1 - gamma) * x0, gamma)
    return SAGAState(s=s, gamma=gamma, av=av, z=z, seed=int(seed), it=1,
                     status=int(Status.RUNNING))


def saga_rebase(F, state: SAGAState, cfg: SAGACfg) -> SAGAState:
    """Make ``av`` consistent with the table under ``F``'s row storage.

    The running average is maintained by deltas, so after swapping the
    oracle's storage mid-run (f32/bf16/int8 stages) it still reflects the
    old rows, and the mismatch never decays. One pass over A repairs it.
    The full table is storage-consistent by construction (av averages the
    stored gradient rows, and deltas under the new rows keep it exact):
    it is returned unchanged."""
    if not cfg.coeff:
        return state
    return state._replace(av=F.apply_all(state.s) / cfg.N)


def _saga_direction(cfg, state, innov, B, wgt=1.0):
    """The SAG (biased, average first) / SAGA (unbiased) update-order
    quirk (SAGA_basic.jl:57-62). ``innov`` = Σ_B (∇f_i(z) − s_i_old);
    ``wgt`` scales the direction only, never the table-mean delta."""
    N = cfg.N
    diff = innov * (wgt / B)
    if cfg.sag:
        av = state.av + innov / N
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (diff + state.av)
        av = state.av + innov / N
    return av, w


def _block_choice(cfg: SAGACfg, state: SAGAState):
    """The step's (block start, direction weight): the uniform
    :func:`block_starts` stream with weight 1, or under importance
    sampling one draw of :func:`importance_draws`."""
    if not cfg.importance:
        return block_starts(state.seed, state.it, 1, cfg.N // cfg.batch,
                            cfg.batch, state.z.device)[0], 1.0
    starts, wgts = importance_draws(state.seed, state.it, 1, cfg, state.qcum,
                                    state.qinv)
    return starts[0], wgts[0]


def _saga_step_coeff(F, g, cfg: SAGACfg, state: SAGAState, start=None,
                     wgt=None, inplace=False, idx=None):
    """Coefficient-table step: the innovation Σ (c_new − c_old)·a_i is
    one extra product over the same rows the coefficients read. The table
    is replaced, not written in place, so earlier states stay valid —
    except for a driver that owns a copy of it (``inplace``), which saves
    copying the whole table every step."""
    N, B = cfg.N, cfg.batch
    dev = state.z.device
    if cfg.block:
        if start is None:
            start, wgt = _block_choice(cfg, state)
        idx = torch.as_tensor(start, device=dev).long() + torch.arange(
            B, device=dev)
        c_new = F.coeff_block(state.z, start, B)
        innov = F.apply_rows_block(c_new - state.s[idx], start, B)
    else:
        if idx is None:
            idx = _iid_indices(state.seed, state.it, N, B, dev)
        c_new = F.coeff_batch(state.z, idx)
        innov = F.apply_rows(c_new - state.s[idx], idx)
    if inplace:
        s = state.s.index_copy_(0, idx, c_new)
    else:
        s = state.s.index_copy(0, idx, c_new)
    av, w = _saga_direction(cfg, state, innov, B, 1.0 if wgt is None else wgt)
    z = g.prox_only(w, state.gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + 1)


def _saga_step_full(F, g, cfg: SAGACfg, state: SAGAState, start=None,
                    wgt=None, inplace=False, idx=None):
    """Full-table step (SAGA_basic.jl:55-65, batched): the block's (or
    the iid minibatch's) gradients at z replace their table rows; the
    innovation is their mean change. With ``cfg.fused`` a block step is
    one call of kernel #1 (``F.fused_saga_block``), gradients, table
    write and innovation in one pass. The table is written in place only
    when the caller owns it (``inplace``)."""
    N, B = cfg.N, cfg.batch
    dev = state.z.device
    s = state.s if inplace else state.s.clone()
    if cfg.block:
        if start is None:
            start, wgt = _block_choice(cfg, state)
        if cfg.fused:
            s, innov = F.fused_saga_block(s, state.z, start, B,
                                          precision=cfg.fused_precision)
            av, w = _saga_direction(cfg, state, innov, B)
            z = g.prox_only(w, state.gamma)
            return state._replace(s=s, av=av, z=z, it=state.it + 1)
        idx = torch.as_tensor(start, device=dev).long() + torch.arange(
            B, device=dev)
        G_B = F.grad_block(state.z, start, B)
    else:
        wgt = None
        if idx is None:
            idx = _iid_indices(state.seed, state.it, N, B, dev)
        G_B = F.grad_batch(state.z, idx)
    diff = torch.mean(G_B - s[idx], dim=0)
    if cfg.sag:
        av = state.av + diff * (B / N)
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (
            diff * (1.0 if wgt is None else wgt) + state.av)
        av = state.av + diff * (B / N)
    s.index_copy_(0, idx, G_B)
    z = g.prox_only(w, state.gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + 1)


def _saga_step(F, g, cfg: SAGACfg, state: SAGAState, start=None, wgt=None,
               inplace=False, idx=None):
    if cfg.importance and (cfg.sag or (cfg.fused and not cfg.coeff)):
        # SAG's average-first order and the full-table kernel have no
        # weighted counterpart: they would ignore the 1/(d·q_j) weight and
        # bias the direction (the facade refuses these; SAGACfg is also
        # built directly)
        raise ValueError(
            "SAGACfg(importance=True) is incompatible with sag=True or "
            "with fused=True on the full-table path (those step branches "
            "ignore the importance unbiasedness weight)")
    step = _saga_step_coeff if cfg.coeff else _saga_step_full
    return step(F, g, cfg, state, start, wgt, inplace, idx)


def _scalars_row(F, g, state, cfg: SAGACfg):
    """The kernels' (8,) f32 scalars row [scale, γ, γλ, 1/B, 1/N, sag,
    mode, aux] on the state's device."""
    from ciao_tpu_torch.ops.fused_block import oracle_scalar_consts

    dev = state.z.device
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    gamma = state.gamma.to(dev).float()
    consts = torch.tensor([1.0 / cfg.batch, 1.0 / cfg.N,
                           1.0 if cfg.sag else 0.0],
                          dtype=torch.float32, device=dev)
    return torch.cat([torch.stack([scale, gamma, gamma * lam.float()]),
                      consts, torch.stack([mode, aux])])


def _explicit(starts, wgts, i: int):
    """(start, weight) of position ``i`` of an explicit schedule."""
    if starts is None:
        return None, None
    return starts[i], None if wgts is None else wgts[i]


def _saga_run_fused(F, g, state, cfg: SAGACfg, steps: int, starts=None,
                    wgts=None):
    """Multistep driver, the counterpart of both JAX drivers
    (``_saga_run_fused`` and ``_saga_run_fused_streamed``): K steps per
    call of ``ops.saga_coeff_multistep_streamed`` when
    ``cfg.fused_stream``, else of ``ops.saga_coeff_multistep``, on one
    schedule (the explicit ``starts`` / ``wgts`` when given, else the
    (seed, it) draws). K = ``LAUNCH_STEPS``; under the systematic
    importance schedule (``istrat``) K is one whole window of
    min(iwin, d) steps and launches start at window boundaries, as JAX's
    window-aligned branch does. The steps before the first launch and
    after the last whole one run stepwise. The table, z and av are
    copied once and then updated in place by the kernel and by the
    stepwise steps.

    No clamp: JAX's streamed driver stops each launch at its first
    same-launch block revisit and advances ``it`` by the committed prefix
    only, because its TPU kernel streams the table through aliased
    windows. Here the table lives in device memory and each step's
    launches are stream-ordered, so a revisit reads the previous step's
    coefficients and every launch commits all its steps (``f`` = None).
    Both packages commit the stepwise stream."""
    from ciao_tpu_torch.ops import fused_block

    kernel = (fused_block.saga_coeff_multistep_streamed if cfg.fused_stream
              else fused_block.saga_coeff_multistep)
    if cfg.istrat:
        K = align = min(cfg.iwin, cfg.N // cfg.batch)
    else:
        K, align = min(LAUNCH_STEPS, steps), 1
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    scalars = _scalars_row(F, g, state, cfg)
    it0, target = state.it, state.it + steps
    state = state._replace(s=state.s.clone(), z=state.z.clone(),
                           av=state.av.clone())

    def step(state):
        return _saga_step(F, g, cfg, state,
                          *_explicit(starts, wgts, state.it - it0),
                          inplace=True)

    while state.it % align and state.it < target:
        state = step(state)
    dev = state.z.device
    while state.it + K <= target:
        off = state.it - it0
        if starts is not None:
            st = starts[off:off + K]
            wg = None if wgts is None else wgts[off:off + K].float()
        elif cfg.importance:
            st, wg = importance_draws(state.seed, state.it, K, cfg,
                                      state.qcum, state.qinv)
            wg = wg.float()
        else:
            st = block_starts(state.seed, state.it, K, cfg.N // cfg.batch,
                              cfg.batch, dev)
            wg = None
        kernel(rows, offs, st, state.s, state.z, state.av, scalars,
               cfg.batch, precision=cfg.fused_precision, rs=rs, wgts=wg)
        state = state._replace(it=state.it + K)
    while state.it < target:
        state = step(state)
    return state


def _check_starts(starts, steps: int, cfg: SAGACfg, device):
    """An explicit schedule as a (steps,) int32 tensor on ``device``,
    checked on the host once (block-aligned and in range)."""
    if not cfg.block:
        raise ValueError("an explicit starts schedule needs block sampling")
    starts = torch.as_tensor(starts).to(device=device, dtype=torch.int32)
    if tuple(starts.shape) != (steps,):
        raise ValueError(f"starts has shape {tuple(starts.shape)}, "
                         f"expected ({steps},)")
    host = starts.cpu()
    if steps and (int(host.min()) < 0 or int(host.max()) > cfg.N - cfg.batch
                  or bool((host % cfg.batch != 0).any())):
        raise ValueError("starts must be multiples of batch in [0, N - batch]")
    return starts.contiguous()


def saga_run(F, g, state, cfg: SAGACfg, steps: int, starts=None,
             wgts=None, idx=None):
    """Advance ``steps`` steps. ``starts`` optionally gives the (steps,)
    block starts to use instead of the (seed, it) draws, and ``wgts``
    (with ``starts``) their (steps,) direction weights 1/(d·q_j); without
    ``wgts`` an explicit schedule is weighted 1. ``idx`` gives an iid
    run's (steps, batch) rows in place of its draws. A full-table run
    copies the table once and then writes it in place."""
    dev = state.z.device
    if idx is not None:
        if cfg.block:
            raise ValueError("an explicit idx schedule needs iid sampling")
        idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int64)
        if tuple(idx.shape) != (steps, cfg.batch):
            raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                             f"({steps}, {cfg.batch})")
    if starts is not None:
        starts = _check_starts(starts, steps, cfg, dev)
    if wgts is not None:
        if starts is None:
            raise ValueError("explicit wgts need explicit starts")
        wgts = torch.as_tensor(wgts).to(dev).contiguous()
        if tuple(wgts.shape) != (steps,):
            raise ValueError(f"wgts has shape {tuple(wgts.shape)}, "
                             f"expected ({steps},)")
    if cfg.coeff and (cfg.fused or cfg.fused_stream) and steps >= 8:
        return _saga_run_fused(F, g, state, cfg, steps, starts, wgts)
    full = not cfg.coeff
    if full:
        state = state._replace(s=state.s.clone())
        if cfg.block and starts is None:
            # the run's block draws in one vectorized pass (the stream of
            # _block_choice, a pure function of (seed, it)): a step's host
            # work is then its table refresh and its direction
            if cfg.importance:
                starts, wgts = importance_draws(state.seed, state.it, steps,
                                                cfg, state.qcum, state.qinv)
            else:
                starts = block_starts(state.seed, state.it, steps,
                                      cfg.N // cfg.batch, cfg.batch, dev)
    for i in range(steps):
        state = _saga_step(F, g, cfg, state, *_explicit(starts, wgts, i),
                           inplace=full, idx=None if idx is None else idx[i])
    return state


def saga_step(F, g, state, cfg: SAGACfg, start=None):
    return _saga_step(F, g, cfg, state, start)


def _route(F, g, x0, N: int, B: int):
    """(resident, streamed, istrat) of a block-sampling run. When the
    kernels' gate is open (a CUDA device, dense rows, an in-kernel prox,
    f32 iterates), every such run takes a kernel: the resident one for
    N ≤ ``RESIDENT_MAX_ROWS``, else the streamed one. Without importance
    sampling the kernel changes nothing but speed: both commit the
    stepwise stream. ``istrat`` is where JAX's route
    (``ciao_tpu/solvers/saga.py`` 682-708) decides semantics: it picks
    the systematic importance schedule on its streamed route — not
    resident (N ≤ ``RESIDENT_MAX_ROWS`` and N % (8·B) == 0) and
    d = N/B ≥ ``STREAM_MIN_BLOCKS`` — and the iid one elsewhere. The
    routes differ from JAX's in these places only, each of which exists
    for the TPU alone: JAX sends the runs that neither of its rules takes
    to the stepwise path, and its gates also apply ``_pick_tile``'s VMEM
    budget and n % 128 lanes."""
    from ciao_tpu_torch.ops import fused_block

    if not fused_block.saga_multistep_available(F, g, x0, B):
        return False, False, False
    streamed = (N > RESIDENT_MAX_ROWS
                and fused_block.saga_multistep_streamed_available(F, g, x0,
                                                                  B))
    jax_resident = N <= RESIDENT_MAX_ROWS and N % (8 * B) == 0
    return (not streamed, streamed,
            not jax_resident and N // B >= STREAM_MIN_BLOCKS)


def _importance_setup(L, N: int, B: int, istrat: bool, rdt, device):
    """The facade's importance schedule (JAX ``saga.py`` 651-661,
    724-748), built in float64 on the host — an f32 cumsum over many
    blocks skews the draws away from the q of the weights — with only
    the finished CDF and weights moved to ``device``. q_j ∝ the largest
    L_i of block j. The systematic schedule (``istrat``, JAX's streamed
    route) clips q to at most 1/K per block (K = min(64, d)) and keeps
    the π-scale CDF cumsum(K·q̃), its last entry exactly K; the iid
    schedule keeps the iid CDF. Returns (qcum, qinv, L_eff, iwin),
    L_eff = max_j L_j/(d·q_j) the effective smoothness of the
    stepsize."""
    from ciao_tpu_torch.sampling import clip_block_distribution

    L64 = np.asarray(torch.as_tensor(L).detach().cpu(), np.float64)
    if L64.ndim == 0:
        L64 = np.full((N,), L64)
    d = N // B
    Lblk = np.max(L64.reshape(d, B), axis=1)
    q = Lblk / np.sum(Lblk)
    iwin = 64
    if istrat:
        iwin = min(64, d)
        q, _ = clip_block_distribution(q, iwin)
        qcum = np.cumsum(iwin * q)
        qcum *= iwin / qcum[-1]
        qcum[-1] = iwin
    else:
        qcum = np.cumsum(q)
        qcum /= qcum[-1]
    L_eff = float(np.max(Lblk / (d * q)))
    return (torch.tensor(qcum, dtype=rdt, device=device),
            torch.tensor(1.0 / (d * q), dtype=rdt, device=device),
            L_eff, iwin)


def _warn_fallback(who: str, F, g, x0, coeff: bool = True):
    """One-time warning when a block-sampling config of facade ``who``
    (SAGA, SVRG, Finito) on a CUDA device lands on the stepwise path,
    naming the first closed gate and its remedy; ``coeff`` False for
    SAGA's full (N, n) table. Silent for CPU iterates. (N % batch != 0,
    the gate's shape condition, is refused by the facades before they
    route.) Sparse rows are served by no kernel, by design: the hybrid
    layout is their fast path and stays silent, and pure ELL names the
    hybrid as the remedy."""
    if x0.device.type != "cuda":
        return
    if hasattr(F, "nnz_per_row"):
        if not hasattr(F, "hot_width"):
            runtime.warn_fused_fallback(
                who, "no CUDA kernel serves sparse rows, and pure-ELL rows "
                "route every slot through a gather and an atomic "
                "scatter-add (a full pass of the planted 131,072 x 16,384 "
                "problem: 1.39-1.43 ms in ELL, 0.57-0.61 ms in the hybrid "
                "on an NVIDIA H100 80GB HBM3 at 700 W)",
                "store the popular columns dense via "
                "HybridSparseLeastSquares/HybridSparseLogistic for full "
                "passes (FISTA, anchors, the polish); a stepwise SAGA "
                "step is host-bound on either layout",
            )
        return
    if x0.dtype != torch.float32:
        runtime.warn_fused_fallback(
            who, f"the iterate dtype is {x0.dtype} and the kernel is "
            "f32-only",
            "use float32 iterates — precision belongs in the oracle's row "
            "storage (with_storage) and the deep_solve polish, not the "
            "iterate dtype",
        )
    elif not coeff:
        runtime.warn_fused_fallback(
            who, "the full-table (N, n) kernel serves f32 or bf16 dense "
            "rows (fused_saga_block) without importance sampling, and int8 "
            "rows never serve it",
            "store the rows f32 or bf16, or use a rank-1 oracle so "
            "table='auto' selects the coefficient table",
        )
    elif not (hasattr(F, "coeff_rows_data") and isinstance(g, (NormL1, Zero))):
        runtime.warn_fused_fallback(
            who, "the in-kernel prox covers NormL1/Zero only, and the "
            "oracle must expose dense rows (coeff_rows_data)",
            "use g=NormL1 or g=Zero and a dense-rows oracle",
        )
    else:
        runtime.warn_fused_fallback(
            who, "the oracle's rows are not f32, bf16 or int8 rows with "
            "f32 offsets on the iterate's device, or n exceeds the "
            "kernel's MAX_COLS",
            "store the oracle in float32 (then with_storage) on the "
            "iterate's device",
        )


@dataclasses.dataclass(frozen=True)
class SAGA:
    """SAGA facade (reference ``SAGA.jl:24-42``). ``SAG_flag`` switches to
    the biased SAG update (reference ``SAGA.jl:190-191``). ``device`` is
    where the run happens (default: x0's device for a tensor x0, else the
    card when there is one); the oracle and the prox are moved there
    with ``.to(device)``."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    SAG_flag: bool = False
    batch: int = 1
    block_sampling: bool = False  # contiguous-block minibatches
    importance_sampling: bool = False  # q_j ∝ L_j block draws (needs L)
    table: str = "auto"  # "coeff" (N,) | "auto" (coeff if rank-1) | "full"
    fused_precision: str = "highest"  # "highest" = exact-f32 kernel dots;
    # "default" = bf16 operands with f32 accumulation
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.gamma is not None and not self.gamma > 0:
            raise ValueError(f"gamma must be positive, not {self.gamma}")
        if self.maxit < 1 or self.freq < 1 or self.batch < 1:
            raise ValueError("maxit, freq and batch must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")
        if self.table not in ("auto", "full", "coeff"):
            raise ValueError(f"table must be 'auto', 'full' or 'coeff', not "
                             f"{self.table!r}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rank1 = getattr(F, "supports_coeff", False)
        coeff = rank1 if self.table == "auto" else self.table == "coeff"
        if coeff and not rank1:
            raise ValueError("SAGA table='coeff' needs a rank-1 oracle "
                             "(supports_coeff)")
        if self.importance_sampling:
            # q_j ∝ L_j block draws, unbiased through the 1/(d·q_j)
            # direction weight; SAG's average-first order has no weighted
            # counterpart
            if self.SAG_flag:
                raise ValueError("importance_sampling supports SAGA only")
            if not self.block_sampling:
                raise ValueError(
                    "importance_sampling needs block_sampling=True")
            if L is None:
                raise ValueError("SAGA importance_sampling: provide L")
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SAGA block_sampling needs N divisible by batch")
        fused = fused_stream = istrat = False
        if self.block_sampling:
            if coeff:
                fused, fused_stream, istrat = _route(F, g, x0, N, self.batch)
            elif not self.importance_sampling:
                # the full-table kernel: f32/bf16 rows (int8 rows need
                # the coefficient table — the f32 table traffic dominates)
                fused = fused_block.saga_block_available(F, x0, self.batch)
            if not (fused or fused_stream):
                _warn_fallback("SAGA", F, g, x0, coeff)
        rdt = real_dtype_of(x0)
        qcum = qinv = None
        iwin = 64
        istrat = istrat and self.importance_sampling
        if self.importance_sampling:
            qcum, qinv, L_eff, iwin = _importance_setup(
                L, N, self.batch, istrat, rdt, device)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        elif L is None:
            raise ValueError(
                "SAGA: smoothness parameter absent — provide L or γ")
        elif self.importance_sampling:
            # the effective smoothness max_j L_j/(d·q_j): the mean block
            # smoothness for q ∝ L, larger where the clip lowered q
            gamma = torch.as_tensor(1.0 / (3.0 * L_eff), dtype=rdt,
                                    device=device)
        else:
            L_max = torch.max(torch.as_tensor(L, dtype=rdt, device=device))
            gamma = 1.0 / ((16.0 if self.SAG_flag else 3.0) * L_max)
        cfg = SAGACfg(
            N=N, sag=self.SAG_flag, batch=self.batch,
            block=self.block_sampling, fused=fused, coeff=coeff,
            fused_precision=self.fused_precision,
            importance=self.importance_sampling, fused_stream=fused_stream,
            istrat=istrat, iwin=iwin,
        )
        return x0, F, g, cfg, lambda: saga_init(
            F, g, x0, gamma, self.seed, cfg)._replace(qcum=qcum, qinv=qinv)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return saga_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        return SolverIterable(
            x0_orig, init, lambda s: saga_step(F, g, s, cfg),
            rebase_fn=lambda s: saga_rebase(F, s, cfg),
        )


def SAG(**kwargs):
    """SAG = SAGA with the biased update order (reference SAGA.jl:190-191)."""
    return SAGA(SAG_flag=True, **kwargs)
