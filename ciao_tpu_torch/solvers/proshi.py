"""ProShI — proximal sharing-problem incremental solver.

Counterpart of ``ciao_tpu/solvers/proshi.py``, a re-design of reference
``src/algorithms/ProShI/ProShI_basic.jl`` for

    minimize (1/N) Σ_i f_i(x_i) + g(Σ_i x_i)

Each block variable x_i is a row of the (N, n) table ``s``; the coupling
runs through ``av = Σ_i s_i`` and the dual-like coupling variable

    z = (prox_g(av, hat_γ) - av) / hat_γ,   hat_γ = Σ_i γ_i

(hat_γ is the SUM here, not the harmonic mean as in Finito —
ProShI_basic.jl:82 against Finito_basic.jl:82). Per-index update
(ProShI_basic.jl:111-120), batched exactly (every i of a batch reads the
same z, and the av deltas add):

    s_i <- (s_i + γ_i z) - (γ_i/N) ∇f_i(s_i + γ_i z);  av += Δs_i

``state.solution`` is the pure view x_i = s_i + γ_i z (the reference
writes it into its table, ProShI_basic.jl:127-132, which corrupts
repeated calls; the JAX package and the port return a fresh tensor).

Schedules are the port's own draws (``ciao_tpu_torch.sampling``), or an
explicit one handed to :func:`proshi_run` (block ids, or a RANDOM sweep's
rows), so the parity tests can replay JAX's key chain. With a contiguous
schedule (cyclic, shuffled, or random with ``block_sampling``), a dense
rank-1 row oracle, an in-kernel coupling prox and a CUDA device, the
steps run ``LAUNCH_STEPS`` at a time on ``ops.proshi_multistep``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.ops.fused_block import _two_sum
from ciao_tpu_torch.sampling import (
    Sweep, SweepState, gen_block_ids, init_sweep, next_block, next_block_id,
)
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    default_terms,
    facade_device,
    real_dtype_of,
    resolve_gamma_array,
    run_solver_loop,
)
from ciao_tpu_torch.solvers.finito import _block_rows, _schedule
from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS


class ProshiCfg(NamedTuple):
    N: int
    batch: int
    sweeping: int
    alpha: float
    fused: bool = False  # LAUNCH_STEPS steps a call of kernel #18
    fused_precision: str = "highest"  # accepted; the kernel's margins are f32
    # random sweeping draws contiguous random BLOCKS (iid block ids of the
    # sweep) instead of scattered without-replacement index sets: the
    # batched form the kernel can serve. Stepwise and fused share it.
    block_sampling: bool = False


class ProshiState(NamedTuple):
    s: torch.Tensor          # (N, n) block table
    gamma: torch.Tensor      # (N,)
    hat_gamma: torch.Tensor  # Σ γ_i
    av: torch.Tensor         # (n,) Σ_i s_i
    z: torch.Tensor          # (n,) coupling variable
    sweep: SweepState
    it: int
    status: int

    @property
    def solution(self):
        """The pure view of the N block solutions x_i = s_i + γ_i z."""
        return self.s + self.gamma[:, None] * self.z[None, :]


def _coupling(g, av, hat_gamma):
    return (g.prox_only(av, hat_gamma) - av) / hat_gamma


def _resync_chunk_of(N: int, chunk: int) -> int:
    c = min(chunk, N)
    while N % c:
        c -= 1
    return c


def _av_compensated(s, chunk: int):
    """Σ_i s_i over the (N, n) table with per-chunk sums and a
    compensated (two-sum) carry across chunks, in chunk order: the f32
    error falls from ~√N·eps to ~√chunk·eps + O(eps²)."""
    N, n = s.shape
    sums = s.reshape(N // chunk, chunk, n).sum(dim=1)
    hi = lo = torch.zeros(n, dtype=s.dtype, device=s.device)
    for i in range(N // chunk):
        hi, lo = _two_sum(hi, lo, sums[i])
    return hi + lo


def proshi_resync(g, state: ProshiState, chunk: int = 4096) -> ProshiState:
    """Recompute the coupling sum ``av = Σ_i s_i`` exactly (compensated
    chunked reduction) and refresh ``z``.

    ProShI keeps ``av`` by increments (ProShI_basic.jl:113-123); in f32
    the rounding drifts, and a drift δ displaces the fixed point so that
    the coupling sum becomes prox_g(av_true + δ) − δ: the soft-threshold's
    exact zeros off the support are lost, which costs a first-order
    λ‖δ‖₁ in the sharing objective. Resyncing at chunk boundaries removes
    the drift; :func:`deep_solve_sharing` packages the schedule.
    ``chunk`` is rounded down to a divisor of N."""
    av = _av_compensated(state.s, _resync_chunk_of(state.s.shape[0], chunk))
    return state._replace(av=av, z=_coupling(g, av, state.hat_gamma))


def sharing_objective(F, g, state: ProshiState, chunk: int = 4096):
    """The sharing objective (1/N) Σ_i f_i(x_i) + g(Σ_i x_i) at the
    state's block solution, with compensated chunked reductions for the
    value sum and the coupling sum (a monolithic f32 reduction over N
    blocks cannot resolve rel 1e-6). A 0-d tensor."""
    N, n = state.s.shape
    chunk = _resync_chunk_of(N, chunk)
    hi = lo = torch.zeros((), dtype=state.s.dtype, device=state.s.device)
    for start in range(0, N, chunk):
        x_blk = (state.s[start:start + chunk]
                 + state.gamma[start:start + chunk, None] * state.z[None, :])
        idx = torch.arange(start, start + chunk, device=state.s.device)
        vals, _ = F.value_and_grad_pointwise(x_blk, idx)
        hi, lo = _two_sum(hi, lo, torch.sum(vals))
    # Σ_i x_i = Σ_i s_i + (Σ_i γ_i) z: no (N, n) temporary
    u = _av_compensated(state.s, chunk) + state.hat_gamma * state.z
    return (hi + lo) / N + g.value(u)


def proshi_init(F, g, x0, gamma, seed: int, cfg: ProshiCfg) -> ProshiState:
    """Reference ProShI_basic.jl:45-90."""
    N = cfg.N
    G = F.grad_all(x0)
    s = x0[None, :] - (gamma / N)[:, None] * G
    hat_gamma = torch.sum(gamma)
    av = torch.sum(s, dim=0)
    return ProshiState(
        s=s, gamma=gamma, hat_gamma=hat_gamma, av=av,
        z=_coupling(g, av, hat_gamma),
        sweep=init_sweep(seed, N, cfg.batch, cfg.sweeping, x0.device),
        it=1, status=int(Status.RUNNING))


def _contiguous(cfg: ProshiCfg) -> bool:
    """Whether the steps take whole contiguous blocks: cyclic, shuffled or
    block-sampled random sweeps over evenly dividing batches."""
    return ((cfg.sweeping != Sweep.RANDOM or cfg.block_sampling)
            and cfg.N % cfg.batch == 0)


def _proshi_step(F, g, cfg: ProshiCfg, state: ProshiState, block=None,
                 idx=None, inplace=False) -> ProshiState:
    """Reference ProShI_basic.jl:93-125, batched. ``block`` (a block
    sweep) or ``idx`` (a RANDOM sweep's rows) replace the step's draw;
    the sweep advances as it would. The table is written in place only
    when the caller owns it (``inplace``)."""
    N, B = cfg.N, cfg.batch
    dev = state.z.device
    sweep = state.sweep
    s = state.s if inplace else state.s.clone()
    if _contiguous(cfg):
        drawn, sweep = next_block_id(sweep, N, B, cfg.sweeping)
        block = drawn if block is None else block
        rows, _ = _block_rows(block, N, B, dev)
        start = block * B
        gi = state.gamma[rows]
        s_old = s[rows]
        s_tmp = s_old + gi[:, None] * state.z[None, :]
        G_B = F.grad_pointwise_block(s_tmp, start, B)
        s_new = s_tmp - (gi / N)[:, None] * G_B
        av = state.av + torch.sum(s_new - s_old, dim=0)
        s.index_copy_(0, rows, s_new)
    else:
        if cfg.sweeping == Sweep.RANDOM:
            if idx is None:
                idx, mask, sweep = next_block(sweep, N, B, cfg.sweeping)
            else:
                idx = torch.as_tensor(idx, device=dev).long()
                mask = torch.ones(B, dtype=torch.bool, device=dev)
                sweep = sweep._replace(pos=sweep.pos + 1)
        else:  # a ragged block sweep: the last block's lanes are masked
            drawn, sweep = next_block_id(sweep, N, B, cfg.sweeping)
            idx, mask = _block_rows(drawn if block is None else block, N, B,
                                    dev)
        gi = state.gamma[idx]
        s_old = s[idx]
        s_tmp = s_old + gi[:, None] * state.z[None, :]
        G_B = F.grad_pointwise(s_tmp, idx)       # per-block eval points
        s_new = s_tmp - (gi / N)[:, None] * G_B
        delta = torch.where(mask[:, None], s_new - s_old, 0)
        av = state.av + torch.sum(delta, dim=0)
        s.index_add_(0, idx, delta)
    z = _coupling(g, av, state.hat_gamma)
    return state._replace(s=s, av=av, z=z, sweep=sweep, it=state.it + 1)


def _gprox_consts(g, hat, dev):
    """(glo, ghi, gmode) of the in-kernel coupling prox, f32 on ``dev``."""
    from ciao_tpu_torch.ops.fused_block import (
        GPROX_BOX, GPROX_L1, GPROX_ZERO, _scalar,
    )
    from ciao_tpu_torch.prox import IndBox, NormL1

    if isinstance(g, NormL1):
        return (_scalar(hat, dev) * g.lam.to(dev).float(), _scalar(0.0, dev),
                _scalar(GPROX_L1, dev))
    if isinstance(g, IndBox):
        return (_scalar(g.lo.reshape(()), dev), _scalar(g.hi.reshape(()), dev),
                _scalar(GPROX_BOX, dev))
    return _scalar(0.0, dev), _scalar(0.0, dev), _scalar(GPROX_ZERO, dev)


def _scalars_row(F, g, state: ProshiState, cfg: ProshiCfg):
    """Kernel #18's (8,) f32 scalars row [scale, 1/N, 1/hat, mode, glo,
    ghi, gmode, aux] on the rows' device."""
    from ciao_tpu_torch.ops.fused_block import _scalar, oracle_scalar_consts

    dev = F.coeff_rows_data()[0].device
    scale, mode, _, aux = oracle_scalar_consts(F, g)
    hat = state.hat_gamma.to(dev)
    glo, ghi, gmode = _gprox_consts(g, hat, dev)
    return torch.stack([scale, _scalar(1.0 / cfg.N, dev),
                        (1.0 / hat).float(), mode, glo, ghi, gmode, aux])


def _proshi_run_fused(F, g, state: ProshiState, cfg: ProshiCfg, steps: int,
                      blocks=None):
    """Multistep driver, the counterpart of both JAX drivers
    (``_proshi_run_fused`` for cyclic sweeps and ``_proshi_run_fused_
    clamped`` for shuffled and block-sampled random ones):
    ``LAUNCH_STEPS`` steps a call of ``ops.proshi_multistep``, the last
    call the remainder. The blocks are the explicit ``blocks``, else
    ``gen_block_ids`` windows of the sweep (the stepwise stream,
    vectorized). s, av and z are copied once and then updated in place.

    No clamp: JAX's kernel streams the table through aliased windows, so
    a launch must not revisit a block; its drivers cut K to d (cyclic)
    or clamp at the first revisit. Here the table lives in device memory
    and a revisit within a call reads the previous visit's rows (the
    persistent engine's grid barriers order them), so every call commits
    all its steps: both packages commit the stepwise stream."""
    from ciao_tpu_torch.ops.fused_block import proshi_multistep

    N, B = cfg.N, cfg.batch
    rows, offs = F.coeff_rows_data()
    scalars = _scalars_row(F, g, state, cfg)
    gamma = state.gamma.to(rows.device).float().contiguous()
    s, av, z = (t.clone() for t in (state.s, state.av, state.z))
    sweep, it = state.sweep, state.it
    for k0 in range(0, steps, LAUNCH_STEPS):
        K = min(LAUNCH_STEPS, steps - k0)
        drawn, sweep = gen_block_ids(sweep, K, N, B, cfg.sweeping)
        blk = drawn if blocks is None else blocks[k0:k0 + K]
        proshi_multistep(rows, offs, gamma, s, (blk.long() * B).to(
            torch.int32), av, z, scalars, B, precision=cfg.fused_precision,
            rs=F.coeff_rows_scale())
        it += K
    return state._replace(s=s, av=av, z=z, sweep=sweep, it=it)


def proshi_run(F, g, state, cfg: ProshiCfg, steps: int, blocks=None,
               idx=None):
    """Advance ``steps`` steps. An explicit schedule replaces the draws
    (the sweep advances as it would): ``blocks`` the (steps,) block ids
    of a block sweep, ``idx`` the (steps, batch) rows of a RANDOM sweep
    without block sampling. A run whose kernel gate is open takes the
    multistep driver; the others copy the table once and step."""
    dev = state.z.device
    if blocks is not None:
        blocks = _schedule(blocks, steps, dev, "blocks")
    if idx is not None:
        idx = _schedule(idx, steps, dev, "idx")
    if cfg.fused:
        return _proshi_run_fused(F, g, state, cfg, steps, blocks)
    state = state._replace(s=state.s.clone())
    for t in range(steps):
        state = _proshi_step(
            F, g, cfg, state, block=None if blocks is None else blocks[t],
            idx=None if idx is None else idx[t], inplace=True)
    return state


def proshi_step(F, g, state, cfg: ProshiCfg):
    """One step; the state passed in stays valid."""
    return _proshi_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class Proshi:
    """ProShI facade (reference ``ProShI.jl:18-40``): γ (scalar or
    per-index), ``sweeping`` (1 random / 2 cyclic / 3 shuffled),
    ``minibatch=(flag, size)``, ``maxit``, ``verbose``, ``freq``, ``α``;
    ``block_sampling`` draws contiguous random blocks under the random
    sweep (the form the kernel serves); ``seed`` seeds the port's draws;
    ``device`` is where the run happens (default: x0's device for a
    tensor x0, else the card when there is one)."""

    gamma: Optional[object] = None
    sweeping: int = 1
    minibatch: Tuple[bool, int] = (False, 1)
    maxit: int = 10000
    verbose: bool = False
    freq: int = 10000
    alpha: float = 0.999
    fused_precision: str = "highest"
    block_sampling: bool = False
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.gamma is not None and not float(
                np.min(np.asarray(torch.as_tensor(self.gamma).cpu()))) > 0:
            raise ValueError("γ must be positive")
        if self.maxit < 1 or self.freq < 1 or self.minibatch[1] < 1:
            raise ValueError("maxit, freq and the minibatch size must be at "
                             "least 1")
        if self.sweeping not in (1, 2, 3):
            raise ValueError(f"sweeping must be 1, 2 or 3, not "
                             f"{self.sweeping}")
        if self.block_sampling and self.sweeping != Sweep.RANDOM:
            raise ValueError("block_sampling only modifies random sweeping")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops.fused_block import proshi_multistep_available

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        B = self.minibatch[1]
        gamma = resolve_gamma_array(self.gamma, L, N, self.alpha,
                                    real_dtype_of(x0), device, who="ProShI")
        if self.block_sampling and N % B != 0:
            raise ValueError(
                "ProShI block_sampling needs N divisible by the batch")
        # the kernel: a contiguous schedule (the random sweep through
        # block sampling), f32 iterates, a dense rank-1 row oracle and an
        # in-kernel coupling prox. JAX's d >= 64 rule for random blocks
        # sizes its TPU clamp and has no counterpart here.
        sweep_ok = self.sweeping != Sweep.RANDOM or self.block_sampling
        fused = sweep_ok and proshi_multistep_available(F, g, x0, B)
        if (not fused and B > 1 and x0.device.type == "cuda"
                and not x0.dtype.is_complex):
            if self.sweeping == Sweep.RANDOM and not self.block_sampling:
                runtime.warn_fused_fallback(
                    "Proshi", "the RANDOM sweep only fuses through the "
                    "contiguous-block stream",
                    "set block_sampling=True, or use cyclic/shuffled "
                    "sweeping")
            else:
                runtime.warn_fused_fallback(
                    "Proshi", "the fused sharing kernel needs f32 iterates, "
                    "a dense rank-1 row oracle and an IndBox/NormL1/Zero "
                    "coupling prox",
                    "align the config to those gates or accept the "
                    "stepwise path")
        cfg = ProshiCfg(N=N, batch=B, sweeping=self.sweeping,
                        alpha=float(self.alpha), fused=fused,
                        fused_precision=self.fused_precision,
                        block_sampling=self.block_sampling)
        seed = self.seed
        return x0, F, g, cfg, lambda: proshi_init(F, g, x0, gamma, seed, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return proshi_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.hat_gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        # the table is storage-consistent (av sums the stored rows): no
        # rebase
        return SolverIterable(x0_orig, init,
                              lambda s: proshi_step(F, g, s, cfg),
                              rebase_fn=lambda s: s)
