"""L-SVRG and L-Katyusha — loopless variance reduction (beyond the
reference).

Counterpart of ``ciao_tpu/solvers/lsvrg.py`` (Kovalev, Horváth,
Richtárik, "Don't Jump Through Hoops and Remove Those Loops: SVRG and
Katyusha are Better Without the Outer Loop", ALT 2020; proximal forms).
Every step is the same variance-reduced prox step, and the anchor jumps
to the step's pre-update iterate with probability p (a Bernoulli coin):

    L-SVRG      w⁺ = prox_{γg}(w − γ[∇f_i(w) − ∇f_i(z) + μ]),  μ = ∇f(z)
                z⁺ = w with probability p (μ⁺ = ∇f(w)), else z
    L-Katyusha  x = θ₁z + θ₂w + (1−θ₁−θ₂)y
                ∇̃ = μ + (1/B)Σ[∇f_i(x) − ∇f_i(w)]
                z⁺ = prox_{τg}((z + ησ̂x − (η/L)∇̃)/(1+ησ̂))
                y⁺ = x + θ₁(z⁺ − z)
                w⁺ = y with probability p (μ⁺ = ∇f(y)), else w

Draws are pure functions of (seed, it): step ``it``'s block start is the
SAGA stream (``saga.block_starts``), its iid minibatch a generator
seeded by (seed, it), and its coin :func:`draw_coins`, the port's counter
hash under a tag of its own (JAX's ``COIN_TAG``). The coins are drawn on
the host, where the fused drivers need them, so a run reads nothing
back from the card. ``lsvrg_run`` and ``lkatyusha_run`` take explicit
``starts``, ``idx`` and ``coins`` in place of the draws (the parity
tests pass JAX's).

With block sampling, coefficient rows and a CUDA device, a run of any
length takes the coin-aware fused driver: the run's block starts are
drawn on the device in one pass, and the steps go to
``ops.lsvrg_coeff_multistep`` / ``ops.lkatyusha_coeff_multistep`` in
windows of at most ``LOOPLESS_LAUNCH`` steps, each ending at its first
coin flip; the anchor refresh (one ``ops.coeff_apply_all`` pass at the
flip step's pre-update iterate) runs between windows.

Complex iterates (complex64, complex128) take the stepwise path, as in
the JAX package (the kernels' gates take f32 iterates alone); γ, the
coins and the momentum weights stay real. The data-parallel variants are
``parallel.DPLSVRG``/``DPLKatyusha``, the tensor-parallel ones
``parallel.TPLSVRG``/``TPLKatyusha``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ciao_tpu_torch.sampling import _M32, _mix32, _seed_key
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    default_terms,
    facade_device,
    rdiv,
    real_dtype_of,
    run_solver_loop,
)
from ciao_tpu_torch.solvers.saga import _check_starts, _uniforms, block_starts
from ciao_tpu_torch.solvers.svrg import fused_inner_gate

# tag of the coin stream, apart from the block and index streams of the
# same (seed, it): JAX's COIN_TAG
COIN_TAG = 0x1005E
# steps per launch of the coin-aware drivers: JAX's _LOOPLESS_LAUNCH
LOOPLESS_LAUNCH = 32


def draw_coins(seed: int, it0: int, k: int, p: float):
    """The Bernoulli(p) anchor-refresh coins of steps it0..it0+k-1, a
    (k,) bool numpy array: the f32 uniforms of the port's counter hash
    under (seed, COIN_TAG), compared with p in f32."""
    its = torch.arange(it0, it0 + k, dtype=torch.int64)
    u = _uniforms(seed ^ (COIN_TAG << 32), its, torch.float32)
    return (u < torch.tensor(p, dtype=torch.float32)).numpy()


def _step_rows(seed: int, it: int, N: int, B: int, device):
    """The B iid rows (with replacement) of step ``it``, from a generator
    seeded by (seed, it). (B,) int64."""
    gen = torch.Generator(device=device)
    gen.manual_seed((_seed_key(seed) << 32) | _mix32((it & _M32) ^ 0xC2B2AE35))
    return torch.randint(N, (B,), generator=gen, device=device)


def _anchor(F, x, cfg):
    """(canch, av) at the anchor point x: the mean gradient, and in fused
    mode the (N,) anchor coefficients it was formed from (else None), as
    the JAX package's ``_coeff_anchor``."""
    if cfg.fused:
        c = F.coeff_all(x)
        return c, F.apply_all(c) / cfg.N
    return None, F.grad_sum_all(x) / cfg.N


def _fused_anchor(F, x, N: int, precision: str):
    """(canch, av) in one pass of ``ops.coeff_apply_all``."""
    from ciao_tpu_torch.ops.fused_block import oracle_apply_all

    c, gsum = oracle_apply_all(F, x, precision)
    return c, gsum / N


def _windows(flips, steps: int, K: int):
    """The (start, end, flip) launch windows of a run of ``steps`` steps
    whose coins land at the sorted positions ``flips``: at most K steps
    each, each ending at its first flip (inclusive)."""
    out, pos, fi = [], 0, 0
    while pos < steps:
        end = min(pos + K, steps)
        while fi < len(flips) and flips[fi] < pos:
            fi += 1
        flip = fi < len(flips) and flips[fi] < end
        if flip:
            end = flips[fi] + 1
        out.append((pos, end, flip))
        pos = end
    return out


def _run_schedule(seed, it0, steps, cfg, p, device, starts, coins_):
    """A run's (block starts on ``device``, host coin flags)."""
    if starts is None:
        starts = block_starts(seed, it0, steps, cfg.N // cfg.batch,
                              cfg.batch, device)
    else:
        starts = _check_starts(starts, steps, cfg, device)
    flags = (draw_coins(seed, it0, steps, p) if coins_ is None
             else _check_coins(coins_, steps))
    return starts, flags


def _check_coins(coins_, steps: int):
    """Explicit coins as a (steps,) bool numpy array."""
    c = np.asarray(coins_, dtype=bool)
    if c.shape != (steps,):
        raise ValueError(f"coins has shape {c.shape}, expected ({steps},)")
    return c


# ---------------------------------------------------------------------------
# L-SVRG
# ---------------------------------------------------------------------------

class LSVRGCfg(NamedTuple):
    N: int
    batch: int = 1
    block: bool = False  # uniform contiguous block per step (the kernel path)
    fused: bool = False  # steps on kernel #16, anchors on kernel #6
    fused_precision: str = "highest"  # dots in the kernels: exact f32 / bf16


class LSVRGState(NamedTuple):
    gamma: torch.Tensor    # scalar stepsize
    p: float               # refresh probability (compared in f32)
    av: torch.Tensor       # (n,) full-gradient anchor μ = ∇f(z)
    z: torch.Tensor        # (n,) anchor point
    w: torch.Tensor        # (n,) iterate
    seed: int              # draws are a function of (seed, it)
    it: int
    status: int
    # fused mode only: the (N,) anchor coefficients c(z), refreshed with
    # av on every coin flip; None otherwise
    canch: Optional[torch.Tensor] = None

    @property
    def solution(self):  # the current iterate: there is no outer average
        return self.w


def lsvrg_init(F, g, x0, gamma, p: float, seed: int,
               cfg: LSVRGCfg) -> LSVRGState:
    """The anchor at x0 (one full pass); w = z = x0, so the init state's
    solution is x0."""
    del g
    canch, av = _anchor(F, x0, cfg)
    gamma = torch.as_tensor(gamma, dtype=real_dtype_of(x0), device=x0.device)
    return LSVRGState(gamma=gamma, p=float(p), av=av, z=x0, w=x0,
                      seed=int(seed), it=1, status=int(Status.RUNNING),
                      canch=canch)


def _lsvrg_step(F, g, cfg: LSVRGCfg, state: LSVRGState, start=None,
                idx=None, flip=None) -> LSVRGState:
    """One loopless step: the variance-reduced prox update, then the
    coin. Paper order (Kovalev et al., Alg. 2): the anchor jumps to the
    pre-update iterate w, whose component gradients this step just
    read. ``start``/``idx``/``flip`` replace the step's own draws."""
    N, B, dev = cfg.N, cfg.batch, state.w.device
    gamma, w = state.gamma, state.w
    if cfg.block:
        if start is None:
            start = block_starts(state.seed, state.it, 1, N // B, B, dev)[0]
        d = F.grad_sum_diff_block(state.z, w, start, B)
    else:
        if idx is None:
            idx = _step_rows(state.seed, state.it, N, B, dev)
        d = F.grad_sum_diff(state.z, w, idx)
    # d = Σ_B (∇f_i(z) − ∇f_i(w)): w + γ(d/B − μ) is the descent step
    w_new = g.prox_only(w + gamma * (d / B - state.av), gamma)
    if flip is None:
        flip = bool(draw_coins(state.seed, state.it, 1, state.p)[0])
    z, av, canch = state.z, state.av, state.canch
    if flip:
        # in fused mode the anchor coefficients stay in step with av, so
        # that an iterator step can sit between kernel runs
        z = w
        canch, av = _anchor(F, w, cfg)
    return state._replace(av=av, z=z, w=w_new, it=state.it + 1, canch=canch)


def _lsvrg_run_fused(F, g, state: LSVRGState, cfg: LSVRGCfg, steps: int,
                     starts=None, coins_=None) -> LSVRGState:
    """The coin-aware fused driver: the run's block starts drawn on the
    device in one pass and its coins on the host, then windows of at
    most ``LOOPLESS_LAUNCH`` steps on kernel #16, each ending at its first
    flip; a flip refreshes the anchor (kernel #6) at the flip step's
    pre-update iterate between windows. The stepwise trajectory on the
    same draws."""
    from ciao_tpu_torch.ops.fused_block import (
        lsvrg_coeff_multistep, oracle_scalar_consts,
    )

    N, B = cfg.N, cfg.batch
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    starts, flags = _run_schedule(state.seed, state.it, steps, cfg, state.p,
                                  rows.device, starts, coins_)
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    gamma = state.gamma.to(rows.device).float()
    scalars = torch.stack([scale, gamma, gamma * lam.float(),
                           torch.full_like(scale, 1.0 / B), mode, aux])
    w, z, av, canch = state.w.clone(), state.z, state.av, state.canch
    for s0, s1, flip in _windows(np.flatnonzero(flags), steps,
                                 LOOPLESS_LAUNCH):
        w, wpre = lsvrg_coeff_multistep(rows, offs, canch, starts[s0:s1],
                                        None, w, av, scalars, B,
                                        precision=cfg.fused_precision, rs=rs)
        if flip:
            z = wpre
            canch, av = _fused_anchor(F, wpre, N, cfg.fused_precision)
    return state._replace(w=w, z=z, av=av, canch=canch,
                          it=state.it + steps)


def lsvrg_run(F, g, state, cfg: LSVRGCfg, steps: int, starts=None,
              coins=None, idx=None):
    """Advance ``steps`` steps: on the coin-aware fused driver when
    ``cfg.fused`` (any length), else stepwise. ``starts`` (block
    sampling, (steps,)), ``idx`` (iid, (steps, batch)) and ``coins``
    ((steps,) booleans) optionally replace the (seed, it) draws."""
    return _run(_lsvrg_step, _lsvrg_run_fused, F, g, state, cfg, steps,
                starts, coins, idx, state.w.device)


def _run(step, run_fused, F, g, state, cfg, steps: int, starts, coins, idx,
         dev):
    """``steps`` steps of ``run_fused`` when ``cfg.fused``, else of
    ``step`` one at a time, on the given draws where there are any."""
    if cfg.fused:
        if idx is not None:
            raise ValueError("the fused driver takes block starts, not idx")
        return run_fused(F, g, state, cfg, steps, starts, coins)
    if starts is not None:
        starts = _check_starts(starts, steps, cfg, dev)
    flags = None if coins is None else _check_coins(coins, steps)
    for t in range(steps):
        state = step(
            F, g, cfg, state, None if starts is None else starts[t],
            None if idx is None else torch.as_tensor(idx[t]).to(dev).long(),
            None if flags is None else bool(flags[t]))
    return state


def lsvrg_step(F, g, state, cfg: LSVRGCfg):
    return _lsvrg_step(F, g, cfg, state)


def lsvrg_rebase(F, g, state, cfg: LSVRGCfg):
    """The anchor gradient recomputed at the current anchor point, after
    a swap of the oracle's row storage (the carried μ keeps the old
    operator's gradient until the next coin lands, which at small p is
    far away); in fused mode the anchor coefficients too."""
    del g
    canch, av = _anchor(F, state.z, cfg)
    return state._replace(av=av, canch=canch)


def _probability(p, batch: int, N: int) -> float:
    return batch / N if p is None else float(p)


@dataclasses.dataclass(frozen=True)
class LSVRG:
    """Loopless-SVRG facade (beyond the reference).

    ``p`` — anchor refresh probability per step; defaults to batch/N.
    ``gamma`` defaults to 1/(6·L_max). ``maxit`` counts steps (one block
    read each), not epochs. ``device`` is where the run happens
    (default: x0's device for a tensor x0, else the card when there is
    one)."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    batch: int = 1
    block_sampling: bool = False  # contiguous blocks (the kernel path)
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
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
        if self.p is not None and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], not {self.p}")

    def _setup(self, x0, F, g, L, N):
        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        else:
            if L is None:
                raise ValueError("LSVRG: provide L or γ")
            gamma = rdiv(1.0, 6.0 * torch.as_tensor(L, dtype=rdt).max()).to(
                device)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("LSVRG block_sampling needs N divisible by batch")
        fused = fused_inner_gate("LSVRG", self.block_sampling, self.batch, F,
                                 g, x0)
        cfg = LSVRGCfg(N=N, batch=self.batch, block=self.block_sampling,
                       fused=fused, fused_precision=self.fused_precision)
        p = _probability(self.p, self.batch, N)
        return x0, F, g, cfg, lambda: lsvrg_init(F, g, x0, gamma, p,
                                                 self.seed, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return lsvrg_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        return SolverIterable(x0_orig, init,
                              lambda s: lsvrg_step(F, g, s, cfg),
                              rebase_fn=lambda s: lsvrg_rebase(F, g, s, cfg))


# ---------------------------------------------------------------------------
# L-Katyusha
# ---------------------------------------------------------------------------

class LKatyushaCfg(NamedTuple):
    N: int
    batch: int = 1
    block: bool = False
    fused: bool = False  # steps on kernel #17, anchors on kernel #6
    fused_precision: str = "highest"  # dots in the kernels: exact f32 / bf16


class LKatyushaState(NamedTuple):
    Lmax: torch.Tensor      # scalar smoothness bound
    sigma: torch.Tensor     # scalar σ̂ = μ/L_max (0: the plain mirror step)
    theta1: torch.Tensor    # scalar momentum weight
    theta2: torch.Tensor    # scalar anchor weight
    p: float                # refresh probability (compared in f32)
    av: torch.Tensor        # (n,) full-gradient anchor μ = ∇f(w_anchor)
    w_anchor: torch.Tensor  # (n,) anchor point
    y: torch.Tensor         # (n,) gradient-step sequence
    z: torch.Tensor         # (n,) mirror-step sequence
    seed: int
    it: int
    status: int
    # fused mode only: the (N,) anchor coefficients c(w_anchor), refreshed
    # with av on every coin flip; None otherwise
    canch: Optional[torch.Tensor] = None

    @property
    def solution(self):  # the y sequence carries the O(√κ) guarantee
        return self.y


def lkatyusha_init(F, g, x0, Lmax, sigma, theta1, theta2, p: float,
                   seed: int, cfg: LKatyushaCfg) -> LKatyushaState:
    """The anchor at x0; y = z = w = x0, so the init state's solution is
    x0."""
    del g
    canch, av = _anchor(F, x0, cfg)
    rdt, dev = real_dtype_of(x0), x0.device
    as_t = lambda v: torch.as_tensor(v, dtype=rdt, device=dev)  # noqa: E731
    return LKatyushaState(
        Lmax=as_t(Lmax), sigma=as_t(sigma), theta1=as_t(theta1),
        theta2=as_t(theta2), p=float(p), av=av, w_anchor=x0, y=x0, z=x0,
        seed=int(seed), it=1, status=int(Status.RUNNING), canch=canch)


def _lkatyusha_consts(state: LKatyushaState):
    """(η, η/L, 1 + ησ̂, τ) with η = θ₂/((1+θ₂)θ₁) and τ = (η/L)/(1+ησ̂)."""
    th1, th2 = state.theta1, state.theta2
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / state.Lmax
    denom = 1.0 + eta * state.sigma
    return eta, step, denom, step / denom


def _lkatyusha_step(F, g, cfg: LKatyushaCfg, state: LKatyushaState,
                    start=None, idx=None, flip=None) -> LKatyushaState:
    """One loopless accelerated step (Kovalev et al., Alg. 3, proximal
    z-step); at σ̂ = 0 the z-step is the plain mirror step. The anchor
    jumps to the pre-update y (the paper's order)."""
    N, B, dev = cfg.N, cfg.batch, state.y.device
    th1, th2 = state.theta1, state.theta2
    eta, step, denom, tau = _lkatyusha_consts(state)
    w = state.w_anchor
    x = th1 * state.z + th2 * w + (1.0 - th1 - th2) * state.y
    if cfg.block:
        if start is None:
            start = block_starts(state.seed, state.it, 1, N // B, B, dev)[0]
        d = F.grad_sum_diff_block(x, w, start, B)
    else:
        if idx is None:
            idx = _step_rows(state.seed, state.it, N, B, dev)
        d = F.grad_sum_diff(x, w, idx)
    gr = state.av + d / B
    z_new = g.prox_only((state.z + (eta * state.sigma) * x - step * gr)
                        / denom, tau)
    y_new = x + th1 * (z_new - state.z)
    if flip is None:
        flip = bool(draw_coins(state.seed, state.it, 1, state.p)[0])
    w_new, av, canch = w, state.av, state.canch
    if flip:
        w_new = state.y
        canch, av = _anchor(F, state.y, cfg)
    return state._replace(av=av, w_anchor=w_new, y=y_new, z=z_new,
                          it=state.it + 1, canch=canch)


def _lkatyusha_run_fused(F, g, state: LKatyushaState, cfg: LKatyushaCfg,
                         steps: int, starts=None,
                         coins_=None) -> LKatyushaState:
    """The coin-aware fused driver of :func:`_lsvrg_run_fused` on kernel
    #17: each window carries y and z against the constant anchor point;
    a flip moves the anchor to the flip step's pre-update y."""
    from ciao_tpu_torch.ops.fused_block import (
        lkatyusha_coeff_multistep, oracle_scalar_consts,
    )

    N, B = cfg.N, cfg.batch
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    starts, flags = _run_schedule(state.seed, state.it, steps, cfg, state.p,
                                  rows.device, starts, coins_)
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    eta, step, denom, tau = _lkatyusha_consts(state)
    f32 = lambda t: t.to(device=rows.device, dtype=torch.float32)  # noqa: E731
    scalars = torch.stack([scale, f32(step), f32(tau * lam.to(tau.dtype)),
                           f32(rdiv(1.0, denom)), f32(eta * state.sigma),
                           f32(state.theta1), f32(state.theta2),
                           torch.full_like(scale, 1.0 / B), mode, aux])
    y, z = state.y.clone(), state.z.clone()
    wa, av, canch = state.w_anchor, state.av, state.canch
    for s0, s1, flip in _windows(np.flatnonzero(flags), steps,
                                 LOOPLESS_LAUNCH):
        y, z, ypre = lkatyusha_coeff_multistep(
            rows, offs, canch, starts[s0:s1], None, wa, y, z, av, scalars, B,
            precision=cfg.fused_precision, rs=rs)
        if flip:
            wa = ypre
            canch, av = _fused_anchor(F, ypre, N, cfg.fused_precision)
    return state._replace(y=y, z=z, w_anchor=wa, av=av, canch=canch,
                          it=state.it + steps)


def lkatyusha_run(F, g, state, cfg: LKatyushaCfg, steps: int, starts=None,
                  coins=None, idx=None):
    """Advance ``steps`` steps: on the coin-aware fused driver when
    ``cfg.fused`` (any length), else stepwise; ``starts``, ``idx`` and
    ``coins`` as in :func:`lsvrg_run`."""
    return _run(_lkatyusha_step, _lkatyusha_run_fused, F, g, state, cfg,
                steps, starts, coins, idx, state.y.device)


def lkatyusha_step(F, g, state, cfg: LKatyushaCfg):
    return _lkatyusha_step(F, g, cfg, state)


def lkatyusha_rebase(F, g, state, cfg: LKatyushaCfg):
    """The anchor gradient recomputed at the current anchor point (cf.
    :func:`lsvrg_rebase`)."""
    del g
    canch, av = _anchor(F, state.w_anchor, cfg)
    return state._replace(av=av, canch=canch)


@dataclasses.dataclass(frozen=True)
class LKatyusha:
    """Loopless-Katyusha facade (beyond the reference): accelerated
    loopless variance reduction with a proximal z-step.

    ``sigma`` — strong-convexity-to-smoothness ratio σ̂ = μ/L_max; sets
    θ₁ = min(√(2σ̂N/(3·batch)), 1/2). Omitted: σ̂ = 0 (the plain mirror
    z-step) with θ₁ = 1/3 unless given. ``p`` defaults to batch/N.
    ``maxit`` counts steps. ``device`` is where the run happens (default:
    x0's device for a tensor x0, else the card when there is one)."""

    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    p: Optional[float] = None
    batch: int = 1
    theta1: Optional[float] = None
    theta2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.maxit < 1 or self.freq < 1 or self.batch < 1:
            raise ValueError("maxit, freq and batch must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")
        if not 0.0 < self.theta2 < 1.0:
            raise ValueError(f"theta2 must lie in (0, 1), not {self.theta2}")
        if self.p is not None and not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must lie in [0, 1], not {self.p}")
        if (self.theta1 is not None
                and not 0.0 < self.theta1 <= 1.0 - self.theta2):
            raise ValueError(f"theta1 must lie in (0, 1 - theta2], not "
                             f"{self.theta1}")

    def _setup(self, x0, F, g, L, N):
        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        if L is None:
            raise ValueError("LKatyusha: provide the smoothness moduli L")
        rdt = real_dtype_of(x0)
        Lmax = torch.as_tensor(L, dtype=rdt).max().to(device)
        sigma = torch.as_tensor(0.0 if self.sigma is None else self.sigma,
                                dtype=rdt, device=device)
        if self.theta1 is not None:
            theta1 = torch.as_tensor(self.theta1, dtype=rdt, device=device)
        elif self.sigma is not None:
            theta1 = torch.clamp(
                torch.sqrt(2.0 * sigma * N / (3.0 * self.batch)), max=0.5)
        else:
            theta1 = torch.as_tensor(1.0 / 3.0, dtype=rdt, device=device)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError(
                "LKatyusha block_sampling needs N divisible by batch")
        fused = fused_inner_gate("LKatyusha", self.block_sampling,
                                 self.batch, F, g, x0)
        cfg = LKatyushaCfg(N=N, batch=self.batch, block=self.block_sampling,
                           fused=fused, fused_precision=self.fused_precision)
        p = _probability(self.p, self.batch, N)
        return x0, F, g, cfg, lambda: lkatyusha_init(
            F, g, x0, Lmax, sigma, theta1, self.theta2, p, self.seed, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return lkatyusha_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.theta1):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        return SolverIterable(
            x0_orig, init, lambda s: lkatyusha_step(F, g, s, cfg),
            rebase_fn=lambda s: lkatyusha_rebase(F, g, s, cfg))
