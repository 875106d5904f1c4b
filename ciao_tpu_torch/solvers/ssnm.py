"""SSNM — SAGA with sampled negative momentum (beyond the reference).

Counterpart of ``ciao_tpu/solvers/ssnm.py`` (Zhou, Shang and Cheng,
"Direct Acceleration of SAGA using Sampled Negative Momentum", AISTATS
2019). Per step, on a uniformly drawn contiguous block j:

    y   = τ·x + (1 − τ)·φ_j                 (φ_j the block's stored point)
    ∇̃  = ∇f_j(y) − ∇f_j(φ_j) + ḡ           ḡ = (1/N) Σ_i ∇f_i(φ_i)
    x⁺  = prox_{ηg}(x − η·∇̃)               η = 1/(3·τ·L_max)
    φ_j ← y

For rank-1 rows the stored gradients are the (N,) coefficient table, so
∇f_j(y) − ∇f_j(φ_j) is SAGA's innovation Σ (c_i(y) − c_i)·a_i, and the
stored points are one (n,) row per block of the (d, n) table ``zb``, as
Finito's anchors. At τ = 1 the step is minibatch SAGA's. τ defaults to
½, or min(½, √(N·σ/(3·L_max))) when σ is given.

Block schedules are a pure function of (seed, it)
(``saga.block_starts``), or explicit ``starts`` handed to
:func:`ssnm_run` (parity tests pass JAX's). With coefficient rows, an
in-kernel prox (``NormL1``/``Zero``) and a CUDA device, :func:`ssnm_run`
hands the steps to ``ops.ssnm_multistep`` (within the JAX package's
resident bounds, ``finito._resident``) or ``ops.ssnm_multistep_streamed``
(beyond them), ``LAUNCH_STEPS`` a call and the last call the remainder:
unlike JAX's drivers, no step runs stepwise after the launches.

Complex iterates (complex64, complex128) take the stepwise path (the
kernels' gates take f32 iterates alone); the JAX package has no complex
test of SSNM, and its facade converges on complex128 rows as the port's
does. The data-parallel variant is ``parallel.DPSSNM``, the
tensor-parallel one ``parallel.TPSSNM``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    default_terms,
    facade_device,
    rdiv,
    real_dtype_of,
    run_solver_loop,
)
from ciao_tpu_torch.solvers.saga import (
    LAUNCH_STEPS, _check_starts, _warn_fallback, block_starts,
)


class SSNMCfg(NamedTuple):
    N: int
    batch: int = 1
    fused: bool = False  # K steps a call of kernel #19
    fused_precision: str = "highest"  # dots in the kernel: exact f32 / bf16
    fused_stream: bool = False  # K steps a call of kernel #13
    block = True  # SSNM draws contiguous blocks only (not a field)


class SSNMState(NamedTuple):
    tau: torch.Tensor    # scalar momentum weight
    eta: torch.Tensor    # scalar stepsize
    c: torch.Tensor      # (N,) coefficient table c_i = c(φ_i)
    zb: torch.Tensor     # (d, n) per-block stored points φ
    gbar: torch.Tensor   # (n,) table mean ḡ = (1/N) Σ c_i·a_i
    x: torch.Tensor      # (n,) iterate
    seed: int            # draws are a function of (seed, it)
    it: int
    status: int

    @property
    def solution(self):
        return self.x


def ssnm_init(F, g, x0, tau, eta, seed: int, cfg: SSNMCfg) -> SSNMState:
    """Table bootstrap φ_i = x0 (SAGA's convention): the coefficients at
    x0, ḡ their mean row gradient, every block's stored point x0 (a (d, n)
    table the state owns); x = x0, so the init state's solution is x0."""
    del g
    rdt, dev = real_dtype_of(x0), x0.device
    c = F.coeff_all(x0)
    gbar = F.apply_all(c) / cfg.N
    zb = x0.expand(cfg.N // cfg.batch, x0.shape[0]).clone()
    as_t = lambda v: torch.as_tensor(v, dtype=rdt, device=dev)  # noqa: E731
    return SSNMState(tau=as_t(tau), eta=as_t(eta), c=c, zb=zb, gbar=gbar,
                     x=x0, seed=int(seed), it=1, status=int(Status.RUNNING))


def _ssnm_step(F, g, cfg: SSNMCfg, state: SSNMState, start=None,
               inplace=False) -> SSNMState:
    """One SSNM step on a contiguous block: the (seed, it) draw or the
    explicit ``start``. The tables are replaced, not written in place,
    unless the caller owns them (``inplace``)."""
    N, B = cfg.N, cfg.batch
    dev = state.x.device
    if start is None:
        start = block_starts(state.seed, state.it, 1, N // B, B, dev)[0]
    start_t = torch.as_tensor(start, device=dev).long()
    j = (start_t // B).view(1)
    idx = start_t + torch.arange(B, device=dev)
    phi = state.zb.index_select(0, j)[0]
    y = state.tau * state.x + (1.0 - state.tau) * phi   # sampled momentum
    c_new = F.coeff_block(y, start, B)
    innov = F.apply_rows_block(c_new - state.c[idx], start, B)
    # minibatch SAGA's direction (the same expression, so τ = 1 is SAGA's
    # step bit for bit), taken from x: the mirror step
    x = g.prox_only(state.x - state.eta * (innov * (1.0 / B) + state.gbar),
                    state.eta)
    gbar = state.gbar + innov / N
    if inplace:
        c = state.c.index_copy_(0, idx, c_new)
        zb = state.zb.index_copy_(0, j, y[None])
    else:
        c = state.c.index_copy(0, idx, c_new)
        zb = state.zb.index_copy(0, j, y[None])
    return state._replace(c=c, zb=zb, gbar=gbar, x=x, it=state.it + 1)


def _ssnm_run_fused(F, g, state: SSNMState, cfg: SSNMCfg, steps: int,
                    starts=None) -> SSNMState:
    """Multistep driver, the counterpart of both JAX drivers
    (``_ssnm_run_fused`` and ``_ssnm_run_fused_streamed``):
    ``LAUNCH_STEPS`` steps a call of ``ops.ssnm_multistep_streamed`` when
    ``cfg.fused_stream``, else of ``ops.ssnm_multistep``, the last call
    the remainder, on the explicit ``starts`` or the (seed, it) draws. c,
    zb, x and ḡ are copied once and then updated in place.

    No clamp and no stepwise remainder: JAX's streamed driver stops each
    launch at its first same-launch revisit (its TPU kernel streams c
    through aliased windows) and both JAX drivers run ``steps mod K``
    stepwise. Here c and zb live in device memory and each step's
    launches are stream-ordered, so every launch commits all its steps
    (``f`` = None) and the last launch takes the remainder. Both
    packages commit the stepwise stream."""
    from ciao_tpu_torch.ops import fused_block as fb

    N, B = cfg.N, cfg.batch
    kernel = fb.ssnm_multistep_streamed if cfg.fused_stream else \
        fb.ssnm_multistep
    rows, offs = F.coeff_rows_data()
    dev = rows.device
    scale, mode, lam, aux = fb.oracle_scalar_consts(F, g)
    eta = state.eta.to(dev).float()
    scalars = torch.stack([scale, eta, eta * lam.float(),
                           torch.full_like(scale, 1.0 / B),
                           torch.full_like(scale, 1.0 / N), mode,
                           state.tau.to(dev).float(), aux])
    c, zb, x, gbar = (t.clone() for t in (state.c, state.zb, state.x,
                                          state.gbar))
    for k0 in range(0, steps, LAUNCH_STEPS):
        k = min(LAUNCH_STEPS, steps - k0)
        st = (starts[k0:k0 + k] if starts is not None
              else block_starts(state.seed, state.it + k0, k, N // B, B, dev))
        kernel(rows, offs, st, c, zb, x, gbar, scalars, B,
               precision=cfg.fused_precision, rs=F.coeff_rows_scale())
    return state._replace(c=c, zb=zb, x=x, gbar=gbar, it=state.it + steps)


def ssnm_run(F, g, state: SSNMState, cfg: SSNMCfg, steps: int,
             starts=None) -> SSNMState:
    """Advance ``steps`` steps. ``starts`` optionally gives the (steps,)
    block starts to use instead of the (seed, it) draws. The stepwise
    path copies the tables once and then writes them in place."""
    dev = state.x.device
    if starts is not None:
        starts = _check_starts(starts, steps, cfg, dev)
    if cfg.fused or cfg.fused_stream:
        return _ssnm_run_fused(F, g, state, cfg, steps, starts)
    state = state._replace(c=state.c.clone(), zb=state.zb.clone())
    for i in range(steps):
        state = _ssnm_step(F, g, cfg, state,
                           None if starts is None else starts[i],
                           inplace=True)
    return state


def ssnm_step(F, g, state: SSNMState, cfg: SSNMCfg) -> SSNMState:
    return _ssnm_step(F, g, cfg, state)


def ssnm_rebase(F, g, state: SSNMState, cfg: SSNMCfg) -> SSNMState:
    """Recompute ḡ exactly from the coefficient table under ``F``'s row
    storage: required after a storage swap (cf. ``saga_rebase``)."""
    del g
    return state._replace(gbar=F.apply_all(state.c) / cfg.N)


@dataclasses.dataclass(frozen=True)
class SSNM:
    """SAGA with sampled negative momentum (beyond the reference).

    ``sigma`` — strong-convexity modulus of f (per-term average); sets
    τ = min(½, √(N·σ/(3·L_max))). Without it τ defaults to ½ (pass
    ``tau`` for a problem-specific value; τ = 1 is minibatch SAGA).
    ``eta`` defaults to 1/(3·τ·L_max). ``maxit`` counts steps of
    ``batch`` rows (contiguous blocks: N must divide by batch).
    ``device`` is where the run happens (default: x0's device for a
    tensor x0, else the card when there is one)."""

    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    batch: int = 1
    tau: Optional[float] = None
    sigma: Optional[float] = None
    eta: Optional[float] = None
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.maxit < 1 or self.freq < 1 or self.batch < 1:
            raise ValueError("maxit, freq and batch must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")
        if self.tau is not None and not 0.0 < self.tau <= 1.0:
            raise ValueError(f"tau must lie in (0, 1], not {self.tau}")
        if self.eta is not None and not self.eta > 0:
            raise ValueError(f"eta must be positive, not {self.eta}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops import fused_block as fb
        from ciao_tpu_torch.solvers.finito import _resident

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        if not getattr(F, "supports_coeff", False):
            raise ValueError(
                "SSNM stores the sampled points per BLOCK, which needs a "
                f"rank-1 (coefficient) oracle; {type(F).__name__} is not")
        if N % self.batch != 0:
            raise ValueError("SSNM needs N divisible by batch")
        rdt = real_dtype_of(x0)
        if L is None and (self.eta is None or (self.tau is None
                                               and self.sigma is not None)):
            raise ValueError("SSNM: provide the smoothness moduli L, or η/τ")
        Lmax = (None if L is None
                else torch.as_tensor(L, dtype=rdt).max().to(device))
        if self.tau is not None:
            tau = torch.as_tensor(self.tau, dtype=rdt, device=device)
        elif self.sigma is not None:
            sig = torch.as_tensor(self.sigma, dtype=rdt, device=device)
            tau = torch.clamp(torch.sqrt(N * sig / (3.0 * Lmax)), max=0.5)
        else:
            tau = torch.as_tensor(0.5, dtype=rdt, device=device)
        eta = (torch.as_tensor(self.eta, dtype=rdt, device=device)
               if self.eta is not None
               else rdiv(1.0, 3.0 * tau * Lmax))  # the mirror coupling
        kernel_ok = fb.saga_multistep_available(F, g, x0, self.batch)
        resident = kernel_ok and _resident(N, x0.numel(), self.batch)
        if not kernel_ok:
            _warn_fallback("SSNM", F, g, x0)
        cfg = SSNMCfg(N=N, batch=self.batch, fused=resident,
                      fused_precision=self.fused_precision,
                      fused_stream=kernel_ok and not resident)
        return x0, F, g, cfg, lambda: ssnm_init(F, g, x0, tau, eta, self.seed,
                                                cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return ssnm_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.tau):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        return SolverIterable(
            x0_orig, init, lambda s: ssnm_step(F, g, s, cfg),
            rebase_fn=lambda s: ssnm_rebase(F, g, s, cfg))
