"""Katyusha — accelerated variance reduction (beyond the reference).

Counterpart of ``ciao_tpu/solvers/katyusha.py`` (Allen-Zhu, "Katyusha:
The First Direct Acceleration of Stochastic Gradient Methods", JMLR
2018, Option II, minibatch mean over a block B). Per inner step:

    x   = τ₁ z + τ₂ x̃ + (1 − τ₁ − τ₂) y
    ∇̃  = μ + (1/B) Σ_B [∇f_i(x) − ∇f_i(x̃)]        μ = ∇f(x̃), the anchor
    z⁺  = prox_{αg}(z − α ∇̃)            α = 1/(3 τ₁ L_max)
    y⁺  = prox_{βg}(x − β ∇̃)            β = 1/(3 L_max)

and per outer step x̃ ← the mean of the epoch's y iterates, the anchor
refreshed at x̃ (one full pass). τ₂ = 1/2; τ₁ from the strong-convexity
modulus σ (τ₁ = min(√(m·B·σ/(3 L_max)), 1/2)) or, when σ is unknown,
the non-strongly-convex schedule τ₁ₛ = 2/(s+4) with α re-derived per
epoch (Katyusha^ns).

Inner schedules are a pure function of (seed, outer it, inner k): block
starts from ``svrg.inner_starts``, iid minibatches from
``svrg.inner_indices``, or explicit ``starts`` / ``idx`` handed to
:func:`katyusha_run`, one tensor per outer step (parity tests pass
JAX's). With block sampling, coefficient rows and a CUDA device, every
inner step of an outer step runs on ``ops.katyusha_coeff_multistep``
(``LAUNCH_STEPS`` a call, the last call the remainder) against the
anchor coefficients ``canch``, and the anchor refresh is one pass of
``ops.coeff_apply_all``.

Complex iterates (complex64, complex128) take the stepwise path, as in
the JAX package (the kernels' gates take f32 iterates alone); τ and the
other scalars stay real.
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
from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS, _check_starts
from ciao_tpu_torch.solvers.svrg import (
    _check_idx, fused_inner_gate, inner_indices, inner_starts,
)


class KatyushaCfg(NamedTuple):
    N: int
    batch: int = 1
    m: int = 1           # inner steps per outer iterate
    block: bool = False  # contiguous-block sampling (the kernel path)
    ns: bool = False     # non-strongly-convex τ₁ₛ = 2/(s+4) schedule
    fused: bool = False  # inner steps on kernel #10, anchors on kernel #6
    fused_precision: str = "highest"  # dots in the kernels: exact f32 / bf16


class KatyushaState(NamedTuple):
    Lmax: torch.Tensor     # scalar smoothness bound (drives α, β)
    tau1: torch.Tensor     # scalar momentum weight of the current epoch
    tau2: torch.Tensor     # scalar anchor weight (constant)
    av: torch.Tensor       # (n,) full-gradient anchor μ = ∇f(x̃)
    x_tilde: torch.Tensor  # (n,) outer iterate (the anchor point)
    y: torch.Tensor        # (n,) gradient-step sequence
    z: torch.Tensor        # (n,) mirror-step sequence
    seed: int              # draws are a function of (seed, it, k)
    it: int
    status: int
    # fused mode only: the (N,) anchor coefficients c(x̃), refreshed with
    # av in one pass over the rows; None otherwise
    canch: Optional[torch.Tensor] = None

    @property
    def solution(self):
        return self.x_tilde


def katyusha_init(F, g, x0, Lmax, tau1, tau2, seed: int,
                  cfg: KatyushaCfg) -> KatyushaState:
    """The anchor at x0 (one full pass); y = z = x̃ = x0, so the init
    state's solution is x0, as SVRG's. Fused: c = F.coeff_all(x0) kept
    as ``canch`` and av = F.apply_all(c)/N, as the JAX package does."""
    del g
    rdt, dev = real_dtype_of(x0), x0.device
    canch = None
    if cfg.fused:
        canch = F.coeff_all(x0)
        av = F.apply_all(canch) / cfg.N
    else:
        av = F.grad_sum_all(x0) / cfg.N
    as_t = lambda v: torch.as_tensor(v, dtype=rdt, device=dev)  # noqa: E731
    return KatyushaState(Lmax=as_t(Lmax), tau1=as_t(tau1), tau2=as_t(tau2),
                         av=av, x_tilde=x0, y=x0, z=x0, seed=int(seed), it=1,
                         status=int(Status.RUNNING), canch=canch)


def _katyusha_schedule(cfg: KatyushaCfg, state: KatyushaState):
    """(τ₁, τ₂, α, β) of the current outer step."""
    if cfg.ns:
        # Katyusha^ns: s = it − 1 outer steps done
        s = torch.full_like(state.Lmax, float(state.it - 1))
        tau1 = rdiv(2.0, s + 4.0)
    else:
        tau1 = state.tau1
    alpha = rdiv(1.0, 3.0 * tau1 * state.Lmax)
    beta = rdiv(1.0, 3.0 * state.Lmax)
    return tau1, state.tau2, alpha, beta


def _katyusha_inner(F, g, cfg, state, tau1, tau2, alpha, beta, starts=None,
                    idx=None):
    """The stepwise inner loop on contiguous blocks (``starts``) or iid
    minibatches (``idx``, (m, B)): one read of the rows a step for
    Σ ∇f_i(x) − ∇f_i(x̃)."""
    B, xt = cfg.batch, state.x_tilde
    y, z = state.y, state.z
    ysum = torch.zeros_like(y)
    steps = starts.shape[0] if starts is not None else idx.shape[0]
    for k in range(steps):
        x = tau1 * z + tau2 * xt + (1.0 - tau1 - tau2) * y
        if starts is not None:
            diff = F.grad_sum_diff_block(x, xt, starts[k], B)
        else:
            diff = F.grad_sum_diff(x, xt, idx[k])
        gr = state.av + diff / B
        z = g.prox_only(z - alpha * gr, alpha)
        y = g.prox_only(x - beta * gr, beta)
        ysum = ysum + y
    return y, z, ysum


def _katyusha_inner_fused(F, g, cfg, state, tau1, tau2, alpha, beta, starts):
    """All m inner steps on kernel #10 (``ops.katyusha_inner_chunked``,
    ``LAUNCH_STEPS`` a call) against ``state.canch``; y and z are copied
    once and then updated in place, the sum of y starts at 0."""
    from ciao_tpu_torch.ops.fused_block import (
        katyusha_inner_chunked, oracle_scalar_consts,
    )

    rows, offs = F.coeff_rows_data()
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    f32 = lambda v: v.to(device=rows.device, dtype=torch.float32)  # noqa: E731
    lam = lam.float()
    scalars = torch.stack([scale, f32(alpha), f32(beta), f32(alpha * lam),
                           f32(beta * lam),
                           torch.full_like(scale, 1.0 / cfg.batch), mode,
                           f32(tau1), f32(tau2), aux])
    y, z = state.y.clone(), state.z.clone()
    ysum = torch.zeros_like(y)
    katyusha_inner_chunked(rows, offs, state.canch, state.x_tilde, y, z, ysum,
                           state.av, scalars, cfg.batch, starts, LAUNCH_STEPS,
                           precision=cfg.fused_precision,
                           rs=F.coeff_rows_scale())
    return y, z, ysum


def _katyusha_step(F, g, cfg: KatyushaCfg, state: KatyushaState,
                   starts=None, idx=None) -> KatyushaState:
    """One outer iterate: m momentum-coupled inner steps and the anchor
    refresh at the mean of their y. ``starts`` (block) or ``idx`` (iid)
    replace the outer step's own draws."""
    m, dev = cfg.m, state.y.device
    tau1, tau2, alpha, beta = _katyusha_schedule(cfg, state)
    if cfg.block or cfg.fused:
        if starts is None:
            starts = inner_starts(state.seed, state.it, m, cfg, dev)
        if cfg.fused:
            y, z, ysum = _katyusha_inner_fused(F, g, cfg, state, tau1, tau2,
                                               alpha, beta, starts)
        else:
            y, z, ysum = _katyusha_inner(F, g, cfg, state, tau1, tau2, alpha,
                                         beta, starts=starts)
    else:
        if idx is None:
            idx = inner_indices(state.seed, state.it, m, cfg.N, dev,
                                batch=cfg.batch)
        y, z, ysum = _katyusha_inner(F, g, cfg, state, tau1, tau2, alpha,
                                     beta, idx=idx)
    x_tilde = ysum / m
    canch = None
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import oracle_apply_all

        canch, gsum = oracle_apply_all(F, x_tilde, cfg.fused_precision)
        av = gsum / cfg.N
    else:
        av = F.grad_sum_all(x_tilde) / cfg.N
    return state._replace(
        tau1=tau1.to(state.tau1.dtype) if cfg.ns else state.tau1, av=av,
        x_tilde=x_tilde, y=y, z=z, it=state.it + 1, canch=canch)


def katyusha_run(F, g, state, cfg: KatyushaCfg, steps: int, starts=None,
                 idx=None):
    """Advance ``steps`` outer steps. ``starts`` (block sampling) or
    ``idx`` (iid) optionally give each outer step's inner schedule in
    place of the (seed, it, k) draws: a sequence of ``steps`` tensors of
    shape (m,) or (m, batch)."""
    if starts is not None and idx is not None:
        raise ValueError("give starts (block sampling) or idx (iid), not both")
    dev = state.y.device
    for t in range(steps):
        st = None if starts is None else _check_starts(starts[t], cfg.m, cfg,
                                                       dev)
        ix = None if idx is None else _check_idx(idx[t], cfg.m, cfg.N, dev,
                                                 batch=cfg.batch)
        state = _katyusha_step(F, g, cfg, state, st, ix)
    return state


def katyusha_step(F, g, state, cfg: KatyushaCfg):
    return _katyusha_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class Katyusha:
    """Accelerated variance-reduced solver (beyond the reference).

    ``sigma`` — strong-convexity modulus of f (per-term average); sets
    τ₁ = min(√(m·batch·σ/(3 L_max)), 1/2). Without it the
    non-strongly-convex τ₁ₛ = 2/(s+4) epoch schedule runs. ``m`` counts
    inner batches per outer iterate and defaults to 2N/batch (the paper's
    two-epoch convention). ``maxit`` counts outer iterates. ``device`` is
    where the run happens (default: x0's device for a tensor x0, else the
    card when there is one)."""

    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    batch: int = 1
    tau1: Optional[float] = None
    tau2: float = 0.5
    sigma: Optional[float] = None
    block_sampling: bool = False  # contiguous inner blocks (the kernel path)
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.maxit < 1 or self.freq < 1 or self.batch < 1:
            raise ValueError("maxit, freq and batch must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")
        if not 0.0 < self.tau2 < 1.0:
            raise ValueError(f"tau2 must lie in (0, 1), not {self.tau2}")
        if self.tau1 is not None and not 0.0 < self.tau1 <= 1.0 - self.tau2:
            raise ValueError(f"tau1 must lie in (0, 1 - tau2], not "
                             f"{self.tau1}")

    def _setup(self, x0, F, g, L, N):
        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        if L is None:
            raise ValueError("Katyusha: provide the smoothness moduli L")
        rdt = real_dtype_of(x0)
        Lmax = torch.as_tensor(L, dtype=rdt).max().to(device)
        m = (2 * N) // self.batch if self.m is None else self.m
        if m < 1:
            raise ValueError("Katyusha: m must be >= 1")
        if self.block_sampling and N % self.batch != 0:
            raise ValueError(
                "Katyusha block_sampling needs N divisible by batch")
        ns = False
        if self.tau1 is not None:
            tau1 = torch.as_tensor(self.tau1, dtype=rdt, device=device)
        elif self.sigma is not None:
            sig = torch.as_tensor(self.sigma, dtype=rdt, device=device)
            tau1 = torch.clamp(torch.sqrt(m * self.batch * sig
                                          / (3.0 * Lmax)), max=0.5)
        else:
            ns = True
            tau1 = torch.as_tensor(0.5, dtype=rdt, device=device)
        fused = fused_inner_gate("Katyusha", self.block_sampling, self.batch,
                                 F, g, x0)
        cfg = KatyushaCfg(N=N, batch=self.batch, m=m,
                          block=self.block_sampling, ns=ns, fused=fused,
                          fused_precision=self.fused_precision)
        return x0, F, g, cfg, lambda: katyusha_init(
            F, g, x0, Lmax, tau1, self.tau2, self.seed, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return katyusha_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.tau1):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        # the anchor is recomputed from a full pass every outer step, so a
        # storage switch self-heals: rebase is the identity
        return SolverIterable(x0_orig, init,
                              lambda s: katyusha_step(F, g, s, cfg),
                              rebase_fn=lambda s: s)
