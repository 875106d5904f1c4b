"""Forward-backward splitting (ISTA) and its accelerated variant
(FISTA) — the deterministic full-gradient baselines.

Counterpart of ``ciao_tpu/solvers/fb.py``:

    x⁺ = prox_{γg}(y − γ∇f(y)),        f = (1/N) Σ_i f_i

with y = x (ISTA) or the Nesterov extrapolation
y⁺ = x⁺ + ((t−1)/t⁺)(x⁺ − x), t⁺ = (1+√(1+4t²))/2 (FISTA). On the card
one step is one pass over the rows (``ops.coeff_apply_all``, the same
compensated read as the SVRG anchor) plus an O(n) prox.

Default γ = 1/mean(L): each f_i has modulus L_i, so the full smooth
term (1/N)Σf_i has modulus ≤ mean(L_i).

Complex iterates (complex64, complex128) take the stepwise path, as in
the JAX package: the kernel's gate takes f32 iterates alone.
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
    real_dtype_of,
    run_solver_loop,
)


class FBCfg(NamedTuple):
    N: int
    fast: bool = False   # Nesterov extrapolation (FISTA)
    fused: bool = False  # one-pass full gradient on kernel #6
    fused_precision: str = "highest"  # dots in the kernel: exact f32 / bf16


class FBState(NamedTuple):
    gamma: torch.Tensor  # scalar stepsize
    t: torch.Tensor      # scalar momentum sequence (1.0 when not fast)
    x: torch.Tensor      # (n,) iterate
    y: torch.Tensor      # (n,) extrapolated point (== x when not fast)
    it: int
    status: int

    @property
    def solution(self):
        return self.x


def fb_init(F, g, x0, gamma, cfg: FBCfg) -> FBState:
    """x = y = x0, t = 1 — solution(init) == x0 (init is iteration #1,
    the framework-wide convention)."""
    del F, g, cfg
    rdt = real_dtype_of(x0)
    return FBState(
        gamma=torch.as_tensor(gamma, dtype=rdt, device=x0.device),
        t=torch.ones((), dtype=rdt, device=x0.device), x=x0, y=x0, it=1,
        status=int(Status.RUNNING))


def full_gradient(F, N: int, y, fused: bool, precision: str = "highest"):
    """∇((1/N)Σf_i)(y): one pass over the rows on kernel #6 when
    ``fused``, else the oracle's two-product ``grad_sum_all``."""
    if fused:
        from ciao_tpu_torch.ops.fused_block import oracle_apply_all

        return oracle_apply_all(F, y, precision)[1] / N
    return F.grad_sum_all(y) / N


def _fb_step(F, g, cfg: FBCfg, state: FBState) -> FBState:
    gamma = state.gamma
    grad = full_gradient(F, cfg.N, state.y, cfg.fused, cfg.fused_precision)
    x_new = g.prox_only(state.y - gamma * grad, gamma)
    if cfg.fast:
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * state.t * state.t))
        y_new = x_new + ((state.t - 1.0) / t_new) * (x_new - state.x)
    else:
        t_new, y_new = state.t, x_new
    return state._replace(t=t_new, x=x_new, y=y_new, it=state.it + 1)


def fb_run(F, g, state, cfg: FBCfg, steps: int):
    for _ in range(steps):
        state = _fb_step(F, g, cfg, state)
    return state


def fb_step(F, g, state, cfg: FBCfg):
    return _fb_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class ForwardBackward:
    """Proximal-gradient facade (deterministic baseline). ``fast=True``
    is FISTA; ``maxit`` counts full-gradient steps. ``device`` is where
    the run happens (default: x0's device for a tensor x0, else the card
    when there is one)."""

    gamma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    fast: bool = False
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    device: Optional[str] = None

    def __post_init__(self):
        if self.gamma is not None and not self.gamma > 0:
            raise ValueError(f"gamma must be positive, not {self.gamma}")
        if self.maxit < 1 or self.freq < 1:
            raise ValueError("maxit and freq must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops.fused_block import full_grad_available

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        elif L is None:
            raise ValueError("ForwardBackward: provide the smoothness moduli "
                             "L, or a stepsize γ")
        else:
            gamma = 1.0 / torch.mean(torch.as_tensor(L, dtype=rdt,
                                                     device=device))
        cfg = FBCfg(N=N, fast=self.fast, fused=full_grad_available(F, x0),
                    fused_precision=self.fused_precision)
        return x0, F, g, cfg, lambda: fb_init(F, g, x0, gamma, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return fb_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        # stateless in the oracle: every step recomputes the full
        # gradient, so a storage switch self-heals (rebase identity)
        return SolverIterable(x0_orig, init, lambda s: fb_step(F, g, s, cfg),
                              rebase_fn=lambda s: s)


def FISTA(**kwargs) -> ForwardBackward:
    """Accelerated forward-backward (``ForwardBackward(fast=True)``) —
    the FastForwardBackward of ProximalAlgorithms.jl."""
    return ForwardBackward(fast=True, **kwargs)
