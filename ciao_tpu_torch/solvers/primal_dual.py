"""Condat-Vũ primal-dual splitting, and Chambolle-Pock as its f = 0 case.

Counterpart of ``ciao_tpu/solvers/primal_dual.py``: minimize (1/N) Σ_i
f_i(x) + g(x) + h(Kx) with f smooth, g and h proximable and K a linear
map (``ops.linmap``): total variation (h = λ‖·‖₁, K = FirstDifference),
analysis sparsity (K = DenseMap). Condat (JOTA 2013) / Vũ (ACM 2013);
with f = 0, Chambolle-Pock (JMIV 2011). Primal step τ, dual step σ:

    x⁺ = prox_{τg}(x − τ(∇f(x) + Kᵀy))
    u  = y + σ·K(2x⁺ − x)
    y⁺ = u − σ·prox_{h/σ}(u/σ)          (Moreau: prox_{σh*}(u))

Convergence requires τ·(L_f/2 + σ‖K‖²) ≤ 1. Defaults: σ = 1/‖K‖ and the
largest τ with a 0.99 margin, L_f = mean(L) and ‖K‖ from the map's
``opnorm_bound``. The only O(N) work is the full gradient: on the card
one pass of kernel #6 (``solvers.fb.full_gradient``); complex iterates
take the stepwise gradient (``tests/test_primal_dual.py:244``'s complex
Chambolle-Pock among them). The DP variant is ``parallel.DPCondatVu``,
the TP one ``parallel.TPCondatVu`` (a stencil K, its halo over the mesh's
"model" axis). The deep route of this class is ``solvers.deep_pd``.
"""

from __future__ import annotations

import dataclasses
import warnings
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
from ciao_tpu_torch.solvers.fb import full_gradient


def prox_conjugate(h, u, sigma):
    """prox_{σh*}(u) by the Moreau identity: the dual update of every
    primal-dual method, for any prox operator of the library."""
    return u - sigma * h.prox_only(u / sigma, 1.0 / sigma)


class PDCfg(NamedTuple):
    N: int
    fused: bool = False  # one-pass full gradient on kernel #6
    fused_precision: str = "highest"


class PDState(NamedTuple):
    tau: torch.Tensor    # scalar primal stepsize
    sigma: torch.Tensor  # scalar dual stepsize
    x: torch.Tensor      # (n,) primal iterate, the solution
    y: torch.Tensor      # (m,) dual iterate (in h*'s domain)
    it: int
    status: int

    @property
    def solution(self):
        return self.x


def pd_init(F, g, h, K, x0, tau, sigma, cfg: PDCfg) -> PDState:
    """x = x0, y = 0: solution(init) == x0 (init is iteration 1)."""
    del F, g, h, cfg
    y = torch.zeros(K.out_dim(x0.shape[0]), dtype=x0.dtype, device=x0.device)
    return PDState(tau=tau, sigma=sigma, x=x0, y=y, it=1,
                   status=int(Status.RUNNING))


def _pd_step(F, g, h, K, cfg: PDCfg, state: PDState,
             grad_fn=None) -> PDState:
    """One Condat-Vũ step. ``grad_fn(x)``, when given, takes the place of
    the full gradient (the deep route's compensated chunked mean)."""
    tau, sigma = state.tau, state.sigma
    if grad_fn is None:
        grad = full_gradient(F, cfg.N, state.x, cfg.fused,
                             cfg.fused_precision)
    else:
        grad = grad_fn(state.x)
    x_new = g.prox_only(state.x - tau * (grad + K.rmatvec(state.y)), tau)
    u = state.y + sigma * K.matvec(2.0 * x_new - state.x)
    y_new = prox_conjugate(h, u, sigma)
    return state._replace(x=x_new, y=y_new, it=state.it + 1)


def pd_run(F, g, h, K, state, cfg: PDCfg, steps: int):
    for _ in range(steps):
        state = _pd_step(F, g, h, K, cfg, state)
    return state


def pd_step(F, g, h, K, state, cfg: PDCfg):
    return _pd_step(F, g, h, K, cfg, state)


@dataclasses.dataclass(frozen=True)
class CondatVu:
    """Primal-dual facade: ``CondatVu(...)(x0, F=F, g=g, h=h, K=K, L=L)``
    minimizes (1/N)Σf_i + g(x) + h(Kx). Omit K for K = I; omit F and L
    for the Chambolle-Pock case (f = 0). ``device`` is where the run
    happens (default: x0's device for a tensor x0, else the card when
    there is one)."""

    tau: Optional[float] = None
    sigma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    fused_precision: str = "highest"
    device: Optional[str] = None

    def __post_init__(self):
        if self.tau is not None and not self.tau > 0:
            raise ValueError(f"tau must be positive, not {self.tau}")
        if self.sigma is not None and not self.sigma > 0:
            raise ValueError(f"sigma must be positive, not {self.sigma}")
        if self.maxit < 1 or self.freq < 1:
            raise ValueError("maxit and freq must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")

    def _stepsizes(self, Lf: float, normK: float):
        """σ = 1/‖K‖ (unless given), then the largest τ with τ(L_f/2 +
        σ‖K‖²) ≤ 1, with a 0.99 margin since ‖K‖ may be the exact norm."""
        sigma = 1.0 / max(normK, 1e-12) if self.sigma is None else self.sigma
        if self.tau is not None:
            tau = self.tau
        else:
            tau = 0.99 / (Lf / 2.0 + sigma * normK * normK)
        if tau * (Lf / 2.0 + sigma * normK * normK) > 1.0 + 1e-9:
            warnings.warn("CondatVu: τ(L_f/2 + σ‖K‖²) > 1 — the given "
                          "stepsizes violate the convergence condition")
        return tau, sigma

    def _setup(self, x0, F, g, h, K, L, N):
        from ciao_tpu_torch.ops.fused_block import full_grad_available
        from ciao_tpu_torch.ops.linmap import IdentityMap
        from ciao_tpu_torch.oracles import ZeroOracle
        from ciao_tpu_torch.prox import Zero

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        h = (Zero() if h is None else h).to(device)
        K = (IdentityMap() if K is None else K).to(device)
        rdt = real_dtype_of(x0)
        if L is not None:
            Lf = float(torch.mean(torch.as_tensor(L, dtype=rdt)))
        elif isinstance(F, ZeroOracle) or self.tau is not None:
            Lf = 0.0  # Chambolle-Pock, or the caller owns the condition
        else:
            raise ValueError("CondatVu: provide the smoothness moduli L, or "
                             "an explicit stepsize τ")
        tau, sigma = self._stepsizes(Lf, float(K.opnorm_bound(x0.shape[0])))
        tau = torch.as_tensor(tau, dtype=rdt, device=device)
        sigma = torch.as_tensor(sigma, dtype=rdt, device=device)
        cfg = PDCfg(N=N, fused=full_grad_available(F, x0),
                    fused_precision=self.fused_precision)
        return x0, F, g, h, K, cfg, lambda: pd_init(F, g, h, K, x0, tau,
                                                     sigma, cfg)

    def __call__(self, x0, F=None, g=None, h=None, K=None, L=None, N=None,
                 observe=None):
        x0, F, g, h, K, cfg, init = self._setup(x0, F, g, h, K, L, N)

        def run_chunk(state, k):
            return pd_run(F, g, h, K, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.tau):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, K=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, h, K, cfg, init = self._setup(x0, F, g, h, K, L, N)
        # stateless in the oracle (the full gradient is recomputed each step)
        return SolverIterable(x0_orig, init,
                              lambda s: pd_step(F, g, h, K, s, cfg),
                              rebase_fn=lambda s: s)


def ChambollePock(**kwargs) -> CondatVu:
    """The f = 0 primal-dual method (Chambolle-Pock, JMIV 2011): minimize
    g(x) + h(Kx), both proximable, ``CondatVu`` called with no F or L.
    The default steps τ = σ = 1/‖K‖ satisfy στ‖K‖² ≤ 1."""
    return CondatVu(**kwargs)
