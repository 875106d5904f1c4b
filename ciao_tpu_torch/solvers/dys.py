"""Davis-Yin three-operator splitting, and Douglas-Rachford as its f = 0
case.

Counterpart of ``ciao_tpu/solvers/dys.py``: minimize (1/N) Σ_i f_i(x) +
g(x) + h(x) with f smooth and both g and h proximable (Davis & Yin,
Set-Valued Var. Anal. 2017). One step, stepsize γ ∈ (0, 2/L_f),
relaxation λ ∈ (0, 2 − γL_f/2):

    x_g = prox_{γg}(z)
    x_h = prox_{γh}(2·x_g − z − γ∇f(x_g))
    z⁺  = z + λ(x_h − x_g)

``solution(state) = x_g``. With h = Zero it is forward-backward on x_g
started from prox_g(x0); with f = 0 it is Douglas-Rachford
(:func:`DouglasRachford`). The only O(N) work is the full gradient at
x_g: on the card one pass of kernel #6 (``solvers.fb.full_gradient``),
as FISTA's. Complex iterates take the stepwise gradient (the kernel's
gate takes f32 iterates alone); the JAX package has no complex test of
Davis-Yin, and its facade converges on complex128 rows as the port's
does. The data-parallel variant is ``parallel.DPDavisYin`` and the TP
one ``parallel.TPDavisYin``, both through ``_dys_step``'s ``grad_fn``.
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
from ciao_tpu_torch.solvers.fb import full_gradient


class DYSCfg(NamedTuple):
    N: int
    fused: bool = False  # one-pass full gradient on kernel #6
    fused_precision: str = "highest"


class DYSState(NamedTuple):
    gamma: torch.Tensor  # scalar stepsize
    lam: torch.Tensor    # scalar relaxation
    z: torch.Tensor      # (n,) governing sequence
    xg: torch.Tensor     # (n,) last prox_g point, the solution
    it: int
    status: int

    @property
    def solution(self):
        return self.xg


def dys_init(F, g, h, x0, gamma, lam, cfg: DYSCfg) -> DYSState:
    """z = xg = x0: solution(init) == x0 (init is iteration 1; the first
    prox_g lands in step 2)."""
    del F, g, h, cfg
    return DYSState(gamma=gamma, lam=lam, z=x0, xg=x0, it=1,
                    status=int(Status.RUNNING))


def _dys_step(F, g, h, cfg: DYSCfg, state: DYSState,
              grad_fn=None) -> DYSState:
    """One Davis-Yin step. ``grad_fn(xg)``, when given, takes the place
    of the full gradient (the data-parallel path's all-reduced one)."""
    gamma = state.gamma
    xg = g.prox_only(state.z, gamma)
    if grad_fn is None:
        grad = full_gradient(F, cfg.N, xg, cfg.fused, cfg.fused_precision)
    else:
        grad = grad_fn(xg)
    xh = h.prox_only(2.0 * xg - state.z - gamma * grad, gamma)
    z_new = state.z + state.lam * (xh - xg)
    return state._replace(z=z_new, xg=xg, it=state.it + 1)


def dys_run(F, g, h, state, cfg: DYSCfg, steps: int):
    for _ in range(steps):
        state = _dys_step(F, g, h, cfg, state)
    return state


def dys_step(F, g, h, state, cfg: DYSCfg):
    return _dys_step(F, g, h, cfg, state)


@dataclasses.dataclass(frozen=True)
class DavisYin:
    """Three-operator splitting facade:
    ``DavisYin(...)(x0, F=F, g=g, h=h, L=L)`` minimizes (1/N)Σf_i + g + h
    with both g and h proximable. Default γ = 1/mean(L) (γ = 1 when f = 0),
    λ = 1. ``device`` is where the run happens (default: x0's device for
    a tensor x0, else the card when there is one)."""

    gamma: Optional[float] = None
    lam: float = 1.0
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    fused_precision: str = "highest"
    device: Optional[str] = None

    def __post_init__(self):
        if self.gamma is not None and not self.gamma > 0:
            raise ValueError(f"gamma must be positive, not {self.gamma}")
        if not 0 < self.lam < 2:
            raise ValueError(f"lam must lie in (0, 2), not {self.lam}")
        if self.maxit < 1 or self.freq < 1:
            raise ValueError("maxit and freq must be at least 1")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")

    def _setup(self, x0, F, g, h, L, N):
        from ciao_tpu_torch.ops.fused_block import full_grad_available
        from ciao_tpu_torch.oracles import ZeroOracle
        from ciao_tpu_torch.prox import Zero

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        h = (Zero() if h is None else h).to(device)
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        elif L is not None:
            gamma = 1.0 / torch.mean(torch.as_tensor(L, dtype=rdt,
                                                     device=device))
        elif isinstance(F, ZeroOracle):
            gamma = torch.ones((), dtype=rdt, device=device)  # f = 0: DRS
        else:
            raise ValueError("DavisYin: provide the smoothness moduli L, or "
                             "a stepsize γ")
        lam = torch.as_tensor(self.lam, dtype=rdt, device=device)
        cfg = DYSCfg(N=N, fused=full_grad_available(F, x0),
                     fused_precision=self.fused_precision)
        return x0, F, g, h, cfg, lambda: dys_init(F, g, h, x0, gamma, lam,
                                                   cfg)

    def __call__(self, x0, F=None, g=None, h=None, L=None, N=None,
                 observe=None):
        x0, F, g, h, cfg, init = self._setup(x0, F, g, h, L, N)

        def run_chunk(state, k):
            return dys_run(F, g, h, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, h=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, h, cfg, init = self._setup(x0, F, g, h, L, N)
        # stateless in the oracle (the full gradient is recomputed each
        # step): a storage switch self-heals
        return SolverIterable(x0_orig, init,
                              lambda s: dys_step(F, g, h, s, cfg),
                              rebase_fn=lambda s: s)


def DouglasRachford(**kwargs) -> DavisYin:
    """Douglas-Rachford splitting: minimize g(x) + h(x), both proximable,
    ``DavisYin`` with f = 0 (pass no F or L; γ defaults to 1, and any
    positive value converges for convex g, h)."""
    return DavisYin(**kwargs)
