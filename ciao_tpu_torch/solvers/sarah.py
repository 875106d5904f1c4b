"""SARAH / ProxSARAH — recursive variance reduction (beyond the
reference).

Counterpart of ``ciao_tpu/solvers/sarah.py``. SARAH (Nguyen, Liu,
Scheinberg, Takáč, ICML 2017) recurses its gradient estimator through
consecutive iterates,

    v_t = (1/B) Σ_B [∇f_i(w_t) − ∇f_i(w_{t−1})] + v_{t−1},

and ProxSARAH (Pham, Nguyen, Phan, Tran-Dinh, JMLR 2020) takes a damped
prox step, y_{t+1} = prox_{γg}(w_t − γ v_t), w_{t+1} = (1−η) w_t +
η y_{t+1}; η = 1 is plain prox-SARAH. An outer iterate is a full-gradient
bootstrap v₀ = ∇f(x̃) with its first damped step, then m recursive inner
steps.

Inner schedules are a pure function of (seed, outer it, inner k), as
SVRG's, or explicit ``starts`` / ``idx`` handed to :func:`sarah_run`.
With block sampling, coefficient rows and a CUDA device, the bootstrap is
one pass of ``ops.coeff_apply_all`` and every inner step runs on
``ops.sarah_multistep`` (``LAUNCH_STEPS`` a call), which takes both
margins of a row from one read of it.

Complex iterates (complex64, complex128) take the stepwise path, as in
the JAX package (the kernels' gates take f32 iterates alone); γ and η
stay real.
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


class SARAHCfg(NamedTuple):
    N: int
    batch: int = 1
    m: int = 1           # stochastic inner steps per outer iterate
    block: bool = False  # contiguous-block sampling (the kernel path)
    fused: bool = False  # inner steps on kernel #11, bootstrap on kernel #6
    fused_precision: str = "highest"  # dots in the kernels: exact f32 / bf16


class SARAHState(NamedTuple):
    gamma: torch.Tensor    # scalar stepsize
    eta: torch.Tensor      # scalar ProxSARAH damping (1 = plain SARAH)
    x_tilde: torch.Tensor  # (n,) outer iterate
    seed: int              # draws are a function of (seed, it, k)
    it: int
    status: int

    @property
    def solution(self):
        return self.x_tilde


def _damped_prox(g, w, v, gamma, eta):
    """ProxSARAH update: w ← (1−η)w + η·prox_{γg}(w − γv)."""
    y = g.prox_only(w - gamma * v, gamma)
    return w + eta * (y - w)


def sarah_init(F, g, x0, gamma, eta, seed: int, cfg: SARAHCfg) -> SARAHState:
    """x̃ = x0 with no gradient work: the full pass belongs to the outer
    step, so the init state's solution is x0."""
    del F, g, cfg
    rdt, dev = real_dtype_of(x0), x0.device
    return SARAHState(gamma=torch.as_tensor(gamma, dtype=rdt, device=dev),
                      eta=torch.as_tensor(eta, dtype=rdt, device=dev),
                      x_tilde=x0, seed=int(seed), it=1,
                      status=int(Status.RUNNING))


def _sarah_inner(F, g, cfg, gamma, eta, w_prev, w, v, starts=None, idx=None):
    """The stepwise recursive inner loop on contiguous blocks
    (``starts``) or iid minibatches (``idx``, (m, B)): one read of the
    rows a step for Σ ∇f_i(w) − ∇f_i(w_prev)."""
    B = cfg.batch
    steps = starts.shape[0] if starts is not None else idx.shape[0]
    for k in range(steps):
        if starts is not None:
            diff = F.grad_sum_diff_block(w, w_prev, starts[k], B)
        else:
            diff = F.grad_sum_diff(w, w_prev, idx[k])
        v = v + diff / B
        w_prev, w = w, _damped_prox(g, w, v, gamma, eta)
    return w_prev, w, v


def _sarah_inner_fused(F, g, cfg, gamma, eta, w_prev, w, v, starts):
    """All m inner steps on kernel #11 (``ops.sarah_inner_chunked``,
    ``LAUNCH_STEPS`` a call) on the stacked pair [w_prev; w]."""
    from ciao_tpu_torch.ops.fused_block import (
        oracle_scalar_consts, sarah_inner_chunked,
    )

    rows, offs = F.coeff_rows_data()
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    f32 = lambda t: t.to(device=rows.device, dtype=torch.float32)  # noqa: E731
    scalars = torch.stack([scale, f32(gamma), f32(gamma * lam.float()),
                           f32(eta), torch.full_like(scale, 1.0 / cfg.batch),
                           mode, aux])
    ww = torch.stack([w_prev, w])
    v = v.clone()
    sarah_inner_chunked(rows, offs, ww, v, scalars, cfg.batch, starts,
                        LAUNCH_STEPS, precision=cfg.fused_precision,
                        rs=F.coeff_rows_scale())
    return ww[0], ww[1], v


def _sarah_step(F, g, cfg: SARAHCfg, state: SARAHState, starts=None,
                idx=None) -> SARAHState:
    """One outer iterate: the full-gradient bootstrap step, then m
    recursive inner steps. ``starts`` (block) or ``idx`` (iid) replace the
    outer step's own draws."""
    m, dev = cfg.m, state.x_tilde.device
    gamma, eta = state.gamma, state.eta
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import oracle_apply_all

        v0 = oracle_apply_all(F, state.x_tilde, cfg.fused_precision)[1] / cfg.N
    else:
        v0 = F.grad_sum_all(state.x_tilde) / cfg.N
    w_prev = state.x_tilde
    w = _damped_prox(g, w_prev, v0, gamma, eta)
    if cfg.block or cfg.fused:
        if starts is None:
            starts = inner_starts(state.seed, state.it, m, cfg, dev)
        inner = _sarah_inner_fused if cfg.fused else _sarah_inner
        _, w, _ = inner(F, g, cfg, gamma, eta, w_prev, w, v0, starts)
    else:
        if idx is None:
            idx = inner_indices(state.seed, state.it, m, cfg.N, dev,
                                batch=cfg.batch)
        _, w, _ = _sarah_inner(F, g, cfg, gamma, eta, w_prev, w, v0, idx=idx)
    return state._replace(x_tilde=w, it=state.it + 1)


def sarah_run(F, g, state, cfg: SARAHCfg, steps: int, starts=None, idx=None):
    """Advance ``steps`` outer steps. ``starts`` (block sampling) or
    ``idx`` (iid) optionally give each outer step's inner schedule in
    place of the (seed, it, k) draws: a sequence of ``steps`` tensors of
    shape (m,) or (m, batch)."""
    if starts is not None and idx is not None:
        raise ValueError("give starts (block sampling) or idx (iid), not both")
    dev = state.x_tilde.device
    for t in range(steps):
        st = None if starts is None else _check_starts(starts[t], cfg.m, cfg,
                                                       dev)
        ix = None if idx is None else _check_idx(idx[t], cfg.m, cfg.N, dev,
                                                 batch=cfg.batch)
        state = _sarah_step(F, g, cfg, state, st, ix)
    return state


def sarah_step(F, g, state, cfg: SARAHCfg):
    return _sarah_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class SARAH:
    """Recursive variance-reduced solver (beyond the reference).

    ``m`` counts stochastic inner steps per outer iterate and defaults to
    N // batch. ``gamma`` defaults to 1/(2 L_max), the SpiderBoost
    large-step choice. ``eta`` < 1 selects ProxSARAH's damped iterate
    averaging; η = 1 is plain prox-SARAH. ``maxit`` counts outer iterates.
    ``device`` is where the run happens (default: x0's device for a
    tensor x0, else the card when there is one)."""

    gamma: Optional[float] = None
    maxit: int = 1000
    verbose: bool = False
    freq: int = 100
    m: Optional[int] = None
    batch: int = 1
    eta: float = 1.0
    block_sampling: bool = False  # contiguous inner blocks (the kernel path)
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
        if not 0.0 < self.eta <= 1.0:
            raise ValueError(f"eta must lie in (0, 1], not {self.eta}")

    def _setup(self, x0, F, g, L, N):
        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        else:
            if L is None:
                raise ValueError(
                    "SARAH: provide the smoothness moduli L, or a stepsize γ")
            gamma = rdiv(1.0, 2.0 * torch.as_tensor(L, dtype=rdt).max()).to(
                device)
        m = N // self.batch if self.m is None else self.m
        if m < 1:
            raise ValueError("SARAH: m must be >= 1")
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SARAH block_sampling needs N divisible by batch")
        fused = fused_inner_gate("SARAH", self.block_sampling, self.batch, F,
                                 g, x0)
        cfg = SARAHCfg(N=N, batch=self.batch, m=m, block=self.block_sampling,
                       fused=fused, fused_precision=self.fused_precision)
        return x0, F, g, cfg, lambda: sarah_init(F, g, x0, gamma, self.eta,
                                                 self.seed, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return sarah_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        # the estimator re-anchors from a full pass every outer step, so a
        # storage switch self-heals: rebase is the identity
        return SolverIterable(x0_orig, init,
                              lambda s: sarah_step(F, g, s, cfg),
                              rebase_fn=lambda s: s)
