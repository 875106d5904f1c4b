"""SVRG / SVRG++ solver family.

Counterpart of ``ciao_tpu/solvers/svrg.py``, a re-design of reference
``src/algorithms/SVRG/SVRG_basic.jl``: an outer iterate is m
variance-reduced inner prox steps and a full-gradient anchor refresh.
SVRG++ doubles m every outer step (SVRG_basic.jl:93); m is a Python int
in the state, so the doubling needs nothing else.

Init quirks preserved: z_full = x0, inner sum z = 0, w = x0
(SVRG_basic.jl:64-67) — so solution(init state) == x0 and a maxit=1
solve returns x0; default γ = 1/(10 L_max) with the Theorem-3.1 ρ < 1
convergence check warning (SVRG_basic.jl:44-52); plus mode requires an
explicit γ (SVRG_basic.jl:33-35) and the facade caps maxit at 25
(SVRG.jl:62-65).

Inner schedules are a pure function of (seed, outer it, inner k): block
starts from :func:`inner_starts`, iid indices (with replacement, batch
1, SVRG_basic.jl:73) from :func:`inner_indices`, or explicit ``starts``
/ ``idx`` handed to :func:`svrg_run`, one (m_t,) tensor per outer step —
the JAX package draws with threefry, which torch cannot reproduce, so
parity tests pass JAX's schedule. With block sampling, coefficient rows
and a CUDA device the fused path runs every inner step on the
``ops.svrg_coeff_multistep`` kernel against the anchor coefficients
``canch`` and refreshes the anchor in one pass (``ops.coeff_apply_all``).

Complex iterates (complex64, complex128) take the stepwise path, as in
the JAX package: the kernels' gates take f32 iterates alone, and no
fallback warning is raised for them. γ stays real.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import torch

from ciao_tpu_torch.sampling import _M32, _mix32, _seed_key
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    default_terms,
    facade_device,
    real_dtype_of,
    run_solver_loop,
)
from ciao_tpu_torch.solvers.saga import (
    LAUNCH_STEPS,
    _check_starts,
    _warn_fallback,
    block_starts,
)


class SVRGCfg(NamedTuple):
    N: int
    plus: bool
    batch: int = 1      # inner-loop minibatch size (reference is 1)
    block: bool = False  # uniform CONTIGUOUS block per inner step
    fused: bool = False  # inner steps on kernel #5, anchors on kernel #6
    fused_precision: str = "highest"  # dots in the kernels: exact f32 / bf16


class SVRGState(NamedTuple):
    gamma: torch.Tensor    # scalar
    m: int                 # inner-loop length (doubles under SVRG++)
    av: torch.Tensor       # (n,) full-gradient anchor, mean over the rows
    z: torch.Tensor        # (n,) running inner sum
    z_full: torch.Tensor   # (n,) outer iterate
    w: torch.Tensor        # (n,) inner iterate
    seed: int              # draws are a function of (seed, it, k)
    it: int
    status: int
    # fused mode only: the (N,) anchor coefficients c(z_full), refreshed
    # with av in one pass over the rows; None otherwise
    canch: Optional[torch.Tensor] = None

    @property
    def solution(self):  # reference: solution(state) = state.z_full
        return self.z_full


# ---------------------------------------------------------------------------
# stateless inner schedules
# ---------------------------------------------------------------------------

def _outer_seed(seed: int, it: int) -> int:
    """The 64-bit seed of outer step ``it``'s inner draws: the port's
    counter hash of (seed, it)."""
    return (_seed_key(seed) << 32) | _mix32((it & _M32) ^ 0x27D4EB2F)


def inner_starts(seed: int, it: int, m: int, cfg: SVRGCfg, device):
    """Block starts of the m inner steps of outer step ``it``: the
    uniform :func:`block_starts` stream under the outer step's seed,
    inner k = 0..m-1, drawn on ``device`` in one pass. (m,) int32."""
    return block_starts(_outer_seed(seed, it), 0, m, cfg.N // cfg.batch,
                        cfg.batch, device)


def inner_indices(seed: int, it: int, m: int, N: int, device, batch=None):
    """The m iid row indices (with replacement) of outer step ``it``,
    from a generator seeded by (seed, it): (m,) int64, or (m, batch) for
    the minibatch inner loops of Katyusha and SARAH."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_outer_seed(seed, it))
    shape = (m,) if batch is None else (m, batch)
    return torch.randint(N, shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# init / steps
# ---------------------------------------------------------------------------

def svrg_init(F, g, x0, gamma, m: int, seed: int, cfg: SVRGCfg) -> SVRGState:
    """z_full = w = x0, z = 0 (SVRG_basic.jl:64-67) and the anchor's mean
    gradient. Fused: c = F.coeff_all(x0) kept as ``canch`` and
    av = F.apply_all(c)/N, as the JAX package does; else
    av = F.grad_sum_all(x0)/N."""
    del g
    gamma = torch.as_tensor(gamma, dtype=real_dtype_of(x0), device=x0.device)
    canch = None
    if cfg.fused:
        canch = F.coeff_all(x0)
        av = F.apply_all(canch) / cfg.N
    else:
        av = F.grad_sum_all(x0) / cfg.N
    return SVRGState(gamma=gamma, m=int(m), av=av, z=torch.zeros_like(x0),
                     z_full=x0, w=x0, seed=int(seed), it=1,
                     status=int(Status.RUNNING), canch=canch)


def _inner_block(F, g, cfg: SVRGCfg, state: SVRGState, starts):
    """The stepwise inner loop on contiguous blocks: d = (1/B)·Σ_B
    (∇f_i(z_full) − ∇f_i(w)) in one read of the block's rows."""
    B = cfg.batch
    w, zsum = state.w, state.z
    for k in range(starts.shape[0]):
        d = F.grad_sum_diff_block(state.z_full, w, starts[k], B) / B
        w = g.prox_only(w + state.gamma * (d - state.av), state.gamma)
        zsum = zsum + w
    return w, zsum


def _inner_iid(F, g, state: SVRGState, idx):
    """The reference's inner loop (SVRG_basic.jl:74-81): one row a step,
    the anchor-minus-live gradient in one read of it."""
    w, zsum = state.w, state.z
    for k in range(idx.shape[0]):
        d = F.grad_sum_diff(state.z_full, w, idx[k:k + 1])
        w = g.prox_only(w + state.gamma * (d - state.av), state.gamma)
        zsum = zsum + w
    return w, zsum


def _inner_fused(F, g, cfg: SVRGCfg, state: SVRGState, starts):
    """All m inner steps on kernel #5, ``LAUNCH_STEPS`` at a time (the
    last launch takes the remainder: a short launch costs nothing more on
    the card), against the anchor coefficients ``state.canch``; w and the
    running sum are copied once and then updated in place."""
    from ciao_tpu_torch.ops.fused_block import (
        oracle_scalar_consts, svrg_coeff_multistep,
    )

    rows, offs = F.coeff_rows_data()
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    gamma = state.gamma.to(rows.device).float()
    scalars = torch.stack([scale, gamma, gamma * lam.float(),
                           torch.full_like(scale, 1.0 / cfg.batch), mode, aux])
    w, zs = state.w.clone(), state.z.clone()
    for k0 in range(0, state.m, LAUNCH_STEPS):
        svrg_coeff_multistep(rows, offs, starts[k0:k0 + LAUNCH_STEPS],
                             state.canch, w, zs, state.av, scalars,
                             cfg.batch, precision=cfg.fused_precision,
                             rs=F.coeff_rows_scale())
    return w, zs


def fused_inner_gate(who: str, block_sampling: bool, batch: int, F, g,
                     x0) -> bool:
    """The kernel gate of the SVRG-shaped families (SVRG, Katyusha,
    SARAH, L-SVRG, L-Katyusha; JAX's ``fused_inner_gate``): block
    sampling and ``ops.svrg_multistep_available``. A closed gate on a
    CUDA device warns once, naming the facade ``who``."""
    if not block_sampling:
        return False
    from ciao_tpu_torch.ops.fused_block import svrg_multistep_available

    fused = svrg_multistep_available(F, g, x0, batch)
    if not fused:
        _warn_fallback(who, F, g, x0)
    return fused


def _svrg_step(F, g, cfg: SVRGCfg, state: SVRGState, starts=None,
               idx=None) -> SVRGState:
    """Outer iterate (SVRG_basic.jl:71-96): m inner steps, then the
    anchor refresh at their mean. ``starts`` (block) or ``idx`` (iid)
    replace the outer step's own draws."""
    m, dev = state.m, state.z.device
    if cfg.block or cfg.fused:
        if starts is None:
            starts = inner_starts(state.seed, state.it, m, cfg, dev)
        inner = _inner_fused if cfg.fused else _inner_block
        w, zsum = inner(F, g, cfg, state, starts)
    else:
        if idx is None:
            idx = inner_indices(state.seed, state.it, m, cfg.N, dev)
        w, zsum = _inner_iid(F, g, state, idx)
    z_full = zsum / m
    canch = None
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import oracle_apply_all

        canch, gsum = oracle_apply_all(F, z_full, cfg.fused_precision)
        av = gsum / cfg.N
    else:
        av = F.grad_sum_all(z_full) / cfg.N
    return state._replace(
        m=2 * m if cfg.plus else m, av=av, z=torch.zeros_like(zsum),
        z_full=z_full, w=w if cfg.plus else z_full, it=state.it + 1,
        canch=canch)


def _check_idx(idx, m: int, N: int, device, batch=None):
    """An explicit iid schedule of shape (m,), or (m, batch), as
    :func:`inner_indices` draws it."""
    idx = torch.as_tensor(idx).to(device=device, dtype=torch.int64)
    shape = (m,) if batch is None else (m, batch)
    if tuple(idx.shape) != shape:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                         f"{shape}")
    if m and (int(idx.min()) < 0 or int(idx.max()) >= N):
        raise ValueError("idx must lie in [0, N)")
    return idx


def svrg_run(F, g, state, cfg: SVRGCfg, steps: int, starts=None, idx=None):
    """Advance ``steps`` outer steps. ``starts`` (block sampling) or
    ``idx`` (iid) optionally give each outer step's inner schedule in
    place of the (seed, it, k) draws: a sequence of ``steps`` tensors,
    the t-th of shape (m_t,), m_t = m·2^t under SVRG++."""
    if starts is not None and idx is not None:
        raise ValueError("give starts (block sampling) or idx (iid), not both")
    dev = state.z.device
    for t in range(steps):
        st = ix = None
        if starts is not None:
            st = _check_starts(starts[t], state.m, cfg, dev)
        if idx is not None:
            ix = _check_idx(idx[t], state.m, cfg.N, dev)
        state = _svrg_step(F, g, cfg, state, st, ix)
    return state


def svrg_step(F, g, state, cfg: SVRGCfg):
    return _svrg_step(F, g, cfg, state)


@dataclasses.dataclass(frozen=True)
class SVRG:
    """SVRG facade (reference ``SVRG.jl:24-44``). ``m`` defaults to N
    (SVRG.jl:59); ``plus=True`` activates SVRG++. ``device`` is where the
    run happens (default: x0's device for a tensor x0, else the card when
    there is one)."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    m: Optional[int] = None
    plus: bool = False
    batch: int = 1       # inner-loop minibatch (beyond the reference)
    block_sampling: bool = False  # contiguous inner blocks (the kernel path)
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    seed: int = 0
    device: Optional[str] = None

    def __post_init__(self):
        if self.gamma is not None and not self.gamma > 0:
            raise ValueError(f"gamma must be positive, not {self.gamma}")
        if self.maxit < 1 or self.freq < 1 or self.batch < 1:
            raise ValueError("maxit, freq and batch must be at least 1")
        if self.m is not None and self.m < 1:
            raise ValueError(f"m must be at least 1, not {self.m}")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")

    def _effective_maxit(self):
        if self.plus and self.maxit > 25:
            warnings.warn(
                "exponential number of inner updates...reverted to 25 "
                "maximum iterations"
            )
            return 25
        return self.maxit

    def _setup(self, x0, F, g, L, mu, N):
        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rdt = real_dtype_of(x0)
        m = N if self.m is None else self.m
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        else:
            if self.plus:
                raise ValueError("SVRG++: provide a stepsize γ")
            if L is None or mu is None:
                raise ValueError(
                    "SVRG: smoothness or convexity parameter absent — "
                    "provide L and μ, or γ")
            L_max = float(torch.as_tensor(L, dtype=rdt).max())
            mu_max = float(torch.as_tensor(mu, dtype=rdt).max())
            gam = 1.0 / (10.0 * L_max)
            # Theorem 3.1 convergence condition (SVRG_basic.jl:44-52)
            rho = (1 + 4 * L_max * gam**2 * mu_max * (N + 1)) / (
                mu_max * gam * N * (1 - 4 * L_max * gam))
            if rho >= 1:
                warnings.warn(
                    "convergence condition violated...provide a stepsize!")
            gamma = torch.as_tensor(gam, dtype=rdt, device=device)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SVRG block_sampling needs N divisible by batch")
        fused = fused_inner_gate("SVRG", self.block_sampling, self.batch, F,
                                 g, x0)
        cfg = SVRGCfg(N=N, plus=self.plus, batch=self.batch,
                      block=self.block_sampling, fused=fused,
                      fused_precision=self.fused_precision)
        return x0, F, g, cfg, lambda: svrg_init(F, g, x0, gamma, m,
                                                self.seed, cfg)

    def __call__(self, x0, F=None, g=None, L=None, mu=None, N=None,
                 observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, mu, N)

        def run_chunk(state, n):
            return svrg_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self._effective_maxit(),
                                    self.verbose, self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, mu=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, mu, N)
        # SVRG recomputes its anchor from a full pass every outer step,
        # so a storage switch self-heals: rebase is identity
        return SolverIterable(x0_orig, init,
                              lambda s: svrg_step(F, g, s, cfg),
                              rebase_fn=lambda s: s)
