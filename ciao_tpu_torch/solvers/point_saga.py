"""Point-SAGA — proximal-point incremental solver (beyond the reference).

Counterpart of ``ciao_tpu/solvers/point_saga.py`` (Defazio, "A Simple
Practical Accelerated Method for Finite Sums", NeurIPS 2016). SAGA's
gradient step through f_j becomes the prox of the sampled term:

    z     = x + γ·(g_j − ḡ)             ḡ = (1/N) Σ_i g_i (the table mean)
    x⁺    = prox_{γ f_j}(z)
    g_j⁺  = (z − x⁺)/γ

For the scalar-loss rows (least squares, logistic, Huber, squared hinge,
Poisson) the prox of one row is rank-1, z − γθ·a_j with a scalar θ from
the oracle's per-row solve, so the table compresses to (N,) θ
coefficients and a batched step is one margin product and one apply
product over the same rows (``oracle.pointprox_block``). Minibatches
(the JAX package's extension): each row of the block keeps its own prox
point z_j = v + γ·c_j·a_j around the shared v = x − γ·ḡ, and x⁺ is the
block mean of the prox outputs; at batch 1 this is Defazio's method.

The method solves min (1/N) Σ f_i(x): it has no separate g. Schedules
are a pure function of (seed, it): uniform blocks (``saga.block_starts``),
the importance schedule (``saga.importance_draws``, always clipped and
systematic, with no direction weight: at the optimum every realized map
fixes x*), or iid minibatches; explicit ``starts`` or ``idx`` can be
handed to :func:`point_saga_run` (parity tests pass JAX's). With block
sampling, an in-kernel θ-solve (``coeff_mode`` 0-4) and a CUDA device,
:func:`point_saga_run` hands the steps to ``ops.point_saga_multistep``
(N ≤ ``RESIDENT_MAX_ROWS``) or ``ops.point_saga_multistep_streamed``,
``LAUNCH_STEPS`` a call and the last call the remainder: unlike JAX's
drivers, no step runs stepwise after the launches.

Complex rows and iterates (complex64, complex128) take the stepwise
path, as in the JAX package (the kernels' gates take f32 iterates
alone): the row prox is z − γθ·conj(a_j) with ‖a_j‖² = Re(a_j·ā_j).
Importance sampling refuses them, as JAX's does. The data-parallel
variant is ``parallel.DPPointSAGA``, the tensor-parallel one
``parallel.TPPointSAGA``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ciao_tpu_torch.prox import Zero
from ciao_tpu_torch.sampling import _random_rows as _iid_indices
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
    LAUNCH_STEPS, RESIDENT_MAX_ROWS, _check_starts, _importance_setup,
    _warn_fallback, block_starts, importance_draws,
)

# the oracle formulas whose θ-solve the kernels carry
_KERNEL_MODES = (0, 1, 2, 3, 4)


class PointSAGACfg(NamedTuple):
    N: int
    batch: int = 1
    block: bool = False  # contiguous-block sampling (the kernel path)
    fused: bool = False  # K steps a call of kernel #12
    fused_precision: str = "highest"  # dots in the kernel: exact f32 / bf16
    fused_stream: bool = False  # K steps a call of kernel #15
    # Lipschitz-proportional blocks on the SAGA systematic schedule (the
    # facade always sets istrat; the draws take no direction weight)
    importance: bool = False
    istrat: bool = True
    iwin: int = 64


class PointSAGAState(NamedTuple):
    gamma: torch.Tensor  # scalar stepsize
    c: torch.Tensor      # (N,) prox-gradient coefficient table
    av: torch.Tensor     # (n,) table mean ḡ = (1/N) Σ c_i·a_i
    x: torch.Tensor      # (n,) iterate
    seed: int            # draws are a function of (seed, it)
    it: int
    status: int
    # kernel routes only: the (N,) row square-norms ‖a_i‖² (dequantized
    # for int8 rows), computed once; None otherwise. Flat: the TPU's
    # (8, N/8) slab has no meaning here
    na8: Optional[torch.Tensor] = None
    # importance sampling only: the π-scale CDF and the weights 1/(d·q̃_j)
    # (kept for the draw stream, which SAGA's helpers define; unused)
    qcum: Optional[torch.Tensor] = None
    qinv: Optional[torch.Tensor] = None

    @property
    def solution(self):
        return self.x


def _sqnorms(F, N: int):
    """The (N,) row square-norms ‖a_i‖² as JAX's ``_sqnorms`` forms them:
    the oracle's raw sums (a bf16 sum for bf16 rows), times rs² for int8
    rows, then f32."""
    na = F.pointprox_sqnorm_block(0, N)
    rs = F.coeff_rows_scale() if hasattr(F, "coeff_rows_scale") else None
    if rs is not None:
        na = na * (rs * rs)
    return na.to(torch.float32)


def point_saga_init(F, g, x0, gamma, seed: int,
                    cfg: PointSAGACfg) -> PointSAGAState:
    """Table bootstrap g_i = ∇f_i(x0) as coefficients (SAGA_basic.jl:
    41-47), ḡ their mean; x = x0, so the init state's solution is x0. The
    kernel routes also take the row square-norms (one pass)."""
    del g
    c = F.coeff_all(x0)
    av = F.apply_all(c) / cfg.N
    na8 = _sqnorms(F, cfg.N) if (cfg.fused or cfg.fused_stream) else None
    return PointSAGAState(
        gamma=torch.as_tensor(gamma, dtype=real_dtype_of(x0),
                              device=x0.device),
        c=c, av=av, x=x0, seed=int(seed), it=1, status=int(Status.RUNNING),
        na8=na8)


def _point_saga_step(F, g, cfg: PointSAGACfg, state: PointSAGAState,
                     start=None, idx=None, inplace=False) -> PointSAGAState:
    """One step on a block (the (seed, it) draw, importance draw or
    explicit ``start``) or an iid minibatch (its draw or ``idx``). The
    table is replaced, not written in place, unless the caller owns it
    (``inplace``)."""
    N, B = cfg.N, cfg.batch
    dev = state.x.device
    gamma = state.gamma
    v = state.x - gamma * state.av            # shared shifted iterate
    if cfg.block:
        if start is None:
            if cfg.importance:
                start = importance_draws(state.seed, state.it, 1, cfg,
                                         state.qcum, state.qinv)[0][0]
            else:
                start = block_starts(state.seed, state.it, 1, N // B, B,
                                     dev)[0]
        rows = torch.as_tensor(start, device=dev).long() + torch.arange(
            B, device=dev)
        theta, u = F.pointprox_block(v, state.c[rows], gamma, start, B)
    else:
        rows = (_iid_indices(state.seed, state.it, N, B, dev) if idx is None
                else idx)
        theta, u = F.pointprox_batch(v, state.c[rows], gamma, rows)
    c = (state.c.index_copy_(0, rows, theta) if inplace
         else state.c.index_copy(0, rows, theta))
    # x⁺ = the block mean of the prox points = v + (γ/B)·Σ_j (c_j − θ_j)·a_j;
    # ḡ⁺ = ḡ + (1/N)·Σ_j (θ_j − c_j)·a_j
    x = v + (gamma / B) * u
    av = state.av - u / N
    return state._replace(c=c, av=av, x=x, it=state.it + 1)


def _point_saga_run_fused(F, g, state: PointSAGAState, cfg: PointSAGACfg,
                          steps: int, starts=None) -> PointSAGAState:
    """Multistep driver, the counterpart of both JAX drivers
    (``_point_saga_run_fused`` and ``_point_saga_run_fused_streamed``):
    ``LAUNCH_STEPS`` steps a call of ``ops.point_saga_multistep_streamed``
    when ``cfg.fused_stream``, else of ``ops.point_saga_multistep``, the
    last call the remainder, on the explicit ``starts``, the importance
    draws or the uniform draws of (seed, it). c, x and ḡ are copied once
    and then updated in place.

    No clamp, no window alignment and no stepwise remainder: JAX's
    streamed driver stops each launch at its first same-launch revisit
    and aligns importance launches to the schedule's windows (its TPU
    kernel streams c through aliased windows), and both JAX drivers run
    ``steps mod K`` stepwise. Here the table lives in device memory and
    the launches are stream-ordered, so every launch commits all its
    steps. The draws are a function of it alone, so both packages commit
    the stepwise stream."""
    from ciao_tpu_torch.ops import fused_block as fb

    N, B = cfg.N, cfg.batch
    kernel = fb.point_saga_multistep_streamed if cfg.fused_stream else \
        fb.point_saga_multistep
    rows, offs = F.coeff_rows_data()
    dev = rows.device
    scale, mode, _, aux = fb.oracle_scalar_consts(F, g)
    scalars = torch.stack([scale, state.gamma.to(dev).float(),
                           torch.full_like(scale, 1.0 / B),
                           torch.full_like(scale, 1.0 / N), mode, aux])
    c, x, av = (t.clone() for t in (state.c, state.x, state.av))
    for k0 in range(0, steps, LAUNCH_STEPS):
        k = min(LAUNCH_STEPS, steps - k0)
        if starts is not None:
            st = starts[k0:k0 + k]
        elif cfg.importance:
            st = importance_draws(state.seed, state.it + k0, k, cfg,
                                  state.qcum, state.qinv)[0]
        else:
            st = block_starts(state.seed, state.it + k0, k, N // B, B, dev)
        kernel(rows, offs, state.na8, c, st, x, av, scalars, B,
               mode=int(F.coeff_mode), precision=cfg.fused_precision,
               rs=F.coeff_rows_scale())
    return state._replace(c=c, x=x, av=av, it=state.it + steps)


def point_saga_run(F, g, state: PointSAGAState, cfg: PointSAGACfg,
                   steps: int, starts=None, idx=None) -> PointSAGAState:
    """Advance ``steps`` steps. ``starts`` (block sampling) or ``idx``
    ((steps, batch) rows, iid) optionally replace the draws. The stepwise
    path copies the table once and then writes it in place."""
    dev = state.x.device
    if starts is not None:
        starts = _check_starts(starts, steps, cfg, dev)
    if idx is not None:
        if cfg.block:
            raise ValueError("an explicit idx schedule needs iid sampling")
        idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int64)
        if tuple(idx.shape) != (steps, cfg.batch):
            raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                             f"({steps}, {cfg.batch})")
    if cfg.fused or cfg.fused_stream:
        return _point_saga_run_fused(F, g, state, cfg, steps, starts)
    state = state._replace(c=state.c.clone())
    for i in range(steps):
        state = _point_saga_step(
            F, g, cfg, state, None if starts is None else starts[i],
            None if idx is None else idx[i], inplace=True)
    return state


def point_saga_step(F, g, state: PointSAGAState,
                    cfg: PointSAGACfg) -> PointSAGAState:
    return _point_saga_step(F, g, cfg, state)


def point_saga_rebase(F, g, state: PointSAGAState,
                      cfg: PointSAGACfg) -> PointSAGAState:
    """The exact table mean ḡ = (1/N) Σ c_i·a_i under ``F``'s row storage,
    required after a storage swap (the delta-kept ḡ would keep the old
    rows' bias), and the kernel routes' row square-norms re-derived for
    the new storage."""
    del g
    na8 = (_sqnorms(F, cfg.N) if (cfg.fused or cfg.fused_stream)
           else state.na8)
    return state._replace(av=F.apply_all(state.c) / cfg.N, na8=na8)


def _route(F, x0, N: int, B: int, block: bool):
    """(resident, streamed) of a run: with block sampling and the gate of
    the block-step kernels open (a CUDA device, dense rows, f32 iterates;
    the prox is Zero) for an oracle whose θ-solve the kernels carry, the
    resident kernel for N ≤ ``RESIDENT_MAX_ROWS``, else the streamed
    one."""
    from ciao_tpu_torch.ops import fused_block as fb

    ok = (block and getattr(F, "supports_coeff", False)
          and getattr(F, "coeff_mode", None) in _KERNEL_MODES
          and fb.saga_multistep_available(F, Zero(), x0, B))
    return ok and N <= RESIDENT_MAX_ROWS, ok and N > RESIDENT_MAX_ROWS


@dataclasses.dataclass(frozen=True)
class PointSAGA:
    """Proximal-point incremental solver (beyond the reference).

    ``gamma`` defaults to the conservative 1/(3·L_max) (with importance
    sampling, 1/(3·max_j L_j/(d·q̃_j))); larger stepsizes, up to about
    1/μ̄, stay stable on well-conditioned problems. ``maxit`` counts steps
    of ``batch`` rows. ``device`` is where the run happens (default: x0's
    device for a tensor x0, else the card when there is one)."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    batch: int = 1
    block_sampling: bool = False
    importance_sampling: bool = False  # q_j ∝ L_j blocks (needs L)
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

    def _setup(self, x0, F, g, L, N):
        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        if g is not None and not isinstance(g, Zero):
            raise ValueError(
                "PointSAGA solves min (1/N)Σ f_i(x) — it has no separate "
                "composite-g form (fold the regularizer into the f_i, or "
                "use SAGA/SARAH/Katyusha for composite problems)")
        F, g, N = default_terms(F, None, N, device)
        if not getattr(F, "supports_pointprox", False):
            raise ValueError(
                "PointSAGA needs a scalar-loss row oracle with the "
                f"pointprox protocol; {type(F).__name__} does not support "
                "it")
        rdt = real_dtype_of(x0)
        B = self.batch
        if self.block_sampling and N % B != 0:
            raise ValueError(
                "PointSAGA block_sampling needs N divisible by batch")
        qcum = qinv = None
        iwin = 64
        if self.importance_sampling:
            # SAGA's schedule construction (host f64), always clipped and
            # systematic: one schedule for every route
            if not self.block_sampling:
                raise ValueError(
                    "importance_sampling needs block_sampling=True")
            if L is None:
                raise ValueError("PointSAGA importance_sampling: provide L")
            if x0.is_complex():
                raise ValueError(
                    "PointSAGA importance_sampling: real dtypes only")
            qcum, qinv, L_eff, iwin = _importance_setup(L, N, B, True, rdt,
                                                        device)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        elif L is None:
            raise ValueError("PointSAGA: provide the smoothness moduli L, "
                             "or a stepsize γ")
        elif self.importance_sampling:
            gamma = torch.as_tensor(1.0 / (3.0 * L_eff), dtype=rdt,
                                    device=device)
        else:
            gamma = rdiv(1.0, 3.0 * torch.as_tensor(L, dtype=rdt).max().to(
                device))
        fused, fused_stream = _route(F, x0, N, B, self.block_sampling)
        if self.block_sampling and not (fused or fused_stream):
            _warn_fallback("PointSAGA", F, g, x0)
        cfg = PointSAGACfg(N=N, batch=B, block=self.block_sampling,
                           fused=fused, fused_precision=self.fused_precision,
                           fused_stream=fused_stream,
                           importance=self.importance_sampling, istrat=True,
                           iwin=iwin)
        return x0, F, g, cfg, lambda: point_saga_init(
            F, g, x0, gamma, self.seed, cfg)._replace(qcum=qcum, qinv=qinv)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return point_saga_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        return SolverIterable(
            x0_orig, init, lambda s: point_saga_step(F, g, s, cfg),
            rebase_fn=lambda s: point_saga_rebase(F, g, s, cfg))
