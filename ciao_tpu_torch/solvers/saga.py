"""SAGA / SAG solver family (coefficient table).

Counterpart of ``ciao_tpu/solvers/saga.py``, a re-design of reference
``src/algorithms/SAGA_SAG/SAGA_basic.jl``. The gradient table of a
rank-1 oracle is stored as its exact (N,) coefficient vector
(``table="coeff"``): one step draws a block (or an iid minibatch),
refreshes its coefficients, forms the SAG (biased) or SAGA (unbiased)
direction and applies the prox.

Defaults (SAGA_basic.jl:34-35): γ = 1/(3 L_max) for SAGA, 1/(16 L_max)
for SAG. Init (SAGA_basic.jl:41-48): table = coefficients at x0, av =
their mean row gradient, z = prox_g((1-γ) x0, γ).

Block schedules are a pure function of (seed, it) (:func:`block_starts`),
or an explicit ``starts`` tensor handed to :func:`saga_run` — the JAX
package draws with threefry, which torch cannot reproduce, so parity
tests pass JAX's schedule. With block sampling, coefficient tables and a
CUDA device, :func:`saga_run` hands K steps at a time to the hand-written
kernel ``ops.saga_coeff_multistep``.

Not ported yet (ROADMAP.md, queue 1 item 7): the full (N, n) table,
importance sampling and the streamed any-N path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers.base import (
    SolverIterable,
    Status,
    real_dtype_of,
    run_solver_loop,
)

_FULL_TABLE = ("the full (N, n) gradient table (table='full') is not ported "
               "yet: ROADMAP.md, queue 1 item 7")
_IMPORTANCE = ("importance sampling is not ported yet: ROADMAP.md, queue 1 "
               "items 5 and 7")

# Steps per kernel launch of the fused multistep path (K in the JAX package).
LAUNCH_STEPS = 128


class SAGACfg(NamedTuple):
    N: int
    sag: bool
    batch: int = 1
    block: bool = False  # uniform CONTIGUOUS block instead of iid subset
    fused: bool = False  # K steps per launch of the CUDA kernel
    coeff: bool = False  # (N,) coefficient table instead of (N, n) rows
    fused_precision: str = "highest"  # dots in the kernel: exact f32 / bf16


class SAGAState(NamedTuple):
    s: torch.Tensor        # (N,) coefficient table
    gamma: torch.Tensor    # scalar
    av: torch.Tensor       # (n,) running average of the table
    z: torch.Tensor        # (n,)
    seed: int              # schedule seed: draws are a function of (seed, it)
    it: int
    status: int

    @property
    def solution(self):  # reference: solution(state) = state.z
        return self.z


# ---------------------------------------------------------------------------
# stateless schedules
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulmod32(x, c: int):
    """(x·c) mod 2^32 for uint32 values held in int64 tensors (or Python
    ints), multiplied in 16-bit halves so no product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The ``lowbias32`` integer finalizer: a bijection of uint32 with
    good avalanche, the round function of the counter-based draws."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _seed_key(seed: int) -> int:
    return _mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))


def block_starts(seed: int, it0: int, k: int, d: int, B: int, device):
    """Block starts of steps it0..it0+k-1: a pure function of (seed, it),
    uniform over the d = N/B blocks, computed on ``device`` in one
    vectorized pass (no host sync). Returns a (k,) int32 tensor."""
    its = torch.arange(it0, it0 + k, dtype=torch.int64, device=device)
    h = _mix32((its & _M32) ^ _seed_key(seed))
    h = _mix32(h ^ 0x9E3779B9)
    return ((h * d) >> 32).mul_(B).to(torch.int32)


def _iid_indices(seed: int, it: int, N: int, B: int, device):
    """The iid minibatch of step ``it`` (without replacement for B > 1),
    from a generator seeded by (seed, it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((_seed_key(seed) << 32) | _mix32((it & _M32) ^ 0x85EBCA6B))
    if B == 1:
        return torch.randint(N, (1,), generator=gen, device=device)
    return torch.randperm(N, generator=gen, device=device)[:B]


# ---------------------------------------------------------------------------
# init / steps
# ---------------------------------------------------------------------------

def _check_cfg(cfg: SAGACfg):
    if not cfg.coeff:
        raise NotImplementedError(_FULL_TABLE)


def saga_init(F, g, x0, gamma, seed: int, cfg: SAGACfg) -> SAGAState:
    """Reference SAGA_basic.jl:41-48. The gradient table
    s_i = ∇f_i(x0) = c_i·a_i is stored as the exact (N,) coefficient
    vector; the full passes are plain matrix products."""
    _check_cfg(cfg)
    gamma = torch.as_tensor(gamma, dtype=real_dtype_of(x0), device=x0.device)
    s = F.coeff_all(x0)
    av = F.apply_all(s) / cfg.N
    z = g.prox_only((1 - gamma) * x0, gamma)
    return SAGAState(s=s, gamma=gamma, av=av, z=z, seed=int(seed), it=1,
                     status=int(Status.RUNNING))


def saga_rebase(F, state: SAGAState, cfg: SAGACfg) -> SAGAState:
    """Make ``av`` consistent with the table under ``F``'s row storage.

    The running average is maintained by deltas, so after swapping the
    oracle's storage mid-run (f32/bf16/int8 stages) it still reflects the
    old rows, and the mismatch never decays. One pass over A repairs it."""
    if not cfg.coeff:
        return state
    return state._replace(av=F.apply_all(state.s) / cfg.N)


def _saga_direction(cfg, state, innov, B, wgt=1.0):
    """The SAG (biased, average first) / SAGA (unbiased) update-order
    quirk (SAGA_basic.jl:57-62). ``innov`` = Σ_B (∇f_i(z) − s_i_old);
    ``wgt`` scales the direction only, never the table-mean delta."""
    N = cfg.N
    diff = innov * (wgt / B)
    if cfg.sag:
        av = state.av + innov / N
        w = state.z - state.gamma * av
    else:
        w = state.z - state.gamma * (diff + state.av)
        av = state.av + innov / N
    return av, w


def _saga_step_coeff(F, g, cfg: SAGACfg, state: SAGAState, start=None):
    """Coefficient-table step: the innovation Σ (c_new − c_old)·a_i is
    one extra product over the same rows the coefficients read. The table
    is replaced, not written in place, so earlier states stay valid."""
    N, B = cfg.N, cfg.batch
    dev = state.z.device
    if cfg.block:
        if start is None:
            start = block_starts(state.seed, state.it, 1, N // B, B, dev)[0]
        idx = torch.as_tensor(start, device=dev).long() + torch.arange(
            B, device=dev)
        c_new = F.coeff_block(state.z, start, B)
        innov = F.apply_rows_block(c_new - state.s[idx], start, B)
    else:
        idx = _iid_indices(state.seed, state.it, N, B, dev)
        c_new = F.coeff_batch(state.z, idx)
        innov = F.apply_rows(c_new - state.s[idx], idx)
    s = state.s.index_copy(0, idx, c_new)
    av, w = _saga_direction(cfg, state, innov, B)
    z = g.prox_only(w, state.gamma)
    return state._replace(s=s, av=av, z=z, it=state.it + 1)


def _saga_step(F, g, cfg: SAGACfg, state: SAGAState, start=None):
    _check_cfg(cfg)
    return _saga_step_coeff(F, g, cfg, state, start)


def _saga_run_fused(F, g, state, cfg: SAGACfg, steps: int, starts=None):
    """Multistep path: K block steps per call of the kernel
    ``ops.saga_coeff_multistep``, then the < K remainder stepwise on the
    same schedule. The table, z and av are copied once and then updated
    in place by the kernel."""
    from ciao_tpu_torch.ops.fused_block import (
        oracle_scalar_consts,
        saga_coeff_multistep,
    )

    B, N = cfg.batch, cfg.N
    K = min(LAUNCH_STEPS, steps)
    L = steps // K
    rem = steps - L * K
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    dev = state.z.device
    scale, mode, lam, aux = oracle_scalar_consts(F, g)
    gamma = state.gamma.to(dev)
    consts = torch.tensor([1.0 / B, 1.0 / N, 1.0 if cfg.sag else 0.0],
                          dtype=torch.float32, device=dev)
    scalars = torch.cat([
        torch.stack([scale, gamma.float(), gamma.float() * lam.float()]),
        consts, torch.stack([mode, aux]),
    ])
    c, z, av = state.s.clone(), state.z.clone(), state.av.clone()
    for launch in range(L):
        if starts is None:
            st = block_starts(state.seed, state.it + launch * K, K, N // B,
                              B, dev)
        else:
            st = starts[launch * K:(launch + 1) * K]
        saga_coeff_multistep(rows, offs, st, c, z, av, scalars, B,
                             precision=cfg.fused_precision, rs=rs)
    state = state._replace(s=c, z=z, av=av, it=state.it + L * K)
    for r in range(rem):
        state = _saga_step(F, g, cfg, state,
                           None if starts is None else starts[L * K + r])
    return state


def _check_starts(starts, steps: int, cfg: SAGACfg, device):
    """An explicit schedule as a (steps,) int32 tensor on ``device``,
    checked on the host once (block-aligned and in range)."""
    if not cfg.block:
        raise ValueError("an explicit starts schedule needs block sampling")
    starts = torch.as_tensor(starts).to(device=device, dtype=torch.int32)
    if tuple(starts.shape) != (steps,):
        raise ValueError(f"starts has shape {tuple(starts.shape)}, "
                         f"expected ({steps},)")
    host = starts.cpu()
    if steps and (int(host.min()) < 0 or int(host.max()) > cfg.N - cfg.batch
                  or bool((host % cfg.batch != 0).any())):
        raise ValueError("starts must be multiples of batch in [0, N - batch]")
    return starts.contiguous()


def saga_run(F, g, state, cfg: SAGACfg, steps: int, starts=None):
    """Advance ``steps`` steps. ``starts`` optionally gives the (steps,)
    block starts to use instead of the (seed, it) draws."""
    _check_cfg(cfg)
    if starts is not None:
        starts = _check_starts(starts, steps, cfg, state.z.device)
    if cfg.coeff and cfg.fused and steps >= 8:
        return _saga_run_fused(F, g, state, cfg, steps, starts)
    for i in range(steps):
        state = _saga_step(F, g, cfg, state,
                           None if starts is None else starts[i])
    return state


def saga_step(F, g, state, cfg: SAGACfg, start=None):
    return _saga_step(F, g, cfg, state, start)


def _warn_saga_fallback(F, g, x0):
    """One-time warning when a block-sampling SAGA config on a CUDA
    device lands on the stepwise path, naming the first closed gate and
    its remedy. Silent for CPU iterates."""
    if x0.device.type != "cuda":
        return
    if x0.dtype != torch.float32:
        runtime.warn_fused_fallback(
            "SAGA", f"the iterate dtype is {x0.dtype} and the kernel is "
            "f32-only",
            "use float32 iterates — precision belongs in the oracle's row "
            "storage (with_storage), not the iterate dtype",
        )
    elif not (hasattr(F, "coeff_rows_data") and isinstance(g, (NormL1, Zero))):
        runtime.warn_fused_fallback(
            "SAGA", "the in-kernel prox covers NormL1/Zero only, and the "
            "oracle must expose dense rows (coeff_rows_data)",
            "use g=NormL1 or g=Zero and a dense-rows oracle",
        )
    else:
        runtime.warn_fused_fallback(
            "SAGA", "the oracle's rows are not f32, bf16 or int8 rows with "
            "f32 offsets on the iterate's device, or n exceeds the "
            "kernel's MAX_COLS",
            "store the oracle in float32 (then with_storage) on the "
            "iterate's device",
        )


@dataclasses.dataclass(frozen=True)
class SAGA:
    """SAGA facade (reference ``SAGA.jl:24-42``). ``SAG_flag`` switches to
    the biased SAG update (reference ``SAGA.jl:190-191``). ``device`` is
    where the run happens (default: x0's device); the oracle and the prox
    are moved there with ``.to(device)``."""

    gamma: Optional[float] = None
    maxit: int = 10000
    verbose: bool = False
    freq: int = 1000
    SAG_flag: bool = False
    batch: int = 1
    block_sampling: bool = False  # contiguous-block minibatches
    importance_sampling: bool = False  # not ported: raises
    table: str = "auto"  # "coeff" (N,) | "auto" (coeff if rank-1) | "full"
    fused_precision: str = "highest"  # "highest" = exact-f32 kernel dots;
    # "default" = bf16 operands with f32 accumulation
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
        if self.table not in ("auto", "full", "coeff"):
            raise ValueError(f"table must be 'auto', 'full' or 'coeff', not "
                             f"{self.table!r}")

    def _setup(self, x0, F, g, L, N):
        if self.importance_sampling:
            raise NotImplementedError(_IMPORTANCE)
        if self.table == "full":
            raise NotImplementedError(_FULL_TABLE)
        if F is None:
            raise NotImplementedError(
                "F=None (the ZeroOracle default) is not ported yet: "
                "ROADMAP.md, queue 1 item 11")
        if self.device is not None:
            device = torch.device(self.device)
        elif isinstance(x0, torch.Tensor):
            device = x0.device
        else:
            device = torch.device("cpu")
        x0 = torch.as_tensor(x0, device=device)
        F = F.to(device)
        g = (Zero() if g is None else g).to(device)
        if N is None:
            N = F.num_terms
        if not getattr(F, "supports_coeff", False):
            raise NotImplementedError(_FULL_TABLE)
        if self.block_sampling and N % self.batch != 0:
            raise ValueError("SAGA block_sampling needs N divisible by batch")
        from ciao_tpu_torch.ops import saga_multistep_available

        fused = self.block_sampling and saga_multistep_available(
            F, g, x0, self.batch)
        if self.block_sampling and not fused:
            _warn_saga_fallback(F, g, x0)
        rdt = real_dtype_of(x0)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
        else:
            if L is None:
                raise ValueError(
                    "SAGA: smoothness parameter absent — provide L or γ"
                )
            L_max = torch.max(torch.as_tensor(L, dtype=rdt, device=device))
            gamma = 1.0 / ((16.0 if self.SAG_flag else 3.0) * L_max)
        cfg = SAGACfg(
            N=N, sag=self.SAG_flag, batch=self.batch,
            block=self.block_sampling, fused=fused, coeff=True,
            fused_precision=self.fused_precision,
        )
        return x0, F, g, cfg, lambda: saga_init(F, g, x0, gamma, self.seed,
                                                cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, n):
            return saga_run(F, g, state, cfg, n)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e}")

        state, it = run_solver_loop(
            init, run_chunk, self.maxit, self.verbose, self.freq, disp, observe
        )
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        return SolverIterable(
            x0_orig, init, lambda s: saga_step(F, g, s, cfg),
            rebase_fn=lambda s: saga_rebase(F, s, cfg),
        )


def SAG(**kwargs):
    """SAG = SAGA with the biased update order (reference SAGA.jl:190-191)."""
    return SAGA(SAG_flag=True, **kwargs)
