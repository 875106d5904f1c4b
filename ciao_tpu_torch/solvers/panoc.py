"""PANOC and ZeroFPR — L-BFGS-accelerated forward-backward solvers.

Counterpart of ``ciao_tpu/solvers/panoc.py``. Both minimize φ(x) = f(x)
+ g(x), f = (1/N) Σ_i f_i smooth, g proximable, by globalizing a
quasi-Newton step with the forward-backward envelope (FBE; Themelis,
Stella & Patrinos, SIOPT 2018):

    z(x)  = prox_{γg}(x − γ∇f(x)),   r(x) = x − z(x)
    φ_γ(x) = f(x) − Re⟨∇f(x), r⟩ + ‖r‖²/(2γ) + g(z)

One FBE evaluation is one full pass over the oracle rows (both sums from
the same margins) plus an O(n) prox. On the card, with the gate of
``ops.full_grad_available`` open, every evaluation is one launch of
kernel #7 (``ops.coeff_value_apply_all``); elsewhere it is the oracle's
``value_sum_and_grad_sum_all``.

* **PANOC** (Stella, Themelis, Sopasakis & Patrinos, CDC 2017):
  candidate x⁺(τ) = x − (1−τ)r + τd, d = −H·r from L-BFGS on the residual
  pairs (s = Δx, y = Δr); backtrack τ = 1, ½, ¼, … until φ_γ(x⁺) ≤
  φ_γ(x) − σ‖r‖²; the last trial forces τ = 0, the plain forward-backward
  step.
* **ZeroFPR**: the same envelope, with the direction built and applied
  at the forward-backward point xbar = z(x): x⁺ = xbar + τd with pairs
  (Δxbar, ΔR(xbar)); one more pass a step.

What runs where. JAX's line search is a ``lax.while_loop`` on the
device; here the accept test φ_γ(u) ≤ target is read by the host, once
per trial (with the ``tol`` test of the same trial in the same read),
and adaptive γ's descent-lemma test once per halving and once more to
stop. Everything else stays on the device: the L-BFGS ring (``head``,
``count``, ``rho``) is updated with ``torch.where``/``index_copy`` and
gathered with ``index_select``, and a non-finite direction falls back to
−r by ``torch.where``. A step of fixed-γ PANOC syncs once per trial, so
1 in the steady state, where τ = 1 is accepted first.

Complex iterates (complex64, complex128) run as real 2n-vectors: every
inner product of the two-loop recursion and the FBE is Re⟨·,·⟩
(``_rdot``), so the ring's ρ is 1/Re⟨s, y⟩; they take the stepwise
envelope read (kernel #7's gate takes f32 iterates alone). The DP
variant is ``parallel.DPPANOC``, whose host reads are of all-reduced
values; the TP one, ``parallel.TPPANOC``, passes every function here an
``rdot`` that sums the rank's columns' inner product over the mesh's
"model" axis, as JAX's ``tp.py`` does.
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
    rdiv,
    real_dtype_of,
    run_solver_loop,
)


class PANOCCfg(NamedTuple):
    N: int
    mem: int = 5          # L-BFGS memory (ring size)
    max_ls: int = 10      # line-search trials before forcing τ = 0
    zerofpr: bool = False  # direction at xbar (ZeroFPR) vs at x (PANOC)
    tol: Optional[float] = None  # ‖r‖/γ stop (None = run maxit)
    fused: bool = False   # every FBE read on kernel #7
    fused_precision: str = "highest"  # dots in the kernel: exact f32 / bf16
    adaptive: bool = False  # γ-backtracking on the descent lemma (no L)


class PANOCState(NamedTuple):
    gamma: torch.Tensor   # scalar stepsize
    sigma: torch.Tensor   # sufficient-decrease constant σ
    x: torch.Tensor       # (n,) iterate
    fx: torch.Tensor      # f(x) = Σf_i(x)/N
    gradx: torch.Tensor   # (n,) ∇f(x)
    z: torch.Tensor       # (n,) prox point z(x)
    gz: torch.Tensor      # g(z)
    fbe: torch.Tensor     # φ_γ(x)
    S: torch.Tensor       # (mem, n) L-BFGS s-pairs ring
    Y: torch.Tensor       # (mem, n) L-BFGS y-pairs ring
    rho: torch.Tensor     # (mem,) 1/Re⟨y, s⟩ (0 = empty/rejected slot)
    head: torch.Tensor    # ring write cursor (0-d int64)
    count: torch.Tensor   # valid pairs, at most mem (0-d int64)
    pbase: torch.Tensor   # ZeroFPR: previous xbar ((0,) under PANOC)
    presid: torch.Tensor  # ZeroFPR: previous R(xbar) ((0,) under PANOC)
    tau: torch.Tensor     # last accepted τ (diagnostic)
    ls_ewma: torch.Tensor  # f32 EWMA of FBE trials per step (thrash gauge)
    it: int
    status: int

    @property
    def solution(self):
        # the prox point: feasible or sparse under g (x is the smooth-side
        # iterate, e.g. never exactly sparse under L1)
        return self.z


def _rdot(a, b):
    """Re⟨a, b⟩, the real inner product of the underlying real space."""
    return torch.real(torch.vdot(a, b))


def _eval_fbe(F, g, u, gamma, cfg: PANOCCfg, rdot=_rdot):
    """One FBE evaluation: one pass over the rows (kernel #7 when
    ``cfg.fused``) and one prox. Returns (f_u, grad_u, z_u, g_zu, r_u,
    fbe_u). ``rdot`` is the real inner product (the TP path's sums its
    columns' over the mesh's "model" axis)."""
    N = cfg.N
    if cfg.fused:
        from ciao_tpu_torch.ops.fused_block import oracle_value_apply_all

        val, _, gsum = oracle_value_apply_all(F, u, cfg.fused_precision)
    else:
        val, gsum = F.value_sum_and_grad_sum_all(u)
    f_u = torch.real(val) / N
    grad_u = gsum / N
    z_u, g_zu = g.prox(u - gamma * grad_u, gamma)
    r_u = u - z_u
    fbe_u = (f_u - rdot(grad_u, r_u) + rdiv(0.5, gamma) * rdot(r_u, r_u)
             + torch.real(g_zu))
    return f_u, grad_u, z_u, g_zu, r_u, fbe_u


def _lbfgs_direction(S, Y, rho, head, count, r, rdot=_rdot):
    """Two-loop recursion d = −H·r over the masked ring: the loops always
    run ``mem`` iterations, and empty slots carry ρ = 0, so they add
    nothing. H₀ = γ_H·I with the Barzilai-Borwein scaling of the newest
    pair. No host read: the ring's slots are gathered once in each loop's
    order (newest first, then oldest first), so each iteration is four
    small launches."""
    m = S.shape[0]
    ar = torch.arange(m, device=r.device)
    bwd = (head - 1 - ar) % m
    fwd = (head - count + ar) % m
    Sb, Yb, rb = S.index_select(0, bwd), Y.index_select(0, bwd), \
        rho.index_select(0, bwd)
    q = r
    alphas = []
    for i in range(m):
        a = rb[i] * rdot(Sb[i], q)
        q = q - a * Yb[i]
        alphas.append(a)
    yy = rdot(Yb[0], Yb[0])
    sy = rdot(Sb[0], Yb[0])
    one = torch.ones((), dtype=rho.dtype, device=r.device)
    gam_h = torch.where((count > 0) & (yy > 0),
                        sy / torch.where(yy > 0, yy, one), one)
    q = q * gam_h
    # α by slot (the backward order is a permutation), then forward
    af = torch.zeros_like(rho).index_copy(0, bwd, torch.stack(alphas)) \
        .index_select(0, fwd)
    Sf, Yf, rf = S.index_select(0, fwd), Y.index_select(0, fwd), \
        rho.index_select(0, fwd)
    for i in range(m):
        b = rf[i] * rdot(Yf[i], q)
        q = q + (af[i] - b) * Sf[i]
    d = -q
    # a broken direction falls back to −r (the forward-backward
    # direction), which the τ-search accepts unconditionally
    return torch.where(torch.isfinite(rdot(d, d)), d, -r)


def _push_pair(state: PANOCState, s, y, valid=True,
               rdot=_rdot) -> PANOCState:
    """Ring-push an (s, y) pair, rejected unless ``valid`` and the
    curvature Re⟨y, s⟩ > ε‖s‖‖y‖ (keeps H positive definite). No host
    read: ``valid`` is a Python bool or a device bool."""
    sy = rdot(y, s)
    ss = rdot(s, s)
    yy = rdot(y, y)
    eps = 1e-12
    good = (sy > eps * torch.sqrt(ss * yy) + eps) & valid
    h = state.head.view(1)
    m = state.S.shape[0]
    S = torch.where(good, state.S.index_copy(0, h, s[None]), state.S)
    Y = torch.where(good, state.Y.index_copy(0, h, y[None]), state.Y)
    inv = rdiv(1.0, torch.where(good, sy, torch.ones_like(sy)))
    rho = torch.where(good, state.rho.index_copy(0, h, inv.view(1)),
                      state.rho)
    head = torch.where(good, (state.head + 1) % m, state.head)
    count = torch.where(good, torch.clamp(state.count + 1, max=m),
                        state.count)
    return state._replace(S=S, Y=Y, rho=rho, head=head, count=count)


def _probe_gamma(F, x0, N, alpha, rdt, rdot=_rdot):
    """One-time finite-difference smoothness probe of the adaptive start:
    L₀ = ‖∇f(x0+δ) − ∇f(x0)‖/‖δ‖, γ₀ = α/L₀. Under TP both norms are of
    the whole vectors (``rdot``), as JAX probes its global arrays."""
    d = torch.where(torch.abs(x0) > 0, 1e-3 * x0,
                    torch.full_like(x0, 1e-3))
    g1 = F.grad_sum_all(x0) / N
    g2 = F.grad_sum_all(x0 + d) / N
    L0 = torch.sqrt(rdot(g2 - g1, g2 - g1)) / torch.sqrt(rdot(d, d))
    return rdiv(alpha, torch.clamp(L0, min=1e-12).to(rdt))


def panoc_init(F, g, x0, gamma, sigma, cfg: PANOCCfg,
               rdot=_rdot) -> PANOCState:
    """One FBE evaluation at x0; an empty ring. solution(init) = z(x0)."""
    rdt = real_dtype_of(x0)
    dev = x0.device
    fx, gradx, z, gz, _r, fbe = _eval_fbe(F, g, x0, gamma, cfg, rdot)
    m = cfg.mem
    paux = x0.numel() if cfg.zerofpr else 0
    i64 = torch.int64
    return PANOCState(
        gamma=gamma, sigma=sigma, x=x0, fx=fx, gradx=gradx, z=z,
        gz=torch.real(gz), fbe=fbe,
        S=torch.zeros((m, x0.numel()), dtype=x0.dtype, device=dev),
        Y=torch.zeros((m, x0.numel()), dtype=x0.dtype, device=dev),
        rho=torch.zeros((m,), dtype=rdt, device=dev),
        head=torch.zeros((), dtype=i64, device=dev),
        count=torch.zeros((), dtype=i64, device=dev),
        pbase=torch.zeros((paux,), dtype=x0.dtype, device=dev),
        presid=torch.zeros((paux,), dtype=x0.dtype, device=dev),
        tau=torch.ones((), dtype=rdt, device=dev),
        ls_ewma=torch.ones((), dtype=torch.float32, device=dev),
        it=1, status=int(Status.RUNNING),
    )


# Line-search thrash gauge: near a narrow row storage's accuracy floor the
# σ-decrease test cannot resolve the quantization noise and the search
# burns several FBE evaluations a step with no progress; a sustained
# average of at least THRASH_EVALS trials a step is the symptom the
# facades warn about (the JAX package's measured bf16 floor: ~3.4).
THRASH_EVALS = 2.5
_EWMA_BETA = 1.0 / 16.0

_ADAPT_ALPHA = 0.95      # target γ·L_local ≤ α after backtracking
_ADAPT_MAX_HALVINGS = 60  # then Status.GAMMA_UNDERFLOW (adaptive Finito's)


def _gamma_backtrack(F, g, cfg: PANOCCfg, state: PANOCState, rdot=_rdot):
    """Adaptive-γ test at the current x: halve γ until the descent lemma
    f(z) ≤ f(x) − ⟨∇f(x), r⟩ + (α/2γ)‖r‖² holds at the forward-backward
    point. Each trial is one value-only pass (``value_sum_all``, a margin
    read outside any kernel, as in JAX) and one prox, and one host read
    of the test. On a γ change the ring flushes and σ rescales by the γ
    ratio (σ ∝ 1/γ). Returns (state, changed)."""
    eps = torch.finfo(state.fbe.dtype).eps

    def f_at(z):
        return torch.real(F.value_sum_all(z)) / cfg.N

    def violated(gamma, r, rr, f_z):
        ub = (state.fx - rdot(state.gradx, r)
              + rdiv(_ADAPT_ALPHA, 2.0 * gamma) * rr)
        return bool(f_z > ub + 10 * eps * (1.0 + torch.abs(f_z)))

    gamma, z, gz = state.gamma, state.z, state.gz
    r = state.x - z
    rr = rdot(r, r)
    halv = 0
    while halv < _ADAPT_MAX_HALVINGS and violated(gamma, r, rr, f_at(z)):
        gamma = gamma * 0.5
        z, gz = g.prox(state.x - gamma * state.gradx, gamma)
        gz = torch.real(gz)
        r = state.x - z
        rr = rdot(r, r)
        halv += 1
    changed = halv > 0
    fbe = (state.fx - rdot(state.gradx, r) + rr / (2.0 * gamma) + gz)
    state = state._replace(gamma=gamma,
                           sigma=state.sigma * (state.gamma / gamma),
                           z=z, gz=gz, fbe=fbe)
    if changed:
        # flush the ring: ρ = 0 masks every slot
        state = state._replace(rho=torch.zeros_like(state.rho),
                               count=torch.zeros_like(state.count),
                               head=torch.zeros_like(state.head))
    if halv >= _ADAPT_MAX_HALVINGS:
        state = state._replace(status=int(Status.GAMMA_UNDERFLOW))
    return state, changed


def _panoc_step(F, g, cfg: PANOCCfg, state: PANOCState,
                rdot=_rdot) -> PANOCState:
    gamma_changed = False
    if cfg.adaptive:
        state, gamma_changed = _gamma_backtrack(F, g, cfg, state, rdot)
    gamma, sigma = state.gamma, state.sigma
    r = state.x - state.z
    rr = rdot(r, r)

    if cfg.zerofpr:
        # the residual at the prox point xbar = z(x) (one more pass), the
        # (Δxbar, ΔR(xbar)) pair of the previous step, the direction there;
        # a pair straddling a γ change mixes two residual maps: rejected
        base = state.z
        rbar = _eval_fbe(F, g, base, gamma, cfg, rdot)[4]
        state = _push_pair(state, base - state.pbase, rbar - state.presid,
                           valid=state.it > 1 and not gamma_changed,
                           rdot=rdot)
        state = state._replace(pbase=base, presid=rbar)
        dir_resid = rbar
    else:
        dir_resid = r

    d = _lbfgs_direction(state.S, state.Y, state.rho, state.head,
                         state.count, dir_resid, rdot)
    target = state.fbe - sigma * rr
    rdt = state.fbe.dtype

    # trial j = 0 is τ = 1 (the pure quasi-Newton step); trial max_ls forces
    # τ = 0, the forward-backward step, which satisfies the decrease for
    # γ < 1/L_f: at most max_ls + 1 trials, each read once by the host
    j = 0
    while True:
        tau = 0.0 if j >= cfg.max_ls else 0.5 ** j
        if cfg.zerofpr:
            u = state.z + tau * d  # τ = 0: the forward-backward point z(x)
        else:
            u = state.x - (1.0 - tau) * r + tau * d
        f_u, grad_u, z_u, g_zu, r_u, fbe_u = _eval_fbe(F, g, u, gamma, cfg,
                                                       rdot)
        j += 1
        flags = [fbe_u <= target]
        if cfg.tol is not None:
            flags.append(torch.sqrt(rdot(r_u, r_u)) / gamma <= cfg.tol)
        flags = torch.stack(flags).tolist()
        if flags[0] or j > cfg.max_ls:
            break

    new = state._replace(
        x=u, fx=f_u, gradx=grad_u, z=z_u, gz=torch.real(g_zu), fbe=fbe_u,
        tau=torch.full((), tau, dtype=rdt, device=u.device),
        ls_ewma=state.ls_ewma + _EWMA_BETA * (j - state.ls_ewma),
        it=state.it + 1,
    )
    if not cfg.zerofpr:
        # PANOC's pair (Δx, ΔR(x)): r_u = R(u) comes from the accepted
        # trial's own evaluation
        new = _push_pair(new, u - state.x, r_u - r, rdot=rdot)
    if cfg.tol is not None and flags[1]:
        new = new._replace(status=int(Status.CONVERGED))
    return new


def panoc_step(F, g, state, cfg: PANOCCfg):
    """One step; a state that is no longer running stays as it is."""
    if state.status != Status.RUNNING:
        return state
    return _panoc_step(F, g, cfg, state)


def panoc_run(F, g, state, cfg: PANOCCfg, steps: int):
    for _ in range(steps):
        state = panoc_step(F, g, state, cfg)
    return state


def warn_if_thrashing(state, who: str = "PANOC", rdot=_rdot) -> bool:
    """After a run: warn, with the remedy, when the line search has been
    thrashing: a sustained average of at least ``THRASH_EVALS`` FBE trials
    a step while the fixed-point residual ‖x − z‖/(1 + ‖x‖) is stalled at
    1e-5 or more (a narrow row storage's accuracy floor; a run ground past
    its f32 optimum sits at the ulp and is benign). Three scalars cross
    to the host; under TP the norms are of the whole vectors (``rdot``)."""
    d = (state.x - state.z).reshape(-1)
    x = state.x.reshape(-1)
    gauge, nd, nx = torch.stack([
        state.ls_ewma.to(torch.float64),
        torch.sqrt(rdot(d, d)).to(torch.float64),
        torch.sqrt(rdot(x, x)).to(torch.float64)]).tolist()
    rrel = nd / (1.0 + nx)
    thrashing = gauge >= THRASH_EVALS and rrel >= 1e-5
    if thrashing:
        warnings.warn(
            f"{who}: the line search is averaging {gauge:.1f} FBE "
            "evaluations per step (healthy steady state is ~1) while "
            f"the fixed-point residual is stalled at {rrel:.1e} "
            "relative — typically the iterate is at a narrow row "
            "storage's accuracy floor, where the σ-decrease test "
            "cannot resolve quantization noise (remedy: switch the "
            "oracle rows to f32 via oracle.with_storage('f32') and "
            "start again from the iterate); with f32 rows, check γ — a "
            "stepsize violating the forward-backward decrease forces the "
            "τ→0 fallback every step.")
    return thrashing


@dataclasses.dataclass(frozen=True)
class PANOC:
    """L-BFGS-accelerated forward-backward facade.

    ``maxit`` counts iterations (each 1 + line-search trials passes; τ = 1
    is usually accepted after the first few, so about 2 passes a step).
    ``tol`` (on ‖x − z‖/γ) stops early when set. ``adaptive`` halves γ
    until the descent lemma holds (the ring flushes and σ rescales on a
    change; 60 halvings give Status.GAMMA_UNDERFLOW); it is on when
    neither γ nor L is given, γ₀ then from a one-time finite-difference
    probe. ``device`` is where the run happens (default: x0's device for
    a tensor x0, else the card when there is one); on the card every FBE
    evaluation is one launch of kernel #7 when its gate is open."""

    gamma: Optional[float] = None
    alpha: float = 0.95   # γ = α/L_f when γ is not given
    beta: float = 0.5     # σ = β(1−γL_f)/(2γ)
    maxit: int = 100
    tol: Optional[float] = None
    mem: int = 5
    max_ls: int = 10
    verbose: bool = False
    freq: int = 10
    zerofpr: bool = False
    fused_precision: str = "highest"  # "default" = bf16 operands, f32 sums
    adaptive: bool = False
    device: Optional[str] = None

    def __post_init__(self):
        if self.gamma is not None and not self.gamma > 0:
            raise ValueError(f"gamma must be positive, not {self.gamma}")
        if not (0 < self.alpha < 1 and 0 < self.beta < 1):
            raise ValueError("alpha and beta must lie in (0, 1)")
        if self.maxit < 1 or self.freq < 1:
            raise ValueError("maxit and freq must be at least 1")
        if self.mem < 1 or self.max_ls < 1:
            raise ValueError("mem and max_ls must be at least 1")
        if self.tol is not None and not self.tol > 0:
            raise ValueError(f"tol must be positive, not {self.tol}")
        if self.fused_precision not in ("highest", "default"):
            raise ValueError(f"fused_precision must be 'highest' or "
                             f"'default', not {self.fused_precision!r}")

    def _setup(self, x0, F, g, L, N):
        from ciao_tpu_torch.ops.fused_block import full_grad_available

        device = facade_device(self.device, x0)
        x0 = torch.as_tensor(x0, device=device)
        F, g, N = default_terms(F, g, N, device)
        rdt = real_dtype_of(x0)
        adaptive = self.adaptive or (self.gamma is None and L is None)
        if self.gamma is not None:
            gamma = torch.as_tensor(self.gamma, dtype=rdt, device=device)
            if L is not None:
                Lf = torch.mean(torch.as_tensor(L, dtype=rdt, device=device))
                sigma = self.beta * torch.clamp(1.0 - gamma * Lf, min=0.05) \
                    / (2.0 * gamma)
            else:
                # unknown L: a conservative σ, as if γ ≈ α/L_f
                sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        elif L is not None:
            Lf = torch.mean(torch.as_tensor(L, dtype=rdt, device=device))
            gamma = rdiv(self.alpha, Lf)
            sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        else:
            # adaptive start: the one-time probe (two gradient passes),
            # then the in-step backtracking owns γ
            gamma = _probe_gamma(F, x0, N, self.alpha, rdt)
            sigma = rdiv(self.beta * (1.0 - self.alpha), 2.0 * gamma)
        cfg = PANOCCfg(N=N, mem=self.mem, max_ls=self.max_ls,
                       zerofpr=self.zerofpr, tol=self.tol,
                       fused=full_grad_available(F, x0),
                       fused_precision=self.fused_precision,
                       adaptive=adaptive)
        return x0, F, g, cfg, lambda: panoc_init(F, g, x0, gamma, sigma, cfg)

    def __call__(self, x0, F=None, g=None, L=None, N=None, observe=None):
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)

        def run_chunk(state, k):
            return panoc_run(F, g, state, cfg, k)

        def disp(it, state):
            print(f"{it:5d} | {float(state.gamma):.3e} | "
                  f"τ={float(state.tau):.3f}")

        state, it = run_solver_loop(init, run_chunk, self.maxit, self.verbose,
                                    self.freq, disp, observe)
        warn_if_thrashing(state, type(self).__name__)
        return state.solution, it

    def iterator(self, x0, F=None, g=None, L=None, N=None):
        x0_orig = x0
        x0, F, g, cfg, init = self._setup(x0, F, g, L, N)
        # a full-gradient method: a storage switch self-heals (the next
        # step recomputes everything from x), so rebase is the identity
        return SolverIterable(x0_orig, init,
                              lambda s: panoc_step(F, g, s, cfg),
                              rebase_fn=lambda s: s,
                              can_abort=self.tol is not None or cfg.adaptive)


def ZeroFPR(**kwargs) -> PANOC:
    """ZeroFPR facade, ``PANOC(zerofpr=True)``: the direction lives at the
    forward-backward point xbar (one more pass a step, typically fewer
    steps)."""
    return PANOC(zerofpr=True, **kwargs)
