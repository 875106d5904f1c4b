"""Synthetic problems with planted optima (numpy only).

A copy of ``LassoProblem``/``make_lasso``, of ``LogisticProblem``/
``make_logistic_l1``, of the sharing problems
``make_sharing``/``make_sharing_planted`` and of the primal-dual plants
``make_fused_lasso_planted``/``make_three_term_planted`` from
``ciao_tpu/utils/problems.py``: importing that module runs
``ciao_tpu/__init__`` and so imports JAX, which the port must not. The
construction is the same numpy code, so both packages draw bit-identical
problems from one seed (reference ``test/test_lasso.jl:14-47``,
``test/test_logistic_l1.jl:12-29``, ``test/test_sharing.jl:11-28``).

The planted sparse Lasso (:func:`make_sparse_lasso_ell`) follows the JAX
package's recipe step by step but is built with torch on the device,
from a ``torch.Generator`` seeded with ``seed``: its draws are the port's
own, so the two packages plant different problems of the same kind.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LassoProblem(NamedTuple):
    A: np.ndarray        # (N, n)
    b: np.ndarray        # (N,)
    lam: float
    x_star: np.ndarray   # planted solution
    f_star: float        # exact optimal cost
    L: np.ndarray        # (N,) per-row Lipschitz moduli (× N scaling)

    def cost(self, x):
        x = np.asarray(x)
        r = self.A @ x - self.b
        return 0.5 * float(np.real(np.vdot(r, r))) + self.lam * float(
            np.sum(np.abs(x))
        )


def make_lasso(N=6, n=3, p=2, lam=1.0, rho=10.0, seed=0, dtype=np.float64,
               well_conditioned=False):
    """Plant a p-sparse Lasso solution via the KKT conditions.

    Construction (test_lasso.jl:18-42): draw a unit dual vector y*,
    rescale the columns of a random matrix so |A_j^T y*| = λ on the
    support and ≤ λ off it, set x* on the support with matching signs,
    then b = A x* + y*. The optimality conditions hold exactly, so
    f* = cost(x*) needs no reference solver.

    ``well_conditioned=True`` caps every column scale at the largest
    on-support scale (KKT still holds: smaller α_j only shrinks
    |A_j^T y*| below λ). The reference recipe divides by the SMALLEST
    |C_j^T y*| values off-support, which at large n plants columns
    1000× bigger than the rest — κ(AᵀA) explodes and incremental
    methods at reference-default stepsizes stall (~0.1 %/epoch). The
    capped variant keeps the column-norm spread ≲1.5× so convergence
    behaviour, not conditioning, is what a benchmark measures.
    """
    rng = np.random.default_rng(seed)
    rdt = np.zeros((), dtype).real.dtype
    complex_out = np.issubdtype(dtype, np.complexfloating)

    y = rng.random(N).astype(rdt)
    y /= np.linalg.norm(y)
    C = (rng.random((N, n)).astype(rdt) * 2 - 1)
    CTy = np.abs(C.T @ y)
    perm = np.argsort(-CTy)  # decreasing

    alpha = np.zeros(n, rdt)
    if well_conditioned:
        cap = lam / CTy[perm[p - 1]]      # largest on-support scale
        alpha[:] = np.minimum(lam / CTy, cap)
    else:
        for k in range(n):
            j = perm[k]
            if k < p:
                alpha[j] = lam / CTy[j]
            else:
                alpha[j] = (
                    lam if CTy[j] < 0.1 * lam else lam * rng.random() / CTy[j]
                )
    A = C * alpha[None, :]

    x_star = np.zeros(n, rdt)
    for k in range(p):
        j = perm[k]
        x_star[j] = rng.random() * rho / np.sqrt(p) * np.sign(A[:, j] @ y)
    b = A @ x_star + y

    L = (np.sum(np.abs(A) ** 2, axis=1) * N).astype(rdt)  # opnorm(row)^2 * N

    if complex_out:
        A = A.astype(dtype)
        b = b.astype(dtype)
        x_star = x_star.astype(dtype)

    prob = LassoProblem(A=A, b=b, lam=float(lam), x_star=x_star, f_star=0.0, L=L)
    return prob._replace(f_star=prob.cost(x_star))


class LogisticProblem(NamedTuple):
    X: np.ndarray
    y: np.ndarray
    lam: float
    x_star: np.ndarray
    L: np.ndarray

    def cost(self, x):
        x = np.asarray(x)
        t = -self.y * (self.X @ x)
        return float(
            np.sum(np.logaddexp(0.0, t)) / len(self.y)
            + self.lam * np.sum(np.abs(x))
        )


def make_logistic_l1():
    """The reference's fixed 8-sample, 5-feature problem
    (test_logistic_l1.jl:12-29) with its hardcoded optimum."""
    x_class1 = np.array(
        [
            [5.1, 3.5, 1.4, 0.2, 1.0],
            [4.9, 3.0, 1.4, 0.2, 1.0],
            [4.7, 3.2, 1.3, 0.2, 1.0],
            [4.6, 3.1, 1.5, 0.2, 1.0],
        ]
    )
    x_class2 = np.array(
        [
            [5.7, 3.0, 4.2, 1.2, 1.0],
            [5.7, 2.9, 4.2, 1.3, 1.0],
            [6.2, 2.9, 4.3, 1.3, 1.0],
            [5.1, 2.5, 3.0, 1.1, 1.0],
        ]
    )
    X = np.vstack([x_class1, x_class2])
    y = np.concatenate([np.ones(4), -np.ones(4)])
    x_star = np.array([0.0, 0.924160995722576, -1.1343956493097298, 0.0, 0.0])
    N = len(y)
    L = 0.25 * np.sum(X**2, axis=1)
    return LogisticProblem(X=X, y=y, lam=1.0 / N, x_star=x_star, L=L)


class SharingProblem(NamedTuple):
    d: np.ndarray        # (N, n) quadratic diagonals
    q: np.ndarray        # (N, n) linear terms
    eta: float
    box_lo: float
    box_hi: float
    g_hi: np.ndarray     # upper bound for g = IndBox(-inf, g_hi) on Σ x_i
    sum_star: np.ndarray
    L: np.ndarray


def make_sharing():
    """The reference's sharing problem (test_sharing.jl:11-28).

    Behavioral parity note: the reference computes L_i as
    ``opnorm(Q[i]) + η`` where ``Q[i]`` is a scalar LINEAR index into the
    matrix (almost certainly a typo for Q), yielding L = [|d_1[0]|+η, 0+η,
    0+η] = [31, 30, 30]. We reproduce the values actually used.
    """
    n, N = 2, 3
    eta = N * 10.0
    d = np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]])
    q = np.ones((N, n))
    # Q[i] linear-index quirk: Q1[1,1]=1, Q2[2,1]=0, Q3[1,2]=0 (1-based cols)
    L = np.array([abs(d[0, 0]) + eta, 0.0 + eta, 0.0 + eta])
    sum_star = np.array([-5.136781609195401, -0.9333333333333327])
    return SharingProblem(
        d=d, q=q, eta=eta, box_lo=-2.0, box_hi=2.0,
        g_hi=np.ones(n), sum_star=sum_star, L=L,
    )


class PlantedSharingProblem(NamedTuple):
    """Any-scale sharing problem with a CLOSED-FORM exact optimum."""

    d: np.ndarray        # (N, n) quadratic diagonals (all > 0), f64
    q: np.ndarray        # (N, n) linear terms, f64
    lam: float           # g = lam * ||.||_1 on the coupling sum
    x_star: np.ndarray   # (N, n) exact block optima, f64
    u_star: np.ndarray   # (n,) optimal coupling sum (exact zeros off-support)
    v_star: np.ndarray   # (n,) optimal dual (element of lam*d||u*||_1)
    f_star: float        # exact optimal value
    L: np.ndarray        # (N,) block smoothness moduli max_j d_ij

    def cost(self, blocks) -> float:
        """Sharing objective (1/N) Σ f_i(x_i) + λ‖Σ x_i‖₁ at the (N, n)
        block matrix, evaluated in f64."""
        x = np.asarray(blocks, np.float64)
        quad = 0.5 * np.sum(self.d * x * x) + np.sum(self.q * x)
        return quad / self.d.shape[0] + self.lam * np.sum(
            np.abs(x.sum(axis=0)))


def make_sharing_planted(N=4096, n=128, p=None, seed=0):
    """Planted sharing problem at ANY scale (the deep-accuracy analog of
    :func:`make_lasso` for the sharing formulation — the reference's
    only sharing instance is the N=3 hardcoded one above,
    ``test/test_sharing.jl:11-28``, and it gets its tolerance from f64
    for free; this gives an exact f* to measure f32 floors against).

        min (1/N) Σ_i [½⟨x_i, d_i ⊙ x_i⟩ + ⟨q_i, x_i⟩] + λ‖Σ_i x_i‖₁

    KKT closes in one soft-threshold: stationarity forces
    ∇f_i(x_i)/1 = −N v with v ∈ λ∂‖u‖₁, so x_i = −(q_i + N v)/d_i and
    per coordinate j the dual is v_j = clip(v0_j, ±λ) with
    v0_j = −(Σ_i q_ij/d_ij)/(N Σ_i 1/d_ij) — on-support coordinates
    (|v0_j| > λ) get u*_j = N S_j (v0_j − λ sign v0_j) whose sign
    matches v_j automatically, off-support get u*_j = 0 exactly.
    λ is placed between the p-th and (p+1)-th largest |v0| so the
    support size is exactly ``p`` (default n//8). d ∈ [1, 2] keeps every
    block well-conditioned; q carries a shared per-coordinate mean so
    the coupling term is a material fraction of the objective.
    Everything is computed and returned in f64."""
    if p is None:
        p = max(1, n // 8)
    assert 0 < p < n
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 2.0, size=(N, n))
    mu = rng.standard_normal(n)
    q = mu[None, :] + rng.standard_normal((N, n))

    S = np.sum(1.0 / d, axis=0)                   # (n,)
    Q = np.sum(q / d, axis=0)                     # (n,)
    v0 = -Q / (N * S)
    mags = np.sort(np.abs(v0))[::-1]
    lam = float(0.5 * (mags[p - 1] + mags[p]))    # support = top-p of |v0|
    v = np.clip(v0, -lam, lam)
    x_star = -(q + N * v[None, :]) / d
    u_star = N * S * (v0 - v)                     # exact zeros off-support
    f_star = float(
        (0.5 * np.sum(d * x_star * x_star) + np.sum(q * x_star)) / N
        + lam * np.sum(np.abs(u_star))
    )
    return PlantedSharingProblem(
        d=d, q=q, lam=lam, x_star=x_star, u_star=u_star, v_star=v,
        f_star=f_star, L=np.max(d, axis=1),
    )


class SparseLassoProblem(NamedTuple):
    """Planted power-law sparse Lasso (rcv1-style): the same operator in
    both sparse layouts, with the exact optimum known by construction.
    Built on the device (:func:`make_sparse_lasso_ell`)."""

    ell: object          # SparseLeastSquaresELL     (pure-ELL layout)
    hybrid: object       # HybridSparseLeastSquares  (hot/cold layout)
    lam: float
    x_star: torch.Tensor  # (n,) on the device
    f_star: float        # exact optimal cost ½‖y*‖² + λ‖x*‖₁
    L: torch.Tensor      # (N,) per-row moduli (× N scaling) on the device


def nan_median_nearest(v):
    """The median of ``v``'s non-NaN entries as JAX's
    ``jnp.nanquantile(v, 0.5, method="nearest")`` takes it: at the half
    index of an even count it is the lower of the two middle entries,
    where numpy's and torch's "nearest" round the index half to even. At
    q = 0.5 the index's fraction is 0 or ½, so torch's "lower" is JAX's
    rule. torch's quantiles take at most 2^24 entries (the rcv1 shape's
    65,536 columns are well inside)."""
    return torch.nanquantile(v, 0.5, interpolation="lower")


def make_sparse_lasso_ell(N=4096, n=4096, *, hot=256, k_hot=12, k_cold=4,
                          p=32, lam=1.0, rho=10.0, beta=1.1, seed=0,
                          device=None) -> SparseLassoProblem:
    """Plant a p-sparse Lasso on a power-law sparse design, returned in
    both sparse layouts (pure ELL and hot/cold hybrid) over the same
    operator; ``ciao_tpu/utils/problems.py``'s recipe, with torch on
    ``device`` (default: the card when there is one) and the port's own
    draws from ``seed``.

    Each row draws ``k_hot`` entries from the hot columns [0, hot) and
    ``k_cold`` from the cold tail [hot, n), both with (j+1)^-beta
    popularity; cold duplicates within a row are zeroed, the first kept,
    so the cold ‖·‖² is exact (hot duplicates merge additively: the
    hybrid's dense block merges them, ELL keeps the raw slots, and the
    operator is the same). A unit dual y* gives the signed column
    correlations s = Aᵀy*. Column-norm equalisation: the KKT scale
    α_j = λ/|s_j| forces a support column's norm to r_j = λ·ν_j/|s_j|
    (ν the raw column norm); the support is the p columns whose r_j lies
    closest above t, the median of r, and every other column takes
    α_j = min(0.95·λ/|s_j|, 0.8·t/ν_j): a strict dual slack, so that no
    column is near-active. x* lives on the support with the signs of s,
    b = A x* + y*, and the KKT conditions hold exactly:
    f* = ½‖y*‖² + λ‖x*‖₁. ``L`` is each row's ‖a_i‖² × N, of the merged
    hot entries. The hot block is lane-padded to
    ``max(128, ⌈hot/128⌉·128)`` columns, ``hot_cols`` its column ids."""
    from ciao_tpu_torch import runtime
    from ciao_tpu_torch.oracles.sparse import (
        HybridSparseLeastSquares, SparseLeastSquaresELL,
    )

    dev = torch.device(runtime.default_device() if device is None
                       else device)
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f32)

    hot_pad = max(128, -(-hot // 128) * 128)
    wj = (torch.arange(n, dtype=f32, device=dev) + 1.0) ** (-beta)
    cdf_h = torch.cumsum(wj[:hot], 0)
    cdf_h = cdf_h / cdf_h[-1]
    cdf_c = torch.cumsum(wj[hot:], 0)
    cdf_c = cdf_c / cdf_c[-1]
    hot_idx = torch.searchsorted(cdf_h, uniform(N, k_hot), right=True)
    cold_idx = hot + torch.searchsorted(cdf_c, uniform(N, k_cold),
                                        right=True)
    # a cold slot is a duplicate when an earlier slot of its row holds the
    # same column (N × k_cold × k_cold bools: 128 MiB at 524,288 × 16)
    earlier = cold_idx[:, :, None] == cold_idx[:, None, :]
    tri = torch.tril(torch.ones(k_cold, k_cold, dtype=torch.bool,
                                device=dev), -1)
    is_dup = torch.any(earlier & tri, dim=2)
    del earlier
    hot_val = uniform(N, k_hot) * 2 - 1
    cold_val = (uniform(N, k_cold) * 2 - 1) * (~is_dup)
    y = uniform(N)
    y = y / torch.sqrt(torch.dot(y, y))

    def scatter(h, c):
        """Σ over each column's slots (a scatter-add; duplicates merge)."""
        out = torch.zeros(n, dtype=f32, device=dev)
        out.index_add_(0, hot_idx.reshape(-1), h.reshape(-1))
        return out.index_add_(0, cold_idx.reshape(-1), c.reshape(-1))

    s = scatter(y[:, None] * hot_val, y[:, None] * cold_val)
    c = s.abs()
    nu = torch.sqrt(scatter(hot_val * hot_val, cold_val * cold_val))
    r = lam * nu / torch.clamp(c, min=1e-30)     # forced support norm
    r = torch.where(nu > 0, r, torch.inf)
    t = nan_median_nearest(torch.where(torch.isfinite(r), r, torch.nan))
    key_rank = torch.where(r >= t, r - t, torch.inf)
    kth = torch.sort(key_rank).values[p - 1]
    supp = key_rank <= kth
    alpha = torch.where(
        supp, lam / torch.clamp(c, min=1e-30),
        torch.minimum(0.95 * lam / torch.clamp(c, min=1e-30),
                      0.8 * t / torch.clamp(nu, min=1e-30)))
    hot_val = hot_val * alpha[hot_idx]
    cold_val = cold_val * alpha[cold_idx]
    xs = torch.where(supp, uniform(n) * np.float32(rho / np.sqrt(p))
                     * torch.sign(s), 0.0)
    m = (torch.sum(hot_val * xs[hot_idx], dim=1)
         + torch.sum(cold_val * xs[cold_idx], dim=1))
    b = m + y
    # the merged hot block (the hybrid layout's dense part)
    A_hot = torch.zeros(N, hot_pad, dtype=f32, device=dev)
    rows = torch.arange(N, device=dev)[:, None].expand(N, k_hot)
    A_hot.index_put_((rows, hot_idx), hot_val, accumulate=True)
    L = (torch.sum(A_hot * A_hot, dim=1)
         + torch.sum(cold_val * cold_val, dim=1)) * N

    scale = torch.tensor(float(N), dtype=f32, device=dev)
    ell = SparseLeastSquaresELL(
        torch.cat([hot_idx, cold_idx], dim=1).to(torch.int32),
        torch.cat([hot_val, cold_val], dim=1), b, scale, n)
    hybrid = HybridSparseLeastSquares(
        A_hot, torch.arange(hot_pad, dtype=torch.int32, device=dev),
        cold_idx.to(torch.int32), cold_val, b, scale, n)
    xs64 = xs.double()
    y64 = y.double()
    f_star = 0.5 * float(y64 @ y64) + lam * float(xs64.abs().sum())
    return SparseLassoProblem(ell=ell, hybrid=hybrid, lam=float(lam),
                              x_star=xs, f_star=f_star, L=L)


class PlantedFusedLassoProblem(NamedTuple):
    """Any-scale fused lasso (1-D analysis sparsity) with a CLOSED-FORM
    exact optimum — the deep-accuracy instance for the primal-dual
    class (Condat-Vũ / Chambolle-Pock), which the prox-of-g-only
    reference cannot express at all."""

    A: np.ndarray        # (N, n) design, f64
    b: np.ndarray        # (N,)
    lam: float           # h = lam * ||.||_1 on Dx (D = FirstDifference)
    x_star: np.ndarray   # (n,) exact optimum (piecewise constant)
    v_star: np.ndarray   # (n-1,) optimal dual, |v| <= lam, interior off-jump
    f_star: float        # exact optimal value
    L: np.ndarray        # (N,) per-row moduli x N (the library convention)

    def cost(self, x) -> float:
        """½‖Ax − b‖² + λ‖Dx‖₁ in f64 (the un-normalized quadratic —
        same convention as :class:`LassoProblem`)."""
        x = np.asarray(x, np.float64)
        r = self.A @ x - self.b
        return float(0.5 * np.dot(r, r) + self.lam * np.sum(np.abs(np.diff(x))))


def make_fused_lasso_planted(N=4096, n=256, jumps=None, lam=1.0, rho=5.0,
                             seed=0):
    """Plant the EXACT optimum of  ½‖Ax−b‖² + λ‖Dx‖₁  ((Dx)_i =
    x_{i+1}−x_i) at ANY (N, n) scale via a RANK-ONE dual correction.

    Stationarity needs  Aᵀ(Ax*−b) + Dᵀv = 0  with v ∈ λ∂‖Dx*‖₁. Draw a
    unit residual y*, set b = Ax* + y* so the condition becomes
    Aᵀy* = Dᵀv, and ENFORCE it exactly with a rank-1 update of a raw
    unit-uniform design C:

        A = C + y*·cᵀ,   c = Dᵀv − Cᵀy*       (‖y*‖ = 1)

    — unlike the column-rescaling trick of :func:`make_lasso` (which
    here would divide by near-zero entries of Dᵀv and destroy the
    conditioning), the rank-1 correction perturbs each column by O(1)
    against the O(√N) column norms, so κ(AᵀA) stays that of a random
    design. x* is piecewise constant with ``jumps`` sign-alternating
    levels; v takes λ·sign at the jumps and strictly interior values
    (≤ 0.6λ) on the flat runs, so the optimum is unique and the jump
    set is stable. Everything is computed and returned in f64;
    f* = ½ + λ‖Dx*‖₁ exactly (‖y*‖ = 1)."""
    if jumps is None:
        jumps = max(2, n // 32)
    assert 2 <= jumps + 1 <= n
    rng = np.random.default_rng(seed)

    # piecewise-constant x*: jumps+1 sign-alternating levels
    bounds = np.sort(rng.choice(np.arange(1, n), size=jumps, replace=False))
    levels = rho * (0.5 + rng.random(jumps + 1)) * \
        (-1.0) ** np.arange(jumps + 1)
    x_star = np.repeat(levels, np.diff(np.concatenate(([0], bounds, [n]))))

    d = np.diff(x_star)
    v = rng.uniform(-0.6, 0.6, n - 1) * lam      # interior on flat runs
    jump_mask = d != 0
    v[jump_mask] = lam * np.sign(d[jump_mask])

    Dt_v = np.zeros(n)
    Dt_v[:-1] -= v
    Dt_v[1:] += v

    y = rng.standard_normal(N)
    y /= np.linalg.norm(y)
    C = rng.uniform(-1.0, 1.0, (N, n))
    A = C + np.outer(y, Dt_v - C.T @ y)          # Aᵀy* = Dᵀv exactly
    b = A @ x_star + y

    f_star = 0.5 + lam * float(np.sum(np.abs(d)))
    L = np.sum(A * A, axis=1) * N                # row moduli x N
    return PlantedFusedLassoProblem(
        A=A, b=b, lam=float(lam), x_star=x_star, v_star=v,
        f_star=f_star, L=L,
    )


class PlantedThreeTermProblem(NamedTuple):
    """Any-scale THREE-TERM fused lasso with a closed-form optimum:
    ½‖Ax−b‖² + λ₁‖x‖₁ + λ₂‖Dx‖₁ (sparse AND piecewise-constant)."""

    A: np.ndarray
    b: np.ndarray
    lam1: float          # ℓ1 weight on x
    lam2: float          # ℓ1 weight on Dx
    x_star: np.ndarray   # piecewise constant WITH exact-zero segments
    u_star: np.ndarray   # (n,) ℓ1 dual, |u| ≤ λ₁, interior on zeros
    v_star: np.ndarray   # (n-1,) TV dual, |v| ≤ λ₂, interior off-jump
    f_star: float
    L: np.ndarray

    def cost(self, x) -> float:
        x = np.asarray(x, np.float64)
        r = self.A @ x - self.b
        return float(0.5 * np.dot(r, r) + self.lam1 * np.sum(np.abs(x))
                     + self.lam2 * np.sum(np.abs(np.diff(x))))


def make_three_term_planted(N=4096, n=256, jumps=None, lam1=0.5, lam2=1.0,
                            rho=5.0, seed=0):
    """Plant the exact optimum of the THREE-TERM objective by the same
    rank-1 dual correction as :func:`make_fused_lasso_planted`, with
    TWO multipliers: stationarity needs ``Aᵀy* = u + Dᵀv`` where
    u ∈ λ₁∂‖x*‖₁ (λ₁·sign on the support, interior ≤ 0.6λ₁ on the
    zero segments) and v ∈ λ₂∂‖Dx*‖₁ (λ₂·sign at jumps, interior
    ≤ 0.6λ₂ on flat runs). Every third segment is pinned EXACTLY zero
    so both structures are non-trivial. Everything f64;
    f* = ½ + λ₁‖x*‖₁ + λ₂‖Dx*‖₁ exactly."""
    if jumps is None:
        jumps = max(3, n // 32)
    assert 3 <= jumps + 1 <= n
    rng = np.random.default_rng(seed)

    bounds = np.sort(rng.choice(np.arange(1, n), size=jumps, replace=False))
    widths = np.diff(np.concatenate(([0], bounds, [n])))
    levels = rho * (0.5 + rng.random(jumps + 1)) * \
        (-1.0) ** np.arange(jumps + 1)
    levels[::3] = 0.0                       # exact-zero segments
    # a zero level between same-sign neighbors still jumps; but two
    # ADJACENT zeros would merge — the ::3 pattern never does that
    x_star = np.repeat(levels, widths)

    d = np.diff(x_star)
    v = rng.uniform(-0.6, 0.6, n - 1) * lam2
    jm = d != 0
    v[jm] = lam2 * np.sign(d[jm])
    u = np.where(x_star != 0, lam1 * np.sign(x_star),
                 rng.uniform(-0.6, 0.6, n) * lam1)

    Dt_v = np.zeros(n)
    Dt_v[:-1] -= v
    Dt_v[1:] += v

    y = rng.standard_normal(N)
    y /= np.linalg.norm(y)
    C = rng.uniform(-1.0, 1.0, (N, n))
    A = C + np.outer(y, u + Dt_v - C.T @ y)   # Aᵀy* = u + Dᵀv exactly
    b = A @ x_star + y

    f_star = (0.5 + lam1 * float(np.sum(np.abs(x_star)))
              + lam2 * float(np.sum(np.abs(d))))
    L = np.sum(A * A, axis=1) * N
    return PlantedThreeTermProblem(
        A=A, b=b, lam1=float(lam1), lam2=float(lam2), x_star=x_star,
        u_star=u, v_star=v, f_star=f_star, L=L,
    )
