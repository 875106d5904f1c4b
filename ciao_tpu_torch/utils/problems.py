"""Synthetic problems with planted optima (numpy only).

A copy of ``LassoProblem``/``make_lasso``, of ``LogisticProblem``/
``make_logistic_l1`` and of the sharing problems
``make_sharing``/``make_sharing_planted`` from
``ciao_tpu/utils/problems.py``: importing that module runs
``ciao_tpu/__init__`` and so imports JAX, which the port must not. The
construction is the same numpy code, so both packages draw bit-identical
problems from one seed (reference ``test/test_lasso.jl:14-47``,
``test/test_logistic_l1.jl:12-29``, ``test/test_sharing.jl:11-28``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
