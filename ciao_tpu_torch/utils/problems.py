"""Synthetic Lasso problem with a planted optimum (numpy only).

A copy of ``LassoProblem`` and ``make_lasso`` from
``ciao_tpu/utils/problems.py``: importing that module runs
``ciao_tpu/__init__`` and so imports JAX, which the port must not. The
construction is the same numpy code, so both packages draw bit-identical
problems from one seed (reference ``test/test_lasso.jl:14-47``).
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
