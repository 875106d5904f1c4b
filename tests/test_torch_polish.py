"""The port's compensated-gradient polish against the JAX package.

``ciao_tpu_torch.solvers.polish`` against ``ciao_tpu.solvers.polish`` on
one planted Lasso made with numpy: the two-sum carry, the chunked mean
gradient and ``fista_polish`` (same x0, η and steps) in f32 and f64, the
power bound, and the guards. Matrix products sum in other orders in the
two libraries: the gradient is held at rtol 2e-5 in f32 (as
tests/test_polish.py holds it against the oracle's own gradient) and
1e-12 in f64, with atols scaled by its largest entry; the polished
iterate at rtol 1e-5 in f32 (FISTA contracts on this κ ≈ 1 basin, so
the rounding does not grow) and 1e-12 in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import polish as jpolish
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers.polish import (
    _two_sum, fista_polish, grad_mean_chunked, lsq_power_lmax, power_lmax,
)
from ciao_tpu_torch.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

N, n = 4096, 64
RTOL = {np.float32: 2e-5, np.float64: 1e-12}


def _lasso(dtype):
    prob = make_lasso(N=N, n=n, p=8, seed=0, dtype=dtype,
                      well_conditioned=True)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N), dtype))
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         torch.tensor(float(N), dtype=torch.from_numpy(
                             prob.A).dtype))
    return prob, JF, F


def test_two_sum_beats_naive_accumulation():
    """One huge partial, then 4095 units: the naive f32 running sum drops
    every unit (2^24 + 1 == 2^24), the compensated carry keeps them."""
    parts = torch.ones(4096)
    parts[0] = 2.0 ** 24
    hi = lo = naive = torch.zeros(())
    for p in parts:
        hi, lo = _two_sum(hi, lo, p)
        naive = naive + p
    comp, exact = float(hi + lo), float(parts.double().sum())
    assert float(naive) == 2.0 ** 24
    assert abs(comp - exact) <= 2.0
    assert abs(comp - exact) < abs(float(naive) - exact) / 1000


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_grad_mean_chunked_matches_jax(dtype):
    prob, JF, F = _lasso(dtype)
    x = (0.1 * np.random.default_rng(1).standard_normal(n)).astype(dtype)
    for chunk in (512, 128):
        want = np.asarray(jpolish.grad_mean_chunked(JF, jnp.asarray(x), chunk))
        got = grad_mean_chunked(F, torch.tensor(x), chunk)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_fista_polish_matches_jax(dtype):
    """Twelve steps from one start off the optimum with one η (0.9 over
    the dense λmax; JAX's power bound takes f32 rows only): the iterate
    and the fixed-point residual agree, and the polish reaches the
    planted optimum."""
    prob, JF, F = _lasso(dtype)
    rng = np.random.default_rng(2)
    x0 = (prob.x_star + 0.05 * rng.standard_normal(n)).astype(dtype)
    A = np.asarray(prob.A, np.float64)
    eta = 0.9 / float(np.linalg.eigvalsh(A.T @ A).max())
    want = jpolish.fista_polish(JF, JNormL1(lam=jnp.asarray(prob.lam, dtype)),
                                jnp.asarray(x0), eta, steps=12, chunk=512)
    got = fista_polish(F, NormL1(torch.tensor(prob.lam, dtype=F.b.dtype)),
                       torch.tensor(x0), eta, steps=12, chunk=512)
    rtol = {np.float32: 1e-5, np.float64: 1e-12}[dtype]
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=rtol,
                               atol=rtol * np.abs(prob.x_star).max())
    np.testing.assert_allclose(float(got.fp_res), float(want.fp_res),
                               rtol=1e-2 if dtype == np.float32 else 1e-9)
    res = fista_polish(F, NormL1(torch.tensor(prob.lam, dtype=F.b.dtype)),
                       got.x, eta, steps=200, chunk=512)
    assert prob.cost(res.x.double().numpy()) - prob.f_star < 1e-5


def test_power_lmax_bounds():
    """The power bound of the mean Hessian AᵀA (scale/N = 1): within
    [0.8, 1.02] of the dense f64 λmax at 8 iterations, within 1 % of
    JAX's once both have converged (128 iterations: their start vectors
    differ, and the top eigenvalues here are 3 % apart, so at 8
    iterations the two estimates differ by a few %), the same at any
    anchor for least squares, and a pure function of the seed."""
    prob, JF, F = _lasso(np.float32)
    A = np.asarray(prob.A, np.float64)
    lam_true = float(np.linalg.eigvalsh(A.T @ A).max())
    lam = float(lsq_power_lmax(F, 3, iters=8))
    assert 0.8 * lam_true <= lam <= 1.02 * lam_true
    lam_j = float(jpolish.lsq_power_lmax(JF, jax.random.PRNGKey(3),
                                         iters=128))
    lam_c = float(lsq_power_lmax(F, 3, iters=128))
    assert abs(lam_c - lam_j) <= 0.01 * lam_j
    x = torch.tensor(prob.x_star, dtype=torch.float32)
    assert float(power_lmax(F, x, 3, iters=8)) == lam
    assert float(lsq_power_lmax(F, 3, iters=8)) == lam
    assert float(lsq_power_lmax(F, 4, iters=8)) != lam


def test_polish_guards():
    """int8 rows define another operator: every entry point refuses them;
    the chunk must divide N."""
    prob, JF, F = _lasso(np.float32)
    F8 = F.with_storage("int8")
    x = torch.zeros(n)
    g = NormL1(prob.lam)
    with pytest.raises(ValueError, match="int8"):
        grad_mean_chunked(F8, x, 512)
    with pytest.raises(ValueError, match="int8"):
        fista_polish(F8, g, x, 1e-3, steps=1, chunk=512)
    with pytest.raises(ValueError, match="int8"):
        power_lmax(F8, x, 0)
    with pytest.raises(ValueError, match="int8"):
        lsq_power_lmax(F8, 0)
    with pytest.raises(ValueError, match="divide"):
        grad_mean_chunked(F, x, 1000)
