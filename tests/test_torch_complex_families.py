"""The complex cases of the JAX package's facade tests, on the port.

``tests/test_fb.py:72``, ``tests/test_katyusha.py:121,231``,
``tests/test_lsvrg.py:118``, ``tests/test_sarah.py:121``,
``tests/test_panoc.py:124``, ``tests/test_point_saga.py:116`` and
``tests/test_primal_dual.py:244`` at their bars (``make_lasso``'s real
data cast to c128, as JAX's tests take it); every family again on truly
complex rows (``_complex_lasso`` of ``tests/test_torch_complex.py``),
PANOC and ZeroFPR there against JAX's iterates; and the three facades
JAX has no complex test for (SSNM, Davis-Yin, ProShI), whose JAX runs
converge on c128 rows, held to those runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciao_tpu
from ciao_tpu_torch import (
    ChambollePock, CondatVu, DavisYin, FISTA, Katyusha, LKatyusha, LSVRG,
    PANOC, PointSAGA, Proshi, SARAH, SSNM, ZeroFPR,
)
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1, SqrDistPoint
from ciao_tpu_torch.utils.problems import make_lasso
from test_torch_complex import _close, _cost, _pair, _t
from torch_threads import one_torch_thread  # noqa: F401

C128 = torch.complex128


# ---------------------------------------------------------------------------
# the complex cases of the JAX package's other tests
# ---------------------------------------------------------------------------

def _planted_c128(N=64, n=8):
    prob = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), float(N))
    return prob, F, NormL1(prob.lam), torch.zeros(n, dtype=C128)


def test_fb_and_facades_complex_dtype():
    """tests/test_fb.py:72 (FISTA, 400 steps), tests/test_katyusha.py:121
    (40 outer steps), tests/test_sarah.py:121 (40) and
    tests/test_lsvrg.py:118 (4,000): dtype kept, cost − f* < 1e-4."""
    prob, F, g, x0 = _planted_c128()
    for S in (FISTA(maxit=400), Katyusha(maxit=40), SARAH(maxit=40),
              LSVRG(maxit=4000)):
        x, _ = S(x0, F=F, g=g, L=prob.L, N=64)
        assert x.dtype == C128
        assert prob.cost(x.numpy()) - prob.f_star < 1e-4, type(S).__name__


def test_beyond_reference_families_complex_dtype():
    """tests/test_katyusha.py:231: each family to 1e-8 on the c128
    planted Lasso, and Point-SAGA (γ = 10/L_max, 20,000 steps) to the
    least-squares solution within 1e-8."""
    prob, F, g, x0 = _planted_c128()
    for S in (Katyusha(maxit=300), SARAH(maxit=300), LSVRG(maxit=8000),
              LKatyusha(maxit=8000), FISTA(maxit=3000)):
        x, _ = S(x0, F=F, g=g, L=prob.L)
        assert x.dtype == C128
        assert prob.cost(x.numpy()) - prob.f_star < 1e-8, type(S).__name__
    xp, _ = PointSAGA(maxit=20000, gamma=10.0 / float(np.max(prob.L)))(
        x0, F=F, L=prob.L)
    xs, *_ = np.linalg.lstsq(prob.A, prob.b, rcond=None)
    assert xp.dtype == C128
    assert float(np.max(np.abs(xp.numpy() - xs))) < 1e-8


@pytest.mark.parametrize("solver", [
    Katyusha(maxit=60), SARAH(maxit=60), LSVRG(maxit=8000),
    FISTA(maxit=1000), PANOC(maxit=80), ZeroFPR(maxit=80),
    SSNM(maxit=2000, batch=8), DavisYin(maxit=1000), CondatVu(maxit=1000)],
    ids=["katyusha", "sarah", "lsvrg", "fista", "panoc", "zerofpr", "ssnm",
         "davisyin", "condatvu"])
def test_facades_on_truly_complex_rows(solver):
    """Each family on ``_complex_lasso``'s rows, whose imaginary parts make
    every conjugate count: cost − f* < 1e-8 with the dtype kept."""
    (A, b, xs, fs, L, lam), _, F, _, g = _pair()
    x, _ = solver(torch.zeros(8, dtype=C128), F=F, g=g, L=L, N=64)
    assert x.dtype == C128
    assert _cost(A, b, lam, x.numpy()) - fs < 1e-8


def test_panoc_complex_dtype():
    """tests/test_panoc.py:124: PANOC and ZeroFPR, 80 steps, to 1e-10,
    and on truly complex rows with JAX's iterates at 1e-8 (ρ = 1/Re⟨s,
    y⟩: the real 2n-vector's inner products)."""
    prob, F, g, x0 = _planted_c128()
    for S in (PANOC(maxit=80), ZeroFPR(maxit=80)):
        x, _ = S(x0, F=F, g=g, L=prob.L, N=64)
        assert x.dtype == C128
        assert prob.cost(x.numpy()) - prob.f_star < 1e-10
    _, JF, F, jg, g = _pair()
    L = _pair()[0][4]
    for name in ("PANOC", "ZeroFPR"):
        jx, _ = getattr(ciao_tpu, name)(maxit=30)(
            jnp.zeros(8, jnp.complex128), F=JF, g=jg, L=L, N=64)
        x, _ = {"PANOC": PANOC, "ZeroFPR": ZeroFPR}[name](maxit=30)(
            torch.zeros(8, dtype=C128), F=F, g=g, L=L, N=64)
        _close(x.numpy(), jx, 1e-8, 1e-8, name)


def test_point_saga_complex():
    """tests/test_point_saga.py:116's complex half: a consistent complex
    system, 4,000 steps, within 1e-6 of the planted x."""
    N, n = 64, 8
    rng = np.random.default_rng(2)
    Ac = rng.standard_normal((N, n)) + 1j * rng.standard_normal((N, n))
    xc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    Fc = LeastSquaresRows(_t(Ac), _t(Ac @ xc), float(N))
    Lc = float(N) * np.abs(Ac * np.conj(Ac)).sum(axis=1)
    x, _ = PointSAGA(maxit=4000)(torch.zeros(n, dtype=C128), F=Fc, L=Lc,
                                 N=N)
    assert x.dtype == C128
    assert np.linalg.norm(x.numpy() - xc) < 1e-6


def test_chambolle_pock_complex_dtype():
    """tests/test_primal_dual.py:244: the complex soft threshold of b is
    min ½‖x − b‖² + λ‖x‖₁ over ℂ, reached to 1e-8 with the dtype kept."""
    rng = np.random.default_rng(9)
    b_np = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    lam = 0.7
    g = SqrDistPoint(_t(b_np), 1.0)
    x, _ = ChambollePock(maxit=3000)(torch.zeros(16, dtype=C128), g=g,
                                     h=NormL1(lam), N=1)
    mag = np.maximum(np.abs(b_np) - lam, 0.0)
    x_star = mag * b_np / np.maximum(np.abs(b_np), 1e-300)
    assert x.dtype == C128
    np.testing.assert_allclose(x.numpy(), x_star, rtol=0, atol=1e-8)


@pytest.mark.parametrize("facade", ["SSNM", "DavisYin", "Proshi"])
def test_facades_without_a_jax_complex_test_match_jax(facade):
    """JAX has no complex test of SSNM, Davis-Yin or ProShI, and its
    facades converge on c128 rows: the port's runs equal JAX's (Davis-Yin
    with h = 0.05‖·‖₁, JAX's IndBox clips no complex value; ProShI's
    cyclic sweep; SSNM's draws are the port's own, so it is held to the
    optimum both reach)."""
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    z0 = jnp.zeros(8, jnp.complex128)
    x0 = torch.zeros(8, dtype=C128)
    if facade == "SSNM":
        jx, _ = ciao_tpu.SSNM(maxit=4000, batch=8)(z0, F=JF, g=jg, L=L)
        x, _ = SSNM(maxit=4000, batch=8)(x0, F=F, g=g, L=L)
        assert _cost(A, b, lam, np.asarray(jx)) - fs < 1e-8
        _close(x.numpy(), jx, 1e-8, 1e-8)
    elif facade == "DavisYin":
        kw = dict(maxit=300)
        jx, _ = ciao_tpu.DavisYin(**kw)(
            z0, F=JF, g=jg, h=ciao_tpu.prox.NormL1(lam=jnp.asarray(0.05)),
            L=L, N=64)
        x, _ = DavisYin(**kw)(x0, F=F, g=g, h=NormL1(0.05), L=L, N=64)
        _close(x.numpy(), jx, 1e-10, 1e-10)
    else:
        kw = dict(maxit=200, sweeping=2, minibatch=(True, 8))
        jZ, _ = ciao_tpu.Proshi(**kw)(z0, F=JF, g=jg, L=L, N=64)
        Z, _ = Proshi(**kw)(x0, F=F, g=g, L=L, N=64)
        assert Z.dtype == C128
        _close(Z.numpy(), jZ, 1e-10, 1e-10)
    assert x0.dtype == C128
