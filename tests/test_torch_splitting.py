"""The port's splitting methods — Davis-Yin and Douglas-Rachford,
Condat-Vũ and Chambolle-Pock — with the linear maps of ``ops.linmap``, the
conjugate prox and the observer's three-term objective, against the JAX
package on the CPU.

The single-device tests of tests/test_dys.py and tests/test_primal_dual.py
at their sizes and bars (closed forms, the box-constrained Lasso, K = I
equals Davis-Yin, the 1-D TV certificate, the maps' adjoints and norm
bounds), and the trajectories against JAX's in f64 step by step and, on
the fused route (kernel #6's plain version on CPU tensors), at f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciao_tpu
from ciao_tpu.ops import linmap as jlinmap
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import IndBox as JIndBox
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.prox import SqrDistPoint as JSqrDistPoint
from ciao_tpu.solvers import dys as jdys
from ciao_tpu.solvers import primal_dual as jpd
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch import (
    FISTA, ChambollePock, CondatVu, DavisYin, DouglasRachford,
    ForwardBackward, monitor,
)
from ciao_tpu_torch.ops import linmap
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import (
    GroupNormL21, IndBox, NormL1, ProxOperator, SqrDistPoint, Zero,
)
from ciao_tpu_torch.solvers import dys, primal_dual
from ciao_tpu_torch.solvers.base import take
from ciao_tpu_torch.solvers.primal_dual import prox_conjugate
from torch_threads import one_torch_thread  # noqa: F401

N, n = 64, 8
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N)))
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), torch.tensor(float(N)))
    return prob, JF, JNormL1(lam=jnp.asarray(prob.lam)), F, NormL1(
        torch.tensor(prob.lam))


def _x0():
    return torch.zeros(n, dtype=F64)


def _identity_rows(b):
    """½‖x − b‖² as the finite sum (1/n)Σ (n/2)(x_i − b_i)²: identity rows."""
    m = b.shape[0]
    return LeastSquaresRows(torch.eye(m, dtype=F64), _t(b),
                            torch.tensor(float(m), dtype=F64))


# ---------------------------------------------------------------------------
# the conjugate prox and the linear maps
# ---------------------------------------------------------------------------

def test_prox_conjugate_closed_forms():
    """Moreau's identity against closed forms (tests/test_primal_dual.py):
    (λ‖·‖₁)* is the ℓ∞-ball indicator, so prox_{σh*} clips to [−λ, λ] for
    every σ; h = (ρ/2)‖x − b‖² gives the affine (u − σb)/(1 + σ/ρ); the
    box's support function gives u − σ·clip(u/σ, lo, hi); all equal JAX's
    prox_conjugate to 1e-12."""
    u = np.linspace(-3.0, 3.0, 41)
    h = NormL1(0.8)
    for sigma in (0.1, 1.0, 7.3):
        out = prox_conjugate(h, _t(u), torch.tensor(sigma, dtype=F64))
        np.testing.assert_allclose(out.numpy(), np.clip(u, -0.8, 0.8),
                                   rtol=0, atol=1e-12)
    rng = np.random.default_rng(0)
    u, b = rng.standard_normal(16), rng.standard_normal(16)
    out = prox_conjugate(SqrDistPoint(_t(b), 2.3), _t(u),
                         torch.tensor(0.6, dtype=F64))
    np.testing.assert_allclose(out.numpy(), (u - 0.6 * b) / (1 + 0.6 / 2.3),
                               rtol=1e-12, atol=0)
    want = jpd.prox_conjugate(JSqrDistPoint(b=jnp.asarray(b),
                                            rho=jnp.asarray(2.3)),
                              jnp.asarray(u), jnp.asarray(0.6))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-12)
    lo, hi, sigma = -0.5, 2.0, 1.7
    uv = np.array([-3.0, -0.2, 0.0, 1.4, 4.2])
    out = prox_conjugate(IndBox(lo, hi), _t(uv), torch.tensor(sigma,
                                                              dtype=F64))
    np.testing.assert_allclose(out.numpy(),
                               uv - sigma * np.clip(uv / sigma, lo, hi),
                               rtol=0, atol=1e-12)
    want = jpd.prox_conjugate(JIndBox(lo=lo, hi=hi), jnp.asarray(uv),
                              jnp.asarray(sigma))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)


def _dense_tv2d(H, W):
    n_ = H * W
    rows = []
    for i in range(H):
        for j in range(W - 1):
            r = np.zeros(n_)
            r[i * W + j], r[i * W + j + 1] = -1.0, 1.0
            rows.append(r)
    for i in range(H - 1):
        for j in range(W):
            r = np.zeros(n_)
            r[i * W + j], r[(i + 1) * W + j] = -1.0, 1.0
            rows.append(r)
    return np.array(rows)


def _dense_grad2d(H, W):
    n_ = H * W
    M = np.zeros((2 * n_, n_))
    for i in range(H):
        for j in range(W - 1):
            M[i * W + j, i * W + j] = -1.0
            M[i * W + j, i * W + j + 1] = 1.0
    for i in range(H - 1):
        for j in range(W):
            M[n_ + i * W + j, i * W + j] = -1.0
            M[n_ + i * W + j, (i + 1) * W + j] = 1.0
    return M


_MAP_M = np.random.default_rng(1).standard_normal((7, 30))
MAPS = {
    "identity": (lambda: linmap.IdentityMap(), lambda: jlinmap.IdentityMap(),
                 30, np.eye(30)),
    "dense": (lambda: linmap.DenseMap(torch.tensor(_MAP_M)),
              lambda: jlinmap.DenseMap(M=jnp.asarray(_MAP_M)), 30, _MAP_M),
    "first-difference": (lambda: linmap.FirstDifference(),
                         lambda: jlinmap.FirstDifference(), 30,
                         np.diff(np.eye(30), axis=0)),
    "first-difference-2d": (lambda: linmap.FirstDifference2D(5, 6),
                            lambda: jlinmap.FirstDifference2D(H=5, W=6), 30,
                            _dense_tv2d(5, 6)),
    "gradient-2d": (lambda: linmap.GradientMap2D(5, 6),
                    lambda: jlinmap.GradientMap2D(H=5, W=6), 30,
                    _dense_grad2d(5, 6)),
}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("name", list(MAPS))
def test_linmap_matches_jax_and_dense(name, dtype):
    """matvec and rmatvec equal JAX's and the explicit matrix (its
    conjugate transpose for the adjoint) to 1e-12; ⟨Kx, y⟩ = ⟨x, Kᴴy⟩;
    out_dim and opnorm_bound equal JAX's, and the bound holds above the
    spectral norm."""
    make, jmake, n_, M = MAPS[name]
    K, JK = make(), jmake()
    rng = np.random.default_rng(2)

    def rand(m):
        v = rng.standard_normal(m)
        if dtype == np.complex128:
            v = v + 1j * rng.standard_normal(m)
        return v.astype(dtype)

    m = K.out_dim(n_)
    assert m == JK.out_dim(n_) == M.shape[0]
    x, y = rand(n_), rand(m)
    Kx, Kty = K.matvec(_t(x)).numpy(), K.rmatvec(_t(y)).numpy()
    np.testing.assert_allclose(Kx, np.asarray(JK.matvec(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Kty, np.asarray(JK.rmatvec(jnp.asarray(y))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Kx, M @ x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Kty, M.conj().T @ y, rtol=0, atol=1e-12)
    lhs, rhs = np.vdot(y, Kx), np.vdot(Kty, x)
    assert abs(lhs - rhs) < 1e-10 * (1 + abs(lhs))
    assert abs(K.opnorm_bound(n_) - JK.opnorm_bound(n_)) < 1e-8
    assert np.linalg.norm(M, 2) <= K.opnorm_bound(n_) + 1e-12


def test_image_maps_refuse_a_wrong_size():
    with pytest.raises(ValueError, match="n = 30"):
        linmap.FirstDifference2D(5, 6).out_dim(31)
    with pytest.raises(ValueError, match="n = 30"):
        linmap.GradientMap2D(5, 6).out_dim(29)


# ---------------------------------------------------------------------------
# trajectories against JAX
# ---------------------------------------------------------------------------

def test_dys_matches_jax_step_by_step(lasso):
    """``dys_init``/``dys_step`` against JAX's for 20 steps in f64 (z and
    x_g within 1e-12 of their largest entries), g = NormL1, h =
    IndBox(−0.6, 0.6), λ = 1.3."""
    prob, JF, jg, F, g = lasso
    gamma = 1.0 / np.mean(prob.L)
    jcfg, cfg = jdys.DYSCfg(N=N), dys.DYSCfg(N=N)
    jh, h = JIndBox(lo=-0.6, hi=0.6), IndBox(-0.6, 0.6)
    js = jdys.dys_init(JF, jg, jh, jnp.zeros(n), jnp.asarray(gamma),
                       jnp.asarray(1.3), jcfg)
    ts = dys.dys_init(F, g, h, _x0(), torch.tensor(gamma),
                      torch.tensor(1.3, dtype=F64), cfg)
    for k in range(20):
        js = jdys.dys_step(JF, jg, jh, js, jcfg)
        ts = dys.dys_step(F, g, h, ts, cfg)
        for f in ("z", "xg"):
            want = np.asarray(getattr(js, f))
            np.testing.assert_allclose(getattr(ts, f).numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"step {k} {f}")
    assert ts.it == int(js.it) == 21


def test_pd_matches_jax_step_by_step():
    """``pd_init``/``pd_step`` against JAX's for 20 steps in f64 on the
    three-term 1-D TV problem with a smooth term (x and y within 1e-12 of
    their largest entries)."""
    b = np.random.default_rng(3).standard_normal(24)
    JF = JLeastSquaresRows(A=jnp.eye(24), b=jnp.asarray(b),
                           scale=jnp.asarray(24.0))
    F = _identity_rows(b)
    tau, sigma = 0.99 / (12.0 + 0.5 * 4.0), 0.5
    jargs = (JF, JNormL1(lam=jnp.asarray(0.2)), JNormL1(lam=jnp.asarray(0.4)),
             jlinmap.FirstDifference())
    targs = (F, NormL1(0.2), NormL1(0.4), linmap.FirstDifference())
    jcfg, cfg = jpd.PDCfg(N=24), primal_dual.PDCfg(N=24)
    js = jpd.pd_init(*jargs, jnp.zeros(24), jnp.asarray(tau),
                     jnp.asarray(sigma), jcfg)
    ts = primal_dual.pd_init(*targs, torch.zeros(24, dtype=F64),
                             torch.tensor(tau, dtype=F64),
                             torch.tensor(sigma, dtype=F64), cfg)
    for k in range(20):
        js = jpd.pd_step(*jargs, js, jcfg)
        ts = primal_dual.pd_step(*targs, ts, cfg)
        for f in ("x", "y"):
            want = np.asarray(getattr(js, f))
            np.testing.assert_allclose(getattr(ts, f).numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"step {k} {f}")


@pytest.mark.parametrize("method", ["dys", "pd"])
def test_fused_route_matches_jax(method, monkeypatch):
    """The fused route on CPU tensors (kernel #6's plain version) follows
    JAX's two-product trajectory at f32 (tests/test_dys.py's and
    tests/test_primal_dual.py's 512 × 128 Lasso, 20 steps, within rtol
    1e-4, atol 1e-6), and the facades open the route exactly where
    ``full_grad_available`` says."""
    from ciao_tpu_torch.ops import fused_block as tfb

    Np, npix = 512, 128
    prob = make_lasso(N=Np, n=npix, p=4, seed=3, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A, jnp.float32),
                           b=jnp.asarray(prob.b, jnp.float32),
                           scale=jnp.asarray(float(Np), jnp.float32))
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), float(Np))
    lam = np.float32(prob.lam)
    jg, g = JNormL1(lam=jnp.asarray(lam)), NormL1(torch.tensor(lam))
    z0 = torch.zeros(npix)
    launches = tfb.coeff_apply_all.launches
    if method == "dys":
        gamma = np.float32(1.0 / np.mean(prob.L))
        jh, h = JIndBox(lo=-1.0, hi=1.0), IndBox(-1.0, 1.0)
        jcfg = jdys.DYSCfg(N=Np)
        js = jdys.dys_run(JF, jg, jh, jdys.dys_init(
            JF, jg, jh, jnp.zeros(npix, jnp.float32), jnp.asarray(gamma),
            jnp.ones((), jnp.float32), jcfg), jcfg, 20)
        cfg = dys.DYSCfg(N=Np, fused=True)
        ts = dys.dys_run(F, g, h, dys.dys_init(
            F, g, h, z0, torch.tensor(gamma), torch.ones(()), cfg), cfg, 20)
        pairs = (("xg", js.xg, ts.xg), ("z", js.z, ts.z))
        facade = DavisYin()._setup(z0, F, g, h, prob.L, None)[4]
    else:
        jh, h = JNormL1(lam=jnp.asarray(0.05, jnp.float32)), NormL1(0.05)
        jK, K = jlinmap.FirstDifference(), linmap.FirstDifference()
        tau = np.float32(0.99 / (float(np.mean(prob.L)) / 2.0 + 0.5 * 4.0))
        sigma = np.float32(0.5)
        jcfg = jpd.PDCfg(N=Np)
        js = jpd.pd_run(JF, jg, jh, jK, jpd.pd_init(
            JF, jg, jh, jK, jnp.zeros(npix, jnp.float32), jnp.asarray(tau),
            jnp.asarray(sigma), jcfg), jcfg, 20)
        cfg = primal_dual.PDCfg(N=Np, fused=True)
        ts = primal_dual.pd_run(F, g, h, K, primal_dual.pd_init(
            F, g, h, K, z0, torch.tensor(tau), torch.tensor(sigma), cfg),
            cfg, 20)
        pairs = (("x", js.x, ts.x), ("y", js.y, ts.y))
        facade = CondatVu()._setup(z0, F, g, h, K, prob.L, None)[5]
    assert tfb.coeff_apply_all.launches == launches  # plain versions
    for f, want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    assert not facade.fused
    monkeypatch.setattr(tfb, "full_grad_available", lambda F, x0: True)
    if method == "dys":
        assert DavisYin()._setup(z0, F, g, h, prob.L, None)[4].fused
    else:
        assert CondatVu()._setup(z0, F, g, h, K, prob.L, None)[5].fused


# ---------------------------------------------------------------------------
# acceptance: tests/test_dys.py and tests/test_primal_dual.py
# ---------------------------------------------------------------------------

class _L1Box(ProxOperator):
    """The exact prox of lam·|.|₁ + ind[−c, c]: clip(soft(x, γ·lam))."""

    def __init__(self, lam, c):
        super().__init__()
        self.lam, self.c = lam, c

    def value(self, x):
        return self.lam * torch.sum(torch.abs(x))

    def prox_only(self, x, gamma):
        s = torch.sign(x) * torch.clamp(torch.abs(x) - gamma * self.lam,
                                        min=0)
        return torch.clamp(s, -self.c, self.c)


def test_dys_h_zero_equals_forward_backward(lasso):
    """With h = Zero, Davis-Yin is ISTA on x_g from prox_g(x0) (to 1e-12)."""
    prob, JF, jg, F, g = lasso
    k = 25
    states = list(take(iter(DavisYin(maxit=k + 1).iterator(
        _x0(), F=F, g=g, h=Zero(), L=prob.L, N=N)), k + 1))
    start = g.prox_only(_x0(), torch.tensor(1.0 / np.mean(prob.L)))
    xf, _ = ForwardBackward(maxit=k)(start, F=F, g=g, L=prob.L, N=N)
    np.testing.assert_allclose(states[-1].solution.numpy(), xf.numpy(),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("method", ["douglas-rachford", "chambolle-pock"])
def test_closed_form_soft_threshold(method):
    """f = 0: min ½‖x − b‖² + λ‖x‖₁ has the optimum soft(b, λ); Douglas-
    Rachford (400 steps) and Chambolle-Pock (K = I, 2,000 steps) reach it
    to 1e-8."""
    b = np.linspace(-2.0, 2.0, 16)
    g, h = SqrDistPoint(_t(b), 1.0), NormL1(0.7)
    S = (DouglasRachford(maxit=400) if method == "douglas-rachford"
         else ChambollePock(maxit=2000))
    x, it = S(torch.zeros(16, dtype=F64), g=g, h=h, N=1)
    x_star = np.sign(b) * np.maximum(np.abs(b) - 0.7, 0)
    np.testing.assert_allclose(x.numpy(), x_star, rtol=0, atol=1e-8)
    assert it == S.maxit


def test_dys_box_constrained_lasso(lasso):
    """Lasso + a binding box: Davis-Yin (g = L1, h = IndBox) matches the
    FISTA run on the exact prox of L1 + box to 2e-6 (6,000 steps each)."""
    prob, JF, jg, F, g = lasso
    c = 0.5 * float(np.max(np.abs(prob.x_star)))
    x_dys, _ = DavisYin(maxit=6000)(_x0(), F=F, g=g, h=IndBox(-c, c),
                                    L=prob.L, N=N)
    x_ref, _ = FISTA(maxit=6000)(_x0(), F=F, g=_L1Box(prob.lam, c),
                                 L=prob.L, N=N)
    assert float(x_ref.abs().max()) >= c - 1e-9
    assert float(x_dys.abs().max()) <= c + 1e-9
    np.testing.assert_allclose(x_dys.numpy(), x_ref.numpy(), rtol=0,
                               atol=2e-6)


def test_iterators_and_refusals(lasso):
    """The first state is x0 and the last equals the batch run (Davis-Yin
    and Condat-Vũ); no L and no stepsize raise; user stepsizes that break
    τ(L/2 + σ‖K‖²) ≤ 1 warn; a complex iterate on real rows runs the
    real trajectory."""
    prob, JF, jg, F, g = lasso
    h = IndBox(-1.0, 1.0)
    solver = DavisYin(maxit=5)
    states = list(take(iter(solver.iterator(_x0(), F=F, g=g, h=h, L=prob.L,
                                            N=N)), 5))
    assert torch.equal(states[0].solution, _x0())
    x_batch, _ = solver(_x0(), F=F, g=g, h=h, L=prob.L, N=N)
    assert torch.equal(states[-1].solution, x_batch)
    with pytest.raises(ValueError, match="smoothness"):
        DavisYin(maxit=2)(_x0(), F=F, g=g, h=h, N=N)
    bq = np.linspace(-1.0, 1.0, 16)
    Fq, hq, L = _identity_rows(bq), NormL1(0.2), np.full(16, 16.0)
    K = linmap.FirstDifference()
    solver = CondatVu(maxit=5)
    states = list(take(iter(solver.iterator(torch.zeros(16, dtype=F64),
                                            F=Fq, h=hq, K=K, L=L, N=16)), 5))
    assert torch.equal(states[0].solution, torch.zeros(16, dtype=F64))
    x_batch, _ = solver(torch.zeros(16, dtype=F64), F=Fq, h=hq, K=K, L=L,
                        N=16)
    assert torch.equal(states[-1].solution, x_batch)
    with pytest.raises(ValueError, match="smoothness"):
        CondatVu(maxit=2)(torch.zeros(16, dtype=F64), F=Fq, h=hq, N=16)
    with pytest.warns(UserWarning, match="convergence condition"):
        CondatVu(tau=5.0, sigma=5.0, maxit=2)(
            torch.zeros(16, dtype=F64), F=Fq, h=hq, K=K, L=L, N=16)
    for S, kw in ((DavisYin(maxit=4), {}), (CondatVu(maxit=4), dict(K=K))):
        xc, _ = S(torch.zeros(16, dtype=torch.complex128), F=Fq, h=hq, L=L,
                  N=16, **kw)
        xr, _ = S(torch.zeros(16, dtype=F64), F=Fq, h=hq, L=L, N=16, **kw)
        assert xc.dtype == torch.complex128
        np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-12,
                                   atol=1e-14)


def _tv_certificate(x, b, lam):
    """The exact optimality certificate of min ½‖x − b‖² + λ‖Dx‖₁: a dual
    z with x − b + λDᵀz = 0, ‖z‖∞ ≤ 1, z = sign(Dx) on the jumps."""
    m = x.shape[0]
    D = np.diff(np.eye(m), axis=0)
    z = np.linalg.lstsq(D.T, (b - x) / lam, rcond=None)[0]
    assert np.linalg.norm(D.T @ z - (b - x) / lam, np.inf) < 1e-6
    assert np.max(np.abs(z)) <= 1.0 + 1e-6
    d = D @ x
    active = np.abs(d) > 1e-6
    np.testing.assert_allclose(z[active], np.sign(d[active]), rtol=0,
                               atol=1e-6)


def test_tv_denoise_certificate_and_smooth_equivalence():
    """1-D TV denoising two ways, Chambolle-Pock (the quadratic as a prox)
    and Condat-Vũ (the quadratic as the finite sum), 20,000 steps each:
    both meet the exact certificate and agree to 5e-6."""
    rng = np.random.default_rng(3)
    m = 32
    b = np.repeat([0.0, 1.5, -0.5, 2.0], m // 4) + 0.3 * rng.standard_normal(m)
    K, h = linmap.FirstDifference(), NormL1(0.4)
    x_cp, _ = ChambollePock(maxit=20000)(
        torch.zeros(m, dtype=F64), g=SqrDistPoint(_t(b), 1.0), h=h, K=K, N=1)
    x_cv, _ = CondatVu(maxit=20000)(torch.zeros(m, dtype=F64),
                                    F=_identity_rows(b), h=h, K=K,
                                    L=np.full(m, float(m)), N=m)
    _tv_certificate(x_cp.numpy(), b, 0.4)
    _tv_certificate(x_cv.numpy(), b, 0.4)
    np.testing.assert_allclose(x_cv.numpy(), x_cp.numpy(), rtol=0, atol=5e-6)
    assert np.sum(np.abs(np.diff(x_cp.numpy())) > 1e-4) < m // 2


def test_condat_vu_k_identity_matches_davis_yin(lasso):
    """With K = I the three-term problem is Davis-Yin's: both splittings
    find the same minimizer (2e-7, 20,000 steps each)."""
    prob, JF, jg, F, g = lasso
    h = IndBox(-0.4, 0.4)
    x_cv, _ = CondatVu(maxit=20000)(_x0(), F=F, g=g, h=h, L=prob.L, N=N)
    x_dys, _ = DavisYin(maxit=20000)(_x0(), F=F, g=g, h=h, L=prob.L, N=N)
    np.testing.assert_allclose(x_cv.numpy(), x_dys.numpy(), rtol=0,
                               atol=2e-7)
    assert float(x_cv.abs().max()) <= 0.4 + 1e-9


def test_isotropic_tv_with_group_norm():
    """Isotropic TV (GradientMap2D + GroupNormL21) by Chambolle-Pock for
    300 steps follows JAX's trajectory to 1e-10 (f64)."""
    H = W = 6
    rng = np.random.default_rng(2)
    img = np.tril(np.ones((H, W))) * 1.5 + 0.2 * rng.standard_normal((H, W))
    b = img.reshape(-1)
    x, _ = ChambollePock(maxit=300)(
        torch.zeros(H * W, dtype=F64), g=SqrDistPoint(_t(b), 1.0),
        h=GroupNormL21(0.35, groups=2), K=linmap.GradientMap2D(H, W), N=1)
    from ciao_tpu.prox import GroupNormL21 as JGroupNormL21

    xj, _ = ciao_tpu.ChambollePock(maxit=300)(
        jnp.zeros(H * W), g=JSqrDistPoint(b=jnp.asarray(b),
                                          rho=jnp.asarray(1.0)),
        h=JGroupNormL21(lam=jnp.asarray(0.35), groups=2),
        K=jlinmap.GradientMap2D(H=H, W=W), N=1)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_observer_three_term_objective():
    """``monitor.observer`` with h and K logs f + g + h(Kx) for Condat-Vũ
    (the last record equals the objective computed outside at the result,
    rtol 1e-6) and the residual from the state's τ; with h alone it serves
    Davis-Yin."""
    prob = make_lasso(N=16, n=8, p=3, seed=0)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), torch.tensor(16.0,
                                                              dtype=F64))
    g, h, K = NormL1(prob.lam), NormL1(0.05), linmap.FirstDifference()
    tr = monitor.Trace()
    x, _ = CondatVu(maxit=200, freq=50)(
        torch.zeros(8, dtype=F64), F=F, g=g, h=h, K=K, L=prob.L, N=16,
        observe=monitor.observer(F, g, tr, h=h, K=K))
    objs = [r["obj"] for r in tr.records if "obj" in r]
    assert len(objs) >= 3 and all(np.isfinite(objs))
    xv = x.numpy()
    expect = (0.5 * np.sum((prob.A @ xv - prob.b) ** 2)
              + prob.lam * np.abs(xv).sum() + 0.05 * np.abs(np.diff(xv)).sum())
    np.testing.assert_allclose(objs[-1], expect, rtol=1e-6)
    assert objs[-1] < objs[0]
    assert any("residual" in r for r in tr.records)
    tr2 = monitor.Trace()
    DavisYin(maxit=200, freq=50)(
        torch.zeros(8, dtype=F64), F=F, g=g, h=IndBox(-1.0, 1.0), L=prob.L,
        N=16, observe=monitor.observer(F, g, tr2, h=IndBox(-1.0, 1.0)))
    objs2 = [r["obj"] for r in tr2.records if "obj" in r]
    assert len(objs2) >= 3 and np.isfinite(objs2[-1])
