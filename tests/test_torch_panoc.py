"""The port's PANOC/ZeroFPR path and kernel #7 against the JAX package on
the CPU.

``coeff_value_apply_all_ref`` (the plain version of kernel #7) is held
against the Pallas kernel in interpret mode in every formula mode and
storage; the oracles' ``value_sum_and_grad_sum_all`` against JAX's in
f64; ``panoc_init``/``panoc_step`` against JAX's step by step in f64
(fixed γ, adaptive γ, the ``tol`` stop, and a JAX state carried over by
``convert.py``); the facades against tests/test_panoc.py's acceptance
bars and the MCP half of tests/test_nonconvex.py. The kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ciao_tpu
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.oracles import (
    HuberRows as JHuberRows, LeastSquaresRows as JLeastSquaresRows,
    LogisticRows as JLogisticRows, PoissonRows as JPoissonRows,
    SquaredHingeRows as JSquaredHingeRows,
)
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import panoc as jpanoc
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch import FISTA, PANOC, ZeroFPR
from ciao_tpu_torch.convert import (
    huber_from_numpy, least_squares_from_numpy, logistic_from_numpy,
    panoc_state_from_numpy, poisson_from_numpy, sqhinge_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows, LogisticRows, SmoothOracle
from ciao_tpu_torch.prox import MCP, NormL1
from ciao_tpu_torch.solvers import panoc as tpanoc
from ciao_tpu_torch.solvers.base import Status, take
from torch_threads import one_torch_thread  # noqa: F401

N, n = 64, 8
MODES = [jfb.MODE_LSQ, jfb.MODE_LOGISTIC, jfb.MODE_HUBER, jfb.MODE_SQHINGE,
         jfb.MODE_POISSON]
MODE_IDS = ["lsq", "logistic", "huber", "sqhinge", "poisson"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _a(v):
    return None if v is None else np.asarray(v)


def _port_oracle(JF):
    """The port's oracle with the JAX oracle's fields, on the CPU."""
    rs = _a(JF.row_scale)
    if isinstance(JF, JLeastSquaresRows):
        return least_squares_from_numpy(_a(JF.A), _a(JF.b), _a(JF.scale), rs,
                                        device="cpu")
    if isinstance(JF, JLogisticRows):
        return logistic_from_numpy(_a(JF.X), _a(JF.y), rs, device="cpu")
    if isinstance(JF, JHuberRows):
        return huber_from_numpy(_a(JF.A), _a(JF.b), _a(JF.delta),
                                _a(JF.scale), rs, device="cpu")
    if isinstance(JF, JSquaredHingeRows):
        return sqhinge_from_numpy(_a(JF.A), _a(JF.y), _a(JF.scale), rs,
                                  device="cpu")
    return poisson_from_numpy(_a(JF.A), _a(JF.y), _a(JF.scale), rs,
                              device="cpu")


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N)))
    jg = JNormL1(lam=jnp.asarray(prob.lam))
    return prob, JF, jg, _port_oracle(JF), NormL1(torch.tensor(prob.lam))


def _x0():
    return torch.zeros(n, dtype=torch.float64)


# ---------------------------------------------------------------------------
# kernel #7's plain version and the oracles' envelope read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("storage,precision", [
    ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
    ("int8", "highest"),
], ids=["f32", "f32-default", "bf16", "int8"])
def test_coeff_value_apply_all_ref_matches_pallas(storage, precision, mode):
    """tests/test_panoc.py:216-266's 512 × 128 read and bounds (value
    rtol 2e-5, int8 2e-3; gsum rtol 2e-4 with atol 1e-5 of its largest
    entry, int8 8e-3 and 4e-3) for every formula mode through the scalars
    row, labels ±1 for the classification modes and counts for Poisson; c
    as the kernel #6 test holds it (rtol 1e-4, atol 1e-3 of its largest
    entry). "default" rounds both dot operands to bf16; XLA on the CPU
    keeps f32 dots exact, so its reference is the same rows stored
    bf16."""
    Np, npix = 512, 128
    rng = np.random.default_rng(5 + mode)
    A = rng.normal(size=(Np, npix)).astype(np.float32)
    b = rng.normal(size=Np).astype(np.float32)
    if mode in (jfb.MODE_LOGISTIC, jfb.MODE_SQHINGE):
        b = np.sign(b).astype(np.float32)
    elif mode == jfb.MODE_POISSON:
        b = rng.poisson(2.0, Np).astype(np.float32)
    u = (0.3 * rng.normal(size=npix)).astype(np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                           scale=jnp.asarray(np.float32(Np)))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rs = _a(JF.row_scale)
    scale = float(Np) if mode in (jfb.MODE_LSQ, jfb.MODE_HUBER) else 1.0
    sc = np.array([scale, mode, 0.7], np.float32)
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jv, jc, jg = jfb.coeff_value_apply_all(
            jA, jnp.asarray(b)[None], jnp.asarray(u)[None],
            jnp.asarray(sc)[None], jfb._pick_tile(Np, Np, npix),
            precision=precision,
            rs1=None if rs is None else jnp.asarray(rs)[None])
    jv, jc, jg = float(jv[0, 0]), np.asarray(jc)[0], np.asarray(jg)[0]
    rows = (_t(np.asarray(JF.A.astype(jnp.float32))).to(torch.bfloat16)
            if storage == "bf16" else _t(JF.A))
    before = tfb.coeff_value_apply_all.launches
    v, c, g = tfb.coeff_value_apply_all(rows, _t(b), _t(u), _t(sc),
                                        precision=precision,
                                        rs=None if rs is None else _t(rs))
    assert tfb.coeff_value_apply_all.launches == before  # the plain version
    assert v.shape == () and v.dtype == c.dtype == g.dtype == torch.float32
    quant = storage == "int8"
    np.testing.assert_allclose(float(v), jv, rtol=2e-3 if quant else 2e-5)
    np.testing.assert_allclose(
        g.numpy(), jg, rtol=8e-3 if quant else 2e-4,
        atol=np.abs(jg).max() * (4e-3 if quant else 1e-5))
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-4,
                               atol=1e-3 * np.abs(jc).max())


@pytest.mark.parametrize("mode", [jfb.MODE_LSQ, jfb.MODE_LOGISTIC],
                         ids=["lsq", "logistic"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_coeff_value_apply_all_ref_ragged_wide_tiles_match_pallas(storage,
                                                                  mode):
    """Tiles of more than 32 rows (96 f32, 256 int8 at n = 128: three to
    eight warps' xor trees, added in warp order) and a ragged last tile
    (32 f32 rows, 64 int8) at N = 1,088: the plain version against the
    Pallas kernel in interpret mode (its 64-row tiles), at
    test_coeff_value_apply_all_ref_matches_pallas's bounds."""
    Np, npix = 1088, 128
    R = tfb._apply_rows(npix, 4 if storage == "f32" else 1)
    assert R > 32 and Np % R
    rng = np.random.default_rng(21 + mode)
    A = rng.normal(size=(Np, npix)).astype(np.float32)
    b = rng.normal(size=Np).astype(np.float32)
    if mode == jfb.MODE_LOGISTIC:
        b = np.sign(b).astype(np.float32)
    u = (0.3 * rng.normal(size=npix)).astype(np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                           scale=jnp.asarray(np.float32(Np)))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rs = _a(JF.row_scale)
    sc = np.array([float(Np) if mode == jfb.MODE_LSQ else 1.0, mode, 0.0],
                  np.float32)
    with pltpu.force_tpu_interpret_mode():
        jv, jc, jg = jfb.coeff_value_apply_all(
            JF.A, jnp.asarray(b)[None], jnp.asarray(u)[None],
            jnp.asarray(sc)[None], jfb._pick_tile(Np, Np, npix),
            rs1=None if rs is None else jnp.asarray(rs)[None])
    jv, jc, jg = float(jv[0, 0]), np.asarray(jc)[0], np.asarray(jg)[0]
    v, c, g = tfb.coeff_value_apply_all(_t(JF.A), _t(b), _t(u), _t(sc),
                                        rs=None if rs is None else _t(rs))
    quant = storage == "int8"
    np.testing.assert_allclose(float(v), jv, rtol=2e-3 if quant else 2e-5)
    np.testing.assert_allclose(
        g.numpy(), jg, rtol=8e-3 if quant else 2e-4,
        atol=np.abs(jg).max() * (4e-3 if quant else 1e-5))
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-4,
                               atol=1e-3 * np.abs(jc).max())


def test_coeff_value_apply_all_ref_is_the_oracle_pass():
    """Within the port, at a ragged N (no whole last tile): c and gsum are
    kernel #6's plain version's (the same tiles), the value is the
    oracle's Σf_i within f32 rounding, and ``oracle_value_apply_all``
    reads the oracle's rows, offsets and scalars."""
    prob = make_lasso(N=1001, n=37, p=3, seed=2, dtype=np.float32)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 3.0)
    z = torch.tensor(np.random.default_rng(0).standard_normal(37) * 0.1,
                     dtype=torch.float32)
    assert tfb._apply_rows(37, 4) == 256  # 3 whole tiles and 233 rows
    v, c, g = tfb.oracle_value_apply_all(F, z)
    c6, g6 = tfb.oracle_apply_all(F, z)
    assert torch.equal(c, c6) and torch.equal(g, g6)
    vs, gs = F.value_sum_and_grad_sum_all(z)
    torch.testing.assert_close(v, vs, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(g, gs, rtol=1e-5,
                               atol=1e-5 * float(gs.abs().max()))


def _jax_row_oracle(kind, storage):
    rng = np.random.default_rng(11)
    A = jnp.asarray(rng.standard_normal((N, n)) / np.sqrt(n))
    b = jnp.asarray(rng.standard_normal(N))
    y = jnp.asarray(np.sign(rng.standard_normal(N)))
    cnt = jnp.asarray(rng.poisson(2.0, N).astype(np.float64))
    F = {"lsq": lambda: JLeastSquaresRows(A=A, b=b, scale=jnp.asarray(2.0)),
         "logistic": lambda: JLogisticRows(X=A, y=y),
         "huber": lambda: JHuberRows(A=A, b=b, delta=jnp.asarray(0.7),
                                     scale=jnp.asarray(1.5)),
         "sqhinge": lambda: JSquaredHingeRows(A=A, y=y,
                                              scale=jnp.asarray(2.0)),
         "poisson": lambda: JPoissonRows(A=A, y=cnt,
                                         scale=jnp.asarray(1.0))}[kind]()
    return F if storage == "f64" else F.with_storage(storage)


@pytest.mark.parametrize("storage", ["f64", "int8"])
@pytest.mark.parametrize("kind", MODE_IDS)
def test_value_sum_and_grad_sum_all_matches_jax(kind, storage):
    """Both sums from one margin against JAX's in f64 at rtol 1e-12 (int8
    rows with f64 iterates: the f32 row scales promote), and against the
    port's own separate reductions and ``value_sum_all``."""
    JF = _jax_row_oracle(kind, storage)
    F = _port_oracle(JF)
    x = np.random.default_rng(0).standard_normal(n) * 0.8
    jv, jg = JF.value_sum_and_grad_sum_all(jnp.asarray(x))
    v, g = F.value_sum_and_grad_sum_all(torch.tensor(x))
    assert v.dtype == g.dtype == torch.float64
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-12,
                               atol=1e-12 * float(np.abs(jg).max()))
    vals, grads = F.value_and_grad_all(torch.tensor(x))
    np.testing.assert_allclose(float(v), float(vals.sum()), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), grads.sum(0).numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(float(F.value_sum_all(torch.tensor(x))),
                               float(v), rtol=1e-12)


def test_generic_oracles_inherit_the_envelope_read():
    """ZeroOracle and SumOracle take the generic full pass."""
    from ciao_tpu_torch.oracles import SumOracle, ZeroOracle

    F = LeastSquaresRows(torch.randn(16, 4, dtype=torch.float64),
                         torch.randn(16, dtype=torch.float64), 2.0)
    x = torch.randn(4, dtype=torch.float64)
    v0, g0 = ZeroOracle(16).value_sum_and_grad_sum_all(x)
    assert float(v0) == 0.0 and torch.equal(g0, torch.zeros(4,
                                                            dtype=x.dtype))
    v, g = SumOracle([F, F]).value_sum_and_grad_sum_all(x)
    vf, gf = F.value_sum_and_grad_sum_all(x)
    torch.testing.assert_close(v, 2 * vf)
    torch.testing.assert_close(g, 2 * gf)
    torch.testing.assert_close(SumOracle([F, F]).value_sum_all(x), 2 * vf)


# ---------------------------------------------------------------------------
# PANOC / ZeroFPR against JAX step by step
# ---------------------------------------------------------------------------

RING = ("S", "Y", "rho")


def _assert_state_close(js, ts, k, what):
    """x, z, fbe, the ring within 1e-9 of their largest entries (the
    libraries' dot products sum in other orders, and ρ = 1/⟨y, s⟩ grows
    as the pairs shrink); γ, τ, ls_ewma, the cursors and the status
    exact."""
    for f in ("x", "z", "fbe", "fx", "gradx", "sigma") + RING:
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f).numpy()
        np.testing.assert_allclose(
            got, want, rtol=1e-9, atol=1e-9 * max(1e-300, np.abs(want).max()),
            err_msg=f"{what} step {k}: {f}")
    for f in ("gamma", "tau", "ls_ewma"):
        assert float(getattr(ts, f)) == float(getattr(js, f)), (what, k, f)
    assert int(ts.head) == int(js.head) and int(ts.count) == int(js.count)
    assert int(ts.it) == int(js.it) and int(ts.status) == int(js.status)


CASES = {"fixed": dict(), "adaptive": dict(adaptive=True),
         "tol": dict(tol=2.0)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("zerofpr", [False, True], ids=["panoc", "zerofpr"])
def test_panoc_matches_jax_step_by_step(lasso, zerofpr, case):
    """12 steps in f64 from the same γ and σ (adaptive from a 30x too
    large γ, so that it halves and flushes the ring; ``tol`` = 2 on ‖r‖/γ,
    met at step 8 or 10, after which the state stays), every field
    compared after every step."""
    prob, JF, jg, F, g = lasso
    kw = CASES[case]
    jcfg = jpanoc.PANOCCfg(N=N, zerofpr=zerofpr, **kw)
    cfg = tpanoc.PANOCCfg(N=N, zerofpr=zerofpr, **kw)
    gamma = 0.95 / np.mean(prob.L) * (30.0 if case == "adaptive" else 1.0)
    sigma = 0.5 * 0.05 / (2 * gamma)
    js = jpanoc.panoc_init(JF, jg, jnp.zeros(n), jnp.asarray(gamma),
                           jnp.asarray(sigma), jcfg)
    ts = tpanoc.panoc_init(F, g, _x0(), torch.tensor(gamma),
                           torch.tensor(sigma), cfg)
    _assert_state_close(js, ts, 0, case)
    for k in range(1, 13):
        js = jpanoc.panoc_step(JF, jg, js, jcfg)
        ts = tpanoc.panoc_step(F, g, ts, cfg)
        _assert_state_close(js, ts, k, case)
    if case == "adaptive":
        assert float(ts.gamma) <= gamma / 16
    if case == "tol":
        assert ts.status == Status.CONVERGED


@pytest.mark.parametrize("zerofpr", [False, True], ids=["panoc", "zerofpr"])
def test_jax_state_carries_over(lasso, zerofpr):
    """A JAX state after 5 steps, converted by ``panoc_state_from_numpy``,
    goes on in the port as it goes on in JAX."""
    prob, JF, jg, F, g = lasso
    jcfg = jpanoc.PANOCCfg(N=N, zerofpr=zerofpr)
    cfg = tpanoc.PANOCCfg(N=N, zerofpr=zerofpr)
    gamma = 0.95 / np.mean(prob.L)
    js = jpanoc.panoc_run(JF, jg, jpanoc.panoc_init(
        JF, jg, jnp.zeros(n), jnp.asarray(gamma),
        jnp.asarray(0.5 * 0.05 / (2 * gamma)), jcfg), jcfg, 5)
    ts = panoc_state_from_numpy(**{f: np.asarray(getattr(js, f))
                                   for f in js._fields}, device="cpu")
    _assert_state_close(js, ts, 5, "converted")
    js = jpanoc.panoc_run(JF, jg, js, jcfg, 5)
    ts = tpanoc.panoc_run(F, g, ts, cfg, 5)
    _assert_state_close(js, ts, 10, "continued")


def test_fused_route_matches_the_two_product_read(lasso, monkeypatch):
    """The fused configuration on CPU tensors runs kernel #7's plain
    version, one call per FBE evaluation, and follows the two-product
    trajectory within f32 rounding, which the L-BFGS steps amplify
    (test_panoc.py's 512 × 128 problem, 15 steps, z within 1e-4 of its
    largest entry); the facade opens the route
    exactly where ``full_grad_available`` says."""
    Np, npix = 512, 128
    prob = make_lasso(N=Np, n=npix, p=4, seed=3, dtype=np.float32)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         float(Np))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    gamma = torch.tensor(0.95 / np.mean(prob.L), dtype=torch.float32)
    sigma = torch.tensor(0.5 * 0.05 / (2 * 0.95 / np.mean(prob.L)),
                         dtype=torch.float32)
    z0 = torch.zeros(npix)
    calls, evals = [], []
    real, real_eval = tfb.oracle_value_apply_all, tpanoc._eval_fbe

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    def counted_eval(*args, **kw):
        evals.append(1)
        return real_eval(*args, **kw)

    monkeypatch.setattr(tfb, "oracle_value_apply_all", counted)
    monkeypatch.setattr(tpanoc, "_eval_fbe", counted_eval)
    for zfpr in (False, True):
        cfg = tpanoc.PANOCCfg(N=Np, zerofpr=zfpr)
        st_x = tpanoc.panoc_run(F, g, tpanoc.panoc_init(F, g, z0, gamma,
                                                        sigma, cfg), cfg, 15)
        assert not calls and len(evals) > 16 + 15 * zfpr
        evals.clear()
        cfg_f = cfg._replace(fused=True)
        st_f = tpanoc.panoc_run(F, g, tpanoc.panoc_init(F, g, z0, gamma,
                                                        sigma, cfg_f),
                                cfg_f, 15)
        assert len(calls) == len(evals) > 16 + 15 * zfpr
        calls.clear()
        evals.clear()
        np.testing.assert_allclose(st_f.z.numpy(), st_x.z.numpy(), rtol=0,
                                   atol=1e-4 * float(st_x.z.abs().max()))
    x0 = torch.zeros(npix)
    assert not PANOC()._setup(x0, F, g, prob.L, None)[3].fused
    monkeypatch.setattr(tfb, "full_grad_available", lambda F, x0: True)
    assert PANOC()._setup(x0, F, g, prob.L, None)[3].fused
    assert ZeroFPR()._setup(x0, F, g, None, None)[3].fused


def test_complex_iterates_are_refused(lasso):
    """No longer refused: a complex iterate on real rows runs the real
    trajectory (the ring's ρ = 1/Re⟨s, y⟩) with a zero imaginary part."""
    prob, JF, jg, F, g = lasso
    for S in (PANOC(maxit=12), ZeroFPR(maxit=12)):
        xc, _ = S(torch.zeros(n, dtype=torch.complex128), F=F, g=g,
                  L=prob.L)
        xr, _ = S(_x0(), F=F, g=g, L=prob.L)
        assert xc.dtype == torch.complex128
        np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-10,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# acceptance: tests/test_panoc.py and tests/test_nonconvex.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["panoc", "zerofpr"])
@pytest.mark.parametrize("info", ["L", "none"])
def test_panoc_reaches_machine_precision(lasso, solver, info):
    """60 Newton-type iterations with L (80 adaptive, with neither γ nor
    L) reach the planted optimum to 1e-12, the quasi-Newton tail FISTA
    cannot match."""
    prob, JF, jg, F, g = lasso
    S = PANOC if solver == "panoc" else ZeroFPR
    maxit = 60 if info == "L" else 80
    x, it = S(maxit=maxit)(_x0(), F=F, g=g,
                           L=prob.L if info == "L" else None, N=N)
    assert prob.cost(x.numpy()) - prob.f_star < 1e-12
    if info == "L":
        assert it == 60


def test_panoc_beats_fista(lasso):
    """At a matched full-pass budget PANOC lands ≥ 1000x closer."""
    prob, JF, jg, F, g = lasso
    xp, _ = PANOC(maxit=50)(_x0(), F=F, g=g, L=prob.L, N=N)
    xf, _ = FISTA(maxit=100)(_x0(), F=F, g=g, L=prob.L, N=N)
    gap_p = prob.cost(xp.numpy()) - prob.f_star
    gap_f = prob.cost(xf.numpy()) - prob.f_star
    assert gap_p * 1000 < gap_f, (gap_p, gap_f)


def test_panoc_tol_stop_and_iterator(lasso):
    """``tol`` stops early (Status.CONVERGED, the iterator exhausts); the
    iterator's states equal the batch run's; maxit = 1 is the init."""
    prob, JF, jg, F, g = lasso
    solver = PANOC(maxit=500, tol=1e-10)
    x, it = solver(_x0(), F=F, g=g, L=prob.L, N=N)
    assert it < 500
    assert prob.cost(x.numpy()) - prob.f_star < 1e-12
    states = list(take(iter(solver.iterator(_x0(), F=F, g=g, L=prob.L,
                                            N=N)), 500))
    assert len(states) == it
    assert int(states[-1].status) == Status.CONVERGED
    solver = PANOC(maxit=7)
    states = list(take(iter(solver.iterator(_x0(), F=F, g=g, L=prob.L, N=N)),
                       7))
    x_batch, _ = solver(_x0(), F=F, g=g, L=prob.L, N=N)
    assert torch.equal(states[-1].solution, x_batch)
    x1, _ = PANOC(maxit=1)(_x0(), F=F, g=g, L=prob.L, N=N)
    assert torch.equal(states[0].solution, x1)


def test_panoc_adaptive_recovers_from_bad_gamma(lasso):
    """adaptive=True with a 200x too large γ halves into range and
    converges."""
    prob, JF, jg, F, g = lasso
    bad = 200.0 / float(np.mean(prob.L))
    x, _ = PANOC(gamma=bad, adaptive=True, maxit=80)(_x0(), F=F, g=g, N=N)
    assert prob.cost(x.numpy()) - prob.f_star < 1e-12


def test_panoc_gamma_only_and_ls_fallback(lasso):
    """γ without L converges; γ = 4/L breaks the forward-backward
    decrease, so every step falls back to τ = 0: the iterates stay finite
    and the thrash gauge warns."""
    prob, JF, jg, F, g = lasso
    gam = 0.95 / float(np.mean(prob.L))
    x, _ = PANOC(gamma=gam, maxit=60)(_x0(), F=F, g=g, N=N)
    assert prob.cost(x.numpy()) - prob.f_star < 1e-12
    with pytest.warns(UserWarning, match="FBE"):
        xb, _ = PANOC(gamma=4.0 / float(np.mean(prob.L)), maxit=30)(
            _x0(), F=F, g=g, L=prob.L, N=N)
    assert bool(torch.isfinite(xb).all())


def test_panoc_logistic_l1():
    """The reference's logistic + L1 problem to 1e-6 of its x*."""
    from ciao_tpu_torch.utils import make_logistic_l1

    prob = make_logistic_l1()
    F = LogisticRows(torch.tensor(prob.X), torch.tensor(prob.y))
    g = NormL1(torch.tensor(prob.lam))
    x, _ = PANOC(maxit=80)(torch.zeros(prob.X.shape[1], dtype=torch.float64),
                           F=F, g=g, L=prob.L, N=prob.X.shape[0])
    assert np.max(np.abs(x.numpy() - prob.x_star)) < 1e-6


class _FloorNoiseOracle(SmoothOracle):
    """tests/test_panoc.py's wrapper: a deterministic bf16-floor-scale
    jitter on the envelope read (the narrow-storage thrash mechanism)."""

    def __init__(self, F, amp):
        super().__init__()
        self.F = F
        self.amp = amp

    @property
    def num_terms(self):
        return self.F.num_terms

    def value_and_grad_i(self, x, i):
        return self.F.value_and_grad_i(x, i)

    def value_sum_and_grad_sum_all(self, u):
        v, gsum = self.F.value_sum_and_grad_sum_all(u)
        h = torch.sum(u * 12345.678)
        noise = self.amp * torch.sin(h * 1e4) * (1.0 + torch.abs(v))
        gscale = 1.0 + torch.linalg.norm(gsum) / np.sqrt(u.numel())
        gnoise = self.amp * gscale * torch.sin(
            h * 7e3 + torch.arange(u.numel(), dtype=u.dtype))
        return v + noise, gsum + gnoise


def test_panoc_thrash_warning_on_value_noise_floor():
    """At a value-noise floor the line search burns several evaluations a
    step and the facade warns; the exact run stays silent. The jitter is
    sin of a ~1e9-radian function of the iterate, so each library's f32
    roundings give it its own sequence: JAX's 2^-8 run ends at a gauge of
    2.507, at the 2.5 threshold; the port's at 1.58, and it thrashes from
    step 70 on. At 2^-6 the port's gauge is 3.35 at step 60, with the
    residual still at 4e-5."""
    prob = make_lasso(N=256, n=32, p=5, seed=7, dtype=np.float32)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 256.0)
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))

    def run(amp):
        Fr = _FloorNoiseOracle(F, amp) if amp else F
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            PANOC(maxit=60)(torch.zeros(32), F=Fr, g=g, L=prob.L, N=256)
        return [w for w in rec if "accuracy floor" in str(w.message)]

    assert run(2.0 ** -6), "a floor-noise run must warn"
    assert not run(0.0), "the exact run must stay silent"


@pytest.mark.parametrize("gauge", [1.0, 2.4, 2.5, 3.4])
@pytest.mark.parametrize("rrel", [1e-7, 9e-6, 1e-5, 1e-3])
def test_thrash_decision_matches_jax(gauge, rrel):
    """``warn_if_thrashing`` decides as JAX's on the same gauge and the
    same residual ‖x − z‖/(1 + ‖x‖)."""
    x = np.zeros(4)
    x[0] = 3.0
    z = x.copy()
    z[1] = rrel * (1 + 3.0)
    jst = jpanoc.PANOCState(*([None] * 19))._replace(
        x=jnp.asarray(x), z=jnp.asarray(z),
        ls_ewma=jnp.asarray(gauge, jnp.float32))
    tst = tpanoc.PANOCState(*([None] * 19))._replace(
        x=torch.tensor(x), z=torch.tensor(z),
        ls_ewma=torch.tensor(gauge, dtype=torch.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tpanoc.warn_if_thrashing(tst) == jpanoc.warn_if_thrashing(jst)


def test_panoc_zerofpr_mcp_support_recovery():
    """tests/test_nonconvex.py:95's MCP half: PANOC and ZeroFPR with the
    nonconvex MCP penalty recover the planted support exactly and the
    oracle refit within 1e-2."""
    rng = np.random.default_rng(3)
    Nm, nm, k = 512, 64, 6
    A = (rng.standard_normal((Nm, nm)) / np.sqrt(Nm)).astype(np.float32)
    x_true = np.zeros(nm, np.float32)
    sup = rng.choice(nm, size=k, replace=False)
    x_true[sup] = (3.0 + rng.random(k)).astype(np.float32) * rng.choice(
        [-1, 1], size=k)
    b = A @ x_true + 0.01 * rng.standard_normal(Nm).astype(np.float32)
    F = LeastSquaresRows(torch.tensor(A), torch.tensor(b), float(Nm))
    lam_max = float(np.linalg.eigvalsh(A.T @ A).max())
    g = MCP(torch.tensor(0.05, dtype=torch.float32),
            torch.tensor(3.0, dtype=torch.float32))
    for S in (PANOC, ZeroFPR):
        x, _ = S(gamma=0.95 / lam_max, maxit=120)(torch.zeros(nm), F=F, g=g)
        x = x.double().numpy()
        assert set(np.flatnonzero(np.abs(x) > 1e-3)) == set(sup.tolist())
        refit = np.linalg.lstsq(A[:, sup], b, rcond=None)[0]
        assert np.max(np.abs(x[sup] - refit)) < 1e-2
