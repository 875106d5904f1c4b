"""The port's logistic, Huber, squared-hinge and Poisson row oracles (and
the Point-SAGA pieces of all five row oracles) against the JAX package on
the CPU.

Every method of the protocol (values, gradients, coefficients, the margin
protocol, ``hess_weight_from_margin`` and the ``pointprox_*`` pieces) on
one seeded problem, f64 and f32 rows and the bf16 and int8 storages. Then
the reference's L1-logistic acceptance (``tests/test_logistic_l1.py``:
8 samples, 5 features, ∞-norm 1e-4 against the hard-coded x*) on the
port's Finito, SAGA, SAG and SVRG, and ``deep_solve`` on ``LogisticRows``
at ``tests/test_deep.py``'s logistic shape against the f64 optimum that
the JAX package's FISTA finds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciao_tpu
from ciao_tpu.oracles import (
    HuberRows as JHuberRows, LeastSquaresRows as JLeastSquaresRows,
    LogisticRows as JLogisticRows, PoissonRows as JPoissonRows,
    SquaredHingeRows as JSquaredHingeRows,
)
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu_torch import SAG, SAGA, SVRG, Finito, deep_solve
from ciao_tpu_torch.convert import (
    huber_from_numpy, least_squares_from_numpy, logistic_from_numpy,
    poisson_from_numpy, sqhinge_from_numpy,
)
from ciao_tpu_torch.oracles import (
    HuberRows, LogisticRows, PoissonRows, SquaredHingeRows,
)
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.utils import make_logistic_l1
from torch_threads import one_torch_thread  # noqa: F401

N, n, B = 64, 16, 8
KINDS = ["lsq", "logistic", "huber", "sqhinge", "poisson"]
STORAGES = ["f64", "f32", "bf16", "int8"]
# relative tolerance of each storage against the JAX oracle: f64 agrees to
# roundoff; f32, bf16 and int8 rows compute in f32, where the two
# libraries sum in different orders
RTOL = {"f64": 1e-12, "f32": 2e-5, "bf16": 2e-5, "int8": 2e-5}


def _data(dtype):
    rng = np.random.default_rng(11)
    A = (rng.standard_normal((N, n)) / np.sqrt(n)).astype(dtype)
    b = rng.standard_normal(N).astype(dtype)
    y = np.sign(rng.standard_normal(N)).astype(dtype)
    cnt = rng.poisson(2.0, N).astype(dtype)
    return A, b, y, cnt


def _jax_oracle(kind, storage):
    dtype = np.float64 if storage == "f64" else np.float32
    A, b, y, cnt = _data(dtype)
    A, b, y, cnt = (jnp.asarray(v) for v in (A, b, y, cnt))
    one = jnp.asarray(1.0, A.dtype)
    F = {"lsq": lambda: JLeastSquaresRows(A=A, b=b,
                                          scale=jnp.asarray(2.0, A.dtype)),
         "logistic": lambda: JLogisticRows(X=A, y=y),
         "huber": lambda: JHuberRows(A=A, b=b,
                                     delta=jnp.asarray(0.7, A.dtype),
                                     scale=jnp.asarray(1.5, A.dtype)),
         "sqhinge": lambda: JSquaredHingeRows(A=A, y=y,
                                              scale=jnp.asarray(2.0,
                                                                A.dtype)),
         "poisson": lambda: JPoissonRows(A=A, y=cnt, scale=one)}[kind]()
    return F if storage in ("f64", "f32") else F.with_storage(storage)


def port_oracle(JF, device="cpu"):
    """The port's oracle with the JAX oracle ``JF``'s fields."""
    a = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    rs = a(JF.row_scale)
    if isinstance(JF, JLeastSquaresRows):
        return least_squares_from_numpy(a(JF.A), a(JF.b), a(JF.scale), rs,
                                        device=device)
    if isinstance(JF, JLogisticRows):
        return logistic_from_numpy(a(JF.X), a(JF.y), rs, device=device)
    if isinstance(JF, JHuberRows):
        return huber_from_numpy(a(JF.A), a(JF.b), a(JF.delta), a(JF.scale),
                                rs, device=device)
    if isinstance(JF, JSquaredHingeRows):
        return sqhinge_from_numpy(a(JF.A), a(JF.y), a(JF.scale), rs,
                                  device=device)
    return poisson_from_numpy(a(JF.A), a(JF.y), a(JF.scale), rs,
                              device=device)


def _close(got, want, rtol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.fixture(scope="module", params=[(k, s) for k in KINDS
                                        for s in STORAGES],
                ids=[f"{k}-{s}" for k in KINDS for s in STORAGES])
def pair(request):
    kind, storage = request.param
    JF = _jax_oracle(kind, storage)
    return kind, storage, JF, port_oracle(JF)


def _points(storage):
    dtype = np.float64 if storage == "f64" else np.float32
    rng = np.random.default_rng(5)
    x1, x2 = (0.8 * rng.standard_normal((2, n))).astype(dtype)
    xs = (0.8 * rng.standard_normal((B, n))).astype(dtype)
    w = rng.standard_normal(N).astype(dtype)
    idx = rng.integers(0, N, B).astype(np.int32)
    return x1, x2, xs, w, idx


def test_oracle_matches_jax(pair):
    """Every method of the coefficient, margin and gradient protocols at
    the seeded points: RTOL of the storage (1e-12 f64, 2e-5 f32 and the
    narrow storages, relative to max(1, the largest entry))."""
    kind, storage, JF, F = pair
    rtol = RTOL[storage]
    x1, x2, xs, w, idx = _points(storage)
    jx1, jx2, jxs, jw = (jnp.asarray(v) for v in (x1, x2, xs, w))
    jidx = jnp.asarray(idx)
    tx1, tx2, txs, tw = (torch.tensor(v) for v in (x1, x2, xs, w))
    tidx = torch.tensor(idx).long()
    s0 = 2 * B
    checks = {
        "value_and_grad_all": (F.value_and_grad_all(tx1),
                               JF.value_and_grad_all(jx1)),
        "grad_all": (F.grad_all(tx1), JF.grad_all(jx1)),
        "grad_sum_all": (F.grad_sum_all(tx1), JF.grad_sum_all(jx1)),
        "value_sum_all": (F.value_sum_all(tx1), JF.value_sum_all(jx1)),
        "coeff_all": (F.coeff_all(tx1), JF.coeff_all(jx1)),
        "coeff_block": (F.coeff_block(tx1, s0, B),
                        JF.coeff_block(jx1, s0, B)),
        "coeff_batch": (F.coeff_batch(tx1, tidx), JF.coeff_batch(jx1, jidx)),
        "apply_all": (F.apply_all(tw), JF.apply_all(jw)),
        "apply_rows": (F.apply_rows(tw[:B], tidx),
                       JF.apply_rows(jw[:B], jidx)),
        "apply_rows_block": (F.apply_rows_block(tw[:B], s0, B),
                             JF.apply_rows_block(jw[:B], s0, B)),
        "value_and_grad_batch": (F.value_and_grad_batch(tx1, tidx),
                                 JF.value_and_grad_batch(jx1, jidx)),
        "grad_sum_batch": (F.grad_sum_batch(tx1, tidx),
                           JF.grad_sum_batch(jx1, jidx)),
        "grad_block": (F.grad_block(tx1, s0, B), JF.grad_block(jx1, s0, B)),
        "grad_sum_diff_block": (F.grad_sum_diff_block(tx1, tx2, s0, B),
                                JF.grad_sum_diff_block(jx1, jx2, s0, B)),
        "grad_pointwise_block": (F.grad_pointwise_block(txs, s0, B),
                                 JF.grad_pointwise_block(jxs, s0, B)),
        "value_and_grad_pointwise": (F.value_and_grad_pointwise(txs, tidx),
                                     JF.value_and_grad_pointwise(jxs, jidx)),
        "value_and_grad_i": (F.value_and_grad_i(tx1, 3),
                             JF.value_and_grad_i(jx1, 3)),
        "margin_all": (F.margin_all(tx1), JF.margin_all(jx1)),
        "margin_block": (F.margin_block(tx1, s0, B),
                         JF.margin_block(jx1, s0, B)),
    }
    r = F.margin_all(tx1)
    jr = JF.margin_all(jx1)
    checks.update({
        "coeff_from_margin": (F.coeff_from_margin(r[s0:s0 + B], s0, B),
                              JF.coeff_from_margin(jr[s0:s0 + B], s0, B)),
        "coeff_from_margin_all": (F.coeff_from_margin_all(r),
                                  JF.coeff_from_margin_all(jr)),
        "value_from_margin_all": (F.value_from_margin_all(r),
                                  JF.value_from_margin_all(jr)),
    })
    for slack in (0.0, 0.5):
        checks[f"hess_weight_from_margin({slack})"] = (
            F.hess_weight_from_margin(r, margin_slack=slack),
            JF.hess_weight_from_margin(jr, margin_slack=slack))
    for name, (got, want) in checks.items():
        if isinstance(want, tuple):
            assert isinstance(got, tuple) and len(got) == len(want), name
            for g_, w_ in zip(got, want):
                _close(g_, w_, rtol, f"{kind}-{storage} {name}")
        else:
            _close(got, want, rtol, f"{kind}-{storage} {name}")


def test_pointprox_matches_jax(pair):
    """The Point-SAGA pieces: ``pointprox_block``/``pointprox_batch`` (θ
    and Σ(c − θ)a), the raw square-norms ``pointprox_sqnorm_block``
    (bit for bit for bf16 and int8 rows: a bf16 sum for bf16 rows, as
    JAX's) and
    ``pointprox_theta_block`` from the raw margins, at γ = 0.7 and a
    table coefficient c_B; RTOL of the storage."""
    kind, storage, JF, F = pair
    rtol = RTOL[storage]
    x1, _, _, w, idx = _points(storage)
    dtype = np.float64 if storage == "f64" else np.float32
    gamma = np.asarray(0.7, dtype)
    c_B = (0.5 * w[:B]).astype(dtype)
    jg, tg = jnp.asarray(gamma), torch.tensor(gamma)
    s0 = 3 * B
    for got, want, what in (
            (F.pointprox_block(torch.tensor(x1), torch.tensor(c_B), tg, s0,
                               B),
             JF.pointprox_block(jnp.asarray(x1), jnp.asarray(c_B), jg, s0, B),
             "pointprox_block"),
            (F.pointprox_batch(torch.tensor(x1), torch.tensor(c_B), tg,
                               torch.tensor(idx).long()),
             JF.pointprox_batch(jnp.asarray(x1), jnp.asarray(c_B), jg,
                                jnp.asarray(idx)),
             "pointprox_batch")):
        for g_, w_ in zip(got, want):
            _close(g_, w_, rtol, f"{kind}-{storage} {what}")
    na = F.pointprox_sqnorm_block(s0, B)
    jna = JF.pointprox_sqnorm_block(s0, B)
    assert str(na.dtype).split(".")[-1] == str(jna.dtype)
    if storage in ("bf16", "int8"):
        # int8 squares sum exactly in f32; a bf16 sum rounds once
        np.testing.assert_array_equal(na.float().numpy(),
                                      np.asarray(jna.astype(jnp.float32)))
    else:
        _close(na, jna, rtol, f"{kind}-{storage} pointprox_sqnorm_block")
    m_raw = F.margin_block(torch.tensor(x1), s0, B)
    jm_raw = JF.margin_block(jnp.asarray(x1), s0, B)
    _close(F.pointprox_theta_block(m_raw, na, torch.tensor(c_B), tg, s0, B),
           JF.pointprox_theta_block(jm_raw, jna, jnp.asarray(c_B), jg, s0, B),
           rtol, f"{kind}-{storage} pointprox_theta_block")


def test_storage_and_constructors():
    """``with_storage`` keeps the oracle's constants and refuses a second
    quantization; the constructors put non-tensor data on the default
    device (the CPU here) and refuse complex rows; Poisson's
    ``local_smoothness`` matches JAX's (rtol 1e-6)."""
    A, b, y, cnt = _data(np.float32)
    H = HuberRows(A, b, delta=0.7, scale=1.5).with_storage("int8")
    assert H.A.dtype == torch.int8 and float(H.delta) == pytest.approx(0.7)
    assert float(H.scale) == 1.5 and H.A.device.type == "cpu"
    with pytest.raises(ValueError, match="already int8"):
        H.with_storage("bf16")
    with pytest.raises(NotImplementedError, match="complex"):
        LogisticRows(torch.zeros((2, 2), dtype=torch.complex64),
                     torch.ones(2))
    assert SquaredHingeRows(A, y).with_storage("bf16").A.dtype == \
        torch.bfloat16
    P = PoissonRows(A, cnt, scale=2.0)
    JP = JPoissonRows(A=jnp.asarray(A), y=jnp.asarray(cnt),
                      scale=jnp.asarray(2.0, jnp.float32))
    np.testing.assert_allclose(P.local_smoothness(1.5).numpy(),
                               np.asarray(JP.local_smoothness(1.5)),
                               rtol=1e-6)
    assert all(getattr(o, "supports_pointprox", False) for o in (
        H, P, LogisticRows(A, y), SquaredHingeRows(A, y)))


# ---------------------------------------------------------------------------
# the reference's L1-logistic acceptance on the port's solvers
# ---------------------------------------------------------------------------

MAXIT = 9000
TOL = 1e-4


@pytest.fixture(scope="module")
def logistic():
    prob = make_logistic_l1()
    F = LogisticRows(torch.tensor(prob.X), torch.tensor(prob.y))
    g = NormL1(torch.tensor(prob.lam))
    return prob, F, g, torch.ones(5, dtype=torch.float64)


@pytest.mark.parametrize("solver", [
    "finito-1", "finito-2", "finito-3", "finito-minibatch", "saga", "sag",
    "svrg"])
def test_logistic_l1_acceptance(logistic, solver):
    """``tests/test_logistic_l1.py`` on the port (f64, 9,000 steps): x
    within ∞-norm 1e-4 of the reference's hard-coded x* (SAG, which the
    reference only smoke-runs, within 1e-2 as the JAX test holds it)."""
    prob, F, g, x0 = logistic
    L = torch.tensor(prob.L)
    if solver.startswith("finito-") and solver[-1].isdigit():
        x, _ = Finito(maxit=MAXIT, sweeping=int(solver[-1]))(
            x0, F=F, g=g, L=L, N=8)
    elif solver == "finito-minibatch":
        x, _ = Finito(maxit=MAXIT, sweeping=3, minibatch=(True, 2))(
            x0, F=F, g=g, L=L, N=8)
    elif solver in ("saga", "sag"):
        x, _ = (SAGA if solver == "saga" else SAG)(maxit=MAXIT)(
            x0, F=F, g=g, N=8, L=L)
    else:
        gamma = 1.0 / (10 * float(np.max(prob.L)))
        x, _ = SVRG(maxit=MAXIT, gamma=gamma)(x0, F=F, g=g, N=8)
    tol = 1e-2 if solver == "sag" else TOL
    assert np.max(np.abs(x.numpy() - prob.x_star)) < tol


def test_deep_solve_logistic_vs_jax_f64_optimum():
    """``deep_solve`` on f32 ``LogisticRows`` at ``tests/test_deep.py``'s
    logistic shape (2,048 × 32, NormL1(0.05)) lands within rel 1e-6 of
    the f64 optimum found by the JAX package's FISTA (20,000 steps at the
    spectral stepsize), the bar of the JAX test. The labels follow a
    planted direction, sign(A·w/√n + noise): with the JAX test's labels,
    independent of A, the gradient at 0 stays inside the λ-ball and the
    optimum is x = 0."""
    Nd, nd, lam_l1 = 2048, 32, 0.05
    rng = np.random.default_rng(7)
    A = rng.standard_normal((Nd, nd)).astype(np.float32)
    rng.standard_normal(Nd)
    w = rng.standard_normal(nd)
    y = np.sign(A @ w / np.sqrt(nd)
                + rng.standard_normal(Nd)).astype(np.float32)
    A64, y64 = A.astype(np.float64), y.astype(np.float64)
    lam_sp = float(np.linalg.eigvalsh(0.25 * A64.T @ A64 / Nd).max())
    xref, _ = ciao_tpu.FISTA(maxit=20_000, gamma=0.95 / lam_sp)(
        jnp.zeros(nd, jnp.float64),
        F=JLogisticRows(X=jnp.asarray(A64), y=jnp.asarray(y64)),
        g=JNormL1(lam=jnp.asarray(lam_l1, jnp.float64)), N=Nd)

    def cost64(z):
        m = A64 @ np.asarray(z, np.float64)
        return (np.logaddexp(0.0, -y64 * m).mean()
                + lam_l1 * np.abs(np.asarray(z, np.float64)).sum())

    f_star = cost64(np.asarray(xref))
    assert np.count_nonzero(np.asarray(xref)) > 0
    F = LogisticRows(torch.tensor(A), torch.tensor(y))
    x, info = deep_solve(
        torch.zeros(nd), F, NormL1(torch.tensor(lam_l1)),
        L=0.25 * torch.sum(torch.tensor(A) ** 2, dim=1), N=Nd, batch=256,
        chunk_epochs=8, max_epochs=64, plateau_rtol=1e-4)
    rel = (cost64(x.numpy()) - f_star) / abs(f_star)
    assert -1e-6 < rel <= 1e-6, rel
    assert info.polish_steps > 0
