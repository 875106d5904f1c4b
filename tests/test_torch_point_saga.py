"""The port's Point-SAGA against the JAX package on the CPU.

The plain versions of kernels #12 and #15 (``point_saga_multistep_ref``
and ``point_saga_multistep_streamed_ref``) against the Pallas kernels in
interpret mode in all five oracle modes (least squares, logistic, Huber,
squared hinge, Poisson), the row square-norms of the kernel routes, the
stepwise ``point_saga_run`` on JAX's own schedules (blocks and iid
minibatches) in f64, the fused driver on the plain versions against the
stepwise stream (uniform and importance draws, with a remainder launch),
the facade's set-up, routing and errors, and ``point_saga_rebase``
re-deriving the square-norms for a new storage. torch cannot draw
threefry, so the parity tests hand JAX's schedules to ``point_saga_run``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ciao_tpu
from ciao_tpu.oracles import (
    HuberRows as JHuberRows, LeastSquaresRows as JLeastSquaresRows,
    LogisticRows as JLogisticRows, PoissonRows as JPoissonRows,
    SquaredHingeRows as JSquaredHingeRows,
)
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.prox import Zero as JZero
from ciao_tpu.solvers import point_saga as jps
from ciao_tpu.solvers.saga import _gen_block_starts
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch.convert import (
    huber_from_numpy, least_squares_from_numpy, logistic_from_numpy,
    point_saga_state_from_numpy, poisson_from_numpy, sqhinge_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import DiagQuadratic
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers import (
    PointSAGA, PointSAGACfg, point_saga_init, point_saga_rebase,
    point_saga_run, solution, take,
)
from ciao_tpu_torch.solvers import point_saga as tps
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    """A torch copy of a numpy array (the kernels update in place)."""
    return torch.tensor(np.asarray(a))


def _rows(JF):
    A = JF.X if isinstance(JF, JLogisticRows) else JF.A
    if A.dtype == jnp.bfloat16:
        return _t(np.asarray(A.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(A))


def port_oracle(JF):
    """The port's oracle with the JAX oracle ``JF``'s fields, on the
    CPU."""
    a = lambda v: None if v is None else np.asarray(v)  # noqa: E731
    rs, dev = a(JF.row_scale), "cpu"
    if isinstance(JF, JLeastSquaresRows):
        return least_squares_from_numpy(a(JF.A), a(JF.b), a(JF.scale), rs,
                                        device=dev)
    if isinstance(JF, JLogisticRows):
        return logistic_from_numpy(a(JF.X), a(JF.y), rs, device=dev)
    if isinstance(JF, JHuberRows):
        return huber_from_numpy(a(JF.A), a(JF.b), a(JF.delta), a(JF.scale),
                                rs, device=dev)
    if isinstance(JF, JSquaredHingeRows):
        return sqhinge_from_numpy(a(JF.A), a(JF.y), a(JF.scale), rs,
                                  device=dev)
    return poisson_from_numpy(a(JF.A), a(JF.y), a(JF.scale), rs, device=dev)


def _offs(JF):
    return np.asarray(JF.b if isinstance(JF, (JLeastSquaresRows, JHuberRows))
                      else JF.y)


# ---------------------------------------------------------------------------
# kernels #12 and #15: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

N, n, B, K = 1024, 128, 128, 8
d = N // B
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
MODES = {"lsq": jfb.MODE_LSQ, "logistic": jfb.MODE_LOGISTIC,
         "huber": jfb.MODE_HUBER, "sqhinge": jfb.MODE_SQHINGE,
         "poisson": jfb.MODE_POISSON}
CASES = [(k, s) for k in MODES for s in ("f32", "int8")] + [
    ("lsq", "bf16"), ("logistic", "bf16")]


def _kernel_oracle(kind, storage):
    """The JAX oracle of ``kind`` on one planted problem's rows, and the
    moduli L of its γ."""
    prob = make_lasso(N=N, n=n, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    A, b = prob.A, prob.b
    rng = np.random.default_rng(1)
    y = np.sign(rng.standard_normal(N)).astype(np.float32)
    sq = np.sum(A.astype(np.float64) ** 2, axis=1)
    if kind == "lsq":
        JF = JLeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                               scale=jnp.asarray(float(N), jnp.float32))
        L = N * sq
    elif kind == "logistic":
        JF = JLogisticRows(X=jnp.asarray(8.0 * A), y=jnp.asarray(y))
        L = 0.25 * 64.0 * sq
    elif kind == "huber":
        JF = JHuberRows(A=jnp.asarray(A), b=jnp.asarray(b),
                        delta=jnp.asarray(0.7, jnp.float32),
                        scale=jnp.asarray(float(N), jnp.float32))
        L = N * sq
    elif kind == "sqhinge":
        JF = JSquaredHingeRows(A=jnp.asarray(8.0 * A), y=jnp.asarray(y),
                               scale=jnp.asarray(2.0, jnp.float32))
        L = 2.0 * 64.0 * sq
    else:
        cnt = rng.poisson(2.0, N).astype(np.float32)
        JF = JPoissonRows(A=jnp.asarray(0.05 * 8.0 * A), y=jnp.asarray(cnt),
                          scale=jnp.asarray(1.0, jnp.float32))
        L = np.e * 0.16 * sq
    if storage != "f32":
        JF = JF.with_storage(storage)
    return JF, L


def _kernel_state(JF, L):
    rng = np.random.default_rng(7)
    x0 = (0.05 * rng.standard_normal(n)).astype(np.float32)
    c = np.asarray(JF.coeff_all(jnp.asarray(x0)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(c)), np.float32) / N
    gamma = 1.0 / (3.0 * float(np.max(L)))
    return x0, c, av, gamma


def _scalars(JF, gamma, kind):
    scale = float(getattr(JF, "scale", 1.0))
    aux = float(getattr(JF, "delta", 0.0))
    return np.array([scale, gamma, 1.0 / B, 1.0 / N, MODES[kind], aux],
                    np.float32)


@pytest.mark.parametrize("kind,storage", CASES,
                         ids=[f"{k}-{s}" for k, s in CASES])
def test_point_saga_multistep_ref_matches_pallas(kind, storage):
    """K = 8 steps of #12's plain version against the Pallas kernel in
    interpret mode, at 10× the default γ (the Newton modes then move
    θ well off its warm start), on one schedule with a block repeated on
    consecutive steps: x, av and c at rtol 1e-4, atol 1e-6 of the
    largest entry. The row square-norms the port derives for the kernel
    (``point_saga._sqnorms``) equal JAX's slab (bf16 and int8 bit for
    bit, f32 to rtol 1e-6: a sum in another order)."""
    JF, L = _kernel_oracle(kind, storage)
    x0, c, av, gamma = _kernel_state(JF, L)
    gamma *= 10.0
    sc = _scalars(JF, gamma, kind)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    jna = np.asarray(jps._sqnorm_slab(JF, N)).reshape(N)
    na = tps._sqnorms(port_oracle(JF), N)
    if storage == "f32":
        np.testing.assert_allclose(na.numpy(), jna, rtol=1e-6)
    else:
        np.testing.assert_array_equal(na.numpy(), jna)
    starts = (np.random.default_rng(3).integers(0, d, K) * B).astype(np.int32)
    starts[3] = starts[2]
    with pltpu.force_tpu_interpret_mode():
        jc, jx, jav = jfb.point_saga_multistep(
            JF.X if kind == "logistic" else JF.A,
            jnp.asarray(_offs(JF)).reshape(SLAB), jnp.asarray(jna).reshape(
                SLAB), jnp.asarray(c).reshape(SLAB), jnp.asarray(starts),
            jnp.asarray(x0)[None], jnp.asarray(av)[None],
            jnp.asarray(sc)[None], B, mode=MODES[kind],
            rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB))
    tc, tx, tav = _t(c), _t(x0), _t(av)
    out = tfb.point_saga_multistep(
        _rows(JF), _t(_offs(JF)), na, tc, _t(starts), tx, tav, _t(sc), B,
        mode=MODES[kind], rs=None if rs is None else _t(rs))
    assert all(o is t for o, t in zip(out, (tc, tx, tav)))  # in place
    assert not np.array_equal(tx.numpy(), x0)
    for got, want in ((tx, np.asarray(jx)[0]), (tav, np.asarray(jav)[0]),
                      (tc, np.asarray(jc).reshape(N))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("kind,fc", [("lsq", 6), ("logistic", 4),
                                     ("poisson", 4)])
def test_point_saga_streamed_ref_matches_pallas(kind, fc):
    """#15's plain version against the streamed Pallas kernel in
    interpret mode, int8 rows, 6 distinct blocks (the clamped JAX driver
    never revisits a block in a launch): with f = 6 every step commits,
    with f = 4 the masked steps leave c, x and av as step 3 left them
    (JAX redirects them to a free block; the port writes nothing) and
    equal the first 4 steps alone bit for bit. rtol 1e-4, atol 1e-6 of
    the largest entry against JAX."""
    JF, L = _kernel_oracle(kind, "int8")
    x0, c, av, gamma = _kernel_state(JF, L)
    sc = _scalars(JF, 10.0 * gamma, kind)
    rs = np.asarray(JF.row_scale)
    na = tps._sqnorms(port_oracle(JF), N)
    starts = (np.random.default_rng(3).permutation(d)[:6] * B).astype(
        np.int32)
    with pltpu.force_tpu_interpret_mode():
        jc, jx, jav = jfb.point_saga_multistep_streamed(
            JF.X if kind == "logistic" else JF.A,
            jnp.asarray(_offs(JF))[None], jnp.asarray(na.numpy())[None],
            jnp.asarray(c)[None], jnp.asarray(starts), jnp.asarray(x0)[None],
            jnp.asarray(av)[None], jnp.asarray(sc)[None], B,
            mode=MODES[kind], rs1=jnp.asarray(rs)[None],
            f=jnp.asarray(fc, jnp.int32))
    tc, tx, tav = _t(c), _t(x0), _t(av)
    tfb.point_saga_multistep_streamed(
        _rows(JF), _t(_offs(JF)), na, tc, _t(starts), tx, tav, _t(sc), B,
        mode=MODES[kind], rs=_t(rs), f=torch.tensor([fc], dtype=torch.int32))
    for got, want in ((tx, np.asarray(jx)[0]), (tav, np.asarray(jav)[0]),
                      (tc, np.asarray(jc)[0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    ref = [_t(c), _t(x0), _t(av)]
    tfb.point_saga_multistep_ref(_rows(JF), _t(_offs(JF)), na, ref[0],
                                 _t(starts[:fc]), ref[1], ref[2], _t(sc), B,
                                 mode=MODES[kind], rs=_t(rs))
    for got, want in zip((tc, tx, tav), ref):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_point_saga_wrappers_on_cpu():
    """CPU tensors take the plain versions and count no launch; the
    resident and streamed wrappers agree; a device with no kernel and an
    unknown mode raise."""
    JF, L = _kernel_oracle("huber", "f32")
    x0, c, av, gamma = _kernel_state(JF, L)
    A, b = _rows(JF), _t(_offs(JF))
    na = tps._sqnorms(port_oracle(JF), N)
    sc = _t(_scalars(JF, gamma, "huber"))
    starts = _t(np.array([0, 3, 3, 5], np.int32) * B)
    before = (tfb.point_saga_multistep.launches,
              tfb.point_saga_multistep_streamed.launches)
    one, two = ([_t(c), _t(x0), _t(av)] for _ in range(2))
    tfb.point_saga_multistep(A, b, na, one[0], starts, one[1], one[2], sc, B,
                             mode=jfb.MODE_HUBER)
    tfb.point_saga_multistep_streamed(A, b, na, two[0], starts, two[1],
                                      two[2], sc, B, mode=jfb.MODE_HUBER)
    for u, v in zip(one, two):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    assert (tfb.point_saga_multistep.launches,
            tfb.point_saga_multistep_streamed.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        tfb.point_saga_multistep(*(t.to("meta") for t in (A, b, na, one[0])),
                                 starts, one[1].to("meta"),
                                 one[2].to("meta"), sc.to("meta"), B)
    with pytest.raises(ValueError, match="mode 7"):
        tfb.pointprox_theta(7, b, b, b, b, 1.0, 1.0)


# ---------------------------------------------------------------------------
# the solver against JAX's stepwise runs
# ---------------------------------------------------------------------------

NL, nL = 64, 8


@pytest.fixture(scope="module")
def lsq():
    """Consistent system: b = A·x_true exactly, so argmin = x_true
    (``tests/test_point_saga.py``'s fixture)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((NL, nL))
    x_true = rng.standard_normal(nL)
    b = A @ x_true
    JF = JLeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                           scale=jnp.asarray(float(NL)))
    L = float(NL) * (A * A).sum(axis=1)
    return A, x_true, JF, port_oracle(JF), L


def _logistic(A, x_true):
    rng = np.random.default_rng(1)
    y = np.sign(A @ x_true)
    y[y == 0] = 1
    y[rng.choice(NL, NL // 4, replace=False)] *= -1
    return JLogisticRows(X=jnp.asarray(A), y=jnp.asarray(y))


@pytest.mark.parametrize("kind,block", [("lsq", True), ("logistic", True),
                                        ("lsq", False)],
                         ids=["lsq-block", "logistic-block", "lsq-iid"])
def test_point_saga_run_matches_jax_stepwise(lsq, kind, block):
    """30 stepwise steps of 4 rows in f64 from JAX's init, on JAX's block
    schedule or its iid draws: x, c and av at rtol 1e-10, atol 1e-12."""
    A, x_true, JF, F, L = lsq
    if kind == "logistic":
        JF = _logistic(A, x_true)
        F = port_oracle(JF)
    gamma = 0.7 if kind == "logistic" else 1.0 / (3.0 * L.max())
    key = jax.random.PRNGKey(5)
    jcfg = jps.PointSAGACfg(N=NL, batch=4, block=block)
    jst = jps.point_saga_init(JF, JZero(), jnp.zeros(nL), jnp.asarray(gamma),
                              key, jcfg)
    steps = 30
    if block:
        sched = dict(starts=np.array(_gen_block_starts(key, jst.it, jcfg,
                                                       steps)))
    else:
        idx, k = [], jst.key
        for _ in range(steps):
            k, sub = jax.random.split(k)
            idx.append(np.asarray(jax.random.randint(sub, (4,), 0, NL,
                                                     dtype=jnp.int32)))
        sched = dict(idx=np.stack(idx))
    jst = jps.point_saga_run(JF, JZero(), jst, jcfg, steps)
    cfg = PointSAGACfg(N=NL, batch=4, block=block)
    st = point_saga_init(F, Zero(), torch.zeros(nL, dtype=torch.float64),
                         gamma, 0, cfg)
    st = point_saga_run(F, Zero(), st, cfg, steps, **sched)
    assert st.it == int(jst.it) == steps + 1
    for got, want in ((st.x, jst.x), (st.c, jst.c), (st.av, jst.av)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)


def _spy_kernels(monkeypatch, calls):
    for name in ("point_saga_multistep", "point_saga_multistep_streamed"):
        fn = getattr(tfb, name + "_ref")

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, a[4].shape[0]))
            return _fn(*a, **k)

        monkeypatch.setattr(tfb, name + "_ref", spy)


@pytest.mark.parametrize("importance", [False, True],
                         ids=["uniform", "importance"])
def test_point_saga_fused_driver_matches_stepwise(importance, monkeypatch):
    """The kernel driver (``cfg.fused`` and ``cfg.fused_stream``, the
    plain versions on the CPU) commits the stepwise stream, uniform or
    importance-sampled: 137 steps are a launch of 128 and a remainder
    launch of 9, with no stepwise tail. Against the stepwise run in f32
    at rtol 1e-5, atol 1e-6 of the largest entry."""
    JF, L = _kernel_oracle("logistic", "f32")
    F = port_oracle(JF)
    cfg = PointSAGACfg(N=N, batch=B, block=True, importance=importance)
    qcum = qinv = None
    if importance:
        from ciao_tpu_torch.solvers.saga import _importance_setup

        qcum, qinv, _, iwin = _importance_setup(L, N, B, True, torch.float32,
                                                "cpu")
        cfg = cfg._replace(iwin=iwin)
    st0 = point_saga_init(F, Zero(), torch.zeros(n), 3.0 / L.max(), 4,
                          cfg)._replace(qcum=qcum, qinv=qinv)
    ref = point_saga_run(F, Zero(), st0, cfg, 137)
    calls = []
    _spy_kernels(monkeypatch, calls)
    for field in ("fused", "fused_stream"):
        fcfg = cfg._replace(**{field: True})
        st = point_saga_run(F, Zero(), point_saga_init(
            F, Zero(), torch.zeros(n), 3.0 / L.max(), 4, fcfg)._replace(
                qcum=qcum, qinv=qinv), fcfg, 137)
        assert st.it == ref.it == 138
        for got, want in ((st.x, ref.x), (st.c, ref.c), (st.av, ref.av)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6 * want.abs().max().item())
    assert calls == [("point_saga_multistep", 128),
                     ("point_saga_multistep", 9),
                     ("point_saga_multistep_streamed", 128),
                     ("point_saga_multistep_streamed", 9)]


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

def _open_gate(monkeypatch):
    """Open the kernels' gate for CPU tensors (shape conditions only)."""
    monkeypatch.setattr(tfb, "saga_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)


def test_facade_setup_matches_jax(monkeypatch):
    """The facade's γ and importance schedule against JAX's
    ``PointSAGA._setup`` (8,192 rows, d = 64: the clipped π-scale CDF,
    qinv and γ = 1/(3·L_eff), f32, rtol 1e-6), and its routing: closed
    gate → stepwise; the opened gate → #12 for N ≤ RESIDENT_MAX_ROWS, #15
    above it; an oracle mode the kernels do not carry → stepwise."""
    Np, npx, Bp = 8192, 16, 128
    prob = make_lasso(N=Np, n=npx, p=4, seed=3, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(Np), jnp.float32))
    F = port_oracle(JF)
    x0 = torch.zeros(npx)
    for imp in (False, True):
        kw = dict(batch=Bp, block_sampling=True, importance_sampling=imp)
        jst = ciao_tpu.PointSAGA(**kw)._setup(
            jnp.zeros(npx, jnp.float32), JF, None, prob.L, None)[4]()
        _, _, _, cfg, init = PointSAGA(**kw)._setup(x0, F, None, prob.L, None)
        st = init()
        np.testing.assert_allclose(st.gamma.numpy(), np.asarray(jst.gamma),
                                   rtol=1e-6)
        assert (cfg.fused, cfg.fused_stream, cfg.importance) == (
            False, False, imp)
        if imp:
            assert cfg.iwin == 64 and cfg.istrat
            np.testing.assert_allclose(st.qcum.numpy(), np.asarray(jst.qcum),
                                       rtol=1e-6)
            np.testing.assert_allclose(st.qinv.numpy(), np.asarray(jst.qinv),
                                       rtol=1e-6)
    _open_gate(monkeypatch)
    kw = dict(batch=Bp, block_sampling=True)
    cfg = PointSAGA(**kw)._setup(x0, F, None, prob.L, None)[3]
    assert (cfg.fused, cfg.fused_stream) == (True, False)
    st = PointSAGA(**kw)._setup(x0, F, None, prob.L, None)[4]()
    np.testing.assert_array_equal(st.na8.numpy(),
                                  tps._sqnorms(F, Np).numpy())
    monkeypatch.setattr(tps, "RESIDENT_MAX_ROWS", Np // 2)
    cfg = PointSAGA(**kw)._setup(x0, F, None, prob.L, None)[3]
    assert (cfg.fused, cfg.fused_stream) == (False, True)
    monkeypatch.setattr(F, "coeff_mode", 9)
    cfg = PointSAGA(**kw)._setup(x0, F, None, prob.L, None)[3]
    assert (cfg.fused, cfg.fused_stream) == (False, False)


def test_facade_errors(lsq):
    """The refusals of JAX's facade: a separate g, an oracle without the
    pointprox protocol, no L and no γ, N not divisible by batch under
    block sampling, importance sampling without blocks or without L."""
    A, x_true, JF, F, L = lsq
    z0 = torch.zeros(nL, dtype=torch.float64)
    with pytest.raises(ValueError, match="composite"):
        PointSAGA(maxit=2)(z0, F=F, g=NormL1(torch.tensor(0.1)), L=L)
    Fd = DiagQuadratic(torch.ones((NL, nL), dtype=torch.float64),
                       torch.ones((NL, nL), dtype=torch.float64))
    with pytest.raises(ValueError, match="pointprox"):
        PointSAGA(maxit=2)(z0, F=Fd, L=np.ones(NL))
    with pytest.raises(ValueError, match="pointprox"):
        PointSAGA(maxit=2)(z0, N=NL, L=L)  # F=None: the zero oracle
    with pytest.raises(ValueError, match="smoothness"):
        PointSAGA(maxit=2)(z0, F=F)
    with pytest.raises(ValueError, match="divisible"):
        PointSAGA(maxit=2, batch=5, block_sampling=True)(z0, F=F, L=L)
    with pytest.raises(ValueError, match="block_sampling"):
        PointSAGA(maxit=2, importance_sampling=True)(z0, F=F, L=L)
    with pytest.raises(ValueError, match="provide L"):
        PointSAGA(maxit=2, batch=8, block_sampling=True,
                  importance_sampling=True, gamma=0.1)(z0, F=F)
    with pytest.raises(ValueError, match="gamma"):
        PointSAGA(gamma=-1.0)


def test_facade_converges_and_iterator(lsq):
    """``tests/test_point_saga.py``'s bars: on the consistent system the
    facade reaches x_true (‖x − x*‖ < 1e-8 in 3,000 steps; < 1e-4 in
    1,500 block steps of 8 rows); the iterator starts at x0 and agrees
    with a maxit = 5 solve bit for bit."""
    A, x_true, JF, F, L = lsq
    z0 = torch.zeros(nL, dtype=torch.float64)
    x, it = PointSAGA(maxit=3000)(z0, F=F, L=L)
    assert it == 3000 and np.linalg.norm(x.numpy() - x_true) < 1e-8
    x, _ = PointSAGA(maxit=1500, batch=8, block_sampling=True)(z0, F=F, L=L)
    assert np.linalg.norm(x.numpy() - x_true) < 1e-4
    solver = PointSAGA(maxit=5)
    states = list(take(iter(solver.iterator(z0, F=F, L=L)), 5))
    assert torch.equal(solution(states[0]), z0)
    assert torch.equal(solution(states[-1]), solver(z0, F=F, L=L)[0])


def test_point_saga_rebase_rederives_sqnorms(lsq):
    """After a storage swap (f64 → int8 rows) on a kernel route,
    ``point_saga_rebase`` recomputes av from the table and the row
    square-norms under the new rows, as JAX's does (its (8, N/8) slab
    flattened; rtol 1e-12)."""
    A, x_true, JF, F, L = lsq
    key = jax.random.PRNGKey(3)
    jcfg = jps.PointSAGACfg(N=NL, batch=4, block=True, fused=True)
    jst = jps.point_saga_init(JF, JZero(), jnp.zeros(nL),
                              jnp.asarray(1.0 / (3.0 * L.max())), key, jcfg)
    jst = jps.point_saga_run(JF, JZero(), jst,
                             jcfg._replace(fused=False), 7)
    J8 = JF.with_storage("int8")
    jre = jps.point_saga_rebase(J8, JZero(), jst, jcfg)
    st = point_saga_state_from_numpy(jst.gamma, jst.c, jst.av, jst.x, jst.it,
                                     na8=jst.na8, device="cpu")
    cfg = PointSAGACfg(N=NL, batch=4, block=True, fused=True)
    re = point_saga_rebase(port_oracle(J8), Zero(), st, cfg)
    for got, want in ((re.av, jre.av), (re.na8, jre.na8)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1),
                                   rtol=1e-12)
    assert not np.allclose(re.na8.numpy(), st.na8.numpy(), rtol=1e-9)
    stepwise = point_saga_rebase(port_oracle(J8), Zero(), st,
                                 cfg._replace(fused=False))
    assert stepwise.na8 is st.na8


def test_new_entry_points_default_to_the_card(lsq, monkeypatch):
    """With a card present, the SSNM and PointSAGA facades and the new
    oracles' constructors put their tensors on cuda:0 when the caller
    names no device and passes no tensor (the CPU build of torch then
    refuses, which shows where they were headed); CPU tensors or
    ``device="cpu"`` keep the CPU."""
    from ciao_tpu_torch import SSNM
    from ciao_tpu_torch.oracles import (
        HuberRows, LogisticRows, PoissonRows, SquaredHingeRows,
    )

    A, x_true, JF, F, L = lsq
    y = np.sign(A[:, 0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for make in (lambda: LogisticRows(A, y), lambda: HuberRows(A, y),
                 lambda: SquaredHingeRows(A, y), lambda: PoissonRows(A, y)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make()
    assert LogisticRows(torch.tensor(A), torch.tensor(y)).A.device.type == \
        "cpu"
    for solver, kw in ((SSNM(maxit=2, batch=4), dict(g=NormL1(0.1))),
                       (PointSAGA(maxit=2), {})):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            solver([0.0] * nL, F=F, L=L, **kw)
        x, _ = solver(torch.zeros(nL, dtype=torch.float64), F=F, L=L, **kw)
        assert x.device.type == "cpu"
        x, _ = type(solver)(**{**solver.__dict__, "device": "cpu"})(
            [0.0] * nL, F=F, L=L, **kw)
        assert x.device.type == "cpu"
