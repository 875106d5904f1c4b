"""The port's SSNM against the JAX package on the CPU.

The plain versions of kernels #19 and #13 (``ssnm_multistep_ref`` and
``ssnm_multistep_streamed_ref``, against the Pallas kernels in interpret
mode, the streamed one with masked steps), the stepwise ``ssnm_run`` on
JAX's own schedule in f64, τ = 1 against the port's minibatch SAGA bit
for bit (``tests/test_ssnm.py:41``), the fused driver (on the plain
versions) against the stepwise stream with a remainder launch, the
facade's defaults, routing and errors, and ``ssnm_rebase``. torch cannot
draw threefry, so the parity tests hand JAX's block starts to
``ssnm_run``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.oracles import LogisticRows as JLogisticRows
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import ssnm as jssnm
from ciao_tpu.solvers.saga import _gen_block_starts
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch.convert import (
    least_squares_from_numpy, logistic_from_numpy, ssnm_state_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers import (
    SAGACfg, SAGAState, SSNM, SSNMCfg, saga_run, solution, ssnm_init,
    ssnm_rebase, ssnm_run, take,
)
from ciao_tpu_torch.solvers import finito as tfinito
from ciao_tpu_torch.solvers.base import Status
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    """A torch copy of a numpy array (the kernels update in place)."""
    return torch.tensor(np.asarray(a))


def _port(JF):
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    if isinstance(JF, JLogisticRows):
        return logistic_from_numpy(np.asarray(JF.X), np.asarray(JF.y), rs,
                                   device="cpu")
    return least_squares_from_numpy(np.asarray(JF.A), np.asarray(JF.b),
                                    np.asarray(JF.scale), rs, device="cpu")


def _rows(JF):
    A = JF.X if isinstance(JF, JLogisticRows) else JF.A
    if A.dtype == jnp.bfloat16:
        return _t(np.asarray(A.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(A))


# ---------------------------------------------------------------------------
# kernels #19 and #13: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

N, n, B, K = 1024, 128, 128, 12
d = N // B
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
# (oracle, rows' storage, precision, τ): f32 exact and at "default" (JAX's
# reference on bf16-rounded rows: XLA on the CPU keeps f32 dots exact at
# any precision), bf16 and int8 rows, τ = 1 (y ≡ x), and logistic rows
CASES = [("lsq", "f32", "highest", 0.5), ("lsq", "f32", "default", 0.5),
         ("lsq", "bf16", "highest", 0.5), ("lsq", "int8", "highest", 0.5),
         ("lsq", "f32", "highest", 1.0), ("logistic", "int8", "highest", 0.5)]
IDS = ["f32", "f32-default", "bf16", "int8", "tau1", "logistic-int8"]


def _kernel_problem(kind, storage):
    """Rows in both packages with an SSNM-like state: a table at x0, the
    stored points near it, gb the table mean, and K block starts with
    repeats."""
    prob = make_lasso(N=N, n=n, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    if kind == "lsq":
        JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                               scale=jnp.asarray(float(N), jnp.float32))
    else:
        y = np.sign(np.random.default_rng(1).standard_normal(N))
        JF = JLogisticRows(X=jnp.asarray(prob.A * 8.0),
                           y=jnp.asarray(y.astype(np.float32)))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rng = np.random.default_rng(7)
    x0 = (0.05 * rng.standard_normal(n)).astype(np.float32)
    c = np.asarray(JF.coeff_all(jnp.asarray(x0)), np.float32)
    gb = np.asarray(JF.apply_all(jnp.asarray(c)), np.float32) / N
    zb = (x0 + 0.01 * rng.standard_normal((d, n))).astype(np.float32)
    starts = (rng.integers(0, d, K) * B).astype(np.int32)
    starts[5] = starts[4]  # a repeat on the next step: zb_j is then y
    Lmax = float(np.max(prob.L))
    return prob, JF, x0, c, gb, zb, starts, Lmax


def _scalars(kind, JF, Lmax, tau, lam):
    eta = 1.0 / (3.0 * tau * Lmax)
    scale = float(JF.scale) if kind == "lsq" else 1.0
    mode = jfb.MODE_LSQ if kind == "lsq" else jfb.MODE_LOGISTIC
    return np.array([scale, eta, eta * lam, 1.0 / B, 1.0 / N, mode, tau, 0.0],
                    np.float32)


def _jax_rows(JF, precision):
    A = JF.X if isinstance(JF, JLogisticRows) else JF.A
    return A.astype(jnp.bfloat16) if precision == "default" else A


@pytest.mark.parametrize("kind,storage,precision,tau", CASES, ids=IDS)
def test_ssnm_multistep_ref_matches_pallas(kind, storage, precision, tau):
    """K = 12 steps of the plain version of #19 against the Pallas kernel
    in interpret mode on one schedule (a block repeated on consecutive
    steps): x, gb, c and zb at rtol 1e-4, atol 1e-6 of the largest
    entry."""
    prob, JF, x0, c, gb, zb, starts, Lmax = _kernel_problem(kind, storage)
    sc = _scalars(kind, JF, Lmax, tau, prob.lam)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    offs = np.asarray(JF.b if kind == "lsq" else JF.y)
    with pltpu.force_tpu_interpret_mode():
        jc, jzb, jx, jgb = jfb.ssnm_multistep(
            _jax_rows(JF, precision), jnp.asarray(offs).reshape(SLAB),
            jnp.asarray(starts), jnp.asarray(c).reshape(SLAB),
            jnp.asarray(zb), jnp.asarray(x0)[None], jnp.asarray(gb)[None],
            jnp.asarray(sc)[None], B, precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB))
    tc, tzb, tx, tgb = _t(c), _t(zb), _t(x0), _t(gb)
    out = tfb.ssnm_multistep(_rows(JF), _t(offs), _t(starts), tc, tzb, tx,
                             tgb, _t(sc), B, precision=precision,
                             rs=None if rs is None else _t(rs))
    assert all(o is t for o, t in zip(out, (tc, tzb, tx, tgb)))  # in place
    assert not np.array_equal(tx.numpy(), x0)
    for got, want in ((tx, np.asarray(jx)[0]), (tgb, np.asarray(jgb)[0]),
                      (tc, np.asarray(jc).reshape(N)), (tzb, np.asarray(jzb))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("fc", [6, 4], ids=["all", "masked"])
def test_ssnm_streamed_ref_matches_pallas(fc):
    """#13's plain version against the streamed Pallas kernel in
    interpret mode, int8 rows, 6 distinct blocks of d = 8 (the clamped
    JAX driver never revisits a block in a launch). With the clamp count
    f = 6 every step commits; with f = 4 the masked steps leave x, gb, c
    and zb as step 3 left them (JAX redirects them to a free block, the
    port writes nothing) — and equal the first 4 steps alone bit for bit.
    rtol 1e-4, atol 1e-6 of the largest entry against JAX."""
    prob, JF, x0, c, gb, zb, _, Lmax = _kernel_problem("lsq", "int8")
    starts = (np.random.default_rng(3).permutation(d)[:6] * B).astype(
        np.int32)
    sc = _scalars("lsq", JF, Lmax, 0.5, prob.lam)
    rs = np.asarray(JF.row_scale)
    with pltpu.force_tpu_interpret_mode():
        jc, jzb, jx, jgb = jfb.ssnm_multistep_streamed(
            JF.A, jnp.asarray(JF.b)[None], jnp.asarray(starts),
            jnp.asarray(c)[None], jnp.asarray(zb), jnp.asarray(x0)[None],
            jnp.asarray(gb)[None], jnp.asarray(sc)[None], B,
            rs1=jnp.asarray(rs)[None], f=jnp.asarray(fc, jnp.int32))
    tc, tzb, tx, tgb = _t(c), _t(zb), _t(x0), _t(gb)
    tfb.ssnm_multistep_streamed(
        _rows(JF), _t(np.asarray(JF.b)), _t(starts), tc, tzb, tx, tgb,
        _t(sc), B, rs=_t(rs), f=torch.tensor([fc], dtype=torch.int32))
    for got, want in ((tx, np.asarray(jx)[0]), (tgb, np.asarray(jgb)[0]),
                      (tc, np.asarray(jc)[0]), (tzb, np.asarray(jzb))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
    ref = [_t(c), _t(zb), _t(x0), _t(gb)]
    tfb.ssnm_multistep_ref(_rows(JF), _t(np.asarray(JF.b)), _t(starts[:fc]),
                           *ref, _t(sc), B, rs=_t(rs))
    for got, want in zip((tc, tzb, tx, tgb), ref):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_ssnm_wrappers_on_cpu():
    """CPU tensors take the plain versions and count no launch; a device
    with no kernel raises; f counts on both."""
    prob, JF, x0, c, gb, zb, starts, Lmax = _kernel_problem("lsq", "f32")
    A, b = _rows(JF), _t(np.asarray(JF.b))
    sc = _t(_scalars("lsq", JF, Lmax, 0.5, prob.lam))
    before = (tfb.ssnm_multistep.launches,
              tfb.ssnm_multistep_streamed.launches)
    one = [_t(c), _t(zb), _t(x0), _t(gb)]
    tfb.ssnm_multistep(A, b, _t(starts), *one, sc, B)
    two = [_t(c), _t(zb), _t(x0), _t(gb)]
    tfb.ssnm_multistep_streamed(A, b, _t(starts), *two, sc, B)
    for u, v in zip(one, two):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    assert (tfb.ssnm_multistep.launches,
            tfb.ssnm_multistep_streamed.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        tfb.ssnm_multistep(A.to("meta"), b.to("meta"), _t(starts),
                           *(t.to("meta") for t in one), sc.to("meta"), B)


# ---------------------------------------------------------------------------
# the solver against JAX's stepwise run
# ---------------------------------------------------------------------------

NL, nL, BL = 64, 8, 4


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=NL, n=nL, p=3, seed=3)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(NL)))
    jg = JNormL1(lam=jnp.asarray(prob.lam))
    return prob, JF, jg, _port(JF), NormL1(torch.tensor(prob.lam))


@pytest.mark.parametrize("tau", [0.3, 1.0])
def test_ssnm_run_matches_jax_stepwise(lasso, tau):
    """40 stepwise steps in f64 from JAX's init on JAX's schedule: x, c,
    ḡ and zb at rtol 1e-10, atol 1e-12."""
    prob, JF, jg, F, g = lasso
    key = jax.random.PRNGKey(5)
    x0 = jnp.zeros(nL, jnp.float64)
    eta = 1.0 / (3.0 * tau * float(np.max(prob.L)))
    jcfg = jssnm.SSNMCfg(N=NL, batch=BL)
    jst = jssnm.ssnm_init(JF, jg, x0, jnp.asarray(tau), jnp.asarray(eta), key,
                          jcfg)
    starts = np.array(_gen_block_starts(key, jst.it, jcfg, 40))
    jst = jssnm.ssnm_run(JF, jg, jst, jcfg, 40)
    cfg = SSNMCfg(N=NL, batch=BL)
    st = ssnm_init(F, g, torch.zeros(nL, dtype=torch.float64), tau, eta, 0,
                   cfg)
    st = ssnm_run(F, g, st, cfg, 40, starts=starts)
    assert st.it == int(jst.it) == 41
    for got, want in ((st.x, jst.x), (st.c, jst.c), (st.gbar, jst.gbar),
                      (st.zb, jst.zb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   atol=1e-12)


def test_ssnm_tau1_is_exactly_minibatch_saga(lasso):
    """At τ = 1 the momentum point is the iterate, and the step IS the
    port's minibatch-SAGA coefficient block step: bit for bit from one
    state on one schedule (η = γ)."""
    prob, JF, jg, F, g = lasso
    gamma = 1.0 / (3.0 * float(np.max(prob.L)))
    x0 = torch.zeros(nL, dtype=torch.float64)
    cfg = SSNMCfg(N=NL, batch=BL)
    st = ssnm_init(F, g, x0, 1.0, gamma, 7, cfg)
    acfg = SAGACfg(N=NL, sag=False, batch=BL, block=True, coeff=True)
    ast = SAGAState(s=st.c, gamma=torch.tensor(gamma, dtype=torch.float64),
                    av=st.gbar, z=x0, seed=7, it=st.it, status=st.status)
    starts = np.random.default_rng(0).integers(0, NL // BL, 5) * BL
    for k in range(5):
        st = ssnm_run(F, g, st, cfg, 1, starts=starts[k:k + 1])
        ast = saga_run(F, g, ast, acfg, 1, starts=starts[k:k + 1])
        assert torch.equal(st.x, ast.z)
        assert torch.equal(st.c, ast.s)
        assert torch.equal(st.gbar, ast.av)


def test_ssnm_fused_driver_matches_stepwise():
    """The kernel driver (``cfg.fused`` and ``cfg.fused_stream``, the
    kernels' plain versions on the CPU) commits the stepwise stream: 137
    steps are one launch of 128 and a remainder launch of 9, with no
    stepwise tail, and equal the stepwise run on the (seed, it) draws in
    f32 at rtol 1e-5, atol 1e-7 of the largest entry."""
    prob, JF, x0, c, gb, zb, starts, Lmax = _kernel_problem("lsq", "f32")
    F = _port(JF)
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    cfg = SSNMCfg(N=N, batch=B)
    st0 = ssnm_init(F, g, torch.zeros(n), 0.5, 1.0 / (1.5 * Lmax), 3, cfg)
    ref = ssnm_run(F, g, st0, cfg, 137)
    calls = []
    for field in ("fused", "fused_stream"):
        name = "ssnm_multistep" + ("_streamed" if field == "fused_stream"
                                   else "")
        ref_fn = getattr(tfb, name + "_ref")

        def spy(*a, _fn=ref_fn, **k):
            calls.append(a[2].shape[0])
            return _fn(*a, **k)

        orig = getattr(tfb, name + "_ref")
        setattr(tfb, name + "_ref", spy)
        try:
            st = ssnm_run(F, g, st0, cfg._replace(**{field: True}), 137)
        finally:
            setattr(tfb, name + "_ref", orig)
        assert st.it == ref.it == 138
        for got, want in ((st.x, ref.x), (st.c, ref.c), (st.gbar, ref.gbar),
                          (st.zb, ref.zb)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-7 * want.abs().max().item())
    assert calls == [128, 9, 128, 9]
    assert torch.equal(st0.x, torch.zeros(n))  # the run copied the state


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

def _open_gate(monkeypatch):
    """Open the kernels' gate for CPU tensors (shape conditions only):
    the facade's routing can then be held on the CPU, the kernels'
    wrappers running their plain versions."""
    monkeypatch.setattr(tfb, "saga_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)


def test_facade_defaults_match_jax(lasso):
    """τ and η of the facade against JAX's ``SSNM._setup``: τ = ½ and
    η = 1/(3τL_max) by default; τ = min(½, √(Nσ/(3L_max))) with σ; an
    explicit τ and η pass through (f64, rtol 1e-14)."""
    prob, JF, jg, F, g = lasso
    for kw in ({}, {"sigma": 1e-3}, {"sigma": 50.0}, {"tau": 0.7, "eta": 0.01}):
        jst = jssnm.SSNM(batch=BL, **kw)._setup(
            jnp.zeros(nL), JF, jg, prob.L, None)[4]()
        st = SSNM(batch=BL, **kw)._setup(
            torch.zeros(nL, dtype=torch.float64), F, g,
            torch.tensor(prob.L), None)[4]()
        for a, b_ in ((st.tau, jst.tau), (st.eta, jst.eta)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                       rtol=1e-14)
        np.testing.assert_array_equal(st.zb.numpy(), np.asarray(jst.zb))


def test_facade_routing_and_errors(lasso, monkeypatch):
    """Closed gate (CPU) → stepwise; the opened gate → kernel #19 within
    JAX's resident bounds, #13 beyond them (a lowered RESIDENT_MAX_ROWS);
    the errors of JAX's facade; a complex iterate on real rows runs the
    real trajectory stepwise."""
    prob, JF, jg, F, g = lasso
    x0 = torch.zeros(nL, dtype=torch.float64)
    cfg = SSNM(batch=BL)._setup(x0, F, g, prob.L, None)[3]
    assert (cfg.fused, cfg.fused_stream) == (False, False)
    _open_gate(monkeypatch)
    cfg = SSNM(batch=BL)._setup(x0, F, g, prob.L, None)[3]
    assert (cfg.fused, cfg.fused_stream) == (True, False)
    monkeypatch.setattr(tfinito, "RESIDENT_MAX_ROWS", NL // 2)
    cfg = SSNM(batch=BL)._setup(x0, F, g, prob.L, None)[3]
    assert (cfg.fused, cfg.fused_stream) == (False, True)
    with pytest.raises(ValueError, match="rank-1"):
        SSNM(batch=BL)(x0, N=NL, L=prob.L)  # F=None: the zero oracle
    with pytest.raises(ValueError, match="divisible"):
        SSNM(batch=5)(x0, F=F, g=g, L=prob.L)
    with pytest.raises(ValueError, match="provide the smoothness"):
        SSNM(batch=BL)(x0, F=F, g=g)
    with pytest.raises(ValueError, match="tau"):
        SSNM(tau=1.5)
    monkeypatch.undo()  # the real gate: a complex iterate closes it
    xc, _ = SSNM(maxit=5, batch=BL)(x0.to(torch.complex128), F=F, g=g,
                                    L=prob.L)
    xr, _ = SSNM(maxit=5, batch=BL)(x0, F=F, g=g, L=prob.L)
    assert xc.dtype == torch.complex128
    np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_facade_converges_and_iterator(lasso):
    """The facade reaches the planted Lasso's optimum (cost − f* < 1e-4 in
    4,000 steps of 4 rows, ``tests/test_ssnm.py``'s bar); the iterator's
    first state is the init state and its states advance one step each."""
    prob, JF, jg, F, g = lasso
    x0 = torch.zeros(nL, dtype=torch.float64)
    x, it = SSNM(maxit=4000, batch=BL)(x0, F=F, g=g, L=prob.L)
    assert it == 4000
    assert prob.cost(x.numpy()) - prob.f_star < 1e-4
    it_ = SSNM(batch=BL).iterator(x0, F=F, g=g, L=prob.L)
    assert it_.x0 is x0
    states = list(take(iter(it_), 3))
    assert torch.equal(solution(states[0]), x0)
    assert [s.it for s in states] == [1, 2, 3]
    assert states[2].status == Status.RUNNING


def test_ssnm_rebase_matches_jax(lasso):
    """After a storage swap (f64 → int8 rows) ``ssnm_rebase`` recomputes
    ḡ from the table under the new rows, as JAX's does (rtol 1e-12)."""
    prob, JF, jg, F, g = lasso
    jcfg = jssnm.SSNMCfg(N=NL, batch=BL)
    key = jax.random.PRNGKey(2)
    jst = jssnm.ssnm_init(JF, jg, jnp.zeros(nL), jnp.asarray(0.5),
                          jnp.asarray(1e-3), key, jcfg)
    jst = jssnm.ssnm_run(JF, jg, jst, jcfg, 9)
    J8 = JF.with_storage("int8")
    jre = jssnm.ssnm_rebase(J8, jg, jst, jcfg)
    st = ssnm_state_from_numpy(jst.tau, jst.eta, jst.c, jst.zb, jst.gbar,
                               jst.x, jst.it, device="cpu")
    re = ssnm_rebase(_port(J8), g, st, SSNMCfg(N=NL, batch=BL))
    np.testing.assert_allclose(re.gbar.numpy(), np.asarray(jre.gbar),
                               rtol=1e-12, atol=1e-14)
    assert re.zb is st.zb and re.c is st.c
    assert not isinstance(g, Zero)
