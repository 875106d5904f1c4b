"""SAGA's full (N, n) gradient table and the ``F=None`` facades against
the JAX package on the CPU.

JAX's ``saga_init`` + ``saga_run`` on the full table (its stepwise XLA
steps, and its fused path through the Pallas kernel ``saga_block_update``
in TPU interpret mode) against the port's, with JAX's schedule handed
over: block starts (``_gen_block_starts``), importance draws and weights
(``_gen_importance_draws``), or the iid rows of its key chain. f64 runs
agree to 1e-10; f32 runs of the kernel path to JAX's fused-vs-stepwise
bounds (z rtol 1e-4, s and av rtol 1e-3, atols scaled by the largest
entry), as ``tests/test_ops.py``'s equivalence suites.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu.utils.problems import make_lasso
import ciao_tpu_torch as ct
from ciao_tpu_torch.convert import least_squares_from_numpy, saga_state_from_numpy
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import saga as tsaga
from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_rebase, saga_run
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol, atol_rel, tag=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=tag)


def _pair(N, n, dtype, storage="f32", seed=2, p=3):
    prob = make_lasso(N=N, n=n, p=p, seed=seed, dtype=dtype,
                      well_conditioned=True)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N), prob.A.dtype))
    if storage != "f32":
        JF = JF.with_storage(storage)
    F = least_squares_from_numpy(np.asarray(JF.A), np.asarray(JF.b),
                                 np.asarray(JF.scale), device="cpu")
    jg = JNormL1(lam=jnp.asarray(prob.lam, prob.A.dtype))
    g = NormL1(torch.tensor(prob.lam, dtype=F.b.dtype))
    return prob, JF, F, jg, g


def _jax_iid_rows(key, steps, N, B):
    """JAX's iid full-table rows: one split of the state's key a step,
    then ``choice`` without replacement (``randint`` for B = 1)."""
    rows = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        if B == 1:
            rows.append(np.asarray(jax.random.randint(sub, (1,), 0, N)))
        else:
            rows.append(np.asarray(jax.random.choice(sub, N, (B,),
                                                     replace=False)))
    return np.stack(rows)


@pytest.mark.parametrize("mode", ["block", "iid", "block-sag", "iid-sag",
                                  "importance"])
def test_full_table_matches_jax_f64(mode):
    """The stepwise full-table steps (block, iid, SAG's average-first
    order, importance-weighted blocks) on JAX's schedule: z, av and the
    (N, n) table within 1e-10 after 60 steps; the init states agree."""
    N, n, B, steps = 64, 8, 8, 60
    prob, JF, F, jg, g = _pair(N, n, np.float64)
    sag, block = mode.endswith("sag"), not mode.startswith("iid")
    imp = mode == "importance"
    gamma = 1.0 / ((16.0 if sag else 3.0) * float(np.max(prob.L)))
    key = jax.random.PRNGKey(4)
    kw = dict(N=N, sag=sag, batch=B, block=block, importance=imp)
    jcfg = jsaga.SAGACfg(**kw)
    x0 = np.zeros(n)
    jst0 = jsaga.saga_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key,
                           jcfg)
    sched = {}
    cfg = SAGACfg(**kw)
    st0 = saga_init(F, g, _t(x0), gamma, 0, cfg)
    if imp:
        d = N // B
        q = np.max(np.asarray(prob.L).reshape(d, B), axis=1)
        q /= q.sum()
        qcum, qinv = np.cumsum(q), 1.0 / (d * q)
        qcum /= qcum[-1]
        jst0 = jst0._replace(qcum=jnp.asarray(qcum), qinv=jnp.asarray(qinv))
        st0 = st0._replace(qcum=_t(qcum), qinv=_t(qinv))
        starts, wgts = jsaga._gen_importance_draws(key, 1, jcfg, jst0.qcum,
                                                   jst0.qinv, steps)
        sched = dict(starts=_t(starts), wgts=_t(wgts))
    elif block:
        sched = dict(starts=_t(jsaga._gen_block_starts(key, 1, jcfg, steps)))
    else:
        sched = dict(idx=_jax_iid_rows(key, steps, N, B))
    for name in ("s", "av", "z"):
        _close(getattr(st0, name).numpy(), getattr(jst0, name), 1e-12, 1e-12,
               f"init {name}")
    jst = jsaga.saga_run(JF, jg, jst0, jcfg, steps)
    st = saga_run(F, g, st0, cfg, steps, **sched)
    assert st.it == int(jst.it) == steps + 1
    assert st.s.shape == (N, n)
    for name in ("z", "av", "s"):
        _close(getattr(st, name).numpy(), getattr(jst, name), 1e-10, 1e-10,
               f"{mode} {name}")
    # the run copied the table it writes in place
    np.testing.assert_array_equal(st0.s.numpy(), np.asarray(jst0.s))


@pytest.mark.parametrize("storage,sag", [("f32", False), ("bf16", False),
                                         ("f32", True)],
                         ids=["f32", "bf16", "f32-sag"])
def test_full_table_kernel_path_matches_jax(storage, sag, monkeypatch):
    """The kernel path (``cfg.fused``: each block step one call of kernel
    #1's plain version) against JAX's fused run (the Pallas kernel in
    interpret mode) on its block schedule, 24 steps at tests/test_ops.py's
    N = 512, n = 128, B = 128; JAX's fused-vs-stepwise bounds."""
    N, n, B, steps = 512, 128, 128, 24
    prob, JF, F, jg, g = _pair(N, n, np.float32, storage, seed=1, p=4)
    gamma = np.float32(1.0 / ((16.0 if sag else 3.0) * np.max(prob.L)))
    key = jax.random.PRNGKey(5)
    kw = dict(N=N, sag=sag, batch=B, block=True, fused=True)
    jcfg = jsaga.SAGACfg(**kw)
    x0 = np.zeros(n, np.float32)
    jst0 = jsaga.saga_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key,
                           jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jsaga.saga_run(JF, jg, jst0, jcfg, steps)
    starts = _t(jsaga._gen_block_starts(key, 1, jcfg, steps))
    calls = []
    real = tfb.saga_block_update
    monkeypatch.setattr(tfb, "saga_block_update",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = SAGACfg(**kw)
    st = saga_run(F, g, saga_init(F, g, _t(x0), _t(gamma), 0, cfg), cfg,
                  steps, starts=starts)
    assert len(calls) == steps and st.it == int(jst.it)
    _close(st.z.numpy(), jst.z, 1e-4, 1e-6, "z")
    _close(st.av.numpy(), jst.av, 1e-3, 1e-5, "av")
    _close(st.s.numpy(), jst.s, 1e-3, 1e-5, "s")


@pytest.mark.parametrize("case", ["f32", "bf16", "f32-default"])
def test_saga_block_update_ref_matches_pallas(case):
    """Kernel #1's plain version against the Pallas kernel in interpret
    mode (tests/test_ops.py:37's shape: N = 512, n = 256, B = 128, start
    256): the block's rows and the innovation within 1e-5 of their
    largest entries, every other row bit for bit. bf16 rows at "highest"
    keep z unrounded in the margin (``_row_grad``); "default" rounds both
    operands, so its JAX reference takes bf16-valued rows and z (the CPU's
    XLA dots are exact at any precision)."""
    N, n, B, start = 512, 256, 128, 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    s = rng.standard_normal((N, n)).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    if case != "f32":
        A = bf(A)
    if case == "f32-default":
        z = bf(z)
    jA = jnp.asarray(A).astype(jnp.bfloat16) if case == "bf16" else A
    with pltpu.force_tpu_interpret_mode():
        js, jinnov = jfb.saga_block_update(
            jnp.asarray(jA), jnp.asarray(b)[:, None], jnp.asarray(s),
            jnp.asarray(z)[None], jnp.asarray(start),
            jnp.full((1, 1), float(N), jnp.float32), B)
    rows = _t(A).to(torch.bfloat16) if case == "bf16" else _t(A)
    ts = _t(s)
    before = tfb.saga_block_update.launches
    out, innov = tfb.saga_block_update(
        rows, _t(b), ts, _t(z), torch.tensor(start),
        torch.tensor([float(N)]), B,
        precision="default" if case == "f32-default" else "highest")
    assert out is ts and tfb.saga_block_update.launches == before
    sl = slice(start, start + B)
    _close(ts[sl].numpy(), np.asarray(js)[sl], 1e-5, 1e-5, "s")
    _close(innov.numpy(), jinnov, 1e-5, 1e-5, "innov")
    outside = np.ones(N, bool)
    outside[sl] = False
    np.testing.assert_array_equal(ts.numpy()[outside], s[outside])


def test_full_table_facade_routes_as_jax(monkeypatch):
    """The facade's table and kernel choice against JAX's ``SAGA._setup``
    (JAX's TPU gates opened by ``on_tpu``, the port's gate for CPU
    tensors): ``table="auto"`` takes the coefficient table for rank-1
    rows and the full table otherwise; the full table's kernel serves
    f32 and bf16 rows with block sampling, not int8 rows and not
    importance sampling; a gated run calls kernel #1 once a step and ends
    where the stepwise run ends. The JAX guard on importance with the
    full-table kernel raises."""
    from ciao_tpu import runtime as jruntime

    N, n, B = 512, 128, 128
    prob, JF, F, jg, g = _pair(N, n, np.float32, seed=1, p=4)
    monkeypatch.setattr(jruntime, "on_tpu", lambda: True)
    monkeypatch.setattr(tfb, "saga_block_available",
                        lambda F, x0, B: F.num_terms % B == 0
                        and F.coeff_rows_scale() is None)
    cases = [dict(table="auto"), dict(table="full"),
             dict(table="full", storage="int8"),
             dict(table="full", importance_sampling=True),
             dict(table="coeff")]
    for kw in cases:
        storage = kw.pop("storage", "f32")
        jF = JF if storage == "f32" else JF.with_storage(storage)
        tF = least_squares_from_numpy(
            np.asarray(jF.A), np.asarray(jF.b), np.asarray(jF.scale),
            None if jF.row_scale is None else np.asarray(jF.row_scale),
            device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jcfg = ciao_tpu.SAGA(block_sampling=True, batch=B, **kw)._setup(
                jnp.zeros(n, jnp.float32), jF, jg, prob.L, N)[3]
        cfg = ct.SAGA(block_sampling=True, batch=B, **kw)._setup(
            torch.zeros(n), tF, g, prob.L, N)[3]
        assert (cfg.coeff, cfg.importance) == (jcfg.coeff, jcfg.importance)
        if not cfg.coeff:
            assert cfg.fused == jcfg.fused, kw
    calls = []
    real = tfb.saga_block_update
    monkeypatch.setattr(tfb, "saga_block_update",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    solver = ct.SAGA(maxit=21, table="full", block_sampling=True, batch=B)
    x, it = solver(torch.zeros(n), F=F, g=g, L=prob.L)
    assert len(calls) == it - 1 == 20
    monkeypatch.setattr(tfb, "saga_block_available", lambda *a: False)
    x2, _ = solver(torch.zeros(n), F=F, g=g, L=prob.L)
    _close(x.numpy(), x2.numpy(), 1e-4, 1e-6)
    bad = SAGACfg(N=N, sag=False, batch=B, block=True, fused=True,
                  importance=True)
    st = saga_init(F, g, torch.zeros(n), 0.01, 0, bad)
    with pytest.raises(ValueError, match="importance"):
        saga_run(F, g, st, bad, 1, starts=[0])


def test_full_table_facades_solve_planted_lasso():
    """tests/test_lasso.py's acceptance on the full table: SAGA (1,000
    steps) and SAG (10,000) on the planted N = 6 Lasso, and block
    sampling on a wider one, reach cost − f* < 1e-4 in f64; the table
    is (N, n) and a rebase leaves such a state as it is."""
    prob = make_lasso(N=6, n=3, p=2, seed=0)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), 6.0)
    g = NormL1(prob.lam)
    x0 = torch.zeros(3, dtype=torch.float64)
    for solver in (ct.SAGA(maxit=1000, table="full"),
                   ct.SAG(maxit=10000, table="full")):
        x, _ = solver(x0, F=F, g=g, L=prob.L)
        assert prob.cost(x.numpy()) - prob.f_star < 1e-4
    it = ct.SAGA(table="full").iterator(x0, F=F, g=g, L=prob.L)
    states = list(ct.take(iter(it), 3))
    assert states[0].s.shape == (6, 3) and states[2].it == 3
    assert it._rebase_fn(states[2]) is states[2]
    wide = make_lasso(N=64, n=8, p=2, seed=2, well_conditioned=True)
    Fw = LeastSquaresRows(_t(wide.A), _t(wide.b), 64.0)
    x, _ = ct.SAGA(maxit=3000, table="full", block_sampling=True, batch=8)(
        torch.zeros(8, dtype=torch.float64), F=Fw, g=NormL1(wide.lam),
        L=wide.L)
    assert wide.cost(x.numpy()) - wide.f_star < 1e-4


def test_full_table_state_from_numpy():
    """A JAX full-table state carried over (``table="full"`` keeps the
    (N, n) table) steps on as JAX's does, and a rebase returns it
    unchanged in both packages."""
    N, n, B = 64, 8, 8
    prob, JF, F, jg, g = _pair(N, n, np.float64)
    key = jax.random.PRNGKey(1)
    jcfg = jsaga.SAGACfg(N=N, sag=False, batch=B, block=True)
    jst = jsaga.saga_run(JF, jg, jsaga.saga_init(
        JF, jg, jnp.zeros(n), jnp.asarray(0.01), key, jcfg), jcfg, 7)
    st = saga_state_from_numpy(jst.s, jst.z, jst.av, jst.gamma, jst.it,
                               device="cpu", table="full")
    assert st.s.shape == (N, n) and st.it == 8
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True)
    assert saga_rebase(F, st, cfg) is st
    start = int(jsaga._gen_block_starts(key, 8, jcfg, 1)[0])
    j2 = jsaga.saga_step(JF, jg, jst, jcfg)
    t2 = tsaga.saga_step(F, g, st, cfg, start)
    _close(t2.z.numpy(), j2.z, 1e-12, 1e-12)
    _close(t2.s.numpy(), j2.s, 1e-12, 1e-12)
    with pytest.raises(ValueError, match="table"):
        saga_state_from_numpy(jst.s, jst.z, jst.av, jst.gamma, 1,
                              table="rows")


@pytest.mark.parametrize("facade", ["SAGA", "SVRG", "ForwardBackward",
                                    "Finito", "Proshi"])
def test_zero_oracle_facades_match_jax(facade):
    """``F=None``: each facade builds ``ZeroOracle(n_terms=N)`` as the
    JAX facade does, so a run is the prox iteration on x0 alone (SAGA on
    the full table, since the zero oracle is not rank 1), equal to JAX's
    to 1e-12 in f64; without N as well it raises JAX's "provide F or
    N"."""
    x0 = np.array([1.0, -2.0, 0.5, 0.05])
    kw = dict(maxit=7)
    if facade != "SAGA":
        kw["gamma"] = 0.1
    if facade in ("Finito", "Proshi"):
        kw["sweeping"] = 2  # the cyclic sweep: the same blocks in both
    jx, jit_ = getattr(ciao_tpu, facade)(**kw)(
        jnp.asarray(x0), g=JNormL1(lam=jnp.asarray(0.3)), L=np.ones(6), N=6)
    x, it = getattr(ct, facade)(**kw)(
        torch.tensor(x0), g=NormL1(0.3), L=np.ones(6), N=6)
    assert it == int(jit_) == 7
    _close(x.numpy(), jx, 1e-12, 1e-12, facade)
    with pytest.raises(ValueError, match="provide F or N"):
        getattr(ct, facade)(**kw)(torch.tensor(x0), g=NormL1(0.3))


@pytest.mark.parametrize("importance", [False, True],
                         ids=["uniform", "importance"])
def test_full_table_run_draws_the_stepwise_stream(importance):
    """A full-table block run draws all its steps' blocks (and weights) in
    one pass; the stream is the stepwise one, so ``saga_run`` ends bit for
    bit where ``saga_step`` repeated ends."""
    N, n, B = 64, 8, 8
    prob, JF, F, jg, g = _pair(N, n, np.float64)
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, importance=importance)
    st = saga_init(F, g, torch.zeros(n, dtype=torch.float64), 0.01, 3, cfg)
    if importance:
        q = np.linspace(1.0, 2.0, N // B)
        st = st._replace(qcum=_t(np.cumsum(q) / q.sum()),
                         qinv=_t(q.sum() / (q * (N // B))))
    run = saga_run(F, g, st, cfg, 25)
    for _ in range(25):
        st = tsaga.saga_step(F, g, st, cfg)
    assert run.it == st.it == 26
    for name in ("s", "av", "z"):
        torch.testing.assert_close(getattr(run, name), getattr(st, name),
                                   rtol=0, atol=0)
