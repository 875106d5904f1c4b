"""The port's tensor-parallel Katyusha, SARAH, L-SVRG, L-Katyusha,
Point-SAGA and SSNM against the JAX package, on four gloo ranks.

The port's ranks run in four processes spawned once for the module
(``tests/torch_parallel_worker.py``, which imports no JAX). The lockstep
cases run them as a (2, 2) mesh; JAX runs the same configurations through
its facades' ``_setup`` on ``make_mesh_2d(2, 2)`` of the first four
devices of the 8-device CPU mesh. Both take the same numpy data, and each
data row of the port takes that row's JAX draws (the inner starts of
Katyusha and SARAH, the loopless pair's block starts and coins, Point-
SAGA's ``local_block_start``, SSNM's split keys), so the f64 states agree
to 1e-10 of each field's largest entry: each rank's columns of the
iterates and anchors, its rows of the tables (and SSNM's stored points,
cut over both axes). The facades' convergence runs use the port's own
draws on a one-rank (1, 1) mesh at JAX's global batch; the states' cuts
are read on a (1, 2) mesh.
"""

import functools

import numpy as np
import pytest

import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
D, M = 2, 2
N, n = 64, 8
n_loc = N // D
B = 4
SEED = 3
ONE = dict(mesh2d=(1, 1), ranks=[0])      # rank 0 alone
PAIR = dict(mesh2d=(1, 2), ranks=[0, 1])  # ranks 0 and 1, columns cut
FULL = dict(mesh2d=(D, M))                # the (2, 2) lockstep mesh
STEPS, OUTER, M_INNER = 24, 3, 8
P_COIN = 0.25
ETA = 0.8
SIGMA_SC = 1.0


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _base(prob, storage=None):
    o = {"kind": "lsq", "A": prob.A, "b": prob.b, "scale": float(N)}
    if storage:
        o["storage"] = storage
    return dict(oracle=o, prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(n))


def _consistent():
    """tests/test_point_saga.py's consistent least-squares system."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n))
    x_true = rng.standard_normal(n)
    return A, x_true, float(N) * (A * A).sum(axis=1)


def _scalars(prob):
    """Each family's (first init scalar, extras) as JAX's facades form
    them from the knobs of :func:`_lockstep`."""
    Lm = float(np.max(prob.L))
    tau1_sc = min(np.sqrt(M_INNER * B * D * SIGMA_SC / (3.0 * Lm)), 0.5)
    return {
        "katyusha_ns": (Lm, (0.5, 0.5)),
        "katyusha_sc": (Lm, (tau1_sc, 0.5)),
        "sarah": (1.0 / (2.0 * Lm), (ETA,)),
        "lsvrg": (1.0 / (6.0 * Lm), (P_COIN,)),
        "lkatyusha": (Lm, (0.0, 1.0 / 3.0, 0.5, P_COIN)),
        "point_saga": (1.0 / (3.0 * Lm), ()),
        "ssnm": (0.5, (1.0 / (3.0 * 0.5 * Lm),)),
    }


@functools.lru_cache(maxsize=None)
def _draws(fn, *args):
    return getattr(tj, fn)(tj.mesh(D), *args)


def _lockstep(prob):
    """The (2, 2) parity cases: name -> (port case, JAX facade class, its
    knobs)."""
    sc = _scalars(prob)
    out = {}

    def add(name, family, key, cls, kw, steps, base=None, cfg=None,
            **sched):
        a, extra = sc[key]
        c = dict(base or _base(prob), fn="tp_build", family=family,
                 cfg=dict(dict(N=N, D=D, M=M, b_loc=B), **(cfg or {})),
                 gamma=a, extra=extra, seed=SEED, steps=steps, **FULL,
                 **sched)
        out[name] = (c, cls, dict(kw, seed=SEED))

    inner = _draws("tp_svrg_starts", SEED, OUTER, M_INNER, n_loc, B)
    add("katyusha_ns", "katyusha", "katyusha_ns", "TPKatyusha",
        dict(batch=B, m=M_INNER), OUTER,
        cfg=dict(m_inner=M_INNER, variant="ns"), starts=inner)
    add("katyusha_sc", "katyusha", "katyusha_sc", "TPKatyusha",
        dict(batch=B, m=M_INNER, sigma=SIGMA_SC), OUTER,
        cfg=dict(m_inner=M_INNER, variant="sc"), starts=inner)
    add("sarah", "sarah", "sarah", "TPSARAH", dict(batch=B, m=M_INNER,
                                                   eta=ETA), OUTER,
        cfg=dict(m_inner=M_INNER), starts=inner)
    coins = tj.coins(SEED, STEPS, P_COIN, D)
    blocks = _draws("block_starts", SEED, STEPS, n_loc, B, 1)
    add("lsvrg", "lsvrg", "lsvrg", "TPLSVRG", dict(batch=B, p=P_COIN), STEPS,
        starts=blocks, coins=coins)
    add("lkatyusha", "lkatyusha", "lkatyusha", "TPLKatyusha",
        dict(batch=B, p=P_COIN), STEPS, starts=blocks, coins=coins)
    for sw in (1, 2, 3):
        add(f"point_saga{sw}", "point_saga", "point_saga", "TPPointSAGA",
            dict(batch=B, sweeping=sw), STEPS, cfg=dict(sweeping=sw),
            base=dict(_base(prob), prox={"kind": "zero"}),
            starts=_draws("block_starts", SEED, STEPS, n_loc, B, sw))
    add("point_saga_int8", "point_saga", "point_saga", "TPPointSAGA",
        dict(batch=B), STEPS, base=dict(_base(prob, "int8"),
                                         prox={"kind": "zero"}),
        starts=blocks)
    add("ssnm", "ssnm", "ssnm", "TPSSNM", dict(batch=B), STEPS,
        starts=_draws("tp_saga_starts", SEED, STEPS, n_loc, B))
    return out


LOCKSTEP = ["katyusha_ns", "katyusha_sc", "sarah", "lsvrg", "lkatyusha",
            "point_saga1", "point_saga2", "point_saga3", "point_saga_int8",
            "ssnm"]
# the families' state fields that are whole on every rank of the mesh
SCALARS = ("Lmax", "tau1", "tau2", "gamma", "eta", "sigma", "theta1",
           "theta2", "tau")
REBASED = {"lsvrg": "av", "lkatyusha": "av", "point_saga1": "av",
           "ssnm": "gbar"}
FAMILIES = ["katyusha", "sarah", "lsvrg", "lkatyusha", "point_saga", "ssnm"]


def _single_cases(prob):
    """A (1, 1) mesh beside the single card on one schedule per family."""
    sc = _scalars(prob)
    rng = np.random.default_rng(4)
    Bs, m = 8, 4
    out = {}
    for fam in FAMILIES:
        key = "katyusha_ns" if fam == "katyusha" else fam
        a, extra = sc[key]
        if fam in ("katyusha", "sarah"):
            T = 3  # outer steps of m inner steps
            starts = [rng.integers(0, N // Bs, m) * Bs for _ in range(T)]
            cfg = dict(m_inner=m, variant="ns" if fam == "katyusha" else "")
        else:
            T = 40
            starts = rng.integers(0, N // Bs, T) * Bs
            cfg = {}
        c = dict(_base(prob), fn="tp_vs_single_vr", family=fam, N=N, B=Bs,
                 steps=T, gamma=a, extra=extra, starts=starts,
                 cfg=dict(dict(N=N, D=1, M=1, b_loc=Bs), **cfg), **ONE)
        if fam in ("lsvrg", "lkatyusha"):
            c["coins"] = rng.random(T) < P_COIN
        if fam == "point_saga":
            c["prox"] = {"kind": "zero"}
        out["single_" + fam] = c
    return out


def _svm():
    """tests/test_sqhinge.py's separable two-class data (256 x 32)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(32)
    w /= np.linalg.norm(w)
    X = rng.standard_normal((256, 32))
    X += np.where((X @ w)[:, None] >= 0, 0.5, -0.5) * w[None, :]
    return X, np.sign(X @ w)


def _cases(lock, prob):
    base = _base(prob)
    sc = _scalars(prob)
    cases = {name: c for name, (c, *_) in lock.items()}
    cases.update(_single_cases(prob))
    for fam in ("lsvrg", "lkatyusha", "ssnm"):
        cases["stepwise_" + fam] = dict(cases[fam], stepwise=True)
    for name in REBASED:
        cases["rebased_" + name] = dict(cases[name], rebase=True)
    # a run draws its steps' draws (and coins) in one pass: the same as each
    # step's own
    for fam in FAMILIES:
        key = "katyusha_ns" if fam == "katyusha" else fam
        a, extra = sc[key]
        cfg = dict(N=N, D=D, M=M, b_loc=B)
        if fam in ("katyusha", "sarah"):
            cfg.update(m_inner=4, variant="ns" if fam == "katyusha" else "")
        if fam == "point_saga":
            cfg.update(sweeping=3)
        cases["runstep_" + fam] = dict(
            base, fn="tp_run_vs_step", family=fam, cfg=cfg, gamma=a,
            extra=extra, seed=SEED, steps=2 if fam in ("katyusha", "sarah")
            else 9, prox={"kind": "zero"} if fam == "point_saga" else
            base["prox"], **FULL)
    # the facades on the port's own draws, at JAX's global batch
    A, x_true, Lc = _consistent()
    cons = dict(base, oracle={"kind": "lsq", "A": A, "b": A @ x_true,
                              "scale": float(N)}, L=Lc, prox={"kind": "zero"})
    X, y = _svm()
    svm = dict(oracle={"kind": "sqhinge", "A": X, "b": y, "scale": 1.0},
               prox={"kind": "zero"}, L=(X * X).sum(axis=1), x0=np.zeros(32))
    conv = {
        "sarah": (base, "TPSARAH", dict(maxit=30, batch=16, m=N)),
        "katyusha": (base, "TPKatyusha", dict(maxit=300, batch=16)),
        "lsvrg": (base, "TPLSVRG", dict(maxit=2000, batch=8)),
        "lkatyusha": (base, "TPLKatyusha", dict(maxit=2000, batch=8)),
        "ssnm": (base, "TPSSNM", dict(maxit=4000, batch=16)),
        "point_saga": (cons, "TPPointSAGA", dict(maxit=1500, batch=16)),
        "sqhinge": (svm, "TPPointSAGA", dict(maxit=400, batch=8)),
    }
    for name, (b, cls, kw) in conv.items():
        cases["conv_" + name] = dict(b, fn="tp_facade", cls=cls, kw=kw, **ONE)
    for cls, kw in (("TPKatyusha", dict(batch=4)), ("TPSARAH", dict(batch=4)),
                    ("TPLSVRG", dict(batch=4)), ("TPLKatyusha", dict(batch=4)),
                    ("TPSSNM", dict(batch=4))):
        cases["iter_" + cls] = dict(base, fn="tp_facade", cls=cls, take=1,
                                    kw=kw, shard=True, **PAIR)
    cases["iter_TPPointSAGA"] = dict(cons, fn="tp_facade", cls="TPPointSAGA",
                                     take=2, kw=dict(batch=4), shard=True,
                                     **PAIR)
    l2 = {"kind": "l2", "lam": 1.0}
    ell = {"kind": "ell", "A": np.where(np.abs(prob.A) < 1.2, 0.0, prob.A),
           "b": prob.b, "scale": float(N)}
    calls = [
        dict(prox=l2), dict(cls="TPSARAH", prox=l2),
        dict(cls="TPLSVRG", prox={"kind": "nuclear", "lam": 0.1}),
        dict(cls="TPLKatyusha", prox=l2), dict(cls="TPSSNM", prox=l2),
        dict(oracle=ell), dict(cls="TPSARAH", oracle=ell),
        dict(cls="TPPointSAGA"),
        dict(L=None), dict(cls="TPSSNM", L=None),
        dict(kw=dict(batch=5)),
        dict(cls="TPLSVRG", oracle=dict(base["oracle"], A=prob.A[:, :7]),
             x0=np.zeros(7)),
        dict(kw=dict(tau2=1.0)), dict(cls="TPSARAH", kw=dict(eta=1.5)),
        dict(cls="TPLSVRG", kw=dict(p=2.0)),
        dict(cls="TPLKatyusha", kw=dict(theta2=0.0)),
        dict(kw=dict(batch=4, m=0)),
    ]
    cases["errors"] = dict(base, fn="tp_errors", cls="TPKatyusha", kw={},
                           calls=calls, **PAIR)
    cases["errors_mesh"] = dict(base, fn="errors", calls=[
        dict(cls=c, kw=dict(batch=4)) for c in (
            "TPKatyusha", "TPSARAH", "TPLSVRG", "TPLKatyusha", "TPSSNM")] + [
        dict(cls="TPPointSAGA", kw=dict(batch=4), prox={"kind": "zero"})])
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    prob = _prob()
    lock = _lockstep(prob)
    cases = _cases(lock, prob)
    results = tw.spawn(cases, WORLD, tmp_path_factory.mktemp("tpvr"))
    return lock, prob, cases, results


def _in(results, name):
    """The results of the ranks in the case's mesh (None elsewhere)."""
    return [tw.result(results, name, r) for r in range(WORLD)
            if results[r].get(name, {}) is not None]


def _jax_state(case, cls, kw):
    import jax.numpy as jnp

    from ciao_tpu import parallel as jp
    from ciao_tpu.oracles import LeastSquaresRows

    o = case["oracle"]
    F = LeastSquaresRows(A=jnp.asarray(o["A"]), b=jnp.asarray(o["b"]),
                         scale=jnp.asarray(o["scale"]))
    if o.get("storage"):
        F = F.with_storage(o["storage"])
    m2 = tj.mesh2d(D, M)
    g = None if case["prox"]["kind"] == "zero" else tj.l1(
        case["prox"]["lam"])
    solver = getattr(jp, cls)(mesh=m2, **kw)
    return tj.tp_run(solver, jnp.asarray(case["x0"]),
                     jp.shard_finite_sum_2d(F, m2), g,
                     jnp.asarray(case["L"]), case["steps"])


@pytest.mark.parametrize("name", LOCKSTEP)
def test_tp_vr_lockstep_matches_jax(setup, name):
    """Each family's lockstep run on the (2, 2) mesh, on JAX's draws and
    coins: each rank's columns of the iterates and anchors, its rows of
    the tables and its block of SSNM's stored points agree with JAX's
    global state to 1e-10 of each field's largest entry in f64 (int8
    rows: Point-SAGA's margins and square-norms summed over "model"
    before the row scale)."""
    lock, _, _, results = setup
    c, cls, kw = lock[name]
    ranks = _in(results, name)
    assert sorted((r["d"], r["m"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    if "coins" in c:
        assert c["coins"][0].sum() >= 3  # the refresh is exercised
    tj.compare2d(ranks, _jax_state(c, cls, kw))


@pytest.mark.parametrize("name", LOCKSTEP)
def test_tp_vr_replicated_scalars_bit_for_bit(setup, name):
    """The scalars every rank holds whole are the same bits on all four
    ranks, and each model group's table rows are the same on both of its
    ranks."""
    _, _, _, results = setup
    ranks = _in(results, name)
    for r in ranks[1:]:
        for f in SCALARS:
            if f in r and r[f] is not None:
                np.testing.assert_array_equal(r[f], ranks[0][f])
    for r in ranks:
        for q in ranks:
            if r["d"] == q["d"] and "c" in r:
                np.testing.assert_array_equal(r["c"], q["c"])


@pytest.mark.parametrize("fam", FAMILIES)
def test_tp_vr_one_rank_equals_single_card(setup, fam):
    """A (1, 1) mesh's run equals the single-card solver on the same
    explicit schedule (inner starts, block starts, coins) to 1e-12 in
    f64, field by field."""
    _, _, _, results = setup
    out = tw.result(results, "single_" + fam)
    tp, one = out["tp"], out["single"]
    assert tp["it"] == one["it"]
    common = [f for f, v in tp.items() if isinstance(v, np.ndarray)
              and isinstance(one.get(f), np.ndarray)]
    assert len(common) >= 3
    for f in common:
        assert tj.gap(tp[f], one[f]) <= 1e-12, f


@pytest.mark.parametrize("fam", ["lsvrg", "lkatyusha", "ssnm"])
def test_tp_vr_stepwise_equals_run(setup, fam):
    """``step`` one at a time with the explicit draws and coins and one
    ``run`` give the same bits."""
    _, _, _, results = setup
    for a, b in zip(_in(results, fam), _in(results, "stepwise_" + fam)):
        for f, v in a.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[f])


@pytest.mark.parametrize("fam", FAMILIES)
def test_tp_vr_run_draws_equal_step_draws(setup, fam):
    """On the port's own draws a ``run`` draws its steps' starts (and the
    loopless pair's coins) in one pass; they are the draws each ``step``
    makes: the same bits, every rank."""
    _, _, _, results = setup
    outs = _in(results, "runstep_" + fam)
    assert len(outs) == WORLD
    for out in outs:
        for f, v in out["run"].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, out["step"][f])


@pytest.mark.parametrize("name", list(REBASED))
def test_tp_vr_rebase_is_exact(setup, name):
    """Each rebase recomputes the anchor gradient or the table mean
    exactly from the rank's block: it matches the carried one to
    rounding, and leaves every other field as it was."""
    _, _, _, results = setup
    key = REBASED[name]
    for a, b in zip(_in(results, name), _in(results, "rebased_" + name)):
        np.testing.assert_allclose(b[key], a[key], rtol=1e-10, atol=1e-12)
        for f, v in a.items():
            if f != key and isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[f])


def _cost(results, name, prob):
    return prob.cost(tw.result(results, "conv_" + name)["x"]) - prob.f_star


@pytest.mark.parametrize("name", ["sarah", "katyusha", "lsvrg", "lkatyusha",
                                  "ssnm"])
def test_tp_vr_facades_converge(setup, name):
    """tests/test_parallel.py:1176 and :1231, tests/test_lsvrg.py:280 and
    tests/test_ssnm.py:191: the facades reach the planted optimum at the
    reference tolerance (a (1, 1) mesh at JAX's global batch)."""
    _, prob, _, results = setup
    assert _cost(results, name, prob) < 1e-4


def test_tp_point_saga_converges(setup):
    """tests/test_point_saga.py:163: TPPointSAGA reaches the consistent
    system's solution."""
    _, _, _, results = setup
    _, x_true, _ = _consistent()
    x = tw.result(results, "conv_point_saga")["x"]
    assert np.linalg.norm(x - x_true) < 1e-4


def test_tp_point_saga_squared_hinge(setup):
    """tests/test_sqhinge.py:262-270: the margin-split θ serves the
    closed-form squared-hinge prox: finite, and the separator classifies
    every point."""
    _, _, _, results = setup
    X, y = _svm()
    x = tw.result(results, "conv_sqhinge")["x"]
    assert np.all(np.isfinite(x))
    assert np.mean(np.sign(X @ x) == y) == 1.0


@pytest.mark.parametrize("cls", ["TPKatyusha", "TPSARAH", "TPLSVRG",
                                 "TPLKatyusha", "TPSSNM", "TPPointSAGA"])
def test_tp_vr_states_are_shards(setup, cls):
    """On a (1, 2) mesh each rank's state holds its columns of the
    iterates and anchors and all rows of the tables (SSNM's stored points
    their columns); SARAH's and Katyusha's init do no gradient work past
    the anchor, so solution(init) == x0."""
    _, _, _, results = setup
    outs = _in(results, "iter_" + cls)
    assert len(outs) == 2
    for st in outs:
        if cls in ("TPKatyusha", "TPSARAH"):
            assert st["x_tilde"].shape == (n // 2,)
            np.testing.assert_array_equal(st["x_tilde"], 0.0)
        if cls == "TPKatyusha":
            assert st["av"].shape == st["y"].shape == (n // 2,)
        if cls in ("TPLSVRG",):
            assert st["w"].shape == st["z"].shape == st["av"].shape == (
                n // 2,)
        if cls == "TPLKatyusha":
            assert st["w_anchor"].shape == st["y"].shape == (n // 2,)
        if cls == "TPSSNM":
            assert st["c"].shape == (N,)
            assert st["zb"].shape == (N // 4, n // 2)
            assert st["x"].shape == st["gbar"].shape == (n // 2,)
        if cls == "TPPointSAGA":
            assert st["c"].shape == (N,) and st["x"].shape == (n // 2,)
            assert st["it"] == 2


def test_tp_vr_validation_errors(setup):
    """JAX's refusals, with its words: a non-separable prox (NormL2,
    NormNuclear), sparse ELL rows (TPKatyusha's half of tests/
    test_parallel.py:1442), Point-SAGA's composite g, a missing L, a bad
    batch or n, and the knobs' ranges."""
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    want = ["separable"] * 5 + ["DP-only"] * 2 + [
        "composite", "smoothness moduli L", "provide L, or both",
        "divisible", "divisible", "tau2", "eta", "p must", "theta2",
        "m must be"]
    assert len(msgs) == len(want)
    for msg, w in zip(msgs, want):
        assert msg is not None and w in msg, (w, msg)


def test_tp_vr_refuse_a_1d_mesh(setup):
    _, _, _, results = setup
    for msg in tw.result(results, "errors_mesh"):
        assert "needs a ('data','model') mesh (make_mesh_2d)" in msg
