"""The port's data-parallel Davis-Yin/Douglas-Rachford, Condat-Vũ/
Chambolle-Pock, PANOC/ZeroFPR and ``deep_solve_pd_dp`` against the JAX
package, on four gloo ranks.

The port's ranks run in four processes spawned once for the module
(``tests/torch_parallel_worker.py``, which imports no JAX). These methods
draw nothing, so the port's ranks and JAX's ``build_dp_functions`` on
the first four devices of the 8-device CPU mesh take the same steps from
the same numpy data: the f64 states agree to 1e-10 of each field's
largest entry on every rank (PANOC's whole state, its L-BFGS ring
included). The facades match the JAX package's single-chip solvers to
reduction order, as ``tests/test_dys.py``, ``test_primal_dual.py`` and
``test_panoc.py`` require of JAX's DP facades; every replicated vector is
the same bits on every rank, and PANOC's line search takes the same
trials on every rank. ``deep_solve_pd_dp`` meets ``tests/
test_deep_pd.py:166``'s bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import ciao_tpu
import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu.ops.linmap import FirstDifference as JFirstDifference
from ciao_tpu.parallel import dp as jdp
from ciao_tpu.prox import IndBox as JIndBox
from ciao_tpu.utils.problems import make_fused_lasso_planted, make_lasso
from torch_threads import one_torch_thread  # noqa: F401

D = 4
N, n = 64, 8
SEED = 3
STEPS = 20
TV = 0.05       # h = TV·‖D·‖₁ of the Condat-Vũ cases
BOX = 0.6       # h = IndBox(−BOX, BOX) of the Davis-Yin cases
CP_N = 8        # the f = 0 cases' N (the closed-form soft threshold)
CP_LAM = 0.7


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _base(prob):
    return dict(oracle={"kind": "lsq", "A": prob.A, "b": prob.b,
                        "scale": float(N)},
                prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(n))


BOX_H = {"h": {"kind": "box", "lo": -BOX, "hi": BOX}}
TV_HK = {"h": {"kind": "l1", "lam": TV}, "K": "first_difference"}


def _cp_case():
    """tests/test_primal_dual.py:370's f = 0 problem: g = ½‖x − b‖²,
    h = λ‖·‖₁, whose solution is the soft threshold of b."""
    b = np.linspace(-2.0, 2.0, 16)
    return dict(oracle=None, N=CP_N, x0=np.zeros(16),
                prox={"kind": "sqrdist", "b": b, "rho": 1.0},
                h={"kind": "l1", "lam": CP_LAM}), b


def _cfg(**kw):
    return dict(dict(N=N, D=D, b_loc=1, sweeping=1, alpha=0.999), **kw)


# PANOC's facades are held to the single chip's trajectory over 30 steps:
# at 38 the plain PANOC sits at the f64 floor (cost − f* ~1e-14), where the
# line search compares envelope values equal to 1e-14 and the four ranks'
# order of summation can flip a trial (τ = 1 against 0.5); 40 steps are
# then held to tests/test_panoc.py's cost bar alone
PANOC_SAME = 30
PANOC_CASES = {
    "panoc": dict(variant="panoc"),
    "zerofpr": dict(variant="zerofpr"),
    "panoc_adaptive": dict(variant="panoc", adaptive=True),
}


def _steps(prob):
    Lf = float(np.mean(prob.L))
    gamma = 0.95 / Lf
    return dict(dys=(1.0 / Lf, (1.0,)), pd=(0.4 / Lf, (0.5,)),
                panoc=(gamma, (0.5 * 0.05 / (2.0 * gamma),)))


def _cases(prob):
    base = _base(prob)
    st = _steps(prob)
    cases = {}
    a, extra = st["dys"]
    cases["dys"] = dict(base, fn="build", family="dys", cfg=_cfg(),
                        gamma=a, extra=extra, steps=STEPS, **BOX_H)
    a, extra = st["pd"]
    for name, kw in (("pd", {}), ("pd_polish", dict(polish_chunk=4))):
        cases[name] = dict(base, fn="build", family="pd", cfg=_cfg(**kw),
                           gamma=a, extra=extra, steps=STEPS, **TV_HK)
    a, extra = st["panoc"]
    for name, kw in PANOC_CASES.items():
        cases[name] = dict(base, fn="build", family="panoc",
                           cfg=_cfg(m_inner=5, max_ls=10, **kw), gamma=a,
                           extra=extra, steps=10)
    # a run's steps are its step calls (the methods draw nothing)
    for fam, extra_kw in (("dys", BOX_H), ("pd", TV_HK), ("panoc", {})):
        a, extra = st[fam]
        cfg = _cfg(m_inner=5) if fam == "panoc" else _cfg()
        cases["runstep_" + fam] = dict(base, fn="run_vs_step", family=fam,
                                       cfg=cfg, gamma=a, extra=extra,
                                       steps=9, **extra_kw)
    # facades against the single-chip solvers
    cases["f_dys"] = dict(base, fn="facade", cls="DPDavisYin",
                          kw=dict(maxit=300), **BOX_H)
    cases["f_cv"] = dict(base, fn="facade", cls="DPCondatVu",
                         kw=dict(maxit=300), **TV_HK)
    for k in (PANOC_SAME, 40):
        for cls in ("DPPANOC", "DPZeroFPR"):
            cases[f"f_{cls}_{k}"] = dict(base, fn="facade", cls=cls,
                                         kw=dict(maxit=k))
        cases[f"f_panoc_adaptive_{k}"] = dict(
            base, fn="facade", cls="DPPANOC", kw=dict(maxit=k), L=None)
    cp, _ = _cp_case()
    cases["f_dr"] = dict(cp, fn="facade", cls="DPDouglasRachford",
                         kw=dict(maxit=400))
    cases["solo_cp"] = dict(cp, fn="solo", calls={"cp": dict(
        cls="DPChambollePock", kw=dict(maxit=2000))})
    for name, kw in (("adaptive", dict(maxit=20)),
                     ("zerofpr", dict(maxit=20, zerofpr=True))):
        cases["trials_" + name] = dict(
            base, fn="panoc_trials", cls="DPPANOC", kw=kw, take=20,
            L=None if name == "adaptive" else base["L"])
    cases["errors"] = dict(base, fn="errors", cls="DPDavisYin", calls=[
        dict(kw=dict(lam=2.0)),
        dict(L=None),
        dict(N=N - 1, shard=False),
        dict(oracle=None, N=None),
        dict(cls="DPCondatVu", kw=dict(sigma=-1.0)),
        dict(cls="DPCondatVu", L=None),
        dict(cls="DPCondatVu", kw=dict(polish_chunk=5)),
        dict(cls="DPCondatVu", oracle=None, N=N, kw=dict(polish_chunk=4)),
        dict(cls="DPPANOC", kw=dict(alpha=1.0)),
        dict(cls="DPPANOC", kw=dict(mem=0)),
        dict(cls="DPPANOC", N=N - 1, shard=False),
    ])
    # deep_solve_pd_dp on tests/test_deep_pd.py:166's plant
    p = make_fused_lasso_planted(N=8192, n=256, jumps=8, seed=0)
    cases["deep_pd"] = dict(
        fn="deep_pd", N=8192, x0=np.zeros(256, np.float32),
        oracle={"kind": "lsq", "A": p.A.astype(np.float32),
                "b": p.b.astype(np.float32), "scale": 8192.0},
        prox={"kind": "zero"}, h={"kind": "l1", "lam": float(p.lam)},
        K="first_difference",
        kw=dict(chunk_steps=512, max_steps=16384, polish_chunk=1024))
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    m = tj.mesh(D)
    prob = _prob()
    cases = _cases(prob)
    results = tw.spawn(cases, D, tmp_path_factory.mktemp("splitting"))
    return m, prob, cases, results


def _ranks(results, name):
    return [tw.result(results, name, r) for r in range(D)]


def _jax_terms(c):
    """JAX's (F, g, h) of a case; h None without one."""
    o = c["oracle"]
    F = ciao_tpu.LeastSquaresRows(A=jnp.asarray(o["A"]),
                                  b=jnp.asarray(o["b"]),
                                  scale=jnp.asarray(o["scale"]))
    g = tj.l1(c["prox"]["lam"])
    h = c.get("h")
    if h is not None:
        h = (tj.l1(h["lam"]) if h["kind"] == "l1" else
             JIndBox(lo=jnp.asarray(h["lo"]), hi=jnp.asarray(h["hi"])))
    return F, g, h


def _jax_dp(m, c, steps):
    """JAX's build_dp_functions on the case."""
    F, g, h = _jax_terms(c)
    F = tj.shard_finite_sum(F, m)
    if c["family"] == "dys":
        terms = (g, h)
    elif c["family"] == "pd":
        terms = (g, h, JFirstDifference())
    else:
        terms = g
    extra = tuple(np.float64(e) for e in c["extra"])
    return tj.run(m, c["family"], F, terms, jdp.DPCfg(**c["cfg"]),
                  np.zeros(n), np.float64(c["gamma"]), 0, steps, extra=extra)


@pytest.mark.parametrize("name", ["dys", "pd", "pd_polish"])
def test_dp_splitting_matches_jax(setup, name):
    """DP Davis-Yin (g = λ‖·‖₁, h a box) and Condat-Vũ (h = 0.05‖D·‖₁;
    with and without the compensated chunks of the deep route) over 20
    steps: every field on every rank."""
    m, _, cases, results = setup
    tj.compare(_ranks(results, name), _jax_dp(m, cases[name], STEPS))


@pytest.mark.parametrize("name", list(PANOC_CASES))
def test_dp_panoc_matches_jax(setup, name):
    """DP PANOC, ZeroFPR and adaptive-γ PANOC over 10 steps: the iterate,
    the envelope, the L-BFGS ring and its cursors, γ and σ, on every
    rank."""
    m, _, cases, results = setup
    tj.compare(_ranks(results, name), _jax_dp(m, cases[name], 10))


def _same_on_every_rank(results, name, key="x"):
    xs = [tw.result(results, name, r)[key] for r in range(D)]
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])
    return xs[0]


def test_dp_davis_yin_matches_single_chip(setup):
    """tests/test_dys.py:214: 300 steps on four ranks equal JAX's
    single-chip Davis-Yin to reduction order."""
    _, prob, cases, results = setup
    x = _same_on_every_rank(results, "f_dys")
    F, g, h = _jax_terms(cases["f_dys"])
    xs, _ = ciao_tpu.DavisYin(maxit=300)(jnp.zeros(n), F=F, g=g, h=h,
                                         L=prob.L, N=N)
    np.testing.assert_allclose(x, np.asarray(xs), rtol=1e-9, atol=1e-12)


def test_dp_condat_vu_matches_single_chip(setup):
    """tests/test_primal_dual.py:345: the three-term fused lasso, 300
    steps on four ranks equal JAX's single-chip Condat-Vũ to reduction
    order."""
    _, prob, cases, results = setup
    x = _same_on_every_rank(results, "f_cv")
    F, g, h = _jax_terms(cases["f_cv"])
    xs, _ = ciao_tpu.CondatVu(maxit=300)(jnp.zeros(n), F=F, g=g, h=h,
                                         K=JFirstDifference(), L=prob.L,
                                         N=N)
    np.testing.assert_allclose(x, np.asarray(xs), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["f_dr", "solo_cp"])
def test_dp_f_zero_closed_form(setup, name):
    """DPDouglasRachford (400 steps on four ranks) and DPChambollePock
    (2,000 steps, tests/test_primal_dual.py:370, on a one-rank mesh: f =
    0 still pays an all-reduce a step) reach the soft threshold of b."""
    _, _, _, results = setup
    _, b = _cp_case()
    if name == "f_dr":
        x = _same_on_every_rank(results, name)
    else:
        x = tw.result(results, name)["cp"]["x"]
    x_star = np.sign(b) * np.maximum(np.abs(b) - CP_LAM, 0.0)
    np.testing.assert_allclose(x, x_star, rtol=0, atol=1e-8)


@pytest.mark.parametrize("cls", ["DPPANOC", "DPZeroFPR"])
def test_dp_panoc_matches_single_chip(setup, cls):
    """tests/test_panoc.py:170: 30 steps on four ranks equal JAX's
    single-chip PANOC/ZeroFPR to reduction order (see PANOC_SAME), and
    40 reach the planted optimum to JAX's bar."""
    _, prob, cases, results = setup
    x = _same_on_every_rank(results, f"f_{cls}_{PANOC_SAME}")
    F, g, _ = _jax_terms(cases["f_" + cls + "_40"])
    sc = ciao_tpu.ZeroFPR if cls == "DPZeroFPR" else ciao_tpu.PANOC
    xs, _ = sc(maxit=PANOC_SAME)(jnp.zeros(n), F=F, g=g, L=prob.L, N=N)
    np.testing.assert_allclose(x, np.asarray(xs), rtol=1e-9, atol=1e-12)
    x40 = _same_on_every_rank(results, f"f_{cls}_40")
    assert prob.cost(x40) - prob.f_star < 1e-12


def test_dp_panoc_adaptive_matches_single_chip(setup):
    """tests/test_panoc.py:108: no γ and no L turns the γ-backtracking
    on; its halvings read all-reduced values, so the trajectory is the
    single chip's (30 steps, see PANOC_SAME; 40 at JAX's cost bar)."""
    _, prob, cases, results = setup
    x = _same_on_every_rank(results, f"f_panoc_adaptive_{PANOC_SAME}")
    F, g, _ = _jax_terms(cases["f_panoc_adaptive_40"])
    xs, _ = ciao_tpu.PANOC(maxit=PANOC_SAME)(jnp.zeros(n), F=F, g=g, N=N)
    np.testing.assert_allclose(x, np.asarray(xs), rtol=1e-9, atol=1e-12)
    x40 = _same_on_every_rank(results, "f_panoc_adaptive_40")
    assert prob.cost(x40) - prob.f_star < 1e-12


@pytest.mark.parametrize("name", ["adaptive", "zerofpr"])
def test_dp_panoc_trials_equal_across_ranks(setup, name):
    """Every rank's line search takes the same FBE evaluations (counted
    on each rank) and the same steps, and every replicated vector and
    the thrash gauge are the same bits on every rank."""
    _, _, _, results = setup
    outs = _ranks(results, "trials_" + name)
    for o in outs[1:]:
        assert o["evals"] == outs[0]["evals"] and o["it"] == outs[0]["it"]
        np.testing.assert_array_equal(o["x"], outs[0]["x"])
        np.testing.assert_array_equal(o["ls_ewma"], outs[0]["ls_ewma"])
    assert outs[0]["evals"] >= outs[0]["it"]


@pytest.mark.parametrize("fam", ["dys", "pd", "panoc"])
def test_dp_splitting_run_equals_steps(setup, fam):
    """A ``run`` of nine steps is nine ``step`` calls, bit for bit."""
    _, _, _, results = setup
    for r in range(D):
        out = tw.result(results, "runstep_" + fam, r)
        for f, v in out["run"].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, out["step"][f])
        assert out["run"]["it"] == out["step"]["it"] == 10


def test_dp_splitting_validation_errors(setup):
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    want = ["lam must", "smoothness moduli L", "divide evenly",
            "provide F or N", "sigma must", "smoothness moduli L",
            "polish_chunk=5", "F omitted", "alpha and beta", "mem and max_ls",
            "divide evenly"]
    assert len(msgs) == len(want)
    for msg, w in zip(msgs, want):
        assert msg is not None and w in msg, (w, msg)


def test_deep_solve_pd_dp_certified(setup):
    """tests/test_deep_pd.py:166 on four ranks: DPCondatVu with each
    rank's compensated chunks, then the certified reduced solve with the
    Gram, right-hand side and certificate gradient summed over the ranks:
    refined and certified, rel < 1e-8, the planted flat runs exactly
    flat, the same bits on every rank."""
    _, _, _, results = setup
    p = make_fused_lasso_planted(N=8192, n=256, jumps=8, seed=0)
    x = _same_on_every_rank(results, "deep_pd")
    out = tw.result(results, "deep_pd")
    assert out["refined"] and out["certified"]
    rel = (p.cost(x.astype(np.float64)) - p.f_star) / abs(p.f_star)
    assert 0 <= rel < 1e-8
    d = np.abs(np.diff(x.astype(np.float64)))
    assert np.all(d[np.abs(np.diff(p.x_star)) == 0] == 0.0)
