"""The port's tensor-parallel Davis-Yin/Douglas-Rachford, Condat-Vũ/
Chambolle-Pock (the stencil K's halo), PANOC/ZeroFPR, ``deep_solve_pd_tp``
and ``entry.dryrun_multichip`` against the JAX package, on four gloo
ranks.

The port's ranks run in four processes spawned once for the module
(``tests/torch_parallel_worker.py``, which imports no JAX). These methods
draw nothing, so the port's (2, 2) mesh and JAX's facades on
``make_mesh_2d(2, 2)`` of the 8-device CPU mesh take the same steps from
the same numpy data: the f64 states agree to 1e-10 of each field's
largest entry on every rank (the padded Condat-Vũ dual over the columns,
PANOC's L-BFGS ring over the columns and its cursors whole). At M = 2 the
halo of K = FirstDifference runs; K = I has none. The facades match JAX's
single-chip solvers to reduction order on a (1, 2) mesh, as the JAX
package's TP tests require; a (1, 1) mesh equals the port's single-card
solver. PANOC's line search takes the same trials, with the same envelope
values, on every rank.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciao_tpu
import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu.utils.problems import make_lasso, make_three_term_planted
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
D, M = 2, 2
N, n = 64, 8
NPD, NX = 64, 16     # tests/test_primal_dual.py:457's Condat-Vũ problem
SEED = 3
STEPS = 20
PANOC_STEPS = 10
ONE = dict(mesh2d=(1, 1), ranks=[0])      # rank 0 alone
PAIR = dict(mesh2d=(1, 2), ranks=[0, 1])  # ranks 0 and 1, columns cut
FULL = dict(mesh2d=(D, M))                # the (2, 2) lockstep mesh
CP_N, CP_LAM = 8, 0.7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _lasso(prob):
    return dict(oracle={"kind": "lsq", "A": prob.A, "b": prob.b,
                        "scale": float(N)},
                prox={"kind": "l1", "lam": float(prob.lam)}, L=prob.L,
                x0=np.zeros(n), N=N)


BOX_H = {"h": {"kind": "box", "lo": -0.6 * np.ones(n), "hi": 0.6 * np.ones(n)}}


def _pd_problem():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((NPD, NX))
    b = rng.standard_normal(NPD)
    return dict(oracle={"kind": "lsq", "A": A, "b": b, "scale": float(NPD)},
                prox={"kind": "l1", "lam": 0.05},
                h={"kind": "l1", "lam": 0.1}, L=(A * A).sum(axis=1) * NPD,
                x0=np.zeros(NX), N=NPD)


def _dr_problem():
    """tests/test_dys.py:197's f = 0 problem, whose solution is the soft
    threshold of b."""
    b = np.linspace(-2.0, 2.0, 16)
    return dict(oracle=None, N=CP_N, x0=np.zeros(16),
                prox={"kind": "sqrdist", "b": b, "rho": 1.0},
                h={"kind": "l1", "lam": CP_LAM}), b


def _cp_problem():
    """f = 0 total-variation denoising: g = ½‖x − b‖², h = 0.7‖D·‖₁ (x = 0
    is not its solution, so the halo has work to do)."""
    dr, _ = _dr_problem()
    return dict(dr, N=NPD, K="first_difference")


def _jax_terms(c):
    """JAX's (F or None, g, h or None) of a case."""
    from ciao_tpu.oracles import LeastSquaresRows
    from ciao_tpu.prox import IndBox, NormL1, SqrDistPoint

    def prox(p):
        if p["kind"] == "l1":
            return NormL1(lam=jnp.asarray(p["lam"]))
        if p["kind"] == "sqrdist":
            return SqrDistPoint(b=jnp.asarray(p["b"]),
                                rho=jnp.asarray(p["rho"]))
        return IndBox(lo=jnp.asarray(p["lo"]), hi=jnp.asarray(p["hi"]))

    o = c.get("oracle")
    F = None if o is None else LeastSquaresRows(
        A=jnp.asarray(o["A"]), b=jnp.asarray(o["b"]),
        scale=jnp.asarray(o["scale"]))
    h = c.get("h")
    return F, prox(c["prox"]), None if h is None else prox(h)


def _jax_K(c):
    from ciao_tpu.ops.linmap import FirstDifference

    return FirstDifference() if c.get("K") else None


def _jax_split(c, cls, kw, steps, mesh=True):
    """JAX's TP facade (or with ``mesh=False`` its single-chip solver) on
    the case: the state after ``steps`` steps, or the solution."""
    from ciao_tpu import parallel as jp

    F, g, h = _jax_terms(c)
    x0 = jnp.asarray(c["x0"])
    L = None if c.get("L") is None else jnp.asarray(c["L"])
    m2 = tj.mesh2d(D, M)
    if F is not None:
        F = jp.shard_finite_sum_2d(F, m2)
    solver = getattr(jp, cls)(mesh=m2, **kw)
    if cls in ("TPDavisYin", "TPDouglasRachford"):
        setup = solver._setup(x0, F, g, h, L, c["N"])
    elif cls in ("TPCondatVu", "TPChambollePock"):
        setup = solver._setup(x0, F, g, h, _jax_K(c), L, c["N"])
    else:
        setup = solver._setup(x0, F, g, L, c["N"])
    init, run = setup[3], setup[5]
    return run(init(), steps)


def _pd_steps(c, K):
    """(τ, σ) of JAX's TPCondatVu on the case: its single-chip rule."""
    from ciao_tpu.solvers.primal_dual import CondatVu

    Lf = 0.0 if c.get("L") is None else float(np.mean(c["L"]))
    normK = float(K.opnorm_bound(len(c["x0"]))) if K is not None else 1.0
    return tuple(float(v) for v in CondatVu()._stepsizes(Lf, normK,
                                                          np.float64))


def _lockstep(prob):
    """The (2, 2) parity cases: name -> (port case, JAX facade, knobs)."""
    from ciao_tpu.ops.linmap import FirstDifference
    from ciao_tpu.solvers.panoc import _probe_gamma

    out = {}

    def add(name, family, base, a, extra, cls, kw, steps, **cfg):
        c = dict(base, fn="tp_build", family=family,
                 cfg=dict(dict(N=base["N"], D=D, M=M), **cfg), gamma=a,
                 extra=extra, steps=steps, **FULL)
        out[name] = (c, cls, kw)

    las = _lasso(prob)
    Lf = float(np.mean(prob.L))
    add("dys", "dys", dict(las, **BOX_H), 1.0 / Lf, (1.0,), "TPDavisYin", {},
        STEPS)
    dr, _ = _dr_problem()
    add("dr", "dys", dr, 1.0, (1.0,), "TPDouglasRachford", {}, STEPS)
    pd = _pd_problem()
    fd = dict(pd, K="first_difference")
    tau, sigma = _pd_steps(fd, FirstDifference())
    add("pd_firstdiff", "pd", fd, tau, (sigma,), "TPCondatVu", {}, STEPS,
        variant="firstdiff")
    tau, sigma = _pd_steps(pd, None)
    add("pd_identity", "pd", pd, tau, (sigma,), "TPCondatVu", {}, STEPS,
        variant="identity")
    cp = _cp_problem()
    tau, sigma = _pd_steps(cp, FirstDifference())
    add("cp", "pd", cp, tau, (sigma,), "TPChambollePock", {}, STEPS,
        variant="firstdiff")
    gamma = 0.95 / Lf
    sig = 0.5 * 0.05 / (2.0 * gamma)
    for name, cls, variant in (("panoc", "TPPANOC", "panoc"),
                               ("zerofpr", "TPZeroFPR", "zerofpr")):
        add(name, "panoc", las, gamma, (sig,), cls, {}, PANOC_STEPS,
            m_inner=5, variant=variant)
    F, _, _ = _jax_terms(las)
    g_ad = float(_probe_gamma(F, jnp.zeros(n), N, 0.95, jnp.float64))
    add("panoc_adaptive", "panoc", dict(las, L=None), g_ad,
        (0.5 * 0.05 / (2.0 * g_ad),), "TPPANOC", {}, PANOC_STEPS,
        m_inner=5, variant="panoc", adaptive=True)
    return out


LOCKSTEP = ["dys", "dr", "pd_firstdiff", "pd_identity", "cp", "panoc",
            "zerofpr", "panoc_adaptive"]
SCALARS = ("gamma", "lam", "tau", "sigma", "fx", "gz", "fbe", "rho",
           "head", "count", "ls_ewma")


def _cases(lock, prob):
    cases = {name: c for name, (c, *_) in lock.items()}
    las = _lasso(prob)
    # a run's steps are its step calls (the methods draw nothing)
    for name in ("dys", "pd_firstdiff", "zerofpr"):
        cases["runstep_" + name] = dict(cases[name], fn="tp_run_vs_step",
                                        steps=6)
    # a (1, 1) mesh beside the single-card facades
    pd = _pd_problem()
    dr, _ = _dr_problem()
    one = {
        "dys": (dict(las, **BOX_H), "TPDavisYin", dict(maxit=60)),
        "cv": (dict(pd, K="first_difference"), "TPCondatVu", dict(maxit=60)),
        "panoc": (las, "TPPANOC", dict(maxit=30)),
        "zerofpr": (las, "TPZeroFPR", dict(maxit=30)),
    }
    for name, (b, cls, kw) in one.items():
        cases["one_" + name] = dict(b, fn="tp_facade", cls=cls, kw=kw, **ONE)
    # JAX's TP tests' configurations, the columns cut over two ranks
    pair = {
        "dys": (dict(las, **BOX_H), "TPDavisYin", dict(maxit=300)),
        "dr": (dr, "TPDouglasRachford", dict(maxit=400)),
        "panoc": (las, "TPPANOC", dict(maxit=40)),
        "zerofpr": (las, "TPZeroFPR", dict(maxit=40)),
        "cv": (dict(pd, K="first_difference"), "TPCondatVu",
               dict(maxit=300)),
        "cp": (_cp_problem(), "TPChambollePock", dict(maxit=300)),
        "cv_identity": (pd, "TPCondatVu", dict(maxit=200)),
    }
    for name, (b, cls, kw) in pair.items():
        cases["pair_" + name] = dict(b, fn="tp_facade", cls=cls, kw=kw,
                                     **PAIR)
    for name, kw, L in (("adaptive", dict(maxit=20), None),
                        ("zerofpr", dict(maxit=20, zerofpr=True), las["L"])):
        cases["trials_" + name] = dict(las, fn="tp_panoc_trials",
                                       cls="TPPANOC", kw=kw, take=20, L=L,
                                       **FULL)
    nuclear = {"kind": "nuclear", "lam": 0.1}
    ell = {"kind": "ell", "A": np.where(np.abs(prob.A) < 1.2, 0.0, prob.A),
           "b": prob.b, "scale": float(N)}
    cases["errors"] = dict(las, fn="tp_errors", cls="TPDavisYin", **PAIR,
                           calls=[
        dict(prox=nuclear, **BOX_H), dict(kw=dict(lam=2.0), **BOX_H),
        dict(L=None, **BOX_H), dict(oracle=None, N=None, **BOX_H),
        dict(oracle=ell, **BOX_H),
        dict(cls="TPCondatVu", **pd, K="dense"),
        dict(cls="TPCondatVu", **dict(pd, prox=nuclear),
             K="first_difference"),
        dict(cls="TPCondatVu", **dict(pd, L=None), K="first_difference"),
        dict(cls="TPCondatVu", kw=dict(sigma=-1.0), **pd),
        dict(cls="TPPANOC", prox={"kind": "l2", "lam": 1.0}),
        dict(cls="TPPANOC", kw=dict(alpha=1.0)),
        dict(cls="TPPANOC", kw=dict(mem=0)),
        dict(cls="TPZeroFPR", oracle=ell),
        dict(cls="TPDavisYin", oracle=dict(las["oracle"], A=prob.A[:, :7]),
             x0=np.zeros(7), **dict(BOX_H, h={"kind": "l1", "lam": 0.1})),
    ])
    cases["errors_mesh"] = dict(las, fn="errors", calls=[
        dict(cls="TPPANOC"), dict(cls="TPZeroFPR"),
        dict(cls="TPDavisYin", **BOX_H),
        dict(cls="TPCondatVu", **BOX_H)])
    # deep_solve_pd_tp on tests/test_deep_pd.py:365's three-term plant on
    # the (2, 2) mesh: the rows cut over two data rows, the columns over two
    # model ranks
    p = make_three_term_planted(N=8192, n=256, jumps=9, seed=0)
    cases["deep_pd"] = dict(
        fn="tp_deep_pd", N=8192, x0=np.zeros(256, np.float32),
        oracle={"kind": "lsq", "A": p.A.astype(np.float32),
                "b": p.b.astype(np.float32), "scale": 8192.0},
        prox={"kind": "l1", "lam": np.float32(p.lam1)},
        h={"kind": "l1", "lam": np.float32(p.lam2)}, K="first_difference",
        kw=dict(chunk_steps=512, max_steps=16384, refine_chunk=1024),
        **FULL)
    # the dryrun on the four ranks (its TP block on a (2, 2) mesh); last,
    # since it makes groups of its own
    cases["dryrun"] = dict(fn="dryrun")
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    prob = _prob()
    lock = _lockstep(prob)
    cases = _cases(lock, prob)
    results = tw.spawn(cases, WORLD, tmp_path_factory.mktemp("tpsplit"))
    return lock, prob, cases, results


def _in(results, name):
    return [tw.result(results, name, r) for r in range(WORLD)
            if results[r].get(name, {}) is not None]


@pytest.mark.parametrize("name", LOCKSTEP)
def test_tp_splitting_lockstep_matches_jax(setup, name):
    """Davis-Yin (g = λ‖·‖₁, a box h cut to the columns), Douglas-Rachford
    (f = 0), Condat-Vũ with K = FirstDifference (the halo at M = 2) and K
    = I, Chambolle-Pock (f = 0), PANOC, ZeroFPR and adaptive-γ PANOC on
    the (2, 2) mesh: every field of every rank's state (its columns of the
    iterates, the padded dual and the L-BFGS ring) against JAX's global
    state to 1e-10 in f64."""
    lock, _, _, results = setup
    c, cls, kw = lock[name]
    ranks = _in(results, name)
    assert sorted((r["d"], r["m"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    tj.compare2d(ranks, _jax_split(c, cls, kw, c["steps"]))


@pytest.mark.parametrize("name", LOCKSTEP)
def test_tp_splitting_scalars_bit_for_bit(setup, name):
    """Every scalar the ranks hold whole (the stepsizes, PANOC's envelope,
    f(x), g(z), the ring's ρ and cursors, the thrash gauge) is the same
    bits on all four ranks; the last rank of each model group keeps the
    padded dual's virtual element exactly 0."""
    _, _, _, results = setup
    ranks = _in(results, name)
    for r in ranks[1:]:
        for f in SCALARS:
            if f in r:
                np.testing.assert_array_equal(r[f], ranks[0][f])
    if name.startswith(("pd", "cp")) and name != "pd_identity":
        for r in ranks:
            if r["m"] == M - 1:
                assert r["y"][-1] == 0.0


@pytest.mark.parametrize("name", ["dys", "pd_firstdiff", "zerofpr"])
def test_tp_splitting_run_equals_steps(setup, name):
    """A ``run`` of six steps is six ``step`` calls, bit for bit."""
    _, _, _, results = setup
    for out in _in(results, "runstep_" + name):
        for f, v in out["run"].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, out["step"][f])
        assert out["run"]["it"] == out["step"]["it"] == 7


def _single(case, cls, kw):
    """The port's single-card facade on the case, on the CPU."""
    from ciao_tpu_torch import solvers
    from ciao_tpu_torch.ops.linmap import FirstDifference

    F = tw.oracle(case)
    g = tw.prox(case)
    kwargs = dict(F=F, g=g, L=torch.tensor(case["L"]), N=case["N"])
    if "h" in case:
        kwargs["h"] = tw.prox(case, "h")
    if case.get("K"):
        kwargs["K"] = FirstDifference()
    name = {"TPDavisYin": "DavisYin", "TPCondatVu": "CondatVu",
            "TPPANOC": "PANOC", "TPZeroFPR": "ZeroFPR"}[cls]
    x, _ = getattr(solvers, name)(**kw)(torch.tensor(case["x0"]), **kwargs)
    return x.numpy()


@pytest.mark.parametrize("name", ["dys", "cv", "panoc", "zerofpr"])
def test_tp_splitting_one_rank_equals_single_card(setup, name):
    """A (1, 1) mesh's facade equals the port's single-card facade to
    1e-12 in f64 (the methods draw nothing)."""
    _, _, cases, results = setup
    c = cases["one_" + name]
    x = tw.result(results, "one_" + name)["x"]
    assert tj.gap(x, _single(c, c["cls"], c["kw"])) <= 1e-12


def _pair_x(results, name):
    """The whole x of a (1, 2) facade run: the same bits on both ranks."""
    xs = [tw.result(results, "pair_" + name, r)["x"] for r in (0, 1)]
    np.testing.assert_array_equal(xs[0], xs[1])
    return xs[0]


def _jax_single(c, name, **kw):
    F, g, h = _jax_terms(c)
    x0 = jnp.zeros(len(c["x0"]))
    L = None if c.get("L") is None else jnp.asarray(c["L"])
    kwargs = dict(F=F, g=g, L=L, N=c["N"])
    if h is not None:
        kwargs["h"] = h
    if _jax_K(c) is not None:
        kwargs["K"] = _jax_K(c)
    x, _ = getattr(ciao_tpu, name)(**kw)(x0, **kwargs)
    return np.asarray(x)


def test_tp_davis_yin_matches_single_chip(setup):
    """tests/test_dys.py:168: 300 steps with the columns cut over two
    ranks (the box bounds cut with them) equal JAX's single-chip
    Davis-Yin to reduction order."""
    _, _, cases, results = setup
    x = _pair_x(results, "dys")
    np.testing.assert_allclose(
        x, _jax_single(cases["pair_dys"], "DavisYin", maxit=300),
        rtol=1e-9, atol=1e-12)


def test_tp_douglas_rachford_f_zero(setup):
    """tests/test_dys.py:197: TPDouglasRachford (f = 0: no oracle, no
    collective) reaches the soft threshold of b."""
    _, _, _, results = setup
    _, b = _dr_problem()
    x_star = np.sign(b) * np.maximum(np.abs(b) - CP_LAM, 0.0)
    np.testing.assert_allclose(_pair_x(results, "dr"), x_star, rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("name", ["panoc", "zerofpr"])
def test_tp_panoc_matches_single_chip(setup, name):
    """tests/test_panoc.py:192: 40 steps of TPPANOC/TPZeroFPR with the
    columns cut over two ranks equal JAX's single-chip solvers to
    reduction order."""
    _, _, cases, results = setup
    x = _pair_x(results, name)
    want = _jax_single(cases["pair_" + name],
                       "ZeroFPR" if name == "zerofpr" else "PANOC", maxit=40)
    np.testing.assert_allclose(x, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name,cls,maxit", [
    ("cv", "CondatVu", 300), ("cp", "ChambollePock", 300),
    ("cv_identity", "CondatVu", 200)])
def test_tp_condat_vu_matches_single_chip(setup, name, cls, maxit):
    """tests/test_primal_dual.py:457: TPCondatVu with K = FirstDifference
    (the halo between the two ranks, twice a step), TPChambollePock (f =
    0, here on a TV denoising of b whose solution is not x0) and K = I
    equal JAX's single-chip Condat-Vũ to reduction order."""
    _, _, cases, results = setup
    x = _pair_x(results, name)
    np.testing.assert_allclose(
        x, _jax_single(cases["pair_" + name], cls, maxit=maxit), rtol=1e-9,
        atol=1e-12)


@pytest.mark.parametrize("name", ["adaptive", "zerofpr"])
def test_tp_panoc_trials_equal_across_ranks(setup, name):
    """Every rank's line search takes the same FBE evaluations (counted on
    each rank) with the same envelope values, bit for bit, over 20 steps
    on the (2, 2) mesh; each model group's ranks hold the same ring
    cursors and the same thrash gauge."""
    _, _, _, results = setup
    outs = _in(results, "trials_" + name)
    assert len(outs) == WORLD
    for o in outs[1:]:
        assert o["evals"] == outs[0]["evals"]
        np.testing.assert_array_equal(o["fbe"], outs[0]["fbe"])
        for f in ("ls_ewma", "gamma", "head", "count", "rho"):
            np.testing.assert_array_equal(o["last"][f], outs[0]["last"][f])
    assert outs[0]["evals"] >= 20


def test_tp_splitting_validation_errors(setup):
    """JAX's refusals, with its words: non-separable terms, the knobs'
    ranges, a missing L or F, sparse ELL rows, a DenseMap K, n not
    divisible by M."""
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    want = ["separable", "lam must", "smoothness moduli L", "provide F or N",
            "DP-only", "DenseMap", "separable", "smoothness moduli L",
            "sigma must", "separable", "alpha and beta", "mem and max_ls",
            "DP-only", "divisible"]
    assert len(msgs) == len(want)
    for msg, w in zip(msgs, want):
        assert msg is not None and w in msg, (w, msg)


def test_tp_splitting_refuse_a_1d_mesh(setup):
    _, _, _, results = setup
    for msg in tw.result(results, "errors_mesh"):
        assert "needs a ('data','model') mesh (make_mesh_2d)" in msg


def test_deep_solve_pd_tp_certified(setup):
    """tests/test_deep_pd.py:365 on the (2, 2) mesh: TPCondatVu (the halo
    between each data row's two ranks) to identification, then the
    certified three-term reduced solve with A·S summed over "model" and
    the Gram, right-hand side and certificate gradient over "data":
    refined and certified, rel < 1e-8, the planted zeros exactly zero,
    the same whole x on all four ranks."""
    _, _, _, results = setup
    p = make_three_term_planted(N=8192, n=256, jumps=9, seed=0)
    outs = [tw.result(results, "deep_pd", r) for r in range(WORLD)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["x"], outs[0]["x"])
    assert outs[0]["refined"] and outs[0]["certified"]
    x = outs[0]["x"].astype(np.float64)
    rel = (p.cost(x) - p.f_star) / abs(p.f_star)
    assert 0 <= rel < 1e-8
    assert np.all(x[p.x_star == 0] == 0.0)


def test_dryrun_multichip_on_four_ranks(setup):
    """``dryrun_multichip(4)`` completes on the four gloo ranks, its TP
    block on a (2, 2) mesh, and refuses a size the group is not."""
    _, _, _, results = setup
    for r in range(WORLD):
        out = tw.result(results, "dryrun", r)
        assert "dryrun_multichip(5)" in out["refusal"]
        assert "4 ranks" in out["refusal"]
        assert out["seconds"] > 0


def test_dryrun_multichip_needs_a_group():
    import torch.distributed as dist

    from ciao_tpu_torch.entry import dryrun_multichip

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(2\).*0 "
                                           r"ranks"):
        dryrun_multichip(2, device="cpu")


def test_entry_dryrun_spawns_two_cpu_ranks():
    """``python -m ciao_tpu_torch.entry dryrun 2 cpu`` spawns two gloo
    ranks and runs the dryrun (its TP block on a (1, 2) mesh)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "ciao_tpu_torch.entry",
                          "dryrun", "2", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip(2): ok" in out.stdout
