"""The port's data-parallel Katyusha, SARAH, L-SVRG, L-Katyusha,
Point-SAGA and SSNM against the JAX package, on four gloo ranks.

The port's ranks run in four processes spawned once for the module
(``tests/torch_parallel_worker.py``, which imports no JAX); JAX runs the
same configurations under ``shard_map`` on the first four devices of the
8-device CPU mesh. Each rank takes its device's draws as JAX makes them
(block starts, iid rows, and for the loopless pair the anchor coins,
which are the same on every device), so the f64 states agree to 1e-10
of each field's largest entry: the replicated vectors on every rank, the
tables (Point-SAGA's c, SSNM's c and zb) on each rank's rows.

The kernel paths of Katyusha's and SARAH's local inner loops (#10, #11
and the anchor pass #6, their plain versions on CPU tensors) are held to
the stepwise local loops at JAX's f32 bounds; the facades' convergence
runs (``tests/test_parallel.py``, ``test_lsvrg.py``,
``test_point_saga.py``, ``test_ssnm.py``) use the port's own draws.
"""

import functools

import numpy as np
import pytest

import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu.parallel import dp as jdp
from ciao_tpu.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

D = 4
N, n = 64, 8
n_loc = N // D
SEED = 3
STEPS, OUTER, M_INNER = 30, 3, 8


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _base(prob, dtype=np.float64):
    return dict(oracle={"kind": "lsq", "A": prob.A.astype(dtype),
                        "b": prob.b.astype(dtype), "scale": float(N)},
                prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(prob.A.shape[1], dtype))


def _consistent():
    """tests/test_point_saga.py's consistent least-squares system."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n))
    x_true = rng.standard_normal(n)
    return A, x_true, float(N) * (A * A).sum(axis=1)


def _cfg(**kw):
    return dict(dict(N=N, D=D, b_loc=4, sweeping=1, alpha=0.999), **kw)


# family -> {case: cfg overrides}
KATYUSHA_CASES = {
    "lockstep_block": dict(block=True, variant="ns"),
    "lockstep_iid": dict(b_loc=2, variant="sc"),
    "local_block": dict(block=True, local=True, variant="ns"),
    "local_iid": dict(b_loc=2, local=True, variant="sc"),
}
SARAH_CASES = {
    "lockstep_block": dict(block=True),
    "lockstep_iid": dict(b_loc=2),
    "local_block": dict(block=True, local=True),
    "local_iid": dict(b_loc=2, local=True),
}
LOOPLESS_CASES = {"block": dict(block=True), "iid": dict(b_loc=2)}
P_COIN = 0.25
TAU1_SC, ETA = 0.3, 0.8


def _scalars(prob):
    """Each family's first init scalar and extras, JAX's init order."""
    Lm = float(np.max(prob.L))
    return {
        "katyusha_ns": (Lm, (0.5, 0.5)),
        "katyusha_sc": (Lm, (TAU1_SC, 0.5)),
        "sarah": (1.0 / (2.0 * Lm), (ETA,)),
        "lsvrg": (1.0 / (6.0 * Lm), (P_COIN,)),
        "lkatyusha": (Lm, (0.0, 1.0 / 3.0, 0.5, P_COIN)),
        "point_saga": (1.0 / (3.0 * Lm), ()),
        "ssnm": (0.5, (1.0 / (1.5 * Lm),)),
    }


@functools.lru_cache(maxsize=None)
def _draws(fn, m, *args):
    """A ``torch_parallel_jax`` draw, made once for all its cases."""
    return getattr(tj, fn)(m, *args)


def _inner(m, cfg, b_loc):
    if cfg.get("block"):
        return dict(starts=_draws("svrg_starts", m, SEED, OUTER, M_INNER,
                                  n_loc, b_loc))
    return dict(idx=_draws("svrg_rows", m, SEED, OUTER, M_INNER, n_loc,
                           b_loc))


def _cases(m, prob):
    base = _base(prob)
    sc = _scalars(prob)
    cases = {}
    for name, kw in KATYUSHA_CASES.items():
        cfg = _cfg(m_inner=M_INNER, **kw)
        a, extra = sc["katyusha_" + kw["variant"]]
        cases["katyusha_" + name] = dict(
            base, fn="build", family="katyusha", cfg=cfg, gamma=a,
            extra=extra, seed=SEED, steps=OUTER,
            **_inner(m, cfg, cfg["b_loc"]))
    for name, kw in SARAH_CASES.items():
        cfg = _cfg(m_inner=M_INNER, **kw)
        a, extra = sc["sarah"]
        cases["sarah_" + name] = dict(
            base, fn="build", family="sarah", cfg=cfg, gamma=a, extra=extra,
            seed=SEED, steps=OUTER, **_inner(m, cfg, cfg["b_loc"]))
    for fam in ("lsvrg", "lkatyusha"):
        a, extra = sc[fam]
        for name, kw in LOOPLESS_CASES.items():
            cfg = _cfg(**kw)
            draws = (dict(starts=_draws("block_starts", m, SEED, STEPS,
                                        n_loc, 4, 1))
                     if kw.get("block") else
                     dict(idx=_draws("step_rows", m, SEED, STEPS, n_loc, 2)))
            cases[f"{fam}_{name}"] = dict(
                base, fn="build", family=fam, cfg=cfg, gamma=a, extra=extra,
                seed=SEED, steps=STEPS,
                coins=tj.coins(SEED, STEPS, P_COIN, D), **draws)
    for sw in (1, 2, 3):
        a, _ = sc["point_saga"]
        cases[f"point_saga_sweep{sw}"] = dict(
            base, fn="build", family="point_saga", cfg=_cfg(sweeping=sw),
            gamma=a, seed=SEED, steps=STEPS,
            starts=_draws("block_starts", m, SEED, STEPS, n_loc, 4, sw))
    a, extra = sc["ssnm"]
    cases["ssnm"] = dict(
        base, fn="build", family="ssnm",
        cfg=_cfg(block=True, coeff=True), gamma=a, extra=extra, seed=SEED,
        steps=STEPS, starts=_draws("block_starts", m, SEED, STEPS, n_loc, 4,
                                   1))
    # the kernel paths (plain versions on CPU tensors) against the stepwise
    # local loops, f32, shards of 256 rows, m = 150: one launch of 128
    # steps and one of 22 an outer step
    p32 = make_lasso(N=1024, n=32, p=4, seed=5, dtype=np.float32,
                     well_conditioned=True)
    b32 = _base(p32, np.float32)
    Lm32 = float(np.max(p32.L))
    for fused in (False, True):
        for fam, extra, a in (("katyusha", (0.5, 0.5), Lm32),
                              ("sarah", (1.0,), 1.0 / (2.0 * Lm32))):
            cases[f"{fam}_fused{fused}"] = dict(
                b32, fn="build", family=fam, steps=OUTER, gamma=a,
                extra=extra, seed=SEED,
                cfg=dict(N=1024, D=D, b_loc=16, sweeping=1, alpha=0.999,
                         block=True, coeff=fused, local=True, m_inner=150,
                         fused=fused,
                         variant="ns" if fam == "katyusha" else "basic"))
    # a run draws its steps' draws in one pass: the same as each step's
    for fam, cfg in (("katyusha", _cfg(block=True, local=True, m_inner=4,
                                       variant="ns")),
                     ("sarah", _cfg(block=True, m_inner=4)),
                     ("lsvrg", _cfg(block=True)),
                     ("lkatyusha", _cfg(b_loc=2)),
                     ("point_saga", _cfg(sweeping=3)),
                     ("ssnm", _cfg(block=True, coeff=True))):
        key = {"katyusha": "katyusha_ns"}.get(fam, fam)
        a, extra = sc[key]
        cases["runstep_" + fam] = dict(base, fn="run_vs_step", family=fam,
                                       cfg=cfg, gamma=a, extra=extra,
                                       seed=SEED, steps=9)
    # the storage-swap rebase: int8 rows, then the f32 rows' exact anchor
    for fam, anchor in (("lsvrg", "z"), ("lkatyusha", "w_anchor"),
                        ("point_saga", None), ("ssnm", None)):
        a, extra = sc[fam]
        cfg = _cfg(block=True, coeff=fam == "ssnm")
        cases["rebase_" + fam] = dict(
            _base(prob, np.float32), fn="rebase_vr", family=fam, cfg=cfg,
            gamma=np.float32(a), extra=extra, seed=SEED, steps=40,
            anchor=anchor)
    # facades on the port's own draws (the JAX tests' configurations):
    # the local modes and short runs on the four ranks; the runs of
    # thousands of lockstep all-reduces on a one-rank mesh (a gloo
    # all-reduce among four CPU ranks costs 1-14 ms)
    conv = {
        "katyusha_local": ("DPKatyusha", dict(maxit=60, batch=8,
                                              local_inner=True)),
        "sarah_local": ("DPSARAH", dict(maxit=30, batch=8, m=N,
                                        local_inner=True)),
        "ssnm_a": ("DPSSNM", dict(batch=8, maxit=200, seed=5)),
        "ssnm_b": ("DPSSNM", dict(batch=8, maxit=200, seed=5)),
    }
    for name, (cls, kw) in conv.items():
        cases["conv_" + name] = dict(base, fn="facade", cls=cls, kw=kw)
    A, x_true, Lc = _consistent()
    cons = dict(base, oracle={"kind": "lsq", "A": A, "b": A @ x_true,
                              "scale": float(N)}, L=Lc, prox={"kind": "zero"})
    cases["iter_lsvrg_p0"] = dict(base, fn="facade", cls="DPLSVRG",
                                  kw=dict(maxit=9, batch=8, p=0.0), take=6)
    cases["iter_ssnm"] = dict(base, fn="facade", cls="DPSSNM",
                              kw=dict(maxit=9, batch=8), take=2)
    solo = {name: dict(cls=cls, kw=kw) for name, (cls, kw) in {
        "katyusha": ("DPKatyusha", dict(maxit=60, batch=8)),
        "katyusha_sigma_block": ("DPKatyusha", dict(
            maxit=60, batch=8, sigma=1.0, block_sampling=True)),
        "sarah": ("DPSARAH", dict(maxit=30, batch=8, m=N)),
        "sarah_eta_block": ("DPSARAH", dict(maxit=30, batch=8, m=N, eta=0.8,
                                            block_sampling=True)),
        "lsvrg": ("DPLSVRG", dict(maxit=3000, batch=8)),
        "lsvrg_block": ("DPLSVRG", dict(maxit=3000, batch=8,
                                        block_sampling=True)),
        "lkatyusha": ("DPLKatyusha", dict(maxit=1000, batch=8)),
        "lkatyusha_block": ("DPLKatyusha", dict(maxit=1000, batch=8,
                                                block_sampling=True)),
        "ssnm": ("DPSSNM", dict(batch=8, maxit=1000, seed=5)),
    }.items()}
    # D = 1: the lockstep and local modes coincide bit for bit
    for cls in ("DPKatyusha", "DPSARAH"):
        for li in (False, True):
            solo[f"{cls}_local{li}"] = dict(
                cls=cls, kw=dict(maxit=5, batch=4, local_inner=li))
    solo["point_saga"] = dict(cons, cls="DPPointSAGA",
                              kw=dict(maxit=1500, batch=8))
    cases["solo"] = dict(base, fn="solo", shard=False, calls=solo)
    cases["errors"] = dict(base, fn="errors", cls="DPKatyusha", calls=[
        dict(kw=dict(tau2=1.0)),
        dict(kw=dict(batch=6)),
        dict(L=None),
        dict(kw=dict(batch=8, m=0)),
        dict(cls="DPSARAH", kw=dict(eta=1.5)),
        dict(cls="DPSARAH", kw=dict(batch=12, block_sampling=True)),
        dict(cls="DPSARAH", L=None),
        dict(cls="DPLSVRG", kw=dict(p=2.0)),
        dict(cls="DPLSVRG", L=None),
        dict(cls="DPLKatyusha", kw=dict(theta2=0.0)),
        dict(cls="DPLKatyusha", kw=dict(batch=12, block_sampling=True)),
        dict(cls="DPPointSAGA", kw=dict(maxit=2)),
        dict(cls="DPPointSAGA", prox={"kind": "zero"}, kw=dict(batch=12)),
        dict(cls="DPSSNM", L=None),
        dict(cls="DPSSNM", kw=dict(batch=12)),
    ])
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    m = tj.mesh(D)
    prob = _prob()
    cases = _cases(m, prob)
    results = tw.spawn(cases, D, tmp_path_factory.mktemp("vr"))
    return m, prob, cases, results


def _ranks(results, name):
    return [tw.result(results, name, r) for r in range(D)]


def _jax_run(m, c, steps):
    """JAX's build_dp_functions on the case: its init order is (x0, a,
    *extra, key), its draws its own."""
    o = c["oracle"]
    F = tj.lsq(o["A"], o["b"], o["scale"], m)
    g = tj.l1(c["prox"]["lam"])
    extra = tuple(np.float32(e) if c["family"] in ("lsvrg", "lkatyusha")
                  and i == len(c["extra"]) - 1 else np.float64(e)
                  for i, e in enumerate(c.get("extra", ())))
    return tj.run(m, c["family"], F, g, jdp.DPCfg(**c["cfg"]), np.zeros(n),
                  np.float64(c["gamma"]), SEED, steps, extra=extra)


@pytest.mark.parametrize("name", list(KATYUSHA_CASES))
def test_dp_katyusha_matches_jax(setup, name):
    """DP Katyusha (tests/test_parallel.py:1105), lockstep and local
    inner loops, block and iid inner steps, the ns schedule and a fixed
    τ₁, on JAX's inner draws: x̃, y, z and av after three outer steps."""
    m, _, cases, results = setup
    c = cases["katyusha_" + name]
    tj.compare(_ranks(results, "katyusha_" + name), _jax_run(m, c, OUTER))


@pytest.mark.parametrize("name", list(SARAH_CASES))
def test_dp_sarah_matches_jax(setup, name):
    """DP SARAH/ProxSARAH (tests/test_parallel.py:1140, η = 0.8),
    lockstep and local chains, block and iid inner steps."""
    m, _, cases, results = setup
    c = cases["sarah_" + name]
    tj.compare(_ranks(results, "sarah_" + name), _jax_run(m, c, OUTER))


@pytest.mark.parametrize("fam", ["lsvrg", "lkatyusha"])
@pytest.mark.parametrize("name", list(LOOPLESS_CASES))
def test_dp_loopless_matches_jax(setup, fam, name):
    """DP L-SVRG and L-Katyusha (tests/test_lsvrg.py:167, 264) over 30
    steps at p = 1/4 on JAX's draws and coins (the coins flip on several
    steps, so the stacked refresh partial is exercised)."""
    m, _, cases, results = setup
    c = cases[f"{fam}_{name}"]
    assert c["coins"][0].sum() >= 3
    tj.compare(_ranks(results, f"{fam}_{name}"), _jax_run(m, c, STEPS))


@pytest.mark.parametrize("sweeping", [1, 2, 3])
def test_dp_point_saga_matches_jax(setup, sweeping):
    """DP Point-SAGA (tests/test_point_saga.py:143) on random, cyclic and
    shuffled sub-blocks: x, av and each rank's coefficient rows."""
    m, _, cases, results = setup
    c = cases[f"point_saga_sweep{sweeping}"]
    tj.compare(_ranks(results, f"point_saga_sweep{sweeping}"),
               _jax_run(m, c, STEPS), local=("c",))


def test_dp_ssnm_matches_jax(setup):
    """DP SSNM (tests/test_ssnm.py:158): each rank's own momentum point;
    x, ḡ and each rank's c and zb rows."""
    m, _, cases, results = setup
    tj.compare(_ranks(results, "ssnm"), _jax_run(m, cases["ssnm"], STEPS),
               local=("c", "zb"))


@pytest.mark.parametrize("fam", ["katyusha", "sarah"])
def test_dp_local_inner_fused_matches_stepwise(setup, fam):
    """The local inner loop on #10's (Katyusha) or #11's (SARAH) path,
    the anchor and the bootstrap on #6's, against the stepwise local loop
    on the same draws, f32 (tests/test_parallel.py:1584, 1624: rtol 2e-4,
    atol 1e-6)."""
    _, _, _, results = setup
    fields = ("x_tilde", "y", "z", "av") if fam == "katyusha" else (
        "x_tilde",)
    for r in range(D):
        a = tw.result(results, f"{fam}_fusedFalse", r)
        b = tw.result(results, f"{fam}_fusedTrue", r)
        for f in fields:
            np.testing.assert_allclose(b[f], a[f], rtol=2e-4, atol=1e-6,
                                       err_msg=f)
        assert b["it"] == a["it"] == 1 + OUTER
    if fam == "katyusha":
        canch = tw.result(results, "katyusha_fusedTrue")["canch"]
        assert canch.shape == (1024 // D,) and canch.dtype == np.float32


@pytest.mark.parametrize("name", ["katyusha_local", "sarah_local"])
def test_dp_vr_local_inner_converges(setup, name):
    """The local inner loops on four ranks (two all-reduces an outer
    step) reach the planted optimum at the reference tolerance, every
    rank the same bits (tests/test_parallel.py:1105, 1140)."""
    _, prob, _, results = setup
    xs = [tw.result(results, "conv_" + name, r)["x"] for r in range(D)]
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])
    assert prob.cost(xs[0]) - prob.f_star < 1e-4


@pytest.mark.parametrize("name", ["katyusha", "katyusha_sigma_block",
                                  "sarah", "sarah_eta_block", "lsvrg",
                                  "lsvrg_block", "lkatyusha",
                                  "lkatyusha_block", "ssnm"])
def test_dp_vr_facades_converge(setup, name):
    """The lockstep facades on the port's own draws reach the planted
    optimum at the reference tolerance (tests/test_parallel.py:1105,
    1140; tests/test_lsvrg.py:167, 264; tests/test_ssnm.py:158; at their
    step counts but L-SVRG's 3,000 for 4,000, L-Katyusha's 1,000 for
    3,000 and SSNM's 1,000 for 4,000), on a one-rank mesh: their
    thousands of lockstep all-reduces would take minutes among four CPU
    ranks, where the parity tests above stand for them."""
    _, prob, _, results = setup
    x = tw.result(results, "solo")[name]["x"]
    assert prob.cost(x) - prob.f_star < 1e-4


def test_dp_lsvrg_p0_freezes_the_anchor(setup):
    """p = 0: the coin never flips, so the anchor stays x0 on every rank
    (tests/test_lsvrg.py:167)."""
    _, _, _, results = setup
    for r in range(D):
        st = tw.result(results, "iter_lsvrg_p0", r)
        assert st["n_states"] == 6 and st["it"] == 6
        np.testing.assert_array_equal(st["z"], np.zeros(n))


def test_dp_point_saga_converges(setup):
    """DPPointSAGA reaches the consistent system's solution
    (tests/test_point_saga.py:143)."""
    _, _, _, results = setup
    _, x_true, _ = _consistent()
    x = tw.result(results, "solo")["point_saga"]["x"]
    assert np.linalg.norm(x - x_true) < 1e-4


def test_dp_ssnm_cut_and_deterministic(setup):
    """DPSSNM on four ranks (tests/test_ssnm.py:158): its tables hold
    the rank's rows (c: n_loc, zb: d_loc blocks), the cost falls, and
    the same seed gives the same bits."""
    _, prob, _, results = setup
    x0 = np.zeros(n)
    for r in range(D):
        xa = tw.result(results, "conv_ssnm_a", r)["x"]
        np.testing.assert_array_equal(
            xa, tw.result(results, "conv_ssnm_b", r)["x"])
        assert prob.cost(xa) < prob.cost(x0)
        st = tw.result(results, "iter_ssnm", r)
        assert st["c"].shape == (n_loc,) and st["zb"].shape == (n_loc // 2, n)
        assert st["x"].shape == (n,)


def test_dp_katyusha_sarah_modes_equal_at_one_rank(setup):
    """On a one-rank mesh the lockstep and local modes are the same bits
    (tests/test_parallel.py:1105, 1140): the same draws, and an
    all-reduce over one rank is the identity."""
    _, _, _, results = setup
    out = tw.result(results, "solo")
    for cls in ("DPKatyusha", "DPSARAH"):
        np.testing.assert_array_equal(out[f"{cls}_localFalse"]["x"],
                                      out[f"{cls}_localTrue"]["x"])


@pytest.mark.parametrize("fam", ["katyusha", "sarah", "lsvrg", "lkatyusha",
                                 "point_saga", "ssnm"])
def test_dp_vr_run_draws_equal_step_draws(setup, fam):
    """A ``run`` draws its steps' starts (and the loopless pair's coins)
    in one pass; they are the draws each ``step`` makes on its own: the
    same bits over nine steps."""
    _, _, _, results = setup
    for r in range(D):
        out = tw.result(results, "runstep_" + fam, r)
        for f, v in out["run"].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, out["step"][f])
        assert out["run"]["it"] == out["step"]["it"] == 10


@pytest.mark.parametrize("fam", ["lsvrg", "lkatyusha", "point_saga",
                                 "ssnm"])
def test_dp_vr_rebase_after_storage_swap(setup, fam):
    """After 40 steps on int8 rows, the f32 rows' rebase recomputes the
    anchor gradient (L-SVRG, L-Katyusha) or the table mean (Point-SAGA,
    SSNM) exactly: the whole f32 oracle's value at the state's anchor,
    which the int8 rows' value was not."""
    _, _, _, results = setup
    key = {"ssnm": "gbar"}.get(fam, "av")
    for r in range(D):
        out = tw.result(results, "rebase_" + fam, r)
        want = out["want"]
        np.testing.assert_allclose(out["after"][key], want, rtol=1e-5,
                                   atol=1e-6 * np.max(np.abs(want)))
        assert tj.gap(out["before"][key], want) > 1e-5
        for f, v in out["after"].items():
            if f != key and isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, out["before"][f])


def test_dp_vr_validation_errors(setup):
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    want = ["tau2", "divisible by D", "smoothness moduli L", "m must be",
            "eta", "block_sampling", "smoothness moduli L", "p must",
            "provide L or", "theta2", "block_sampling", "composite",
            "batch/D must divide", "provide L, or both", "must divide N/D"]
    assert len(msgs) == len(want)
    for msg, w in zip(msgs, want):
        assert msg is not None and w in msg, (w, msg)
