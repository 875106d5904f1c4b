"""The port's data-parallel Finito family (basic, coefficient, LFinito,
adaptive) and ProShI against the JAX package, on four gloo ranks.

As in ``tests/test_torch_parallel_dp.py``: the port's ranks run in four
spawned processes that import no JAX, take each device's schedule as
JAX's ``shard_map`` draws it, and their f64 states agree with JAX's to
1e-10 of each field's largest entry (the largest gap reached is below
1e-13); the kernel paths (the plain versions on CPU tensors) are held
to the stepwise ones in f32 with JAX's bounds; the convergence runs use
the port's own draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu import Proshi as JProshi
from ciao_tpu.oracles import DiagQuadratic, SqrDistBox, SumOracle
from ciao_tpu.parallel import dp as jdp
from ciao_tpu.parallel import shard_finite_sum
from ciao_tpu.prox import IndBox as JIndBox
from ciao_tpu.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

D = 4
N, n = 64, 8
n_loc = N // D
SEED = 3
STEPS, ROUNDS, K_LOC, EPOCHS = 30, 3, 4, 3


def _base(prob, dtype=np.float64, scale=None):
    Np, npx = prob.A.shape
    return dict(oracle={"kind": "lsq", "A": prob.A.astype(dtype),
                        "b": prob.b.astype(dtype),
                        "scale": float(scale or Np)},
                prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(npx, dtype))


def _cfg(**kw):
    return dict(dict(N=N, D=D, b_loc=4, sweeping=2, alpha=0.999), **kw)


def _gamma(prob, Np=N, dtype=np.float64):
    return (0.999 * Np / np.asarray(prob.L)).astype(dtype)


FINITO = {"random": dict(sweeping=1), "cyclic": dict(sweeping=2),
          "shuffled": dict(sweeping=3)}
COEFF = {"cyclic": 2, "shuffled": 3}
LFIN = {"cyclic": dict(sweeping=2), "shuffled": dict(sweeping=3),
        "local_shuffled": dict(sweeping=3, local=True)}
ADAPTIVE = {"random": 1, "cyclic": 2, "shuffled": 3}


def _sharing():
    """tests/test_parallel.py's 24-block sharing problem (the reference's
    3 blocks, test_sharing.jl:13-24, replicated 8x)."""
    d = np.tile(np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]]), (8, 1))
    q = np.ones_like(d)
    Nb = d.shape[0]
    eta = Nb * 10.0
    L = np.abs(d).max(axis=1) + eta
    return d, q, Nb, eta, L


def _sharing_base():
    d, q, Nb, eta, L = _sharing()
    return dict(oracle={"kind": "sharing", "d": d, "q": q, "lo": -2.0,
                        "hi": 2.0, "eta": eta, "n_terms": Nb},
                prox={"kind": "box", "lo": -np.inf, "hi": np.ones(2)},
                L=L, x0=np.zeros(2), N=Nb)


def _cases(m, prob):
    base = _base(prob)
    gam = _gamma(prob)
    cases = {}
    for name, kw in FINITO.items():
        c = dict(base, fn="build", family="finito", cfg=_cfg(**kw),
                 gamma=gam, seed=SEED, steps=STEPS)
        if kw["sweeping"] == 1:
            c["idx"] = tj.indices(m, SEED, STEPS, n_loc, 4, 1)
        else:
            c["starts"] = tj.block_starts(m, SEED, STEPS, n_loc, 4,
                                          kw["sweeping"])
        cases["finito_" + name] = c
    for name, sw in COEFF.items():
        cases["coeff_" + name] = dict(
            base, fn="build", family="finito_coeff",
            cfg=_cfg(sweeping=sw, coeff=True), gamma=gam, seed=SEED,
            steps=STEPS,
            starts=tj.block_starts(m, SEED, STEPS, n_loc, 4, sw))
    cases["coeff_local"] = dict(
        base, fn="build", family="finito_coeff", gamma=gam, seed=SEED,
        cfg=_cfg(sweeping=3, coeff=True, local_steps=K_LOC, rebase_every=2),
        steps=ROUNDS, starts=tj.rounds(m, SEED, ROUNDS, K_LOC, n_loc, 4, 3))
    for name, kw in LFIN.items():
        cases["lfinito_" + name] = dict(
            base, fn="build", family="lfinito", cfg=_cfg(**kw), gamma=gam,
            seed=SEED, steps=EPOCHS,
            starts=tj.lfinito_orders(m, SEED, EPOCHS, n_loc // 4, 4,
                                     kw["sweeping"]))
    for name, sw in ADAPTIVE.items():
        cases["adaptive_" + name] = dict(
            base, fn="build", family="finito_adaptive", seed=SEED,
            cfg=_cfg(b_loc=1, sweeping=sw, variant="adaptive"), steps=STEPS,
            idx=tj.adaptive_indices(SEED, STEPS, N, sw, D))
    # the kernel paths (plain versions on CPU tensors) against the
    # stepwise ones, f32, shards of 256 rows
    p32 = make_lasso(N=1024, n=32, p=4, seed=5, dtype=np.float32,
                     well_conditioned=True)
    g32 = _gamma(p32, 1024, np.float32)
    big = dict(N=1024, D=D, b_loc=16, alpha=0.999)
    for fused in (False, True):
        cases[f"coeff_round_fused{fused}"] = dict(
            _base(p32, np.float32), fn="build", family="finito_coeff",
            gamma=g32, steps=3, seed=SEED,
            cfg=dict(big, sweeping=3, coeff=True, local_steps=8,
                     fused=fused, rebase_every=2))
        for storage in (None, "int8"):
            b = _base(p32, np.float32)
            b["oracle"] = dict(b["oracle"], storage=storage)
            cases[f"lfinito_local_fused{fused}_{storage}"] = dict(
                b, fn="build", family="lfinito", gamma=g32, steps=3,
                seed=SEED, cfg=dict(big, sweeping=3, local=True,
                                    fused=fused))
        b = _base(p32, np.float32)
        b["prox"] = {"kind": "box", "lo": -np.inf, "hi": np.float32(0.5)}
        cases[f"proshi_round_fused{fused}"] = dict(
            b, fn="build", family="proshi", gamma=g32, steps=3, seed=SEED,
            cfg=dict(big, sweeping=2, local_steps=6, fused=fused,
                     rebase_every=50))
    # facades on the port's own draws
    conv = {"sweep1": dict(maxit=900, batch=16, sweeping=1),
            "sweep2": dict(maxit=600, batch=16, sweeping=2),
            "sweep3": dict(maxit=650, batch=16, sweeping=3),
            "lfinito": dict(LFinito=True, maxit=120, batch=16, sweeping=3),
            "lfinito_local": dict(LFinito=True, local_sweep=True, maxit=120,
                                  batch=8, sweeping=3),
            "local": dict(maxit=200, batch=16, sweeping=2, local_steps=4,
                          seed=3),
            "full": dict(maxit=200, batch=16, sweeping=2, table="full",
                         seed=3),
            "coeff": dict(maxit=200, batch=16, sweeping=2, table="coeff",
                          seed=3),
            "adaptive": dict(adaptive=True, sweeping=2, maxit=200)}
    for name, kw in conv.items():
        cases["conv_" + name] = dict(base, fn="facade", cls="DPFinito", kw=kw)
    cases["local_iter"] = dict(base, fn="facade", cls="DPFinito",
                               kw=dict(batch=16, sweeping=2, local_steps=4,
                                       seed=3), take=7)
    cases["adaptive_iter"] = dict(base, fn="facade", cls="DPFinito",
                                  kw=dict(adaptive=True, sweeping=2),
                                  take=1)
    pa = make_lasso(N=64, n=8, p=3, seed=1)
    ab = _base(pa)
    ab["oracle"] = dict(ab["oracle"], A=pa.A * 1e8)
    cases["adaptive_abort"] = dict(ab, fn="facade", cls="DPFinito",
                                   kw=dict(adaptive=True, sweeping=2,
                                           tol_b=1e30), take=500)
    cases["errors"] = dict(base, fn="errors", cls="DPFinito", calls=[
        dict(kw=dict(adaptive=True, LFinito=True)),
        dict(kw=dict(adaptive=True, batch=8)),
        dict(kw=dict(maxit=10, batch=16, sweeping=1, local_steps=4)),
        dict(kw=dict(maxit=10, batch=8, local_sweep=True)),
        dict(_sharing_base(), cls="DPProshi",
             kw=dict(maxit=10, batch=16, local_steps=4))])
    # ProShI on the sharing problem
    sb = _sharing_base()
    d, q, Nb, eta, L = _sharing()
    gsh = 0.999 * Nb / L
    shcfg = dict(N=Nb, D=D, b_loc=2, alpha=0.999)
    cases["proshi_cyclic"] = dict(
        sb, fn="build", family="proshi", cfg=dict(shcfg, sweeping=2),
        gamma=gsh, seed=SEED, steps=STEPS,
        starts=tj.block_starts(m, SEED, STEPS, Nb // D, 2, 2))
    cases["proshi_random"] = dict(
        sb, fn="build", family="proshi", cfg=dict(shcfg, sweeping=1),
        gamma=gsh, seed=SEED, steps=STEPS,
        idx=tj.indices(m, SEED, STEPS, Nb // D, 2, 1))
    cases["proshi_local"] = dict(
        sb, fn="build", family="proshi", gamma=gsh, seed=SEED,
        cfg=dict(shcfg, sweeping=2, local_steps=3, rebase_every=2),
        steps=ROUNDS, starts=tj.rounds(m, SEED, ROUNDS, 3, Nb // D, 2, 2))
    cases["proshi_conv"] = dict(sb, fn="facade", cls="DPProshi",
                                kw=dict(maxit=1300, batch=8, local_steps=4,
                                        sweeping=2))
    cases["proshi_local_iter"] = dict(sb, fn="facade", cls="DPProshi",
                                      kw=dict(batch=8, local_steps=3,
                                              sweeping=2), take=3)
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    m = tj.mesh(D)
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    cases = _cases(m, prob)
    results = tw.spawn(cases, D, tmp_path_factory.mktemp("finito"))
    return m, prob, cases, results


def _ranks(results, name):
    return [tw.result(results, name, r) for r in range(D)]


def _jax(m, c, family, steps, gamma=None):
    o = c["oracle"]
    F = tj.lsq(o["A"], o["b"], o["scale"], m)
    g = tj.l1(c["prox"]["lam"])
    gamma = jnp.asarray(c["gamma"]) if gamma is None else gamma
    return tj.run(m, family, F, g, jdp.DPCfg(**c["cfg"]), np.zeros(n),
                  gamma, SEED, steps)


@pytest.mark.parametrize("name", list(FINITO))
def test_dp_finito_matches_jax(setup, name):
    """DP Finito with the full table, random rows and cyclic/shuffled
    blocks: z, av and each rank's table rows and stepsizes."""
    m, _, cases, results = setup
    jst = _jax(m, cases["finito_" + name], "finito", STEPS)
    tj.compare(_ranks(results, "finito_" + name), jst, local=("s", "gamma"))


@pytest.mark.parametrize("name", list(COEFF))
def test_dp_finito_coeff_matches_jax(setup, name):
    m, _, cases, results = setup
    jst = _jax(m, cases["coeff_" + name], "finito_coeff", STEPS)
    tj.compare(_ranks(results, "coeff_" + name), jst,
               local=("c", "zb", "invg"))


def test_dp_finito_local_round_matches_jax(setup):
    """Coefficient-Finito local rounds (K = 4, rebase every 2nd)."""
    m, _, cases, results = setup
    jst = _jax(m, cases["coeff_local"], "finito_coeff", ROUNDS)
    tj.compare(_ranks(results, "coeff_local"), jst,
               local=("c", "zb", "invg"))


@pytest.mark.parametrize("name", list(LFIN))
def test_dp_lfinito_matches_jax(setup, name):
    """LFinito epochs, lockstep (one all-reduce a block) and local-sweep
    (two an epoch), in JAX's per-device visit orders."""
    m, _, cases, results = setup
    jst = _jax(m, cases["lfinito_" + name], "lfinito", EPOCHS)
    tj.compare(_ranks(results, "lfinito_" + name), jst, local=("gamma",))


@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_dp_finito_adaptive_matches_jax(setup, name):
    """Adaptive Finito in lockstep: the probe's stepsizes, the three
    tables on each rank's rows, the backtracked hat_γ, av and z."""
    m, _, cases, results = setup
    jst = _jax(m, cases["adaptive_" + name], "finito_adaptive", STEPS,
               gamma=jnp.zeros(N))
    tj.compare(_ranks(results, "adaptive_" + name), jst,
               local=("s", "gradf", "fi_x", "gamma"))


def test_dp_finito_local_round_fused_matches_stepwise(setup):
    """The round on kernel #9's path against the stepwise round, f32:
    JAX's bounds (z rtol 2e-5, atol 1e-6; c rtol 2e-4, atol 1e-2)."""
    _, _, _, results = setup
    for r in range(D):
        a = tw.result(results, "coeff_round_fusedFalse", r)
        b = tw.result(results, "coeff_round_fusedTrue", r)
        np.testing.assert_allclose(b["z"], a["z"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["zb"], a["zb"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["c"], a["c"], rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("storage", [None, "int8"])
def test_dp_lfinito_local_sweep_fused_matches_stepwise(setup, storage):
    """The local epoch on kernels #6 and #8's path against the stepwise
    sweep on the same operator, f32 rows (rtol 2e-5, atol 1e-5) and int8
    rows, whose kernel dots round to bf16 as the TPU's do while the
    stepwise products stay f32: there within 1e-3 of the largest entry
    (the gap reached is 1.4e-4)."""
    _, _, _, results = setup
    for r in range(D):
        a = tw.result(results, f"lfinito_local_fusedFalse_{storage}", r)
        b = tw.result(results, f"lfinito_local_fusedTrue_{storage}", r)
        for f in ("z", "av", "z_full"):
            if storage is None:
                np.testing.assert_allclose(b[f], a[f], rtol=2e-5, atol=1e-5)
            else:
                assert tj.gap(b[f], a[f]) <= 1e-3, f


def test_dp_proshi_local_round_fused_matches_stepwise(setup):
    """The cyclic round on kernel #18's path against the stepwise round,
    f32, with JAX's bounds."""
    _, _, _, results = setup
    for r in range(D):
        a = tw.result(results, "proshi_round_fusedFalse", r)
        b = tw.result(results, "proshi_round_fusedTrue", r)
        np.testing.assert_allclose(b["z"], a["z"], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(b["s"], a["s"], rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(b["av"], a["av"], rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("name", ["sweep1", "sweep2", "sweep3", "lfinito",
                                  "lfinito_local", "local"])
def test_dp_finito_converges(setup, name):
    """The facades reach the planted optimum at the reference tolerance
    (tests/test_parallel.py:67-96, 603, 709)."""
    _, prob, _, results = setup
    xs = [tw.result(results, "conv_" + name, r)["x"] for r in range(D)]
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])
    assert prob.cost(xs[0]) - prob.f_star < 1e-4


def test_dp_finito_coeff_matches_full(setup):
    """The coefficient table equals the full table on the same draws."""
    _, _, _, results = setup
    for r in range(D):
        np.testing.assert_allclose(
            tw.result(results, "conv_coeff", r)["x"],
            tw.result(results, "conv_full", r)["x"], rtol=1e-12, atol=1e-12)


def test_dp_finito_matches_single_card(setup):
    """DP and single-card minibatch Finito find the same solution
    (tests/test_parallel.py:120)."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import Finito

    _, prob, _, results = setup
    F = LeastSquaresRows(torch.from_numpy(prob.A), torch.from_numpy(prob.b),
                         float(N))
    x_sc, _ = Finito(maxit=900, minibatch=(True, 16), device="cpu")(
        torch.zeros(n, dtype=torch.float64), F=F,
        g=NormL1(torch.tensor(prob.lam)), L=torch.from_numpy(prob.L))
    np.testing.assert_allclose(tw.result(results, "conv_sweep1")["x"],
                               x_sc.numpy(), atol=2e-3)


def test_dp_finito_local_round_invariants(setup):
    """After every round av is the exact table identity
    av = hat·(Σ invg_j·zb_j − Σ c_i·a_i/N) and z = prox(av); one iterate
    is one round of K steps."""
    _, prob, _, results = setup
    parts = [tw.result(results, "local_iter", r) for r in range(D)]
    assert parts[0]["it"] == 1 + 6 * 4
    hat = parts[0]["hat_gamma"]
    s = sum(p["invg"] @ p["zb"] - prob.A[r * n_loc:(r + 1) * n_loc].T
            @ p["c"] / N for r, p in enumerate(parts))
    np.testing.assert_allclose(parts[0]["av"], hat * s, rtol=1e-10,
                               atol=1e-12)
    lam = prob.lam * hat
    av = parts[0]["av"]
    np.testing.assert_allclose(parts[0]["z"], np.sign(av) * np.maximum(
        np.abs(av) - lam, 0), rtol=1e-10, atol=1e-12)


def test_dp_finito_adaptive_matches_single_card_cyclic(setup):
    """Cyclic adaptive Finito: the DP run equals the single-card one to
    reduction-order noise (tests/test_parallel.py:1293), and its tables
    are cut by rows with positive probed stepsizes."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import Finito

    _, prob, _, results = setup
    F = LeastSquaresRows(torch.from_numpy(prob.A), torch.from_numpy(prob.b),
                         float(N))
    x_sc, _ = Finito(adaptive=True, sweeping=2, maxit=200, device="cpu")(
        torch.zeros(n, dtype=torch.float64), F=F,
        g=NormL1(torch.tensor(prob.lam)))
    np.testing.assert_allclose(tw.result(results, "conv_adaptive")["x"],
                               x_sc.numpy(), rtol=0, atol=1e-10)
    st = tw.result(results, "adaptive_iter")
    assert st["s"].shape == (n_loc, n) and st["gradf"].shape == (n_loc, n)
    assert st["fi_x"].shape == (n_loc,) and np.all(st["gamma"] > 0)


def test_dp_adaptive_iterator_terminates_on_abort(setup):
    """The γ-underflow abort ends the stream (tests/test_parallel.py:
    1704): the facade passes can_abort for the adaptive variant."""
    _, _, _, results = setup
    for r in range(D):
        assert tw.result(results, "adaptive_abort", r)["n_states"] < 500


def test_dp_finito_validation_errors(setup):
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    assert "exclusive" in msgs[0]
    assert "single-index" in msgs[1]
    assert "local_steps" in msgs[2]
    assert "local_sweep" in msgs[3]
    assert "N/D divisible by batch/D" in msgs[4]


@pytest.mark.parametrize("name", ["cyclic", "random", "local"])
def test_dp_proshi_matches_jax(setup, name):
    """DP ProShI on the sharing problem (a SumOracle of DiagQuadratic and
    a SqrDistBox whose term count stays global): lockstep cyclic and
    random, and local rounds (K = 3, rebase every 2nd)."""
    m, _, cases, results = setup
    c = cases["proshi_" + name]
    d, q, Nb, eta, L = _sharing()
    F = shard_finite_sum(SumOracle(terms=(
        DiagQuadratic(d=jnp.asarray(d), q=jnp.asarray(q)),
        SqrDistBox(lo=jnp.asarray(-2.0), hi=jnp.asarray(2.0),
                   eta=jnp.asarray(eta), n_terms=Nb))), m, N=Nb)
    g = JIndBox(lo=-jnp.inf, hi=jnp.asarray(np.ones(2)))
    jst = tj.run(m, "proshi", F, g, jdp.DPCfg(**c["cfg"]), np.zeros(2),
                 jnp.asarray(c["gamma"]), SEED, c["steps"])
    tj.compare(_ranks(results, "proshi_" + name), jst, local=("s", "gamma"))


def test_dp_proshi_converges(setup):
    """DP ProShI in local rounds (K = 4) reaches the single-card coupling
    target (JAX's Proshi at the matched batch of 8, tests/test_parallel.
    py:198, 980) and keeps the constraint; each rank returns its own
    blocks. The lockstep path's parity above stands for its 10,000
    steps, each an all-reduce, too long on four CPU ranks."""
    _, _, _, results = setup
    d, q, Nb, eta, L = _sharing()
    F = SumOracle(terms=(
        DiagQuadratic(d=jnp.asarray(d), q=jnp.asarray(q)),
        SqrDistBox(lo=jnp.asarray(-2.0), hi=jnp.asarray(2.0),
                   eta=jnp.asarray(eta), n_terms=Nb)))
    g = JIndBox(lo=-jnp.inf, hi=jnp.asarray(np.ones(2)))
    x_ref, _ = JProshi(maxit=10000, minibatch=(True, 8))(
        jnp.zeros(2), F=F, g=g, L=jnp.asarray(L), N=Nb)
    sum_ref = np.asarray(jnp.sum(x_ref, axis=0))
    parts = [tw.result(results, "proshi_conv", r)["x"] for r in range(D)]
    assert all(p.shape == (Nb // D, 2) for p in parts)
    got = np.sum(np.concatenate(parts), axis=0)
    np.testing.assert_allclose(got, sum_ref, atol=2e-2)
    assert np.all(got <= 1.0 + 1e-6)


def test_dp_proshi_local_round_invariant(setup):
    """After a local round av is the exact global block sum."""
    _, _, _, results = setup
    parts = [tw.result(results, "proshi_local_iter", r) for r in range(D)]
    assert parts[0]["it"] == 1 + 2 * 3
    total = sum(p["s"].sum(axis=0) for p in parts)
    np.testing.assert_allclose(parts[0]["av"], total, rtol=1e-8, atol=1e-10)
