"""The port's tensor-parallel path (``make_mesh_2d``, TPSAGA/SAG, TPFinito,
TPLFinito, TPSVRG/SVRG++, TPProshi, TPForwardBackward/TPFISTA,
``deep_solve_tp``) against the JAX package, on four gloo ranks.

The port's ranks run in four processes spawned once for the module
(``tests/torch_parallel_worker.py``, which imports no JAX). The lockstep
cases run them as a (2, 2) mesh; JAX runs the same configurations under
``shard_map`` on ``make_mesh_2d(2, 2)`` of the first four devices of the
8-device CPU mesh. Both take the same numpy data, and each data row of the
port takes that row's JAX draws (``tests/torch_parallel_jax.py``), so the
f64 states agree to 1e-10 of each field's largest entry: each rank's
columns of z, av and the anchors, its rows of the tables. The facades'
convergence runs use the port's own draws on a one-rank (1, 1) mesh, at
JAX's global batch (its per-row batch times its four data rows), or on a
(1, 2) mesh where the cut of the coordinates is the point: thousands of
lockstep reductions among four busy CPU ranks take minutes.
"""

import numpy as np
import pytest
import torch

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
STEPS = dict(saga=24, finito=16, lfinito=3, svrg=3, proshi=16, fb=20)
M_INNER = 8


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _base(prob, dtype=np.float64, storage=None):
    o = {"kind": "lsq", "A": prob.A.astype(dtype), "b": prob.b.astype(dtype),
         "scale": float(N)}
    if storage:
        o["storage"] = storage
    return dict(oracle=o, prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(prob.A.shape[1], dtype))


def _sharing():
    """tests/test_parallel.py's 24-block sharing problem (the reference's
    3 blocks replicated 8x, test_sharing.jl:13-24), IndBox(-inf, ones)."""
    d = np.tile(np.array([[1.0, 2.0], [-1.0, 3.0], [0.0, 10.0]]), (8, 1))
    Nb, nb = d.shape
    eta = Nb * 10.0
    return dict(oracle={"kind": "sharing", "d": d, "q": np.ones_like(d),
                        "lo": -2.0, "hi": 2.0, "eta": eta, "n_terms": Nb},
                prox={"kind": "box", "lo": -np.inf, "hi": np.ones(nb)},
                L=np.abs(d).max(axis=1) + eta, N=Nb, x0=np.zeros(nb))


def _gamma_saga(prob, sag=False):
    return 1.0 / ((16.0 if sag else 3.0) * float(np.max(prob.L)))


def _lockstep(m1, prob):
    """The (2, 2) parity cases: name -> (port case, JAX facade class
    name, its knobs, the state's extra axes)."""
    base = _base(prob)
    gam_i = 0.999 * N / prob.L
    gam_svrg = 1.0 / (7 * float(np.max(prob.L)))
    out = {}

    def add(name, family, cfg, gamma, cls, kw, steps, extra=(), axes=None,
            **sched):
        c = dict(sched.pop("base", base), fn="tp_build", family=family,
                 cfg=dict(dict(N=N, D=D, M=M, b_loc=B), **cfg), gamma=gamma,
                 seed=SEED, steps=steps, extra=extra, **FULL, **sched)
        out[name] = (c, cls, kw, axes)

    for name, sag, storage in (("saga", False, None), ("sag", True, None),
                               ("saga_int8", False, "int8")):
        gam = _gamma_saga(prob, sag)
        add(name, "saga", dict(sag=sag), gam, "TPSAGA",
            dict(batch=B, gamma=gam, SAG_flag=sag, seed=SEED), STEPS["saga"],
            base=_base(prob, storage=storage),
            starts=tj.tp_saga_starts(m1, SEED, STEPS["saga"], n_loc, B))
    for sw in (1, 2, 3):
        add(f"finito{sw}", "finito", dict(sweeping=sw), gam_i, "TPFinito",
            dict(batch=B, sweeping=sw, seed=SEED), STEPS["finito"],
            starts=tj.block_starts(m1, SEED, STEPS["finito"], n_loc, B, sw))
    for sw in (2, 3):
        add(f"lfinito{sw}", "lfinito", dict(sweeping=sw), gam_i, "TPLFinito",
            dict(batch=B, sweeping=sw, seed=SEED), STEPS["lfinito"],
            starts=tj.lfinito_orders(m1, SEED, STEPS["lfinito"], n_loc // B,
                                     B, sw))
    for name, plus, m0 in (("svrg", False, M_INNER), ("svrg_plus", True, 2)):
        add(name, "svrg", dict(plus=plus), gam_svrg, "TPSVRG",
            dict(batch=B, m=m0, plus=plus, gamma=gam_svrg, seed=SEED),
            STEPS["svrg"], extra=(m0,),
            starts=tj.tp_svrg_starts(m1, SEED, STEPS["svrg"], m0, n_loc, B,
                                     plus))
    sh = _sharing()
    Nb = sh["N"]
    gam_p = 0.999 * Nb / sh["L"]
    for sw in (1, 2):
        sched = (dict(idx=tj.indices(m1, SEED, STEPS["proshi"], Nb // D, 4,
                                     sw)) if sw == 1 else
                 dict(starts=tj.block_starts(m1, SEED, STEPS["proshi"],
                                             Nb // D, 4, sw)))
        add(f"proshi{sw}", "proshi", dict(N=Nb, sweeping=sw), gam_p,
            "TPProshi", dict(batch=4 * D, sweeping=sw, seed=SEED),
            STEPS["proshi"], axes={"s": ("data", "model")}, base=sh, **sched)
    gam_fb = 1.0 / float(np.mean(prob.L))
    for name, kw in (("ista", {}), ("fista", dict(fast=True)),
                     ("fista_polish", dict(fast=True, polish_chunk=8))):
        add(name, "fb", dict(b_loc=1, **kw), gam_fb, "TPForwardBackward",
            dict(gamma=gam_fb, **kw), STEPS["fb"])
    return out


def _cases(lock, prob):
    base = _base(prob)
    cases = {name: c for name, (c, *_) in lock.items()}
    cases["mesh"] = dict(fn="tp_mesh", N=N, n=n, **FULL)
    cases["layout"] = dict(base, fn="tp_layout", **FULL,
                           prox={"kind": "l1", "lam": np.full(n, 0.1)})
    cases["layout_int8"] = dict(_base(prob, storage="int8"),
                                fn="tp_layout", **FULL)
    cases["power"] = dict(base, fn="tp_power", N=N, seed=5, iters=6,
                          x=np.linspace(-1, 1, n), **FULL)
    cases["stepwise_saga"] = dict(
        cases["saga"], stepwise=True)
    cases["rebased_saga"] = dict(cases["saga"], rebase=True)
    cases["rebased_finito"] = dict(cases["finito3"], rebase=True)
    # the (1, 1) mesh beside the single-device solvers on one schedule
    p32 = make_lasso(N=N, n=n, p=3, seed=3)
    rng = np.random.default_rng(4)
    cases["vs_single"] = dict(base, fn="tp_vs_single", N=N, B=8,
                              gamma=_gamma_saga(p32),
                              starts=rng.integers(0, N // 8, 40) * 8, **ONE)
    # the facades on the port's own draws
    gam_svrg = 1.0 / (7 * float(np.max(prob.L)))
    conv = {
        "saga": ("TPSAGA", dict(maxit=3000, batch=16), ONE),
        "saga_int8": ("TPSAGA", dict(maxit=3000, batch=16), ONE),
        "finito1": ("TPFinito", dict(maxit=800, batch=16, sweeping=1), ONE),
        "finito2": ("TPFinito", dict(maxit=800, batch=16, sweeping=2), ONE),
        "finito3": ("TPFinito", dict(maxit=800, batch=16, sweeping=3), ONE),
        "lfinito2": ("TPLFinito", dict(maxit=200, batch=16, sweeping=2), ONE),
        "lfinito3": ("TPLFinito", dict(maxit=200, batch=16, sweeping=3), ONE),
        # JAX's budgets are 500 and 16 outer steps; 100 and 13 reach the
        # bar here, and SVRG++'s last three would be 57,344 eager steps
        "svrg": ("TPSVRG", dict(maxit=100, batch=16, m=N, gamma=gam_svrg),
                 ONE),
        "svrg_plus": ("TPSVRG", dict(maxit=13, batch=16, m=2, plus=True),
                      ONE),
        "vec_lam": ("TPSAGA", dict(maxit=500, batch=32), PAIR),
        "scalar_lam": ("TPSAGA", dict(maxit=500, batch=32), PAIR),
        "fista_pair": ("TPFISTA", dict(maxit=200), PAIR),
    }
    for name, (cls, kw, where) in conv.items():
        c = dict(base, fn="tp_facade", cls=cls, kw=kw, **where)
        if name == "saga_int8":
            c = dict(_base(prob, storage="int8"), fn="tp_facade", cls=cls,
                     kw=kw, **where)
        if name == "vec_lam":
            c["prox"] = {"kind": "l1", "lam": np.full(n, float(prob.lam))}
        cases["conv_" + name] = c
    pc = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    cases["conv_complex"] = dict(_base(pc, np.complex128), fn="tp_facade",
                                 cls="TPSAGA", kw=dict(maxit=3000, batch=32),
                                 **PAIR)
    for cls in ("TPSAGA", "TPFinito", "TPSVRG"):
        cases["iter_" + cls] = dict(base, fn="tp_facade", cls=cls, take=1,
                                    kw=dict(batch=4, m=N) if cls == "TPSVRG"
                                    else dict(batch=4), shard=True, **PAIR)
    cases["iter_TPLFinito"] = dict(base, fn="tp_facade", cls="TPLFinito",
                                   take=2, kw=dict(batch=4, sweeping=2),
                                   **PAIR)
    l2 = {"kind": "l2", "lam": 1.0}
    sh = _sharing()
    cases["errors"] = dict(base, fn="tp_errors", cls="TPSAGA", **PAIR, calls=[
        dict(prox=l2), dict(cls="TPFinito", prox=l2),
        dict(cls="TPLFinito", prox=l2), dict(cls="TPFISTA", prox=l2),
        dict(cls="TPSVRG", prox=l2),
        dict(kw=dict(batch=5)), dict(oracle=dict(base["oracle"],
                                                 A=prob.A[:, :7]),
                                     x0=np.zeros(7)),
        dict(oracle={"kind": "ell", "A": np.where(
            np.abs(prob.A) < 1.2, 0.0, prob.A), "b": prob.b,
            "scale": float(N)}, kw=dict(batch=4)),
        dict(cls="TPForwardBackward", kw=dict(maxit=2, polish_chunk=77)),
        dict(cls="TPForwardBackward", kw=dict(maxit=2, polish_chunk=16),
             oracle=dict(base["oracle"], storage="int8")),
        dict(cls="TPProshi", **{k: v for k, v in sh.items() if k != "prox"},
             prox=l2),
        dict(cls="TPProshi", prox=sh["prox"], L=sh["L"], N=sh["N"],
             x0=sh["x0"], oracle=_base(make_lasso(N=24, n=2, p=1, seed=0))[
                 "oracle"] | {"scale": 24.0}),
        dict(cls="TPFinito", kw=dict(sweeping=4)),
    ])
    cases["errors_mesh"] = dict(base, fn="errors", cls="TPSAGA", calls=[
        dict(kw=dict(batch=4))])
    cases["rebase_saga"] = dict(base, fn="tp_rebase", cls="TPSAGA",
                                kw=dict(maxit=3000, batch=4), steps=200,
                                **PAIR)
    cases["rebase_finito"] = dict(base, fn="tp_rebase", cls="TPFinito",
                                  kw=dict(maxit=2000, batch=4, sweeping=2),
                                  steps=100, **PAIR)
    # ProShI: (1, 2) beside DP on rank 0 alone; (4, 1) beside DP on all
    cases["proshi_sharing"] = dict(sh, fn="tp_proshi_vs_dp", dp_ranks=[0],
                                   kw=dict(maxit=10000, batch=8, sweeping=2),
                                   take=True, **PAIR)
    for sw in (1, 3):
        cases[f"proshi_sweep{sw}"] = dict(
            sh, fn="tp_facade", cls="TPProshi",
            kw=dict(maxit=10000, batch=8, sweeping=sw), **PAIR)
    cases["proshi_m1"] = dict(sh, fn="tp_proshi_vs_dp", dp_ranks=[0, 1, 2, 3],
                              kw=dict(maxit=200, batch=8, sweeping=3),
                              mesh2d=(WORLD, 1))
    # deep_solve_tp on test_deep.py's planted problem (2,048 x 32)
    pd = _deep_prob()
    cases["deep"] = dict(_base(pd, np.float32), fn="tp_deep", N=2048,
                         polish_chunk=64, oracle=dict(
                             _base(pd, np.float32)["oracle"], scale=2048.0),
                         kw=dict(batch=32, chunk_steps=1024, max_steps=16_384,
                                 plateau_rtol=1e-4, polish_chunk=64), **PAIR)
    return cases


def _deep_prob():
    return make_lasso(N=2048, n=32, p=6, seed=0, dtype=np.float32,
                      well_conditioned=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    prob = _prob()
    lock = _lockstep(tj.mesh(D), prob)
    cases = _cases(lock, prob)
    results = tw.spawn(cases, WORLD, tmp_path_factory.mktemp("tp"))
    return lock, prob, cases, results


def _in(results, name):
    """The results of the ranks in the case's mesh (None elsewhere)."""
    return [tw.result(results, name, r) for r in range(WORLD)
            if results[r].get(name, {}) is not None]


def _jax_oracle(c):
    import jax.numpy as jnp

    from ciao_tpu.oracles import (
        DiagQuadratic, LeastSquaresRows, SqrDistBox, SumOracle,
    )

    o = c["oracle"]
    if o["kind"] == "sharing":
        return SumOracle(terms=(
            DiagQuadratic(d=jnp.asarray(o["d"]), q=jnp.asarray(o["q"])),
            SqrDistBox(lo=jnp.asarray(o["lo"]), hi=jnp.asarray(o["hi"]),
                       eta=jnp.asarray(o["eta"]), n_terms=o["n_terms"])))
    F = LeastSquaresRows(A=jnp.asarray(o["A"]), b=jnp.asarray(o["b"]),
                         scale=jnp.asarray(o["scale"]))
    return F.with_storage(o["storage"]) if o.get("storage") else F


def _jax_prox(c):
    import jax.numpy as jnp

    from ciao_tpu.prox import IndBox, NormL1

    p = c["prox"]
    if p["kind"] == "l1":
        return NormL1(lam=jnp.asarray(p["lam"]))
    return IndBox(lo=jnp.asarray(p["lo"]), hi=jnp.asarray(p["hi"]))


def _jax_state(case, cls, kw):
    import jax.numpy as jnp

    from ciao_tpu import parallel as jp

    m2 = tj.mesh2d(D, M)
    F = jp.shard_finite_sum_2d(_jax_oracle(case), m2, N=case.get("N"))
    solver = getattr(jp, cls)(mesh=m2, **kw)
    return tj.tp_run(solver, jnp.asarray(case["x0"]), F, _jax_prox(case),
                     jnp.asarray(case["L"]), case["steps"], N=case.get("N"))


LOCKSTEP = ["saga", "sag", "saga_int8", "finito1", "finito2", "finito3",
            "lfinito2", "lfinito3", "svrg", "svrg_plus", "proshi1",
            "proshi2", "ista", "fista", "fista_polish"]


@pytest.mark.parametrize("name", LOCKSTEP)
def test_tp_lockstep_matches_jax(setup, name):
    """Each family's lockstep run on the (2, 2) mesh, on JAX's draws: each
    rank's columns of the iterate and averages and its rows of the tables
    agree with JAX's global state to 1e-10 of each field's largest entry
    in f64 (int8 rows: the margins summed over "model" before the row
    scale)."""
    lock, prob, cases, results = setup
    c, cls, kw, axes = lock[name]
    ranks = _in(results, name)
    assert len(ranks) == D * M
    assert sorted((r["d"], r["m"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    tj.compare2d(ranks, _jax_state(c, cls, kw), axes)


def test_tp_stepwise_equals_run(setup):
    """``step`` one at a time and ``run`` give the same bits."""
    _, _, _, results = setup
    for a, b in zip(_in(results, "saga"), _in(results, "stepwise_saga")):
        for f in ("z", "av", "s"):
            np.testing.assert_array_equal(a[f], b[f])


def test_tp_saga_rebase_is_exact_mean(setup):
    """TPSAGA's rebase recomputes av = Σ cᵢaᵢ/N from the rows' tables,
    which the delta-maintained av matches to rounding."""
    _, prob, _, results = setup
    for a, b in zip(_in(results, "saga"), _in(results, "rebased_saga")):
        np.testing.assert_allclose(b["av"], a["av"], rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(b["z"], a["z"])


def test_tp_finito_rebase_is_exact(setup):
    _, _, _, results = setup
    for a, b in zip(_in(results, "finito3"), _in(results, "rebased_finito")):
        np.testing.assert_allclose(b["av"], a["av"], rtol=1e-10, atol=1e-12)


def test_make_mesh_2d(setup):
    """Rank r at (r // M, r % M); its data group the ranks that share m,
    its model group those that share d; rows and columns of its block."""
    _, _, _, results = setup
    for r in range(WORLD):
        mi = tw.result(results, "mesh", r)
        d, m = r // M, r % M
        assert (mi["d"], mi["m"], mi["rank"], mi["size"]) == (d, m, r, 4)
        assert mi["shape"] == {"data": D, "model": M}
        assert mi["rows"] == (d * n_loc, (d + 1) * n_loc)
        assert mi["cols"] == (m * n // M, (m + 1) * n // M)
        assert mi["device"] == "cpu"
        # ranks r + 1: the data group sums over d, the model group over m
        np.testing.assert_array_equal(
            mi["psum_d"], np.full(2, sum(dd * M + m + 1 for dd in range(D))))
        np.testing.assert_array_equal(
            mi["psum_m"], np.full(2, sum(d * M + mm + 1 for mm in range(M))))
        np.testing.assert_array_equal(mi["gather"], np.arange(1.0, M + 1))


def test_make_mesh_2d_refusals():
    import torch.distributed as dist

    from ciao_tpu_torch.parallel import make_mesh_2d

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh_2d(2, 2, device="cpu")


def test_shard_finite_sum_2d_layout(setup):
    """Rows × columns of A, rows of b, the scale whole; a vector λ cut to
    the columns; the block holds only its part and records (N, D, M,
    rank)."""
    _, prob, _, results = setup
    for lay in _in(results, "layout"):
        d, m = lay["d"], lay["m"]
        r0, c0 = d * n_loc, m * (n // M)
        assert lay["leaves"]["A"][0] == (n_loc, n // M)
        assert lay["specs"]["A"] == ("data", "model")
        assert lay["specs"]["b"] == ("data",)
        assert lay["specs"]["scale"] == ()
        np.testing.assert_array_equal(
            lay["values"]["A"], prob.A[r0:r0 + n_loc, c0:c0 + n // M])
        np.testing.assert_array_equal(lay["values"]["b"],
                                      prob.b[r0:r0 + n_loc])
        assert lay["storage"]["A"] == n_loc * (n // M) * 8
        assert lay["tp_shard"] == (N, D, M, d * M + m)
        assert lay["num_terms"] == n_loc
        assert lay["prox"]["lam"].shape == (n // M,)


def test_shard_finite_sum_2d_int8_keeps_whole_row_scales(setup):
    """int8 rows are quantized whole, before the cut: each block keeps
    its rows' whole-row scales (cut over "data" only), never a scale of
    its columns."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    _, prob, _, results = setup
    whole = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                             float(N)).with_storage("int8")
    for lay in _in(results, "layout_int8"):
        d, m = lay["d"], lay["m"]
        assert lay["specs"]["row_scale"] == ("data",)
        np.testing.assert_array_equal(
            lay["values"]["row_scale"],
            whole.row_scale[d * n_loc:(d + 1) * n_loc].numpy())
        np.testing.assert_array_equal(
            lay["values"]["A"], whole.A[d * n_loc:(d + 1) * n_loc,
                                        m * 4:(m + 1) * 4].numpy())


def test_power_lmax_tp_matches_single_card(setup):
    """The 2-D power bound equals the single-card ``power_lmax`` on the
    whole oracle: the start vector is drawn whole and cut, so the bound
    does not depend on M."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.solvers.polish import power_lmax

    _, prob, cases, results = setup
    c = cases["power"]
    F = LeastSquaresRows(torch.from_numpy(prob.A), torch.from_numpy(prob.b),
                         float(N))
    want = float(power_lmax(F, torch.from_numpy(c["x"]), 5, iters=6))
    for got in _in(results, "power"):
        assert abs(got - want) <= 1e-12 * want


def test_tp_one_rank_equals_single_device(setup):
    """A (1, 1) mesh's TPSAGA equals single-device coefficient SAGA on the
    same 40 block starts, and TPFISTA the FISTA facade, to 1e-12 in f64."""
    _, _, _, results = setup
    out = tw.result(results, "vs_single")
    for f in ("z", "av", "s"):
        assert tj.gap(out["tp"][f], out["single"][f]) <= 1e-12, f
    assert out["tp"]["it"] == out["single"]["it"] == 41
    assert tj.gap(out["fista_tp"], out["fista_single"]) <= 1e-12


def _conv(results, name, prob):
    out = tw.result(results, "conv_" + name)
    return prob.cost(out["x"]) - prob.f_star


@pytest.mark.parametrize("name", ["saga", "finito1", "finito2", "finito3",
                                  "lfinito2", "lfinito3", "svrg",
                                  "svrg_plus"])
def test_tp_converges(setup, name):
    """tests/test_parallel.py:236, 288, 918 and 951: the facades reach the
    planted optimum at the reference tolerance (on a (1, 1) mesh at JAX's
    global batch)."""
    _, prob, _, results = setup
    assert _conv(results, name, prob) < 1e-4


def test_tp_int8_converges(setup):
    """tests/test_parallel.py:474: TPSAGA on int8 rows converges to the
    reference's int8 bar."""
    _, prob, _, results = setup
    assert _conv(results, "saga_int8", prob) < 1e-3


@pytest.mark.parametrize("cls", ["TPSAGA", "TPFinito", "TPSVRG",
                                 "TPLFinito"])
def test_tp_states_are_shards(setup, cls):
    """On a (1, 2) mesh each rank's state holds its columns of the
    iterate and averages (n/2) and all rows of the tables: SAGA's and
    Finito's (N,) coefficients, Finito's (N/B, n/2) anchors and (N/B,)
    stepsize sums, LFinito's (N,) stepsizes."""
    _, _, _, results = setup
    for st in _in(results, "iter_" + cls):
        assert st["z"].shape == (n // 2,)
        assert st["av"].shape == (n // 2,)
        if cls == "TPSAGA":
            assert st["s"].shape == (N,)
        if cls == "TPFinito":
            assert st["c"].shape == (N,)
            assert st["zb"].shape == (N // 4, n // 2)
            assert st["invg"].shape == (N // 4,)
        if cls == "TPSVRG":
            assert st["z_full"].shape == (n // 2,)
        if cls == "TPLFinito":
            assert st["gamma"].shape == (N,) and st["it"] == 2


def test_tp_vector_prox_params(setup):
    """tests/test_parallel.py:1423: a vector λ cut to the columns agrees
    with the scalar λ of equal value on a (1, 2) mesh."""
    _, _, _, results = setup
    a = tw.result(results, "conv_vec_lam")["x"]
    b = tw.result(results, "conv_scalar_lam")["x"]
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(a, tw.result(results, "conv_vec_lam",
                                               1)["x"])


def test_tp_complex_dtype(setup):
    """tests/test_parallel.py:1465: complex128 rows and iterate, columns
    cut over two ranks, converge at the reference tolerance."""
    _, _, _, results = setup
    pc = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    x = tw.result(results, "conv_complex")["x"]
    assert x.dtype == np.complex128
    assert float(np.real(pc.cost(x) - pc.f_star)) < 1e-4


def test_tp_fista_matches_single_chip(setup):
    """tests/test_fb.py:106: TPFISTA with the columns cut over two ranks
    equals the single-device FISTA (deterministic), every rank the whole
    iterate."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import FISTA

    _, prob, _, results = setup
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         float(N))
    x_sc, _ = FISTA(maxit=200)(torch.zeros(n, dtype=torch.float64), F=F,
                               g=NormL1(torch.tensor(prob.lam)), L=prob.L)
    for r in (0, 1):
        np.testing.assert_allclose(
            tw.result(results, "conv_fista_pair", r)["x"], x_sc.numpy(),
            rtol=1e-9, atol=1e-12)


def test_tp_validation_errors(setup):
    """JAX's refusals, with its words: a non-separable prox, a bad batch
    or n, sparse ELL rows (TPSAGA half of tests/test_parallel.py:1442),
    FB's polish_chunk guards, ProShI's oracle and prox, a bad sweep."""
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    for k in range(5):
        assert "separable" in msgs[k], msgs[k]
    assert "divisible" in msgs[5]
    assert "divisible" in msgs[6]
    assert "DP-only" in msgs[7]
    assert "divide" in msgs[8]
    assert "int8" in msgs[9]
    assert "separable" in msgs[10]
    assert "coordinate-separable" in msgs[11]
    assert "sweeping" in msgs[12]


def test_tp_refuses_a_1d_mesh(setup):
    _, _, _, results = setup
    msg = tw.result(results, "errors_mesh")[0]
    assert "needs a ('data','model') mesh (make_mesh_2d)" in msg


def test_tp_saga_rebase_after_int8(setup):
    """tests/test_parallel.py:474: 200 states on int8 rows, resumed under
    f32 rows with ``rebase=True``: av equals the f32 rows' Σ cᵢaᵢ/N."""
    _, _, _, results = setup
    for r in (0, 1):
        out = tw.result(results, "rebase_saga", r)
        np.testing.assert_allclose(out["first"]["av"], out["apply"] / N,
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(out["first"]["s"], out["int8"]["s"])


def test_tp_finito_rebase_after_int8(setup):
    """av = hat·(invg·zb − Σ cᵢaᵢ/N) on the rank's columns after the f32
    rebase of an int8 TPFinito state."""
    _, _, _, results = setup
    for r in (0, 1):
        out = tw.result(results, "rebase_finito", r)
        q = out["int8"]
        want = q["hat_gamma"] * (q["invg"] @ q["zb"] - out["apply"] / N)
        np.testing.assert_allclose(out["first"]["av"], want, rtol=1e-10,
                                   atol=1e-12)


def test_tp_proshi_matches_dp_and_shards(setup):
    """tests/test_parallel.py:1348 on a (1, 2) mesh: the block table cut
    over the columns, the same trajectory as DPProshi to 1e-12 over
    10,000 steps, the coupling constraint held; the first state's table
    is the rank's columns and av its exact column sum."""
    _, _, cases, results = setup
    sh = cases["proshi_sharing"]
    Nb, nb = sh["N"], sh["x0"].shape[0]
    dp = tw.result(results, "proshi_sharing")["dp"]
    for r in (0, 1):
        out = tw.result(results, "proshi_sharing", r)
        assert out["tp"].shape == (Nb, nb)
        np.testing.assert_allclose(out["tp"], dp, rtol=1e-12, atol=1e-12)
        assert np.all(out["tp"].sum(axis=0) <= 1.0 + 1e-6)
        st = out["first"]
        assert st["s"].shape == (Nb, nb // 2) and st["z"].shape == (1,)
        assert st["gamma"].shape == (Nb,)
        np.testing.assert_allclose(st["av"], st["s"].sum(axis=0),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sweeping", [1, 3])
def test_tp_proshi_random_and_shuffled_converge(setup, sweeping):
    """tests/test_parallel.py:1386: the random and shuffled sweeps reach
    the cyclic sweep's coupling sums."""
    _, _, _, results = setup
    x = tw.result(results, f"proshi_sweep{sweeping}")["x"]
    x_cyc = tw.result(results, "proshi_sharing")["tp"]
    np.testing.assert_allclose(x.sum(axis=0), x_cyc.sum(axis=0), atol=2e-2)


def test_tp_proshi_at_one_model_rank_equals_dp(setup):
    """At M = 1 the TP schedule folds the data row as DP folds the rank:
    TPProshi on a (4, 1) mesh equals DPProshi on the four ranks to
    1e-12, each rank's blocks."""
    _, _, _, results = setup
    for r in range(WORLD):
        out = tw.result(results, "proshi_m1", r)
        np.testing.assert_allclose(out["tp"], out["dp"], rtol=1e-12,
                                   atol=1e-12)


def test_deep_solve_tp_reaches_rel_1e6_on_2d_mesh(setup):
    """tests/test_deep.py:390 on a (1, 2) mesh: TPSAGA to the plateau,
    the 2-D power bound, the TP-FISTA polish with compensated chunks:
    rel ≤ 1e-6 in f32, the same whole x on both ranks; the polish path
    equals plain TP FISTA within f32 noise."""
    pd = _deep_prob()
    _, _, _, results = setup
    outs = [tw.result(results, "deep", r) for r in (0, 1)]
    np.testing.assert_array_equal(outs[0]["x"], outs[1]["x"])
    rel = (pd.cost(outs[0]["x"]) - pd.f_star) / abs(pd.f_star)
    assert rel <= 1e-6, rel
    assert outs[0]["lmax"] > 0 and outs[0]["polish_steps"] > 0
    np.testing.assert_allclose(outs[0]["polish"], outs[0]["fista"],
                               rtol=1e-4, atol=1e-5)
