"""The port's data-parallel mesh, SAGA/SAG, SVRG/SVRG++, FB/FISTA and
``deep_solve_dp`` against the JAX package, on four gloo ranks.

The port's ranks run in four processes spawned once for the module
(``tests/torch_parallel_worker.py``, which imports no JAX); JAX runs the
same configurations under ``shard_map`` on the first four devices of the
8-device CPU mesh. Both take the same numpy data, and the port's ranks
take each device's schedule as JAX draws it (``tests/
torch_parallel_jax.py``), so the f64 states agree to 1e-10 of each
field's largest entry: the replicated vectors (z, av, ...) on every rank,
the tables on each rank's rows. The largest gap reached is below 1e-13.
The facades' convergence runs use the port's own draws, as
``tests/test_parallel.py`` does JAX's.
"""

import numpy as np
import pytest
import torch

import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu.parallel import dp as jdp
from ciao_tpu.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

D = 4
N, n = 64, 8
n_loc = N // D
SEED = 3


def _prob():
    return make_lasso(N=N, n=n, p=3, seed=3)


def _base(prob, dtype=np.float64):
    return dict(oracle={"kind": "lsq", "A": prob.A.astype(dtype),
                        "b": prob.b.astype(dtype), "scale": float(N)},
                prox={"kind": "l1", "lam": float(prob.lam)},
                L=prob.L, x0=np.zeros(prob.A.shape[1], dtype))


def _cfg(**kw):
    return dict(dict(N=N, D=D, b_loc=4, sweeping=1, alpha=0.999), **kw)


SAGA_CASES = {
    "block_coeff": dict(block=True, coeff=True),
    "block_full": dict(block=True, coeff=False),
    "iid": dict(),
    "sag_block": dict(block=True, coeff=True, sag=True),
}
SVRG_CASES = {
    "lockstep_iid": dict(b_loc=2),
    "lockstep_block": dict(block=True),
    "local_block": dict(block=True, local=True),
    "local_iid": dict(b_loc=2, local=True),
}
FB_CASES = {"ista": dict(variant="ista"), "fista": dict(variant="fista"),
            "polish": dict(variant="fista", polish_chunk=4)}
SAGA_STEPS, ROUNDS, K_LOC, SVRG_OUTER, M_INNER, FB_STEPS = 30, 3, 4, 3, 8, 20


def _gamma_saga(prob, sag=False):
    return 1.0 / ((16.0 if sag else 3.0) * float(np.max(prob.L)))


def _cases(m, prob):
    base = _base(prob)
    cases = {}
    for name, kw in SAGA_CASES.items():
        cfg = _cfg(**kw)
        c = dict(base, fn="build", family="saga", cfg=cfg,
                 gamma=_gamma_saga(prob, kw.get("sag", False)), seed=SEED,
                 steps=SAGA_STEPS)
        if kw.get("block"):
            c["starts"] = tj.block_starts(m, SEED, SAGA_STEPS, n_loc, 4, 1)
        else:
            c["idx"] = tj.indices(m, SEED, SAGA_STEPS, n_loc, 4, 1)
        cases["saga_" + name] = c
    cases["saga_local"] = dict(
        base, fn="build", family="saga", gamma=_gamma_saga(prob),
        cfg=_cfg(block=True, coeff=True, local_steps=K_LOC, rebase_every=2),
        seed=SEED, steps=ROUNDS,
        starts=tj.rounds(m, SEED, ROUNDS, K_LOC, n_loc, 4, 1))
    gam_svrg = 1.0 / (7 * float(np.max(prob.L)))
    for name, kw in SVRG_CASES.items():
        cfg = _cfg(**kw)
        c = dict(base, fn="build", family="svrg", cfg=cfg, gamma=gam_svrg,
                 seed=SEED, steps=SVRG_OUTER, extra=(M_INNER,))
        if kw.get("block"):
            c["starts"] = tj.svrg_starts(m, SEED, SVRG_OUTER, M_INNER, n_loc,
                                         cfg["b_loc"])
        else:
            c["idx"] = tj.svrg_rows(m, SEED, SVRG_OUTER, M_INNER, n_loc,
                                    cfg["b_loc"])
        cases["svrg_" + name] = c
    cases["svrg_plus_local"] = dict(
        base, fn="build", family="svrg", gamma=gam_svrg, seed=SEED,
        cfg=_cfg(block=True, local=True, plus=True), steps=SVRG_OUTER,
        extra=(2,), starts=tj.svrg_plus_starts(m, SEED, SVRG_OUTER, 2, n_loc,
                                               4))
    for name, kw in FB_CASES.items():
        cases["fb_" + name] = dict(
            base, fn="build", family="fb", cfg=_cfg(b_loc=1, **kw),
            gamma=1.0 / float(np.mean(prob.L)), steps=FB_STEPS)
    # the kernel paths (plain versions on CPU tensors) against the
    # stepwise ones, f32, shards of 256 rows
    p32 = make_lasso(N=1024, n=32, p=4, seed=5, dtype=np.float32,
                     well_conditioned=True)
    b32 = dict(_base(p32, np.float32))
    for fused in (False, True):
        cases[f"saga_round_fused{fused}"] = dict(
            b32, fn="build", family="saga", steps=3,
            gamma=np.float32(_gamma_saga(p32)),
            cfg=dict(N=1024, D=D, b_loc=16, sweeping=1, alpha=0.999,
                     block=True, coeff=True, local_steps=8, fused=fused,
                     rebase_every=2))
        for plus, m0 in ((False, 70), (True, 40)):
            cases[f"svrg_fused{fused}_plus{plus}"] = dict(
                b32, fn="build", family="svrg", steps=3, extra=(m0,),
                gamma=np.float32(1.0 / (10 * float(np.max(p32.L)))),
                cfg=dict(N=1024, D=D, b_loc=16, sweeping=1, alpha=0.999,
                         block=True, coeff=True, local=True, plus=plus,
                         fused=fused))
    # facades on the port's own draws
    conv = {"saga": ("DPSAGA", dict(maxit=1300, batch=8)),
            "saga_coeff": ("DPSAGA", dict(maxit=1300, batch=8,
                                          block_sampling=True)),
            "svrg_local": ("DPSVRG", dict(
                maxit=150, batch=8, m=N, local_inner=True,
                gamma=1.0 / (7 * float(np.max(prob.L))))),
            "fista": ("DPFISTA", dict(maxit=300)),
            "saga_seed7_a": ("DPSAGA", dict(maxit=100, batch=8, seed=7)),
            "saga_seed7_b": ("DPSAGA", dict(maxit=100, batch=8, seed=7))}
    for name, (cls, kw) in conv.items():
        cases["conv_" + name] = dict(base, fn="facade", cls=cls, kw=kw)
    gam_i = 0.999 * N / prob.L
    for name, fam, kw, gam in (
            ("saga", "saga", dict(block=True, coeff=True), _gamma_saga(prob)),
            ("saga_rounds", "saga",
             dict(block=True, coeff=True, local_steps=K_LOC),
             _gamma_saga(prob)),
            ("finito", "finito", dict(sweeping=3), gam_i),
            ("coeff_rounds", "finito_coeff", dict(sweeping=3, coeff=True,
                                                  local_steps=K_LOC), gam_i)):
        cases["runstep_" + name] = dict(base, fn="run_vs_step", family=fam,
                                        cfg=_cfg(**kw), gamma=gam, seed=SEED,
                                        steps=9)
    cases["iter"] = dict(base, fn="facade", cls="DPFinito",
                         kw=dict(batch=8, maxit=50), take=5)
    cases["errors"] = dict(base, fn="errors", cls="DPFinito", calls=[
        dict(N=63, shard=False), dict(kw=dict(batch=6)),
        dict(cls="DPSAGA", kw=dict(maxit=10, batch=16, local_steps=4)),
        dict(cls="DPSAGA", kw=dict(batch=8, table="coeff")),
        dict(cls="DPForwardBackward", kw=dict(polish_chunk=5))])
    cases["layout"] = dict(base, fn="layout", values=("A", "b"))
    cases["mesh"] = dict(fn="mesh_info")
    cases["sched"] = dict(fn="schedules", seed=11, it0=5, n_loc=64, B=8,
                          K=20)
    # deep_solve_dp on test_deep.py's planted problem, and its power bound
    pd = make_lasso(N=2048, n=32, p=6, seed=0, dtype=np.float32,
                    well_conditioned=True)
    cases["deep"] = dict(
        _base(pd, np.float32), fn="deep", N=2048,
        oracle=dict(_base(pd, np.float32)["oracle"], scale=2048.0),
        kw=dict(batch=256, local_steps=8, chunk_rounds=16, max_rounds=256,
                plateau_rtol=1e-4))
    cases["power"] = dict(base, fn="power", N=N, seed=5, iters=6,
                          x=np.linspace(-1, 1, n))
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    m = tj.mesh(D)
    prob = _prob()
    cases = _cases(m, prob)
    results = tw.spawn(cases, D, tmp_path_factory.mktemp("dp"))
    return m, prob, cases, results


def _ranks(results, name):
    return [tw.result(results, name, r) for r in range(D)]


def _jax_problem(m, case):
    o = case["oracle"]
    F = tj.lsq(o["A"], o["b"], o["scale"], m)
    return F, tj.l1(case["prox"]["lam"])


@pytest.mark.parametrize("name", list(SAGA_CASES))
def test_dp_saga_step_matches_jax(setup, name):
    """Lockstep DP SAGA/SAG (block coefficients, block full table, iid
    rows, SAG) on JAX's schedule: z, av and every rank's table rows."""
    m, prob, cases, results = setup
    c = cases["saga_" + name]
    F, g = _jax_problem(m, c)
    cfg = jdp.DPCfg(**c["cfg"])
    jst = tj.run(m, "saga", F, g, cfg, np.zeros(n), np.float64(c["gamma"]),
                 SEED, SAGA_STEPS)
    tj.compare(_ranks(results, "saga_" + name), jst, local=("s",))


def test_dp_saga_local_round_matches_jax(setup):
    """Local-update rounds (K = 4, rebase every 2nd round, so round 2
    takes the exact recompute and rounds 1, 3 the delta resync)."""
    m, prob, cases, results = setup
    c = cases["saga_local"]
    F, g = _jax_problem(m, c)
    jst = tj.run(m, "saga", F, g, jdp.DPCfg(**c["cfg"]), np.zeros(n),
                 np.float64(c["gamma"]), SEED, ROUNDS)
    tj.compare(_ranks(results, "saga_local"), jst, local=("s",))


@pytest.mark.parametrize("name", list(SVRG_CASES))
def test_dp_svrg_matches_jax(setup, name):
    """DP SVRG, lockstep and local-inner, block and iid inner steps, on
    JAX's inner schedules: z_full, w, av after three outer steps."""
    m, prob, cases, results = setup
    c = cases["svrg_" + name]
    F, g = _jax_problem(m, c)
    jst = tj.run(m, "svrg", F, g, jdp.DPCfg(**c["cfg"]), np.zeros(n),
                 np.float64(c["gamma"]), SEED, SVRG_OUTER,
                 extra=(np.int32(M_INNER),))
    tj.compare(_ranks(results, "svrg_" + name), jst)


def test_dp_svrg_plus_local_matches_jax(setup):
    """SVRG++ local inner loops (m = 2, 4, 8) and the averaged warm
    start."""
    m, prob, cases, results = setup
    c = cases["svrg_plus_local"]
    F, g = _jax_problem(m, c)
    jst = tj.run(m, "svrg", F, g, jdp.DPCfg(**c["cfg"]), np.zeros(n),
                 np.float64(c["gamma"]), SEED, SVRG_OUTER,
                 extra=(np.int32(2),))
    ranks = _ranks(results, "svrg_plus_local")
    assert all(r["m"] == 16 for r in ranks)
    tj.compare(ranks, jst)


@pytest.mark.parametrize("name", list(FB_CASES))
def test_dp_fb_matches_jax(setup, name):
    """DP ISTA, FISTA and the compensated-chunk FISTA of the polish."""
    m, prob, cases, results = setup
    c = cases["fb_" + name]
    F, g = _jax_problem(m, c)
    jst = tj.run(m, "fb", F, g, jdp.DPCfg(**c["cfg"]), np.zeros(n),
                 np.float64(c["gamma"]), 0, FB_STEPS)
    tj.compare(_ranks(results, "fb_" + name), jst)


def test_dp_saga_local_round_fused_matches_stepwise(setup):
    """The round on kernel #3's path (its plain version on CPU tensors)
    against the stepwise round, f32, on the same draws: JAX's bounds
    (z rtol 2e-5, atol 1e-6; s rtol 2e-4, atol 1e-2)."""
    _, _, _, results = setup
    for r in range(D):
        a = tw.result(results, "saga_round_fusedFalse", r)
        b = tw.result(results, "saga_round_fusedTrue", r)
        np.testing.assert_allclose(b["z"], a["z"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["av"], a["av"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["s"], a["s"], rtol=2e-4, atol=1e-2)
        assert b["it"] == a["it"] == 1 + 3 * 8


@pytest.mark.parametrize("plus", [False, True])
def test_dp_svrg_local_fused_matches_stepwise(setup, plus):
    """The local inner loop on kernel #5's path (``svrg_inner_chunked``:
    launches of min(64, m) steps and a stepwise remainder; SVRG++'s m =
    40, 80, 160 gives one 40-step launch, then remainders of 16 and 32)
    and the anchor on #6's, against the stepwise loop, f32."""
    _, _, _, results = setup
    for r in range(D):
        a = tw.result(results, f"svrg_fusedFalse_plus{plus}", r)
        b = tw.result(results, f"svrg_fusedTrue_plus{plus}", r)
        for f in ("z_full", "w", "av"):
            np.testing.assert_allclose(b[f], a[f], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["canch"], a["canch"], rtol=2e-4,
                                   atol=1e-3)
        assert b["m"] == a["m"]


@pytest.mark.parametrize("name", ["saga", "saga_coeff", "svrg_local",
                                  "fista"])
def test_dp_converges(setup, name):
    """The facades on the port's own draws reach the planted optimum at
    the reference tolerance (tests/test_parallel.py:67-118, 769; the
    lockstep SVRG's one all-reduce an inner step, SAG's 5,000 steps, and
    SVRG++'s doubling
    inner loop (2^20 steps by JAX's 20th outer step), are too long for
    eager steps on four CPU ranks: their parity above stands for
    them)."""
    _, prob, _, results = setup
    xs = [tw.result(results, "conv_" + name, r)["x"] for r in range(D)]
    for x in xs[1:]:
        np.testing.assert_array_equal(x, xs[0])
    assert prob.cost(xs[0]) - prob.f_star < 1e-4


@pytest.mark.parametrize("name", ["saga", "saga_rounds", "finito",
                                  "coeff_rounds"])
def test_dp_run_draws_equal_step_draws(setup, name):
    """A ``run`` draws its steps' block starts in one vectorized pass;
    they are the draws each ``step`` makes on its own: the same bits
    (nine steps or rounds, shuffled epochs crossing)."""
    _, _, _, results = setup
    for r in range(D):
        out = tw.result(results, "runstep_" + name, r)
        for f, v in out["run"].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, out["step"][f])
        assert out["run"]["it"] == out["step"]["it"]


def test_dp_deterministic(setup):
    """Stateless (seed, it, rank) schedules: the same seed twice gives
    the same bits."""
    _, _, _, results = setup
    for r in range(D):
        np.testing.assert_array_equal(
            tw.result(results, "conv_saga_seed7_a", r)["x"],
            tw.result(results, "conv_saga_seed7_b", r)["x"])


def test_dp_iterator_streaming(setup):
    _, _, _, results = setup
    st = tw.result(results, "iter")
    assert st["n_states"] == 5 and st["it"] == 5
    assert st["s"].shape == (n_loc, n) and st["gamma"].shape == (n_loc,)


def test_dp_validation_errors(setup):
    _, _, _, results = setup
    msgs = tw.result(results, "errors")
    assert "divide evenly" in msgs[0]
    assert "divisible by D" in msgs[1]
    assert "local_steps" in msgs[2]
    assert "requires block_sampling" in msgs[3]
    assert "polish_chunk" in msgs[4]


def test_oracle_sharding_layout(setup):
    """shard_finite_sum: A and b cut to each rank's rows, the scale
    whole; the part counts its own rows and records (N, D, rank)."""
    _, prob, _, results = setup
    for r in range(D):
        lay = tw.result(results, "layout", r)
        assert lay["leaves"]["A"][0] == (n_loc, n)
        assert lay["leaves"]["b"][0] == (n_loc,)
        assert lay["leaves"]["scale"][0] == ()
        assert lay["specs"]["A"] == ("data", None)
        assert lay["specs"]["scale"] == ()
        assert lay["dp_shard"] == (N, D, r) and lay["num_terms"] == n_loc
        np.testing.assert_array_equal(lay["values"]["A"],
                                      prob.A[r * n_loc:(r + 1) * n_loc])


def test_oracle_part_holds_only_its_rows(setup):
    """The cut leaves are copies of the rank's rows, not views of the
    whole matrix: the storage behind A and b holds n_loc rows."""
    _, prob, _, results = setup
    for r in range(D):
        lay = tw.result(results, "layout", r)
        assert lay["storage"]["A"] == n_loc * n * prob.A.itemsize
        assert lay["storage"]["b"] == n_loc * prob.b.itemsize


def test_placement_off_the_data_axis_raises():
    """A placement naming an axis the 1-D data mesh lacks raises, as
    JAX's NamedSharding does, instead of leaving the leaf whole."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.parallel import shard_finite_sum
    from ciao_tpu_torch.parallel.mesh import Mesh

    prob = _prob()
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         float(N))
    mesh = Mesh(group=None, rank=1, size=D, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="names an axis"):
        shard_finite_sum(F, mesh, axis="model")
    part = shard_finite_sum(F, mesh)
    np.testing.assert_array_equal(part.A.numpy(),
                                  prob.A[n_loc:2 * n_loc])
    assert part.A.untyped_storage().nbytes() == n_loc * n * prob.A.itemsize


def test_mesh_and_collectives(setup):
    """make_mesh over the process group (n_data must be its size), and
    the all-reduce of real and complex tensors."""
    _, _, _, results = setup
    for r in range(D):
        mi = tw.result(results, "mesh", r)
        assert (mi["rank"], mi["size"], mi["device"]) == (r, D, "cpu")
        assert mi["shape"] == {"data": D}
        assert "n_data=5" in mi["n_data_error"]
        np.testing.assert_array_equal(mi["torch.float64"], np.full(3, 10.0))
        np.testing.assert_array_equal(mi["torch.complex128"],
                                      np.full(3, 10.0 + 0j))


def test_make_mesh_without_group_raises():
    import torch.distributed as dist

    from ciao_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def test_schedules_rank_folded(setup):
    """The port's own draws: a round's vectorized starts equal the
    step-by-step ones, cyclic walks the blocks in order, the shuffled
    epochs are permutations, the ranks draw differently, and random
    rows are distinct and in range."""
    _, _, cases, results = setup
    sp = cases["sched"]
    d = sp["n_loc"] // sp["B"]
    outs = [tw.result(results, "sched", r) for r in range(D)]
    for o in outs:
        for sw in (1, 2, 3):
            np.testing.assert_array_equal(o[f"round{sw}"], o[f"single{sw}"])
            assert np.all(o[f"round{sw}"] % sp["B"] == 0)
        its = np.arange(sp["it0"], sp["it0"] + sp["K"])
        np.testing.assert_array_equal(o["round2"], ((its - 1) % d) * sp["B"])
        ep = (its - 1) // d
        for e in np.unique(ep):
            if np.sum(ep == e) == d:
                blocks = o["round3"][ep == e] // sp["B"]
                assert sorted(blocks) == list(range(d))
        assert len(set(o["idx1"].tolist())) == sp["B"]
        assert o["idx1"].min() >= 0 and o["idx1"].max() < sp["n_loc"]
    assert not np.array_equal(outs[0]["round1"], outs[1]["round1"])
    assert not np.array_equal(outs[0]["round3"], outs[1]["round3"])
    np.testing.assert_array_equal(outs[0]["round2"], outs[1]["round2"])


def test_deep_solve_dp_reaches_rel_1e6(setup):
    """deep_solve_dp (tests/test_deep.py:269): local-update DPSAGA to the
    plateau, the power bound with its all-reduce, the compensated DP
    polish: rel ≤ 1e-6, the same x on every rank."""
    _, _, _, results = setup
    pd = make_lasso(N=2048, n=32, p=6, seed=0, dtype=np.float32,
                    well_conditioned=True)
    outs = [tw.result(results, "deep", r) for r in range(D)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["x"], outs[0]["x"])
    rel = (pd.cost(outs[0]["x"]) - pd.f_star) / abs(pd.f_star)
    assert rel <= 1e-6, rel
    assert outs[0]["lmax"] > 0 and outs[0]["polish_steps"] > 0


def test_power_lmax_dp_matches_single_card(setup):
    """The DP power bound equals the single-card ``power_lmax`` on the
    whole oracle (same start vector; sums in other orders)."""
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.solvers.polish import power_lmax

    _, prob, cases, results = setup
    c = cases["power"]
    F = LeastSquaresRows(torch.from_numpy(prob.A), torch.from_numpy(prob.b),
                         float(N))
    want = float(power_lmax(F, torch.from_numpy(c["x"]), 5, iters=6))
    for r in range(D):
        assert abs(tw.result(results, "power", r) - want) <= 1e-12 * want
