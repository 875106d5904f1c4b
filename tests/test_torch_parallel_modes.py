"""The port's data-parallel paths on other rows and dtypes, their
repeatability across process launches, and the pieces they share with
the single-card path, against the JAX package on the CPU.

bf16 rows, the sparse ELL and hybrid rows against dense rows, the
storage-switch rebase, complex128 iterates, Huber rows (with the clip
active in the kernel path's plain version), the two-launch bit-exactness
of ``tests/test_multihost.py`` (four gloo ranks started two ways give the
same bits), a D = 1 local round against the single-card coefficient SAGA
on the same starts, ``svrg_inner_chunked`` against JAX's (the Pallas
kernel in interpret mode), and the hybrid rows' ``dp_replicated``. The
rank processes import no JAX (``tests/torch_parallel_worker.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_parallel_jax as tj
import torch_parallel_worker as tw
from ciao_tpu.oracles import HuberRows as JHuberRows
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.parallel import dp as jdp
from ciao_tpu.parallel import shard_finite_sum
from ciao_tpu.utils.problems import make_lasso
from torch_threads import one_torch_thread  # noqa: F401

D = 4
N, n = 64, 8
n_loc = N // D
SEED = 3


def _base(A, b, lam, L, dtype=np.float64, scale=None, kind="lsq", **extra):
    return dict(oracle=dict({"kind": kind, "A": np.asarray(A).astype(dtype),
                             "b": np.asarray(b).astype(dtype),
                             "scale": float(scale or A.shape[0])}, **extra),
                prox={"kind": "l1", "lam": float(lam)}, L=np.asarray(L),
                x0=np.zeros(A.shape[1], dtype))


def _sparse_problem():
    """tests/test_parallel.py:354's 128 x 32 rows: three popular columns
    and a few more a row."""
    rng = np.random.default_rng(11)
    Np, npx = 128, 32
    A = np.zeros((Np, npx))
    hot = [3, 9, 20]
    for c in hot:
        msk = rng.random(Np) < 0.9
        A[msk, c] = rng.standard_normal(msk.sum())
    cold = np.setdiff1d(np.arange(npx), hot)
    for i in range(Np):
        cs = rng.choice(cold, size=rng.integers(1, 5), replace=False)
        A[i, cs] = rng.standard_normal(len(cs))
    b = A @ rng.standard_normal(npx)
    return A, b, (A ** 2).sum(axis=1) * Np


def _sparse_small():
    """tests/test_parallel.py:406's 64 x 16 rows with one hot column."""
    rng = np.random.default_rng(13)
    A = rng.standard_normal((64, 16)) * (rng.random((64, 16)) < 0.3)
    A[:, 2] = rng.standard_normal(64)
    b = A @ rng.standard_normal(16)
    return A, b, (A ** 2).sum(axis=1) * 64


def _huber(Np, npx, seed, delta, dtype=np.float64):
    prob = make_lasso(N=Np, n=npx, p=4, seed=seed, dtype=np.float32)
    return _base(prob.A, prob.b, prob.lam, prob.L, dtype, kind="huber",
                 delta=delta)


def _cases(m):
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    base = _base(prob.A, prob.b, prob.lam, prob.L)
    cases = {}
    p32 = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.float32,
                     well_conditioned=True)
    bf = _base(p32.A, p32.b, p32.lam, p32.L, np.float32, storage="bf16")
    cases["bf16"] = dict(bf, fn="facade", cls="DPSAGA",
                         kw=dict(maxit=1300, batch=8))
    cases["bf16_layout"] = dict(bf, fn="layout")
    A, b, L = _sparse_problem()
    for kind in ("lsq", "ell", "hybrid"):
        sp = _base(A, b, 0.02, L, kind=kind, D=3)
        cases[f"sparse_saga_{kind}"] = dict(
            sp, fn="facade", cls="DPSAGA",
            kw=dict(maxit=300, batch=16, block_sampling=True))
        cases[f"sparse_finito_{kind}"] = dict(
            sp, fn="facade", cls="DPFinito",
            kw=dict(maxit=300, batch=16, sweeping=3))
    cases["hybrid_layout"] = dict(_base(A, b, 0.02, L, kind="hybrid", D=3),
                                  fn="layout")
    A2, b2, L2 = _sparse_small()
    for kind in ("lsq", "hybrid"):
        sp = _base(A2, b2, 0.02, L2, kind=kind, D=1)
        cases[f"sparse_lfinito_{kind}"] = dict(
            sp, fn="facade", cls="DPFinito",
            kw=dict(maxit=20, batch=8, LFinito=True, sweeping=2))
        cases[f"sparse_svrg_{kind}"] = dict(
            sp, fn="facade", cls="DPSVRG", kw=dict(maxit=5, batch=8, m=4))
    cases["rebase_saga"] = dict(
        base, fn="rebase_resume", cls="DPSAGA", steps=300, more=1000,
        kw=dict(batch=16, block_sampling=True, table="coeff", seed=3))
    cases["rebase_finito"] = dict(
        base, fn="rebase_resume", cls="DPFinito", steps=200,
        kw=dict(batch=16, sweeping=2, table="coeff", seed=3))
    pc = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    cb = _base(pc.A, pc.b, pc.lam, pc.L, np.complex128)
    cases["complex_finito"] = dict(cb, fn="facade", cls="DPFinito",
                                   kw=dict(maxit=600, batch=16, sweeping=2))
    cases["complex_svrg"] = dict(
        cb, fn="facade", cls="DPSVRG",
        kw=dict(maxit=150, batch=8, m=N, local_inner=True,
                gamma=1.0 / (7 * float(np.max(pc.L)))))
    cases["complex_coeff_parity"] = dict(
        cb, fn="build", family="finito_coeff", seed=SEED, steps=30,
        gamma=0.999 * N / pc.L,
        cfg=dict(N=N, D=D, b_loc=4, sweeping=2, alpha=0.999, coeff=True),
        starts=tj.block_starts(m, SEED, 30, n_loc, 4, 2))
    hub = _huber(N, n, 5, 0.5)
    cases["huber_parity"] = dict(
        hub, fn="build", family="saga", seed=SEED, steps=30,
        gamma=1.0 / (3.0 * float(np.max(hub["L"]))),
        cfg=dict(N=N, D=D, b_loc=4, sweeping=1, alpha=0.999, block=True,
                 coeff=True),
        starts=tj.block_starts(m, SEED, 30, n_loc, 4, 1))
    hf = _huber(1024, 32, 5, 0.02, np.float32)
    for fused in (False, True):
        cases[f"huber_round_fused{fused}"] = dict(
            hf, fn="build", family="saga", seed=SEED, steps=3,
            gamma=np.float32(1.0 / (3.0 * float(np.max(hf["L"])))),
            cfg=dict(N=1024, D=D, b_loc=16, sweeping=1, alpha=0.999,
                     block=True, coeff=True, local_steps=4, fused=fused))
    mh = make_lasso(N=16 * D, n=32, p=4, seed=0)
    mb = _base(mh.A, mh.b, mh.lam, mh.L)
    cases["launch_lockstep"] = dict(
        mb, fn="facade", cls="DPSAGA",
        kw=dict(batch=D, block_sampling=True, maxit=400))
    cases["launch_local"] = dict(
        mb, fn="facade", cls="DPSAGA",
        kw=dict(batch=D, block_sampling=True, local_steps=8,
                rebase_every=16, maxit=50))
    return cases


LAUNCH = ("launch_lockstep", "launch_local")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    m = tj.mesh(D)
    cases = _cases(m)
    results = tw.spawn(cases, D, tmp_path_factory.mktemp("modes"))
    again = tw.spawn({k: cases[k] for k in LAUNCH}, D,
                     tmp_path_factory.mktemp("modes_again"), reverse=True)
    return m, cases, results, again


def _x(results, name, r=0):
    return tw.result(results, name, r)["x"]


def test_dp_saga_bf16_storage(setup):
    """bf16 rows shard and solve through the DP path; the iterate stays
    f32 and reaches the bf16 gradient-resolution floor
    (tests/test_parallel.py:328)."""
    _, cases, results, _ = setup
    p32 = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.float32,
                     well_conditioned=True)
    x = _x(results, "bf16")
    assert x.dtype == np.float32
    rel = (p32.cost(x.astype(np.float64)) - p32.f_star) / abs(p32.f_star)
    assert rel < 2e-2, rel
    lay = tw.result(results, "bf16_layout")
    assert lay["leaves"]["A"] == ((n_loc, n), "torch.bfloat16")


@pytest.mark.parametrize("family", ["saga", "finito"])
def test_dp_sparse_matches_dense(setup, family):
    """ELL and hybrid rows take DP SAGA and DP Finito down the dense
    rows' trajectory (tests/test_parallel.py:354)."""
    _, _, results, _ = setup
    for r in range(D):
        dense = _x(results, f"sparse_{family}_lsq", r)
        for kind in ("ell", "hybrid"):
            np.testing.assert_allclose(_x(results, f"sparse_{family}_{kind}",
                                          r), dense, rtol=1e-9, atol=1e-9)


def test_dp_hybrid_hot_columns_stay_whole(setup):
    """N = 128 = the hybrid's hot width: ``dp_replicated`` keeps
    ``hot_cols`` (and its int64 copy) whole on every rank while the hot
    block and the ELL tail are cut, as JAX's ``data_specs`` does."""
    _, _, results, _ = setup
    for r in range(D):
        lay = tw.result(results, "hybrid_layout", r)
        assert lay["leaves"]["hot_cols"][0] == (128,)
        assert lay["leaves"]["_hot64"][0] == (128,)
        assert lay["leaves"]["A_hot"][0] == (32, 128)
        assert lay["leaves"]["idx"][0][0] == 32
        assert lay["specs"]["hot_cols"] == ()
        assert lay["specs"]["A_hot"] == ("data", None)


def test_hybrid_logistic_declares_dp_replicated():
    """Both hybrids carry JAX's ``dp_replicated`` (ciao_tpu/oracles/
    sparse.py:232,615)."""
    from ciao_tpu_torch.oracles import HybridSparseLogistic
    from ciao_tpu_torch.parallel import data_specs

    rng = np.random.default_rng(3)
    A = rng.standard_normal((128, 16)) * (rng.random((128, 16)) < 0.3)
    y = np.sign(rng.standard_normal(128))
    F = HybridSparseLogistic.from_dense(A, y, D=2, device="cpu")
    assert F.hot_width == 128
    specs = data_specs(F, 128)
    assert specs["hot_cols"] == () and specs["_hot64"] == ()
    assert specs["A_hot"] == ("data", None) and specs["b"] == ("data",)


@pytest.mark.parametrize("family", ["lfinito", "svrg"])
def test_dp_sparse_full_passes_match_dense(setup, family):
    """The full-pass families (LFinito epochs, SVRG anchors) on the
    hybrid rows equal the dense rows' (tests/test_parallel.py:406)."""
    _, _, results, _ = setup
    for r in range(D):
        np.testing.assert_allclose(
            _x(results, f"sparse_{family}_hybrid", r),
            _x(results, f"sparse_{family}_lsq", r), rtol=1e-9, atol=1e-9)


def test_dp_rebase_storage_switch(setup):
    """The int8 stage's state resumed under f32 rows with rebase=True:
    av recomputed from the coefficient shards (one apply, one
    all-reduce), then the run reaches the reference tolerance; the same
    identity for coefficient Finito (tests/test_parallel.py:433)."""
    _, cases, results, _ = setup
    prob = make_lasso(N=N, n=n, p=3, seed=3)
    parts = [tw.result(results, "rebase_saga", r) for r in range(D)]
    total = sum(p["apply"] for p in parts) / N
    np.testing.assert_allclose(parts[0]["first"]["av"], total, rtol=1e-10,
                               atol=1e-12)
    assert prob.cost(parts[0]["last"]["z"]) - prob.f_star < 1e-4
    parts = [tw.result(results, "rebase_finito", r) for r in range(D)]
    first = [p["first"] for p in parts]
    hat = first[0]["hat_gamma"]
    want = hat * (sum(f["invg"] @ f["zb"] for f in first)
                  - sum(p["apply"] for p in parts) / N)
    np.testing.assert_allclose(first[0]["av"], want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["complex_finito", "complex_svrg"])
def test_dp_complex_dtype(setup, name):
    """complex128 iterates through DP Finito and local-inner DP SVRG keep
    their dtype and converge (tests/test_parallel.py:1007)."""
    _, _, results, _ = setup
    pc = make_lasso(N=N, n=n, p=3, seed=3, dtype=np.complex128)
    x = _x(results, name)
    assert x.dtype == np.complex128
    assert pc.cost(x) - pc.f_star < 1e-4


def test_dp_complex_matches_jax(setup):
    """Complex coefficient Finito steps equal JAX's on its schedule."""
    m, cases, results, _ = setup
    c = cases["complex_coeff_parity"]
    o = c["oracle"]
    F = shard_finite_sum(JLeastSquaresRows(
        A=jnp.asarray(o["A"]), b=jnp.asarray(o["b"]),
        scale=jnp.asarray(float(N))), m)
    jst = tj.run(m, "finito_coeff", F, tj.l1(c["prox"]["lam"]),
                 jdp.DPCfg(**c["cfg"]), np.zeros(n, np.complex128),
                 jnp.asarray(c["gamma"]), SEED, 30)
    tj.compare([tw.result(results, "complex_coeff_parity", r)
                for r in range(D)], jst, local=("c", "zb", "invg"))


def test_dp_huber_matches_jax(setup):
    """DP SAGA on Huber rows (tests/test_parallel.py:1205) on JAX's
    schedule, the clip active on part of the rows."""
    m, cases, results, _ = setup
    c = cases["huber_parity"]
    o = c["oracle"]
    F = shard_finite_sum(JHuberRows(
        A=jnp.asarray(o["A"]), b=jnp.asarray(o["b"]),
        delta=jnp.asarray(o["delta"]), scale=jnp.asarray(float(N))), m)
    jst = tj.run(m, "saga", F, tj.l1(c["prox"]["lam"]),
                 jdp.DPCfg(**c["cfg"]), np.zeros(n), np.float64(c["gamma"]),
                 SEED, 30)
    tj.compare([tw.result(results, "huber_parity", r) for r in range(D)],
               jst, local=("s",))


def test_dp_saga_local_round_fused_huber(setup):
    """Huber rows' local round on kernel #3's path (the plain version)
    against the stepwise round, the clip active (tests/test_parallel.py:
    1779's bounds)."""
    _, _, results, _ = setup
    clipped = False
    for r in range(D):
        a = tw.result(results, "huber_round_fusedFalse", r)
        b = tw.result(results, "huber_round_fusedTrue", r)
        np.testing.assert_allclose(b["z"], a["z"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["s"], a["s"], rtol=2e-4, atol=1e-4)
        clipped |= bool(np.any(np.isclose(np.abs(a["s"]), 1024 * 0.02,
                                          rtol=1e-5)))
    assert clipped


@pytest.mark.parametrize("name", LAUNCH)
def test_dp_bits_do_not_depend_on_the_launch(setup, name):
    """tests/test_multihost.py for the port: four ranks started by
    ``torch.multiprocessing`` and four started one by one in reverse
    order give the same bits (lockstep and local-round DP SAGA), on
    every rank."""
    _, _, results, again = setup
    mh = make_lasso(N=16 * D, n=32, p=4, seed=0)
    for r in range(D):
        np.testing.assert_array_equal(_x(results, name, r),
                                      _x(again, name, r))
        np.testing.assert_array_equal(_x(results, name, r),
                                      _x(results, name, 0))
    assert mh.cost(_x(results, name)) < mh.cost(np.zeros(32))


def test_dp_round_at_one_rank_matches_single_card(tmp_path):
    """At D = 1 a local round of K = 8 steps on kernel #3's path equals
    the single-card coefficient SAGA's K steps on the same starts to 1e-6
    of the largest entry (the delta resync av0 + (av − av0) is not
    bit-equal to av); the check ``chip_smoke.py`` phase 4dp makes on the
    card."""
    prob = make_lasso(N=1024, n=32, p=4, seed=5, dtype=np.float32,
                      well_conditioned=True)
    rng = np.random.default_rng(0)
    case = dict(_base(prob.A, prob.b, prob.lam, prob.L, np.float32),
                fn="single_round", N=1024, B=16, K=8,
                gamma=np.float32(1.0 / (3.0 * np.max(prob.L))),
                starts=(rng.integers(0, 64, 8) * 16).astype(np.int32))
    r = tw.result(tw.spawn({"one": case}, 1, tmp_path), "one")
    assert r["dp"]["it"] == r["single"]["it"] == 9
    for f in ("z", "av", "s"):
        assert tj.gap(r["dp"][f], r["single"][f]) <= 1e-6, f


@pytest.mark.parametrize("m_inner", [32, 40])
def test_svrg_inner_chunked_matches_jax(m_inner):
    """The port's ``svrg_inner_chunked`` (kernel #5's plain version on
    CPU tensors) against JAX's, whose launches run the Pallas kernel in
    interpret mode: the same ``done`` and the same w and running sum to
    rtol 1e-4, atol 1e-6 (the SVRG kernel tests' bounds); the remainder
    (m = 40 is one launch of 32 and 8 left) is the caller's."""
    from ciao_tpu_torch.ops import fused_block as tfb

    Np, npx, B = 1024, 128, 128
    slab = (jfb.SLAB_ROWS, Np // jfb.SLAB_ROWS)
    prob = make_lasso(N=Np, n=npx, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(Np), jnp.float32))
    rng = np.random.default_rng(7)
    zt = (0.05 * rng.standard_normal(npx)).astype(np.float32)
    canch = np.asarray(JF.coeff_all(jnp.asarray(zt)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(canch)), np.float32) / Np
    w = (zt + 0.01 * rng.standard_normal(npx)).astype(np.float32)
    zs = np.zeros(npx, np.float32)
    starts = (rng.integers(0, Np // B, m_inner) * B).astype(np.int32)
    gamma = np.float32(1.0 / (10.0 * np.max(prob.L)))
    sc = np.array([Np, gamma, gamma * prob.lam, 1.0 / B, jfb.MODE_LSQ, 0.0],
                  np.float32)
    with pltpu.force_tpu_interpret_mode():
        jw, jzs, jdone = jfb.svrg_inner_chunked(
            JF.A, jnp.asarray(np.asarray(JF.b)).reshape(slab),
            jnp.asarray(canch).reshape(slab), jnp.asarray(w)[None],
            jnp.asarray(zs)[None], jnp.asarray(av)[None],
            jnp.asarray(sc)[None], B, m_inner,
            lambda k0, K: jax.lax.dynamic_slice_in_dim(
                jnp.asarray(starts), k0, K), launch_steps=32)
    tw_, tzs = torch.tensor(w), torch.tensor(zs)
    st = torch.tensor(starts)
    out_w, out_zs, done = tfb.svrg_inner_chunked(
        torch.tensor(prob.A), torch.tensor(prob.b), torch.tensor(canch),
        tw_, tzs, torch.tensor(av), torch.tensor(sc), B, m_inner,
        lambda k0, K: st[k0:k0 + K], launch_steps=32)
    assert out_w is tw_ and out_zs is tzs  # in place
    assert done == int(jdone) == 32
    np.testing.assert_allclose(out_w.numpy(), np.asarray(jw)[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(out_zs.numpy(), np.asarray(jzs)[0],
                               rtol=1e-4, atol=1e-6)
