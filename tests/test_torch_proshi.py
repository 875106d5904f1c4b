"""The port's sharing family — ProShI, its terms, its kernel and the deep
route — against the JAX package on the CPU.

The reference's acceptance (``tests/test_sharing.py``: N = 3 blocks of
n = 2, the IndBox(-Inf, 1) coupling, 1,000 iterations, ∞-norm 1e-4 on
Σ x_i) through the port's facade in f64. ProShI against JAX's
``proshi_run`` on JAX's own schedule (block ids of its sweep, or the rows
of its RANDOM key chain, handed to the port): in f64 stepwise within
1e-10, in f32 on the port's kernel driver (the plain version of kernel
#18 on CPU tensors) within JAX's fused-vs-stepwise bounds (z rtol 1e-4
atol 1e-6, s rtol 1e-4 atol 1e-5, av rtol 1e-3 atol 1e-4). The plain
version of kernel #18 against the Pallas kernel in TPU interpret mode,
the compensated resync and objective against host f64, and
``deep_solve_sharing`` to rel ≤ 1e-6 on a planted problem.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu import sampling as jsampling
from ciao_tpu.oracles import DenseQuadratic as JDenseQuadratic
from ciao_tpu.oracles import DiagQuadratic as JDiagQuadratic
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.oracles import SqrDistBox as JSqrDistBox
from ciao_tpu.oracles import SumOracle as JSumOracle
from ciao_tpu.oracles import ZeroOracle as JZeroOracle
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.prox import IndBox as JIndBox
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.prox import Zero as JZero
from ciao_tpu.solvers import proshi as jpro
from ciao_tpu.utils import problems as jproblems
from ciao_tpu.utils.problems import make_lasso
import ciao_tpu_torch as ct
from ciao_tpu_torch import monitor
from ciao_tpu_torch.convert import (
    least_squares_from_numpy, proshi_state_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import (
    DenseQuadratic, DiagQuadratic, LeastSquaresRows, SqrDistBox, SumOracle,
    ZeroOracle,
)
from ciao_tpu_torch.prox import IndBox, NormL1, Zero
from ciao_tpu_torch.solvers import proshi as tpro
from ciao_tpu_torch.utils.problems import make_sharing, make_sharing_planted
from torch_threads import one_torch_thread  # noqa: F401

MAXIT, TOL = 1000, 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol, atol, tag=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=tag)


# ---------------------------------------------------------------------------
# the reference's sharing acceptance (tests/test_sharing.py), f64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharing():
    prob = make_sharing()
    F = SumOracle([DiagQuadratic(_t(prob.d), _t(prob.q)),
                   SqrDistBox(prob.box_lo, prob.box_hi, prob.eta, n_terms=3)])
    g = IndBox(-math.inf, _t(prob.g_hi))
    return prob, F, g, torch.zeros(2, dtype=torch.float64)


def _check(prob, blocks):
    blocks = blocks.numpy()
    assert blocks.shape == (3, 2)  # the N block solutions
    assert np.max(np.abs(blocks.sum(axis=0) - prob.sum_star)) < TOL


@pytest.mark.parametrize("sweeping", [1, 2, 3])
def test_proshi_basic(sharing, sweeping):
    prob, F, g, x0 = sharing
    x, it = ct.Proshi(maxit=MAXIT, sweeping=sweeping)(x0, F=F, g=g, L=prob.L,
                                                      N=3)
    assert it == MAXIT
    _check(prob, x)


@pytest.mark.parametrize("sweeping,batch", [(1, 2), (2, 2), (3, 3)])
def test_proshi_minibatch(sharing, sweeping, batch):
    prob, F, g, x0 = sharing
    x, _ = ct.Proshi(maxit=MAXIT, sweeping=sweeping,
                     minibatch=(True, batch))(x0, F=F, g=g, L=prob.L, N=3)
    _check(prob, x)


def test_proshi_scalar_gamma_and_L(sharing):
    prob, F, g, x0 = sharing
    x, _ = ct.Proshi(maxit=MAXIT, gamma=3.0 / float(np.max(prob.L)))(
        x0, F=F, g=g, L=prob.L, N=3)
    _check(prob, x)
    x2, _ = ct.Proshi(maxit=MAXIT)(x0, F=F, g=g, L=float(np.max(prob.L)),
                                   N=3)
    _check(prob, x2)


@pytest.mark.parametrize("sweeping", [1, 2, 3])
def test_proshi_iterator(sharing, sweeping):
    """The module-level ``iterator``: x0 aliased, the states' solution a
    pure view (repeated calls agree; the reference's in-place solution
    would corrupt its table)."""
    prob, F, g, x0 = sharing
    it = ct.iterator(ct.Proshi(sweeping=sweeping), x0, F=F, g=g, L=prob.L,
                     N=3)
    assert it.x0 is x0
    for state in ct.take(iter(it), 2):
        sol = ct.solution(state)
        assert sol.shape == (3, 2)
        torch.testing.assert_close(sol, ct.solution(state), rtol=0, atol=0)


def test_proshi_block_sampling_acceptance(sharing):
    prob, F, g, x0 = sharing
    x, _ = ct.Proshi(maxit=MAXIT, sweeping=1, block_sampling=True)(
        x0, F=F, g=g, L=prob.L, N=3)
    _check(prob, x)


def test_observer_sharing_objective(sharing):
    """``monitor.observer`` on a ProShI run logs the sharing objective at
    the block solution, equal to a numpy evaluation at the end, finite
    (the box's slack at the ulp) and falling."""
    prob, F, g, x0 = sharing
    tr = monitor.Trace()
    x, _ = ct.Proshi(maxit=MAXIT, sweeping=2, freq=250)(
        x0, F=F, g=g, L=prob.L, N=3, observe=monitor.observer(F, g, tr))
    objs = [r["obj"] for r in tr.records if "obj" in r]
    assert len(objs) >= 3 and tr.last("residual") is not None
    blocks = x.numpy()
    fvals = 0.5 * np.sum(prob.d * blocks**2, axis=1) + np.sum(prob.q * blocks,
                                                              axis=1)
    r = blocks - np.clip(blocks, prob.box_lo, prob.box_hi)
    fvals += 0.5 * float(prob.eta) * np.sum(r**2, axis=1)
    assert np.all(blocks.sum(axis=0) <= prob.g_hi + 1e-10)
    assert np.isfinite(objs[-1])
    np.testing.assert_allclose(objs[-1], fvals.sum() / 3.0, rtol=1e-6)
    assert objs[-1] < objs[0] - 1e-6


# ---------------------------------------------------------------------------
# problems, terms and the coupling prox against JAX
# ---------------------------------------------------------------------------

def test_sharing_problems_are_jax_bit_for_bit():
    a, b = make_sharing(), jproblems.make_sharing()
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(a.L, [31.0, 30.0, 30.0])  # the L quirk
    a = make_sharing_planted(N=256, n=16, p=3, seed=4)
    b = jproblems.make_sharing_planted(N=256, n=16, p=3, seed=4)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.cost(a.x_star) == b.cost(b.x_star)


def _terms(kind, rng, N, n):
    d = rng.uniform(-1.0, 2.0, (N, n))
    q = rng.standard_normal((N, n))
    Q = rng.standard_normal((N, n, n))
    if kind == "diag":
        return DiagQuadratic(_t(d), _t(q)), JDiagQuadratic(
            d=jnp.asarray(d), q=jnp.asarray(q))
    if kind == "dense":
        return DenseQuadratic(_t(Q), _t(q)), JDenseQuadratic(
            Q=jnp.asarray(Q), q=jnp.asarray(q))
    if kind == "box":
        return SqrDistBox(-0.5, 0.7, 3.0, n_terms=N), JSqrDistBox(
            lo=jnp.asarray(-0.5), hi=jnp.asarray(0.7), eta=jnp.asarray(3.0),
            n_terms=N)
    if kind == "zero":
        return ZeroOracle(n_terms=N), JZeroOracle(n_terms=N)
    t1, j1 = _terms("diag", rng, N, n)
    t2, j2 = _terms("box", rng, N, n)
    return SumOracle([t1, t2]), JSumOracle(terms=(j1, j2))


@pytest.mark.parametrize("kind", ["diag", "dense", "box", "zero", "sum"])
def test_sharing_terms_match_jax(kind):
    """Every entry point of the sharing terms against JAX's in f64: one
    term, batches, pointwise points, contiguous blocks, full passes and
    the sums."""
    rng = np.random.default_rng(1)
    N, n = 12, 5
    T, J = _terms(kind, rng, N, n)
    x, x2 = rng.standard_normal(n), rng.standard_normal(n)
    xs = rng.standard_normal((4, n))
    idx = np.array([3, 0, 7, 11])
    tx, tx2, txs, tidx = _t(x), _t(x2), _t(xs), torch.tensor(idx)
    jx, jx2, jxs, jidx = map(jnp.asarray, (x, x2, xs, idx))
    pairs = [
        (T.value_and_grad_i(tx, 5), J.value_and_grad_i(jx, 5)),
        (T.value_and_grad_batch(tx, tidx), J.value_and_grad_batch(jx, jidx)),
        (T.value_and_grad_pointwise(txs, tidx),
         J.value_and_grad_pointwise(jxs, jidx)),
        (T.grad_pointwise(txs, tidx), J.grad_pointwise(jxs, jidx)),
        (T.grad_pointwise_block(txs, 4, 4),
         J.grad_pointwise_block(jxs, 4, 4)),
        (T.grad_pointwise_block(txs, torch.tensor(4), 4),
         J.grad_pointwise_block(jxs, jnp.asarray(4), 4)),
        (T.grad_block(tx, 8, 4), J.grad_block(jx, 8, 4)),
        (T.grad_all(tx), J.grad_all(jx)),
        (T.value_and_grad_all(tx), J.value_and_grad_all(jx)),
        (T.grad_sum_all(tx), J.grad_sum_all(jx)),
        (T.grad_sum_diff(tx, tx2, tidx), J.grad_sum_diff(jx, jx2, jidx)),
        (T.grad_sum_diff_block(tx, tx2, 4, 4),
         J.grad_sum_diff_block(jx, jx2, 4, 4)),
    ]
    for k, (got, want) in enumerate(pairs):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            _close(a.numpy(), b, 1e-12, 1e-12, f"{kind} entry {k}")
    assert T.num_terms == N


def test_indbox_and_least_squares_pointwise_match_jax():
    """IndBox: clip, a 100·eps slack on the value (0 at the ulp over the
    bound, ∞ beyond it), array bounds; the least-squares pointwise
    entries and ``fused_saga_block``'s int8 refusal as JAX's."""
    for lo, hi in ((-math.inf, 1.0), (-0.5, np.array([0.2, 1.0, 3.0]))):
        t, j = IndBox(lo, _t(hi) if np.ndim(hi) else hi), JIndBox(
            lo=jnp.asarray(lo), hi=jnp.asarray(hi))
        for x in (np.array([0.1, 0.9, -3.0]),
                  np.array([0.2, 1.0, 3.0]) * (1 + 1e-14),
                  np.array([0.1, 2.0, 9.0])):
            assert float(t.value(_t(x))) == float(j.value(jnp.asarray(x)))
            _close(t.prox_only(_t(x), 0.1).numpy(),
                   j.prox_only(jnp.asarray(x), 0.1), 0, 0)
    assert float(IndBox(-math.inf, 1.0).value(
        torch.tensor([1.0 + 1e-15], dtype=torch.float64))) == 0.0
    assert math.isinf(float(IndBox(-math.inf, 1.0).value(
        torch.tensor([1.01], dtype=torch.float64))))
    prob = make_lasso(N=16, n=4, p=2, seed=1)
    for storage in ("f32", "int8"):
        JF = JLeastSquaresRows(A=jnp.asarray(prob.A, jnp.float32),
                               b=jnp.asarray(prob.b, jnp.float32),
                               scale=jnp.asarray(16.0, jnp.float32))
        if storage == "int8":
            JF = JF.with_storage("int8")
        F = least_squares_from_numpy(
            np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
            None if JF.row_scale is None else np.asarray(JF.row_scale),
            device="cpu")
        xs = np.random.default_rng(2).standard_normal((4, 4)).astype(
            np.float32)
        idx = np.array([1, 2, 3, 4])
        for got, want in (
                (F.grad_pointwise_block(_t(xs), 1, 4),
                 JF.grad_pointwise_block(jnp.asarray(xs), 1, 4)),
                (F.value_and_grad_pointwise(_t(xs), torch.tensor(idx))[0],
                 JF.value_and_grad_pointwise(jnp.asarray(xs),
                                             jnp.asarray(idx))[0])):
            _close(got.numpy(), want, 1e-5, 1e-5, storage)
    with pytest.raises(ValueError, match="int8"):
        F.fused_saga_block(torch.zeros(16, 4), torch.zeros(4), 0, 4)


# ---------------------------------------------------------------------------
# ProShI against JAX on JAX's schedules
# ---------------------------------------------------------------------------

def _lasso_pair(N, n, dtype, storage="f32", seed=3):
    prob = make_lasso(N=N, n=n, p=4, seed=seed, dtype=dtype)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N), prob.A.dtype))
    if storage != "f32":
        JF = JF.with_storage(storage)
    F = least_squares_from_numpy(
        np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
        None if JF.row_scale is None else np.asarray(JF.row_scale),
        device="cpu")
    gamma = (0.999 * N / np.asarray(prob.L, np.float64)).astype(dtype)
    return prob, JF, F, gamma


def _couplings(name, dtype):
    if name == "box":
        return JIndBox(lo=-jnp.inf, hi=jnp.asarray(0.5, dtype)), IndBox(
            -math.inf, torch.tensor(0.5, dtype=torch.from_numpy(
                np.zeros(1, dtype)).dtype))
    if name == "l1":
        return JNormL1(lam=jnp.asarray(0.01, dtype)), NormL1(
            torch.tensor(0.01, dtype=torch.from_numpy(
                np.zeros(1, dtype)).dtype))
    return JZero(), Zero()


def _jax_schedule(key, cfg, steps):
    """The schedule JAX's stepwise run draws: the block ids of its sweep
    (contiguous and ragged block sweeps), or the rows of its RANDOM key
    chain."""
    st = jsampling.init_sweep(key, cfg.N, cfg.batch, cfg.sweeping)
    if cfg.sweeping == 1 and not cfg.block_sampling:
        rows = []
        for _ in range(steps):
            idx, _, st = jsampling.next_block(st, cfg.N, cfg.batch, 1)
            rows.append(np.asarray(idx))
        return dict(idx=np.stack(rows))
    return dict(blocks=np.asarray(jsampling.gen_block_ids(
        st, steps, cfg.N, cfg.batch, cfg.sweeping)[0]))


def _run_pair(N, n, B, steps, sweeping, gname, dtype, storage="f32",
              block_sampling=False, fused=False):
    """JAX's stepwise ProShI run and the port's on JAX's schedule (the
    port's kernel driver when ``fused``)."""
    prob, JF, F, gamma = _lasso_pair(N, n, dtype, storage)
    jg, g = _couplings(gname, dtype)
    key = jax.random.PRNGKey(5)
    kw = dict(N=N, batch=B, sweeping=sweeping, alpha=0.999,
              block_sampling=block_sampling)
    jcfg = jpro.ProshiCfg(**kw)
    x0 = np.zeros(n, dtype)
    jst0 = jpro.proshi_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key,
                            jcfg)
    jst = jpro.proshi_run(JF, jg, jst0, jcfg, steps)
    cfg = tpro.ProshiCfg(**kw, fused=fused)
    st0 = tpro.proshi_init(F, g, _t(x0), _t(gamma), 0, cfg)
    tol = 1e-12 if dtype == np.float64 else 1e-5  # f32: av sums N rows
    for name in ("s", "av", "z"):
        want = np.asarray(getattr(jst0, name))
        _close(getattr(st0, name).numpy(), want, tol,
               tol * float(np.abs(want).max()), f"init {name}")
    st = tpro.proshi_run(F, g, st0, cfg, steps,
                         **_jax_schedule(key, jcfg, steps))
    assert st.it == int(jst.it) == steps + 1
    if sweeping != 1 or block_sampling:
        # a RANDOM sweep's pos counts the port's draws, JAX's stays put
        assert st.sweep.pos == int(jst.sweep.pos)
    return st, jst, st0


@pytest.mark.parametrize("sweeping,gname,N,block_sampling", [
    (2, "box", 256, False), (3, "l1", 256, False), (1, "zero", 256, False),
    (1, "box", 256, True), (2, "l1", 250, False), (3, "zero", 250, False),
], ids=["cyclic-box", "shuffled-l1", "random-zero", "random-block-box",
        "ragged-cyclic-l1", "ragged-shuffled-zero"])
def test_proshi_matches_jax_f64(sweeping, gname, N, block_sampling):
    """Stepwise ProShI, 40 steps of B = 32 rows (N = 250: a ragged last
    block of 26), on JAX's schedule: z, s and av within 1e-10."""
    st, jst, _ = _run_pair(N, 16, 32, 40, sweeping, gname, np.float64,
                           block_sampling=block_sampling)
    for name in ("z", "s", "av"):
        want = np.asarray(getattr(jst, name))
        _close(getattr(st, name).numpy(), want, 1e-10,
               1e-10 * max(float(np.abs(want).max()), 1.0), name)


@pytest.mark.parametrize("case", [
    "cyclic-box", "cyclic-l1", "cyclic-zero", "cyclic-int8-box",
    "shuffled-l1", "random-block-l1"])
def test_proshi_kernel_driver_matches_jax_f32(case, monkeypatch):
    """The port's kernel driver (the plain version of kernel #18, one call
    of up to LAUNCH_STEPS steps) on JAX's schedule against JAX's stepwise
    run, with JAX's fused-vs-stepwise bounds: tests/test_sharing.py's
    cyclic cases (N = 1,024, n = 128, B = 128, 27 steps; int8 rows 24),
    and its shuffled and random-block cases (N = 1,280, B = 16, 150
    steps: d = 80 > K, where JAX's kernel clamps and the port's does
    not)."""
    calls = []
    real = tfb.proshi_multistep
    monkeypatch.setattr(tfb, "proshi_multistep",
                        lambda *a, **k: calls.append(a[4].shape[0])
                        or real(*a, **k))
    parts = case.split("-")
    gname = parts[-1]
    if parts[0] == "cyclic":
        storage = "int8" if "int8" in parts else "f32"
        steps = 24 if storage == "int8" else 27
        st, jst, _ = _run_pair(1024, 128, 128, steps, 2, gname, np.float32,
                               storage, fused=True)
    else:
        steps = 150
        st, jst, _ = _run_pair(1280, 128, 16, steps, 3 if parts[0] ==
                               "shuffled" else 1, gname, np.float32,
                               block_sampling=parts[0] == "random",
                               fused=True)
    assert calls == [min(steps, 128)] + ([steps - 128] if steps > 128 else [])
    _close(st.z.numpy(), jst.z, 1e-4, 1e-6, "z")
    _close(st.s.numpy(), jst.s, 1e-4, 1e-5, "s")
    _close(st.av.numpy(), jst.av, 1e-3, 1e-4, "av")


@pytest.mark.parametrize("case", ["f32-box", "int8-l1-masked",
                                  "f32-zero-default", "bf16-box-masked"])
def test_proshi_multistep_ref_matches_pallas(case):
    """The plain version of kernel #18 against the Pallas kernel in
    interpret mode, K = 4 distinct blocks of N = 1,024, n = 128, B = 128:
    s, av and z within 1e-5 of their largest entries. A masked call (f = 2
    < K) matches JAX's clamped launch (its masked steps leave s and av,
    and recompute z from them); "default" precision changes nothing in
    either (the Pallas body ignores it)."""
    storage, gname = case.split("-")[:2]
    masked = case.endswith("masked")
    precision = "default" if case.endswith("default") else "highest"
    N, n, B, K = 1024, 128, 128, 4
    prob, JF, F, gamma = _lasso_pair(N, n, np.float32, storage)
    if storage == "bf16":
        JF = JLeastSquaresRows(A=JF.A.astype(jnp.bfloat16), b=JF.b,
                               scale=JF.scale)
        F = least_squares_from_numpy(np.asarray(JF.A), np.asarray(JF.b),
                                     np.asarray(JF.scale), device="cpu")
    jg, g = _couplings(gname, np.float32)
    rng = np.random.default_rng(7)
    s = (0.05 * rng.standard_normal((N, n))).astype(np.float32)
    av = s.sum(axis=0)
    hat = np.float32(gamma.sum())
    jz = jpro._coupling(jg, jnp.asarray(av), jnp.asarray(hat))
    starts = np.array([512, 0, 896, 256], np.int32)
    st = tpro.ProshiState(s=_t(s), gamma=_t(gamma), hat_gamma=_t(hat),
                          av=_t(av), z=_t(np.asarray(jz)), sweep=None, it=1,
                          status=0)
    cfg = tpro.ProshiCfg(N=N, batch=B, sweeping=2, alpha=0.999)
    scalars = tpro._scalars_row(F, g, st, cfg)
    jstate = jpro.ProshiState(s=jnp.asarray(s), gamma=jnp.asarray(gamma),
                              hat_gamma=jnp.asarray(hat), av=jnp.asarray(av),
                              z=jz, sweep=None, it=None, status=None)
    jsc, b2, g2, rs2, _ = jpro._proshi_fused_consts(JF, jg, jstate, cfg)
    np.testing.assert_allclose(scalars.numpy(), np.asarray(jsc)[0], rtol=1e-7)
    f = 2 if masked else None
    with pltpu.force_tpu_interpret_mode():
        js, jav, jzz = jfb.proshi_multistep(
            JF.A, b2, g2, jnp.asarray(s), jnp.asarray(starts),
            jnp.asarray(av)[None], jz[None], jsc, B, precision=precision,
            rs2=rs2, interpret=True,
            f=None if f is None else jnp.asarray(f, jnp.int32))
    ts, tav, tz = _t(s), _t(av), _t(np.asarray(jz))
    out = tfb.proshi_multistep(
        F.A, F.b, _t(gamma), ts,
        torch.tensor(starts), tav, tz, scalars, B, precision=precision,
        rs=F.coeff_rows_scale(), f=None if f is None else torch.tensor([f],
                                                                   dtype=torch.int32))
    assert out[0] is ts and out[1] is tav and out[2] is tz
    for name, got, want in (("s", ts, js), ("av", tav, jav[0]),
                            ("z", tz, jzz[0])):
        want = np.asarray(want)
        _close(got.numpy(), want, 1e-5,
               1e-5 * max(float(np.abs(want).max()), 1e-30), name)
    if masked:  # rows of the masked steps' blocks stay as they were
        np.testing.assert_array_equal(ts.numpy()[896:1024], s[896:1024])


# ---------------------------------------------------------------------------
# resync, objective, the deep route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    prob = make_sharing_planted(N=2048, n=64, p=8, seed=1)
    F = DiagQuadratic(_t(prob.d.astype(np.float32)),
                      _t(prob.q.astype(np.float32)))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    return prob, F, g, torch.zeros(64)


def test_resync_and_objective_match_host_f64(planted):
    """tests/test_deep_sharing.py: the compensated coupling sum tracks the
    f64 sum within the f32 input noise, the resync rebuilds av from the
    table and z from av, and the compensated sharing objective agrees
    with the host-f64 evaluation to 1e-5 after 256 steps."""
    prob, F, g, x0 = planted
    rng = np.random.default_rng(0)
    s64 = rng.standard_normal((65_536, 8))
    comp = tpro._av_compensated(_t(s64.astype(np.float32)), 2048).double()
    in_noise = np.sqrt(65_536) * 1.2e-7 * np.abs(s64).max()
    assert float((comp - _t(s64.sum(axis=0))).abs().max()) < 4 * in_noise
    gam = _t((0.999 * 2048 / prob.L).astype(np.float32))
    cfg = tpro.ProshiCfg(N=2048, batch=64, sweeping=2, alpha=0.999)
    st = tpro.proshi_run(F, g, tpro.proshi_init(F, g, x0, gam, 0, cfg), cfg,
                         256)
    re = tpro.proshi_resync(g, st._replace(av=st.av + 1.0), 1000)
    np.testing.assert_allclose(re.av.double().numpy(),
                               st.s.double().sum(0).numpy(), rtol=1e-5,
                               atol=1e-4)
    torch.testing.assert_close(re.z, tpro._coupling(g, re.av, re.hat_gamma))
    dev = float(tpro.sharing_objective(F, g, st, 1024))
    host = prob.cost(st.solution.double().numpy())
    assert abs(dev - host) / abs(host) < 1e-5
    assert tpro._resync_chunk_of(2048, 1000) == 512
    assert tpro._resync_chunk_of(2000, 1024) == 1000


def test_deep_solve_sharing_f32_reaches_1e6(planted):
    """The public route: f32 ProShI with compensated resyncs reaches rel ≤
    1e-6 against the f64 closed-form optimum (the reference needs f64 for
    its 1e-4); the trace's last objective agrees with the host's."""
    prob, F, g, x0 = planted
    blocks, info = ct.deep_solve_sharing(
        x0, F, g=g, L=prob.L, N=2048, batch=64, sweeping=2, chunk_epochs=32,
        max_epochs=2048, resync_chunk=1024, seed=0)
    assert blocks.shape == (2048, 64) and blocks.dtype == torch.float32
    host = prob.cost(blocks.double().numpy())
    assert (host - prob.f_star) / abs(prob.f_star) < 1e-6
    assert info.resyncs >= 1 and info.epochs == 32 * info.resyncs
    assert abs(info.objs[-1] - host) / abs(host) < 1e-5


# ---------------------------------------------------------------------------
# facade, routing, state carry-over
# ---------------------------------------------------------------------------

def test_proshi_facade_routes_and_warns(monkeypatch):
    """With the gate opened for CPU tensors the facade takes the kernel
    for every contiguous schedule (cyclic, shuffled, random with block
    sampling, at any d: JAX's d ≥ 64 rule sizes its TPU clamp) and a
    dense row oracle with an in-kernel coupling, and the stepwise path
    for the scattered random sweep, a ragged N % B, quadratic terms or
    another coupling; the kernel run ends where the stepwise run ends."""
    prob, JF, F, gamma = _lasso_pair(512, 32, np.float32)
    g = NormL1(torch.tensor(0.01))
    monkeypatch.setattr(tfb, "proshi_multistep_available",
                        lambda F, g, x0, B: hasattr(F, "coeff_mode")
                        and F.num_terms % B == 0)

    def cfg(**kw):
        F_ = kw.pop("F", F)
        return ct.Proshi(**kw)._setup(torch.zeros(32), F_, g, prob.L,
                                      None)[3]

    assert cfg(sweeping=2, minibatch=(True, 64)).fused
    assert cfg(sweeping=3, minibatch=(True, 64)).fused
    assert cfg(sweeping=1, block_sampling=True, minibatch=(True, 64)).fused
    assert not cfg(sweeping=1, minibatch=(True, 64)).fused
    assert not cfg(sweeping=2, minibatch=(True, 60)).fused
    assert not cfg(sweeping=2, minibatch=(True, 64),
                   F=DiagQuadratic(torch.ones(512, 32),
                                   torch.zeros(512, 32))).fused
    x, _ = ct.Proshi(sweeping=3, minibatch=(True, 64), maxit=40)(
        torch.zeros(32), F=F, g=g, L=prob.L)
    monkeypatch.setattr(tfb, "proshi_multistep_available", lambda *a: False)
    x2, _ = ct.Proshi(sweeping=3, minibatch=(True, 64), maxit=40)(
        torch.zeros(32), F=F, g=g, L=prob.L)
    _close(x.numpy(), x2.numpy(), 1e-4, 1e-6)


def test_proshi_facade_errors_and_zero_default():
    """The facade's guards (JAX's asserts as ValueErrors), ``F=None``
    building ``ZeroOracle(n_terms=N)``, and the real kernel gate closed
    for CPU tensors, IndBox with array bounds and other couplings."""
    for kw in (dict(gamma=-1.0), dict(maxit=0), dict(sweeping=4),
               dict(block_sampling=True, sweeping=2),
               dict(minibatch=(True, 0)), dict(fused_precision="tf32")):
        with pytest.raises(ValueError):
            ct.Proshi(**kw)
    with pytest.raises(ValueError, match="divisible"):
        ct.Proshi(sweeping=1, block_sampling=True, minibatch=(True, 4))(
            torch.zeros(2), L=np.ones(6), N=6)
    with pytest.raises(ValueError, match="smoothness"):
        ct.Proshi()(torch.zeros(2), N=6)
    x, it = ct.Proshi(maxit=5, sweeping=2, gamma=0.5)(
        torch.tensor([1.0, -1.0]), g=IndBox(-math.inf, 0.5), N=4)
    assert x.shape == (4, 2) and it == 5
    F = LeastSquaresRows(torch.randn(64, 8), torch.randn(64), 64.0)
    x0 = torch.zeros(8)
    for g in (NormL1(0.1), Zero(), IndBox(-math.inf, 1.0),
              IndBox(-1.0, torch.ones(8)), None):
        assert not tfb.proshi_multistep_available(F, g, x0, 16)
    assert not tfb.saga_block_available(F, x0, 16)


def test_proshi_state_from_numpy():
    """A JAX ProShI state carried over as numpy steps on as JAX's does
    (the cyclic sweep's pos and order come with it)."""
    prob, JF, F, gamma = _lasso_pair(256, 16, np.float64)
    jg, g = _couplings("box", np.float64)
    jcfg = jpro.ProshiCfg(N=256, batch=32, sweeping=2, alpha=0.999)
    jst = jpro.proshi_run(JF, jg, jpro.proshi_init(
        JF, jg, jnp.zeros(16), jnp.asarray(gamma), jax.random.PRNGKey(0),
        jcfg), jcfg, 5)
    st = proshi_state_from_numpy(jst.s, jst.gamma, jst.hat_gamma, jst.av,
                                 jst.z, jst.sweep.pos, jst.sweep.order,
                                 jst.it, device="cpu")
    assert st.it == 6 and st.s.shape == (256, 16)
    cfg = tpro.ProshiCfg(N=256, batch=32, sweeping=2, alpha=0.999)
    j2 = jpro.proshi_step(JF, jg, jst, jcfg)
    t2 = tpro.proshi_step(F, g, st, cfg)
    assert t2.sweep.pos == int(j2.sweep.pos)
    for name in ("z", "s", "av"):
        _close(getattr(t2, name).numpy(), getattr(j2, name), 1e-12, 1e-12,
               name)
    # the step left the state it was given as it was
    np.testing.assert_array_equal(st.s.numpy(), np.asarray(jst.s))


def test_new_modules_import_no_jax():
    """The sharing modules of the port import no JAX either."""
    code = "\n".join([
        "import sys",
        "import ciao_tpu_torch.solvers.proshi, ciao_tpu_torch.solvers.deep_sharing",
        "import ciao_tpu_torch.oracles.quadratic, ciao_tpu_torch.oracles.compose",
        "import ciao_tpu_torch.monitor, ciao_tpu_torch.utils.problems",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ciao_tpu'))",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
