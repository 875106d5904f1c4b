"""The port's SVRG/SVRG++ path against the JAX package on the CPU.

The oracle's gradient sums, the plain version of kernel #5
(``svrg_coeff_multistep_ref``, against the Pallas kernel in interpret
mode) and the solver in its three inner modes — stepwise blocks, iid
rows and the fused multistep driver (the plain kernel versions on CPU
tensors) — on the same numpy inputs. torch cannot draw threefry, so the
parity tests replay JAX's key chain (one ``jax.random.split`` per outer
step, then ``_gen_block_starts`` or the iid split chain) and hand the
schedule to ``svrg_run``. The facades solve the reference's planted
Lasso with the port's own draws.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import svrg as jsvrg
from ciao_tpu.solvers.saga import _gen_block_starts
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch import runtime
from ciao_tpu_torch.convert import (
    least_squares_from_numpy, svrg_state_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import (
    SVRG, SVRGCfg, halt, loop, solution, svrg_init, svrg_run,
    svrg_step, take,
)
from ciao_tpu_torch.solvers.svrg import inner_indices, inner_starts
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    """A torch copy of a numpy array (the kernels update in place)."""
    return torch.tensor(np.asarray(a))


def _jax_oracle(prob, N, storage="f32"):
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N), prob.A.dtype))
    return JF if storage == "f32" else JF.with_storage(storage)


def _port_oracle(JF):
    return least_squares_from_numpy(
        np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
        None if JF.row_scale is None else np.asarray(JF.row_scale),
        device="cpu")


# ---------------------------------------------------------------------------
# the oracle's gradient sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["f64", "bf16", "int8"])
def test_grad_sums_match_jax(storage):
    """grad_sum_diff (gathered rows), grad_sum_diff_block and grad_sum_all
    against JAX: f64 rows at rtol 1e-12; bf16 and int8 storage at f32
    iterates, rtol 1e-5 (int8: the scale on both sides, as JAX)."""
    dtype = np.float64 if storage == "f64" else np.float32
    prob = make_lasso(N=256, n=24, p=4, seed=1, dtype=dtype)
    JF = _jax_oracle(prob, 256, "f32" if storage == "f64" else storage)
    F = _port_oracle(JF)
    rng = np.random.default_rng(2)
    x1, x2 = (rng.standard_normal((2, 24)) * 0.3).astype(dtype)
    idx = rng.integers(0, 256, 16).astype(np.int32)
    rtol = 1e-12 if storage == "f64" else 1e-5
    jx1, jx2 = jnp.asarray(x1), jnp.asarray(x2)
    tx1, tx2 = _t(x1), _t(x2)
    pairs = [
        (JF.grad_sum_diff(jx1, jx2, jnp.asarray(idx)),
         F.grad_sum_diff(tx1, tx2, _t(idx).long())),
        (JF.grad_sum_diff_block(jx1, jx2, 64, 32),
         F.grad_sum_diff_block(tx1, tx2, 64, 32)),
        (JF.grad_sum_diff_block(jx1, jx2, 64, 32),
         F.grad_sum_diff_block(tx1, tx2, torch.tensor(64), 32)),
        (JF.grad_sum_all(jx1), F.grad_sum_all(tx1)),
    ]
    for want, got in pairs:
        assert got.dtype == tx1.dtype
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# kernel #5's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

N, n, B, K = 1024, 128, 128, 16
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)


def _kernel_problem(storage):
    """A planted Lasso in both packages with an SVRG-like state: the
    anchor z̃ and its coefficients, av its mean gradient, w a point near
    it, zs a running sum."""
    prob = make_lasso(N=N, n=n, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = _jax_oracle(prob, N, storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    rng = np.random.default_rng(7)
    zt = (0.05 * rng.standard_normal(n)).astype(np.float32)
    canch = np.asarray(JF.coeff_all(jnp.asarray(zt)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(canch)), np.float32) / N
    w = (zt + 0.01 * rng.standard_normal(n)).astype(np.float32)
    zs = (0.1 * rng.standard_normal(n)).astype(np.float32)
    starts = (rng.integers(0, N // B, K) * B).astype(np.int32)
    gamma = np.float32(1.0 / (10.0 * np.max(prob.L)))
    return JF, rs, canch, av, w, zs, starts, gamma, prob


def _torch_rows(JF, storage):
    if storage == "bf16":
        return _t(np.asarray(JF.A.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(JF.A))


@pytest.mark.parametrize("prox", ["l1", "zero"])
@pytest.mark.parametrize("storage,precision", [
    ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
    ("int8", "highest"),
], ids=["f32", "f32-default", "bf16", "int8"])
def test_svrg_multistep_ref_matches_pallas(storage, precision, prox):
    """K = 16 inner steps (repeated blocks included) of the plain version
    against the Pallas kernel in interpret mode on one schedule: w and zs
    at rtol 1e-4, atol 1e-6. "default" rounds both dot operands to bf16,
    as the TPU's MXU does; XLA on the CPU keeps f32 dots exact at any
    precision, so its reference is the same rows stored bf16. Zero is
    γλ = 0 in the scalars row."""
    JF, rs, canch, av, w, zs, starts, gamma, prob = _kernel_problem(storage)
    thr = gamma * prob.lam if prox == "l1" else 0.0
    sc = np.array([N, gamma, thr, 1.0 / B, jfb.MODE_LSQ, 0.0], np.float32)
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jw, jzs = jfb.svrg_coeff_multistep(
            jA, jnp.asarray(np.asarray(JF.b)).reshape(SLAB),
            jnp.asarray(canch).reshape(SLAB), jnp.asarray(starts),
            jnp.asarray(w)[None], jnp.asarray(zs)[None],
            jnp.asarray(av)[None], jnp.asarray(sc)[None], B,
            precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB))
    tw, tzs = _t(w), _t(zs)
    out = tfb.svrg_coeff_multistep(
        _torch_rows(JF, storage), _t(np.asarray(JF.b)), _t(starts),
        _t(canch), tw, tzs, _t(av), _t(sc), B, precision=precision,
        rs=None if rs is None else _t(rs))
    assert out[0] is tw and out[1] is tzs  # in place
    assert not np.array_equal(tw.numpy(), w)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw)[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tzs.numpy(), np.asarray(jzs)[0], rtol=1e-4,
                               atol=1e-6)


def test_svrg_wrapper_on_cpu_and_gate():
    """CPU tensors take the plain version and count no launch; a device
    with no kernel raises; the gate is closed for CPU tensors and for a
    prox the kernel does not apply."""
    JF, rs, canch, av, w, zs, starts, gamma, prob = _kernel_problem("int8")
    args = (_torch_rows(JF, "int8"), _t(np.asarray(JF.b)), _t(starts),
            _t(canch))
    sc = _t(np.array([N, gamma, gamma * prob.lam, 1.0 / B, 0.0, 0.0],
                     np.float32))
    state, ref = [_t(w), _t(zs)], [_t(w), _t(zs)]
    before = tfb.svrg_coeff_multistep.launches
    tfb.svrg_coeff_multistep(*args, *state, _t(av), sc, B, rs=_t(rs))
    tfb.svrg_coeff_multistep_ref(*args, *ref, _t(av), sc, B, rs=_t(rs))
    assert tfb.svrg_coeff_multistep.launches == before
    for got, want in zip(state, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    m = torch.empty((64, 8), device="meta")
    v = torch.empty(64, device="meta")
    z = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.svrg_coeff_multistep(
            m, v, torch.zeros(2, dtype=torch.int32, device="meta"), v, z,
            z.clone(), z.clone(), torch.empty(6, device="meta"), 16)
    F = LeastSquaresRows(torch.randn(64, 8), torch.randn(64), 64.0)
    assert not tfb.svrg_multistep_available(F, NormL1(0.1), torch.zeros(8),
                                            16)
    assert not tfb.svrg_multistep_available(F, object(), torch.zeros(8), 16)


# ---------------------------------------------------------------------------
# svrg_run against JAX on JAX's schedule
# ---------------------------------------------------------------------------

def _jax_schedules(key, ms, cfg, iid=False):
    """JAX's inner schedule of outer steps with inner lengths ``ms``: per
    outer step ``key, sub = split(key)``; block starts
    ``_gen_block_starts(sub, 0, cfg, m)``, or the iid chain
    ``sub, ik = split(sub)`` with one ``randint`` per inner step."""
    out = []
    for m in ms:
        key, sub = jax.random.split(key)
        if not iid:
            out.append(np.array(_gen_block_starts(sub, 0, cfg, m)))
            continue
        idx = []
        for _ in range(m):
            sub, ik = jax.random.split(sub)
            idx.append(int(jax.random.randint(ik, (1,), 0, cfg.N,
                                              dtype=jnp.int32)[0]))
        out.append(np.asarray(idx, np.int64))
    return out


def _close_state(t, j, tag):
    """z_full and w at rtol 1e-4, atol 1e-6; av at rtol 1e-3, atol 1e-4:
    tests/test_ops.py's fused-vs-stepwise bounds."""
    np.testing.assert_allclose(t.z_full.numpy(), np.asarray(j.z_full),
                               rtol=1e-4, atol=1e-6, err_msg=tag)
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=1e-4,
                               atol=1e-6, err_msg=tag)
    np.testing.assert_allclose(t.av.numpy(), np.asarray(j.av), rtol=1e-3,
                               atol=1e-4, err_msg=tag)
    assert t.m == int(j.m) and t.it == int(j.it), tag


def _svrg_pair(Np, seed, plus):
    prob = make_lasso(N=Np, n=128, p=4, seed=seed, dtype=np.float32,
                      well_conditioned=plus)
    JF = _jax_oracle(prob, Np)
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    gamma = np.float32(1.0 / (10.0 * np.max(prob.L)))
    return JF, jg, _port_oracle(JF), g, gamma


@pytest.mark.parametrize("mode", ["block", "iid", "fused"])
@pytest.mark.parametrize("m", [24, 70])
def test_svrg_run_matches_jax(mode, m, monkeypatch):
    """Three outer steps of m inner steps (tests/test_ops.py:408's
    problem), N = 1,024, n = 128, B = 128. block: the stepwise block
    paths of both packages. iid: the reference's one-row inner loop
    (batch 1, with replacement). fused: JAX's Pallas kernels in
    interpret mode against the port's fused driver, whose wrappers run
    their plain versions here — one launch of kernel #5 per outer step
    (m ≤ LAUNCH_STEPS) and one of kernel #6 per anchor refresh."""
    JF, jg, F, g, gamma = _svrg_pair(1024, 3, plus=False)
    key = jax.random.PRNGKey(5)
    x0 = np.zeros(128, np.float32)
    block = mode != "iid"
    jcfg = jsvrg.SVRGCfg(N=1024, plus=False, batch=128, block=block,
                         fused=mode == "fused",
                         m_fused=m if mode == "fused" else 0)
    jst0 = jsvrg.svrg_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), m,
                           key, jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jsvrg.svrg_run(JF, jg, jst0, jcfg, 3)
    sched = _jax_schedules(key, [m] * 3, jcfg, iid=not block)

    calls = {"svrg_coeff_multistep": 0, "coeff_apply_all": 0}
    for name in calls:
        fn = getattr(tfb, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tfb, name, spy)
    cfg = SVRGCfg(N=1024, plus=False, batch=128, block=block,
                  fused=mode == "fused")
    st0 = svrg_init(F, g, _t(x0), _t(gamma), m, 0, cfg)
    jav0 = np.asarray(jst0.av)
    np.testing.assert_allclose(st0.av.numpy(), jav0, rtol=1e-5,
                               atol=1e-5 * np.abs(jav0).max())
    kw = dict(starts=sched) if block else dict(idx=sched)
    st = svrg_run(F, g, st0, cfg, 3, **kw)
    _close_state(st, jst, f"{mode} m={m}")
    if mode == "fused":
        assert calls == {"svrg_coeff_multistep": 3, "coeff_apply_all": 3}
        assert st.canch.shape == (1024,)
        np.testing.assert_allclose(
            st.canch.numpy(), np.asarray(jst.canch).reshape(-1), rtol=1e-3,
            atol=1e-3 * float(np.abs(np.asarray(jst.canch)).max()))
    else:
        assert calls == {"svrg_coeff_multistep": 0, "coeff_apply_all": 0}
        assert st.canch is None
    # the run copied what the kernels update in place
    np.testing.assert_array_equal(st0.w.numpy(), x0)


def test_svrg_plus_matches_jax_across_launch_boundaries(monkeypatch):
    """SVRG++ on the fused path (tests/test_ops.py:1183's problem, N =
    8,192): m = 48 → 96 → 192 crosses the port's 128-step launch (192 =
    128 + 64, the remainder a short launch of kernel #5, never stepwise)
    and doubles to 384 in step with JAX's dynamic-launch driver (interpret
    mode) on JAX's schedule."""
    JF, jg, F, g, gamma = _svrg_pair(8192, 5, plus=True)
    key = jax.random.PRNGKey(3)
    x0 = np.zeros(128, np.float32)
    jcfg = jsvrg.SVRGCfg(N=8192, plus=True, batch=128, block=True,
                         fused=True)
    with pltpu.force_tpu_interpret_mode():
        jst = jsvrg.svrg_run(JF, jg, jsvrg.svrg_init(
            JF, jg, jnp.asarray(x0), jnp.asarray(gamma), 48, key, jcfg),
            jcfg, 3)
    sched = _jax_schedules(key, [48, 96, 192], jcfg)
    launches = []
    fn = tfb.svrg_coeff_multistep

    def spy(*a, **kw):
        launches.append(a[2].shape[0])
        return fn(*a, **kw)
    monkeypatch.setattr(tfb, "svrg_coeff_multistep", spy)
    cfg = SVRGCfg(N=8192, plus=True, batch=128, block=True, fused=True)
    st = svrg_run(F, g, svrg_init(F, g, _t(x0), _t(gamma), 48, 0, cfg), cfg,
                  3, starts=sched)
    assert launches == [48, 96, 128, 64]
    assert st.m == int(jst.m) == 384
    _close_state(st, jst, "SVRG++")


def test_fused_driver_matches_stepwise_port():
    """Within the port, on its own draws: the fused driver (plain kernel
    versions) and the stepwise block path give one trajectory to f32
    rounding, and the draws are a pure function of (seed, it, k)."""
    prob = make_lasso(N=512, n=32, p=3, seed=1, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 512.0)
    g = NormL1(prob.lam)
    gamma = 1.0 / (10.0 * float(np.max(prob.L)))
    cfg = SVRGCfg(N=512, plus=True, batch=64, block=True)
    x0 = torch.zeros(32)
    a = svrg_run(F, g, svrg_init(F, g, x0, gamma, 40, 9, cfg), cfg, 3)
    cf = cfg._replace(fused=True)
    b = svrg_run(F, g, svrg_init(F, g, x0, gamma, 40, 9, cf), cf, 3)
    assert a.m == b.m == 320 and a.it == b.it == 4
    np.testing.assert_allclose(b.z_full.numpy(), a.z_full.numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.w.numpy(), a.w.numpy(), rtol=1e-4,
                               atol=1e-6)
    s = inner_starts(9, 2, 100, cfg, "cpu")
    assert s.dtype == torch.int32 and bool((s % 64 == 0).all())
    torch.testing.assert_close(s[:40], inner_starts(9, 2, 40, cfg, "cpu"))
    assert not torch.equal(s, inner_starts(9, 3, 100, cfg, "cpu"))
    i = inner_indices(9, 2, 50, 512, "cpu")
    assert torch.equal(i, inner_indices(9, 2, 50, 512, "cpu"))
    assert int(i.min()) >= 0 and int(i.max()) < 512


def test_svrg_state_from_numpy():
    """A fused JAX state carried over: its (8, N/8) anchor slab becomes
    the flat (N,) table in row-major order, which is the row order (row i
    of the slab holds rows i·N/8 … (i+1)·N/8 − 1)."""
    JF, jg, F, g, gamma = _svrg_pair(1024, 3, plus=False)
    jcfg = jsvrg.SVRGCfg(N=1024, plus=False, batch=128, block=True,
                         fused=True, m_fused=8)
    jst = jsvrg.svrg_init(JF, jg, jnp.zeros(128, jnp.float32),
                          jnp.asarray(gamma), 8, jax.random.PRNGKey(0), jcfg)
    assert jst.canch.shape == SLAB
    st = svrg_state_from_numpy(jst.gamma, jst.m, jst.av, jst.z, jst.z_full,
                               jst.w, jst.it, canch=jst.canch, device="cpu")
    want = np.asarray(JF.coeff_all(jnp.zeros(128, jnp.float32)))
    np.testing.assert_array_equal(st.canch.numpy(), want)
    assert st.m == 8 and st.it == 1 and st.canch.shape == (1024,)
    cfg = SVRGCfg(N=1024, plus=False, batch=128, block=True, fused=True)
    mine = svrg_init(F, g, torch.zeros(128), float(gamma), 8, 0, cfg)
    np.testing.assert_allclose(mine.canch.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

def _lasso6(dtype):
    prob = make_lasso(N=6, n=3, p=2, seed=0, dtype=dtype)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 6.0)
    return prob, F, NormL1(prob.lam)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_svrg_facade_solves_planted_lasso(dtype):
    """tests/test_lasso.py:107-118 with the reference's budgets: SVRG
    (maxit 1000, m = N) and SVRG++ (maxit 16, m = 1) reach cost − f* <
    1e-4 and keep the dtype."""
    prob, F, g = _lasso6(dtype)
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    x, it = SVRG(maxit=1000, gamma=gamma)(torch.zeros(3, dtype=tdt), F=F,
                                          g=g, N=6)
    assert x.dtype == tdt and it == 1000
    assert prob.cost(x.double().numpy()) - prob.f_star < 1e-4
    x, it = SVRG(maxit=16, gamma=gamma, m=1, plus=True)(
        torch.zeros(3, dtype=tdt), F=F, g=g, N=6)
    assert it == 16
    assert prob.cost(x.double().numpy()) - prob.f_star < 1e-4


def test_svrg_block_minibatch_converges():
    """tests/test_ops.py:452: contiguous blocks of 8 rows (beyond the
    reference's batch-1 inner loop) still solve the planted Lasso."""
    prob = make_lasso(N=64, n=16, p=4, seed=0)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 64.0)
    x, _ = SVRG(gamma=float(1.0 / (10.0 * np.max(prob.L))), maxit=400,
                batch=8, block_sampling=True)(
        torch.zeros(16, dtype=torch.float64), F=F, g=NormL1(prob.lam),
        L=prob.L)
    assert prob.cost(x.numpy()) - prob.f_star < 1e-4


def test_svrg_iterator_contract():
    """tests/test_lasso.py:121-134: the iterator aliases x0, its first
    state is the init state (solution == x0, the view z_full), and
    maxit = 1 returns x0."""
    prob, F, g = _lasso6(np.float64)
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    x0 = torch.zeros(3, dtype=torch.float64)
    it = SVRG(gamma=gamma).iterator(x0, F=F, g=g, N=6)
    assert it.x0 is x0
    states = list(take(iter(it), 3))
    assert [s.it for s in states] == [1, 2, 3]
    for s in states:
        assert solution(s) is s.z_full and s.z_full.dtype == torch.float64
    np.testing.assert_array_equal(states[0].z_full.numpy(), x0.numpy())
    x1, it1 = SVRG(gamma=gamma, maxit=1)(x0, F=F, g=g, L=prob.L, N=6)
    assert it1 == 1
    np.testing.assert_array_equal(solution(states[0]).numpy(), x1.numpy())
    assert loop(take(iter(it), 4)).it == 4
    assert [s.it for s in halt(iter(it), lambda s: s.it >= 2)] == [1, 2]
    cfg = SVRGCfg(N=6, plus=False)
    nxt = svrg_step(F, g, states[0], cfg)
    np.testing.assert_array_equal(nxt.z_full.numpy(),
                                  states[1].z_full.numpy())
    assert it._rebase_fn(states[1]) is states[1]


def test_svrg_errors_and_warnings():
    """The JAX facade's guards: SVRG++ needs γ, the default γ needs L and
    μ (and warns when Theorem 3.1's ρ < 1 fails), block sampling needs N
    divisible by batch, SVRG++ caps maxit at 25; F=None builds the zero
    oracle, whose anchor gradient is 0."""
    prob, F, g = _lasso6(np.float64)
    x0 = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError, match="SVRG\\+\\+: provide a stepsize"):
        SVRG(plus=True, maxit=2)(x0, F=F, g=g, L=prob.L, mu=0.1)
    with pytest.raises(ValueError, match="smoothness or convexity"):
        SVRG(maxit=2)(x0, F=F, g=g, L=prob.L)
    with pytest.raises(ValueError, match="divisible"):
        SVRG(maxit=2, gamma=0.01, block_sampling=True, batch=4)(
            x0, F=F, g=g)
    xz, _ = SVRG(maxit=2, gamma=0.01)(x0, g=g, N=6)
    np.testing.assert_array_equal(xz.numpy(), x0.numpy())
    with pytest.warns(UserWarning, match="reverted to 25"):
        assert SVRG(maxit=30, gamma=1e-3, plus=True)._effective_maxit() == 25
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert SVRG(maxit=30, gamma=1e-3)._effective_maxit() == 30
        assert SVRG(maxit=25, gamma=1e-3, plus=True)._effective_maxit() == 25
    with pytest.warns(UserWarning, match="convergence condition violated"):
        _, it = SVRG(maxit=2)(x0, F=F, g=g, L=prob.L, mu=1e-6)
    assert it == 2
    for kw in (dict(gamma=-1.0), dict(maxit=0), dict(batch=0), dict(m=0),
               dict(fused_precision="tf32")):
        with pytest.raises(ValueError):
            SVRG(**kw)


def test_svrg_fallback_warning_names_the_facade(monkeypatch):
    """On a CUDA device a block run whose kernel gate is closed warns
    once, naming SVRG (the shared warning of the SAGA facade)."""
    import types

    from ciao_tpu_torch.solvers import saga

    monkeypatch.setattr(runtime, "on_cuda", lambda: True)
    runtime.reset_fallback_warnings()
    x0 = types.SimpleNamespace(device=torch.device("cuda", 0),
                               dtype=torch.float32)
    try:
        with pytest.warns(UserWarning, match="SVRG: this configuration"):
            saga._warn_fallback("SVRG", object(), object(), x0)
    finally:
        runtime.reset_fallback_warnings()
