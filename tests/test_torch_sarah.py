"""The port's SARAH / ProxSARAH against the JAX package on the CPU.

The plain version of kernel #11 (``sarah_multistep_ref``, against the
Pallas kernel in interpret mode), ``sarah_run`` in its three inner modes
(stepwise blocks, iid minibatches, the fused driver on the kernels' plain
versions) on JAX's own schedule, and the facade on the planted Lasso of
``tests/test_sarah.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import sarah as jsarah
from ciao_tpu.solvers.saga import _gen_block_starts
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch.convert import (
    least_squares_from_numpy, sarah_state_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import (
    SARAH, SARAHCfg, sarah_init, sarah_run, sarah_step, solution, take,
)
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
# kernel #11's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

N, n, B, K = 1024, 128, 128, 16
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
CASES = [("f32", "highest", "l1"), ("f32", "default", "l1"),
         ("int8", "highest", "l1"), ("f32", "highest", "zero")]
IDS = ["f32", "f32-default", "int8", "zero"]


@pytest.mark.parametrize("storage,precision,prox", CASES, ids=IDS)
def test_sarah_multistep_ref_matches_pallas(storage, precision, prox):
    """K = 16 recursive steps of the plain version against the Pallas
    kernel in interpret mode on one schedule (repeated blocks included),
    η = 0.7: ww = [w_prev; w] at rtol 1e-4, atol 1e-6, and the estimator
    v, a gradient mean like SVRG's av (entries up to ~600 here), at av's
    rtol 1e-3, atol 1e-4. "default"
    rounds both points of the stacked dot to bf16; JAX's reference is the
    same rows stored bf16 (XLA on the CPU keeps f32 dots exact)."""
    prob = make_lasso(N=N, n=n, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = _jax_oracle(prob, N, storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    rng = np.random.default_rng(7)
    w0 = (0.05 * rng.standard_normal(n)).astype(np.float32)
    ww = np.stack([w0, w0 + 0.01 * rng.standard_normal(n)]).astype(
        np.float32)
    v = np.asarray(JF.grad_sum_all(jnp.asarray(w0)), np.float32) / N
    starts = (rng.integers(0, N // B, K) * B).astype(np.int32)
    gamma = np.float32(1.0 / (2.0 * np.max(prob.L)))
    thr = gamma * prob.lam if prox == "l1" else 0.0
    sc = np.array([N, gamma, thr, 0.7, 1.0 / B, jfb.MODE_LSQ, 0.0],
                  np.float32)
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jww, jv = jfb.sarah_multistep(
            jA, jnp.asarray(np.asarray(JF.b)).reshape(SLAB),
            jnp.asarray(starts), jnp.asarray(ww), jnp.asarray(v)[None],
            jnp.asarray(sc)[None], B, precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB))
    tww, tv = _t(ww), _t(v)
    out = tfb.sarah_multistep(
        _t(np.asarray(JF.A)), _t(np.asarray(JF.b)), _t(starts), tww, tv,
        _t(sc), B, precision=precision, rs=None if rs is None else _t(rs))
    assert out[0] is tww and out[1] is tv  # in place
    assert not np.array_equal(tww.numpy(), ww)
    np.testing.assert_allclose(tww.numpy(), np.asarray(jww), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv)[0], rtol=1e-3,
                               atol=1e-4)


def test_sarah_wrapper_on_cpu_and_shared_memory():
    """CPU tensors take the plain version and count no launch; the
    chunked driver runs every step; a device with no kernel raises; the
    engine's shared memory counts SARAH's two staged points and their two
    sets of margin sums, so at the widest f32 row its ring holds one
    stage where one point's holds two."""
    prob = make_lasso(N=256, n=16, p=3, seed=1, dtype=np.float32)
    A, b = torch.tensor(prob.A), torch.tensor(prob.b)
    starts = torch.tensor([0, 64, 64, 192], dtype=torch.int32)
    sc = torch.tensor([256.0, 1e-4, 1e-5, 1.0, 1 / 64, 0.0, 0.0])
    ww = 0.01 * torch.randn(2, 16, generator=torch.Generator().manual_seed(0))
    v = torch.zeros(16)
    before = tfb.sarah_multistep.launches
    ref = [ww.clone(), v.clone()]
    tfb.sarah_multistep_ref(A, b, starts, *ref, sc, 64)
    got = [ww.clone(), v.clone()]
    assert tfb.sarah_inner_chunked(A, b, *got, sc, 64, starts, 3)[2] == 4
    assert tfb.sarah_multistep.launches == before
    for g_, r_ in zip(got, ref):
        torch.testing.assert_close(g_, r_, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        tfb.sarah_multistep(
            torch.empty((64, 8), device="meta"),
            torch.empty(64, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"),
            torch.empty((2, 8), device="meta"), torch.empty(8, device="meta"),
            torch.empty(7, device="meta"), 16)
    cols = tfb.MAX_COLS
    assert tfb._loopless_grid(4096, cols, 4, 132, 2)[2:] == (1, 1)
    assert tfb._loopless_grid(4096, cols, 4, 132)[2:] == (1, 2)
    for pts in (1, 2):
        _, _, S, P = tfb._loopless_grid(4096, cols, 4, 132, pts)
        assert tfb._loopless_smem_bytes(S, P, cols, 4, pts) <= tfb.SMEM_BYTES
    assert (tfb._loopless_smem_bytes(8, 6, 1024, 4, 2)
            - tfb._loopless_smem_bytes(8, 6, 1024, 4)) == 4 * 1024 + 4 * 8 * 8


# ---------------------------------------------------------------------------
# sarah_run against JAX on JAX's schedule
# ---------------------------------------------------------------------------

def _jax_schedules(key, m, steps, cfg, iid=False):
    """JAX's inner schedule: per outer step ``key, sub = split(key)``;
    block starts ``_gen_block_starts(sub, 0, cfg, m)``, or the iid
    minibatch ``randint(fold_in(sub, k), (B,))`` of inner step k."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        if iid:
            out.append(np.stack([np.asarray(jax.random.randint(
                jax.random.fold_in(sub, k), (cfg.batch,), 0, cfg.N,
                dtype=jnp.int32)) for k in range(m)]).astype(np.int64))
        else:
            out.append(np.array(_gen_block_starts(sub, 0, cfg, m)))
    return out


def _spy(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tfb, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tfb, name, spy)
    return calls


@pytest.mark.parametrize("mode", ["block", "iid", "fused"])
@pytest.mark.parametrize("m,eta", [(24, 1.0), (70, 0.7)],
                         ids=["m24-eta1", "m70-eta0.7"])
def test_sarah_run_matches_jax(mode, m, eta, monkeypatch):
    """Three outer steps (tests/test_sarah.py:175's problem, N = 1,024,
    n = 128, B = 128) of plain SARAH (η = 1) and ProxSARAH (η = 0.7).
    fused: JAX's Pallas kernels in interpret mode (and its stepwise
    remainder past 64 steps) against the port's fused driver: per outer
    step one kernel #6 bootstrap and one launch of kernel #11 for every
    inner step."""
    Np, B_ = 1024, 128
    prob = make_lasso(N=Np, n=128, p=4, seed=3, dtype=np.float32)
    JF = _jax_oracle(prob, Np)
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    F, g = _port_oracle(JF), NormL1(torch.tensor(prob.lam))
    gamma = np.float32(1.0 / (2.0 * np.max(prob.L)))
    key = jax.random.PRNGKey(5)
    x0 = np.zeros(128, np.float32)
    block = mode != "iid"
    jcfg = jsarah.SARAHCfg(N=Np, batch=B_, m=m, block=block,
                           fused=mode == "fused")
    jst0 = jsarah.sarah_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma),
                             jnp.asarray(eta, jnp.float32), key, jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jsarah.sarah_run(JF, jg, jst0, jcfg, 3)
    sched = _jax_schedules(key, m, 3, jcfg, iid=not block)
    calls = _spy(monkeypatch, ["sarah_multistep", "coeff_apply_all"])
    cfg = SARAHCfg(N=Np, batch=B_, m=m, block=block, fused=mode == "fused")
    st0 = sarah_state_from_numpy(jst0.gamma, jst0.eta, jst0.x_tilde,
                                 jst0.it, device="cpu")
    mine = sarah_init(F, g, _t(x0), gamma, eta, 0, cfg)
    assert float(mine.gamma) == float(st0.gamma) and mine.it == st0.it
    st = sarah_run(F, g, st0, cfg, 3,
                   **(dict(starts=sched) if block else dict(idx=sched)))
    np.testing.assert_allclose(st.x_tilde.numpy(), np.asarray(jst.x_tilde),
                               rtol=1e-4, atol=1e-6,
                               err_msg=f"{mode} m={m} eta={eta}")
    assert st.it == int(jst.it) == 4
    want = 3 if mode == "fused" else 0
    assert calls == {"sarah_multistep": want, "coeff_apply_all": want}


# ---------------------------------------------------------------------------
# the facade (tests/test_sarah.py's cases)
# ---------------------------------------------------------------------------

Nf, nf = 64, 8


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=Nf, n=nf, p=3, seed=3)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         float(Nf))
    return prob, F, NormL1(prob.lam)


def _x0():
    return torch.zeros(nf, dtype=torch.float64)


def test_sarah_facade_converges_in_each_mode(lasso):
    """Default γ = 1/(2 L_max) and m = N, contiguous blocks of 8 with
    m = N, and ProxSARAH's η = 0.7 reach cost − f* < 1e-4 in
    tests/test_sarah.py's budgets, keeping f64."""
    prob, F, g = lasso
    for kw, maxit in ((dict(), 30),
                      (dict(batch=8, block_sampling=True, m=Nf), 30),
                      (dict(eta=0.7), 40)):
        x, it = SARAH(maxit=maxit, **kw)(_x0(), F=F, g=g, L=prob.L)
        assert it == maxit and x.dtype == torch.float64, kw
        assert prob.cost(x.numpy()) - prob.f_star < 1e-4, kw


def test_sarah_fused_facade_on_the_cpu_matches_stepwise(lasso, monkeypatch):
    """With the kernel gate opened for CPU tensors the facade routes a
    block run to the fused driver (kernel #11's and #6's plain versions)
    on f32 rows: the stepwise block run's solution on the same draws,
    one launch of each wrapper per outer step."""
    prob, _, _ = lasso
    F = LeastSquaresRows(torch.tensor(prob.A, dtype=torch.float32),
                         torch.tensor(prob.b, dtype=torch.float32),
                         float(Nf))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    solver = SARAH(maxit=6, batch=8, block_sampling=True, eta=0.8)
    xs, _ = solver(torch.zeros(nf), F=F, g=g, L=prob.L)
    monkeypatch.setattr(tfb, "svrg_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)
    calls = _spy(monkeypatch, ["sarah_multistep", "coeff_apply_all"])
    xf, it = solver(torch.zeros(nf), F=F, g=g, L=prob.L)
    assert it == 6 and calls == {"sarah_multistep": 5, "coeff_apply_all": 5}
    np.testing.assert_allclose(xf.numpy(), xs.numpy(), rtol=1e-4, atol=1e-6)


def test_sarah_iterator_invariants(lasso):
    """solution(init) == x0 (no gradient work at init), the iterator's
    k-th state is a maxit = k solve, the solution is the view x̃, rebase
    is the identity."""
    prob, F, g = lasso
    solver = SARAH(maxit=5)
    it = solver.iterator(_x0(), F=F, g=g, L=prob.L)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(states[0].solution.numpy(), _x0().numpy())
    assert solution(states[3]) is states[3].x_tilde
    x_batch, _ = solver(_x0(), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(states[-1].solution.numpy(),
                                  x_batch.numpy())
    nxt = sarah_step(F, g, states[0], SARAHCfg(N=Nf, m=Nf))
    np.testing.assert_array_equal(nxt.x_tilde.numpy(),
                                  states[1].x_tilde.numpy())
    assert it._rebase_fn(states[1]) is states[1]


def test_sarah_refusals(lasso):
    """tests/test_sarah.py's refusals as ValueError (JAX asserts): η
    outside (0, 1], γ ≤ 0, precision; L and γ both missing, block
    sampling with N not divisible by batch, m < 1; complex iterates name
    their ROADMAP item. An explicit γ needs no L; F=None is the zero
    oracle."""
    prob, F, g = lasso
    for kw in (dict(eta=0.0), dict(eta=1.5), dict(gamma=0.0),
               dict(fused_precision="tf32"), dict(freq=0)):
        with pytest.raises(ValueError):
            SARAH(**kw)
    with pytest.raises(ValueError, match="divisible"):
        SARAH(maxit=2, batch=7, block_sampling=True)(_x0(), F=F, g=g,
                                                     L=prob.L)
    with pytest.raises(ValueError, match="smoothness"):
        SARAH(maxit=2)(_x0(), F=F, g=g)
    with pytest.raises(ValueError, match="m must be"):
        SARAH(maxit=2, m=0)(_x0(), F=F, g=g, L=prob.L)
    xc, _ = SARAH(maxit=3)(torch.zeros(nf, dtype=torch.complex128), F=F,
                       g=g, L=prob.L)
    xr, _ = SARAH(maxit=3)(_x0(), F=F, g=g, L=prob.L)
    assert xc.dtype == torch.complex128
    np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-12,
                               atol=1e-14)
    _, it = SARAH(maxit=2, gamma=1e-3)(_x0(), F=F, g=g)
    assert it == 2
    x, _ = SARAH(maxit=3, gamma=1e-3)(_x0(), g=g, N=Nf)
    np.testing.assert_array_equal(x.numpy(), _x0().numpy())
