"""The port's SAGA slice against the JAX package, end to end.

One planted Lasso goes through JAX's ``saga_init`` + ``saga_run`` (the
fused multistep path, its Pallas kernel in TPU interpret mode) and the
port's ``saga_init`` + ``saga_run`` (the multistep path on the plain
version of the kernel), with JAX's own block schedule handed to the port
as ``starts``. Tolerances follow ``tests/test_ops.py``'s fused-vs-
stepwise suite: z rtol 1e-4; av and c rtol 1e-3 for f32 rows, and for
int8 rows (bf16-rounded dot operands) atols scaled by the largest entry.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu.monitor import objective as jobjective
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch import runtime
from ciao_tpu_torch.convert import least_squares_from_numpy, saga_state_from_numpy
from ciao_tpu_torch.monitor import fixed_point_residual, objective
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers import (
    SAG, SAGA, SAGACfg, Status, block_starts, halt, importance_draws, loop,
    saga_init, saga_rebase, saga_run, saga_step, solution, take,
)

Np, npix, Bp = 1024, 128, 128


def _jax_problem(storage):
    prob = make_lasso(N=Np, n=npix, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(Np), jnp.float32))
    if storage != "f32":
        JF = JF.with_storage(storage)
    return prob, JF


def _port_oracle(JF):
    return least_squares_from_numpy(
        np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
        None if JF.row_scale is None else np.asarray(JF.row_scale))


def _close_state(t, j, storage, tag):
    """z rtol 1e-4; av, c as tests/test_ops.py for f32 and int8 rows."""
    np.testing.assert_allclose(t.z.numpy(), np.asarray(j.z), rtol=1e-4,
                               atol=1e-6, err_msg=tag)
    js, jav = np.asarray(j.s), np.asarray(j.av)
    av_atol = 1e-4 if storage == "f32" else 1e-5 * float(np.abs(jav).max())
    c_atol = 1e-3 if storage == "f32" else 1e-4 * float(np.abs(js).max())
    np.testing.assert_allclose(t.av.numpy(), jav, rtol=1e-3, atol=av_atol,
                               err_msg=tag)
    np.testing.assert_allclose(t.s.numpy(), js, rtol=1e-3, atol=c_atol,
                               err_msg=tag)


@pytest.mark.parametrize("storage,steps,sag", [
    ("f32", 96, False), ("f32", 77, False), ("int8", 96, False),
    ("int8", 77, False), ("f32", 96, True), ("f32", 150, False),
], ids=["f32-96", "f32-77", "int8-96", "int8-77", "f32-96-sag",
        "f32-150-remainder"])
def test_slice_matches_jax(storage, steps, sag):
    """saga_init → saga_run, fused, against JAX on one schedule. 150
    steps run one 128-step launch and a 22-step stepwise remainder."""
    prob, JF = _jax_problem(storage)
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gamma = np.float32(1.0 / ((16.0 if sag else 3.0) * np.max(prob.L)))
    key = jax.random.PRNGKey(5)
    jcfg = jsaga.SAGACfg(N=Np, sag=sag, batch=Bp, block=True, coeff=True,
                         fused=True)
    x0 = np.zeros(npix, np.float32)
    jst0 = jsaga.saga_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key,
                           jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jsaga.saga_run(JF, jg, jst0, jcfg, steps)
    starts = np.asarray(jsaga._gen_block_starts(key, 1, jcfg, steps))

    F, g = _port_oracle(JF), NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    cfg = SAGACfg(N=Np, sag=sag, batch=Bp, block=True, coeff=True, fused=True)
    st0 = saga_init(F, g, torch.tensor(x0), torch.tensor(gamma), 0, cfg)
    _close_state(st0, jst0, storage, "init")
    st = saga_run(F, g, st0, cfg, steps, starts=torch.tensor(starts))
    assert st.it == int(jst.it) == steps + 1
    assert st.z.dtype == st.s.dtype == st.av.dtype == torch.float32
    _close_state(st, jst, storage, f"{storage} steps={steps}")
    # the run copied the table: the init state is unchanged
    np.testing.assert_array_equal(st0.z.numpy(), np.asarray(jst0.z))


def test_fused_path_matches_stepwise_port():
    """Within the port: the multistep path (two 64-step launches of
    the plain kernel version and a remainder) and the stepwise path give
    the same trajectory on one schedule, to f32 rounding."""
    prob = make_lasso(N=512, n=32, p=3, seed=1, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 512.0)
    g = NormL1(prob.lam)
    gamma = torch.tensor(1.0 / (3.0 * np.max(prob.L)), dtype=torch.float32)
    x0 = torch.zeros(32)
    cfg = SAGACfg(N=512, sag=False, batch=64, block=True, coeff=True)
    st0 = saga_init(F, g, x0, gamma, 11, cfg)
    steps = 140
    starts = block_starts(11, 1, steps, 512 // 64, 64, "cpu")
    a = saga_run(F, g, st0, cfg, steps, starts=starts)
    b = saga_run(F, g, st0, cfg._replace(fused=True), steps, starts=starts)
    c = saga_run(F, g, st0, cfg._replace(fused=True), steps)  # own draws
    assert a.it == b.it == c.it == steps + 1
    np.testing.assert_allclose(b.z.numpy(), a.z.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(c.z.numpy(), a.z.numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.s.numpy(), a.s.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_saga_rebase_matches_jax():
    """A state carried over from JAX (its table in the (8, N/8) slab
    layout) and rebased under int8 rows gives JAX's av."""
    prob, JF = _jax_problem("f32")
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gamma = np.float32(1.0 / (3.0 * np.max(prob.L)))
    jcfg = jsaga.SAGACfg(N=Np, sag=False, batch=Bp, block=True, coeff=True)
    jst = jsaga.saga_run(JF, jg, jsaga.saga_init(
        JF, jg, jnp.zeros(npix, jnp.float32), jnp.asarray(gamma),
        jax.random.PRNGKey(1), jcfg), jcfg, 20)
    JFq = JF.with_storage("int8")
    jre = jsaga.saga_rebase(JFq, jst, jcfg)

    st = saga_state_from_numpy(np.asarray(jst.s).reshape(8, Np // 8),
                               np.asarray(jst.z), np.asarray(jst.av),
                               np.asarray(jst.gamma), int(jst.it))
    np.testing.assert_array_equal(st.s.numpy(), np.asarray(jst.s))
    assert st.it == 21 and st.status == Status.RUNNING
    cfg = SAGACfg(N=Np, sag=False, batch=Bp, block=True, coeff=True)
    re = saga_rebase(_port_oracle(JFq), st, cfg)
    np.testing.assert_allclose(re.av.numpy(), np.asarray(jre.av), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jre.av).max()))
    assert re.z is st.z and re.s is st.s


def test_objective_matches_jax():
    prob, JF = _jax_problem("int8")
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    x = np.random.default_rng(0).standard_normal(npix).astype(np.float32)
    want = float(jobjective(JF, jg, jnp.asarray(x)))
    got = objective(_port_oracle(JF), NormL1(prob.lam), torch.tensor(x))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    r = fixed_point_residual(torch.zeros(3), torch.tensor([3.0, 4.0, 0.0]),
                             0.5)
    assert float(r) == 10.0


def _lasso6(dtype=np.float64):
    prob = make_lasso(N=6, n=3, p=2, seed=0, dtype=dtype)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 6.0)
    return prob, F, NormL1(prob.lam)


@pytest.fixture
def lasso6():
    return _lasso6()


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_saga_facade_solves_planted_lasso(dtype):
    """The reference's acceptance problem (tests/test_lasso.py): SAGA
    with the reference's budget reaches cost − f* < 1e-4."""
    prob, F, g = _lasso6(dtype)
    dtype = torch.from_numpy(np.zeros(1, dtype)).dtype
    x, it = SAGA(maxit=1000)(torch.zeros(3, dtype=dtype), F=F, g=g,
                             L=prob.L)
    assert x.dtype == dtype and it == 1000
    assert prob.cost(x.double().numpy()) - prob.f_star < 1e-4
    x2, _ = SAGA(maxit=1000, gamma=1.0 / (3 * float(np.max(prob.L))))(
        torch.zeros(3, dtype=dtype), F=F, g=g, N=6)
    assert prob.cost(x2.double().numpy()) - prob.f_star < 1e-4


def test_sag_facade_solves_planted_lasso(lasso6):
    prob, F, g = lasso6
    x, _ = SAG(maxit=10000)(torch.zeros(3, dtype=torch.float64), F=F, g=g,
                            L=prob.L)
    assert prob.cost(x.numpy()) - prob.f_star < 1e-4


def test_block_sampling_facade_solves_planted_lasso():
    """Block sampling through the facade (the stepwise path on the CPU)
    on a wider planted Lasso. The observer sees the init state and the
    state after each chunk of freq steps, as in the JAX package."""
    prob = make_lasso(N=64, n=8, p=2, seed=2, well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 64.0)
    seen = []
    x, it = SAGA(maxit=3000, block_sampling=True, batch=8, freq=1000)(
        torch.zeros(8, dtype=torch.float64), F=F, g=NormL1(prob.lam),
        L=prob.L, observe=lambda i, s: seen.append(i))
    assert seen == [1, 1001, 2001, 3000] and it == 3000
    assert prob.cost(x.numpy()) - prob.f_star < 1e-4


def test_iterator_and_init_equivalence(lasso6):
    prob, F, g = lasso6
    gamma = 1.0 / (3 * float(np.max(prob.L)))
    x0 = torch.zeros(3, dtype=torch.float64)
    it = SAGA(gamma=gamma).iterator(x0, F=F, g=g, N=6)
    assert it.x0 is x0
    states = list(take(iter(it), 3))
    assert [s.it for s in states] == [1, 2, 3]
    assert solution(states[0]) is states[0].z
    x1, n1 = SAGA(gamma=gamma, maxit=1)(x0, F=F, g=g, N=6)
    assert n1 == 1
    np.testing.assert_array_equal(states[0].z.numpy(), x1.numpy())
    last = loop(take(iter(it), 5))
    assert last.it == 5
    stop = list(halt(iter(it), lambda s: s.it >= 4))
    assert [s.it for s in stop] == [1, 2, 3, 4]
    st = saga_step(F, g, states[0], SAGACfg(N=6, sag=False, coeff=True))
    np.testing.assert_array_equal(st.z.numpy(), states[1].z.numpy())


def test_unported_options_raise(lasso6):
    """Options of the JAX facade that the port once left out now run: the
    full (N, n) table gives the coefficient table's trajectory (the
    compression is exact, tests/test_ops.py:119), a full-table init holds
    the (N, n) gradients, ``F=None`` builds the zero oracle (and without
    N raises JAX's "provide F or N"); the importance-sampling guards
    raise as JAX's do."""
    prob, F, g = lasso6
    x0 = torch.zeros(3, dtype=torch.float64)
    xf, _ = SAGA(maxit=300, table="full")(x0, F=F, g=g, L=prob.L)
    xc, _ = SAGA(maxit=300)(x0, F=F, g=g, L=prob.L)
    np.testing.assert_allclose(xf.numpy(), xc.numpy(), rtol=1e-12,
                               atol=1e-12)
    # importance sampling is ported; its guards are JAX's
    with pytest.raises(ValueError, match="SAGA only"):
        SAG(maxit=10, importance_sampling=True, block_sampling=True,
            batch=2)(x0, F=F, g=g, L=prob.L)
    with pytest.raises(ValueError, match="block_sampling=True"):
        SAGA(maxit=10, importance_sampling=True)(x0, F=F, g=g, L=prob.L)
    with pytest.raises(ValueError, match="provide L"):
        SAGA(maxit=10, importance_sampling=True, block_sampling=True,
             batch=2, gamma=0.1)(x0, F=F, g=g)
    st = saga_init(F, g, x0, 0.1, 0, SAGACfg(N=6, sag=False))
    np.testing.assert_allclose(st.s.numpy(), F.grad_all(x0).numpy())
    x, it = SAGA(maxit=10)(torch.ones(3, dtype=torch.float64), g=g, N=6,
                           L=prob.L)
    assert it == 10 and bool(torch.isfinite(x).all())
    with pytest.raises(ValueError, match="provide F or N"):
        SAGA(maxit=10)(x0, g=g, L=prob.L)
    with pytest.raises(ValueError, match="provide L"):
        SAGA(maxit=10)(x0, F=F, g=g)
    with pytest.raises(ValueError, match="divisible"):
        SAGA(maxit=10, block_sampling=True, batch=4)(x0, F=F, g=g, L=prob.L)


@pytest.mark.parametrize("kw", [
    dict(gamma=-1.0), dict(maxit=0), dict(batch=0), dict(freq=0),
    dict(fused_precision="tf32"), dict(table="rows"),
])
def test_facade_rejects_bad_settings(kw):
    with pytest.raises(ValueError):
        SAGA(**kw)


def test_explicit_starts_are_checked(lasso6):
    prob, F, g = lasso6
    cfg = SAGACfg(N=6, sag=False, batch=2, block=True, coeff=True)
    st = saga_init(F, g, torch.zeros(3, dtype=torch.float64), 0.01, 0, cfg)
    with pytest.raises(ValueError, match="shape"):
        saga_run(F, g, st, cfg, 3, starts=[0, 2])
    with pytest.raises(ValueError, match="multiples"):
        saga_run(F, g, st, cfg, 2, starts=[0, 1])
    with pytest.raises(ValueError, match="multiples"):
        saga_run(F, g, st, cfg, 2, starts=[0, 6])
    with pytest.raises(ValueError, match="block sampling"):
        saga_run(F, g, st, cfg._replace(block=False), 2, starts=[0, 2])
    assert saga_run(F, g, st, cfg, 2, starts=[4, 0]).it == 3


def test_block_starts_uniform_and_stateless():
    """The port's own schedule: block-aligned, a pure function of
    (seed, it) (any window of it reproduces the same draws), different
    across seeds, and uniform over the d blocks: a chi-square statistic
    over 16,000 draws in 16 blocks under its 0.999 quantile (37.70 at 15
    degrees of freedom)."""
    d, B, k = 16, 32, 16_000
    s = block_starts(7, 1, k, d, B, "cpu")
    assert s.dtype == torch.int32 and s.shape == (k,)
    assert bool((s % B == 0).all()) and int(s.min()) >= 0
    assert int(s.max()) <= (d - 1) * B
    counts = np.bincount(s.numpy() // B, minlength=d)
    chi2 = float(((counts - k / d) ** 2 / (k / d)).sum())
    assert chi2 < 37.70, counts
    torch.testing.assert_close(block_starts(7, 101, 50, d, B, "cpu"),
                               s[100:150], rtol=0, atol=0)
    other = block_starts(8, 1, k, d, B, "cpu")
    assert float((other == s).float().mean()) < 0.2
    # consecutive draws are not correlated: pairs (s_t, s_t+1) spread too
    pairs = np.bincount((s[:-1] // B * d + s[1:] // B).numpy(),
                        minlength=d * d)
    assert pairs.min() > 0


def test_fallback_warning_is_silent_without_cuda():
    """The one-time warning speaks only on a CUDA device: CPU runs are
    expected to take the stepwise path."""
    assert runtime.on_cuda() == torch.cuda.is_available()
    if runtime.on_cuda():
        pytest.skip("checks the CPU behaviour")
    runtime.reset_fallback_warnings()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        runtime.warn_fused_fallback("SAGA", "reason", "remedy")
        with runtime.expected_fallback():
            runtime.warn_fused_fallback("SAGA", "reason", "remedy")
    assert not runtime._FALLBACK_WARNED


def test_fallback_warning_once_per_reason(monkeypatch):
    """With a CUDA device the warning fires once per (facade, reason),
    and not at all inside expected_fallback()."""
    monkeypatch.setattr(runtime, "on_cuda", lambda: True)
    runtime.reset_fallback_warnings()
    with runtime.expected_fallback():
        runtime.warn_fused_fallback("SAGA", "r1", "fix")
    with pytest.warns(UserWarning, match="stepwise PyTorch path.*r1.*fix"):
        runtime.warn_fused_fallback("SAGA", "r1", "fix")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        runtime.warn_fused_fallback("SAGA", "r1", "fix")
    runtime.reset_fallback_warnings()


def test_port_imports_no_jax():
    """The port never imports JAX: a fresh interpreter that imports every
    module of the package has no jax in sys.modules. (This process
    already has jax, through tests/conftest.py.)"""
    code = "\n".join([
        "import sys",
        "import ciao_tpu_torch",
        "import ciao_tpu_torch.convert, ciao_tpu_torch.monitor",
        "import ciao_tpu_torch.ops, ciao_tpu_torch.ops._build",
        "import ciao_tpu_torch.runtime, ciao_tpu_torch.solvers.saga",
        "import ciao_tpu_torch.sampling, ciao_tpu_torch.solvers.deep",
        "import ciao_tpu_torch.solvers.polish, ciao_tpu_torch.solvers.staged",
        "import ciao_tpu_torch.utils.problems, ciao_tpu_torch.solvers.proshi",
        "import ciao_tpu_torch.solvers.deep_sharing, ciao_tpu_torch.oracles",
        "import ciao_tpu_torch.oracles.sparse, ciao_tpu_torch.solvers.deep_pd",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ciao_tpu'))",
        "assert not bad, bad",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_package_surface():
    import ciao_tpu_torch as ct

    for name in ("SAGA", "SAG", "LeastSquaresRows", "NormL1", "Zero",
                 "Status", "solution", "take", "loop", "halt", "deep_solve",
                 "DeepSolveInfo", "staged_saga", "StagedInfo", "fista_polish",
                 "power_lmax", "lsq_power_lmax", "grad_mean_chunked",
                 "Proshi", "deep_solve_sharing", "DeepSharingInfo",
                 "iterator", "IndBox", "DiagQuadratic", "DenseQuadratic",
                 "SqrDistBox", "SumOracle", "ZeroOracle", "proshi_resync",
                 "sharing_objective", "deep_solve_pd", "DeepPDInfo",
                 "tv_refine", "tv_refine3"):
        assert hasattr(ct, name), name
    assert Zero().prox_only(torch.ones(2), 0.1).tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# the streamed driver and importance sampling
# ---------------------------------------------------------------------------

NS, BS = 8192, 128  # d = 64 blocks, as tests/test_ops.py's streamed suite


def _streamed_problem(storage, seed=3):
    prob = make_lasso(N=NS, n=npix, p=4, seed=seed, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(NS), jnp.float32))
    if storage != "f32":
        JF = JF.with_storage(storage)
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    return prob, JF, jg, _port_oracle(JF), g


class _Spy:
    """Counts the calls of a kernel wrapper that a driver makes."""

    def __init__(self, monkeypatch, name):
        from ciao_tpu_torch.ops import fused_block

        self.fn, self.calls = getattr(fused_block, name), []
        monkeypatch.setattr(fused_block, name, self)

    def __call__(self, *args, **kw):
        self.calls.append((args[2].shape[0], kw.get("wgts") is not None,
                           kw.get("f")))
        return self.fn(*args, **kw)


@pytest.mark.parametrize("storage,steps", [
    ("f32", 77), ("f32", 96), ("int8", 77), ("int8", 96), ("f32", 150),
], ids=["f32-77", "f32-96", "int8-77", "int8-96", "f32-150-remainder"])
def test_streamed_driver_matches_jax(storage, steps, monkeypatch):
    """The port's streamed driver (launches of the plain version of kernel
    #4, no clamp) against JAX's ``saga_run`` with ``fused_stream=True``
    (clamped launches of the Pallas kernel, interpret mode on the CPU),
    JAX's block schedule handed over as ``starts``. Tolerances as
    tests/test_ops.py's streamed suite (_close_state). 150 steps are one
    128-step launch and a 22-step stepwise remainder."""
    prob, JF, jg, F, g = _streamed_problem(storage)
    gamma = np.float32(1.0 / (3.0 * np.max(prob.L)))
    key = jax.random.PRNGKey(5)
    jcfg = jsaga.SAGACfg(N=NS, sag=False, batch=BS, block=True, coeff=True,
                         fused_stream=True)
    x0 = np.zeros(npix, np.float32)
    jst = jsaga.saga_run(JF, jg, jsaga.saga_init(
        JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key, jcfg), jcfg, steps)
    starts = np.asarray(jsaga._gen_block_starts(key, 1, jcfg, steps))

    spy = _Spy(monkeypatch, "saga_coeff_multistep_streamed")
    cfg = SAGACfg(N=NS, sag=False, batch=BS, block=True, coeff=True,
                  fused_stream=True)
    st0 = saga_init(F, g, torch.tensor(x0), torch.tensor(gamma), 0, cfg)
    st = saga_run(F, g, st0, cfg, steps, starts=torch.tensor(starts))
    assert spy.calls == [(min(steps, 128), False, None)]
    assert st.it == int(jst.it) == steps + 1
    _close_state(st, jst, storage, f"{storage} steps={steps}")
    np.testing.assert_array_equal(st0.z.numpy(), np.zeros(npix, np.float32))


def _importance_cfgs(prob, K):
    """JAX's iid and systematic (istrat, window K) importance set-ups of
    tests/test_importance.py, as (qcum, qinv, γ) in f32."""
    from ciao_tpu.sampling import clip_block_distribution as jclip

    d = NS // BS
    Lblk = np.max(np.asarray(prob.L, np.float64).reshape(d, BS), axis=1)
    q = Lblk / Lblk.sum()
    qcum = np.cumsum(q)
    qcum /= qcum[-1]
    iid = (qcum, 1.0 / (d * q), 1.0 / (3.0 * np.max(Lblk / (d * q))))
    qt, _ = jclip(q, K)
    pcum = np.cumsum(K * qt)
    pcum *= K / pcum[-1]
    pcum[-1] = K
    strat = (pcum, 1.0 / (d * qt), 1.0 / (3.0 * np.max(Lblk / (d * qt))))
    return [tuple(np.float32(a) if np.ndim(a) == 0 else a.astype(np.float32)
                  for a in t) for t in (iid, strat)]


@pytest.mark.parametrize("istrat", [False, True], ids=["iid", "istrat"])
def test_importance_parity_with_jax(istrat, monkeypatch):
    """JAX's importance draws (``_gen_importance_draws``: starts and
    1/(d·q_j) weights, iid or systematic) fed to the port as explicit
    ``starts``/``wgts``: iid through the resident driver against JAX's
    stepwise path, istrat (window 16) through the streamed driver —
    window-aligned launches after 15 stepwise steps, and a stepwise tail
    — against JAX's streamed driver. 77 steps; z rtol 1e-4, c and av as
    the streamed suite."""
    prob, JF, jg, F, g = _streamed_problem("f32", seed=0)
    K = 16
    qcum, qinv, gamma = _importance_cfgs(prob, K)[int(istrat)]
    key = jax.random.PRNGKey(5)
    jcfg = jsaga.SAGACfg(N=NS, sag=False, batch=BS, block=True, coeff=True,
                         importance=True, istrat=istrat, iwin=K,
                         fused_stream=istrat)
    x0 = np.zeros(npix, np.float32)
    jq, ji = jnp.asarray(qcum), jnp.asarray(qinv)
    jst = jsaga.saga_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key,
                          jcfg)._replace(qcum=jq, qinv=ji)
    jst = jsaga.saga_run(JF, jg, jst, jcfg, 77)
    starts, wgts = map(np.asarray, jsaga._gen_importance_draws(
        key, 1, jcfg, jq, ji, 77))
    assert np.all(wgts > 0) and len(np.unique(starts)) > 1

    name = ("saga_coeff_multistep_streamed" if istrat
            else "saga_coeff_multistep")
    spy = _Spy(monkeypatch, name)
    cfg = SAGACfg(N=NS, sag=False, batch=BS, block=True, coeff=True,
                  importance=True, istrat=istrat, iwin=K,
                  fused_stream=istrat, fused=not istrat)
    st = saga_init(F, g, torch.tensor(x0), torch.tensor(gamma), 0,
                   cfg)._replace(qcum=torch.tensor(qcum),
                                 qinv=torch.tensor(qinv))
    st = saga_run(F, g, st, cfg, 77, starts=torch.tensor(starts),
                  wgts=torch.tensor(wgts))
    if istrat:   # steps 1..15 stepwise, windows 16..63, steps 64..77
        assert spy.calls == [(16, True, None)] * 3
    else:
        assert spy.calls == [(77, True, None)]
    assert st.it == int(jst.it) == 78
    _close_state(st, jst, "f32", f"istrat={istrat}")


def _route_gate(monkeypatch):
    """Open the kernels' gate for CPU tensors (shape conditions only), so
    that the facade's routing can be held to JAX's on the CPU; the
    kernels' wrappers then run their plain versions."""
    from ciao_tpu_torch.ops import fused_block

    monkeypatch.setattr(fused_block, "saga_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)


@pytest.mark.parametrize("route", ["stepwise", "resident", "streamed",
                                   "streamed-by-threshold"])
def test_facade_importance_setup_matches_jax(route, monkeypatch):
    """The facade's importance set-up — host-f64 q, clip and π-scale CDF
    under the systematic schedule, qinv and γ from L_eff — against JAX's
    ``SAGA._setup`` on the same route. JAX routes through its TPU gates
    (``on_tpu`` patched, as tests/test_importance.py does); the port's
    gate is opened for CPU tensors. N = 8,320 (d = 65) closes JAX's
    resident gates and opens its streamed ones: the port keeps JAX's
    schedule (istrat, window 64) on its resident kernel, as N ≤
    ``RESIDENT_MAX_ROWS``. At N = 8,192 a lower ``RESIDENT_MAX_ROWS``
    (JAX: a closed slab gate) forces the streamed route in both."""
    import ciao_tpu
    from ciao_tpu import runtime as jruntime
    from ciao_tpu_torch.solvers import saga as tsaga

    Nr = 8320 if route == "streamed" else NS
    prob = make_lasso(N=Nr, n=npix, p=4, seed=0, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(Nr), jnp.float32))
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    if route != "stepwise":
        monkeypatch.setattr(jruntime, "on_tpu", lambda: True)
        _route_gate(monkeypatch)
    if route == "streamed-by-threshold":
        monkeypatch.setattr(ciao_tpu.ops, "coeff_multistep_available",
                            lambda *a: False)
        monkeypatch.setattr(tsaga, "RESIDENT_MAX_ROWS", NS // 2)
    _, _, _, jcfg, jinit = ciao_tpu.SAGA(
        maxit=1, block_sampling=True, batch=BS, importance_sampling=True,
    )._setup(jnp.zeros(npix, jnp.float32), JF, jg, L=prob.L, N=Nr)
    _, _, _, cfg, init = SAGA(
        maxit=1, block_sampling=True, batch=BS, importance_sampling=True,
    )._setup(torch.zeros(npix), _port_oracle(JF),
             NormL1(torch.tensor(prob.lam)), prob.L, Nr)
    assert (cfg.fused, cfg.fused_stream) == (
        route in ("resident", "streamed"), route == "streamed-by-threshold")
    assert (jcfg.fused, jcfg.fused_stream) == (
        route == "resident", route.startswith("streamed"))
    assert (cfg.istrat, cfg.iwin) == (jcfg.istrat, jcfg.iwin)
    assert cfg.istrat == route.startswith("streamed")
    jst, st = jinit(), init()
    for name in ("qcum", "qinv", "gamma"):
        got, want = getattr(st, name), np.asarray(getattr(jst, name))
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    if cfg.istrat:
        pi = np.diff(np.concatenate([[0.0], st.qcum.double().numpy()]))
        assert float(st.qcum[-1]) == cfg.iwin and pi.max() <= 1.0 + 1e-6


def test_facade_routes_as_jax(monkeypatch):
    """The facade's route with the gate open: every block-sampling run
    takes a kernel, the resident one for N ≤ RESIDENT_MAX_ROWS, else the
    streamed one, with no warning; the importance schedule is JAX's:
    systematic (istrat) where JAX takes its streamed route (not N ≤
    RESIDENT_MAX_ROWS in multiples of 8·B, and d ≥ 64), iid elsewhere,
    including d < 64, where JAX runs stepwise. On the CPU (gate closed)
    the run is stepwise with iid draws."""
    import warnings

    from ciao_tpu_torch.solvers import saga as tsaga

    def route(N, B):
        F = LeastSquaresRows(torch.zeros(N, 4), torch.zeros(N), 1.0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cfg = SAGA(maxit=1, block_sampling=True, batch=B,
                       importance_sampling=True)._setup(
                torch.zeros(4), F, NormL1(0.1), torch.ones(N), N)[3]
        return cfg.fused, cfg.fused_stream, cfg.istrat

    assert route(8192, 128) == (False, False, False)  # the CPU: gate closed
    _route_gate(monkeypatch)
    assert tsaga.RESIDENT_MAX_ROWS == 1 << 20
    assert tsaga.STREAM_MIN_BLOCKS == 64
    assert route(8192, 128) == (True, False, False)
    assert route(8320, 128) == (True, False, True)
    assert route(4224, 128) == (True, False, False)  # d = 33 < 64
    monkeypatch.setattr(tsaga, "RESIDENT_MAX_ROWS", 4096)
    assert route(8192, 128) == (False, True, True)
    assert route(4224, 128) == (False, True, False)


@pytest.mark.parametrize("kernel", ["resident", "streamed"])
def test_facade_importance_streamed_end_to_end(kernel, monkeypatch):
    """SAGA(importance_sampling=True) on JAX's streamed route as a user
    calls it (gate opened for CPU tensors): it launches whole windows of
    K = 64 systematic steps with weights, and the objective falls.
    N = 8,320 rows of B = 128 (d = 65) take JAX's streamed route; the
    port runs them on its resident kernel (N ≤ RESIDENT_MAX_ROWS), or on
    its streamed kernel when the threshold is lowered under N."""
    from ciao_tpu_torch.solvers import saga as tsaga

    prob = make_lasso(N=8320, n=npix, p=4, seed=0, dtype=np.float32)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 8320.0)
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    _route_gate(monkeypatch)
    if kernel == "streamed":
        monkeypatch.setattr(tsaga, "RESIDENT_MAX_ROWS", 4096)
    spy = _Spy(monkeypatch, "saga_coeff_multistep_streamed"
               if kernel == "streamed" else "saga_coeff_multistep")
    obj0 = float(objective(F, g, torch.zeros(npix)))
    x, it = SAGA(maxit=321, block_sampling=True, batch=BS,
                 importance_sampling=True)(torch.zeros(npix), F=F, g=g,
                                           L=prob.L)
    assert it == 321
    # steps 1..63 stepwise, windows at 64, 128, 192, 256, step 320
    assert spy.calls == [(64, True, None)] * 4
    assert float(objective(F, g, x)) < obj0


def test_own_importance_draws():
    """The port's own importance draws: a pure function of (seed, it);
    iid visit frequencies ∝ q (chi-square over 20,000 draws in 16 blocks
    under its 0.999 quantile, 37.70 at 15 degrees of freedom); istrat
    windows of K draws distinct, each block in a window with probability
    K·q̃_j, weights qinv[j]."""
    d, B, K, k = 16, 8, 4, 20_000
    rng = np.random.default_rng(0)
    q = rng.uniform(0.2, 1.0, d)
    q[3] = 6.0  # clipped to 1/K under istrat
    q /= q.sum()
    cfg = SAGACfg(N=d * B, sag=False, batch=B, block=True, coeff=True,
                  importance=True)
    qcum = torch.tensor(np.cumsum(q) / np.cumsum(q)[-1])
    qinv = torch.tensor(1.0 / (d * q))
    st, w = importance_draws(9, 1, k, cfg, qcum, qinv)
    assert st.dtype == torch.int32 and w.dtype == torch.float64
    blocks = st.numpy() // B
    torch.testing.assert_close(w, qinv[blocks], rtol=0, atol=0)
    chi2 = ((np.bincount(blocks, minlength=d) - k * q) ** 2 / (k * q)).sum()
    assert chi2 < 37.70
    st2, _ = importance_draws(9, 101, 50, cfg, qcum, qinv)
    torch.testing.assert_close(st2, st[100:150], rtol=0, atol=0)

    from ciao_tpu_torch.sampling import clip_block_distribution

    qt, nclip = clip_block_distribution(q, K)
    assert nclip == 1 and abs(qt.max() - 1.0 / K) < 1e-12
    pcum = np.cumsum(K * qt)
    pcum *= K / pcum[-1]
    pcum[-1] = K
    scfg = cfg._replace(istrat=True, iwin=K)
    st, _ = importance_draws(9, 0, k, scfg, torch.tensor(pcum),
                             torch.tensor(1.0 / (d * qt)))
    win = st.numpy().reshape(-1, K) // B
    assert all(len(set(row)) == K for row in win)
    # a block with π_j = K·q̃_j is in a window with probability π_j, once
    # at most: its count over W windows is Binomial(W, π_j), exactly W for
    # the clipped block (π = 1); every other count within 5 sd
    W, pi = k // K, K * qt
    cnt = np.bincount(win.ravel(), minlength=d)
    assert cnt[3] == W
    free = pi < 1
    zs = (cnt[free] - W * pi[free]) / np.sqrt(W * pi[free] * (1 - pi[free]))
    assert np.abs(zs).max() < 5.0, zs


def test_schedule_helpers_match_jax():
    """``first_duplicate``, ``clip_block_distribution`` and
    ``stream_launch_K`` give JAX's values."""
    from ciao_tpu.sampling import clip_block_distribution as jclip
    from ciao_tpu.sampling import first_duplicate as jfirst
    from ciao_tpu_torch.sampling import clip_block_distribution, first_duplicate
    from ciao_tpu_torch.solvers.saga import stream_launch_K

    rng = np.random.default_rng(4)
    for _ in range(20):
        blocks = rng.integers(0, 12, rng.integers(1, 10)).astype(np.int32)
        got = first_duplicate(torch.tensor(blocks))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(jfirst(jnp.asarray(blocks)))
    for K in (4, 16, 64):
        q = rng.pareto(1.0, 80) + 1e-3
        got, want = clip_block_distribution(q, K), jclip(q, K)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for d in (1, 8, 64, 65, 1280, 10**6):
        assert stream_launch_K(d) == jsaga.stream_launch_K(d)
        assert stream_launch_K(d, 1.25) == jsaga.stream_launch_K(d, 1.25)


def test_clamped_launches_commit_the_stepwise_stream():
    """JAX's clamped launch loop run with the port's kernel #4 (its plain
    version): windows of K = stream_launch_K(d) draws, clamped at
    first_duplicate, ``it`` advanced by the committed count only, the
    masked tail re-drawn next launch. It commits the stepwise stream, so
    it ends where the port's unclamped driver ends (to f32 rounding)."""
    from ciao_tpu_torch.ops.fused_block import saga_coeff_multistep_streamed
    from ciao_tpu_torch.sampling import first_duplicate
    from ciao_tpu_torch.solvers.saga import _scalars_row, stream_launch_K

    prob, JF, jg, F, g = _streamed_problem("f32")
    cfg = SAGACfg(N=NS, sag=False, batch=BS, block=True, coeff=True,
                  fused_stream=True)
    gamma = torch.tensor(1.0 / (3.0 * np.max(prob.L)), dtype=torch.float32)
    st0 = saga_init(F, g, torch.zeros(npix), gamma, 7, cfg)
    d, steps = NS // BS, 96
    K = stream_launch_K(d)
    c, z, av, it, clamps = st0.s.clone(), st0.z.clone(), st0.av.clone(), 1, 0
    scalars = _scalars_row(F, g, st0, cfg)
    while it + K <= steps + 1:
        starts = block_starts(7, it, K, d, BS, "cpu")
        f = first_duplicate(starts // BS)
        clamps += int(f) < K
        saga_coeff_multistep_streamed(F.A, F.b, starts, c, z, av, scalars,
                                      BS, f=f)
        it += int(f)
    st = st0._replace(s=c, z=z, av=av, it=it)
    st = saga_run(F, g, st, cfg._replace(fused_stream=False), steps + 1 - it)
    want = saga_run(F, g, st0, cfg, steps)
    assert clamps > 0 and st.it == want.it == steps + 1
    np.testing.assert_allclose(st.z.numpy(), want.z.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(st.s.numpy(), want.s.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_streamed_state_carries_from_jax():
    """A JAX importance state (flat (N,) table, qcum and qinv) carried
    over as numpy resumes in the port."""
    st = saga_state_from_numpy(np.arange(8.0, dtype=np.float32),
                               np.ones(2, np.float32), np.zeros(2, np.float32),
                               np.float32(0.1), 5,
                               qcum=np.array([0.5, 1.0], np.float32),
                               qinv=np.array([1.0, 1.0], np.float32))
    assert st.s.shape == (8,) and st.it == 5
    assert st.qcum.tolist() == [0.5, 1.0] and st.qinv.dtype == torch.float32
