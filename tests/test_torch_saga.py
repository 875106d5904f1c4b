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
    SAG, SAGA, SAGACfg, Status, block_starts, halt, loop, saga_init,
    saga_rebase, saga_run, saga_step, solution, take,
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
    """Options of the JAX facade that the port does not cover yet raise
    and name the ROADMAP item instead of running on another path."""
    prob, F, g = lasso6
    x0 = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SAGA(maxit=10, table="full")(x0, F=F, g=g, L=prob.L)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SAGA(maxit=10, importance_sampling=True, block_sampling=True,
             batch=2)(x0, F=F, g=g, L=prob.L)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        saga_init(F, g, x0, 0.1, 0, SAGACfg(N=6, sag=False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SAGA(maxit=10)(x0, g=g, N=6, L=prob.L)
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
        "import ciao_tpu_torch.utils.problems",
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
                 "Status", "solution", "take", "loop", "halt"):
        assert hasattr(ct, name), name
    assert Zero().prox_only(torch.ones(2), 0.1).tolist() == [1.0, 1.0]
