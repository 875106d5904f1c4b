"""The port's Katyusha against the JAX package on the CPU.

The plain version of kernel #10 (``katyusha_coeff_multistep_ref``,
against the Pallas kernel in interpret mode), ``katyusha_run`` in its
three inner modes (stepwise blocks, iid minibatches, the fused driver on
the kernels' plain versions) on JAX's own schedule, and the facade on the
planted Lasso of ``tests/test_katyusha.py``. torch cannot draw threefry,
so the parity tests replay JAX's key chain (one ``split`` per outer step,
then ``_gen_block_starts`` or one ``fold_in`` per inner step) and hand
the schedule to ``katyusha_run``.
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
from ciao_tpu.solvers import katyusha as jkat
from ciao_tpu.solvers.saga import _gen_block_starts
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch.convert import (
    katyusha_state_from_numpy, least_squares_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import (
    Katyusha, KatyushaCfg, katyusha_init, katyusha_run, katyusha_step,
    solution, take,
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
# kernel #10's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

N, n, B, K = 1024, 128, 128, 16
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
# (rows' storage, precision, prox): f32 exact, "default" (JAX's reference
# on bf16-stored rows: XLA on the CPU keeps f32 dots exact at any
# precision), int8, and the Zero prox (αλ = βλ = 0)
CASES = [("f32", "highest", "l1"), ("f32", "default", "l1"),
         ("int8", "highest", "l1"), ("f32", "highest", "zero")]
IDS = ["f32", "f32-default", "int8", "zero"]


def _kernel_problem(storage):
    """A planted Lasso in both packages with a Katyusha-like state: the
    anchor x̃ and its coefficients, av its mean gradient, y and z near it,
    ys a running sum, and K block starts (repeats included)."""
    prob = make_lasso(N=N, n=n, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = _jax_oracle(prob, N, storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    rng = np.random.default_rng(7)
    xt = (0.05 * rng.standard_normal(n)).astype(np.float32)
    canch = np.asarray(JF.coeff_all(jnp.asarray(xt)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(canch)), np.float32) / N
    y, z = (xt + 0.01 * rng.standard_normal((2, n))).astype(np.float32)
    ys = (0.1 * rng.standard_normal(n)).astype(np.float32)
    starts = (rng.integers(0, N // B, K) * B).astype(np.int32)
    Lmax = float(np.max(prob.L))
    return JF, rs, canch, av, xt, y, z, ys, starts, Lmax, prob


def _torch_rows(JF, storage):
    if storage == "bf16":
        return _t(np.asarray(JF.A.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(JF.A))


@pytest.mark.parametrize("storage,precision,prox", CASES, ids=IDS)
def test_katyusha_multistep_ref_matches_pallas(storage, precision, prox):
    """K = 16 inner steps of the plain version against the Pallas kernel
    in interpret mode on one schedule, τ₁ = 0.3, τ₂ = 0.5: y, z and ys at
    rtol 1e-4, atol 1e-6."""
    (JF, rs, canch, av, xt, y, z, ys, starts, Lmax,
     prob) = _kernel_problem(storage)
    tau1, tau2 = 0.3, 0.5
    alpha, beta = 1.0 / (3.0 * tau1 * Lmax), 1.0 / (3.0 * Lmax)
    lam = prob.lam if prox == "l1" else 0.0
    sc = np.array([N, alpha, beta, alpha * lam, beta * lam, 1.0 / B,
                   jfb.MODE_LSQ, tau1, tau2, 0.0], np.float32)
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jy, jz, jys = jfb.katyusha_coeff_multistep(
            jA, jnp.asarray(np.asarray(JF.b)).reshape(SLAB),
            jnp.asarray(canch).reshape(SLAB), jnp.asarray(starts),
            jnp.asarray(xt)[None], jnp.asarray(y)[None],
            jnp.asarray(z)[None], jnp.asarray(ys)[None],
            jnp.asarray(av)[None], jnp.asarray(sc)[None], B,
            precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB))
    ty, tz, tys = _t(y), _t(z), _t(ys)
    out = tfb.katyusha_coeff_multistep(
        _torch_rows(JF, storage), _t(np.asarray(JF.b)), _t(canch),
        _t(starts), _t(xt), ty, tz, tys, _t(av), _t(sc), B,
        precision=precision, rs=None if rs is None else _t(rs))
    assert out[0] is ty and out[1] is tz and out[2] is tys  # in place
    assert not np.array_equal(tz.numpy(), z)
    for got, want in ((ty, jy), (tz, jz), (tys, jys)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[0],
                                   rtol=1e-4, atol=1e-6)


def test_katyusha_wrapper_on_cpu_and_chunked_driver():
    """CPU tensors take the plain version and count no launch; a device
    with no kernel raises; the chunked driver runs every step (the last
    launch the remainder) and equals one call of the plain version."""
    (JF, rs, canch, av, xt, y, z, ys, starts, Lmax,
     prob) = _kernel_problem("int8")
    A, b = _torch_rows(JF, "int8"), _t(np.asarray(JF.b))
    sc = _t(np.array([N, 0.1 / Lmax, 0.3 / Lmax, 0.1 * prob.lam / Lmax,
                      0.3 * prob.lam / Lmax, 1.0 / B, 0.0, 0.5, 0.5, 0.0],
                     np.float32))
    before = tfb.katyusha_coeff_multistep.launches
    ref = [_t(y), _t(z), _t(ys)]
    tfb.katyusha_coeff_multistep_ref(A, b, _t(canch), _t(starts), _t(xt),
                                     *ref, _t(av), sc, B, rs=_t(rs))
    got = [_t(y), _t(z), _t(ys)]
    out = tfb.katyusha_inner_chunked(A, b, _t(canch), _t(xt), *got, _t(av),
                                     sc, B, _t(starts), 5, rs=_t(rs))
    assert out[3] == K and tfb.katyusha_coeff_multistep.launches == before
    for g_, r_ in zip(got, ref):
        torch.testing.assert_close(g_, r_, rtol=0, atol=0)
    m = torch.empty((64, 8), device="meta")
    v = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.katyusha_coeff_multistep(
            m, torch.empty(64, device="meta"),
            torch.empty(64, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"), v, v, v, v, v,
            torch.empty(10, device="meta"), 16)


# ---------------------------------------------------------------------------
# katyusha_run against JAX on JAX's schedule
# ---------------------------------------------------------------------------

def _jax_schedules(key, m, steps, cfg, iid=False):
    """JAX's inner schedule of ``steps`` outer steps: per outer step
    ``key, sub = split(key)``; block starts ``_gen_block_starts(sub, 0,
    cfg, m)``, or the iid minibatch ``randint(fold_in(sub, k), (B,))`` of
    inner step k."""
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
@pytest.mark.parametrize("m,ns", [(24, True), (70, False)],
                         ids=["m24-ns", "m70-tau1"])
def test_katyusha_run_matches_jax(mode, m, ns, monkeypatch):
    """Three outer steps of m inner steps (tests/test_katyusha.py:177's
    problem, N = 1,024, n = 128, B = 128), under the ns schedule (τ₁ =
    2/(s+4)) and a fixed τ₁ = 0.25. block and iid: the stepwise paths of
    both packages. fused: JAX's Pallas kernels in interpret mode (and its
    stepwise remainder past 64 steps) against the port's fused driver,
    whose every inner step goes to kernel #10: one launch per outer step
    (m ≤ LAUNCH_STEPS) and one of kernel #6 per anchor."""
    Np, B_ = 1024, 128
    prob = make_lasso(N=Np, n=128, p=4, seed=3, dtype=np.float32)
    JF = _jax_oracle(prob, Np)
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    F, g = _port_oracle(JF), NormL1(torch.tensor(prob.lam))
    Lm = np.float32(np.max(prob.L))
    key = jax.random.PRNGKey(5)
    tau1 = np.float32(0.5 if ns else 0.25)
    x0 = np.zeros(128, np.float32)
    block = mode != "iid"
    jcfg = jkat.KatyushaCfg(N=Np, batch=B_, m=m, block=block, ns=ns,
                            fused=mode == "fused")
    jst0 = jkat.katyusha_init(JF, jg, jnp.asarray(x0), jnp.asarray(Lm),
                              jnp.asarray(tau1), jnp.asarray(0.5,
                                                             jnp.float32),
                              key, jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jkat.katyusha_run(JF, jg, jst0, jcfg, 3)
    sched = _jax_schedules(key, m, 3, jcfg, iid=not block)
    calls = _spy(monkeypatch, ["katyusha_coeff_multistep", "coeff_apply_all"])
    cfg = KatyushaCfg(N=Np, batch=B_, m=m, block=block, ns=ns,
                      fused=mode == "fused")
    st0 = katyusha_state_from_numpy(
        jst0.Lmax, jst0.tau1, jst0.tau2, jst0.av, jst0.x_tilde, jst0.y,
        jst0.z, jst0.it, canch=jst0.canch, device="cpu")
    mine = katyusha_init(F, g, _t(x0), Lm, tau1, 0.5, 0, cfg)
    np.testing.assert_allclose(mine.av.numpy(), st0.av.numpy(), rtol=1e-5,
                               atol=1e-5 * float(st0.av.abs().max()))
    st = katyusha_run(F, g, st0, cfg, 3,
                      **(dict(starts=sched) if block else dict(idx=sched)))
    tag = f"{mode} m={m} ns={ns}"
    for fld in ("x_tilde", "y", "z"):
        np.testing.assert_allclose(getattr(st, fld).numpy(),
                                   np.asarray(getattr(jst, fld)), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{tag} {fld}")
    np.testing.assert_allclose(st.av.numpy(), np.asarray(jst.av), rtol=1e-3,
                               atol=1e-4, err_msg=tag)
    np.testing.assert_allclose(float(st.tau1), float(jst.tau1), rtol=1e-6)
    assert st.it == int(jst.it) == 4
    if mode == "fused":
        assert calls == {"katyusha_coeff_multistep": 3, "coeff_apply_all": 3}
        assert st.canch.shape == (Np,)
    else:
        assert calls == {"katyusha_coeff_multistep": 0, "coeff_apply_all": 0}
        assert st.canch is None
    # the run copied what the kernel updates in place
    np.testing.assert_array_equal(st0.y.numpy(), x0)


# ---------------------------------------------------------------------------
# the facade (tests/test_katyusha.py's cases)
# ---------------------------------------------------------------------------

Nf, nf = 64, 8


@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=Nf, n=nf, p=3, seed=3)
    from ciao_tpu_torch.oracles import LeastSquaresRows

    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                         float(Nf))
    return prob, F, NormL1(prob.lam)


def _x0():
    return torch.zeros(nf, dtype=torch.float64)


def test_katyusha_facade_converges_in_each_mode(lasso):
    """The ns schedule, τ₁ from σ, an explicit τ₁ and contiguous blocks
    of 8 reach cost − f* < 1e-4 on the planted Lasso in
    tests/test_katyusha.py's budgets, keeping f64; the block run takes
    the stepwise path on the CPU."""
    prob, F, g = lasso
    for kw, maxit in ((dict(), 30), (dict(sigma=1.0), 60),
                      (dict(tau1=0.3), 80),
                      (dict(batch=8, block_sampling=True), 60)):
        x, it = Katyusha(maxit=maxit, **kw)(_x0(), F=F, g=g, L=prob.L)
        assert it == maxit and x.dtype == torch.float64, kw
        assert prob.cost(x.numpy()) - prob.f_star < 1e-4, kw


def test_katyusha_fused_facade_on_the_cpu_matches_stepwise(lasso,
                                                          monkeypatch):
    """With the kernel gate opened for CPU tensors the facade routes a
    block run to the fused driver (kernel #10's plain version) on f32
    rows; its solution equals the stepwise block run on the same draws,
    and every outer step launches the kernel wrapper once."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    prob, _, _ = lasso
    F = LeastSquaresRows(torch.tensor(prob.A, dtype=torch.float32),
                         torch.tensor(prob.b, dtype=torch.float32),
                         float(Nf))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    x0 = torch.zeros(nf)
    solver = Katyusha(maxit=6, batch=8, block_sampling=True)
    xs, _ = solver(x0, F=F, g=g, L=prob.L)
    monkeypatch.setattr(tfb, "svrg_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)
    calls = _spy(monkeypatch, ["katyusha_coeff_multistep"])
    xf, it = solver(x0, F=F, g=g, L=prob.L)
    assert it == 6 and calls["katyusha_coeff_multistep"] == 5
    np.testing.assert_allclose(xf.numpy(), xs.numpy(), rtol=1e-4, atol=1e-6)


def test_katyusha_iterator_invariants(lasso):
    """solution(init) == x0, the iterator's k-th state is a maxit = k
    solve (stateless draws), the solution is the view x̃, and rebase is
    the identity."""
    prob, F, g = lasso
    solver = Katyusha(maxit=5)
    it = solver.iterator(_x0(), F=F, g=g, L=prob.L)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(states[0].solution.numpy(), _x0().numpy())
    assert [s.it for s in states] == [1, 2, 3, 4, 5]
    assert solution(states[2]) is states[2].x_tilde
    x_batch, _ = solver(_x0(), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(states[-1].solution.numpy(),
                                  x_batch.numpy())
    cfg = KatyushaCfg(N=Nf, m=2 * Nf, ns=True)
    nxt = katyusha_step(F, g, states[0], cfg)
    np.testing.assert_array_equal(nxt.x_tilde.numpy(),
                                  states[1].x_tilde.numpy())
    assert it._rebase_fn(states[1]) is states[1]


def test_katyusha_refusals(lasso):
    """The JAX facade's guards as ValueError (JAX asserts): τ₂ and τ₁
    out of range, precision, maxit, batch; L missing, block sampling
    with N not divisible by batch, m < 1; complex iterates name their
    ROADMAP item. F=None builds the zero oracle."""
    prob, F, g = lasso
    for kw in (dict(tau2=0.0), dict(tau2=1.0), dict(tau1=0.6),
               dict(tau1=0.0), dict(fused_precision="tf32"), dict(maxit=0),
               dict(batch=0)):
        with pytest.raises(ValueError):
            Katyusha(**kw)
    with pytest.raises(ValueError, match="divisible"):
        Katyusha(maxit=2, batch=7, block_sampling=True)(_x0(), F=F, g=g,
                                                        L=prob.L)
    with pytest.raises(ValueError, match="smoothness"):
        Katyusha(maxit=2)(_x0(), F=F, g=g)
    with pytest.raises(ValueError, match="m must be"):
        Katyusha(maxit=2, m=0)(_x0(), F=F, g=g, L=prob.L)
    xc, _ = Katyusha(maxit=3)(torch.zeros(nf, dtype=torch.complex128), F=F,
                       g=g, L=prob.L)
    xr, _ = Katyusha(maxit=3)(_x0(), F=F, g=g, L=prob.L)
    assert xc.dtype == torch.complex128
    np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-12,
                               atol=1e-14)
    x, _ = Katyusha(maxit=3)(_x0(), g=g, L=prob.L, N=Nf)
    np.testing.assert_array_equal(x.numpy(), _x0().numpy())
