"""The port's Finito family against the JAX package on the CPU.

The four variants — the full table (``basic``), the coefficient table
(``basic_coeff``), LFinito and adaptive Finito — through the stepwise
steps and the kernel drivers (the kernels' plain versions on CPU
tensors), on the same numpy inputs. torch cannot draw threefry, so the
parity tests replay JAX's key chain (``gen_block_ids`` of JAX's sweep,
one ``split`` and ``permutation`` per LFinito epoch, the importance
draws) and hand the schedule to ``finito_run``; cyclic sweeps need no
replay. The facade solves ``tests/test_lasso.py``'s planted Lasso with
the port's own draws, at the reference's budgets and 1e-4 gap.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import ciao_tpu
from ciao_tpu import sampling as jsampling
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.prox import Zero as JZero
from ciao_tpu.solvers import finito as jfin
from ciao_tpu.solvers.saga import _gen_importance_draws
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch import Finito, solution
from ciao_tpu_torch.convert import (
    finito_coeff_state_from_numpy, least_squares_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers import finito as tfin
from ciao_tpu_torch.solvers import loop, take
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _pair(N, n, seed, dtype=np.float32, storage="f32", p=4, wc=False):
    """A planted Lasso as JAX and port oracles and proxes, scale N."""
    prob = make_lasso(N=N, n=n, p=p, seed=seed, dtype=dtype,
                      well_conditioned=wc)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N), prob.A.dtype))
    if storage != "f32":
        JF = JF.with_storage(storage)
    F = least_squares_from_numpy(
        np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
        None if JF.row_scale is None else np.asarray(JF.row_scale),
        device="cpu")
    jg = JNormL1(lam=jnp.asarray(prob.lam, prob.A.dtype))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.from_numpy(
        np.zeros(1, dtype)).dtype))
    return prob, JF, F, jg, g


def _jax_blocks(key, cfg, steps):
    """JAX's block stream of a basic run: its sweep's next ``steps`` ids
    (the cyclic sweep starting at cfg.cyclic_pos0)."""
    st = jsampling.init_sweep(key, cfg.N, cfg.batch, cfg.sweeping)
    if cfg.sweeping == 2:
        st = st._replace(pos=jnp.asarray(cfg.cyclic_pos0, jnp.int32))
    return np.asarray(jsampling.gen_block_ids(st, steps, cfg.N, cfg.batch,
                                              cfg.sweeping)[0])


def _jax_orders(key, d, epochs, sweeping):
    """JAX's LFinito visit orders: a fresh permutation per shuffled epoch
    (``key, sub = split(key)``), natural order otherwise."""
    out = []
    for _ in range(epochs):
        if sweeping == 3:
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.permutation(sub, d)))
        else:
            out.append(np.arange(d))
    return np.stack(out)


def _cfgs(N, B, sweeping, **kw):
    return (jfin.FinitoCfg(N=N, batch=B, sweeping=sweeping, alpha=0.999,
                           **kw),
            tfin.FinitoCfg(N=N, batch=B, sweeping=sweeping, alpha=0.999,
                           **kw))


def _gamma(prob, N, dtype=np.float32):
    return (0.999 * N / np.asarray(prob.L, np.float64)).astype(dtype)


def _spy(monkeypatch, *names):
    """Count the calls of the named kernel wrappers."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tfb, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tfb, name, spy)
    return calls


def _close(got, want, rtol, atol_rel, tag=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=tag)


# ---------------------------------------------------------------------------
# the basic variant: full table, coefficient table, kernel drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweeping", [2, 3])
def test_finito_coeff_matches_full_table(sweeping):
    """tests/test_ops.py:141 in f64: the full-table and the coefficient
    trajectories of the port, on JAX's schedule, equal JAX's full-table
    run at 1e-10 (the compression is algebraic)."""
    prob, JF, F, jg, g = _pair(32, 8, 2, np.float64, p=3)
    key = jax.random.PRNGKey(0)
    jx, _ = ciao_tpu.Finito(maxit=200, sweeping=sweeping,
                            minibatch=(True, 8), table="full")(
        jnp.zeros(8), F=JF, g=jg, L=prob.L)
    jcfg, cfg = _cfgs(32, 8, sweeping)
    blocks = _jax_blocks(key, jcfg, 199)
    gamma = _t(_gamma(prob, 32, np.float64))
    x0 = torch.zeros(8, dtype=torch.float64)
    full = tfin.finito_run(F, g, tfin.finito_basic_init(F, g, x0, gamma, 0,
                                                        cfg),
                           cfg, "basic", 199, blocks=blocks)
    coeff = tfin.finito_run(F, g, tfin.finito_coeff_init(F, g, x0, gamma, 0,
                                                         cfg),
                            cfg, "basic_coeff", 199, blocks=blocks)
    for st in (full, coeff):
        assert st.it == 200
        np.testing.assert_allclose(st.z.numpy(), np.asarray(jx), rtol=1e-10,
                                   atol=1e-10)
    # the explicit schedule advanced the sweep as the draws would
    assert full.sweep.pos == coeff.sweep.pos == tfin.finito_run(
        F, g, tfin.finito_basic_init(F, g, x0, gamma, 0, cfg), cfg, "basic",
        199).sweep.pos


@pytest.mark.parametrize("sweeping", [2, 3])
def test_finito_fused_multistep_matches_jax(sweeping, monkeypatch):
    """tests/test_ops.py:309 (N = 1,024, n = 128, B = 128, 96 steps): the
    port's multistep driver (one call of kernel #9's plain version) and
    its stepwise steps, on JAX's schedule, against JAX's fused run in
    interpret mode: z and zb at rtol 1e-4, c at 1e-3."""
    prob, JF, F, jg, g = _pair(1024, 128, 3)
    key = jax.random.PRNGKey(5)
    jcfg, cfg = _cfgs(1024, 128, sweeping)
    gamma = _gamma(prob, 1024)
    jst0 = jfin.finito_coeff_init(JF, jg, jnp.zeros(128, jnp.float32), jnp.asarray(gamma),
                                  key, jcfg._replace(fused=True))
    with pltpu.force_tpu_interpret_mode():
        jst = jfin.finito_run(JF, jg, jst0, jcfg._replace(fused=True),
                              "basic_coeff", 96)
    blocks = _jax_blocks(key, jcfg, 96)
    calls = _spy(monkeypatch, "finito_coeff_multistep")
    st0 = tfin.finito_coeff_init(F, g, torch.zeros(128), _t(gamma), 0, cfg)
    _close(st0.av.numpy(), jst0.av, 1e-5, 1e-5, "init av")
    for c in (cfg, cfg._replace(fused=True)):
        st = tfin.finito_run(F, g, st0, c, "basic_coeff", 96, blocks=blocks)
        assert st.it == int(jst.it) == 97
        _close(st.z.numpy(), jst.z, 1e-4, 1e-6, "z")
        _close(st.zb.numpy(), jst.zb, 1e-4, 1e-6, "zb")
        _close(st.c.numpy(), jst.c, 1e-3, 1e-5, "c")
    assert calls == {"finito_coeff_multistep": 1}
    # the run copied the tables the kernel updates in place
    np.testing.assert_array_equal(st0.zb.numpy(), 0.0)


@pytest.mark.parametrize("storage,sweeping,steps", [
    ("f32", 3, 130), ("f32", 2, 77), ("int8", 2, 77)])
def test_finito_streamed_driver_matches_jax(storage, sweeping, steps,
                                            monkeypatch):
    """tests/test_ops.py:1128 (N = 8,192, d = 64): the port's driver on
    kernel #14's plain version (launches of 128 steps, the remainder a
    short launch, no clamp) on JAX's schedule, against JAX's stepwise run
    (which its clamped fused run reproduces): z and zb at rtol 1e-4
    (1e-2 int8), av at 1e-3."""
    prob, JF, F, jg, g = _pair(8192, 128, 3, storage=storage)
    key = jax.random.PRNGKey(5)
    jcfg, cfg = _cfgs(8192, 128, sweeping)
    gamma = _gamma(prob, 8192)
    jst = jfin.finito_run(JF, jg, jfin.finito_coeff_init(
        JF, jg, jnp.zeros(128, jnp.float32), jnp.asarray(gamma), key, jcfg), jcfg,
        "basic_coeff", steps)
    calls = _spy(monkeypatch, "finito_coeff_multistep_streamed")
    cfg = cfg._replace(fused_stream=True)
    st = tfin.finito_run(F, g, tfin.finito_coeff_init(
        F, g, torch.zeros(128), _t(gamma), 0, cfg), cfg, "basic_coeff",
        steps, blocks=_jax_blocks(key, jcfg, steps))
    assert calls == {"finito_coeff_multistep_streamed": -(-steps // 128)}
    assert st.it == int(jst.it) == steps + 1
    wide = 1e-4 if storage == "f32" else 1e-2
    _close(st.z.numpy(), jst.z, wide, 1e-6, "z")
    _close(st.zb.numpy(), jst.zb, wide, 1e-6, "zb")
    _close(st.av.numpy(), jst.av, max(wide, 1e-3), 1e-5, "av")


def test_finito_full_table_fused_matches_jax(monkeypatch):
    """tests/test_ops.py:80 (N = 64, n = 128, B = 16, cyclic, 30 steps):
    the full-table step on kernel #2's plain version (one call a step)
    and the stepwise step against JAX's fused run in interpret mode."""
    prob, JF, F, jg, g = _pair(64, 128, 1)
    jcfg, cfg = _cfgs(64, 16, 2)
    gamma = _gamma(prob, 64)
    jst = jfin.finito_basic_init(JF, jg, jnp.zeros(128, jnp.float32), jnp.asarray(gamma),
                                 jax.random.PRNGKey(0), jcfg)
    with pltpu.force_tpu_interpret_mode():
        jz = jfin.finito_run(JF, jg, jst, jcfg._replace(fused=True), "basic",
                             30).z
    calls = _spy(monkeypatch, "finito_block_update")
    st0 = tfin.finito_basic_init(F, g, torch.zeros(128), _t(gamma), 0, cfg)
    for c in (cfg, cfg._replace(fused=True)):
        st = tfin.finito_run(F, g, st0, c, "basic", 30)
        _close(st.z.numpy(), jz, 1e-4, 1e-5, str(c.fused))
    assert calls == {"finito_block_update": 30}


# ---------------------------------------------------------------------------
# LFinito
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("sweeping", [2, 3])
def test_lfinito_matches_jax(sweeping, storage, monkeypatch):
    """tests/test_ops.py:498 (N = 1,024, n = 128, B = 128, 6 epochs):
    the port's stepwise epochs and its fused epochs (kernel #6's and #8's
    plain versions, one call each an epoch) on JAX's visit orders, against
    JAX's stepwise and fused (interpret mode) epochs: z, z_full, av at
    rtol 1e-4."""
    prob, JF, F, jg, g = _pair(1024, 128, 3, storage=storage)
    key = jax.random.PRNGKey(5)
    jcfg, cfg = _cfgs(1024, 128, sweeping)
    gamma = _gamma(prob, 1024)
    orders = _jax_orders(key, 8, 6, sweeping)
    calls = _spy(monkeypatch, "lfinito_sweep_multistep", "coeff_apply_all")
    for fused in (False, True):
        # int8 rows round the kernels' dot operands to bf16, so each
        # route is held to JAX's same route
        with pltpu.force_tpu_interpret_mode():
            jc = jcfg._replace(fused=fused)
            jst = jfin.finito_run(JF, jg, jfin.lfinito_init(
                JF, jg, jnp.zeros(128, jnp.float32), jnp.asarray(gamma), key,
                jc), jc, "lfinito", 6)
        c = cfg._replace(fused=fused)
        st = tfin.finito_run(F, g, tfin.lfinito_init(
            F, g, torch.zeros(128), _t(gamma), 0, c), c, "lfinito", 6,
            blocks=orders)
        assert st.it == int(jst.it) == 7
        atol = 1e-5 if storage == "f32" else 1e-4
        for name in ("z", "z_full", "av"):
            _close(getattr(st, name).numpy(), getattr(jst, name), 1e-4, atol,
                   f"{name} fused={c.fused}")
    assert calls == {"lfinito_sweep_multistep": 6, "coeff_apply_all": 6}
    assert st.sweep.epoch == (6 if sweeping == 3 else 0)


@pytest.mark.parametrize("sweeping", [2, 3])
def test_lfinito_ragged_matches_jax(sweeping):
    """The ragged branch (N = 10, B = 4: blocks {0-3}, {4-7}, {8, 9}) in
    f64 on JAX's visit orders, against JAX's stepwise epochs at 1e-10."""
    prob, JF, F, jg, g = _pair(10, 3, 7, np.float64, p=2)
    key = jax.random.PRNGKey(1)
    jcfg, cfg = _cfgs(10, 4, sweeping)
    gamma = _gamma(prob, 10, np.float64)
    jst = jfin.finito_run(JF, jg, jfin.lfinito_init(
        JF, jg, jnp.zeros(3), jnp.asarray(gamma), key, jcfg), jcfg,
        "lfinito", 12)
    st = tfin.finito_run(F, g, tfin.lfinito_init(
        F, g, torch.zeros(3, dtype=torch.float64), _t(gamma), 0, cfg), cfg,
        "lfinito", 12, blocks=_jax_orders(key, 3, 12, sweeping))
    np.testing.assert_allclose(st.z.numpy(), np.asarray(jst.z), rtol=1e-10,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# rebase, importance sampling, adaptive
# ---------------------------------------------------------------------------

def test_finito_rebase_storage_switch():
    """tests/test_ops.py:865 on JAX's schedule: after an int8 stage,
    ``finito_rebase`` under the f32 rows restores av = hat·(invg @ zb −
    apply_all(c)/N) and re-proxes z, any other state passes through, and
    the rebased finish out-converges the stalled un-rebased one (JAX's
    bars: < 3e-5 rebased, > 5e-5 not)."""
    prob, JF, Fp, jg, g = _pair(2048, 128, 0, p=8, wc=True)
    Fq = Fp.with_storage("int8")
    jcfg, cfg = _cfgs(2048, 256, 3)
    blocks = _jax_blocks(jax.random.PRNGKey(0), jcfg, 16000)
    gamma = _t(_gamma(prob, 2048))
    fs = abs(prob.f_star)

    def rel(z):
        return (prob.cost(z.double().numpy()) - prob.f_star) / fs

    st = tfin.finito_coeff_init(Fp, g, torch.zeros(128), gamma, 0, cfg)
    st = tfin.finito_run(Fq, g, st, cfg, "basic_coeff", 4000,
                         blocks=blocks[:4000])
    rb = tfin.finito_rebase(Fp, g, st, cfg)
    hat = st.hat_gamma
    want = hat * (st.invg @ st.zb) - (hat / 2048) * Fp.apply_all(st.c)
    torch.testing.assert_close(rb.av, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(rb.z, g.prox_only(want, hat), rtol=1e-5,
                               atol=1e-7)
    lst = tfin.lfinito_init(Fp, g, torch.zeros(128), gamma, 0, cfg)
    assert tfin.finito_rebase(Fp, g, lst, cfg) is lst
    r_nr, r_rb = (rel(tfin.finito_run(Fp, g, s0, cfg, "basic_coeff", 12000,
                                      blocks=blocks[4000:]).z)
                  for s0 in (st, rb))
    assert r_rb < 3e-5, r_rb
    assert r_nr > 5e-5, r_nr


def _powerlaw_lsq(Np, npx, seed, span=1.5):
    """tests/test_importance.py:359: consistent least squares with
    log-uniform row scales 1..10^span."""
    rng = np.random.default_rng(seed)
    scale_row = 10.0 ** (span * np.arange(Np) / (Np - 1))
    A = rng.standard_normal((Np, npx)) * scale_row[:, None]
    b = A @ rng.standard_normal(npx)
    return A, b, Np * (A * A).sum(axis=1)


def test_finito_importance_matches_jax(monkeypatch):
    """tests/test_importance.py:387 (N = 8,192, n = 128, B = 128, 193
    steps, Zero prox): the facade's importance set-up equals JAX's (qcum,
    qinv, γ, the window), and the stepwise steps and both kernel drivers
    (#9's and #14's plain versions) on JAX's importance draws reproduce
    JAX's stepwise run."""
    A, b, L = _powerlaw_lsq(8192, 128, 3, span=1.0)
    JF = JLeastSquaresRows(A=jnp.asarray(A, jnp.float32),
                           b=jnp.asarray(b, jnp.float32),
                           scale=jnp.asarray(8192.0, jnp.float32))
    F = LeastSquaresRows(_t(A.astype(np.float32)), _t(b.astype(np.float32)),
                         8192.0)
    x0 = np.zeros(128, np.float32)
    _, _, _, jcfg, jinit, jvar = ciao_tpu.Finito(
        maxit=2, minibatch=(True, 128), importance_sampling=True)._setup(
        jnp.asarray(x0), JF, JZero(), L, 8192)
    _, _, _, cfg, init, var = Finito(
        maxit=2, minibatch=(True, 128), importance_sampling=True)._setup(
        _t(x0), F, Zero(), L, 8192)
    assert var == jvar == "basic_coeff"
    assert (cfg.importance, cfg.istrat, cfg.iwin) == (True, True, jcfg.iwin)
    jst0, st0 = jinit(), init()
    for name in ("qcum", "qinv", "gamma"):
        np.testing.assert_array_equal(getattr(st0, name).numpy(),
                                      np.asarray(getattr(jst0, name)))
    jst = jfin.finito_run(JF, JZero(), jst0, jcfg, "basic_coeff", 193)
    starts, _ = _gen_importance_draws(jst0.sweep.key, 1, jcfg, jst0.qcum,
                                      jst0.qinv, 193)
    blocks = np.asarray(starts) // 128
    calls = _spy(monkeypatch, "finito_coeff_multistep",
                 "finito_coeff_multistep_streamed")
    for c in (cfg, cfg._replace(fused=True),
              cfg._replace(fused_stream=True)):
        st = tfin.finito_run(F, Zero(), st0, c, "basic_coeff", 193,
                             blocks=blocks)
        assert st.it == int(jst.it) == 194
        _close(st.z.numpy(), jst.z, 1e-4, 1e-6, f"z {c.fused}")
        _close(st.c.numpy(), jst.c, 1e-3, 1e-4, f"c {c.fused}")
    assert calls == {"finito_coeff_multistep": 2,
                     "finito_coeff_multistep_streamed": 2}
    # the port's own draws are the same stream stepwise and fused
    a = tfin.finito_run(F, Zero(), st0, cfg, "basic_coeff", 40)
    f = tfin.finito_run(F, Zero(), st0, cfg._replace(fused=True),
                        "basic_coeff", 40)
    _close(f.z.numpy(), a.z.numpy(), 1e-5, 1e-6)


def test_finito_importance_guards():
    """tests/test_importance.py:432's guards."""
    prob, _, F, _, g = _pair(64, 8, 0)
    with pytest.raises(ValueError, match="RANDOM"):
        Finito(maxit=2, sweeping=2, importance_sampling=True)
    with pytest.raises(ValueError, match="basic"):
        Finito(maxit=2, LFinito=True, importance_sampling=True)
    with pytest.raises(ValueError, match="coefficient"):
        Finito(maxit=2, table="full", importance_sampling=True)
    with pytest.raises(ValueError, match="provide L"):
        Finito(maxit=2, minibatch=(True, 8), gamma=0.1,
               importance_sampling=True)(torch.zeros(8), F=F, g=g, N=64)
    x, it = Finito(maxit=400, minibatch=(True, 8),
                   importance_sampling=True)(torch.zeros(8), F=F, g=g,
                                             L=prob.L)
    assert it == 400 and prob.cost(x.double().numpy()) < prob.cost(
        np.zeros(8))


def test_finito_adaptive_matches_jax_cyclic():
    """Adaptive Finito on the cyclic sweep (no draws) in f64: the probe's
    γ and the bootstrap, then 200 backtracking steps (γ shrinks on five
    of the six rows), equal JAX's at 1e-10. Later, near the solution,
    f_i(z) and its model agree to rounding, and the packages' sums in
    other orders can flip one shrink (first at step 233 here)."""
    prob, JF, F, jg, g = _pair(6, 3, 0, np.float64, p=2)
    _, cfg = _cfgs(6, 1, 2)
    jcfg = jfin.FinitoCfg(N=6, batch=1, sweeping=2, alpha=0.999)
    jst = jfin.finito_adaptive_init(JF, jg, jnp.zeros(3),
                                    jax.random.PRNGKey(0), jcfg)
    st = tfin.finito_adaptive_init(F, g, torch.zeros(3, dtype=torch.float64),
                                   0, cfg)
    for name in ("gamma", "hat_gamma", "av", "z", "fi_x", "gradf"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    jst = jfin.finito_run(JF, jg, jst, jcfg, "adaptive", 200)
    st = tfin.finito_run(F, g, st, cfg, "adaptive", 200)
    assert st.it == int(jst.it)
    for name in ("gamma", "hat_gamma", "z", "s"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    assert float(st.gamma.min()) < float(np.asarray(jfin.finito_adaptive_init(
        JF, jg, jnp.zeros(3), jax.random.PRNGKey(0), jcfg).gamma).min())


def test_finito_adaptive_gamma_underflow_abort():
    """A tol_b that the shrinking γ_i crosses: both packages abort at the
    same step with GAMMA_UNDERFLOW, keep the last valid state, and warn;
    the iterator stops there."""
    prob, JF, F, jg, g = _pair(6, 3, 0, np.float64, p=2)
    kw = dict(maxit=300, sweeping=2, adaptive=True, tol_b=0.9)
    with pytest.warns(UserWarning, match="too small"):
        jx, jit = ciao_tpu.Finito(**kw)(jnp.zeros(3), F=JF, g=jg, N=6)
    with pytest.warns(UserWarning, match="too small"):
        x, it = Finito(**kw)(torch.zeros(3, dtype=torch.float64), F=F, g=g,
                             N=6)
    assert 2 < it == jit < 300
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10,
                               atol=1e-12)
    states = list(take(iter(Finito(**kw).iterator(
        torch.zeros(3, dtype=torch.float64), F=F, g=g, N=6)), 200))
    assert len(states) == it


def test_finito_adaptive_probe_retries():
    """Rows whose first probe collapses (a_i ⟂ 1, so ∇f_i(x0 + 1) =
    ∇f_i(x0)) take the doubling ±t retry: finite positive γ, and the
    solve still converges."""
    prob = make_lasso(N=6, n=3, p=2, seed=0, dtype=np.float64)
    A = prob.A.copy()
    A[2] = np.array([1.0, -2.0, 1.0])       # A[2] · 1 = 0
    F = LeastSquaresRows(_t(A), _t(prob.b), 6.0)
    st = tfin.finito_adaptive_init(F, NormL1(prob.lam),
                                   torch.zeros(3, dtype=torch.float64), 0,
                                   tfin.FinitoCfg(N=6, batch=1, sweeping=2,
                                                  alpha=0.999))
    assert bool(torch.isfinite(st.gamma).all()) and float(st.gamma.min()) > 0


# ---------------------------------------------------------------------------
# the facade on tests/test_lasso.py's problem
# ---------------------------------------------------------------------------

MAXIT = 1000


@pytest.fixture(params=[np.float32, np.float64], ids=["f32", "f64"])
def lasso(request):
    dtype = request.param
    prob = make_lasso(N=6, n=3, p=2, seed=0, dtype=dtype)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), 6.0)
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    return prob, F, NormL1(prob.lam), torch.zeros(3, dtype=tdt), tdt


def _check(prob, x, tdt):
    assert x.dtype == tdt
    assert prob.cost(x.double().numpy()) - prob.f_star < 1e-4


@pytest.mark.parametrize("kw", [
    dict(sweeping=1), dict(sweeping=2), dict(sweeping=3),
    dict(sweeping=2, LFinito=True), dict(sweeping=3, LFinito=True),
    dict(sweeping=1, adaptive=True, tol=1e-5),
    dict(sweeping=2, adaptive=True, tol=1e-5),
    dict(sweeping=3, adaptive=True, tol=1e-5),
    dict(sweeping=1, minibatch=(True, 2)), dict(sweeping=2, minibatch=(True, 2)),
    dict(sweeping=3, minibatch=(True, 3)),
    dict(sweeping=2, LFinito=True, minibatch=(True, 1)),
    dict(sweeping=2, LFinito=True, minibatch=(True, 2)),
    dict(sweeping=3, LFinito=True, minibatch=(True, 3)),
    dict(sweeping=2, table="full"), dict(sweeping=3, table="coeff"),
], ids=["basic-1", "basic-2", "basic-3", "lfinito-2", "lfinito-3",
        "adaptive-1", "adaptive-2", "adaptive-3", "mb-1-2", "mb-2-2",
        "mb-3-3", "lmb-2-1", "lmb-2-2", "lmb-3-3", "full-2", "coeff-3"])
def test_finito_facade_solves_planted_lasso(lasso, kw):
    """tests/test_lasso.py:41-80: every variant, sweep and minibatch case
    at the reference's budget reaches cost − f* < 1e-4 and keeps the
    dtype."""
    prob, F, g, x0, tdt = lasso
    x, it = Finito(maxit=MAXIT, **kw)(x0, F=F, g=g, L=prob.L, N=6)
    assert it == MAXIT
    _check(prob, x, tdt)


@pytest.mark.parametrize("sweeping", [2, 3])
@pytest.mark.parametrize("LFinito", [False, True])
def test_finito_ragged_converges(sweeping, LFinito):
    """tests/test_lasso.py:263-280: N = 10, B = 4 (a ragged final block)."""
    prob = make_lasso(N=10, n=3, p=2, seed=7)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), 10.0)
    x, _ = Finito(maxit=400 if LFinito else 1500, sweeping=sweeping,
                  LFinito=LFinito, minibatch=(True, 4))(
        torch.zeros(3, dtype=torch.float64), F=F, g=NormL1(prob.lam),
        L=prob.L, N=10)
    assert prob.cost(x.numpy()) - prob.f_star < 1e-4


def test_finito_ragged_final_batch_matches_reference_semantics():
    """tests/test_lasso.py:209: Finito basic, cyclic, N = 10, B = 4 —
    the masked path's trajectory equals a numpy simulation of the
    reference's smaller final batch (first step on block 2)."""
    N_, B = 10, 4
    prob = make_lasso(N=N_, n=3, p=2, seed=7)
    A, b = np.asarray(prob.A, np.float64), np.asarray(prob.b, np.float64)
    lam = float(prob.lam)
    gam = 0.999 * N_ / np.asarray(prob.L, np.float64)

    def grad(i, z):
        return N_ * (A[i] @ z - b[i]) * A[i]

    s = np.stack([-gam[i] / N_ * grad(i, np.zeros(3)) for i in range(N_)])
    hat = 1.0 / np.sum(1.0 / gam)
    av = hat * np.sum(s / gam[:, None], axis=0)
    z = np.sign(av) * np.maximum(np.abs(av) - hat * lam, 0)
    blocks = [list(range(0, 4)), list(range(4, 8)), [8, 9]]
    F = LeastSquaresRows(_t(A), _t(b), float(N_))
    stream = iter(Finito(sweeping=2, minibatch=(True, B)).iterator(
        torch.zeros(3, dtype=torch.float64), F=F, g=NormL1(lam), L=prob.L,
        N=N_))
    next(stream)
    for k in range(7):
        for i in blocks[(k + 1) % 3]:
            s_new = z - gam[i] / N_ * grad(i, z)
            av = av + (s_new - s[i]) * hat / gam[i]
            s[i] = s_new
        z = np.sign(av) * np.maximum(np.abs(av) - hat * lam, 0)
        np.testing.assert_allclose(next(stream).z.numpy(), z, rtol=1e-9,
                                   atol=1e-12, err_msg=f"step {k}")


def test_finito_scalar_gamma_and_L(lasso):
    """tests/test_lasso.py:83: an explicit scalar γ, and a scalar L
    broadcast."""
    prob, F, g, x0, tdt = lasso
    gamma = 6.0 / float(np.max(prob.L))
    x, _ = Finito(maxit=MAXIT, gamma=gamma)(x0, F=F, g=g, L=prob.L, N=6)
    _check(prob, x, tdt)
    x2, _ = Finito(maxit=MAXIT)(x0, F=F, g=g, L=float(np.max(prob.L)), N=6)
    _check(prob, x2, tdt)


@pytest.mark.parametrize("sweeping,LFinito,adaptive", [
    (1, False, False), (2, False, False), (3, False, True), (3, True, False),
])
def test_finito_iterator_contract(lasso, sweeping, LFinito, adaptive):
    """tests/test_lasso.py:93: the iterator aliases x0; each state's
    solution is the view z; the init state is iteration 1; the states'
    steps equal a run's."""
    prob, F, g, x0, tdt = lasso
    solver = Finito(sweeping=sweeping, LFinito=LFinito, adaptive=adaptive)
    it = solver.iterator(x0, F=F, g=g, L=prob.L, N=6)
    assert it.x0 is x0
    states = list(take(iter(it), 4))
    assert [s.it for s in states] == [1, 2, 3, 4]
    for state in states:
        assert solution(state) is state.z and state.z.dtype == tdt
    last = loop(take(iter(it), 4))
    torch.testing.assert_close(last.z, states[-1].z, rtol=0, atol=0)
    x, _ = Finito(maxit=4, sweeping=sweeping, LFinito=LFinito,
                  adaptive=adaptive)(x0, F=F, g=g, L=prob.L, N=6)
    torch.testing.assert_close(x, states[-1].z, rtol=0, atol=0)


def test_finito_bad_config_raises():
    """tests/test_ops.py:158 (table='coeff' with a RANDOM sweep), the
    missing L of tests/test_lasso.py:175 (with F=None too: the zero
    oracle still needs L or γ), the knobs' checks, and a complex iterate
    on real rows, which runs the real trajectory with a zero imaginary
    part."""
    prob = make_lasso(N=32, n=8, p=3, seed=2)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), 32.0)
    g, x0 = NormL1(1.0), torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="coeff"):
        Finito(maxit=10, sweeping=1, table="coeff")(x0, F=F, g=g, L=prob.L)
    with pytest.raises(ValueError, match="smoothness parameter absent"):
        Finito(maxit=10)(x0, F=F, g=g, N=32)
    with pytest.raises(ValueError, match="smoothness parameter absent"):
        Finito(maxit=10)(x0, g=g, N=32)
    xc, _ = Finito(maxit=10)(torch.zeros(8, dtype=torch.complex128), F=F,
                             g=g, L=prob.L)
    xr, _ = Finito(maxit=10)(x0, F=F, g=g, L=prob.L)
    assert xc.dtype == torch.complex128
    np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-12,
                               atol=1e-14)
    for kw in (dict(gamma=-1.0), dict(maxit=0), dict(sweeping=4),
               dict(table="dense"), dict(fused_precision="tf32"),
               dict(tol_b=0.0), dict(minibatch=(True, 0))):
        with pytest.raises(ValueError):
            Finito(**kw)


# ---------------------------------------------------------------------------
# routing, with the kernels' gates opened for CPU tensors
# ---------------------------------------------------------------------------

def _open_gates(monkeypatch):
    monkeypatch.setattr(tfb, "saga_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)
    monkeypatch.setattr(tfb, "finito_block_available",
                        lambda F, x0, B: F.num_terms % B == 0)


@pytest.mark.parametrize("route", ["resident", "streamed", "full", "lfinito"])
def test_facade_routes_every_gated_run_to_a_kernel(route, monkeypatch):
    """With the gates open, the facade sends each run to its kernels, the
    remainder steps included: the coefficient table to #9 up to JAX's
    resident bounds (and #14 past them, here by a lowered row bound, as
    JAX's closed slab gate does), the full table to #2 once a step,
    LFinito to #6 and #8 once an epoch; the result is the stepwise
    facade's to f32 rounding."""
    prob, _, F, _, g = _pair(1024, 128, 3)
    kw = dict(sweeping=3, minibatch=(True, 128), maxit=200)
    if route == "full":
        kw.update(table="full", maxit=21)
    if route == "lfinito":
        kw.update(LFinito=True, maxit=5)
    assert tfin._resident(262_144, 1024, 4096)           # the headline: #9
    assert not tfin._resident(10 * 1024 * 1024, 128, 8192)  # deep: #14
    x_step, _ = Finito(**kw)(torch.zeros(128), F=F, g=g, L=prob.L)
    _open_gates(monkeypatch)
    if route == "streamed":
        monkeypatch.setattr(tfin, "RESIDENT_MAX_ROWS", 512)
    calls = _spy(monkeypatch, "finito_coeff_multistep",
                 "finito_coeff_multistep_streamed", "finito_block_update",
                 "lfinito_sweep_multistep", "coeff_apply_all")
    x, it = Finito(**kw)(torch.zeros(128), F=F, g=g, L=prob.L)
    assert it == kw["maxit"]
    want = dict.fromkeys(calls, 0)
    want.update({"resident": {"finito_coeff_multistep": 2},
                 "streamed": {"finito_coeff_multistep_streamed": 2},
                 "full": {"finito_block_update": 20},
                 "lfinito": {"lfinito_sweep_multistep": 4,
                             "coeff_apply_all": 4}}[route])
    assert calls == want
    _close(x.numpy(), x_step.numpy(), 1e-4, 1e-5)


def test_finito_coeff_state_from_numpy():
    """A JAX coefficient state carried over: c flattened, zb and invg as
    they are, the sweep's pos and order; one step of each package from it
    on the same block agrees."""
    prob, JF, F, jg, g = _pair(1024, 128, 3)
    jcfg, cfg = _cfgs(1024, 128, 2)
    jst = jfin.finito_coeff_init(JF, jg, jnp.zeros(128, jnp.float32),
                                 jnp.asarray(_gamma(prob, 1024)),
                                 jax.random.PRNGKey(0), jcfg)
    jst = jfin.finito_run(JF, jg, jst, jcfg, "basic_coeff", 5)
    st = finito_coeff_state_from_numpy(
        jst.c, jst.zb, jst.invg, jst.gamma, jst.hat_gamma, jst.av, jst.z,
        jst.sweep.pos, jst.sweep.order, jst.it, device="cpu")
    assert st.it == 6 and st.sweep.pos == int(jst.sweep.pos)
    assert st.zb.shape == (8, 128) and st.c.shape == (1024,)
    j2 = jfin.finito_step(JF, jg, jst, jcfg, "basic_coeff")
    t2 = tfin.finito_step(F, g, st, cfg, "basic_coeff")
    assert t2.sweep.pos == int(j2.sweep.pos)
    _close(t2.z.numpy(), j2.z, 1e-5, 1e-6)
    _close(t2.zb.numpy(), j2.zb, 1e-5, 1e-6)
