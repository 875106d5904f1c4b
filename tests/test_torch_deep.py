"""The port's deep-accuracy path (``staged_saga``, ``deep_solve``) on the
CPU, and a fixed-schedule slice of it against the JAX package.

``deep_solve`` must reach rel ≤ 1e-6 on the planted Lasso, the bar of
tests/test_deep.py, for the f32 and the staged int8 → f32 schedules and
with importance sampling. The slice test runs JAX's ``saga_init``, its
streamed ``saga_run`` (Pallas kernel in interpret mode) and
``fista_polish``, and the port's, on one block schedule with one η: z
agrees at rtol 1e-4, the bound of tests/test_ops.py's streamed suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import polish as jpolish
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu_torch import LeastSquaresRows, NormL1, deep_solve, staged_saga
from ciao_tpu_torch.solvers import SAGACfg, fista_polish, saga_init, saga_run
from ciao_tpu_torch.utils.problems import make_lasso

N, n = 2048, 32


def _rel(prob, x):
    return (prob.cost(x.double().numpy()) - prob.f_star) / abs(prob.f_star)


def _port_lasso(prob, N_):
    return (LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b),
                             torch.tensor(float(N_))),
            NormL1(torch.tensor(prob.lam, dtype=torch.float32)))


@pytest.mark.parametrize("storages", [("f32",), ("int8", "f32")])
def test_deep_solve_lasso_reaches_rel_1e6(storages):
    """tests/test_deep.py's bar with its settings: the stochastic stage to
    its plateau (or the budget), then the automatic-η polish through
    rel 1e-6."""
    prob = make_lasso(N=N, n=n, p=6, seed=0, dtype=np.float32,
                      well_conditioned=True)
    F, g = _port_lasso(prob, N)
    seen = []
    x, info = deep_solve(torch.zeros(n), F, g, L=prob.L, N=N,
                         storages=storages, batch=256, chunk_epochs=8,
                         max_epochs=96, plateau_rtol=1e-4,
                         observe=lambda z: seen.append(z))
    rel = _rel(prob, x)
    assert rel <= 1e-6, (storages, rel)
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    assert info.polish_steps > 0 and len(info.fp_res) == info.polish_steps // 4
    assert info.lmax > 0 and info.eta == pytest.approx(0.9 / info.lmax)
    assert list(info.staged.storages) == list(storages)
    assert sum(info.staged.epochs) <= 96
    assert len(seen) == sum(info.staged.epochs) // 8 + len(info.fp_res)


def test_staged_saga_switches_storage_with_rebase():
    """A staged run whose stages plateau at once (a chunk here gains some
    30 %, under plateau_rtol = 0.4) runs one chunk per stage, rebases at
    the switch and records both stages; its objective check is the
    one-pass value sum."""
    prob = make_lasso(N=N, n=n, p=6, seed=1, dtype=np.float32,
                      well_conditioned=True)
    F, g = _port_lasso(prob, N)
    z, info = staged_saga(torch.zeros(n), F, g, L=prob.L, N=N,
                          storages=("int8", "f32"), batch=256, chunk_epochs=4,
                          plateau_rtol=0.4, max_epochs=64)
    assert info.storages == ["int8", "f32"] and info.epochs == [4, 4]
    assert info.switched_early == [True, True]
    want = float(F.value_and_grad_all(z)[0].sum() / N + g.value(z))
    assert info.objectives[-1] == pytest.approx(want, rel=1e-5)
    assert info.objectives[-1] < info.objectives[0]


def test_deep_slice_matches_jax():
    """JAX's saga_init + streamed saga_run + fista_polish against the
    port's on N = 8,192 rows of n = 128 (d = 64 blocks of 128, the
    streamed route), 2 epochs of JAX's schedule, then 8 polish steps
    with JAX's η: z at rtol 1e-4 after each stage."""
    Ns, ns, Bs, steps = 8192, 128, 128, 128
    prob = make_lasso(N=Ns, n=ns, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(Ns), jnp.float32))
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gamma = np.float32(1.0 / (3.0 * np.max(prob.L)))
    key = jax.random.PRNGKey(2)
    jcfg = jsaga.SAGACfg(N=Ns, sag=False, batch=Bs, block=True, coeff=True,
                         fused_stream=True)
    jst = jsaga.saga_run(JF, jg, jsaga.saga_init(
        JF, jg, jnp.zeros(ns, jnp.float32), jnp.asarray(gamma), key, jcfg),
        jcfg, steps)
    starts = np.asarray(jsaga._gen_block_starts(key, 1, jcfg, steps))
    lmax = float(jpolish.lsq_power_lmax(JF, key, iters=6))
    eta = np.float32(0.9 / lmax)
    jres = jpolish.fista_polish(JF, jg, jst.z, eta, steps=8, chunk=1024)

    F, g = _port_lasso(prob, Ns)
    cfg = SAGACfg(N=Ns, sag=False, batch=Bs, block=True, coeff=True,
                  fused_stream=True)
    st = saga_run(F, g, saga_init(F, g, torch.zeros(ns), torch.tensor(gamma),
                                  0, cfg), cfg, steps,
                  starts=torch.tensor(starts))
    np.testing.assert_allclose(st.z.numpy(), np.asarray(jst.z), rtol=1e-4,
                               atol=1e-6)
    res = fista_polish(F, g, st.z, eta, steps=8, chunk=1024)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-4,
                               atol=1e-6)
    assert _rel(prob, res.x) < _rel(prob, st.z)


def test_deep_solve_importance_stage():
    """tests/test_deep.py's importance stage: with importance sampling
    the well-conditioned instance still reaches rel 1e-6, and on the raw
    (uncapped, ill-conditioned) generator the importance stage lands
    closer than the uniform one at a matched budget."""
    wc = make_lasso(N=2048, n=64, p=6, seed=0, dtype=np.float32,
                    well_conditioned=True)
    Fw, gw = _port_lasso(wc, 2048)
    xw, info = deep_solve(torch.zeros(64), Fw, gw, L=wc.L, N=2048, batch=128,
                          chunk_epochs=8, max_epochs=96, plateau_rtol=1e-4,
                          importance_sampling=True)
    assert _rel(wc, xw) <= 1e-6
    assert info.polish_steps > 0

    prob = make_lasso(N=1024, n=64, p=6, seed=1, dtype=np.float32)
    F, g = _port_lasso(prob, 1024)
    kw = dict(L=prob.L, N=1024, batch=64, chunk_epochs=16, max_epochs=192,
              plateau_rtol=1e-4, polish_max_rounds=2)
    xi, _ = deep_solve(torch.zeros(64), F, g, importance_sampling=True, **kw)
    xu, _ = deep_solve(torch.zeros(64), F, g, **kw)
    gap_i = prob.cost(xi.double().numpy()) - prob.f_star
    gap_u = prob.cost(xu.double().numpy()) - prob.f_star
    assert gap_i * 1.5 < gap_u, (gap_i, gap_u)


def test_deep_solve_needs_dense_rows():
    """An oracle without dense rows takes the block-protocol route, whose
    automatic stepsize covers the quadratic and logistic families alone
    (the sparse rows): any other oracle without dense rows raises JAX's
    ValueError before any work."""
    class Blocks(torch.nn.Module):
        num_terms = 8

    with pytest.raises(ValueError, match="quadratic"):
        deep_solve(torch.zeros(2), Blocks(), None, L=np.ones(8), batch=2)
