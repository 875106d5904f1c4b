"""Complex rows and iterates in the port against the JAX package on the CPU.

Four parts (the complex cases of the JAX package's other facade tests
are in ``tests/test_torch_complex_families.py``):

* ``tests/test_lasso.py``'s complex half: the planted Lasso (its real
  data cast to c64/c128) through every Finito variant, SVRG, SVRG++,
  SAGA and SAG at the reference's budgets, with the dtype kept and
  cost − f* < 1e-4.
* Step-for-step parity in c128 on truly complex rows (``_complex_lasso``:
  ``make_lasso``'s KKT recipe with complex C and y, so every conjugate
  counts): SAGA (both tables, block and iid), SVRG (block and iid) and
  Finito (full and coefficient tables, LFinito, adaptive) from JAX's init
  on JAX's schedules, drawn here and handed to the port's ``starts``,
  ``idx`` or ``blocks``, within 1e-10.
* The least-squares oracle: ``tests/test_oracles.py:78`` with
  ``_batched_paths_consistent``, and every path against JAX's on truly
  complex rows.
* The refusals that stay (JAX's words), and the fallback warning a
  complex iterate never raises.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ciao_tpu
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import finito as jfin
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu.solvers import svrg as jsvrg
from ciao_tpu_torch import (
    SAG, SAGA, SVRG, Finito, PointSAGA, iterator, solution, take,
)
from ciao_tpu_torch import runtime
from ciao_tpu_torch.convert import (
    finito_coeff_state_from_numpy, least_squares_from_numpy,
    saga_state_from_numpy, svrg_state_from_numpy,
)
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import finito as tfin
from ciao_tpu_torch.solvers import saga as tsaga
from ciao_tpu_torch.solvers import svrg as tsvrg
from ciao_tpu_torch.utils.problems import make_lasso
from test_torch_finito import _jax_blocks, _jax_orders
from test_torch_saga_full import _jax_iid_rows
from test_torch_svrg import _jax_schedules
from torch_threads import one_torch_thread  # noqa: F401

C128 = torch.complex128


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-10, atol_rel=1e-10, tag=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max()),
                               err_msg=tag)


# ---------------------------------------------------------------------------
# tests/test_lasso.py's complex half
# ---------------------------------------------------------------------------

MAXIT = 1000
TOL = 1e-4


@pytest.fixture(params=[np.complex64, np.complex128], ids=["c64", "c128"])
def lasso(request):
    dtype = request.param
    prob = make_lasso(N=6, n=3, p=2, seed=0, dtype=dtype)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), 6.0)
    g = NormL1(prob.lam)
    x0 = torch.zeros(3, dtype=_t(prob.A).dtype)
    return prob, F, g, x0, x0.dtype


def _check(prob, x, tdt):
    assert x.dtype == tdt
    assert prob.cost(x.numpy()) - prob.f_star < TOL


@pytest.mark.parametrize("sweeping", [1, 2, 3])
def test_finito_basic(lasso, sweeping):
    prob, F, g, x0, tdt = lasso
    x, it = Finito(maxit=MAXIT, sweeping=sweeping)(x0, F=F, g=g, L=prob.L,
                                                   N=6)
    assert it == MAXIT
    _check(prob, x, tdt)


@pytest.mark.parametrize("sweeping", [2, 3])
def test_lfinito(lasso, sweeping):
    prob, F, g, x0, tdt = lasso
    x, _ = Finito(maxit=MAXIT, sweeping=sweeping, LFinito=True)(
        x0, F=F, g=g, L=prob.L, N=6)
    _check(prob, x, tdt)


@pytest.mark.parametrize("sweeping", [1, 2, 3])
def test_finito_adaptive(lasso, sweeping):
    prob, F, g, x0, tdt = lasso
    x, _ = Finito(maxit=MAXIT, tol=1e-5, sweeping=sweeping, adaptive=True)(
        x0, F=F, g=g, L=prob.L, N=6)
    _check(prob, x, tdt)


@pytest.mark.parametrize("sweeping,batch", [(1, 2), (2, 2), (3, 3)])
def test_finito_minibatch(lasso, sweeping, batch):
    prob, F, g, x0, tdt = lasso
    x, _ = Finito(maxit=MAXIT, sweeping=sweeping, minibatch=(True, batch))(
        x0, F=F, g=g, L=prob.L, N=6)
    _check(prob, x, tdt)


@pytest.mark.parametrize("sweeping,batch", [(2, 1), (2, 2), (3, 3)])
def test_lfinito_minibatch(lasso, sweeping, batch):
    prob, F, g, x0, tdt = lasso
    x, _ = Finito(maxit=MAXIT, sweeping=sweeping, LFinito=True,
                  minibatch=(True, batch))(x0, F=F, g=g, L=prob.L, N=6)
    _check(prob, x, tdt)


def test_finito_scalar_gamma_and_L(lasso):
    prob, F, g, x0, tdt = lasso
    gamma = 6.0 / float(np.max(prob.L))
    x, _ = Finito(maxit=MAXIT, gamma=gamma)(x0, F=F, g=g, L=prob.L, N=6)
    _check(prob, x, tdt)
    x2, _ = Finito(maxit=MAXIT)(x0, F=F, g=g, L=float(np.max(prob.L)), N=6)
    _check(prob, x2, tdt)


@pytest.mark.parametrize("sweeping,LFinito,adaptive",
                         [(1, False, False), (2, False, False),
                          (3, False, True), (3, True, False)])
def test_finito_iterator_contract(lasso, sweeping, LFinito, adaptive):
    prob, F, g, x0, tdt = lasso
    solver = Finito(sweeping=sweeping, LFinito=LFinito, adaptive=adaptive)
    it = iterator(solver, x0, F=F, g=g, L=prob.L, N=6)
    assert it.x0 is x0
    for state in take(iter(it), 2):
        assert solution(state) is state.z and state.z.dtype == tdt


def test_svrg(lasso):
    prob, F, g, x0, tdt = lasso
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    x, _ = SVRG(maxit=MAXIT, gamma=gamma)(x0, F=F, g=g, N=6)
    _check(prob, x, tdt)


def test_svrg_plus(lasso):
    prob, F, g, x0, tdt = lasso
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    x, _ = SVRG(maxit=16, gamma=gamma, m=1, plus=True)(x0, F=F, g=g, N=6)
    _check(prob, x, tdt)


def test_svrg_iterator_and_init_equivalence(lasso):
    prob, F, g, x0, tdt = lasso
    gamma = 1.0 / (7 * float(np.max(prob.L)))
    it = iterator(SVRG(gamma=gamma), x0, F=F, g=g, N=6)
    assert it.x0 is x0
    states = list(take(iter(it), 2))
    for state in states:
        assert solution(state) is state.z_full and state.z_full.dtype == tdt
    x1, it1 = SVRG(gamma=gamma, maxit=1)(x0, F=F, g=g, L=prob.L, N=6)
    assert it1 == 1
    assert torch.equal(solution(states[0]), x1)


def test_saga(lasso):
    prob, F, g, x0, tdt = lasso
    x, _ = SAGA(maxit=MAXIT)(x0, F=F, g=g, N=6, L=prob.L)
    _check(prob, x, tdt)
    gamma = 1.0 / (3 * float(np.max(prob.L)))
    x2, _ = SAGA(maxit=MAXIT, gamma=gamma)(x0, F=F, g=g, N=6)
    _check(prob, x2, tdt)


def test_saga_iterator_and_init_equivalence(lasso):
    prob, F, g, x0, tdt = lasso
    gamma = 1.0 / (3 * float(np.max(prob.L)))
    it = iterator(SAGA(gamma=gamma), x0, F=F, g=g, N=6)
    assert it.x0 is x0
    states = list(take(iter(it), 2))
    for state in states:
        assert solution(state) is state.z
    x1, _ = SAGA(gamma=gamma, maxit=1)(x0, F=F, g=g, L=prob.L, N=6)
    assert torch.equal(solution(states[0]), x1)


def test_sag(lasso):
    prob, F, g, x0, tdt = lasso
    x, _ = SAG(maxit=10000)(x0, F=F, g=g, N=6, L=prob.L)
    _check(prob, x, tdt)
    gamma = 1.0 / (16 * float(np.max(prob.L)))
    x2, _ = SAG(maxit=10000, gamma=gamma)(x0, F=F, g=g, N=6)
    _check(prob, x2, tdt)
    states = list(take(iter(iterator(SAG(gamma=gamma), x0, F=F, g=g, N=6)),
                       2))
    x1, _ = SAG(gamma=gamma, maxit=1)(x0, F=F, g=g, L=prob.L, N=6)
    assert torch.equal(solution(states[0]), x1)


# ---------------------------------------------------------------------------
# truly complex rows: step-for-step parity with JAX in c128
# ---------------------------------------------------------------------------

def _complex_lasso(N, n, p, seed, lam=1.0, rho=10.0):
    """A planted complex Lasso, min ½‖Ax − b‖² + λ‖x‖₁ over ℂⁿ: the KKT
    recipe of ``make_lasso`` with complex C and a complex unit dual y*:
    columns scaled so |A_jᴴy*| = λ on the support and below it off the
    support, x*_j along the phase of A_jᴴy*, b = Ax* + y*. Returns (A, b,
    x*, f*, L, λ) with L_i = N‖a_i‖²."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    y /= np.linalg.norm(y)
    C = rng.standard_normal((N, n)) + 1j * rng.standard_normal((N, n))
    mag = np.abs(C.conj().T @ y)
    perm = np.argsort(-mag)
    alpha = lam * (0.2 + 0.7 * rng.random(n)) / mag
    alpha[perm[:p]] = lam / mag[perm[:p]]
    A = C * alpha
    ATy = A.conj().T @ y
    x = np.zeros(n, complex)
    sup = perm[:p]
    x[sup] = (1.0 + rho * rng.random(p)) * ATy[sup] / np.abs(ATy[sup])
    b = A @ x + y
    r = A @ x - b
    f_star = 0.5 * np.real(np.vdot(r, r)) + lam * np.sum(np.abs(x))
    return A, b, x, f_star, N * np.sum(np.abs(A) ** 2, axis=1), lam


def _cost(A, b, lam, x):
    r = A @ x - b
    return 0.5 * float(np.real(np.vdot(r, r))) + lam * float(
        np.sum(np.abs(x)))


def _pair(N=64, n=8, p=3, seed=3):
    A, b, xs, fs, L, lam = _complex_lasso(N, n, p, seed)
    JF = JLeastSquaresRows(A=jnp.asarray(A), b=jnp.asarray(b),
                           scale=jnp.asarray(float(N)))
    F = least_squares_from_numpy(A, b, np.float64(N), device="cpu")
    return (A, b, xs, fs, L, lam), JF, F, JNormL1(lam=jnp.asarray(lam)), \
        NormL1(torch.tensor(lam, dtype=torch.float64))


def test_complex_lasso_plant_is_optimal():
    """The plant's KKT conditions hold: A_jᴴ(b − Ax*) = λ·x*_j/|x*_j| on
    the support and |A_jᴴ(b − Ax*)| < λ off it."""
    A, b, xs, fs, L, lam = _complex_lasso(64, 8, 3, 3)
    d = A.conj().T @ (b - A @ xs)
    sup = np.abs(xs) > 0
    np.testing.assert_allclose(d[sup], lam * xs[sup] / np.abs(xs[sup]),
                               rtol=0, atol=1e-12)
    assert np.all(np.abs(d[~sup]) < lam)
    assert np.abs(A.imag).max() > 0.1 and np.abs(xs[sup].imag).max() > 0.1


@pytest.mark.parametrize("mode", ["coeff-block", "coeff-iid", "full-block",
                                  "full-iid", "sag"])
def test_saga_matches_jax_step_by_step(mode):
    """SAGA/SAG from JAX's init on JAX's schedule: z, av and the table
    within 1e-10 after 60 steps of batch 8."""
    N, B, steps = 64, 8, 60
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    coeff, block = mode.startswith("coeff"), not mode.endswith("iid")
    sag = mode == "sag"
    gamma = 1.0 / ((16.0 if sag else 3.0) * float(np.max(L)))
    kw = dict(N=N, sag=sag, batch=B, block=block, coeff=coeff)
    jcfg, cfg = jsaga.SAGACfg(**kw), tsaga.SAGACfg(**kw)
    key = jax.random.PRNGKey(4)
    x0 = np.zeros(8, complex)
    jst0 = jsaga.saga_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key,
                           jcfg)
    st0 = tsaga.saga_init(F, g, _t(x0), gamma, 0, cfg)
    for name in ("s", "av", "z"):
        _close(getattr(st0, name).numpy(), getattr(jst0, name), 1e-12,
               1e-12, f"init {name}")
    if block:
        sched = dict(starts=_t(jsaga._gen_block_starts(key, 1, jcfg, steps)))
    else:
        sched = dict(idx=_jax_iid_rows(key, steps, N, B))
    jst = jsaga.saga_run(JF, jg, jst0, jcfg, steps)
    st = tsaga.saga_run(F, g, st0, cfg, steps, **sched)
    assert st.z.dtype == C128 and st.s.dtype == C128
    for name in ("z", "av", "s"):
        _close(getattr(st, name).numpy(), getattr(jst, name), tag=name)
    # the state carries over from JAX's numpy fields and steps on as JAX's
    cst = saga_state_from_numpy(
        np.asarray(jst.s), np.asarray(jst.z), np.asarray(jst.av),
        np.asarray(jst.gamma), int(jst.it), device="cpu",
        table="coeff" if coeff else "full")
    assert cst.z.dtype == cst.s.dtype == C128
    assert cst.gamma.dtype == torch.float64
    if block:
        _close(tsaga.saga_run(F, g, cst, cfg, 5, starts=_t(
            jsaga._gen_block_starts(key, steps + 1, jcfg, 5))).z.numpy(),
            jsaga.saga_run(JF, jg, jst, jcfg, 5).z, tag="carried")


@pytest.mark.parametrize("mode", ["block", "iid", "plus"])
def test_svrg_matches_jax_step_by_step(mode):
    """SVRG (three outer steps of m = 24) and SVRG++ (four, m doubling
    from 3) from JAX's init on JAX's inner schedules: z_full, w and the
    anchor gradient within 1e-10."""
    N, B = 64, 8
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    plus, block = mode == "plus", mode != "iid"
    m, outer = (3, 4) if plus else (24, 3)
    gamma = 1.0 / (10.0 * float(np.max(L)))
    kw = dict(N=N, plus=plus, batch=B, block=block)
    jcfg, cfg = jsvrg.SVRGCfg(**kw), tsvrg.SVRGCfg(**kw)
    key = jax.random.PRNGKey(5)
    x0 = np.zeros(8, complex)
    jst0 = jsvrg.svrg_init(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), m,
                           key, jcfg)
    jst = jsvrg.svrg_run(JF, jg, jst0, jcfg, outer)
    ms = [m * 2 ** t for t in range(outer)] if plus else [m] * outer
    sched = _jax_schedules(key, ms, jcfg, iid=not block)
    st0 = tsvrg.svrg_init(F, g, _t(x0), _t(gamma), m, 0, cfg)
    _close(st0.av.numpy(), jst0.av, 1e-12, 1e-12, "init av")
    st = tsvrg.svrg_run(F, g, st0, cfg, outer,
                        **(dict(starts=sched) if block else dict(idx=sched)))
    assert st.z_full.dtype == C128 and st.gamma.dtype == torch.float64
    for name in ("z_full", "w", "av"):
        _close(getattr(st, name).numpy(), getattr(jst, name), tag=name)
    cst = svrg_state_from_numpy(np.asarray(jst.gamma), int(jst.m),
                                np.asarray(jst.av), np.asarray(jst.z),
                                np.asarray(jst.z_full), np.asarray(jst.w),
                                int(jst.it), device="cpu")
    assert cst.w.dtype == C128


@pytest.mark.parametrize("variant,sweeping", [
    ("basic", 2), ("basic", 3), ("basic_coeff", 2), ("basic_coeff", 3),
    ("lfinito", 3), ("adaptive", 2)])
def test_finito_matches_jax_step_by_step(variant, sweeping):
    """Finito from JAX's init on JAX's sweep (blocks of 8; the cyclic
    sweep of rows for the adaptive variant, whose line search takes
    Re⟨∇f_i, z − s_i⟩ and whose probe splits JAX's key): z and the tables
    within 1e-10 (LFinito: 12 epochs, the others 150 steps)."""
    N = 64
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    B = 1 if variant == "adaptive" else 8
    jcfg = jfin.FinitoCfg(N=N, batch=B, sweeping=sweeping, alpha=0.999)
    cfg = tfin.FinitoCfg(N=N, batch=B, sweeping=sweeping, alpha=0.999)
    gamma = 0.999 * N / np.asarray(L)
    key = jax.random.PRNGKey(1)
    x0 = np.zeros(8, complex)
    init = {"basic": "finito_basic_init", "basic_coeff": "finito_coeff_init",
            "lfinito": "lfinito_init", "adaptive": "finito_adaptive_init"}
    jinit, tinit = getattr(jfin, init[variant]), getattr(tfin, init[variant])
    if variant == "adaptive":
        jst0 = jinit(JF, jg, jnp.asarray(x0), key, jcfg)
        st0 = tinit(F, g, _t(x0), 0, cfg)
    else:
        jst0 = jinit(JF, jg, jnp.asarray(x0), jnp.asarray(gamma), key, jcfg)
        st0 = tinit(F, g, _t(x0), _t(gamma), 0, cfg)
    steps = 12 if variant == "lfinito" else 150
    if variant == "lfinito":
        blocks = _jax_orders(key, N // B, steps, sweeping)
    else:
        blocks = _jax_blocks(key, jcfg, steps)
    if variant == "adaptive":
        blocks = None
        for name in ("gamma", "hat_gamma", "av", "z", "fi_x", "gradf"):
            _close(getattr(st0, name).numpy(), getattr(jst0, name), 1e-12,
                   1e-12, f"init {name}")
    jst = jfin.finito_run(JF, jg, jst0, jcfg, variant, steps)
    st = tfin.finito_run(F, g, st0, cfg, variant, steps, blocks=blocks)
    assert st.z.dtype == C128 and st.gamma.dtype == torch.float64
    _close(st.z.numpy(), jst.z, tag="z")
    for name in ("s", "c", "zb", "gradf", "av", "gamma"):
        if hasattr(jst, name):
            _close(getattr(st, name).numpy(), getattr(jst, name), tag=name)
    if variant == "basic_coeff":
        cst = finito_coeff_state_from_numpy(
            *(np.asarray(getattr(jst, k)) for k in (
                "c", "zb", "invg", "gamma", "hat_gamma", "av", "z")),
            int(jst.sweep.pos), np.asarray(jst.sweep.order), int(jst.it),
            device="cpu")
        assert cst.c.dtype == cst.zb.dtype == C128


# ---------------------------------------------------------------------------
# the oracle: tests/test_oracles.py:78 and every path against JAX's
# ---------------------------------------------------------------------------

def _batched_paths_consistent(F, x, atol=1e-8):
    """tests/test_oracles.py's ``_batched_paths_consistent`` on the port."""
    N = F.num_terms
    idx = torch.arange(N)
    vals_i, grads_i = zip(*[F.value_and_grad_i(x, torch.tensor(i))
                            for i in range(N)])
    G_ref = torch.stack(grads_i)
    vals, G = F.value_and_grad_batch(x, idx)
    for got, want in ((G, G_ref), (vals, torch.stack(vals_i)),
                      (F.grad_sum_all(x), G_ref.sum(0)),
                      (F.grad_all(x), G_ref),
                      (F.grad_sum_batch(x, idx, torch.arange(N) < N - 1),
                       G_ref[:-1].sum(0))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                   rtol=1e-6)
    x2 = x + 0.37
    np.testing.assert_allclose(
        F.grad_sum_diff(x, x2, idx).numpy(),
        (F.grad_sum_batch(x, idx) - F.grad_sum_batch(x2, idx)).numpy(),
        atol=atol, rtol=1e-6)
    xs = torch.stack([x + 0.1 * i for i in range(N)])
    Gp_ref = torch.stack([F.value_and_grad_i(xs[i], torch.tensor(i))[1]
                          for i in range(N)])
    np.testing.assert_allclose(F.grad_pointwise(xs, idx).numpy(),
                               Gp_ref.numpy(), atol=atol, rtol=1e-6)
    assert vals.dtype == x.dtype.to_real()


def test_least_squares_complex():
    """tests/test_oracles.py:78: the gradient of ½|a·x − b|² is
    conj(a)·(a·x − b), and the batched paths agree."""
    rng = np.random.default_rng(1)
    N, n = 4, 3
    A = rng.standard_normal((N, n)) + 0j
    b = rng.standard_normal(N) + 0j
    F = LeastSquaresRows(_t(A), _t(b), 1.0)
    x = _t(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for i in range(N):
        v, g = F.value_and_grad_i(x, torch.tensor(i))
        r = A[i] @ x.numpy() - b[i]
        np.testing.assert_allclose(v.numpy(), 0.5 * np.abs(r) ** 2,
                                   atol=1e-10)
        np.testing.assert_allclose(g.numpy(), np.conj(A[i]) * r, atol=1e-10)
    _batched_paths_consistent(F, x)


def test_least_squares_complex_paths_match_jax():
    """On truly complex rows every path of the oracle equals JAX's to
    1e-12: values, gradients (batch, block, pointwise, all rows), the
    coefficient protocol Σ w_i·conj(a_i), the margins and the Point-SAGA
    pieces (‖a‖² = Re(a·ā), θ and the update with conj(a))."""
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair(N=16, n=5, p=2)
    _batched_paths_consistent(F, _t(xs))
    rng = np.random.default_rng(7)
    x = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    x2 = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    w = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    xs6 = rng.standard_normal((6, 5)) + 1j * rng.standard_normal((6, 5))
    idx = np.array([3, 0, 9, 9, 15, 4])
    jx, tx = jnp.asarray(x), _t(x)
    ji, ti = jnp.asarray(idx), _t(idx)
    cases = {
        "value_and_grad_i": ((jx, 3), (tx, 3)),
        "value_and_grad_batch": ((jx, ji), (tx, ti)),
        "grad_sum_batch": ((jx, ji), (tx, ti)),
        "grad_sum_diff": ((jx, jnp.asarray(x2), ji), (tx, _t(x2), ti)),
        "grad_sum_all": ((jx,), (tx,)),
        "grad_all": ((jx,), (tx,)),
        "value_and_grad_all": ((jx,), (tx,)),
        "value_sum_and_grad_sum_all": ((jx,), (tx,)),
        "value_sum_all": ((jx,), (tx,)),
        "grad_pointwise": ((jnp.asarray(xs6), ji), (_t(xs6), ti)),
        "value_and_grad_pointwise": ((jnp.asarray(xs6), ji), (_t(xs6), ti)),
        "grad_block": ((jx, 2, 6), (tx, 2, 6)),
        "grad_sum_diff_block": ((jx, jnp.asarray(x2), 2, 6),
                                (tx, _t(x2), 2, 6)),
        "grad_pointwise_block": ((jnp.asarray(xs6), 2, 6),
                                 (_t(xs6), 2, 6)),
        "coeff_batch": ((jx, ji), (tx, ti)),
        "coeff_block": ((jx, 2, 6), (tx, 2, 6)),
        "coeff_all": ((jx,), (tx,)),
        "apply_rows": ((jnp.asarray(w), ji), (_t(w), ti)),
        "apply_rows_block": ((jnp.asarray(w), 2, 6), (_t(w), 2, 6)),
        "apply_all": ((jnp.asarray(np.resize(w, 16)),),
                      (_t(np.resize(w, 16)),)),
        "margin_all": ((jx,), (tx,)),
        "margin_block": ((jx, 2, 6), (tx, 2, 6)),
        "value_from_margin_all": ((JF.margin_all(jx),), (F.margin_all(tx),)),
        "coeff_from_margin": ((JF.margin_block(jx, 2, 6), 2, 6),
                              (F.margin_block(tx, 2, 6), 2, 6)),
        "coeff_from_margin_all": ((JF.margin_all(jx),),
                                  (F.margin_all(tx),)),
        "pointprox_block": ((jx, jnp.asarray(w), 0.01, 2, 6),
                            (tx, _t(w), 0.01, 2, 6)),
        "pointprox_batch": ((jx, jnp.asarray(w), 0.01, ji),
                            (tx, _t(w), 0.01, ti)),
        "pointprox_sqnorm_block": ((2, 6), (2, 6)),
        "pointprox_theta_block": (
            (JF.margin_block(jx, 2, 6), JF.pointprox_sqnorm_block(2, 6),
             jnp.asarray(w), 0.01, 2, 6),
            (F.margin_block(tx, 2, 6), F.pointprox_sqnorm_block(2, 6),
             _t(w), 0.01, 2, 6)),
    }
    for name, (jargs, targs) in cases.items():
        want = getattr(JF, name)(*jargs)
        got = getattr(F, name)(*targs)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for k, (gv, wv) in enumerate(zip(got, want)):
            wv = np.asarray(wv)
            assert gv.dtype.is_complex == np.iscomplexobj(wv), (name, k)
            np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-12,
                                       atol=1e-12 * max(1.0, np.abs(wv).max()),
                                       err_msg=f"{name}[{k}]")


def test_complex_refusals_repeat_jax():
    """What JAX refuses, the port refuses with JAX's words: int8 storage
    of complex rows and importance sampling of complex iterates (Finito,
    Point-SAGA); a real storage dtype of complex rows raises where JAX
    would drop the imaginary part (a deliberate deviation)."""
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    with pytest.raises(ValueError, match="int8 storage requires real rows"):
        JF.with_storage("int8")
    with pytest.raises(ValueError, match="int8 storage requires real rows"):
        F.with_storage("int8")
    for st in ("bf16", "f32"):
        with pytest.raises(ValueError, match="imaginary part"):
            F.with_storage(st)
    x0 = torch.zeros(8, dtype=C128)
    with pytest.raises(ValueError,
                       match="Finito importance_sampling: real dtypes only"):
        Finito(minibatch=(True, 8), importance_sampling=True)(
            x0, F=F, g=g, L=L)
    with pytest.raises(ValueError,
                       match="PointSAGA importance_sampling: real dtypes"):
        PointSAGA(batch=8, block_sampling=True, importance_sampling=True)(
            x0, F=F, L=L)
    for S in (ciao_tpu.Finito(minibatch=(True, 8), importance_sampling=True),
              ciao_tpu.PointSAGA(batch=8, block_sampling=True,
                                 importance_sampling=True)):
        with pytest.raises(ValueError, match="real dtypes only"):
            S(jnp.zeros(8, jnp.complex128), F=JF, L=L)
    # SAGA's importance sampling takes complex iterates, in JAX too
    x, _ = SAGA(maxit=400, batch=8, block_sampling=True,
                importance_sampling=True)(x0, F=F, g=g, L=L)
    assert x.dtype == C128 and bool(torch.isfinite(x).all())


def test_complex_iterate_never_warns_of_a_fallback(monkeypatch):
    """A complex iterate on the card closes every kernel gate with no
    fallback warning (JAX's exemption, tests/test_warnings.py:105); a
    real f64 iterate with the same closed gate warns. The card is stood
    in for by an object with a CUDA device and the iterate's dtype."""
    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    monkeypatch.setattr(runtime, "on_cuda", lambda: True)
    runtime.reset_fallback_warnings()

    def on_card(dtype):
        return types.SimpleNamespace(device=torch.device("cuda"),
                                     dtype=dtype)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsaga._warn_fallback("SAGA", F, g, on_card(torch.complex64))
        tsaga._warn_fallback("SAGA", F, g, on_card(torch.complex64), False)
    with pytest.warns(UserWarning, match="iterate dtype"):
        tsaga._warn_fallback("SAGA", F, g, on_card(torch.float64))
    runtime.reset_fallback_warnings()


# ---------------------------------------------------------------------------
# convert.py: JAX's complex states carried over
# ---------------------------------------------------------------------------

CARRIED = {
    "katyusha": ("Katyusha", "katyusha_state_from_numpy", {}),
    "sarah": ("SARAH", "sarah_state_from_numpy", {}),
    "lsvrg": ("LSVRG", "lsvrg_state_from_numpy", {}),
    "lkatyusha": ("LKatyusha", "lkatyusha_state_from_numpy", {}),
    "ssnm": ("SSNM", "ssnm_state_from_numpy", dict(batch=8)),
    "point_saga": ("PointSAGA", "point_saga_state_from_numpy", {}),
    "finito_basic": ("Finito", "finito_basic_state_from_numpy",
                     dict(sweeping=2, table="full", minibatch=(True, 8))),
    "lfinito": ("Finito", "lfinito_state_from_numpy",
                dict(sweeping=2, LFinito=True, minibatch=(True, 8))),
    "finito_adaptive": ("Finito", "finito_adaptive_state_from_numpy",
                        dict(sweeping=2, adaptive=True)),
    "proshi": ("Proshi", "proshi_state_from_numpy",
               dict(sweeping=2, minibatch=(True, 8))),
    "fb": ("FISTA", "fb_state_from_numpy", {}),
    "panoc": ("PANOC", "panoc_state_from_numpy", {}),
}


@pytest.mark.parametrize("family", list(CARRIED))
def test_complex_states_carry_over_from_jax(family):
    """Each ``*_from_numpy`` of a facade that runs complex iterates takes
    JAX's c128 state (after three states of its iterator on truly complex
    rows): every carried field equals JAX's, complex fields stay complex;
    the deterministic FISTA and PANOC then take one step as JAX's does."""
    import inspect

    from ciao_tpu_torch import convert
    from ciao_tpu_torch import solvers as tsolvers

    (A, b, xs, fs, L, lam), JF, F, jg, g = _pair()
    name, conv, kw = CARRIED[family]
    jkw = dict(F=JF, L=L, N=64)
    if family != "point_saga":
        jkw["g"] = jg
    jit = getattr(ciao_tpu, name)(**kw).iterator(
        jnp.zeros(8, jnp.complex128), **jkw)
    jstates = list(ciao_tpu.solvers.take(iter(jit), 4))
    js = jstates[2]
    args = {}
    for p in inspect.signature(getattr(convert, conv)).parameters:
        if p in ("pos", "order"):
            args[p] = np.asarray(getattr(js.sweep, p))
        elif p not in ("seed", "device") and getattr(js, p, None) is not None:
            args[p] = np.asarray(getattr(js, p))
    st = getattr(convert, conv)(**args, device="cpu")
    for p, want in args.items():
        got = getattr(st, p, None)
        if got is None:
            got = getattr(st.sweep, p)
        if isinstance(got, torch.Tensor):
            assert got.dtype.is_complex == np.iscomplexobj(want), p
            np.testing.assert_array_equal(got.numpy().reshape(want.shape),
                                          want, err_msg=p)
    assert st.solution.dtype == C128
    if family in ("fb", "panoc"):
        _, Ft, gt, cfg, _ = getattr(tsolvers, name)()._setup(
            torch.zeros(8, dtype=C128), F, g, L, 64)[:5]
        step = getattr(tsolvers, f"{family}_step")
        _close(step(Ft, gt, st, cfg).solution.numpy(),
               jstates[3].solution, 1e-10, 1e-10, family)
