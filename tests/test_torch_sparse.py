"""The port's sparse rows (ELL and hot/cold hybrid, least squares and
logistic), its planted sparse Lasso and the block-protocol deep route
against the JAX package on the CPU.

Every protocol method of the four classes on ``tests/test_sparse.py``'s
fixtures (f64, one row all padding) within 1e-12 of the largest entry;
SAGA, Finito, LFinito, SVRG, Katyusha and FISTA on both layouts along
JAX's schedule within 1e-9, and equal to the port's own dense run; the
block-protocol polish gradient and power bounds; ``deep_solve`` on JAX's
2,048 x 256 planted problem carried across (rel <= 1e-6 on both layouts
and both losses); the port's own ``make_sparse_lasso_ell``. JAX runs as
``tests/test_sparse.py`` and ``tests/test_deep.py`` run it (x64 on, from
``tests/conftest.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu import sampling as jsampling
from ciao_tpu.oracles import (
    HybridSparseLeastSquares as JHybridLsq,
    HybridSparseLogistic as JHybridLogistic,
    SparseLeastSquaresELL as JEllLsq,
    SparseLogisticELL as JEllLogistic,
)
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import fb as jfb
from ciao_tpu.solvers import finito as jfin
from ciao_tpu.solvers import katyusha as jkat
from ciao_tpu.solvers import polish as jpolish
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu.solvers import svrg as jsvrg
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu.utils.problems import make_sparse_lasso_ell as jmake_sparse
from ciao_tpu_torch import convert, deep_solve, runtime
from ciao_tpu_torch.oracles import (
    HybridSparseLeastSquares, HybridSparseLogistic, LeastSquaresRows,
    SparseLeastSquaresELL, SparseLogisticELL, ZeroOracle,
)
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import fb as tfb
from ciao_tpu_torch.solvers import finito as tfin
from ciao_tpu_torch.solvers import katyusha as tkat
from ciao_tpu_torch.solvers import polish as tpolish
from ciao_tpu_torch.solvers import saga as tsaga
from ciao_tpu_torch.solvers import svrg as tsvrg
from ciao_tpu_torch.utils import make_sparse_lasso_ell
from ciao_tpu_torch.utils.problems import nan_median_nearest

N, n, K = 128, 32, 8          # tests/test_sparse.py's ELL fixtures
N_H, n_H = 160, 48            # its hybrid fixtures
PAD_ROW = 5                   # a row made all padding in every fixture


def _t(a):
    return torch.tensor(np.asarray(a))


def _power_law_matrix(N_, n_, seed=7):
    """tests/test_sparse.py's power-law matrix: four near-dense columns
    (ids not at the front) and a tail of at most 4 nonzeros a row."""
    rng = np.random.default_rng(seed)
    A = np.zeros((N_, n_))
    hot = [c for c in (5, 11, 30, 41) if c < n_] or [n_ - 1]
    for c in hot:
        m = rng.random(N_) < 0.9
        A[m, c] = rng.standard_normal(m.sum())
    cold_cols = np.setdiff1d(np.arange(n_), hot)
    for i in range(N_):
        cols = rng.choice(cold_cols, size=rng.integers(0, 5), replace=False)
        A[i, cols] = rng.standard_normal(len(cols))
    b = A @ rng.standard_normal(n_) + 0.05 * rng.standard_normal(N_)
    return A, b


def _lsq_matrix():
    """tests/test_sparse.py's ``pair``: a planted Lasso's rows cut to their
    K largest entries, b with noise."""
    rng = np.random.default_rng(0)
    prob = make_lasso(N=N, n=n, p=4, seed=1, dtype=np.float64,
                      well_conditioned=True)
    A = np.array(prob.A)
    keep = np.argsort(-np.abs(A), axis=1)[:, :K]
    As = np.zeros_like(A)
    rows = np.arange(N)[:, None]
    As[rows, keep] = A[rows, keep]
    b = As @ prob.x_star + rng.standard_normal(N) * 0.1
    return As, b, prob


def _logit_matrix():
    """tests/test_sparse.py's ``logit_pair``: K random entries a row, ±1
    labels."""
    rng = np.random.default_rng(11)
    A = np.zeros((N, n))
    for i in range(N):
        cols = rng.choice(n, size=K, replace=False)
        A[i, cols] = rng.standard_normal(K)
    x_true = rng.standard_normal(n)
    y = np.sign(A @ x_true + 0.1 * rng.standard_normal(N))
    return A, y


def _hybrid_logit_matrix():
    A, _ = _power_law_matrix(N_H, n_H, seed=13)
    rng = np.random.default_rng(14)
    y = np.sign(A @ rng.standard_normal(n_H) + 0.1 * rng.standard_normal(N_H))
    y[y == 0] = 1.0
    return A, y


def _oracles(kind):
    """(JAX oracle, port oracle from_dense, port oracle carried across by
    ``convert``) of a fixture with row PAD_ROW all padding."""
    if kind.startswith("ell_lsq"):
        A, b, _ = _lsq_matrix()
    elif kind.startswith("hybrid_lsq"):
        A, b = _power_law_matrix(N_H, n_H)
    elif kind == "ell_logistic":
        A, b = _logit_matrix()
    else:
        A, b = _hybrid_logit_matrix()
    A = A.copy()
    A[PAD_ROW] = 0.0
    N_ = A.shape[0]
    if kind == "ell_lsq":
        J = JEllLsq.from_dense(A, b, float(N_), K=K)
        P = SparseLeastSquaresELL.from_dense(A, b, float(N_), K=K,
                                             device="cpu")
        C = convert.sparse_least_squares_ell_from_numpy(
            J.idx, J.val, J.b, J.scale, J.n_dim, device="cpu")
    elif kind.startswith("hybrid_lsq"):
        J = JHybridLsq.from_dense(A, b, float(N_), D=4)
        P = HybridSparseLeastSquares.from_dense(A, b, float(N_), D=4,
                                                device="cpu")
        if kind.endswith("bf16"):
            J, P = J.with_storage(), P.with_storage("bf16")
        C = convert.hybrid_sparse_least_squares_from_numpy(
            J.A_hot, J.hot_cols, J.idx, J.val, J.b, J.scale, J.n_dim,
            device="cpu")
    elif kind == "ell_logistic":
        J = JEllLogistic.from_dense(A, b, K=K)
        P = SparseLogisticELL.from_dense(A, b, K=K, device="cpu")
        C = convert.sparse_logistic_ell_from_numpy(J.idx, J.val, J.y,
                                                   J.n_dim, device="cpu")
    else:
        J = JHybridLogistic.from_dense(A, b, D=4)
        P = HybridSparseLogistic.from_dense(A, b, D=4, device="cpu")
        C = convert.hybrid_sparse_logistic_from_numpy(
            J.A_hot, J.hot_cols, J.idx, J.val, J.y, J.n_dim, device="cpu")
    return J, P, C


KINDS = ["ell_lsq", "hybrid_lsq", "hybrid_lsq_bf16", "ell_logistic",
         "hybrid_logistic"]


def _same(t, a):
    """Tensor ``t`` holds the numpy array ``a`` bit for bit (bf16 by its
    bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert t.numpy().dtype == a.dtype, (t.dtype, a.dtype)
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("kind", KINDS)
def test_fields_equal_jax(kind):
    """``from_dense`` fills JAX's slots (``idx``, ``val``, ``hot_cols``,
    ``A_hot``) exactly, and the ``convert`` functions carry JAX's fields
    across bit for bit (int32 indices, a bf16 block by its bits)."""
    J, P, C = _oracles(kind)
    fields = ["idx", "val", "n_dim"]
    fields += ["A_hot", "hot_cols"] if "hybrid" in kind else []
    fields += ["b", "scale"] if "lsq" in kind else ["y"]
    for O in (P, C):
        for name in fields:
            got, want = getattr(O, name), getattr(J, name)
            if name == "n_dim":
                assert got == want
            else:
                _same(got, want)
        assert O.idx.dtype == torch.int32
        assert O.num_terms == J.num_terms and O.dim == J.dim
        assert O.nnz_per_row == J.nnz_per_row
        assert O.coeff_mode == J.coeff_mode
        if "hybrid" in kind:
            assert O.hot_width == J.hot_width == 128
    # row PAD_ROW is all padding: index 0, value 0
    assert not P.idx[PAD_ROW].any() and not P.val[PAD_ROW].any()


def _jax_calls(J, cases):
    """JAX's ``J.name(*args)`` for every (name, args) of ``cases`` in one
    jitted call (the arrays and ints constants of it): one compile, not
    one an operation."""
    def run(F):
        return [getattr(F, name)(*(jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in args)) for name, args in cases]
    return jax.jit(run)(J)


def _close(got, want, tol=1e-12):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-300))


@pytest.mark.parametrize("kind", KINDS)
def test_protocol_matches_jax(kind):
    """Every protocol method against JAX's within 1e-12 of the largest
    entry, on a batch that holds the all-padding row; block starts as a
    host int and as a 0-d tensor."""
    J, P, _ = _oracles(kind)
    N_, n_ = J.num_terms, J.dim
    rng = np.random.default_rng(2)
    x, x2 = rng.standard_normal(n_), rng.standard_normal(n_)
    xs = rng.standard_normal((4, n_))
    idx = np.array([3, PAD_ROW, 99, 64], np.int32)
    mask = np.array([True, True, False, True])
    w4, w16 = rng.standard_normal(4), rng.standard_normal(16)
    wN = rng.standard_normal(N_)
    j, t = jnp.asarray, _t
    cases = [
        ("margin_all", (x,)), ("coeff_all", (x,)), ("coeff_batch", (x, idx)),
        ("coeff_block", (x, 0, 16)), ("apply_rows", (w4, idx)),
        ("apply_rows_block", (w16, 0, 16)), ("apply_all", (wN,)),
        ("grad_sum_all", (x,)), ("grad_sum_batch", (x, idx)),
        ("grad_sum_batch", (x, idx, mask)), ("grad_sum_diff", (x, x2, idx)),
        ("grad_sum_diff", (x, x2, idx, mask)),
        ("grad_sum_diff_block", (x, x2, 0, 16)), ("grad_block", (x, 0, 16)),
        ("grad_batch", (x, idx)), ("grad_pointwise", (xs, idx)),
        ("value_and_grad_i", (x, 7)), ("value_and_grad_i", (x, PAD_ROW)),
    ]
    wants = _jax_calls(J, cases)
    for (name, args), want in zip(cases, wants):
        got = getattr(P, name)(*(t(a) if isinstance(a, np.ndarray) else a
                                 for a in args))
        for g_, w_ in (zip(got, want) if isinstance(got, tuple)
                       else [(got, want)]):
            _close(g_, w_)
    # a device start gathers what a host start slices
    for name in ("coeff_block", "grad_block"):
        _close(getattr(P, name)(t(x), torch.tensor(16), 16),
               getattr(P, name)(t(x), 16, 16), 0.0)
    _close(P.grad_sum_diff_block(t(x), t(x2), torch.tensor(16), 16),
           P.grad_sum_diff_block(t(x), t(x2), 16, 16), 0.0)
    # the port's own value sums (JAX derives them by vmap): the sum of
    # the rows' values, and the batch gradients the rows' gradients
    vals, grads = P.value_and_grad_batch(t(x), t(idx))
    _close(grads, P.grad_batch(t(x), t(idx)), 0.0)
    _close(vals[1], P.value_and_grad_i(t(x), PAD_ROW)[0], 0.0)
    allv, _ = P.value_and_grad_all(t(x))
    _close(P.value_sum_all(t(x)), allv.sum(), 1e-14)
    vs, gs = P.value_sum_and_grad_sum_all(t(x))
    _close(vs, allv.sum(), 1e-14)
    _close(gs, P.grad_sum_all(t(x)), 1e-14)
    m = wants[0]
    for slack in (0.0, 0.3):
        _close(P.hess_weight_from_margin(t(m), slack),
               J.hess_weight_from_margin(m, slack))
    # the all-padding row: margin 0, gradient 0 (least squares: −scale·b)
    assert float(P.margin_all(t(x))[PAD_ROW]) == 0.0
    assert not P.grad_batch(t(x), torch.tensor([PAD_ROW]))[0].any()


def test_with_storage_keeps_the_tail_and_refuses_int8():
    _, P, _ = _oracles("hybrid_lsq")
    Pb = P.with_storage("bf16")
    assert Pb.A_hot.dtype == torch.bfloat16
    assert Pb.val.dtype == P.val.dtype == torch.float64
    assert torch.equal(Pb.idx, P.idx) and torch.equal(Pb.hot_cols,
                                                      P.hot_cols)
    with pytest.raises(ValueError, match="f32 or bf16"):
        P.with_storage("int8")


# ---------------------------------------------------------------------------
# trajectories along JAX's schedule
# ---------------------------------------------------------------------------


def _layout(layout):
    """(JAX sparse, port sparse, port dense, JAX prox, port prox, L, N_, n_)
    of tests/test_sparse.py's pair (ELL) or hybrid pair."""
    if layout == "ell":
        A, b, prob = _lsq_matrix()
        lam = prob.lam
        J = JEllLsq.from_dense(A, b, float(N), K=K)
        P = SparseLeastSquaresELL.from_dense(A, b, float(N), K=K,
                                             device="cpu")
    else:
        A, b = _power_law_matrix(N_H, n_H)
        lam = 0.05
        J = JHybridLsq.from_dense(A, b, float(N_H), D=4)
        P = HybridSparseLeastSquares.from_dense(A, b, float(N_H), D=4,
                                                device="cpu")
    N_, n_ = A.shape
    D = LeastSquaresRows(_t(A), _t(b), float(N_))
    L = (A ** 2).sum(axis=1) * N_
    return (J, P, D, JNormL1(lam=jnp.asarray(lam)), NormL1(lam), L, N_,
            n_)


def _block_ids(key, cfg, steps):
    """JAX's shuffled sweep's next ``steps`` block ids."""
    st = jsampling.init_sweep(key, cfg.N, cfg.batch, cfg.sweeping)
    return np.asarray(jsampling.gen_block_ids(st, steps, cfg.N, cfg.batch,
                                              cfg.sweeping)[0])


def _orders(key, d, epochs):
    """JAX's LFinito visit orders: a permutation per shuffled epoch."""
    out = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, d)))
    return np.stack(out)


def _outer_starts(key, m, steps, cfg):
    """JAX's block starts of ``steps`` outer steps of m inner steps."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jsaga._gen_block_starts(sub, 0, cfg, m)))
    return out


FAMILIES = ["saga", "finito", "lfinito", "svrg", "katyusha", "fista"]


@pytest.mark.parametrize("layout", ["ell", "hybrid"])
@pytest.mark.parametrize("family", FAMILIES)
def test_trajectory_matches_jax_and_dense(family, layout):
    """Each family on the sparse layout, JAX's schedule handed to the port:
    the port's iterate equals JAX's within 1e-9 and the port's dense
    ``LeastSquaresRows`` run on the same schedule."""
    J, P, D, jg, g, L, N_, n_ = _layout(layout)
    B = 16
    x0 = np.zeros(n_)
    key = jax.random.PRNGKey(0)
    outs = []
    if family == "saga":
        gam = 1.0 / (3.0 * L.max())
        jcfg = jsaga.SAGACfg(N=N_, sag=False, batch=B, block=True,
                             coeff=True)
        want = jsaga.saga_run(J, jg, jsaga.saga_init(
            J, jg, jnp.asarray(x0), jnp.asarray(gam), key, jcfg), jcfg, 40).z
        starts = _t(jsaga._gen_block_starts(key, 1, jcfg, 40))
        cfg = tsaga.SAGACfg(N=N_, sag=False, batch=B, block=True, coeff=True)
        for F in (P, D):
            outs.append(tsaga.saga_run(F, g, tsaga.saga_init(
                F, g, _t(x0), _t(gam), 0, cfg), cfg, 40, starts=starts).z)
    elif family in ("finito", "lfinito"):
        gamma = 0.999 * N_ / L
        jcfg = jfin.FinitoCfg(N=N_, batch=B, sweeping=3, alpha=0.999)
        cfg = tfin.FinitoCfg(N=N_, batch=B, sweeping=3, alpha=0.999)
        if family == "finito":
            want = jfin.finito_run(J, jg, jfin.finito_coeff_init(
                J, jg, jnp.asarray(x0), jnp.asarray(gamma), key, jcfg),
                jcfg, "basic_coeff", 40).z
            blocks = _block_ids(key, jcfg, 40)
            for F in (P, D):
                outs.append(tfin.finito_run(F, g, tfin.finito_coeff_init(
                    F, g, _t(x0), _t(gamma), 0, cfg), cfg, "basic_coeff", 40,
                    blocks=blocks).z)
        else:
            want = jfin.finito_run(J, jg, jfin.lfinito_init(
                J, jg, jnp.asarray(x0), jnp.asarray(gamma), key, jcfg),
                jcfg, "lfinito", 4).z
            orders = _orders(key, N_ // B, 4)
            for F in (P, D):
                outs.append(tfin.finito_run(F, g, tfin.lfinito_init(
                    F, g, _t(x0), _t(gamma), 0, cfg), cfg, "lfinito", 4,
                    blocks=orders).z)
    elif family == "svrg":
        gam = 1.0 / (10.0 * L.max())
        jcfg = jsvrg.SVRGCfg(N=N_, plus=False, batch=B, block=True)
        want = jsvrg.svrg_run(J, jg, jsvrg.svrg_init(
            J, jg, jnp.asarray(x0), jnp.asarray(gam), 8, key, jcfg), jcfg,
            3).z_full
        starts = _outer_starts(key, 8, 3, jcfg)
        cfg = tsvrg.SVRGCfg(N=N_, plus=False, batch=B, block=True)
        for F in (P, D):
            outs.append(tsvrg.svrg_run(F, g, tsvrg.svrg_init(
                F, g, _t(x0), _t(gam), 8, 0, cfg), cfg, 3,
                starts=starts).z_full)
    elif family == "katyusha":
        m = 2 * N_ // B
        jcfg = jkat.KatyushaCfg(N=N_, batch=B, m=m, block=True, ns=True)
        want = jkat.katyusha_run(J, jg, jkat.katyusha_init(
            J, jg, jnp.asarray(x0), jnp.asarray(L.max()), jnp.asarray(0.5),
            jnp.asarray(0.5), key, jcfg), jcfg, 3).y
        starts = _outer_starts(key, m, 3, jcfg)
        cfg = tkat.KatyushaCfg(N=N_, batch=B, m=m, block=True, ns=True)
        for F in (P, D):
            outs.append(tkat.katyusha_run(F, g, tkat.katyusha_init(
                F, g, _t(x0), L.max(), 0.5, 0.5, 0, cfg), cfg, 3,
                starts=starts).y)
    else:
        gam = 1.0 / L.mean()
        jcfg = jfb.FBCfg(N=N_, fast=True)
        want = jfb.fb_run(J, jg, jfb.fb_init(J, jg, jnp.asarray(x0),
                                             jnp.asarray(gam), jcfg),
                          jcfg, 30).x
        cfg = tfb.FBCfg(N=N_, fast=True)
        for F in (P, D):
            outs.append(tfb.fb_run(F, g, tfb.fb_init(F, g, _t(x0), _t(gam),
                                                     cfg), cfg, 30).x)
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_facades_route_sparse_rows_stepwise_and_warn_for_ell(monkeypatch):
    """The kernels' gates close on sparse rows (no ``coeff_rows_data``),
    and on a CUDA device the fallback warning names the hybrid for pure
    ELL and stays silent for the hybrid."""
    from ciao_tpu_torch.ops import fused_block as fb

    _, Pe, _ = _oracles("ell_lsq")
    _, Ph, _ = _oracles("hybrid_lsq")
    x0 = torch.zeros(n, dtype=torch.float32)
    for F in (Pe, Ph):
        assert not fb.saga_multistep_available(F, NormL1(0.1), x0, 16)
        assert not fb.full_grad_available(F, x0)
        assert not fb.finito_block_available(F, x0, 16)
    monkeypatch.setattr(runtime, "on_cuda", lambda: True)
    runtime.reset_fallback_warnings()
    cuda_x0 = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    dtype=torch.float32)
    try:
        with pytest.warns(UserWarning, match="HybridSparseLeastSquares"):
            tsaga._warn_fallback("SAGA", Pe, NormL1(0.1), cuda_x0)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tsaga._warn_fallback("SAGA", Ph, NormL1(0.1), cuda_x0)
    finally:
        runtime.reset_fallback_warnings()


# ---------------------------------------------------------------------------
# the block-protocol polish and power bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ell_lsq", "hybrid_lsq", "ell_logistic"])
def test_grad_mean_chunked_blocks_matches_jax(kind):
    J, P, _ = _oracles(kind)
    x = np.random.default_rng(3).standard_normal(J.dim)
    want = jpolish.grad_mean_chunked_blocks(J, jnp.asarray(x), 32)
    _close(tpolish.grad_mean_chunked_blocks(P, _t(x), 32), want)
    _close(tpolish.grad_mean_chunked_blocks(P, _t(x), 32),
           np.asarray(J.grad_sum_all(jnp.asarray(x))) / J.num_terms, 1e-12)
    with pytest.raises(ValueError, match="must divide"):
        tpolish.grad_sum_chunked_blocks(P, _t(x), 48 if kind == "ell_lsq"
                                        else 7)


def _dense(P):
    """The f64 dense rows of a sparse oracle."""
    A = torch.zeros(P.num_terms, P.dim, dtype=torch.float64)
    A.scatter_add_(1, P.idx.long(), P.val.double())
    if P.A_hot is not None:
        A.index_add_(1, P.hot_cols.long(), P.A_hot.double())
    return A


@pytest.mark.parametrize("kind", ["ell_lsq", "hybrid_lsq"])
def test_power_lmax_quadratic_is_the_dense_eigenvalue(kind):
    _, P, _ = _oracles(kind)
    A = _dense(P)
    lam = float(torch.linalg.eigvalsh(float(P.scale) * A.T @ A
                                      / P.num_terms).max())
    got = float(tpolish.power_lmax_quadratic(P, seed=1, iters=200))
    assert abs(got - lam) <= 1e-3 * lam, (got, lam)


@pytest.mark.parametrize("kind", ["ell_logistic", "hybrid_logistic",
                                  "ell_lsq"])
def test_power_lmax_weighted_is_the_dense_eigenvalue(kind):
    _, P, _ = _oracles(kind)
    A = _dense(P)
    x = torch.tensor(np.random.default_rng(4).standard_normal(P.dim))
    for slack in (0.0, 0.5):
        w = torch.broadcast_to(P.hess_weight_from_margin(A @ x, slack),
                               (P.num_terms,))
        lam = float(torch.linalg.eigvalsh(
            A.T @ (w[:, None] * A) / P.num_terms).max())
        got = float(tpolish.power_lmax_weighted(P, x, seed=1, iters=200,
                                                margin_slack=slack))
        assert abs(got - lam) <= 1e-3 * lam, (slack, got, lam)
    with pytest.raises(ValueError, match="margin protocol"):
        tpolish.power_lmax_weighted(ZeroOracle(n_terms=4), x, seed=1)


# ---------------------------------------------------------------------------
# deep_solve on JAX's planted problem, carried across
# ---------------------------------------------------------------------------

NP, NPX = 2_048, 256


@pytest.fixture(scope="module")
def jax_planted():
    """JAX's 2,048 x 256 planted sparse Lasso (tests/test_deep.py:227) in
    both layouts, carried across as f32."""
    jp = jmake_sparse(N=NP, n=NPX, hot=64, k_hot=8, k_cold=4, p=16,
                      rho=1.0, seed=0)
    E, H = jp.ell, jp.hybrid
    ell = convert.sparse_least_squares_ell_from_numpy(
        E.idx, E.val, E.b, E.scale, E.n_dim, device="cpu")
    hyb = convert.hybrid_sparse_least_squares_from_numpy(
        H.A_hot, H.hot_cols, H.idx, H.val, H.b, H.scale, H.n_dim,
        device="cpu")
    return jp, ell, hyb


def test_deep_solve_sparse_lsq_reaches_rel_1e6(jax_planted):
    jp, ell, hyb = jax_planted
    A = _dense(ell)
    b = ell.b.double()

    def cost64(z):
        r = A @ z.double() - b
        return 0.5 * float(r @ r) + jp.lam * float(z.double().abs().sum())

    f_ref = cost64(_t(jp.x_star))
    g = NormL1(torch.tensor(jp.lam, dtype=torch.float32))
    for name, F in (("ell", ell), ("hybrid", hyb)):
        x, info = deep_solve(torch.zeros(NPX), F, g, L=_t(jp.L), N=NP,
                             batch=256, chunk_epochs=8, max_epochs=64,
                             plateau_rtol=1e-4, polish_max_rounds=24)
        rel = (cost64(x) - f_ref) / abs(f_ref)
        assert rel <= 1e-6, (name, rel)
        assert info.polish_steps > 0


def test_deep_solve_sparse_logistic_reaches_rel_1e6(jax_planted):
    """Sparse logistic rows on the same design (y = ±1, λ = 0.002, as
    tests/test_deep.py:495): the block-protocol polish with the weighted
    bound, against an f64 reference of the port's ELL oracle by the same
    restarting FISTA run until its residual stalls (JAX's 20,000-step
    dense FISTA is not rerun here)."""
    jp, ell, hyb = jax_planted
    y = torch.tensor(np.sign(np.random.default_rng(1).standard_normal(NP)),
                     dtype=torch.float32)
    lam = 0.002
    F64 = SparseLogisticELL(ell.idx, ell.val.double(), y.double(), NPX)

    def cost64(z):
        z = z.double()
        return float(F64.value_sum_all(z)) / NP + lam * float(z.abs().sum())

    g64 = NormL1(torch.tensor(lam, dtype=torch.float64))
    eta = 0.9 / float(tpolish.power_lmax_weighted(
        F64, torch.zeros(NPX), seed=2, iters=100))
    xr, res = torch.zeros(NPX, dtype=torch.float64), []
    for _ in range(60):
        out = tpolish.fista_polish(F64, g64, xr, eta, 50, NP,
                                   block_protocol=True)
        xr = out.x
        res.append(float(out.fp_res))
        if res[-1] < 1e-13 or (len(res) > 1 and res[-1] > res[-2] / 1.5):
            break
    f_ref = cost64(xr)
    g = NormL1(torch.tensor(lam, dtype=torch.float32))
    L = 0.25 * (_dense(ell) ** 2).sum(dim=1).float()
    for name, F in (("ell", SparseLogisticELL(ell.idx, ell.val, y, NPX)),
                    ("hybrid", HybridSparseLogistic(
                        hyb.A_hot, hyb.hot_cols, hyb.idx, hyb.val, y, NPX))):
        x, info = deep_solve(torch.zeros(NPX), F, g, L=L, N=NP, batch=256,
                             chunk_epochs=8, max_epochs=96,
                             plateau_rtol=1e-4, margin_slack=0.5,
                             polish_steps=8, polish_max_rounds=48)
        rel = (cost64(x) - f_ref) / abs(f_ref)
        assert -1e-6 < rel <= 1e-6, (name, rel)
        assert info.polish_steps > 0


def test_deep_solve_refuses_other_sparse_losses(jax_planted, monkeypatch):
    jp, ell, _ = jax_planted
    monkeypatch.setattr(SparseLeastSquaresELL, "coeff_mode", 7)
    with pytest.raises(ValueError, match="quadratic"):
        deep_solve(torch.zeros(NPX), ell, NormL1(jp.lam), L=_t(jp.L), N=NP,
                   batch=256, chunk_epochs=4, max_epochs=8)


# ---------------------------------------------------------------------------
# the port's planted problem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hot,hot_pad", [(64, 128), (200, 256)])
def test_make_sparse_lasso_ell_follows_the_recipe(hot, hot_pad):
    """The KKT certificate of tests/test_sparse.py:457-464 (|Aᵀr*| ≤ λ, =
    λ on the support, ≤ 0.95λ off it), both layouts one operator, the hot
    block's padding, cold duplicates zeroed, L = ‖a_i‖²·N and f* =
    ½‖y*‖² + λ‖x*‖₁ = cost(x*)."""
    k_hot, k_cold, p = 8, 4, 16
    prob = make_sparse_lasso_ell(N=NP, n=NPX, hot=hot, k_hot=k_hot,
                                 k_cold=k_cold, p=p, rho=1.0, seed=3,
                                 device="cpu")
    E, H = prob.ell, prob.hybrid
    assert H.A_hot.shape == (NP, hot_pad) and E.idx.shape == (NP,
                                                              k_hot + k_cold)
    assert torch.equal(H.hot_cols, torch.arange(hot_pad, dtype=torch.int32))
    assert int((prob.x_star != 0).sum()) == p
    gs = E.grad_sum_all(prob.x_star).double() / NP
    supp = prob.x_star != 0
    assert float(gs.abs().max()) <= prob.lam * 1.001
    assert float((gs[supp].abs() - prob.lam).abs().max()) < 1e-3
    assert float(gs[~supp].abs().max()) <= prob.lam * 0.96
    A_e, A_h = _dense(E), _dense(H)
    np.testing.assert_allclose(A_h.numpy(), A_e.numpy(), rtol=0, atol=1e-6)
    cold = H.idx.long().where(H.val != 0, -torch.arange(1, k_cold + 1))
    assert all(len(set(r)) == k_cold for r in cold.tolist())
    assert bool((H.idx[H.val != 0] >= hot).all())
    np.testing.assert_allclose(prob.L.double().numpy(),
                               (A_e ** 2).sum(dim=1).numpy() * NP, rtol=1e-5)
    r = A_e @ prob.x_star.double() - E.b.double()
    cost = 0.5 * float(r @ r) + prob.lam * float(
        prob.x_star.double().abs().sum())
    assert abs(cost - prob.f_star) <= 1e-6 * prob.f_star


def test_nan_median_nearest_is_jaxs_rule():
    """At an even count JAX's "nearest" median takes the lower middle
    entry, where numpy and torch round the index half to even."""
    rng = np.random.default_rng(0)
    median = jax.jit(lambda a: jnp.nanquantile(a, 0.5, method="nearest"))
    ties = 0
    for m in range(1, 24):
        a = np.full(24, np.nan, np.float32)
        a[:m] = rng.standard_normal(m)
        a = rng.permutation(a)
        want = float(median(jnp.asarray(a)))
        assert float(nan_median_nearest(torch.tensor(a))) == want
        ties += want != float(np.nanquantile(a, 0.5, method="nearest"))
    assert ties > 0


SPARSE_MODULES = ("oracles/sparse.py", "utils/problems.py",
                  "solvers/polish.py", "solvers/deep.py", "solvers/saga.py",
                  "convert.py")


@pytest.mark.parametrize("path", SPARSE_MODULES)
def test_sparse_modules_import_no_jax(path):
    """The modules of the sparse route name no ``jax`` and nothing of
    ``ciao_tpu`` in any import, at the top or inside a function
    (tests/test_torch_saga.py's ``test_port_imports_no_jax`` imports them
    in a fresh interpreter)."""
    import ast
    import pathlib

    import ciao_tpu_torch

    src = pathlib.Path(ciao_tpu_torch.__file__).parent / path
    names = []
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib",
                                                    "ciao_tpu")]
    assert names and not bad, bad
