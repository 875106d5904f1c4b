"""``Precompose`` and ``CustomOracle`` in the port against the JAX package
on the CPU.

``tests/test_oracles.py:140`` (a custom least-squares family equals the
hand-written rows) and ``:178`` (``Precompose`` of a scalar logistic
loss equals ``LogisticRows``), the Welsch halves of
``tests/test_nonconvex.py`` (``:37`` SARAH, ``:96`` PANOC) at JAX's
bars, the batched paths (gathered data, a ``vmap`` of the gradient)
against the per-term ones, JAX's values and gradients on real iterates,
SAGA's steps on a custom family against JAX's on JAX's schedule, and the
complex convention: the port's gradients are conj(a)·r, the rows'
convention, where JAX's ``CustomOracle`` returns the conjugate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciao_tpu import oracles as joracles
from ciao_tpu.prox import Zero as JZero
from ciao_tpu.solvers import saga as jsaga
from ciao_tpu_torch import FISTA, PANOC, SARAH, CustomOracle, Precompose
from ciao_tpu_torch.oracles import LeastSquaresRows, LogisticRows
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers import saga as tsaga
from test_torch_complex import _batched_paths_consistent
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _lsq(x, d):
    return 0.5 * (d["a"] @ x - d["b"]) ** 2


def _jlsq(x, d):
    return 0.5 * (d["a"] @ x - d["b"]) ** 2


def _abs_lsq(x, d):
    """½|a·x − b|² for complex x and rows."""
    r = d["a"] @ x - d["b"]
    return 0.5 * (r.real ** 2 + r.imag ** 2)


def _jabs_lsq(x, d):
    r = d["a"] @ x - d["b"]
    return 0.5 * jnp.real(r * jnp.conj(r))


def test_custom_oracle_matches_handwritten():
    """tests/test_oracles.py:140: a custom least-squares family equals the
    hand-written rows term by term (1e-10), and JAX's custom family."""
    rng = np.random.default_rng(4)
    N, n = 5, 4
    A = rng.standard_normal((N, n))
    b = rng.standard_normal(N)
    custom = CustomOracle(data={"a": _t(A), "b": _t(b)}, fun=_lsq)
    hand = LeastSquaresRows(_t(A), _t(b), 1.0)
    jcustom = joracles.CustomOracle(
        data={"a": jnp.asarray(A), "b": jnp.asarray(b)}, fun=_jlsq)
    x = rng.standard_normal(n)
    assert custom.num_terms == N
    for i in range(N):
        v1, g1 = custom.value_and_grad_i(_t(x), torch.tensor(i))
        v2, g2 = hand.value_and_grad_i(_t(x), torch.tensor(i))
        v3, g3 = jcustom.value_and_grad_i(jnp.asarray(x), jnp.asarray(i))
        np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-10)
        np.testing.assert_allclose(g1.numpy(), g2.numpy(), atol=1e-10)
        np.testing.assert_allclose(v1.numpy(), np.asarray(v3), atol=1e-12)
        np.testing.assert_allclose(g1.numpy(), np.asarray(g3), atol=1e-12)
    _batched_paths_consistent(custom, _t(x))


def _logistic_pair(N=6, n=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, n))
    y = np.sign(rng.standard_normal(N))
    base = CustomOracle(
        data={"y": _t(y)},
        fun=lambda v, d: torch.nn.functional.softplus(-d["y"] * v[0]))
    pre = Precompose(base, _t(X)[:, None, :])
    jbase = joracles.CustomOracle(
        data={"y": jnp.asarray(y)},
        fun=lambda v, d: jnp.logaddexp(0.0, -d["y"] * v[0]))
    jpre = joracles.Precompose(base=jbase, Lmat=jnp.asarray(X)[:, None, :])
    return X, y, pre, jpre, rng.standard_normal(n)


def test_precompose_matches_folded_logistic():
    """tests/test_oracles.py:178: Precompose(scalar logistic, a_iᵀ rows)
    equals LogisticRows (values rtol 1e-12, gradients 1e-10), its batched
    paths the per-term ones, and JAX's Precompose."""
    X, y, pre, jpre, x = _logistic_pair()
    folded = LogisticRows(_t(X), _t(y))
    for i in range(6):
        v1, g1 = pre.value_and_grad_i(_t(x), i)
        v2, g2 = folded.value_and_grad_i(_t(x), i)
        v3, g3 = jpre.value_and_grad_i(jnp.asarray(x), i)
        np.testing.assert_allclose(float(v1), float(v2), rtol=1e-12)
        np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-10)
        np.testing.assert_allclose(float(v1), float(v3), rtol=1e-12)
        np.testing.assert_allclose(g1.numpy(), np.asarray(g3), rtol=1e-10)
    _batched_paths_consistent(pre, _t(x))


def test_precompose_shift_and_blocks_match_jax():
    """A general (N, m, n) map with a shift over a custom base: every
    batched and block path equals JAX's generic one (vmap of the per-term
    chain rule) to 1e-12 on real iterates."""
    rng = np.random.default_rng(3)
    N, m, n = 7, 3, 4
    Lm = rng.standard_normal((N, m, n))
    t = rng.standard_normal((N, m))
    w = rng.standard_normal((N, m))
    fun = (lambda v, d: 0.5 * torch.sum(d["w"] * v * v)
           + torch.sum(torch.sin(v)))
    jfun = (lambda v, d: 0.5 * jnp.sum(d["w"] * v * v)
            + jnp.sum(jnp.sin(v)))
    pre = Precompose(CustomOracle({"w": _t(w)}, fun), _t(Lm), _t(t))
    jpre = joracles.Precompose(
        base=joracles.CustomOracle(data={"w": jnp.asarray(w)}, fun=jfun),
        Lmat=jnp.asarray(Lm), shift=jnp.asarray(t))
    x, x2 = rng.standard_normal(n), rng.standard_normal(n)
    xs = rng.standard_normal((4, n))
    idx = np.array([6, 0, 3, 3])
    for name, args in (("value_and_grad_batch", (x, idx)),
                       ("grad_sum_batch", (x, idx)),
                       ("grad_sum_diff", (x, x2, idx)),
                       ("value_and_grad_all", (x,)),
                       ("grad_sum_all", (x,)),
                       ("value_sum_and_grad_sum_all", (x,)),
                       ("value_and_grad_pointwise", (xs, idx)),
                       ("grad_block", (x, 2, 4)),
                       ("grad_pointwise_block", (xs, 1, 4))):
        got = getattr(pre, name)(*(_t(a) if isinstance(a, np.ndarray)
                                   else a for a in args))
        want = getattr(jpre, name)(*(jnp.asarray(a) for a in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                       rtol=1e-12, atol=1e-12, err_msg=name)


def test_custom_oracle_data_tree_device_and_n_terms():
    """``data`` is a tree of buffers (``.to`` moves every leaf and the
    tree comes back as given); ``n_terms`` overrides the leading size, as
    JAX's field does."""
    A = torch.arange(12.0).reshape(4, 3)
    F = CustomOracle({"rows": [A, (A[:, 0], torch.ones(4))]},
                     fun=lambda x, d: d["rows"][0] @ x + d["rows"][1][1])
    assert F.num_terms == 4
    assert sorted(dict(F.named_buffers())) == ["_leaf0", "_leaf1", "_leaf2"]
    assert F.to("cpu") is F and F.to(torch.float64)._leaf0.dtype == \
        torch.float64
    data = F.data
    assert isinstance(data["rows"], list) and isinstance(data["rows"][1],
                                                         tuple)
    assert CustomOracle({"a": A}, fun=lambda x, d: d["a"] @ x,
                        n_terms=2).num_terms == 2
    v, g = F.value_and_grad_batch(torch.ones(3, dtype=torch.float64),
                                  torch.tensor([1, 3]))
    np.testing.assert_array_equal(v.numpy(), [13.0, 31.0])
    np.testing.assert_array_equal(g.numpy(), F.data["rows"][0][[1, 3]])


def test_complex_convention_is_the_rows():
    """The port's gradient of ½|a·x − b|² on a complex iterate is
    conj(a)·r, as ``LeastSquaresRows`` gives (a = 0.5 − 1j, b = 0.3 +
    0.1j, x = 1 + 2j: 1.2 + 2.15j), where JAX's ``CustomOracle`` returns
    the conjugate (1.2 − 2.15j); on a real iterate all three agree.
    A change on either side shows here."""
    a, b, x = 0.5 - 1j, 0.3 + 0.1j, 1 + 2j
    F = CustomOracle({"a": _t([[a]]), "b": _t([b])}, fun=_abs_lsq)
    R = LeastSquaresRows(_t([[a]]), _t([b]), 1.0)
    J = joracles.CustomOracle(
        data={"a": jnp.asarray([[a]]), "b": jnp.asarray([b])},
        fun=_jabs_lsq)
    g = F.value_and_grad_i(_t([x]), 0)[1].numpy()
    np.testing.assert_allclose(g, [1.2 + 2.15j], atol=1e-14)
    np.testing.assert_allclose(g, R.value_and_grad_i(_t([x]), 0)[1].numpy(),
                               atol=1e-14)
    jg = np.asarray(J.value_and_grad_i(jnp.asarray([x]), 0)[1])
    np.testing.assert_allclose(jg, [1.2 - 2.15j], atol=1e-14)
    np.testing.assert_allclose(np.conj(jg), g, atol=1e-14)
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 3)) + 1j * rng.standard_normal((6, 3))
    bb = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    F = CustomOracle({"a": _t(A), "b": _t(bb)}, fun=_abs_lsq)
    R = LeastSquaresRows(_t(A), _t(bb), 1.0)
    xc = _t(rng.standard_normal(3) + 1j * rng.standard_normal(3))
    for got, want in zip(F.value_and_grad_all(xc), R.value_and_grad_all(xc)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-14)
    assert F.value_and_grad_all(xc)[0].dtype == torch.float64
    # a facade on the custom family walks the rows' trajectory
    for Fx in (F, R):
        xf, _ = FISTA(maxit=50)(torch.zeros(3, dtype=torch.complex128), F=Fx,
                                g=NormL1(0.1), L=np.full(6, 60.0), N=6)
        if Fx is F:
            x_custom = xf
    np.testing.assert_allclose(x_custom.numpy(), xf.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_saga_on_a_custom_family_matches_jax():
    """SAGA's full-table steps on a custom least-squares family (no
    coefficient protocol) from JAX's init on JAX's block schedule: z, av
    and the table within 1e-10 after 40 steps."""
    rng = np.random.default_rng(6)
    N, n, B, steps = 32, 4, 4, 40
    A = rng.standard_normal((N, n))
    b = rng.standard_normal(N)
    F = CustomOracle({"a": _t(A), "b": _t(b)}, fun=_lsq)
    JF = joracles.CustomOracle(data={"a": jnp.asarray(A),
                                     "b": jnp.asarray(b)}, fun=_jlsq)
    gamma = 1.0 / (3.0 * float(np.max((A * A).sum(1))))
    kw = dict(N=N, sag=False, batch=B, block=True)
    jcfg, cfg = jsaga.SAGACfg(**kw), tsaga.SAGACfg(**kw)
    key = jax.random.PRNGKey(2)
    jst = jsaga.saga_run(JF, JZero(), jsaga.saga_init(
        JF, JZero(), jnp.zeros(n), jnp.asarray(gamma), key, jcfg), jcfg,
        steps)
    starts = _t(jsaga._gen_block_starts(key, 1, jcfg, steps))
    st = tsaga.saga_run(F, Zero(), tsaga.saga_init(
        F, Zero(), torch.zeros(n, dtype=torch.float64), gamma, 0, cfg), cfg,
        steps, starts=starts)
    for name in ("z", "av", "s"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


def _planted_outlier_problem(N=256, n=16, frac=0.2, seed=0):
    """tests/test_nonconvex.py's planted signal with 20 % gross outliers."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, n)).astype(np.float32)
    x_true = rng.standard_normal(n).astype(np.float32)
    b = A @ x_true + 0.01 * rng.standard_normal(N).astype(np.float32)
    out = rng.choice(N, size=int(frac * N), replace=False)
    b[out] += 50.0 * rng.standard_normal(out.size).astype(np.float32)
    return A, b, x_true


def _welsch(x, d, sigma=1.0):
    r = torch.dot(d["a"], x) - d["b"]
    return 0.5 * sigma ** 2 * (1.0 - torch.exp(-(r * r) / sigma ** 2))


@pytest.mark.parametrize("solver", ["sarah", "panoc"])
def test_nonconvex_welsch(solver):
    """tests/test_nonconvex.py:37 (SARAH, 200 outer steps of 32 blocks of
    8) and :96 (PANOC, 200 steps): the nonconvex Welsch loss through
    ``CustomOracle`` from the least-squares warm start recovers the
    planted signal through the outliers (max |x − x_true| < 0.05, where
    least squares is dragged 5x farther off), at a stationary point
    (‖Σ∇f_i‖/N < 1e-4 SARAH, 1e-5 PANOC)."""
    A, b, x_true = _planted_outlier_problem()
    N = A.shape[0]
    F = CustomOracle({"a": _t(A), "b": _t(b)}, fun=_welsch)
    L = (A * A).sum(axis=1)
    x0 = _t(np.linalg.lstsq(A, np.clip(b, -5, 5), rcond=None)[0]
            .astype(np.float32))
    if solver == "sarah":
        x, _ = SARAH(maxit=200, m=32, batch=8, block_sampling=True)(
            x0, F=F, L=L, N=N)
    else:
        x, _ = PANOC(maxit=200)(x0, F=F, L=L, N=N)
    assert x.dtype == torch.float32
    xd = x.double().numpy()
    assert np.max(np.abs(xd - x_true)) < 0.05
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    assert np.max(np.abs(x_ls - x_true)) > 5 * np.max(np.abs(xd - x_true))
    gn = float(torch.linalg.norm(F.grad_sum_all(x))) / N
    assert gn < (1e-4 if solver == "sarah" else 1e-5)
