"""The port's forward-backward / FISTA path and kernel #6 against the JAX
package on the CPU.

``coeff_apply_all_ref`` (the plain version of the one-pass kernel) is held
against the Pallas kernel in interpret mode, and against the adversarial
stream of tests/test_ops.py that a plain f32 sum gets wrong; ``fb_run``
against JAX's in f64 and, fused, at f32; the facades solve
tests/test_fb.py's planted Lasso. The kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.prox import NormL1 as JNormL1
from ciao_tpu.solvers import fb as jfbs
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch.convert import (
    fb_state_from_numpy, least_squares_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import (
    FISTA, FBCfg, ForwardBackward, fb_init, fb_run, fb_step, full_gradient,
    solution, take,
)
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.tensor(np.asarray(a))


def _port_oracle(JF):
    return least_squares_from_numpy(
        np.asarray(JF.A), np.asarray(JF.b), np.asarray(JF.scale),
        None if JF.row_scale is None else np.asarray(JF.row_scale),
        device="cpu")


# ---------------------------------------------------------------------------
# kernel #6's plain version
# ---------------------------------------------------------------------------

MODES = [jfb.MODE_LSQ, jfb.MODE_LOGISTIC, jfb.MODE_HUBER, jfb.MODE_SQHINGE,
         jfb.MODE_POISSON]


@pytest.mark.parametrize("mode", MODES,
                         ids=["lsq", "logistic", "huber", "sqhinge",
                              "poisson"])
@pytest.mark.parametrize("storage,precision", [
    ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
    ("int8", "highest"),
], ids=["f32", "f32-default", "bf16", "int8"])
def test_coeff_apply_all_ref_matches_pallas(storage, precision, mode):
    """tests/test_ops.py:346's problem and bounds (c rtol 1e-4, atol 1e-3
    relative to its largest entry; gsum rtol 1e-3, atol 1e-1 relative)
    for every formula mode through the scalars row, labels ±1 for the
    classification modes and counts for Poisson. "default" rounds both
    dot operands to bf16; XLA on the CPU keeps f32 dots exact, so its
    reference is the same rows stored bf16."""
    Np, npix = 1024, 128
    prob = make_lasso(N=Np, n=npix, p=4, seed=7, dtype=np.float32)
    rng = np.random.default_rng(mode)
    b = prob.b.astype(np.float32)
    if mode in (jfb.MODE_LOGISTIC, jfb.MODE_SQHINGE):
        b = np.sign(rng.standard_normal(Np)).astype(np.float32)
    elif mode == jfb.MODE_POISSON:
        b = rng.poisson(2.0, Np).astype(np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(b),
                           scale=jnp.asarray(float(Np), jnp.float32))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    z = (0.3 * rng.standard_normal(npix)).astype(np.float32)
    scale = float(Np) if mode in (jfb.MODE_LSQ, jfb.MODE_HUBER) else 1.0
    sc = np.array([scale, mode, 0.05], np.float32)
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jc, jg = jfb.coeff_apply_all(
            jA, jnp.asarray(b)[None], jnp.asarray(z)[None],
            jnp.asarray(sc)[None], jfb._pick_tile(128, Np, npix),
            precision=precision,
            rs1=None if rs is None else jnp.asarray(rs)[None])
    jc, jg = np.asarray(jc)[0], np.asarray(jg)[0]
    A = (_t(np.asarray(JF.A.astype(jnp.float32))).to(torch.bfloat16)
         if storage == "bf16" else _t(np.asarray(JF.A)))
    before = tfb.coeff_apply_all.launches
    c, g = tfb.coeff_apply_all(A, _t(b), _t(z), _t(sc), precision=precision,
                               rs=None if rs is None else _t(rs))
    assert tfb.coeff_apply_all.launches == before  # the plain version
    assert c.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-4,
                               atol=1e-3 * np.abs(jc).max())
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-3,
                               atol=1e-1 * np.abs(jg).max() / Np)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_coeff_apply_all_ref_ragged_wide_tiles_match_pallas(storage):
    """At the deep target's width n = 128 the walk's tiles hold more than
    32 rows (96 f32, 256 int8), and N = 1,088 leaves a ragged last tile
    (32 f32 rows, 64 int8): the plain version against the Pallas kernel in
    interpret mode (its 64-row tiles), at
    test_coeff_apply_all_ref_matches_pallas's bounds."""
    Np, npix = 1088, 128
    R = tfb._apply_rows(npix, 4 if storage == "f32" else 1)
    assert R > 32 and Np % R
    prob = make_lasso(N=Np, n=npix, p=4, seed=9, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A),
                           b=jnp.asarray(prob.b.astype(np.float32)),
                           scale=jnp.asarray(float(Np), jnp.float32))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    z = (0.3 * np.random.default_rng(9).standard_normal(npix)).astype(
        np.float32)
    sc = np.array([float(Np), jfb.MODE_LSQ, 0.0], np.float32)
    with pltpu.force_tpu_interpret_mode():
        jc, jg = jfb.coeff_apply_all(
            JF.A, jnp.asarray(prob.b.astype(np.float32))[None],
            jnp.asarray(z)[None], jnp.asarray(sc)[None],
            jfb._pick_tile(Np, Np, npix),
            rs1=None if rs is None else jnp.asarray(rs)[None])
    jc, jg = np.asarray(jc)[0], np.asarray(jg)[0]
    c, g = tfb.coeff_apply_all(_t(JF.A), _t(prob.b.astype(np.float32)),
                               _t(z), _t(sc),
                               rs=None if rs is None else _t(rs))
    np.testing.assert_allclose(c.numpy(), jc, rtol=1e-4,
                               atol=1e-3 * np.abs(jc).max())
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-3,
                               atol=1e-1 * np.abs(jg).max() / Np)


def test_coeff_apply_all_ref_is_the_oracle_pass():
    """Within the port, at a ragged N (no whole last tile): with f32 rows
    c is the oracle's coeff_all and gsum its grad_sum_all; with int8 rows
    (both dot operands in bf16) c is coeff_all at the bf16-rounded z."""
    prob = make_lasso(N=1001, n=37, p=3, seed=2, dtype=np.float32)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 1001.0)
    z = torch.tensor(np.random.default_rng(0).standard_normal(37) * 0.1,
                     dtype=torch.float32)
    assert tfb._apply_rows(37, 4) == 256  # 3 whole tiles and 233 rows
    c, g = tfb.oracle_apply_all(F, z)
    torch.testing.assert_close(c, F.coeff_all(z), rtol=1e-5, atol=1e-3)
    want = F.grad_sum_all(z)
    torch.testing.assert_close(g, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    F8 = F.with_storage("int8")
    c8, _ = tfb.oracle_apply_all(F8, z)
    torch.testing.assert_close(c8, F8.coeff_all(tfb._bf16_round(z)),
                               rtol=1e-5, atol=1e-3)


def test_coeff_apply_all_compensated_accumulation():
    """tests/test_ops.py:367's adversarial stream at its full size (N =
    262,144, n = 128): the first 2,048 rows have c = 2^18, the rest
    1e-3; gsum[0] = Σ c_i exactly. A plain f32 running sum drops most of
    the small rows into the big partial's ulp; the plain version's
    compensated tile sum keeps them, err < 0.05·lost as the JAX test
    holds its kernel."""
    Np, npix, TILE = 262_144, 128, 2_048
    A = torch.zeros(Np, npix)
    A[:, 0] = 1.0
    b = torch.full((Np,), -1e-3)
    b[:TILE] = -(2.0 ** 18)
    exact = 2.0 ** 18 * TILE + 1e-3 * (Np - TILE)
    lost = 1e-3 * (Np - TILE)
    _, g = tfb.coeff_apply_all(A, b, torch.zeros(npix),
                               torch.tensor([1.0, 0.0, 0.0]))
    assert abs(float(g[0]) - exact) < 0.05 * lost
    naive = torch.zeros(())
    for chunk in (-b).split(2_048):
        naive = naive + chunk.sum()
    assert abs(float(naive) - exact) > 0.05 * lost  # the stream bites


def test_apply_wrapper_rejects_devices_without_kernel():
    m = torch.empty((64, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.coeff_apply_all(m, torch.empty(64, device="meta"),
                            torch.empty(8, device="meta"),
                            torch.empty(3, device="meta"))
    F = LeastSquaresRows(torch.randn(64, 8), torch.randn(64), 64.0)
    assert not tfb.full_grad_available(F, torch.zeros(8))


@pytest.mark.parametrize("n,itemsize,rows,per_sm", [
    (1024, 4, 12, 2), (1024, 2, 24, 2), (1024, 1, 48, 2), (128, 4, 96, 2),
    (128, 2, 192, 2), (128, 1, 256, 2), (64, 1, 256, 2), (3_072, 4, 4, 2),
    (4_096, 1, 11, 2), (4_096, 4, 2, 2), (8_192, 4, 2, 1), (8_192, 1, 11, 1),
    (12_288, 4, 1, 1), (16_384, 4, 1, 1), (16_384, 2, 2, 1),
    (16_384, 1, 4, 1),
])
def test_apply_rows_fit_shared_memory(n, itemsize, rows, per_sm):
    """Up to 4,096 columns two CTAs share an SM, each with tiles of as many
    whole rows as fit 48 KB and its half of the shared memory, at most 256
    (one a thread); wider rows take the wide walk, one CTA an SM, its tiles
    as many rows as fit all of it, and the widest (n = 16,384 f32: one
    64 KB row a tile) still fit."""
    assert tfb._apply_rows(n, itemsize) == rows
    assert tfb._apply_ctas_per_sm(n) == per_sm
    half = tfb.SMEM_BYTES // 2 - 1024
    assert tfb._apply_smem_bytes(rows, n, itemsize) <= (
        half if per_sm == 2 else tfb.SMEM_BYTES)
    # the largest tile that fits: one row more does not
    if rows < tfb.APPLY_MAX_ROWS and (per_sm == 1 or rows * n * itemsize
                                      + n * itemsize <= 48 * 1024):
        assert tfb._apply_smem_bytes(rows + 1, n, itemsize) > (
            half if per_sm == 2 else tfb.SMEM_BYTES)


# ---------------------------------------------------------------------------
# fb_run against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lasso():
    prob = make_lasso(N=64, n=8, p=3, seed=3)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 64.0)
    return prob, F, NormL1(prob.lam)


@pytest.mark.parametrize("fast", [False, True], ids=["ista", "fista"])
def test_fb_run_matches_jax_f64(fast, lasso):
    """50 steps in f64 from JAX's init on tests/test_fb.py's problem: x,
    y and t at rtol 1e-10."""
    prob, F, g = lasso
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(64.0))
    jg = JNormL1(lam=jnp.asarray(prob.lam))
    gamma = 1.0 / np.mean(prob.L)
    jcfg = jfbs.FBCfg(N=64, fast=fast)
    jst = jfbs.fb_run(JF, jg, jfbs.fb_init(JF, jg, jnp.zeros(8),
                                           jnp.asarray(gamma), jcfg), jcfg, 50)
    cfg = FBCfg(N=64, fast=fast)
    st = fb_run(F, g, fb_init(F, g, torch.zeros(8, dtype=torch.float64),
                              gamma, cfg), cfg, 50)
    assert st.it == int(jst.it) == 51
    for name in ("x", "y", "t"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-10, atol=1e-14, err_msg=name)
    again = fb_state_from_numpy(jst.gamma, jst.t, jst.x, jst.y, jst.it,
                                device="cpu")
    one = fb_step(F, g, again, cfg)
    two = jfbs.fb_step(JF, jg, jst, jcfg)
    np.testing.assert_allclose(one.x.numpy(), np.asarray(two.x), rtol=1e-10)


@pytest.mark.parametrize("fast", [False, True], ids=["ista", "fista"])
def test_fb_fused_matches_jax(fast, monkeypatch):
    """tests/test_fb.py:129 at f32: 20 fused steps, the Pallas kernel in
    interpret mode against the port's fused path (kernel #6's wrapper,
    its plain version here), once per step; x and y at rtol 1e-4, atol
    1e-6."""
    Np, npix = 512, 128
    prob = make_lasso(N=Np, n=npix, p=4, seed=3, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(Np), jnp.float32))
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    gamma = np.float32(1.0 / np.mean(prob.L))
    jcfg = jfbs.FBCfg(N=Np, fast=fast, fused=True)
    with pltpu.force_tpu_interpret_mode():
        jst = jfbs.fb_run(JF, jg, jfbs.fb_init(
            JF, jg, jnp.zeros(npix, jnp.float32), jnp.asarray(gamma), jcfg),
            jcfg, 20)
    calls = []
    fn = tfb.coeff_apply_all

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    monkeypatch.setattr(tfb, "coeff_apply_all", spy)
    F, g = _port_oracle(JF), NormL1(torch.tensor(prob.lam))
    cfg = FBCfg(N=Np, fast=fast, fused=True)
    st = fb_run(F, g, fb_init(F, g, torch.zeros(npix), _t(gamma), cfg), cfg,
                20)
    assert len(calls) == 20
    for name in ("x", "y"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    unfused = full_gradient(F, Np, st.y, False)
    np.testing.assert_allclose(full_gradient(F, Np, st.y, True).numpy(),
                               unfused.numpy(), rtol=1e-4,
                               atol=1e-5 * float(unfused.abs().max()))


# ---------------------------------------------------------------------------
# the facades (tests/test_fb.py:33-69)
# ---------------------------------------------------------------------------

def test_fb_and_fista_converge(lasso):
    prob, F, g = lasso
    x0 = torch.zeros(8, dtype=torch.float64)
    x, it = ForwardBackward(maxit=4000)(x0, F=F, g=g, L=prob.L, N=64)
    assert it == 4000 and x.dtype == torch.float64
    assert prob.cost(x.numpy()) - prob.f_star < 1e-4
    xf, _ = FISTA(maxit=400)(x0, F=F, g=g, L=prob.L, N=64)
    assert prob.cost(xf.numpy()) - prob.f_star < 1e-4


def test_fista_accelerates(lasso):
    """At a matched budget of 150 full-gradient steps FISTA lands at
    least 10x closer to the optimum than ISTA."""
    prob, F, g = lasso
    x0 = torch.zeros(8, dtype=torch.float64)
    xi, _ = ForwardBackward(maxit=150)(x0, F=F, g=g, L=prob.L, N=64)
    xf, _ = FISTA(maxit=150)(x0, F=F, g=g, L=prob.L, N=64)
    gap_i = prob.cost(xi.numpy()) - prob.f_star
    gap_f = prob.cost(xf.numpy()) - prob.f_star
    assert gap_f * 10 < gap_i, (gap_f, gap_i)


def test_fb_iterator_invariants_and_errors(lasso):
    prob, F, g = lasso
    x0 = torch.zeros(8, dtype=torch.float64)
    solver = FISTA(maxit=5)
    it = solver.iterator(x0, F=F, g=g, L=prob.L, N=64)
    assert it.x0 is x0
    states = list(take(iter(it), 5))
    assert [s.it for s in states] == [1, 2, 3, 4, 5]
    assert solution(states[0]) is states[0].x
    np.testing.assert_array_equal(states[0].x.numpy(), x0.numpy())
    x_batch, n_it = solver(x0, F=F, g=g, L=prob.L, N=64)
    assert n_it == 5
    np.testing.assert_array_equal(states[-1].x.numpy(), x_batch.numpy())
    assert it._rebase_fn(states[2]) is states[2]
    with pytest.raises(ValueError, match="smoothness"):
        ForwardBackward(maxit=2)(x0, F=F, g=g, N=64)
    # F=None: the zero oracle, so a step is the prox of the iterate
    xz, _ = ForwardBackward(maxit=2, gamma=0.1)(x0 + 1.0, g=g, N=64)
    np.testing.assert_array_equal(xz.numpy(),
                                  g.prox_only(x0 + 1.0, 0.1).numpy())
    for kw in (dict(gamma=0.0), dict(maxit=0), dict(freq=0),
               dict(fused_precision="tf32")):
        with pytest.raises(ValueError):
            ForwardBackward(**kw)
    x1, _ = ForwardBackward(maxit=1)(x0, F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(x1.numpy(), x0.numpy())
