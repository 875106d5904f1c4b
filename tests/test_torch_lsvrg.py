"""The port's L-SVRG and L-Katyusha against the JAX package on the CPU.

The plain versions of kernels #16 and #17 (``lsvrg_coeff_multistep_ref``
and ``lkatyusha_coeff_multistep_ref``, against the Pallas kernels in
interpret mode, masked tails included), ``lsvrg_run`` and
``lkatyusha_run`` in their three modes (stepwise blocks, iid minibatches,
the coin-aware fused drivers on the kernels' plain versions) on JAX's own
block draws and coins, and the facades on the planted Lasso of
``tests/test_lsvrg.py``. JAX's draws of step ``it`` are stateless in
(key, it): the block start ``_gen_block_starts(key, it0, cfg, steps)``,
the iid minibatch ``randint(fold_in(key, it), (B,))`` and the coin
``_coin(key, it, p)``; the tests hand them to the port's runs.
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
from ciao_tpu.solvers import lsvrg as jl
from ciao_tpu.solvers.saga import _gen_block_starts
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch.convert import (
    least_squares_from_numpy, lkatyusha_state_from_numpy,
    lsvrg_state_from_numpy,
)
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers import (
    LKatyusha, LKatyushaCfg, LSVRG, LSVRGCfg, lkatyusha_init, lkatyusha_run,
    lsvrg_init, lsvrg_rebase, lsvrg_run, lsvrg_step, take,
)
from ciao_tpu_torch.solvers.lsvrg import (
    LOOPLESS_LAUNCH, _windows, draw_coins,
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
# kernels #16 and #17: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

N, n, B, K = 1024, 128, 128, 16
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
# (rows' storage, precision, prox, stop): f32, "default" (JAX's reference
# on bf16-stored rows), int8, the Zero prox, and a masked tail (stop < K-1)
CASES = [("f32", "highest", "l1", K - 1), ("f32", "default", "l1", K - 1),
         ("int8", "highest", "l1", K - 1), ("f32", "highest", "zero", K - 1),
         ("f32", "highest", "l1", 9)]
IDS = ["f32", "f32-default", "int8", "zero", "masked-tail"]


def _kernel_problem(storage, stop):
    """A planted Lasso in both packages with an anchor w̃, its
    coefficients and mean gradient, and K block starts clamped past
    ``stop`` onto the last processed block (JAX's contract)."""
    prob = make_lasso(N=N, n=n, p=4, seed=3, dtype=np.float32,
                      well_conditioned=True)
    JF = _jax_oracle(prob, N, storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    rng = np.random.default_rng(7)
    wt = (0.05 * rng.standard_normal(n)).astype(np.float32)
    canch = np.asarray(JF.coeff_all(jnp.asarray(wt)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(canch)), np.float32) / N
    near = (wt + 0.01 * rng.standard_normal((2, n))).astype(np.float32)
    starts = (rng.integers(0, N // B, K) * B).astype(np.int32)
    starts[stop + 1:] = starts[stop]
    return prob, JF, rs, wt, canch, av, near, starts


def _jax_args(JF, canch, starts, stop, rs, precision):
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    return (jA, jnp.asarray(np.asarray(JF.b)).reshape(SLAB),
            jnp.asarray(canch).reshape(SLAB), jnp.asarray(starts),
            jnp.asarray(stop, jnp.int32)), dict(
        precision=precision,
        rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB))


@pytest.mark.parametrize("storage,precision,prox,stop", CASES, ids=IDS)
def test_lsvrg_multistep_ref_matches_pallas(storage, precision, prox, stop):
    """stop + 1 of K = 16 L-SVRG steps of the plain version against the
    Pallas kernel in interpret mode: w and wpre (the pre-update iterate of
    the last processed step) at rtol 1e-4, atol 1e-6."""
    prob, JF, rs, wt, canch, av, near, starts = _kernel_problem(storage, stop)
    gamma = np.float32(1.0 / (6.0 * np.max(prob.L)))
    thr = gamma * prob.lam if prox == "l1" else 0.0
    sc = np.array([N, gamma, thr, 1.0 / B, jfb.MODE_LSQ, 0.0], np.float32)
    args, kw = _jax_args(JF, canch, starts, stop, rs, precision)
    with pltpu.force_tpu_interpret_mode():
        jw, jwpre = jfb.lsvrg_coeff_multistep(
            *args, jnp.asarray(near[0])[None], jnp.asarray(av)[None],
            jnp.asarray(sc)[None], B, **kw)
    tw = _t(near[0])
    w, wpre = tfb.lsvrg_coeff_multistep(
        _t(np.asarray(JF.A)), _t(np.asarray(JF.b)), _t(canch), _t(starts),
        torch.tensor([stop], dtype=torch.int32), tw, _t(av), _t(sc), B,
        precision=precision, rs=None if rs is None else _t(rs))
    assert w is tw and not np.array_equal(wpre.numpy(), near[0])
    for got, want in ((w, jw), (wpre, jwpre)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[0],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("storage,precision,prox,stop", CASES, ids=IDS)
def test_lkatyusha_multistep_ref_matches_pallas(storage, precision, prox,
                                                stop):
    """The same for L-Katyusha (θ₁ = 1/3, θ₂ = 1/2, σ̂ = 0.01): y, z and
    ypre at rtol 1e-4, atol 1e-6."""
    prob, JF, rs, wt, canch, av, near, starts = _kernel_problem(storage, stop)
    th1, th2, sig = 1.0 / 3.0, 0.5, 0.01
    eta = th2 / ((1.0 + th2) * th1)
    step = eta / float(np.max(prob.L))
    denom = 1.0 + eta * sig
    lam = prob.lam if prox == "l1" else 0.0
    sc = np.array([N, step, step / denom * lam, 1.0 / denom, eta * sig, th1,
                   th2, 1.0 / B, jfb.MODE_LSQ, 0.0], np.float32)
    args, kw = _jax_args(JF, canch, starts, stop, rs, precision)
    with pltpu.force_tpu_interpret_mode():
        jy, jz, jypre = jfb.lkatyusha_coeff_multistep(
            *args, jnp.asarray(wt)[None], jnp.asarray(near[0])[None],
            jnp.asarray(near[1])[None], jnp.asarray(av)[None],
            jnp.asarray(sc)[None], B, **kw)
    ty, tz = _t(near[0]), _t(near[1])
    y, z, ypre = tfb.lkatyusha_coeff_multistep(
        _t(np.asarray(JF.A)), _t(np.asarray(JF.b)), _t(canch), _t(starts),
        torch.tensor([stop], dtype=torch.int32), _t(wt), ty, tz, _t(av),
        _t(sc), B, precision=precision, rs=None if rs is None else _t(rs))
    assert y is ty and z is tz and not np.array_equal(z.numpy(), near[1])
    for got, want in ((y, jy), (z, jz), (ypre, jypre)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[0],
                                   rtol=1e-4, atol=1e-6)


def test_loopless_wrappers_on_cpu_and_masked_steps():
    """CPU tensors take the plain versions and count no launch; the steps
    past stop change nothing (the launch equals the first stop + 1 steps
    alone, and wpre/ypre are the last processed step's); a device with no
    kernel raises; the fused drivers' windows end at each flip."""
    prob, JF, rs, wt, canch, av, near, starts = _kernel_problem("f32", 4)
    A, b = _t(np.asarray(JF.A)), _t(np.asarray(JF.b))
    sc6 = _t(np.array([N, 1e-5, 1e-6, 1.0 / B, 0.0, 0.0], np.float32))
    before = (tfb.lsvrg_coeff_multistep.launches,
              tfb.lkatyusha_coeff_multistep.launches)
    w1, pre1 = tfb.lsvrg_coeff_multistep(
        A, b, _t(canch), _t(starts), torch.tensor([4], dtype=torch.int32),
        _t(near[0]), _t(av), sc6, B)
    w2, pre2 = tfb.lsvrg_coeff_multistep(A, b, _t(canch), _t(starts[:5]),
                                         None, _t(near[0]), _t(av), sc6, B)
    torch.testing.assert_close(w1, w2, rtol=0, atol=0)
    torch.testing.assert_close(pre1, pre2, rtol=0, atol=0)
    sc10 = _t(np.array([N, 1e-5, 1e-6, 1.0, 0.0, 1 / 3, 0.5, 1.0 / B, 0.0,
                        0.0], np.float32))
    outs = [tfb.lkatyusha_coeff_multistep(
        A, b, _t(canch), _t(st), stop, _t(wt), _t(near[0]), _t(near[1]),
        _t(av), sc10, B) for st, stop in (
            (starts, torch.tensor([4], dtype=torch.int32)),
            (starts[:5], None))]
    for a, b_ in zip(*outs):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert (tfb.lsvrg_coeff_multistep.launches,
            tfb.lkatyusha_coeff_multistep.launches) == before
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.lsvrg_coeff_multistep(
            torch.empty((64, 8), device="meta"),
            torch.empty(64, device="meta"), torch.empty(64, device="meta"),
            torch.zeros(2, dtype=torch.int32, device="meta"), None, meta,
            meta, torch.empty(6, device="meta"), 16)
    assert _windows([5, 9, 70], 80, 32) == [
        (0, 6, True), (6, 10, True), (10, 42, False), (42, 71, True),
        (71, 80, False)]
    assert _windows([], 70, 32) == [(0, 32, False), (32, 64, False),
                                   (64, 70, False)]
    assert _windows([31, 95], 40, 32) == [(0, 32, True), (32, 40, False)]


H100_SMS = 132
# (B, n, itemsize) -> (rows a CTA, CTAs, rows a stage, stages) on an H100
GRID = {(4096, 1024, 4): (32, 128, 8, 6), (4096, 1024, 2): (32, 128, 16, 6),
        (4096, 1024, 1): (32, 128, 32, 6), (1024, 1024, 4): (8, 128, 8, 6),
        (1024, 1024, 1): (8, 128, 8, 8), (128, 1024, 4): (1, 128, 1, 8),
        (4096, 16384, 4): (32, 128, 1, 2), (4096, 16384, 2): (32, 128, 1, 5),
        (4096, 16384, 1): (32, 128, 2, 5), (8192, 128, 4): (64, 128, 64, 6),
        (8192, 128, 2): (64, 128, 64, 8), (8192, 128, 1): (64, 128, 64, 8)}
# the row groups of the narrow-row split (16-byte path: units of 4 columns)
GROUPS = {128: 8, 202: 4, 1024: 1, 16384: 1}


@pytest.mark.parametrize("itemsize", [4, 2, 1], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("B,n", [(4096, 1024), (1024, 1024), (128, 1024),
                                 (4096, 202), (4096, 16384), (8192, 128)],
                         ids=["headline", "B1024", "B128", "n202", "n16384",
                              "deep"])
def test_loopless_grid_fits_the_card(B, n, itemsize):
    """The persistent engine's grid and ring (``_loopless_grid``, checked
    again in ``csrc/loopless_steps.cuh``) on an H100's 132 SMs: rows × CTAs
    = B, every CTA resident at once (CTAs ≤ SMs × the CTAs an SM holds by
    shared memory and threads), the CTA's shared memory within 227 KB, at
    least two stages of at most the CTA's rows, a power of two, in 32 KB
    unless one row is larger; the headline's and the facades' batch on 128
    CTAs, the headline's ring holding a whole step and more. The deep
    target's B = 8,192 at n = 128 (kernel #4): 64 rows a CTA on 128 CTAs,
    one 64-row stage a step (32 KB f32), its 32 units of four columns a
    row split over 8 row groups of a warp, whose column sums the shared
    memory holds; at n = 1,024 one group, and no room taken for them."""
    rows, ctas, S, P = tfb._loopless_grid(B, n, itemsize, H100_SMS)
    smem = tfb._loopless_smem_bytes(S, P, n, itemsize)
    per_sm = min(2048 // (tfb.LOOPLESS_THREADS + 32),
                 (228 * 1024) // (smem + 1024))
    assert rows * ctas == B and (rows & (rows - 1)) == 0
    assert per_sm >= 1 and ctas <= H100_SMS * per_sm
    assert smem <= tfb.SMEM_BYTES == 232_448
    assert 2 <= P <= tfb.LOOPLESS_MAX_STAGES and 1 <= S <= rows
    assert (S & (S - 1)) == 0 and S <= tfb.LOOPLESS_MAX_STAGE_ROWS
    assert S == 1 or S * n * itemsize <= tfb.LOOPLESS_STAGE_BYTES
    assert P == tfb.LOOPLESS_MAX_STAGES or tfb._loopless_smem_bytes(
        S, P + 1, n, itemsize) > tfb.SMEM_BYTES
    if (B, n, itemsize) in GRID:
        assert (rows, ctas, S, P) == GRID[B, n, itemsize]
    if B >= 1024 and n <= 1024:
        assert ctas == 128 and S * P > rows
    g = tfb._loopless_groups(-(-n // 4))
    assert g == GROUPS[n] and tfb.LOOPLESS_THREADS % g == 0
    # the ring, the point, the mbarriers and the per-row values, then g rows
    # of n f32 column sums where g > 1
    ring = P * (-(-S * n * itemsize // 16) * 16) + -(-4 * n // 16) * 16
    rest = 16 * P + 4 * (3 * P * S + 10 * S + 256)
    assert smem == ring + rest + (-(-4 * g * n // 16) * 16 if g > 1 else 0)
    if (B, n) == (8192, 128):
        assert S == rows == 64 and S * n * itemsize <= 32 * 1024


@pytest.mark.parametrize("key", list(GRID), ids=[
    f"B{B}-n{n}-{ {4: 'f32', 2: 'bf16', 1: 'int8'}[i]}" for B, n, i in GRID])
def test_loopless_one_point_rule_is_unchanged(key):
    """The grid, ring and shared memory of the one-point kernels (#4, #5,
    #10, #16, #17) with the points counted: ``points=1`` is the default,
    value for value, and the shared memory is the ring, one point, the
    mbarriers, the per-row values, one set of margin sums and the warp
    sums (and the narrow rows' group sums)."""
    B, n, itemsize = key
    grid = tfb._loopless_grid(B, n, itemsize, H100_SMS, 1)
    assert grid == tfb._loopless_grid(B, n, itemsize, H100_SMS) == GRID[key]
    _, _, S, P = grid
    g = tfb._loopless_groups(-(-n // 4))
    want = (P * (-(-S * n * itemsize // 16) * 16) + -(-4 * n // 16) * 16
            + (-(-4 * g * n // 16) * 16 if g > 1 else 0) + 16 * P
            + 4 * (3 * P * S + 10 * S + 256))
    assert tfb._loopless_smem_bytes(S, P, n, itemsize, 1) == want
    assert tfb._loopless_smem_bytes(S, P, n, itemsize) == want


# (B, n, itemsize) -> (rows a CTA, CTAs, rows a stage, stages) beside
# SARAH's two points (kernel #11) on an H100
GRID2 = {(4096, 1024, 4): (32, 128, 8, 6), (4096, 1024, 2): (32, 128, 16, 6),
         (4096, 1024, 1): (32, 128, 32, 6), (8192, 128, 4): (64, 128, 64, 6),
         (8192, 128, 2): (64, 128, 64, 8), (8192, 128, 1): (64, 128, 64, 8),
         (4096, 16384, 4): (32, 128, 1, 1), (4096, 16384, 2): (32, 128, 1, 3),
         (4096, 16384, 1): (32, 128, 2, 3)}


@pytest.mark.parametrize("itemsize", [4, 2, 1], ids=["f32", "bf16", "int8"])
@pytest.mark.parametrize("B,n", [(4096, 1024), (8192, 128), (4096, 16384)],
                         ids=["headline", "deep", "n16384"])
def test_loopless_grid_beside_two_points(B, n, itemsize):
    """SARAH's two points on the engine (``_loopless_grid`` with
    ``points=2``, checked again in ``csrc/loopless_steps.cuh``): the grid
    and the stage rows are one point's; the shared memory is one point's
    plus the second point and a second set of margin sums, within 227 KB;
    as many stages as fit, two or more wherever two fit, and one only
    where two do not: f32 rows at n = 16,384 (two stages would take
    263,296 B), the widest shape the kernel's gate admits."""
    one = tfb._loopless_grid(B, n, itemsize, H100_SMS)
    rows, ctas, S, P = tfb._loopless_grid(B, n, itemsize, H100_SMS, 2)
    assert (rows, ctas, S, P) == GRID2[B, n, itemsize]
    assert (rows, ctas, S) == one[:3] and 1 <= P <= one[3]
    smem = tfb._loopless_smem_bytes(S, P, n, itemsize, 2)
    assert smem <= tfb.SMEM_BYTES
    assert smem - tfb._loopless_smem_bytes(S, P, n, itemsize) == (
        -(-8 * n // 16) * 16 - -(-4 * n // 16) * 16 + 4 * 8 * S)
    assert P == tfb.LOOPLESS_MAX_STAGES or tfb._loopless_smem_bytes(
        S, P + 1, n, itemsize, 2) > tfb.SMEM_BYTES
    two = tfb._loopless_smem_bytes(S, 2, n, itemsize, 2)
    assert (P >= 2) == (two <= tfb.SMEM_BYTES)
    assert (P == 1) == ((n, itemsize) == (16384, 4))
    if P == 1:
        assert two == 263_296


@pytest.mark.parametrize("n,stages", [(14_456, 2), (14_460, 1)])
def test_loopless_two_points_keep_two_stages_to_14456_f32_columns(n, stages):
    """Beside SARAH's two points, two stages of one f32 row fit up to
    14,456 columns; a wider row takes the one-stage ring."""
    for B in (4096, 1024):
        assert tfb._loopless_grid(B, n, 4, H100_SMS, 2)[3] == stages
        assert tfb._loopless_grid(B, n, 4, H100_SMS)[3] >= 2


# ---------------------------------------------------------------------------
# lsvrg_run and lkatyusha_run against JAX on JAX's draws
# ---------------------------------------------------------------------------

Np, Bp, npix = 1024, 128, 128


@pytest.fixture(scope="module")
def pair():
    """tests/test_lsvrg.py:318's problem in both packages."""
    prob = make_lasso(N=Np, n=npix, p=4, seed=3, dtype=np.float32)
    JF = _jax_oracle(prob, Np)
    jg = JNormL1(lam=jnp.asarray(prob.lam, jnp.float32))
    return prob, JF, jg, _port_oracle(JF), NormL1(torch.tensor(prob.lam))


def _jax_draws(key, it0, steps, p, cfg, iid):
    """JAX's block starts (or iid minibatches) and coins of steps
    it0..it0+steps-1."""
    its = it0 + np.arange(steps)
    coins_ = np.array([bool(jl._coin(key, int(t), jnp.float32(p)))
                       for t in its])
    if iid:
        idx = np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, int(t)), (cfg.batch,), 0, cfg.N,
            dtype=jnp.int32)) for t in its]).astype(np.int64)
        return dict(idx=idx), coins_
    return dict(starts=np.array(_gen_block_starts(key, it0, cfg,
                                                  steps))), coins_


def _spy(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(tfb, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tfb, name, spy)
    return calls


def _flips_windows(coins_, steps):
    wins = _windows(np.flatnonzero(coins_), steps, LOOPLESS_LAUNCH)
    return len(wins), sum(f for _, _, f in wins)


@pytest.mark.parametrize("mode", ["block", "iid", "fused"])
@pytest.mark.parametrize("steps,p", [(80, 0.08), (40, 0.0)],
                         ids=["p0.08", "p0"])
def test_lsvrg_run_matches_jax(pair, mode, steps, p, monkeypatch):
    """``steps`` L-SVRG steps at γ = 1/(6 L_max): p = 0.08 lands coins
    inside windows of 32 at several positions, p = 0 is the no-flip
    sentinel. block and iid: JAX's stepwise paths; fused: its coin-aware
    driver (Pallas in interpret mode) against the port's, on the plain
    versions here: one kernel #16 launch per window and one kernel #6 per
    flip. w and z at rtol 1e-4, atol 1e-6; av at rtol 1e-3, atol 1e-4."""
    prob, JF, jg, F, g = pair
    gamma = np.float32(1.0 / (6.0 * np.max(prob.L)))
    key = jax.random.PRNGKey(5)
    x0 = jnp.zeros(npix, jnp.float32)
    jcfg = jl.LSVRGCfg(N=Np, batch=Bp, block=mode != "iid",
                       fused=mode == "fused")
    jst0 = jl.lsvrg_init(JF, jg, x0, jnp.asarray(gamma),
                         jnp.asarray(p, jnp.float32), key, jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jl.lsvrg_run(JF, jg, jst0, jcfg, steps)
    draws, coins_ = _jax_draws(key, 1, steps, p, jcfg, mode == "iid")
    calls = _spy(monkeypatch, ["lsvrg_coeff_multistep", "coeff_apply_all"])
    cfg = LSVRGCfg(N=Np, batch=Bp, block=mode != "iid", fused=mode == "fused")
    st0 = lsvrg_state_from_numpy(jst0.gamma, jst0.p, jst0.av, jst0.z,
                                 jst0.w, jst0.it, canch=jst0.canch,
                                 device="cpu")
    st = lsvrg_run(F, g, st0, cfg, steps, coins=coins_, **draws)
    tag = f"{mode} steps={steps} p={p}"
    for fld in ("w", "z"):
        np.testing.assert_allclose(getattr(st, fld).numpy(),
                                   np.asarray(getattr(jst, fld)), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{tag} {fld}")
    np.testing.assert_allclose(st.av.numpy(), np.asarray(jst.av), rtol=1e-3,
                               atol=1e-4, err_msg=tag)
    assert st.it == int(jst.it) == steps + 1
    wins, flips = _flips_windows(coins_, steps)
    assert (flips > 0) == (p > 0) and (p == 0 or wins > flips), tag
    if mode == "fused":
        assert calls == {"lsvrg_coeff_multistep": wins,
                         "coeff_apply_all": flips}, tag
        np.testing.assert_allclose(
            st.canch.numpy(), np.asarray(jst.canch).reshape(-1), rtol=1e-3,
            atol=1e-3 * float(np.abs(np.asarray(jst.canch)).max()))
    else:
        assert calls == {"lsvrg_coeff_multistep": 0, "coeff_apply_all": 0}


@pytest.mark.parametrize("mode", ["block", "iid", "fused"])
@pytest.mark.parametrize("steps,p,sig", [(80, 0.08, 0.0), (40, 0.0, 0.01)],
                         ids=["p0.08", "p0-sigma"])
def test_lkatyusha_run_matches_jax(pair, mode, steps, p, sig, monkeypatch):
    """The same for L-Katyusha (θ₁ = 1/3, θ₂ = 1/2; σ̂ = 0 and 0.01): y,
    z and the anchor point at rtol 1e-4, atol 1e-6, av at rtol 1e-3, atol
    1e-4; fused: one kernel #17 launch per window, one kernel #6 per
    flip."""
    prob, JF, jg, F, g = pair
    Lm = jnp.asarray(np.max(prob.L), jnp.float32)
    key = jax.random.PRNGKey(5)
    x0 = jnp.zeros(npix, jnp.float32)
    jcfg = jl.LKatyushaCfg(N=Np, batch=Bp, block=mode != "iid",
                           fused=mode == "fused")
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    jst0 = jl.lkatyusha_init(JF, jg, x0, Lm, f32(sig), f32(1.0 / 3.0),
                             f32(0.5), f32(p), key, jcfg)
    with pltpu.force_tpu_interpret_mode():
        jst = jl.lkatyusha_run(JF, jg, jst0, jcfg, steps)
    draws, coins_ = _jax_draws(key, 1, steps, p, jcfg, mode == "iid")
    calls = _spy(monkeypatch, ["lkatyusha_coeff_multistep",
                               "coeff_apply_all"])
    cfg = LKatyushaCfg(N=Np, batch=Bp, block=mode != "iid",
                       fused=mode == "fused")
    st0 = lkatyusha_state_from_numpy(
        jst0.Lmax, jst0.sigma, jst0.theta1, jst0.theta2, jst0.p, jst0.av,
        jst0.w_anchor, jst0.y, jst0.z, jst0.it, canch=jst0.canch,
        device="cpu")
    st = lkatyusha_run(F, g, st0, cfg, steps, coins=coins_, **draws)
    tag = f"{mode} steps={steps} p={p}"
    for fld in ("y", "z", "w_anchor"):
        np.testing.assert_allclose(getattr(st, fld).numpy(),
                                   np.asarray(getattr(jst, fld)), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{tag} {fld}")
    np.testing.assert_allclose(st.av.numpy(), np.asarray(jst.av), rtol=1e-3,
                               atol=1e-4, err_msg=tag)
    assert st.it == int(jst.it) == steps + 1
    wins, flips = _flips_windows(coins_, steps)
    if mode == "fused":
        assert calls == {"lkatyusha_coeff_multistep": wins,
                         "coeff_apply_all": flips}, tag
    else:
        assert calls == {"lkatyusha_coeff_multistep": 0,
                         "coeff_apply_all": 0}


def test_fused_drivers_match_stepwise_on_the_ports_draws():
    """Within the port, on its own draws: the fused drivers (plain kernel
    versions) and the stepwise block paths give one trajectory; runs of
    1 and 7 steps go to the kernels too; the coins are a pure function of
    (seed, it), about p of them land, and p = 0 and 1 never and always."""
    prob = make_lasso(N=512, n=32, p=3, seed=1, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A), torch.tensor(prob.b), 512.0)
    g = NormL1(prob.lam)
    Lmax = float(np.max(prob.L))
    x0 = torch.zeros(32)
    for steps in (1, 7, 90):
        a_cfg = LSVRGCfg(N=512, batch=64, block=True)
        f_cfg = a_cfg._replace(fused=True)
        a = lsvrg_run(F, g, lsvrg_init(F, g, x0, 1 / (6 * Lmax), 0.1, 3,
                                       a_cfg), a_cfg, steps)
        b = lsvrg_run(F, g, lsvrg_init(F, g, x0, 1 / (6 * Lmax), 0.1, 3,
                                       f_cfg), f_cfg, steps)
        for fld in ("w", "z", "av"):
            np.testing.assert_allclose(getattr(b, fld).numpy(),
                                       getattr(a, fld).numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{steps} {fld}")
        k_cfg = LKatyushaCfg(N=512, batch=64, block=True)
        kf_cfg = k_cfg._replace(fused=True)
        args = (F, g, x0, Lmax, 0.0, 1 / 3, 0.5, 0.1, 3)
        a = lkatyusha_run(F, g, lkatyusha_init(*args, k_cfg), k_cfg, steps)
        b = lkatyusha_run(F, g, lkatyusha_init(*args, kf_cfg), kf_cfg, steps)
        for fld in ("y", "z", "w_anchor"):
            np.testing.assert_allclose(getattr(b, fld).numpy(),
                                       getattr(a, fld).numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{steps} {fld}")
    c = draw_coins(3, 1, 20_000, 0.05)
    np.testing.assert_array_equal(c[100:200], draw_coins(3, 101, 100, 0.05))
    assert abs(c.mean() - 0.05) < 0.01 and not draw_coins(3, 1, 500, 0.0).any()
    assert draw_coins(3, 1, 500, 1.0).all()


# ---------------------------------------------------------------------------
# the facades (tests/test_lsvrg.py's cases)
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


def test_lsvrg_facade_converges_and_samples(lasso):
    """Default γ = 1/(6 L_max), p = batch/N, and contiguous blocks of 8
    reach cost − f* < 1e-4 in 4,000 steps, keeping f64; block and iid
    runs differ."""
    prob, F, g = lasso
    for kw in (dict(), dict(batch=8, block_sampling=True)):
        x, it = LSVRG(maxit=4000, **kw)(_x0(), F=F, g=g, L=prob.L)
        assert it == 4000 and x.dtype == torch.float64
        assert prob.cost(x.numpy()) - prob.f_star < 1e-4, kw
    xs = [LSVRG(maxit=20, batch=8, block_sampling=blk)(
        _x0(), F=F, g=g, L=prob.L)[0].numpy() for blk in (False, True)]
    assert not np.array_equal(*xs)


def test_lsvrg_coin_semantics_and_rebase(lasso):
    """p = 0 freezes the anchor and its gradient at x0; p = 1 moves the
    anchor to the pre-update iterate every step (Kovalev et al., Alg. 2);
    the fused configuration's stepwise step keeps the anchor coefficients
    in step with av; the rebase recomputes μ at the anchor; the iterator's
    k-th state is a maxit = k solve."""
    prob, F, g = lasso
    states = list(take(iter(LSVRG(p=0.0).iterator(_x0(), F=F, g=g,
                                                  L=prob.L)), 9))
    for st in states:
        np.testing.assert_array_equal(st.z.numpy(), _x0().numpy())
        np.testing.assert_array_equal(st.av.numpy(), states[0].av.numpy())
    states = list(take(iter(LSVRG(p=1.0).iterator(_x0(), F=F, g=g,
                                                  L=prob.L)), 6))
    for prev, cur in zip(states, states[1:]):
        np.testing.assert_array_equal(cur.z.numpy(), prev.w.numpy())
    cfg = LSVRGCfg(N=Nf, batch=8, block=True, fused=True)
    st = lsvrg_init(F, g, _x0(), 1e-3, 1.0, 0, cfg)
    st = lsvrg_step(F, g, lsvrg_step(F, g, st, cfg), cfg)
    torch.testing.assert_close(st.canch, F.coeff_all(st.z))
    torch.testing.assert_close(st.av, F.apply_all(st.canch) / Nf)
    it = LSVRG(maxit=5).iterator(_x0(), F=F, g=g, L=prob.L)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(states[0].solution.numpy(), _x0().numpy())
    x_batch, _ = LSVRG(maxit=5)(_x0(), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(states[-1].solution.numpy(),
                                  x_batch.numpy())
    bad = states[3]._replace(av=torch.zeros_like(states[3].av))
    fixed = it._rebase_fn(bad)
    torch.testing.assert_close(fixed.av, F.grad_sum_all(bad.z) / Nf)
    torch.testing.assert_close(
        lsvrg_rebase(F, g, bad, LSVRGCfg(N=Nf)).av, fixed.av)


def test_lkatyusha_facade_converges_and_coin(lasso):
    """The default (σ̂ = 0, θ₁ = 1/3), σ̂ = 1e-3 and θ₁ = 0.4 with blocks
    of 8 reach cost − f* < 1e-4 in 3,000 steps; p = 1 moves the anchor to
    the pre-update y every step (Alg. 3); the iterator's k-th state is a
    maxit = k solve; the rebase recomputes μ at the anchor."""
    prob, F, g = lasso
    for kw in (dict(), dict(sigma=1e-3),
               dict(theta1=0.4, batch=8, block_sampling=True)):
        x, it = LKatyusha(maxit=3000, **kw)(_x0(), F=F, g=g, L=prob.L)
        assert it == 3000 and x.dtype == torch.float64
        assert prob.cost(x.numpy()) - prob.f_star < 1e-4, kw
    it = LKatyusha(maxit=5).iterator(_x0(), F=F, g=g, L=prob.L)
    states = list(take(iter(it), 5))
    np.testing.assert_array_equal(states[0].solution.numpy(), _x0().numpy())
    x_batch, _ = LKatyusha(maxit=5)(_x0(), F=F, g=g, L=prob.L)
    np.testing.assert_array_equal(states[-1].solution.numpy(),
                                  x_batch.numpy())
    states = list(take(iter(LKatyusha(p=1.0).iterator(
        _x0(), F=F, g=g, L=prob.L)), 6))
    for prev, cur in zip(states, states[1:]):
        np.testing.assert_array_equal(cur.w_anchor.numpy(), prev.y.numpy())
    bad = states[3]._replace(av=torch.zeros_like(states[3].av))
    torch.testing.assert_close(it._rebase_fn(bad).av,
                               F.grad_sum_all(bad.w_anchor) / Nf)


def test_loopless_fused_facades_on_the_cpu(lasso, monkeypatch):
    """With the kernel gate opened for CPU tensors both facades send a
    block run of any length to their coin-aware drivers (the kernels'
    plain versions) on f32 rows, and match the stepwise block run."""
    prob, _, _ = lasso
    F = LeastSquaresRows(torch.tensor(prob.A, dtype=torch.float32),
                         torch.tensor(prob.b, dtype=torch.float32),
                         float(Nf))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32))
    kw = dict(maxit=41, batch=8, block_sampling=True, p=0.1)
    plain = [S(**kw)(torch.zeros(nf), F=F, g=g, L=prob.L)[0]
             for S in (LSVRG, LKatyusha)]
    monkeypatch.setattr(tfb, "svrg_multistep_available",
                        lambda F, g, x0, B: F.num_terms % B == 0)
    calls = _spy(monkeypatch, ["lsvrg_coeff_multistep",
                               "lkatyusha_coeff_multistep"])
    for S, want in zip((LSVRG, LKatyusha), plain):
        x, it = S(**kw)(torch.zeros(nf), F=F, g=g, L=prob.L)
        assert it == 41
        np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6)
    assert calls["lsvrg_coeff_multistep"] >= 2
    assert calls["lkatyusha_coeff_multistep"] >= 2


def test_loopless_refusals(lasso):
    """The JAX facades' guards as ValueError (JAX asserts): p outside
    [0, 1], θ₂ and θ₁ out of range, γ ≤ 0, precision; L (or γ) missing,
    block sampling with N not divisible by batch; complex iterates name
    their ROADMAP item. F=None is the zero oracle."""
    prob, F, g = lasso
    for S, kw in ((LSVRG, dict(p=1.5)), (LSVRG, dict(gamma=0.0)),
                  (LSVRG, dict(fused_precision="tf32")),
                  (LKatyusha, dict(p=-0.1)), (LKatyusha, dict(theta2=1.0)),
                  (LKatyusha, dict(theta1=0.6)), (LKatyusha, dict(maxit=0))):
        with pytest.raises(ValueError):
            S(**kw)
    for S, msg in ((LSVRG, "provide L"), (LKatyusha, "smoothness")):
        with pytest.raises(ValueError, match="divisible"):
            S(maxit=2, batch=7, block_sampling=True)(_x0(), F=F, g=g,
                                                     L=prob.L)
        with pytest.raises(ValueError, match=msg):
            S(maxit=2)(_x0(), F=F, g=g)
        xc, _ = S(maxit=3)(torch.zeros(nf, dtype=torch.complex128), F=F,
                           g=g, L=prob.L)
        xr, _ = S(maxit=3)(_x0(), F=F, g=g, L=prob.L)
        assert xc.dtype == torch.complex128
        np.testing.assert_allclose(xc.numpy(), xr.numpy(), rtol=1e-12,
                                   atol=1e-14)
        x, _ = S(maxit=3)(_x0(), g=g, L=prob.L, N=Nf)
        np.testing.assert_array_equal(x.numpy(), _x0().numpy())
