"""The Finito family's schedules, oracle methods and kernels in the port
against the JAX package on the CPU.

The block schedules (``ciao_tpu_torch.sampling``: cyclic exactly as JAX,
shuffled and RANDOM from the port's own draws), the least-squares
oracle's new methods, and the plain versions of kernels #9
(``finito_coeff_multistep``), #14 (``finito_coeff_multistep_streamed``),
#8 (``lfinito_sweep_multistep``) and #2 (``finito_block_update``) against
the Pallas kernels in interpret mode, on the same numpy inputs with the
slab layouts reshaped. "default" precision rounds both dot operands to
bf16 as the TPU does; XLA on the CPU keeps f32 dots exact at any
precision, so JAX's reference for it is the same rows stored bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu import sampling as jsampling
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.utils.problems import make_lasso
from ciao_tpu_torch import sampling
from ciao_tpu_torch.convert import least_squares_from_numpy
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1
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


def _close(got, want, rel, tag=""):
    """Within ``rel`` of the largest entry of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=tag)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,B", [(64, 8), (10, 4)], ids=["whole", "ragged"])
def test_cyclic_schedule_matches_jax(N, B):
    """Cyclic sweeps are deterministic: block for block (pos0 = 1, the
    reference's first step on block 2) and, ragged, the same rows and
    masks."""
    key = jax.random.PRNGKey(0)
    jst = jsampling.init_sweep(key, N, B, 2)
    st = sampling.init_sweep(0, N, B, 2)
    assert st.pos == int(jst.pos) == 1
    jblocks, jst2 = jsampling.gen_block_ids(jst, 23, N, B, 2)
    blocks, st2 = sampling.gen_block_ids(st, 23, N, B, 2)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))
    assert st2.pos == int(jst2.pos)
    for _ in range(7):
        jidx, jmask, jst = jsampling.next_block(jst, N, B, 2)
        idx, mask, st = sampling.next_block(st, N, B, 2)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert st.pos == int(jst.pos)


def test_shuffled_schedule_epochs():
    """The port's shuffled sweep (its own draws): the first epoch of the
    basic sweep is natural order, as JAX's; every later epoch is a
    permutation of the d blocks, drawn anew at pos == d; the vectorized
    window equals step-by-step draws; LFinito's reshuffle draws a fresh
    (non-natural) permutation for its first epoch too; the permutation is
    a pure function of (seed, epoch)."""
    N, B = 512, 8
    d = N // B
    jst = jsampling.init_sweep(jax.random.PRNGKey(3), N, B, 3)
    jfirst, _ = jsampling.gen_block_ids(jst, d, N, B, 3)
    st = sampling.init_sweep(7, N, B, 3)
    first, _ = sampling.gen_block_ids(st, d, N, B, 3)
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    np.testing.assert_array_equal(first.numpy(), np.arange(d))
    blocks, st_k = sampling.gen_block_ids(st, 3 * d + 5, N, B, 3)
    seq, s1 = [], st
    for _ in range(3 * d + 5):
        j, s1 = sampling.next_block_id(s1, N, B, 3)
        seq.append(int(j))
    np.testing.assert_array_equal(blocks.numpy(), seq)
    assert (st_k.pos, st_k.epoch) == (s1.pos, s1.epoch) == (5, 3)
    torch.testing.assert_close(st_k.order, s1.order)
    for e in range(1, 3):
        ep = blocks[e * d:(e + 1) * d].numpy()
        assert sorted(ep) == list(range(d))
        assert not np.array_equal(ep, np.arange(d))
    lf = sampling.reshuffled(sampling.init_sweep(7, N, B, 3), d)
    assert sorted(lf.order.tolist()) == list(range(d)) and lf.epoch == 1
    assert not np.array_equal(lf.order.numpy(), np.arange(d))
    np.testing.assert_array_equal(lf.order.numpy(), blocks[d:2 * d].numpy())
    other = sampling.reshuffled(sampling.init_sweep(8, N, B, 3), d)
    assert not torch.equal(other.order, lf.order)


def test_random_schedules():
    """RANDOM block ids (stateless in (seed, pos)): the window equals the
    stepwise draws and stays in range; a RANDOM minibatch holds B
    distinct rows and repeats for the same (seed, pos)."""
    N, B = 256, 16
    st = sampling.init_sweep(4, N, B, 1)
    blocks, st2 = sampling.gen_block_ids(st, 40, N, B, 1)
    seq, s1 = [], st
    for _ in range(40):
        j, s1 = sampling.next_block_id(s1, N, B, 1)
        seq.append(int(j))
    np.testing.assert_array_equal(blocks.numpy(), seq)
    assert st2.pos == s1.pos == 40
    assert blocks.min() >= 0 and blocks.max() < N // B
    assert len(set(seq)) > 8
    idx, mask, s2 = sampling.next_block(st, N, B, 1)
    assert len(set(idx.tolist())) == B and bool(mask.all()) and s2.pos == 1
    torch.testing.assert_close(idx, sampling.next_block(st, N, B, 1)[0])
    assert not torch.equal(idx, sampling.next_block(s2, N, B, 1)[0])


def test_gen_block_ids_clamped():
    """The clamp count of a shuffled window that crosses an epoch
    boundary: f is the first repeat (JAX's ``first_duplicate`` on the
    same blocks gives the same f), the state advances by f draws only,
    and the next window starts with the discarded candidates; on JAX's
    own replayed window, the port's count equals JAX's."""
    N, B = 64, 4
    d = N // B
    st = sampling.init_sweep(11, N, B, 3)
    st = sampling.gen_block_ids(st, d - 3, N, B, 3)[1]   # 3 before the end
    found = False
    for _ in range(40):
        blocks, f, st2 = sampling.gen_block_ids_clamped(st, 12, N, B, 3)
        jf = jsampling.first_duplicate(jnp.asarray(blocks.numpy()))
        assert int(f) == int(jf)
        adv = sampling.gen_block_ids(st, int(f), N, B, 3)[1]
        assert (st2.pos, st2.epoch) == (adv.pos, adv.epoch)
        torch.testing.assert_close(st2.order, adv.order)
        nxt = sampling.gen_block_ids(st2, 12 - int(f), N, B, 3)[0]
        np.testing.assert_array_equal(nxt.numpy(), blocks[int(f):].numpy())
        found = found or int(f) < 12
        st = sampling.gen_block_ids(st, d, N, B, 3)[1]
    assert found
    jst = jsampling.init_sweep(jax.random.PRNGKey(2), N, B, 3)
    jst = jsampling.gen_block_ids(jst, d - 4, N, B, 3)[1]
    for _ in range(6):
        jblocks, jf, jst = jsampling.gen_block_ids_clamped(jst, 12, N, B, 3)
        assert int(sampling.first_duplicate(_t(jblocks))) == int(jf)


# ---------------------------------------------------------------------------
# the oracle's new methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["f64", "bf16", "int8"])
def test_finito_oracle_methods_match_jax(storage):
    """grad_all, grad_block (host and device start), grad_batch,
    grad_pointwise, value_i, value_and_grad_i, value_and_grad_all and the
    masked grad_sum_diff against JAX: f64 rows at rtol 1e-12, bf16 and
    int8 storage at f32 iterates, rtol 1e-5."""
    dtype = np.float64 if storage == "f64" else np.float32
    prob = make_lasso(N=96, n=16, p=4, seed=1, dtype=dtype)
    JF = _jax_oracle(prob, 96, "f32" if storage == "f64" else storage)
    F = _port_oracle(JF)
    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal(16)).astype(dtype)
    x2 = (0.3 * rng.standard_normal(16)).astype(dtype)
    xs = (0.3 * rng.standard_normal((12, 16))).astype(dtype)
    idx = rng.integers(0, 96, 12)
    mask = rng.random(12) < 0.7
    rtol = 1e-12 if storage == "f64" else 1e-5
    jx, tx = jnp.asarray(x), _t(x)
    jv, jg = JF.value_and_grad_all(jx)
    tv, tg = F.value_and_grad_all(tx)
    jvi, jgi = JF.value_and_grad_i(jx, 37)
    tvi, tgi = F.value_and_grad_i(tx, torch.tensor(37))
    pairs = [
        (JF.grad_all(jx), F.grad_all(tx)),
        (JF.grad_block(jx, 32, 16), F.grad_block(tx, 32, 16)),
        (JF.grad_block(jx, 32, 16), F.grad_block(tx, torch.tensor(32), 16)),
        (JF.grad_batch(jx, jnp.asarray(idx)), F.grad_batch(tx, _t(idx))),
        (JF.grad_pointwise(jnp.asarray(xs), jnp.asarray(idx)),
         F.grad_pointwise(_t(xs), _t(idx))),
        (jv, tv), (jg, tg), (jvi, tvi), (jgi, tgi),
        (JF.value_i(jx, 5), F.value_i(tx, 5)),
        (JF.grad_sum_diff(jx, jnp.asarray(x2), jnp.asarray(idx),
                          jnp.asarray(mask)),
         F.grad_sum_diff(tx, _t(x2), _t(idx), _t(mask))),
    ]
    for k, (want, got) in enumerate(pairs):
        assert got.dtype == tx.dtype, k
        _close(got.numpy(), want, rtol, f"pair {k}")


def test_fused_finito_block_refuses_int8_and_runs_plain_on_cpu():
    prob = make_lasso(N=64, n=8, p=2, seed=0, dtype=np.float32)
    F = LeastSquaresRows(_t(prob.A), _t(prob.b), 64.0)
    s, gamma, z = torch.randn(64, 8), torch.rand(64) + 0.5, torch.randn(8)
    with pytest.raises(ValueError, match="int8"):
        F.with_storage("int8").fused_finito_block(s, gamma, z, 0, 16,
                                                  1 / 64, 0.1)
    before = tfb.finito_block_update.launches
    s2, innov = F.fused_finito_block(s.clone(), gamma, z, 16, 16, 1 / 64, 0.1)
    assert tfb.finito_block_update.launches == before
    G = F.grad_block(z, 16, 16)
    want = z[None] - (gamma[16:32] / 64)[:, None] * G
    torch.testing.assert_close(s2[16:32], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2[:16], s[:16], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _soft(v, thr):
    return np.sign(v) * np.maximum(np.abs(v) - thr, 0.0)


def _finito_state(N, n, B, storage, seed=3):
    """A planted Lasso in both packages and a Finito coefficient state:
    c at a point x0, per-block anchors near it, the av of the identity
    av = hat·(invg @ zb − apply_all(c)/N), z = soft(av, hat·λ)."""
    prob = make_lasso(N=N, n=n, p=4, seed=seed, dtype=np.float32,
                      well_conditioned=True)
    JF = _jax_oracle(prob, N, storage)
    rng = np.random.default_rng(seed + 4)
    d = N // B
    gamma = (0.999 * N / np.asarray(prob.L, np.float64)).astype(np.float32)
    hat = np.float32(1.0 / np.sum(1.0 / gamma.astype(np.float64)))
    invg = np.sum((1.0 / gamma).reshape(d, B), axis=1).astype(np.float32)
    x0 = (0.05 * rng.standard_normal(n)).astype(np.float32)
    zb = (x0[None] + 0.01 * rng.standard_normal((d, n))).astype(np.float32)
    c = np.asarray(JF.coeff_all(jnp.asarray(x0)), np.float32)
    av = (hat * (invg @ zb) - hat / N * np.asarray(
        JF.apply_all(jnp.asarray(c)))).astype(np.float32)
    z = _soft(av, hat * prob.lam).astype(np.float32)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    return dict(prob=prob, JF=JF, rs=rs, gamma=gamma, hat=hat, invg=invg,
                zb=zb, c=c, av=av, z=z, rng=rng, d=d)


def _port_rows(JF, storage):
    if storage == "bf16":
        return _t(np.asarray(JF.A.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(JF.A))


CASES = [("f32", "highest"), ("f32", "default"), ("int8", "highest")]
CASE_IDS = ["f32", "f32-default", "int8"]


@pytest.mark.parametrize("prox", ["l1", "zero"])
@pytest.mark.parametrize("storage,precision", CASES, ids=CASE_IDS)
def test_finito_multistep_ref_matches_pallas(storage, precision, prox):
    """Kernel #9 (tests/test_ops.py:309's shape: N = 1,024, n = 128,
    B = 128): K = 16 steps with repeated blocks from one state, c, zb, z
    and av of the plain version against the Pallas kernel (slab layouts
    reshaped) within 1e-4 of each one's largest entry."""
    N, n, B, K = 1024, 128, 128, 16
    S = _finito_state(N, n, B, storage)
    JF, rs = S["JF"], S["rs"]
    slab = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
    thr = S["hat"] * S["prob"].lam if prox == "l1" else 0.0
    sc = np.array([N, 1.0 / N, S["hat"], thr, jfb.MODE_LSQ, 0.0], np.float32)
    starts = (S["rng"].integers(0, S["d"], K) * B).astype(np.int32)
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jc, jzb, jz, jav = jfb.finito_coeff_multistep(
            jA, jnp.asarray(np.asarray(JF.b)).reshape(slab),
            jnp.asarray(starts), jnp.asarray(S["c"]).reshape(slab),
            jnp.asarray(S["zb"]), jnp.asarray(S["invg"])[None],
            jnp.asarray(S["z"])[None], jnp.asarray(S["av"])[None],
            jnp.asarray(sc)[None], B, precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(slab))
    st = [_t(S[k]) for k in ("c", "zb", "z", "av")]
    out = tfb.finito_coeff_multistep(
        _port_rows(JF, storage), _t(np.asarray(JF.b)), _t(starts), st[0],
        st[1], _t(S["invg"]), st[2], st[3], _t(sc), B, precision=precision,
        rs=None if rs is None else _t(rs))
    assert all(a is b for a, b in zip(out, st))  # in place
    assert not np.array_equal(st[2].numpy(), S["z"])
    for name, got, want in zip(("c", "zb", "z", "av"), st,
                               (np.asarray(jc).reshape(-1), jzb, jz[0],
                                jav[0])):
        _close(got.numpy(), want, 1e-4, name)


@pytest.mark.parametrize("f", [32, 13], ids=["f=K", "f=13"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_finito_streamed_ref_matches_pallas(storage, f):
    """Kernel #14 (tests/test_ops.py:1128's shape: N = 8,192, n = 128,
    B = 128, d = 64): K = 32 distinct blocks, step f a repeat of step 0
    (JAX's clamp point), f = K and f = 13, invg pre-gathered by step;
    the masked steps leave the state as step f − 1 left it."""
    N, n, B, K = 8192, 128, 128, 32
    S = _finito_state(N, n, B, storage)
    JF, rs = S["JF"], S["rs"]
    thr = S["hat"] * S["prob"].lam
    sc = np.array([N, 1.0 / N, S["hat"], thr, jfb.MODE_LSQ, 0.0], np.float32)
    blocks = S["rng"].permutation(S["d"])[:K]
    if f < K:
        blocks[f] = blocks[0]
    starts = (blocks * B).astype(np.int32)
    invg_k = S["invg"][blocks]
    jc, jzb, jz, jav = jfb.finito_coeff_multistep_streamed(
        JF.A, jnp.asarray(np.asarray(JF.b))[None], jnp.asarray(starts),
        jnp.asarray(invg_k), jnp.asarray(S["c"])[None], jnp.asarray(S["zb"]),
        jnp.asarray(S["z"])[None], jnp.asarray(S["av"])[None],
        jnp.asarray(sc)[None], B,
        rs1=None if rs is None else jnp.asarray(rs)[None],
        f=jnp.asarray(f, jnp.int32), interpret=True)
    rows = _port_rows(JF, storage)
    args = (_t(np.asarray(JF.b)), _t(starts), _t(invg_k))
    st = [_t(S[k]) for k in ("c", "zb", "z", "av")]
    tfb.finito_coeff_multistep_streamed(
        rows, *args, *st, _t(sc), B, rs=None if rs is None else _t(rs),
        f=torch.tensor([f], dtype=torch.int32))
    for name, got, want in zip(("c", "zb", "z", "av"), st,
                               (np.asarray(jc)[0], jzb, jz[0], jav[0])):
        _close(got.numpy(), want, 1e-4, name)
    # the masked steps are no-ops: the first f steps alone give the same
    pre = [_t(S[k]) for k in ("c", "zb", "z", "av")]
    tfb.finito_coeff_multistep_streamed_ref(
        rows, args[0], args[1][:f], args[2][:f], *pre, _t(sc), B,
        rs=None if rs is None else _t(rs))
    for a, b in zip(st, pre):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("prox", ["l1", "zero"])
@pytest.mark.parametrize("storage,precision", CASES, ids=CASE_IDS)
def test_lfinito_sweep_ref_matches_pallas(storage, precision, prox):
    """Kernel #8 (tests/test_ops.py:498's shape): a whole shuffled sweep
    of d = 8 blocks against the epoch's anchor; av and the returned z —
    the LAST block's prox point, not soft(av_out) — within 1e-4."""
    N, n, B = 1024, 128, 128
    S = _finito_state(N, n, B, storage)
    JF, rs = S["JF"], S["rs"]
    slab = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)
    thr = S["hat"] * S["prob"].lam if prox == "l1" else 0.0
    sc = np.array([N, S["hat"], thr, 1.0 / N, jfb.MODE_LSQ, 0.0], np.float32)
    zf = _soft(S["av"], thr).astype(np.float32)
    canch = np.asarray(JF.coeff_all(jnp.asarray(zf)), np.float32)
    av0 = (zf - S["hat"] / N * np.asarray(JF.apply_all(
        jnp.asarray(canch)))).astype(np.float32)
    order = S["rng"].permutation(S["d"])
    starts = (order * B).astype(np.int32)
    invg_v = S["invg"][order]
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        jav, jz = jfb.lfinito_sweep_multistep(
            jA, jnp.asarray(np.asarray(JF.b)).reshape(slab),
            jnp.asarray(canch).reshape(slab), jnp.asarray(starts),
            jnp.asarray(av0)[None], jnp.asarray(zf)[None],
            jnp.asarray(invg_v)[None], jnp.asarray(sc)[None], B,
            precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(slab))
    av = _t(av0)
    out_av, z = tfb.lfinito_sweep_multistep(
        _port_rows(JF, storage), _t(np.asarray(JF.b)), _t(canch),
        _t(starts), av, _t(zf), _t(invg_v), _t(sc), B, precision=precision,
        rs=None if rs is None else _t(rs))
    assert out_av is av
    _close(av.numpy(), jav[0], 1e-4, "av")
    _close(z.numpy(), jz[0], 1e-4, "z")
    if prox == "l1":
        assert not np.allclose(z.numpy(), _soft(av.numpy(), thr))
    # in chunks (the driver's 512-block launches, here of 3): the same
    av2 = _t(av0)
    _, z2 = tfb.lfinito_sweep_chunked(
        _port_rows(JF, storage), _t(np.asarray(JF.b)), _t(canch),
        _t(starts), _t(invg_v), av2, _t(zf), _t(sc), B, precision=precision,
        rs=None if rs is None else _t(rs), chunk=3)
    torch.testing.assert_close(av2, av, rtol=0, atol=0)
    torch.testing.assert_close(z2, z, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["f32", "bf16", "f32-default"])
def test_finito_block_update_ref_matches_pallas(case):
    """Kernel #2 (tests/test_ops.py:59's shape: N = 512, n = 256,
    B = 128, start 256): s over the block and the innovation within 1e-5
    of their largest entries, every row outside the block bit for bit.
    bf16 rows at "highest" keep z unrounded in the margin (the Pallas
    ``_row_grad``); "default" rounds both operands, so its JAX reference
    is bf16-valued rows and z."""
    N, n, B, start = 512, 256, 128, 256
    rng = np.random.default_rng(0)
    A = rng.standard_normal((N, n)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    s = rng.standard_normal((N, n)).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    gamma = rng.uniform(0.5, 2.0, N).astype(np.float32)
    if case != "f32":
        A = np.asarray(jnp.asarray(A).astype(jnp.bfloat16).astype(jnp.float32))
    if case == "f32-default":
        z = np.asarray(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32))
    sc = np.array([N, 1.0 / N, 0.37], np.float32)
    jA = jnp.asarray(A).astype(jnp.bfloat16) if case != "f32" else A
    with pltpu.force_tpu_interpret_mode():
        js, jinnov = jfb.finito_block_update(
            jnp.asarray(jA), jnp.asarray(b)[:, None], jnp.asarray(s),
            jnp.asarray(gamma)[:, None], jnp.asarray(z)[None],
            jnp.asarray(start), jnp.asarray(sc)[None], B)
    rows = _t(A).to(torch.bfloat16) if case == "bf16" else _t(A)
    ts = _t(s)
    out, innov = tfb.finito_block_update(
        rows, _t(b), ts, _t(gamma), _t(z), torch.tensor(start), _t(sc), B,
        precision="default" if case == "f32-default" else "highest")
    assert out is ts
    sl = slice(start, start + B)
    _close(ts[sl].numpy(), np.asarray(js)[sl], 1e-5, "s")
    _close(innov.numpy(), jinnov, 1e-5, "innov")
    outside = np.ones(N, bool)
    outside[sl] = False
    np.testing.assert_array_equal(ts.numpy()[outside], s[outside])


def test_wrappers_on_cpu_meta_and_gates():
    """CPU tensors take the plain versions and count no launch; a device
    with no kernel raises; the gates are closed for CPU tensors."""
    kernels = (tfb.finito_coeff_multistep, tfb.finito_coeff_multistep_streamed,
               tfb.lfinito_sweep_multistep, tfb.finito_block_update)
    before = [k.launches for k in kernels]
    S = _finito_state(1024, 128, 128, "f32")
    sc = _t(np.array([1024, 1 / 1024, S["hat"], 0.0, 0.0, 0.0], np.float32))
    A, b = _t(np.asarray(S["JF"].A)), _t(np.asarray(S["JF"].b))
    starts = torch.tensor([0, 256], dtype=torch.int32)
    st = [_t(S[k]) for k in ("c", "zb", "z", "av")]
    tfb.finito_coeff_multistep(A, b, starts, st[0], st[1], _t(S["invg"]),
                               st[2], st[3], sc, 128)
    assert [k.launches for k in kernels] == before
    m = torch.empty((64, 8), device="meta")
    v = torch.empty(64, device="meta")
    z = torch.empty(8, device="meta")
    i32 = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.finito_coeff_multistep(m, v, i32, v, m[:4], z[:4], z, z.clone(),
                                   torch.empty(6, device="meta"), 16)
    with pytest.raises(ValueError, match="no kernel"):
        tfb.lfinito_sweep_multistep(m, v, v, i32, z, z.clone(), z[:2],
                                    torch.empty(6, device="meta"), 16)
    with pytest.raises(ValueError, match="no kernel"):
        tfb.finito_block_update(m, v, m.clone(), v, z, 0,
                                torch.empty(3, device="meta"), 16)
    F = LeastSquaresRows(torch.randn(64, 8), torch.randn(64), 64.0)
    g, x0 = NormL1(0.1), torch.zeros(8)
    for gate in (tfb.finito_multistep_available,
                 tfb.finito_multistep_streamed_available,
                 tfb.lfinito_sweep_available):
        assert not gate(F, g, x0, 16)
    assert not tfb.finito_block_available(F, x0, 16)
