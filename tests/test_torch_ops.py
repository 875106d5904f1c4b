"""The port's SAGA coefficient-table kernel against the JAX package.

``ciao_tpu_torch.ops.fused_block`` holds the hand-written CUDA kernel
``saga_coeff_multistep`` and its plain PyTorch version. On the CPU the
wrapper runs the plain version, which is held here against the Pallas
kernel it replaces (``ciao_tpu.ops.fused_block.saga_coeff_multistep``),
run in TPU interpret mode as ``tests/test_ops.py`` runs it, on the same
numpy inputs and the same explicit block schedule. The kernel itself is
held against the plain version on the card by tests/test_torch_cuda.py.
The ctypes signatures of every kernel library are held here against the
C entries of their sources.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ciao_tpu.ops import fused_block as jfb
from ciao_tpu.oracles import LeastSquaresRows as JLeastSquaresRows
from ciao_tpu.utils.problems import make_lasso as jmake_lasso
from ciao_tpu_torch.ops import _build
from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1, Zero
from torch_threads import one_torch_thread  # noqa: F401

N, n, B, K = 1024, 128, 128, 16
SLAB = (jfb.SLAB_ROWS, N // jfb.SLAB_ROWS)


def _t(a):
    """A torch copy of a numpy array (the kernel updates in place)."""
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("mode", [jfb.MODE_LSQ, jfb.MODE_LOGISTIC,
                                  jfb.MODE_HUBER, jfb.MODE_SQHINGE,
                                  jfb.MODE_POISSON])
def test_coeff_formula_matches_jax(mode):
    """Every oracle mode of the per-row formula, f32, including margins
    past the Poisson clamp. Tolerance rtol 5e-6: exp and sigmoid may
    differ by a few ulps between the two libraries."""
    assert (tfb.MODE_LSQ, tfb.MODE_LOGISTIC, tfb.MODE_HUBER, tfb.MODE_SQHINGE,
            tfb.MODE_POISSON) == (jfb.MODE_LSQ, jfb.MODE_LOGISTIC,
                                  jfb.MODE_HUBER, jfb.MODE_SQHINGE,
                                  jfb.MODE_POISSON)
    assert tfb.POISSON_CLAMP == jfb.POISSON_CLAMP
    rng = np.random.default_rng(mode)
    r = (rng.standard_normal(512) * 4).astype(np.float32)
    r[:8] = [31.0, 40.0, -31.0, 0.0, 29.9, 30.0, -1e-3, 1e-3]
    if mode in (jfb.MODE_LOGISTIC, jfb.MODE_SQHINGE):
        b = np.sign(rng.standard_normal(512)).astype(np.float32)
    elif mode == jfb.MODE_POISSON:
        b = rng.poisson(3.0, 512).astype(np.float32)
    else:
        b = rng.standard_normal(512).astype(np.float32)
    scale, aux = np.float32(7.0), np.float32(0.5)
    want = np.asarray(jfb._coeff_formula(mode, jnp.asarray(r), jnp.asarray(b),
                                         jnp.float32(scale), jnp.float32(aux)))
    got = tfb._coeff_formula(torch.tensor(float(mode)), _t(r), _t(b),
                             torch.tensor(scale), torch.tensor(aux))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-6, atol=1e-30)


def _problem(storage: str, seed: int = 3):
    """A planted Lasso in both packages, with a SAGA-like state: z a
    small random point, c its coefficients, av their mean row gradient."""
    prob = jmake_lasso(N=N, n=n, p=4, seed=seed, dtype=np.float32,
                       well_conditioned=True)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(N), jnp.float32))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    rng = np.random.default_rng(seed)
    z = (0.05 * rng.standard_normal(n)).astype(np.float32)
    c = np.asarray(JF.coeff_all(jnp.asarray(z)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(c)), np.float32) / N
    starts = (rng.integers(0, N // B, K) * B).astype(np.int32)
    wgts = rng.uniform(0.5, 2.0, K).astype(np.float32)
    gamma = np.float32(1.0 / (3.0 * np.max(prob.L)))
    return JF, rs, z, c, av, starts, wgts, gamma, prob


def _scalars(gamma, lam, sag: bool):
    return np.array([N, gamma, gamma * lam, 1.0 / B, 1.0 / N,
                     1.0 if sag else 0.0, jfb.MODE_LSQ, 0.0], np.float32)


def _torch_rows(JF, storage):
    """The JAX oracle's stored rows as a torch tensor of the same dtype."""
    if storage == "bf16":
        return _t(np.asarray(JF.A.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(JF.A))


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage,precision", [
    ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
    ("int8", "highest"),
], ids=["f32", "f32-default", "bf16", "int8"])
def test_multistep_ref_matches_pallas(storage, precision, sag, weighted):
    """K = 16 steps of the plain version against the Pallas kernel in
    interpret mode, same schedule (with repeated blocks). The weights
    scale the SAGA direction only; SAG ignores them. Tolerances as
    tests/test_ops.py's fused-vs-stepwise suite: z rtol 1e-4; av and c
    rtol 1e-3 for exact-f32 dots; where both dot operands round to bf16
    the two libraries' different summation orders meet bf16-rounded
    innovation inputs, so c and av take atols scaled by their largest
    entry (1e-4 and 1e-5 of it)."""
    JF, rs, z, c, av, starts, wgts, gamma, prob = _problem(storage)
    sc = _scalars(gamma, prob.lam, sag)
    w = wgts if weighted else None
    # "default" precision means bf16 operands with f32 accumulation, as
    # on the TPU's MXU; on the CPU XLA keeps f32 dots exact at any
    # precision, so the reference for it is the same rows stored bf16,
    # which rounds both operands exactly so
    jA = JF.A.astype(jnp.bfloat16) if precision == "default" else JF.A
    with pltpu.force_tpu_interpret_mode():
        c8, z2, av2 = jfb.saga_coeff_multistep(
            jA, jnp.asarray(np.asarray(JF.b)).reshape(SLAB),
            jnp.asarray(starts), jnp.asarray(c).reshape(SLAB),
            jnp.asarray(z)[None], jnp.asarray(av)[None], jnp.asarray(sc)[None],
            B, precision=precision,
            rs8=None if rs is None else jnp.asarray(rs).reshape(SLAB),
            wgts=None if w is None else jnp.asarray(w),
        )
    jc, jz, jav = (np.asarray(c8).reshape(N), np.asarray(z2)[0],
                   np.asarray(av2)[0])

    tc, tz, tav = _t(c), _t(z), _t(av)
    out = tfb.saga_coeff_multistep(
        _torch_rows(JF, storage), _t(np.asarray(JF.b)), _t(starts), tc, tz,
        tav, _t(sc), B, precision=precision,
        rs=None if rs is None else _t(rs), wgts=None if w is None else _t(w))
    assert out[0] is tc and out[1] is tz and out[2] is tav  # in place
    assert not np.array_equal(tz.numpy(), z)  # the steps moved z
    lowp = storage != "f32" or precision == "default"
    np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-4, atol=1e-6)
    av_atol = 1e-5 * np.abs(jav).max() if lowp else 1e-4
    c_atol = 1e-4 * np.abs(jc).max() if lowp else 1e-3
    np.testing.assert_allclose(tav.numpy(), jav, rtol=1e-3, atol=av_atol)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-3, atol=c_atol)
    # rows outside every visited block keep their coefficients exactly
    visited = np.zeros(N, bool)
    for s in starts:
        visited[s:s + B] = True
    np.testing.assert_array_equal(tc.numpy()[~visited], c[~visited])


def test_oracle_scalar_consts_and_gate():
    """The scalars row's constants, and the kernel gate, which is closed
    for CPU tensors and for a prox the kernel does not apply."""
    A = torch.randn(64, 8)
    F = LeastSquaresRows(A, torch.randn(64), 64.0)
    g = NormL1(0.25)
    scale, mode, lam, aux = tfb.oracle_scalar_consts(F, g)
    assert float(scale) == 64.0 and float(mode) == tfb.MODE_LSQ
    assert float(lam) == 0.25 and float(aux) == 0.0
    assert float(tfb.oracle_scalar_consts(F, Zero())[2]) == 0.0
    x0 = torch.zeros(8)
    assert not tfb.saga_multistep_available(F, g, x0, 16)  # CPU tensors
    assert not tfb.saga_multistep_available(F, object(), x0, 16)


def test_wrapper_rejects_devices_without_kernel():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain-version fallback: the wrapper raises."""
    A = torch.empty((64, 8), device="meta")
    v = torch.empty(64, device="meta")
    z = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.saga_coeff_multistep(A, v, torch.zeros(2, dtype=torch.int32,
                                                   device="meta"),
                                 v, z, z.clone(), torch.empty(8, device="meta"),
                                 16)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    A = torch.randn(64, 8)
    before = tfb.saga_coeff_multistep.launches
    args = (A, torch.randn(64), torch.tensor([0, 32], dtype=torch.int32))
    sc = torch.tensor([64.0, 0.01, 0.001, 1 / 32, 1 / 64, 0.0, 0.0, 0.0])
    state = [torch.zeros(64), torch.ones(8), torch.zeros(8)]
    ref = [t.clone() for t in state]
    tfb.saga_coeff_multistep(*args, *state, sc, 32)
    tfb.saga_coeff_multistep_ref(*args, *ref, sc, 32)
    assert tfb.saga_coeff_multistep.launches == before
    for got, want in zip(state, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("B,n,itemsize,rows", [
    (4096, 1024, 4, 32), (4096, 1024, 1, 32), (96, 1024, 4, 32),
    (100, 64, 4, 4), (4096, 16384, 4, 2), (4096, tfb.MAX_COLS, 2, 4),
])
def test_rows_per_cta_fits_shared_memory(B, n, itemsize, rows):
    """The row phase's CTA size: the largest power of two up to 32 that
    divides B and whose tile, z and per-row values fit in a Hopper CTA's
    shared memory."""
    assert tfb._rows_per_cta(B, n, itemsize) == rows
    assert tfb._smem_bytes(rows, n, itemsize) <= tfb.SMEM_BYTES
    assert (rows == 32 or B % (2 * rows)
            or tfb._smem_bytes(2 * rows, n, itemsize) > tfb.SMEM_BYTES)


_ENTRY = re.compile(r'extern "C" int (\w+)_launch\(([^)]*)\)')


@pytest.mark.parametrize("name", sorted(tfb._ARGTYPES))
def test_argtypes_match_the_c_entry(name):
    """The ctypes signature of each kernel library (``_ARGTYPES``) lists
    its C entry's parameters in their order: ``P`` for a pointer, ``I``
    for an int, ``L`` for a long long. A wrong kind passes a pointer as
    32 bits, a missing one shifts every argument after it: faults only a
    card would show."""
    m = _ENTRY.search((_build.CSRC / f"{name}.cu").read_text())
    assert m is not None and m.group(1) == name
    kinds = ""
    for param in m.group(2).split(","):
        param = " ".join(param.split())
        kinds += ("P" if "*" in param
                  else "L" if param.startswith("long long ")
                  else "I" if param.startswith("int ") else "?")
    assert kinds == tfb._ARGTYPES[name]


def test_every_kernel_source_is_bound_and_its_headers_exist():
    """Each ``csrc/*.cu`` is the library of an entry of ``_ARGTYPES``,
    and every header a source includes is in ``csrc``."""
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert {p.stem for p in sources} == set(tfb._ARGTYPES)
    for src in sources:
        for header in _build.headers(src):
            assert header.parent == _build.CSRC, (src.name, header)
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (_build.CSRC / inc).is_file(), (src.name, inc)


def test_ref_rejects_unknown_precision():
    A = torch.randn(32, 8)
    with pytest.raises(ValueError, match="precision"):
        tfb.saga_coeff_multistep_ref(
            A, torch.randn(32), torch.zeros(1, dtype=torch.int32),
            torch.zeros(32), torch.zeros(8), torch.zeros(8), torch.zeros(8),
            16, precision="tf32")


# ---------------------------------------------------------------------------
# kernel #4: saga_coeff_multistep_streamed (any N, steps k >= f masked)
# ---------------------------------------------------------------------------

NS, BS = 8192, 128  # d = 64 blocks, as tests/test_ops.py's streamed suite


def _streamed_problem(storage: str):
    prob = jmake_lasso(N=NS, n=n, p=4, seed=3, dtype=np.float32)
    JF = JLeastSquaresRows(A=jnp.asarray(prob.A), b=jnp.asarray(prob.b),
                           scale=jnp.asarray(float(NS), jnp.float32))
    if storage != "f32":
        JF = JF.with_storage(storage)
    rs = None if JF.row_scale is None else np.asarray(JF.row_scale)
    rng = np.random.default_rng(11)
    z = (0.05 * rng.standard_normal(n)).astype(np.float32)
    c = np.asarray(JF.coeff_all(jnp.asarray(z)), np.float32)
    av = np.asarray(JF.apply_all(jnp.asarray(c)), np.float32) / NS
    gamma = np.float32(1.0 / (3.0 * np.max(prob.L)))
    return JF, rs, z, c, av, gamma, prob, rng


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_streamed_ref_matches_pallas(storage, sag, weighted):
    """The plain version of kernel #4 against the Pallas kernel in
    interpret mode on the same (1, N) inputs: K = 8 and 16 distinct
    blocks (the JAX kernel's contract for f = K), clamp count f = K and
    f = 3. Tolerances as test_multistep_ref_matches_pallas (z rtol 1e-4;
    c, av rtol 1e-3, with atols scaled by the largest entry where the
    dots round to bf16). A masked step writes nothing: every row outside
    the f committed blocks keeps its coefficient bit for bit."""
    JF, rs, z, c, av, gamma, prob, rng = _streamed_problem(storage)
    sc = np.array([NS, gamma, gamma * prob.lam, 1.0 / BS, 1.0 / NS,
                   1.0 if sag else 0.0, jfb.MODE_LSQ, 0.0], np.float32)
    lowp = storage != "f32"
    for K in (8, 16):
        starts = (rng.choice(NS // BS, K, replace=False) * BS).astype(
            np.int32)
        w = rng.uniform(0.5, 2.0, K).astype(np.float32) if weighted else None
        for f in (K, 3):
            c1, z2, av2 = jfb.saga_coeff_multistep_streamed(
                JF.A, jnp.asarray(np.asarray(JF.b))[None],
                jnp.asarray(starts), jnp.asarray(c)[None],
                jnp.asarray(z)[None], jnp.asarray(av)[None],
                jnp.asarray(sc)[None], BS,
                rs1=None if rs is None else jnp.asarray(rs)[None],
                wgts=None if w is None else jnp.asarray(w),
                f=jnp.asarray(f, jnp.int32), interpret=True)
            jc, jz, jav = (np.asarray(c1)[0], np.asarray(z2)[0],
                           np.asarray(av2)[0])
            tc, tz, tav = _t(c), _t(z), _t(av)
            tfb.saga_coeff_multistep_streamed(
                _torch_rows(JF, storage), _t(np.asarray(JF.b)), _t(starts),
                tc, tz, tav, _t(sc), BS, rs=None if rs is None else _t(rs),
                wgts=None if w is None else _t(w),
                f=torch.tensor([f], dtype=torch.int32))
            tag = f"K={K} f={f}"
            assert not np.array_equal(tz.numpy(), z), tag
            np.testing.assert_allclose(tz.numpy(), jz, rtol=1e-4, atol=1e-6,
                                       err_msg=tag)
            av_atol = 1e-5 * np.abs(jav).max() if lowp else 1e-4
            c_atol = 1e-4 * np.abs(jc).max() if lowp else 1e-3
            np.testing.assert_allclose(tav.numpy(), jav, rtol=1e-3,
                                       atol=av_atol, err_msg=tag)
            np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-3,
                                       atol=c_atol, err_msg=tag)
            committed = np.zeros(NS, bool)
            for s in starts[:f]:
                committed[s:s + BS] = True
            np.testing.assert_array_equal(tc.numpy()[~committed],
                                          c[~committed], err_msg=tag)


def test_streamed_masked_steps_write_nothing():
    """Within the port: a launch clamped at f leaves c, z and av bit for
    bit as the first f steps alone leave them, whatever the masked steps
    hold (here repeats of committed blocks and other weights); f = None
    runs all K, as f = K does."""
    JF, rs, z, c, av, gamma, prob, rng = _streamed_problem("int8")
    sc = _t(np.array([NS, gamma, gamma * prob.lam, 1.0 / BS, 1.0 / NS, 0.0,
                      jfb.MODE_LSQ, 0.0], np.float32))
    A, b = _torch_rows(JF, "int8"), _t(np.asarray(JF.b))
    starts = _t((rng.integers(0, NS // BS, 12) * BS).astype(np.int32))
    starts[7:] = starts[:5]
    w = _t(rng.uniform(0.5, 2.0, 12).astype(np.float32))

    def run(st, wg, f):
        state = [_t(c), _t(z), _t(av)]
        tfb.saga_coeff_multistep_streamed(A, b, st, *state, sc, BS,
                                          rs=_t(rs), wgts=wg, f=f)
        return state

    for f in (0, 5, 7):
        got = run(starts, w, torch.tensor(f, dtype=torch.int32))
        want = ([_t(c), _t(z), _t(av)] if f == 0
                else run(starts[:f], w[:f], None))
        for a, e in zip(got, want):
            torch.testing.assert_close(a, e, rtol=0, atol=0)
    for a, e in zip(run(starts, w, None),
                    run(starts, w, torch.tensor([12], dtype=torch.int32))):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_streamed_wrapper_on_cpu_and_gate(monkeypatch):
    """CPU tensors take the plain version and count no kernel launch,
    weighted or not; a device with no kernel raises; the streamed gate is
    the resident kernel's, closed for CPU tensors, with no block minimum
    (the port does not clamp)."""
    A = torch.randn(64, 8)
    args = (A, torch.randn(64), torch.tensor([0, 32], dtype=torch.int32))
    sc = torch.tensor([64.0, 0.01, 0.001, 1 / 32, 1 / 64, 0.0, 0.0, 0.0])
    state = [torch.zeros(64), torch.ones(8), torch.zeros(8)]
    ref = [t.clone() for t in state]
    kernel = tfb.saga_coeff_multistep_streamed
    before = kernel.launches, kernel.weighted_launches
    wg = torch.ones(2)
    kernel(*args, *state, sc, 32, wgts=wg)
    tfb.saga_coeff_multistep_streamed_ref(*args, *ref, sc, 32, wgts=wg)
    assert (kernel.launches, kernel.weighted_launches) == before
    for got, want in zip(state, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    m = torch.empty((64, 8), device="meta")
    v = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.saga_coeff_multistep_streamed(
            m, v, torch.zeros(2, dtype=torch.int32, device="meta"), v,
            torch.empty(8, device="meta"), torch.empty(8, device="meta"),
            torch.empty(8, device="meta"), 16)
    F = LeastSquaresRows(torch.randn(64 * 16, 8), torch.randn(64 * 16), 1.0)
    assert not tfb.saga_multistep_streamed_available(F, NormL1(0.1),
                                                     torch.zeros(8), 16)
    # with the resident gate open, d = 4 blocks of 256 rows pass
    monkeypatch.setattr(tfb, "saga_multistep_available",
                        lambda F, g, x0, B: True)
    assert tfb.saga_multistep_streamed_available(F, NormL1(0.1),
                                                 torch.zeros(8), 256)


@pytest.mark.parametrize("tf32", [False, True])
def test_plain_versions_leave_tf32_flag_alone(tf32):
    """The plain versions check the TF32 flag instead of setting it: on
    the CPU (exact f32 whatever the flag) they run and leave it as they
    found it; for a CUDA device with TF32 on, the check raises."""
    from ciao_tpu_torch import runtime

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        A = torch.randn(64, 8)
        args = (A, torch.randn(64), torch.tensor([0, 32], dtype=torch.int32),
                torch.zeros(64), torch.ones(8), torch.zeros(8),
                torch.tensor([64.0, 0.01, 0.001, 1 / 32, 1 / 64, 0, 0, 0]),
                32)
        tfb.saga_coeff_multistep_ref(*args)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        tfb.saga_coeff_multistep_streamed_ref(*args)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        runtime.require_exact_f32_matmul("cpu", "test")
        if tf32:
            with pytest.raises(RuntimeError, match="TF32"):
                runtime.require_exact_f32_matmul("cuda", "test")
        else:
            runtime.require_exact_f32_matmul("cuda", "test")
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
