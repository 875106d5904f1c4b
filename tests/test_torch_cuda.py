"""The CUDA kernels ``saga_coeff_multistep`` and
``saga_coeff_multistep_streamed`` against their plain versions, and the
polish's exact-f32 check.

These tests need an NVIDIA GPU (marker ``cuda``) and skip without one:
the kernel has no CPU mode. They import no JAX, so they run on a
machine with the card and PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernel and the plain version run the same f32 arithmetic and sum in
other orders, so the states are held relative to their largest entry:
z within 1e-6 (exact-f32 dots) or 1e-5 (bf16-rounded dots), c and av
within 10x that.
"""

import pytest
import torch

from ciao_tpu_torch.ops import fused_block as tfb
from ciao_tpu_torch.oracles import LeastSquaresRows

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _setup(dev, N, n, B, K, storage, sag, weighted, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    if storage != "f32":
        F = F.with_storage(storage)
    gamma = 1.0 / (3.0 * float((A * A).sum(1).max()) * N)
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    c = F.coeff_all(z)
    av = F.apply_all(c) / N
    starts = (torch.randint(N // B, (K,), generator=gen, device=dev) * B).to(
        torch.int32)
    sc = torch.tensor([N, gamma, gamma * 0.1, 1.0 / B, 1.0 / N,
                       1.0 if sag else 0.0, 0.0, 0.0], device=dev)
    wgts = (torch.rand(K, generator=gen, device=dev) + 0.5
            if weighted else None)
    return F, (c, z, av), starts, sc, wgts


def _run_both(F, state, starts, sc, B, precision, wgts):
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (tfb.saga_coeff_multistep, tfb.saga_coeff_multistep_ref):
        st = [t.clone() for t in state]
        fn(rows, offs, starts, *st, sc, B, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts)
        outs.append(st)
    torch.cuda.synchronize()
    return outs


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage,precision,n", [
    ("f32", "highest", 256), ("f32", "default", 256), ("bf16", "highest", 256),
    ("int8", "highest", 256),
    # rows that are not whole 16-byte chunks take the one-value-at-a-time path
    ("f32", "highest", 202), ("bf16", "highest", 200), ("int8", "highest", 200),
], ids=["f32", "f32-default", "bf16", "int8", "f32-n202", "bf16-n200",
        "int8-n200"])
def test_kernel_matches_plain_version(dev, storage, precision, n, sag,
                                      weighted):
    N, B, K = 4096, 256, 32
    F, state, starts, sc, wgts = _setup(dev, N, n, B, K, storage, sag,
                                        weighted)
    before = tfb.saga_coeff_multistep.launches
    (kc, kz, kav), (rc, rz, rav) = _run_both(F, state, starts, sc, B,
                                             precision, wgts)
    assert tfb.saga_coeff_multistep.launches == before + 1
    lowp = tfb._lowp(F.A, precision)
    tol = 1e-5 if lowp else 1e-6
    assert float((rz - state[1]).abs().max()) > 0  # the steps moved z
    assert _rel(kz, rz) <= tol
    assert _rel(kav, rav) <= 10 * tol
    assert _rel(kc, rc) <= 10 * tol


def test_kernel_repeats_bit_for_bit(dev):
    """No atomics: two runs from one state give the same bits."""
    F, state, starts, sc, _ = _setup(dev, 4096, 256, 256, 16, "int8", False,
                                     False, seed=1)
    rows, offs = F.coeff_rows_data()
    runs = []
    for _ in range(2):
        st = [t.clone() for t in state]
        tfb.saga_coeff_multistep(rows, offs, starts, *st, sc, 256,
                                 rs=F.coeff_rows_scale())
        runs.append(st)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wrapper_checks_its_arguments(dev):
    F, (c, z, av), starts, sc, _ = _setup(dev, 1024, 64, 128, 4, "f32",
                                          False, False)
    rows, offs = F.coeff_rows_data()
    with pytest.raises(TypeError, match="starts"):
        tfb.saga_coeff_multistep(rows, offs, starts.long(), c, z, av, sc, 128)
    with pytest.raises(ValueError, match="shape"):
        tfb.saga_coeff_multistep(rows, offs, starts, c[:512], z, av, sc, 128)
    with pytest.raises(ValueError, match="rs"):
        tfb.saga_coeff_multistep(rows, offs, starts, c, z, av, sc, 128,
                                 rs=torch.ones(1024, device=dev))
    with pytest.raises(ValueError, match="on cpu"):
        tfb.saga_coeff_multistep(rows, offs, starts, c, z.cpu(), av, sc, 128)
    with pytest.raises(ValueError, match="bad shape"):
        tfb.saga_coeff_multistep(rows, offs, starts, c, z, av, sc, 100)


# ---------------------------------------------------------------------------
# kernel #4: saga_coeff_multistep_streamed
# ---------------------------------------------------------------------------

def _run_streamed(F, state, starts, sc, B, precision, wgts, f):
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (tfb.saga_coeff_multistep_streamed,
               tfb.saga_coeff_multistep_streamed_ref):
        st = [t.clone() for t in state]
        fn(rows, offs, starts, *st, sc, B, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts, f=f)
        outs.append(st)
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("f", [64, 23], ids=["f=K", "f=23"])
@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "wgts"])
@pytest.mark.parametrize("sag", [False, True], ids=["saga", "sag"])
@pytest.mark.parametrize("storage,precision", [
    ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
    ("int8", "highest"),
], ids=["f32", "f32-default", "bf16", "int8"])
def test_streamed_kernel_matches_plain_version(dev, storage, precision, sag,
                                               weighted, f):
    """K = 64 steps at N = 8,192, n = 128, B = 128 (d = 64, repeats
    included), clamp count f on the device; tolerances as above."""
    N, n, B, K = 8192, 128, 128, 64
    F, state, starts, sc, wgts = _setup(dev, N, n, B, K, storage, sag,
                                        weighted, seed=2)
    fc = torch.tensor([f], dtype=torch.int32, device=dev)
    before = tfb.saga_coeff_multistep_streamed.launches
    (kc, kz, kav), (rc, rz, rav) = _run_streamed(F, state, starts, sc, B,
                                                 precision, wgts, fc)
    assert tfb.saga_coeff_multistep_streamed.launches == before + 1
    tol = 1e-5 if tfb._lowp(F.A, precision) else 1e-6
    assert float((rz - state[1]).abs().max()) > 0
    assert _rel(kz, rz) <= tol
    assert _rel(kav, rav) <= 10 * tol
    assert _rel(kc, rc) <= 10 * tol


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_streamed_masked_steps_are_identity(dev, storage):
    """A launch clamped at f = 23 leaves c, z and av bit for bit as the
    first 23 steps alone leave them; f = None equals f = K."""
    F, state, starts, sc, wgts = _setup(dev, 8192, 128, 128, 64, storage,
                                        False, True, seed=3)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()

    def run(st, wg, f):
        out = [t.clone() for t in state]
        tfb.saga_coeff_multistep_streamed(rows, offs, st, *out, sc, 128,
                                          rs=rs, wgts=wg, f=f)
        torch.cuda.synchronize()
        return out

    f23 = torch.tensor([23], dtype=torch.int32, device=dev)
    for a, b in zip(run(starts, wgts, f23), run(starts[:23], wgts[:23], None)):
        assert torch.equal(a, b)
    f64 = torch.tensor(64, dtype=torch.int32, device=dev)
    for a, b in zip(run(starts, wgts, f64), run(starts, wgts, None)):
        assert torch.equal(a, b)
    f0 = torch.tensor([0], dtype=torch.int32, device=dev)
    for a, b in zip(run(starts, wgts, f0), state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_streamed_kernel_at_the_deep_target_shape(dev, storage):
    """K = 8 steps at the deep target's shape, N = 10,485,760 rows of
    n = 128, B = 8,192: 64-bit row offsets past 2^31 bytes."""
    N, n, B, K = 10 * 1024 * 1024, 128, 8192, 8
    F, state, starts, sc, _ = _setup(dev, N, n, B, K, storage, False, False,
                                     seed=4)
    starts[-1] = N - B  # the last block: its rows start 5.4 GB into f32 A
    (kc, kz, kav), (rc, rz, rav) = _run_streamed(F, state, starts, sc, B,
                                                 "highest", None, None)
    tol = 1e-5 if storage != "f32" else 1e-6
    assert _rel(kz, rz) <= tol
    assert _rel(kav, rav) <= 10 * tol
    assert _rel(kc, rc) <= 10 * tol


def test_streamed_wrapper_checks_f(dev):
    F, (c, z, av), starts, sc, _ = _setup(dev, 1024, 64, 128, 4, "f32",
                                          False, False)
    rows, offs = F.coeff_rows_data()
    with pytest.raises(TypeError, match="f must be"):
        tfb.saga_coeff_multistep_streamed(
            rows, offs, starts, c, z, av, sc, 128,
            f=torch.tensor([2], device=dev))
    with pytest.raises(ValueError, match="one count"):
        tfb.saga_coeff_multistep_streamed(
            rows, offs, starts, c, z, av, sc, 128,
            f=torch.tensor([2, 3], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="on cpu"):
        tfb.saga_coeff_multistep_streamed(
            rows, offs, starts, c, z, av, sc, 128,
            f=torch.tensor([2], dtype=torch.int32))


def test_polish_and_plain_versions_raise_under_tf32(dev):
    """On the card the compensated gradient, the power bound and the
    plain kernel versions need exact f32 products: with TF32 on they
    raise, and they leave the flag as they found it."""
    from ciao_tpu_torch.solvers.polish import grad_mean_chunked, power_lmax

    F, (c, z, av), starts, sc, _ = _setup(dev, 1024, 64, 128, 4, "f32",
                                          False, False)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            grad_mean_chunked(F, z, 256)
        with pytest.raises(RuntimeError, match="TF32"):
            power_lmax(F, z, 0)
        rows, offs = F.coeff_rows_data()
        with pytest.raises(RuntimeError, match="TF32"):
            tfb.saga_coeff_multistep_ref(rows, offs, starts, c, z, av, sc,
                                         128)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    g = grad_mean_chunked(F, z, 256)
    want = F.apply_all(F.coeff_all(z)) / 1024
    assert _rel(g, want) <= 1e-5


def test_facade_sends_every_block_run_to_a_kernel(dev):
    """On the card a block-sampling run whose gate is open takes a kernel
    whatever its block count: N = 4,224 rows of B = 128 (d = 33, which
    the JAX package runs stepwise) go to the resident kernel with no
    fallback warning, 256 steps in two launches, and the objective
    falls."""
    import warnings

    from ciao_tpu_torch import SAGA
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.prox import NormL1

    N, n, B = 4224, 64, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    A = torch.randn(N, n, generator=gen, device=dev)
    F = LeastSquaresRows(A, torch.randn(N, generator=gen, device=dev),
                         float(N))
    g = NormL1(torch.tensor(0.01, device=dev))
    x0 = torch.zeros(n, device=dev)
    before = tfb.saga_coeff_multistep.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, it = SAGA(maxit=257, block_sampling=True, batch=B)(
            x0, F=F, g=g, L=(A * A).sum(1) * N)
    assert it == 257
    assert tfb.saga_coeff_multistep.launches == before + 2
    assert float(objective(F, g, x)) < float(objective(F, g, x0))
