"""The CUDA kernel ``saga_coeff_multistep`` against its plain version.

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
