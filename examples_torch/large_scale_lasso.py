"""Large-N Lasso on one card: the low-memory LFinito path.

The port of ``examples/large_scale_lasso.py``. The reference's answer to
N beyond table capacity is LFinito (O(n) state, two gradient passes per
sample per epoch, ``Finito_LFinito.jl``); on the card each epoch is one
pass of kernel #6 (the anchor refresh) and one sweep of kernel #8 over
the rows. 2,097,152 x 1,024 rows are 8 GiB in f32; int8 storage holds
8,388,608 x 1,024, an f32 operator of 32 GiB, built a chunk of rows at a
time so that its f32 rows never exist whole:

    python examples_torch/large_scale_lasso.py          # f32 on the card
    python examples_torch/large_scale_lasso.py bf16     # bf16-stored rows
    python examples_torch/large_scale_lasso.py int8     # 8M x 1,024 int8
    python examples_torch/large_scale_lasso.py small cpu  # smoke shapes

The rows and b are drawn on the device from a ``torch.Generator`` seeded
0 (the JAX example draws them with ``jax.random``).
"""

import sys
import time

import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.oracles.base import quantize_rows
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.solvers.finito import FinitoCfg, finito_run, lfinito_init

CHUNK = 524_288  # rows drawn, squared and quantized at a time


def _build(gen, N, n, dev, storage, chunk=CHUNK):
    """(A, row_scale, L) with L_i = ‖a_i‖²·N, a chunk of rows at a time:
    f32 rows are drawn into A in place; int8 rows are quantized from each
    drawn f32 chunk, so that the peak is the int8 matrix and one f32
    chunk."""
    int8 = storage == "int8"
    A = torch.empty(N, n, device=dev,
                    dtype=torch.int8 if int8 else torch.float32)
    rs = torch.empty(N, device=dev) if int8 else None
    L = torch.empty(N, device=dev)
    for s in range(0, N, chunk):
        k = min(chunk, N - s)
        a = torch.randn(k, n, generator=gen, device=dev)
        if int8:
            A[s:s + k], rs[s:s + k] = quantize_rows(a)
        else:
            A[s:s + k] = a
        L[s:s + k] = torch.sum(a * a, dim=1) * N
    return A, rs, L


def objective(F, z, lam, N):
    """(1/N)·Σf_i(z) + λ‖z‖₁ (the oracle's full pass widens narrow rows a
    chunk at a time)."""
    return float(torch.real(F.value_sum_all(z)) / N
                 + lam * torch.sum(torch.abs(z)))


def main(N=2_097_152, n=1_024, B=4_096, epochs=20, storage="f32",
         small=False, device=None):
    dev = runtime.entry_device(device)
    if small:  # smoke shapes (tests/test_torch_examples.py): same code path
        N, B, epochs = 2_048, 256, 2
    if storage == "int8" and not small:
        N = 4 * N  # the f32 run's byte budget
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    A, rs, L = _build(gen, N, n, dev, storage)
    b = torch.randn(N, generator=gen, device=dev)
    F = LeastSquaresRows(A, b, float(N), rs)
    del A
    if storage == "bf16":
        F = F.with_storage()  # state and coefficients stay f32
    lam = 0.1
    g = NormL1(lam)

    # the kernels on the card; the CPU smoke run takes the stepwise epoch
    cfg = FinitoCfg(N=N, batch=B, sweeping=3, alpha=0.999,
                    fused=dev.type == "cuda")
    z0 = torch.zeros(n, device=dev)
    st = lfinito_init(F, g, z0, 0.999 * N / L, 0, cfg)

    st = finito_run(F, g, st, cfg, "lfinito", epochs)  # warm
    _ = float(st.z[0])
    t0 = time.perf_counter()
    st = finito_run(F, g, st, cfg, "lfinito", epochs)
    _ = float(st.z[0])
    dt = time.perf_counter() - t0
    bpe = F.A.element_size()
    ms = dt / epochs * 1e3
    print(f"N={N:,} n={n} [{storage}]: {ms:.1f} ms/epoch "
          f"({epochs * 2 * N * n * bpe / dt / 1e9:.0f} GB/s effective)")
    o0 = objective(F, z0, lam, N)
    oz = objective(F, st.z, lam, N)
    assert bool(torch.isfinite(st.z).all())
    assert oz < o0, f"LFinito must decrease the objective ({oz} vs {o0})"
    return dict(objective0=o0, objective=oz, ms_per_epoch=ms, N=N,
                epochs=2 * epochs)


if __name__ == "__main__":
    _stor = "f32"
    for _s in ("bf16", "int8"):
        if _s in sys.argv[1:]:
            _stor = _s
    main(storage=_stor, small="small" in sys.argv[1:],
         device="cpu" if "cpu" in sys.argv[1:] else None)
