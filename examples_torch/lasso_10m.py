"""The BASELINE.json headline problem: a 10M x 100 Lasso on one card.

The port of ``examples/lasso_10m.py``. At n = 100 the rows are dense and
zero-padded to 128 columns: the padding carries zeros (the same
problem), and 128-column rows take the persistent engine's narrow-row
split (eight warps a row group). The solver is LFinito, the reference's
own answer to N beyond table capacity (O(n) state,
``Finito_LFinito.jl``): each epoch is one pass of kernel #6 and one
sweep of kernel #8 over the rows. A is 10,485,760 x 128, 5 GiB in f32.

    python examples_torch/lasso_10m.py          # f32 on the card
    python examples_torch/lasso_10m.py bf16     # bf16-stored rows
    python examples_torch/lasso_10m.py int8     # int8-stored rows
    python examples_torch/lasso_10m.py small cpu  # smoke shapes

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

LIVE = 100  # live columns of the 128
# the H100 80GB HBM3's one-pass read rate at 700 W, 3,061-3,156 GB/s
# (PERF.md section 5), to size the timed run to about half a second
READ_BYTES_PER_S = 3.0e12


def main(N=10 * 1024 * 1024, n=128, B=8_192, epochs=12, storage="f32",
         small=False, device=None):
    dev = runtime.entry_device(device)
    if small:  # smoke shapes (tests/test_torch_examples.py): same code path
        N, B, epochs = 8_192, 512, 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn(N, n, generator=gen, device=dev)
    a[:, LIVE:] = 0.0
    L = torch.cat([torch.sum(c * c, dim=1) for c in a.split(1 << 20)]) * N
    rs = None
    if storage == "int8":
        A, rs = quantize_rows(a)
    else:
        A = a.to(torch.bfloat16) if storage == "bf16" else a
    del a
    b = torch.randn(N, generator=gen, device=dev)
    F = LeastSquaresRows(A, b, float(N), rs)
    del A
    lam = 0.1
    g = NormL1(lam)

    cfg = FinitoCfg(N=N, batch=B, sweeping=3, alpha=0.999,
                    fused=dev.type == "cuda")
    z0 = torch.zeros(n, device=dev)
    st = lfinito_init(F, g, z0, 0.999 * N / L, 0, cfg)

    if not small:
        # a timed run of about half a second: two passes over the rows an
        # epoch
        est_epoch_s = 2 * N * n * F.A.element_size() / READ_BYTES_PER_S
        epochs = max(epochs, min(512, int(0.5 / est_epoch_s) + 1))

    st = finito_run(F, g, st, cfg, "lfinito", epochs)  # warm
    _ = float(st.z[0])
    t0 = time.perf_counter()
    st = finito_run(F, g, st, cfg, "lfinito", epochs)
    _ = float(st.z[0])
    dt = time.perf_counter() - t0
    bpe = F.A.element_size()
    ms = dt / epochs * 1e3
    print(f"LFinito {N:,}x100 (pad 128) [{storage}]: "
          f"{ms:.1f} ms/epoch = {epochs / dt:.1f} epochs/s "
          f"({epochs * 2 * N * n * bpe / dt / 1e9:.0f} GB/s effective)")
    def obj(z):
        return float(torch.real(F.value_sum_all(z)) / N
                     + lam * torch.sum(torch.abs(z)))

    o0, oz = obj(z0), obj(st.z)
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
