"""Deep accuracy as one call: ``ciao_tpu_torch.deep_solve``.

The port of ``examples/deep_accuracy.py``. Every f32 stochastic solver
floors at rel ~√N·eps, the rounding of the full-gradient reduction.
``deep_solve`` runs fused SAGA to that plateau (kernel #3 up to 2^20
rows, #4 beyond), then compensated-gradient monotone FISTA at the
curvature-bound step η = 0.9/λ̂ of ``power_lmax``: its passes are plain
chunked products with a two-sum carry, no kernel, as in the JAX package.

    python examples_torch/deep_accuracy.py          # 1M x 128 on the card
    python examples_torch/deep_accuracy.py small    # smoke shapes
    python examples_torch/deep_accuracy.py small cpu

The problem is the JAX example's: ``make_lasso``'s numpy draws at seed 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import ciao_tpu_torch
from ciao_tpu_torch import LeastSquaresRows, NormL1, runtime
from ciao_tpu_torch.utils.problems import make_lasso


def main(N=1024 * 1024, n=128, batch=8_192, small=False, device=None):
    dev = runtime.entry_device(device)
    if small:  # smoke shapes (tests/test_torch_examples.py)
        N, batch = 4_096, 256
    prob = make_lasso(N=N, n=n, p=16, seed=0, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A, device=dev),
                         torch.tensor(prob.b, device=dev), float(N))
    g = NormL1(float(prob.lam))

    x, info = ciao_tpu_torch.deep_solve(
        torch.zeros(n, device=dev), F, g, L=prob.L, N=N,
        batch=batch, chunk_epochs=8, max_epochs=128, plateau_rtol=1e-4,
    )
    rel = (prob.cost(x.double().cpu().numpy()) - prob.f_star) / abs(
        prob.f_star)
    print(f"deep_solve: rel suboptimality {rel:.3e} "
          f"({sum(info.staged.epochs)} SAGA epochs + {info.polish_steps} "
          f"polish steps; lambda_max {info.lmax:.3e}, eta {info.eta:.3e})")
    assert rel <= 1e-6, rel
    return rel


if __name__ == "__main__":
    main(small="small" in sys.argv[1:],
         device="cpu" if "cpu" in sys.argv[1:] else None)
