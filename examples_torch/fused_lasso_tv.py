"""Analysis sparsity to certified accuracy: ``ciao_tpu_torch.deep_solve_pd``
on the fused lasso.

The port of ``examples/fused_lasso_tv.py``: ``min ½‖Ax−b‖² + λ‖Dx‖₁``
with the difference operator inside the nonsmooth term. Compensated
Condat-Vũ runs to identification of the jump set, then ``tv_refine``
solves the reduced problem on it exactly and certifies it (a KKT dual
certificate), so that flat runs come out exactly flat in f32. No kernel
lies on this route (the JAX package runs it outside Pallas too).

    python examples_torch/fused_lasso_tv.py          # 65,536 x 512
    python examples_torch/fused_lasso_tv.py small    # smoke shapes
    python examples_torch/fused_lasso_tv.py small cpu

The problem is the JAX example's: ``make_fused_lasso_planted``'s numpy
draws at seed 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import ciao_tpu_torch
from ciao_tpu_torch import FirstDifference, LeastSquaresRows, NormL1, runtime
from ciao_tpu_torch.utils import make_fused_lasso_planted


def main(N=65_536, n=512, jumps=12, small=False, device=None):
    dev = runtime.entry_device(device)
    if small:  # smoke shapes (tests/test_torch_examples.py)
        N, n, jumps = 4_096, 128, 6
    prob = make_fused_lasso_planted(N=N, n=n, jumps=jumps, seed=0)
    F = LeastSquaresRows(
        torch.tensor(prob.A, dtype=torch.float32, device=dev),
        torch.tensor(prob.b, dtype=torch.float32, device=dev), float(N))
    h = NormL1(float(prob.lam))

    x, info = ciao_tpu_torch.deep_solve_pd(
        torch.zeros(n, device=dev), F, h=h, K=FirstDifference(), N=N,
        chunk=4096, chunk_steps=256, max_steps=16_384,
    )
    x = x.cpu().numpy()
    rel = (prob.cost(x) - prob.f_star) / abs(prob.f_star)
    d = np.abs(np.diff(np.asarray(x, np.float64)))
    true_J = np.abs(np.diff(prob.x_star)) > 0
    print(f"deep_solve_pd: rel suboptimality {rel:.3e} in {info.steps} "
          f"CV steps (refined={info.refined}, certified={info.certified}, "
          f"tau={info.tau:.3e})")
    print(f"jumps recovered {int(np.sum(d[true_J] > 1e-2))}/"
          f"{int(true_J.sum())}, spurious {int(np.sum(d[~true_J] > 0))} "
          f"(flat runs exactly flat: {bool(np.all(d[~true_J] == 0.0))})")
    assert info.refined and info.certified
    assert 0 <= rel < 1e-7, rel
    assert np.all(d[~true_J] == 0.0)
    return rel, x, info


if __name__ == "__main__":
    main(small="small" in sys.argv[1:],
         device="cpu" if "cpu" in sys.argv[1:] else None)
