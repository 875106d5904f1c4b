"""Robust regression with the Huber oracle and the Katyusha solver.

The port of ``examples/robust_regression.py``. Both are beyond the
reference's surface (its oracle set has no robust loss; its solver set
has no accelerated method) but ride the same machinery: rank-1
coefficients, contiguous-block streaming, data-parallel sharding, and on
the card the Huber clip is kernel #10's in-kernel formula (MODE_HUBER,
δ its aux scalar), with the anchor pass on #6. The script corrupts 10 %
of a planted regression's targets with gross outliers, then shows

  * plain least squares (the closed form) is dragged off the signal;
  * Huber + Katyusha recovers it, in a handful of accelerated epochs;
  * the same problem solved data-parallel (DP Katyusha) on the ranks of
    the process group: one rank of its own when none is running, or
    every rank ``torchrun`` starts.

    python examples_torch/robust_regression.py        # on the card
    python examples_torch/robust_regression.py cpu    # one CPU rank
    torchrun --nproc-per-node 2 examples_torch/robust_regression.py cpu

The draws are the JAX example's (numpy, seed 0), so both packages get one
problem; the rows are f32, as JAX's script runs them.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from ciao_tpu_torch import HuberRows, Katyusha, runtime
from ciao_tpu_torch.parallel import DPKatyusha, make_mesh, shard_finite_sum
from ciao_tpu_torch.parallel.mesh import process_group


def problem(seed=0):
    """(A, y, x_true): the planted regression with 10 % gross outliers."""
    rng = np.random.default_rng(seed)
    N, n = 4096, 64
    A = rng.standard_normal((N, n))
    x_true = rng.standard_normal(n)
    y = A @ x_true + 0.01 * rng.standard_normal(N)
    out = rng.choice(N, size=N // 10, replace=False)
    y[out] += 50.0 * rng.standard_normal(out.size)
    return A, y, x_true


def main(device=None, dtype=torch.float32):
    dev = runtime.entry_device(device)
    with process_group(dev):
        return _solve(dev, dtype)


def _solve(dev, dtype):
    A, y, x_true = problem()
    N, n = A.shape
    lead = dist.get_rank() == 0

    x_ls = np.linalg.lstsq(A, y, rcond=None)[0]
    err_ls = float(np.linalg.norm(x_ls - x_true))
    if lead:
        print(f"least squares   : |x - x_true| = {err_ls:.4f}")

    F = HuberRows(torch.tensor(A, dtype=dtype, device=dev),
                  torch.tensor(y, dtype=dtype, device=dev), 0.5, float(N))
    L = float(N) * (A * A).sum(axis=1)
    z0 = torch.zeros(n, dtype=dtype, device=dev)

    x_h, iters = Katyusha(maxit=60, batch=64, block_sampling=True)(
        z0, F=F, L=L, N=N)
    err = float(np.linalg.norm(x_h.double().cpu().numpy() - x_true))
    if lead:
        print(f"huber+katyusha  : |x - x_true| = {err:.4f}  ({iters} outer "
              f"steps)")
        assert err < 0.1 * err_ls

    # data-parallel on the ranks of the process group
    mesh = make_mesh(device=dev)
    D = mesh.size
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPKatyusha(mesh=mesh, maxit=60, batch=8 * D)(z0, F=Fd, L=L)
    err_dp = float(np.linalg.norm(x_dp.double().cpu().numpy() - x_true))
    if lead:
        print(f"dp katyusha x{D} : |x - x_true| = {err_dp:.4f}")
        assert err_dp < 0.1 * err_ls
    return dict(err_ls=err_ls, err=err, iters=iters, err_dp=err_dp, D=D)


if __name__ == "__main__":
    main(device="cpu" if "cpu" in sys.argv[1:] else None)
