"""Nonconvex sparse regression: the MCP penalty and the SARAH solver.

The port of ``examples/nonconvex_sparse_mcp.py``. Both are beyond the
reference's tested surface but inside its advertised problem class ("g
possibly nonconvex", reference README.md:6-12). The script plants a
sparse signal, then shows

  * L1 (lasso) recovers the support but shrinks every surviving
    coefficient by the threshold, the classic lasso bias;
  * MCP + SARAH recovers the same support unbiased (large coefficients
    pass through the firm threshold untouched), landing on the oracle
    least-squares refit;
  * SARAH is the right solver here: its recursive estimator carries the
    SPIDER-class nonconvex convergence guarantee. On the card the L1 run
    takes kernel #11 (and #6 for the bootstrap); MCP's firm threshold is
    no in-kernel prox, so the MCP runs take the stepwise path;
  * the same MCP fit data-parallel (DP SARAH) on the ranks of the process
    group: one rank of its own when none is running, or every rank
    ``torchrun`` starts.

    python examples_torch/nonconvex_sparse_mcp.py        # on the card
    python examples_torch/nonconvex_sparse_mcp.py cpu    # one CPU rank

The draws are the JAX example's (numpy, seed 0), so both packages get one
problem; the rows are f32, as JAX's script runs them.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from ciao_tpu_torch import MCP, SARAH, LeastSquaresRows, NormL1, runtime
from ciao_tpu_torch.parallel import DPSARAH, make_mesh, shard_finite_sum
from ciao_tpu_torch.parallel.mesh import process_group


def problem(seed=0):
    """(A, b, x_true, supp): a planted sparse signal."""
    rng = np.random.default_rng(seed)
    N, n, p = 4096, 128, 8
    A = rng.standard_normal((N, n)) / np.sqrt(N)
    x_true = np.zeros(n)
    supp = rng.choice(n, size=p, replace=False)
    # signal bounded away from the MCP clip radius beta*lam = 2
    x_true[supp] = (3.0 + 3.0 * rng.random(p)) * rng.choice([-1.0, 1.0], p)
    b = A @ x_true + 0.02 * rng.standard_normal(N)
    return A, b, x_true, supp


def main(device=None, dtype=torch.float32):
    dev = runtime.entry_device(device)
    with process_group(dev):
        return _solve(dev, dtype)


def _solve(dev, dtype):
    A, b, x_true, supp = problem()
    N, n = A.shape
    lead = dist.get_rank() == 0
    F = LeastSquaresRows(torch.tensor(A, dtype=dtype, device=dev),
                         torch.tensor(b, dtype=dtype, device=dev), float(N))
    L = float(N) * (A * A).sum(axis=1)
    lam = 0.1   # > noise level ||A^T eps||_inf ~ 0.06
    z0 = torch.zeros(n, dtype=dtype, device=dev)

    x_ls_refit = np.zeros(n)
    x_ls_refit[supp] = np.linalg.lstsq(A[:, supp], b, rcond=None)[0]

    x_l1, _ = SARAH(maxit=60, batch=64, block_sampling=True, m=N // 64)(
        z0, F=F, g=NormL1(lam), L=L, N=N)
    x_l1 = x_l1.double().cpu().numpy()
    err_l1 = float(np.linalg.norm(x_l1 - x_ls_refit))
    if lead:
        print(f"L1 (lasso)  : support={int((np.abs(x_l1) > 1e-8).sum())}, "
              f"|x - refit| = {err_l1:.4f}  (shrinkage bias)")

    g_mcp = MCP(lam, 20.0)
    x_mcp, iters = SARAH(maxit=60, batch=64, block_sampling=True,
                         m=N // 64)(z0, F=F, g=g_mcp, L=L, N=N)
    x_mcp = x_mcp.double().cpu().numpy()
    err_mcp = float(np.linalg.norm(x_mcp - x_ls_refit))
    if lead:
        print(f"MCP + SARAH : support={int((np.abs(x_mcp) > 1e-8).sum())}, "
              f"|x - refit| = {err_mcp:.6f}  ({iters} outer steps, "
              f"unbiased)")
        assert set(np.flatnonzero(np.abs(x_mcp) > 1e-8)) == set(supp)
        assert err_mcp < 0.05 * err_l1

    # data-parallel on the ranks of the process group
    mesh = make_mesh(device=dev)
    D = mesh.size
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPSARAH(mesh=mesh, maxit=60, batch=8 * D, m=N // (8 * D))(
        z0, F=Fd, g=g_mcp, L=L)
    err_dp = float(np.linalg.norm(x_dp.double().cpu().numpy() - x_ls_refit))
    if lead:
        print(f"dp sarah x{D} : |x - refit| = {err_dp:.6f}")
        assert err_dp < 0.05 * err_l1
    return dict(err_l1=err_l1, err_mcp=err_mcp, iters=iters, err_dp=err_dp,
                D=D)


if __name__ == "__main__":
    main(device="cpu" if "cpu" in sys.argv[1:] else None)
