"""Sparse Poisson regression (count-data GLM) with the Poisson oracle.

The port of ``examples/poisson_glm.py``. Beyond the reference's surface
entirely: ProximalOperators.jl has no Poisson likelihood, so the
reference cannot express count regression. Here it rides the same
machinery as every other rank-1 oracle: on the card the clamped exp link
is kernel #10's in-kernel formula (MODE_POISSON), with the anchor pass on
#6. The script plants a sparse log-linear model, draws Poisson counts,
then shows

  * L1-regularized Poisson GLM (Katyusha) recovers the planted support
    with the bulk of nuisance coordinates at exactly zero;
  * the smoothness moduli come from the oracle's trust region
    (``local_smoothness(m_max)``: the Poisson Hessian is exp(m), so there
    is no global L);
  * the same fit data-parallel (DP Katyusha) on the ranks of the process
    group: one rank of its own when none is running, or every rank
    ``torchrun`` starts.

    python examples_torch/poisson_glm.py        # on the card
    python examples_torch/poisson_glm.py cpu    # one CPU rank
    torchrun --nproc-per-node 2 examples_torch/poisson_glm.py cpu

The draws are the JAX example's (numpy, seed 0), so both packages get one
problem; the rows are f32, as JAX's script runs them.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from ciao_tpu_torch import Katyusha, PoissonRows, runtime
from ciao_tpu_torch.parallel import DPKatyusha, make_mesh, shard_finite_sum
from ciao_tpu_torch.parallel.mesh import process_group
from ciao_tpu_torch.prox import NormL1


def problem(seed=0):
    """(A, y, x_true): Poisson counts of a sparse log-linear model."""
    rng = np.random.default_rng(seed)
    N, n = 4096, 64
    A = rng.standard_normal((N, n)) * (1.2 / np.sqrt(n))
    x_true = np.zeros(n)
    x_true[:6] = [2.0, -1.6, 1.2, -1.0, 0.8, -0.7]
    y = rng.poisson(np.exp(A @ x_true)).astype(np.float64)
    return A, y, x_true


def main(device=None, dtype=torch.float32):
    dev = runtime.entry_device(device)
    with process_group(dev):
        return _solve(dev, dtype)


def _solve(dev, dtype):
    A, y, x_true = problem()
    N, n = A.shape
    lead = dist.get_rank() == 0
    if lead:
        print(f"counts: mean {y.mean():.2f}, max {y.max():.0f}")

    F = PoissonRows(torch.tensor(A, dtype=dtype, device=dev),
                    torch.tensor(y, dtype=dtype, device=dev))
    # margins stay within a few units on the solve path; e^2.5·‖a_i‖²
    # is an honest local modulus there
    L = F.local_smoothness(2.5).double().cpu().numpy()
    x0 = torch.zeros(n, dtype=dtype, device=dev)

    # λ_max = ‖∇f(0)‖_∞ zeroes the solution; λ_max/10 keeps the planted
    # support and thresholds the noise
    lam_max = float(torch.max(torch.abs(F.grad_sum_all(x0)))) / N
    g = NormL1(0.1 * lam_max)

    x_hat, iters = Katyusha(maxit=120, batch=64, block_sampling=True)(
        x0, F=F, g=g, L=L, N=N)
    xv = x_hat.double().cpu().numpy()
    sup = np.abs(xv) > 1e-8
    corr = float(np.corrcoef(xv[:6], x_true[:6])[0, 1])
    if lead:
        print(f"katyusha        : {int(sup.sum())} nonzeros ({iters} outer "
              f"steps), support hit {int(sup[:6].sum())}/6, corr "
              f"{corr:.3f}")
        assert sup[:6].all(), "planted support missed"
        assert sup.sum() <= n // 2, "no sparsity"
        assert corr > 0.95

    # data-parallel on the ranks of the process group
    mesh = make_mesh(device=dev)
    D = mesh.size
    Fd = shard_finite_sum(F, mesh)
    x_dp, _ = DPKatyusha(mesh=mesh, maxit=120, batch=8 * D)(
        x0, F=Fd, g=g, L=L)
    err_dp = float(np.linalg.norm(x_dp.double().cpu().numpy() - xv))
    if lead:
        print(f"dp katyusha x{D} : |x - x_single| = {err_dp:.5f}")
        assert err_dp < 5e-2
    return dict(nonzeros=int(sup.sum()), support=int(sup[:6].sum()),
                corr=corr, iters=iters, err_dp=err_dp, D=D)


if __name__ == "__main__":
    main(device="cpu" if "cpu" in sys.argv[1:] else None)
