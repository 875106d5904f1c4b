"""Multi-process data-parallel solve (template).

The port of ``examples/multihost.py``. The reference is single-process
(SURVEY.md §2.3); this is the recipe for several processes, one a rank:
each process owns its rows, and the DP solvers keep all traffic between
them to one x-sized all-reduce a step (or one a round of local steps).

With ``CIAO_MULTIHOST`` set, each copy of the script joins the process
group that the environment describes (``init_method="env://"``: ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``, as
``torchrun`` sets them), where JAX's calls ``jax.distributed.initialize``:

    CIAO_MULTIHOST=1 torchrun --nproc-per-node 2 examples_torch/multihost.py

NCCL carries the all-reduces where each rank has a card of its own, gloo
where a host runs more ranks than it has cards (or with ``cpu``). Without
it, the script runs on one rank of its own, or on the ranks ``torchrun``
starts. ``tests/test_torch_multihost.py`` runs the multi-process path on
the CPU: two processes started from the environment, held to the same
runs through ``torch.multiprocessing``.
"""

import os
import sys

import torch
import torch.distributed as dist

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.parallel import DPSAGA, make_mesh, shard_finite_sum
from ciao_tpu_torch.parallel.mesh import process_group
from ciao_tpu_torch.prox import NormL1
from ciao_tpu_torch.utils.problems import make_lasso


def main(device=None):
    """The two solves at JAX's sizes; rank 0 prints and asserts."""
    dev = runtime.entry_device(device)
    if os.environ.get("CIAO_MULTIHOST") and "RANK" not in os.environ:
        raise RuntimeError(
            "multihost: CIAO_MULTIHOST is set but RANK is not: start one "
            "process a rank with the environment torchrun sets (RANK, "
            "WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK)")
    with process_group(dev):
        return _solve(dev)


def _solve(dev):
    mesh = make_mesh(device=dev)          # every rank on "data"
    D = mesh.size
    N, n = 128 * D, 64
    prob = make_lasso(N=N, n=n, p=8, seed=0)
    F = shard_finite_sum(
        LeastSquaresRows(
            torch.tensor(prob.A, dtype=torch.float32, device=dev),
            torch.tensor(prob.b, dtype=torch.float32, device=dev), float(N)),
        mesh)
    g = NormL1(float(prob.lam))
    x0 = torch.zeros(n, device=dev)
    lead = dist.get_rank() == 0

    solver = DPSAGA(mesh=mesh, batch=D * 8, block_sampling=True,
                    maxit=30000)
    x, iters = solver(x0, F=F, g=g, L=prob.L)
    gap = float(prob.cost(x.double().cpu().numpy()) - prob.f_star)
    if lead:
        print(f"ranks={D} processes={dist.get_world_size()} iters={iters} "
              f"suboptimality={gap:.3e}")
        assert gap < 1e-4

    # Across hosts: amortize the collective with local-update rounds, K
    # local steps a round (one kernel #3 launch on the card) and ONE
    # all-reduce a round. Every family has such knobs
    # (DPFinito(local_steps=K), DPFinito(LFinito=True, local_sweep=True),
    # DPSVRG(local_inner=True), DPProshi, DPKatyusha/DPSARAH(local_inner=
    # True)).
    solver = DPSAGA(mesh=mesh, batch=D * 8, block_sampling=True,
                    local_steps=64, rebase_every=50, maxit=500)
    x, steps = solver(x0, F=F, g=g, L=prob.L)
    gap_local = float(prob.cost(x.double().cpu().numpy()) - prob.f_star)
    if lead:
        print(f"local-update mode: {steps} steps in 500 rounds "
              f"(1 collective per 64 steps) suboptimality={gap_local:.3e}")
        assert gap_local < 1e-4
    return dict(D=D, iters=iters, gap=gap, steps=steps, gap_local=gap_local)


if __name__ == "__main__":
    main(device="cpu" if "cpu" in sys.argv[1:] else None)
