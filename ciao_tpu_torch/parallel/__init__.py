"""The data-parallel mesh and solver paths on ``torch.distributed``.

Counterpart of ``ciao_tpu/parallel/`` for the reference's own families:
the mesh and its placement rule (:mod:`mesh`), the DP solver families
with all-reduce aggregation (:mod:`dp`) and ``deep_solve_dp``
(:mod:`deep`). One process a rank: start the ranks (``torchrun``,
``torch.multiprocessing.spawn``), initialize the process group in each
(NCCL for one process a GPU, gloo on the CPU or for several processes
on one GPU), then ``make_mesh()`` and ``shard_finite_sum``. The rest of
JAX's ``ciao_tpu.parallel`` (the other families' DP variants,
``deep_solve_pd_dp``, TP, ``make_mesh_2d``) is queued in ROADMAP.md.
"""

from ciao_tpu_torch.parallel.deep import deep_solve_dp
from ciao_tpu_torch.parallel.dp import (
    DPCfg,
    DPFinito,
    DPFISTA,
    DPForwardBackward,
    DPProshi,
    DPSAG,
    DPSAGA,
    DPSVRG,
    build_dp_functions,
    local_block_start,
    local_indices,
)
from ciao_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    data_specs,
    make_mesh,
    put_specs,
    replicated_specs,
    shard_finite_sum,
)

__all__ = [
    "deep_solve_dp",
    "DATA_AXIS",
    "MODEL_AXIS",
    "data_specs",
    "make_mesh",
    "put_specs",
    "replicated_specs",
    "shard_finite_sum",
    "DPCfg",
    "DPFinito",
    "DPForwardBackward",
    "DPFISTA",
    "DPProshi",
    "DPSAG",
    "DPSAGA",
    "DPSVRG",
    "build_dp_functions",
    "local_block_start",
    "local_indices",
]
