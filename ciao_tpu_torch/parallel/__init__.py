"""The data-parallel mesh and solver paths on ``torch.distributed``.

Counterpart of ``ciao_tpu/parallel/``'s data-parallel half: the mesh
and its placement rule (:mod:`mesh`), the DP solver families with
all-reduce aggregation (:mod:`dp`: the reference's own families and
those beyond it, Katyusha, SARAH, L-SVRG, L-Katyusha, Point-SAGA, SSNM,
Davis-Yin, Condat-Vũ, PANOC/ZeroFPR), ``deep_solve_dp`` and
``deep_solve_pd_dp`` (:mod:`deep`). One process a rank: start the ranks (``torchrun``,
``torch.multiprocessing.spawn``), initialize the process group in each
(NCCL for one process a GPU, gloo on the CPU or for several processes
on one GPU), then ``make_mesh()`` and ``shard_finite_sum``. The rest of
JAX's ``ciao_tpu.parallel`` (TP, ``make_mesh_2d``, the sharded
checkpoint) is queued in ROADMAP.md.
"""

from ciao_tpu_torch.parallel.deep import deep_solve_dp, deep_solve_pd_dp
from ciao_tpu_torch.parallel.dp import (
    DPCfg,
    DPChambollePock,
    DPCondatVu,
    DPDavisYin,
    DPDouglasRachford,
    DPFinito,
    DPFISTA,
    DPForwardBackward,
    DPKatyusha,
    DPLKatyusha,
    DPLSVRG,
    DPPANOC,
    DPPointSAGA,
    DPProshi,
    DPSAG,
    DPSAGA,
    DPSARAH,
    DPSSNM,
    DPSVRG,
    DPZeroFPR,
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
    "deep_solve_pd_dp",
    "DATA_AXIS",
    "MODEL_AXIS",
    "data_specs",
    "make_mesh",
    "put_specs",
    "replicated_specs",
    "shard_finite_sum",
    "DPCfg",
    "DPChambollePock",
    "DPCondatVu",
    "DPDavisYin",
    "DPDouglasRachford",
    "DPFinito",
    "DPForwardBackward",
    "DPFISTA",
    "DPKatyusha",
    "DPLKatyusha",
    "DPLSVRG",
    "DPPANOC",
    "DPPointSAGA",
    "DPProshi",
    "DPSAG",
    "DPSAGA",
    "DPSARAH",
    "DPSSNM",
    "DPSVRG",
    "DPZeroFPR",
    "build_dp_functions",
    "local_block_start",
    "local_indices",
]
