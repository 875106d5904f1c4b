"""The data-parallel and tensor-parallel meshes and solver paths on
``torch.distributed``.

Counterpart of ``ciao_tpu/parallel/``: the meshes and their placement
rules (:mod:`mesh`: ``make_mesh`` and the (data, model) ``make_mesh_2d``),
the DP solver families with all-reduce aggregation (:mod:`dp`: the
reference's own families and those beyond it, Katyusha, SARAH, L-SVRG,
L-Katyusha, Point-SAGA, SSNM, Davis-Yin, Condat-Vũ, PANOC/ZeroFPR), the
reference's TP families with samples and coordinates both cut (:mod:`tp`:
SAGA/SAG, Finito, LFinito, SVRG/SVRG++, ProShI, ISTA/FISTA),
``deep_solve_dp``, ``deep_solve_pd_dp`` and ``deep_solve_tp``
(:mod:`deep`). One process a rank: start the ranks (``torchrun``,
``torch.multiprocessing.spawn``), initialize the process group in each
(NCCL for one process a GPU, gloo on the CPU or for several processes
on one GPU), then ``make_mesh()`` and ``shard_finite_sum``, or
``make_mesh_2d(D, M)`` and ``shard_finite_sum_2d``. The rest of JAX's
``ciao_tpu.parallel`` (the TP families beyond the reference,
``deep_solve_pd_tp``, the sharded checkpoint) is queued in ROADMAP.md.
"""

from ciao_tpu_torch.parallel.deep import (
    deep_solve_dp, deep_solve_pd_dp, deep_solve_tp,
)
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
    Mesh2D,
    data_specs,
    make_mesh,
    make_mesh_2d,
    put_specs,
    replicated_specs,
    shard_finite_sum,
)
from ciao_tpu_torch.parallel.tp import (
    TPCfg,
    TPFinito,
    TPFISTA,
    TPForwardBackward,
    TPLFinito,
    TPProshi,
    TPSAGA,
    TPSVRG,
    build_tp_functions,
    data_model_specs,
    model_prox_specs,
    shard_finite_sum_2d,
)

__all__ = [
    "deep_solve_dp",
    "deep_solve_pd_dp",
    "deep_solve_tp",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh2D",
    "data_specs",
    "make_mesh",
    "make_mesh_2d",
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
    "TPCfg",
    "TPFinito",
    "TPFISTA",
    "TPForwardBackward",
    "TPLFinito",
    "TPProshi",
    "TPSAGA",
    "TPSVRG",
    "build_tp_functions",
    "data_model_specs",
    "model_prox_specs",
    "shard_finite_sum_2d",
]
