"""The data-parallel and tensor-parallel meshes and solver paths on
``torch.distributed``.

Counterpart of ``ciao_tpu/parallel/``: the meshes and their placement
rules (:mod:`mesh`: ``make_mesh`` and the (data, model) ``make_mesh_2d``),
the DP solver families with all-reduce aggregation (:mod:`dp`: the
reference's own families and those beyond it, Katyusha, SARAH, L-SVRG,
L-Katyusha, Point-SAGA, SSNM, Davis-Yin, Condat-Vũ, PANOC/ZeroFPR), the
TP families with samples and coordinates both cut (:mod:`tp`: the
reference's SAGA/SAG, Finito, LFinito, SVRG/SVRG++, ProShI, ISTA/FISTA,
and those beyond it, Katyusha, SARAH, L-SVRG, L-Katyusha, Point-SAGA,
SSNM, Davis-Yin/Douglas-Rachford, Condat-Vũ/Chambolle-Pock on a stencil
K, PANOC/ZeroFPR), ``deep_solve_dp``, ``deep_solve_pd_dp``,
``deep_solve_tp`` and ``deep_solve_pd_tp`` (:mod:`deep`): every public
name of JAX's ``ciao_tpu.parallel``. One process a rank: start the ranks
(``torchrun``, ``torch.multiprocessing.spawn``), initialize the process
group in each (NCCL for one process a GPU, gloo on the CPU or for several
processes on one GPU), then ``make_mesh()`` and ``shard_finite_sum``, or
``make_mesh_2d(D, M)`` and ``shard_finite_sum_2d``; ``mesh.process_group``
starts a script's group (one rank of its own, or from the ``torchrun``
environment). Where each field of a DP or TP state lives is stated once
per state class in :mod:`placement`, which the sharded checkpoint
(``checkpoint.save_async(..., mesh=)``, ``checkpoint.load_orbax``)
reads.
"""

from ciao_tpu_torch.parallel.deep import (
    deep_solve_dp, deep_solve_pd_dp, deep_solve_pd_tp, deep_solve_tp,
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
    TPChambollePock,
    TPCondatVu,
    TPDavisYin,
    TPDouglasRachford,
    TPFinito,
    TPFISTA,
    TPForwardBackward,
    TPKatyusha,
    TPLFinito,
    TPLKatyusha,
    TPLSVRG,
    TPPANOC,
    TPPointSAGA,
    TPProshi,
    TPSAGA,
    TPSARAH,
    TPSSNM,
    TPSVRG,
    TPZeroFPR,
    build_tp_functions,
    data_model_specs,
    model_prox_specs,
    shard_finite_sum_2d,
)

__all__ = [
    "deep_solve_dp",
    "deep_solve_pd_dp",
    "deep_solve_pd_tp",
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
    "TPChambollePock",
    "TPCondatVu",
    "TPDavisYin",
    "TPDouglasRachford",
    "TPFinito",
    "TPFISTA",
    "TPForwardBackward",
    "TPKatyusha",
    "TPLFinito",
    "TPLKatyusha",
    "TPLSVRG",
    "TPPANOC",
    "TPPointSAGA",
    "TPProshi",
    "TPSAGA",
    "TPSARAH",
    "TPSSNM",
    "TPSVRG",
    "TPZeroFPR",
    "build_tp_functions",
    "data_model_specs",
    "model_prox_specs",
    "shard_finite_sum_2d",
]
