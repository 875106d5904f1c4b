"""ciao_tpu_torch — the PyTorch/CUDA port of ciao_tpu.

Finite-sum composite optimization, minimize (1/N) Σ f_i(x) + g(x), on an
NVIDIA GPU. The JAX package ``ciao_tpu`` stays the reference: this
package mirrors its module paths and names. Oracles and proxes are small
``nn.Module``s holding their data as buffers, solver steps are plain
functions on tensors, entry points take an explicit device, and every
Pallas TPU kernel on a ported path is a hand-written Hopper kernel with
a plain PyTorch version beside it (``ciao_tpu_torch.ops``).

Ported so far: the SAGA headline path — ``LeastSquaresRows`` (f32, bf16
and int8 rows), ``NormL1``/``Zero``, and block-sampled coefficient-table
SAGA/SAG, uniform or importance-sampled, through the
``saga_coeff_multistep`` (N ≤ 1M) and ``saga_coeff_multistep_streamed``
(any N) CUDA kernels; the deep-accuracy path: ``staged_saga``, the
compensated ``fista_polish`` with ``power_lmax``, and ``deep_solve``;
SVRG/SVRG++ (inner steps on ``svrg_coeff_multistep``) and
forward-backward/FISTA, whose full-gradient reads run on the one-pass
``coeff_apply_all`` kernel; the Finito/MISO family: the full table on
``finito_block_update``, the coefficient table on
``finito_coeff_multistep`` and ``finito_coeff_multistep_streamed``,
LFinito on ``coeff_apply_all`` and ``lfinito_sweep_multistep``, and
adaptive Finito; SAGA's full (N, n) table on ``saga_block_update``; the
sharing family: ``Proshi`` on ``proshi_multistep`` (dense row oracles;
the sharing terms ``DiagQuadratic``, ``SqrDistBox``, ``SumOracle`` run
stepwise) with the coupling proxes ``IndBox``/``NormL1``/``Zero``, and
``deep_solve_sharing``; the families beyond the reference whose inner
step is SVRG's: ``Katyusha`` (``katyusha_coeff_multistep``), ``SARAH``
(``sarah_multistep``), ``LSVRG`` and ``LKatyusha``
(``lsvrg_coeff_multistep``, ``lkatyusha_coeff_multistep``), each with
its anchor on ``coeff_apply_all``; ``SSNM`` (``ssnm_multistep``,
``ssnm_multistep_streamed``) and ``PointSAGA`` (``point_saga_multistep``,
``point_saga_multistep_streamed``), with the row oracles
``LogisticRows``, ``HuberRows``, ``SquaredHingeRows`` and ``PoissonRows``
beside ``LeastSquaresRows``; ``PANOC`` and ``ZeroFPR``, whose envelope
reads run on ``coeff_value_apply_all``, and the splitting methods
``DavisYin``/``DouglasRachford`` and ``CondatVu``/``ChambollePock`` with
the linear maps of ``ops.linmap`` (full gradients on
``coeff_apply_all``); the whole prox library of ``ciao_tpu.prox``; the
sparse rows ``SparseLeastSquaresELL``, ``HybridSparseLeastSquares``,
``SparseLogisticELL`` and ``HybridSparseLogistic`` with
``make_sparse_lasso_ell`` and ``deep_solve``'s block-protocol polish
(gathers and scatter-adds in PyTorch: no kernel serves them, as none
does in the JAX package); the primal-dual deep route ``deep_solve_pd``
with ``tv_refine`` and ``tv_refine3`` (compensated Condat-Vũ and the
certified reduced solves, PyTorch products with no kernel, as in the
JAX package); complex rows and iterates (complex64, complex128) through
``LeastSquaresRows`` and every facade whose JAX counterpart runs them,
on the stepwise PyTorch paths (no kernel takes them, as none does in
the JAX package); ``Precompose`` and ``CustomOracle`` (autodiff through
``torch.func``); checkpoints (``ciao_tpu_torch.checkpoint``: ``save``,
``load``, ``save_async``, ``load_like``, ``resume_iterator``, and for
the DP and TP states the sharded ``save_async(..., mesh=)`` with the
elastic restore ``load_orbax``); ``monitor.profiler_trace``; the
single-card entry point ``ciao_tpu_torch.entry`` and the ten examples of
``examples_torch/``. Left out: the pytree, TPU and threefry helpers
(``register_oracle``, ``static_field``, ``register_prox``,
``runtime.on_tpu``, ``sampling.uniform_index``). Imports torch and
numpy, never jax. Entry points run on the card unless the
caller names the CPU (a CPU tensor or ``device="cpu"``).
"""

from ciao_tpu_torch import oracles, prox
from ciao_tpu_torch.oracles import (
    CustomOracle, DenseQuadratic, DiagQuadratic, HuberRows,
    HybridSparseLeastSquares, LeastSquaresRows, LogisticRows, PoissonRows,
    Precompose, SparseLeastSquaresELL, SqrDistBox, SquaredHingeRows,
    SumOracle, ZeroOracle,
)
from ciao_tpu_torch.ops.linmap import (
    DenseMap, FirstDifference, FirstDifference2D, GradientMap2D, IdentityMap,
)
from ciao_tpu_torch.prox import (
    MCP, SCAD, ElasticNet, GroupNormL21, HingeLoss, IndAffine, IndBallL1,
    IndBallL2, IndBallLinf, IndBox, IndHalfspace, IndNonnegative,
    IndNonpositive, IndPoint, IndSimplex, IndSphereL2, LogBarrier, NormL0,
    NormL1, NormL2, NormL21, NormLinf, NormNuclear, SqrNormL2, Zero,
)
from ciao_tpu_torch.solvers import (
    FISTA, LSVRG, PANOC, SAG, SAGA, SARAH, SSNM, SVRG, ChambollePock,
    CondatVu, DavisYin, DeepPDInfo, DeepSharingInfo, DeepSolveInfo,
    DouglasRachford, Finito, ForwardBackward, Katyusha, LKatyusha, PointSAGA,
    Proshi, StagedInfo, ZeroFPR,
    deep_solve, deep_solve_pd, deep_solve_sharing,
    fista_polish, grad_mean_chunked, halt, iterator, loop, lsq_power_lmax,
    power_lmax, proshi_resync, sharing_objective, solution, staged_saga,
    take, tv_refine, tv_refine3,
)
from ciao_tpu_torch.solvers.base import Status

__version__ = "0.1.0"

__all__ = [
    "oracles",
    "prox",
    "LeastSquaresRows",
    "LogisticRows",
    "HuberRows",
    "SquaredHingeRows",
    "PoissonRows",
    "DiagQuadratic",
    "DenseQuadratic",
    "SqrDistBox",
    "SumOracle",
    "ZeroOracle",
    "Precompose",
    "CustomOracle",
    "SparseLeastSquaresELL",
    "HybridSparseLeastSquares",
    "NormL1",
    "Zero",
    "IndBox",
    "GroupNormL21",
    "NormL2",
    "SqrNormL2",
    "ElasticNet",
    "IndBallL2",
    "IndSimplex",
    "NormNuclear",
    "NormL0",
    "NormL21",
    "NormLinf",
    "IndBallL1",
    "IndBallLinf",
    "IndNonnegative",
    "IndNonpositive",
    "IndHalfspace",
    "IndPoint",
    "IndAffine",
    "IndSphereL2",
    "LogBarrier",
    "HingeLoss",
    "MCP",
    "SCAD",
    "IdentityMap",
    "DenseMap",
    "FirstDifference",
    "FirstDifference2D",
    "GradientMap2D",
    "SAGA",
    "SAG",
    "SVRG",
    "Finito",
    "Proshi",
    "Katyusha",
    "SARAH",
    "LSVRG",
    "LKatyusha",
    "SSNM",
    "PointSAGA",
    "ForwardBackward",
    "FISTA",
    "PANOC",
    "ZeroFPR",
    "DavisYin",
    "DouglasRachford",
    "CondatVu",
    "ChambollePock",
    "deep_solve",
    "DeepSolveInfo",
    "deep_solve_sharing",
    "DeepSharingInfo",
    "deep_solve_pd",
    "DeepPDInfo",
    "tv_refine",
    "tv_refine3",
    "proshi_resync",
    "sharing_objective",
    "staged_saga",
    "StagedInfo",
    "fista_polish",
    "power_lmax",
    "lsq_power_lmax",
    "grad_mean_chunked",
    "Status",
    "solution",
    "take",
    "loop",
    "halt",
    "iterator",
]
