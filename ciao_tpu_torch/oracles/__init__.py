"""Smooth-term oracles of the port: the dense row oracles
``LeastSquaresRows``, ``LogisticRows``, ``HuberRows``,
``SquaredHingeRows`` and ``PoissonRows``, the sparse rows
``SparseLeastSquaresELL``, ``HybridSparseLeastSquares``,
``SparseLogisticELL`` and ``HybridSparseLogistic``, the sharing terms
``DiagQuadratic``, ``DenseQuadratic`` and ``SqrDistBox``, and the
combinators ``SumOracle`` and ``ZeroOracle``."""

from ciao_tpu_torch.oracles.base import (
    SmoothOracle, parse_storage_dtype, quantize_rows,
)
from ciao_tpu_torch.oracles.compose import SumOracle, ZeroOracle
from ciao_tpu_torch.oracles.huber import HuberRows
from ciao_tpu_torch.oracles.least_squares import LeastSquaresRows
from ciao_tpu_torch.oracles.logistic import LogisticRows
from ciao_tpu_torch.oracles.poisson import PoissonRows
from ciao_tpu_torch.oracles.quadratic import (
    DenseQuadratic, DiagQuadratic, SqrDistBox,
)
from ciao_tpu_torch.oracles.sparse import (
    HybridSparseLeastSquares, HybridSparseLogistic, SparseLeastSquaresELL,
    SparseLogisticELL,
)
from ciao_tpu_torch.oracles.sqhinge import SquaredHingeRows

__all__ = ["SmoothOracle", "LeastSquaresRows", "LogisticRows", "HuberRows",
           "SquaredHingeRows", "PoissonRows", "DiagQuadratic",
           "DenseQuadratic", "SqrDistBox", "SumOracle", "ZeroOracle",
           "SparseLeastSquaresELL", "HybridSparseLeastSquares",
           "SparseLogisticELL", "HybridSparseLogistic",
           "parse_storage_dtype", "quantize_rows"]
