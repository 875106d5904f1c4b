"""Smooth-term oracles of the port: ``LeastSquaresRows``, the sharing
terms ``DiagQuadratic``, ``DenseQuadratic`` and ``SqrDistBox``, and the
combinators ``SumOracle`` and ``ZeroOracle``."""

from ciao_tpu_torch.oracles.base import (
    SmoothOracle, parse_storage_dtype, quantize_rows,
)
from ciao_tpu_torch.oracles.compose import SumOracle, ZeroOracle
from ciao_tpu_torch.oracles.least_squares import LeastSquaresRows
from ciao_tpu_torch.oracles.quadratic import (
    DenseQuadratic, DiagQuadratic, SqrDistBox,
)

__all__ = ["SmoothOracle", "LeastSquaresRows", "DiagQuadratic",
           "DenseQuadratic", "SqrDistBox", "SumOracle", "ZeroOracle",
           "parse_storage_dtype", "quantize_rows"]
