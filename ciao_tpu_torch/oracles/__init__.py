"""Smooth-term oracles of the port (``LeastSquaresRows`` so far)."""

from ciao_tpu_torch.oracles.base import (
    SmoothOracle, parse_storage_dtype, quantize_rows,
)
from ciao_tpu_torch.oracles.least_squares import LeastSquaresRows

__all__ = ["SmoothOracle", "LeastSquaresRows", "parse_storage_dtype",
           "quantize_rows"]
