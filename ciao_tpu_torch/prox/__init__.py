"""Prox operators of the port (``Zero`` and ``NormL1`` so far)."""

from ciao_tpu_torch.prox.base import ProxOperator
from ciao_tpu_torch.prox.separable import NormL1, Zero

__all__ = ["ProxOperator", "NormL1", "Zero"]
