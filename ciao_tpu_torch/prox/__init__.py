"""Prox operators of the port (``Zero``, ``NormL1`` and ``IndBox`` so
far)."""

from ciao_tpu_torch.prox.base import ProxOperator
from ciao_tpu_torch.prox.separable import IndBox, NormL1, Zero

__all__ = ["ProxOperator", "IndBox", "NormL1", "Zero"]
