"""Proximable-term protocol.

Counterpart of ``ciao_tpu/prox/base.py``. A prox operator is a small
``nn.Module`` whose parameters are buffers, so ``.to(device)`` moves
them, with:

  * ``value(x)``            — g(x) (also ``g(x)``, the module's forward)
  * ``prox(x, gamma)``      — argmin_z g(z) + 1/(2 gamma) |z - x|^2,
                              returning ``(z, g(z))``
  * ``prox_only(x, gamma)`` — just z (the hot-loop entry)
"""

from __future__ import annotations

import abc

import torch
from torch import nn


class ProxOperator(nn.Module, metaclass=abc.ABCMeta):
    @abc.abstractmethod
    def value(self, x: torch.Tensor) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def prox_only(self, x: torch.Tensor, gamma) -> torch.Tensor:
        ...

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, self.value(z)

    def forward(self, x):
        return self.value(x)


def _softsign(x):
    """sign(x) that handles complex inputs as x/|x| (0 -> 0)."""
    return torch.sgn(x)
