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
    #: True when prox_only acts coordinatewise (safe on a coordinate-
    #: sharded x); norm-coupled operators set it False.
    separable: bool = True

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


def as_param(v):
    """A prox parameter as a buffer value: a tensor as it is, a Python
    number in float64 (then computed with in x's dtype, as a weakly typed
    JAX scalar is), an array with its own dtype."""
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (int, float)):
        return torch.tensor(float(v), dtype=torch.float64)
    return torch.as_tensor(v)


def real_of(p, x):
    """A scalar parameter in x's real dtype, on x's device."""
    return p.to(device=x.device, dtype=x.dtype.to_real())


def like(p, x):
    """A data parameter (a point, a direction, labels) in x's dtype."""
    return p.to(device=x.device, dtype=x.dtype)


def times_gamma(gamma, p, x):
    """γ·p in x's real dtype. A Python stepsize meets a parameter kept in
    float64 as JAX's two weak scalars do: multiplied in double, rounded
    once."""
    if isinstance(gamma, (int, float)):
        return (gamma * p).to(device=x.device, dtype=x.dtype.to_real())
    return gamma * real_of(p, x)


def zero_real(x):
    """0 in x's real dtype (an indicator's value inside its set)."""
    return torch.zeros((), dtype=x.dtype.to_real(), device=x.device)


def ind_value(feasible, x):
    """An indicator's value: 0 where ``feasible``, else +inf, in x's real
    dtype."""
    rdt = x.dtype.to_real()
    return torch.where(feasible, torch.zeros((), dtype=rdt, device=x.device),
                       torch.full((), float("inf"), dtype=rdt,
                                  device=x.device))
