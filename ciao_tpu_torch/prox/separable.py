"""Separable prox operators: ``Zero`` and ``NormL1``.

Counterpart of ``ciao_tpu/prox/separable.py:26-57``; the other operators
of that module are not ported yet (ROADMAP.md, queue 1 item 14).
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.prox.base import ProxOperator, _softsign


class Zero(ProxOperator):
    """g == 0; prox is the identity (reference default g, Finito.jl:69)."""

    def value(self, x):
        return torch.zeros((), dtype=x.dtype.to_real(), device=x.device)

    def prox_only(self, x, gamma):
        return x

    def prox(self, x, gamma):
        return x, self.value(x)


class NormL1(ProxOperator):
    """g(x) = lam * ||x||_1; prox = soft-thresholding.

    Complex support: |x_i| magnitudes with phase preserved. ``lam`` is a
    buffer; a Python number is kept in float64 and, like a weakly typed
    JAX scalar, computed with in the real dtype of ``x``.
    """

    def __init__(self, lam=1.0):
        super().__init__()
        if not isinstance(lam, torch.Tensor):
            lam = torch.tensor(float(lam), dtype=torch.float64)
        self.register_buffer("lam", lam)

    def _lam(self, x):
        return self.lam.to(x.dtype.to_real())

    def value(self, x):
        return self._lam(x) * torch.sum(torch.abs(x))

    def prox_only(self, x, gamma):
        # a Python stepsize meets lam as JAX's two weak scalars would:
        # multiplied in double, then rounded once to x's dtype
        lam = self.lam if isinstance(gamma, (int, float)) else self._lam(x)
        thr = gamma * lam
        mag = torch.abs(x)
        return _softsign(x) * torch.clamp(mag - thr, min=0)
