"""Separable prox operators: ``Zero``, ``NormL1`` and ``IndBox``.

Counterpart of ``ciao_tpu/prox/separable.py:26-57,112-135``; the other
operators of that module are not ported yet (ROADMAP.md, queue 1 item
14).
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


def _bound(v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.float64)


class IndBox(ProxOperator):
    """Indicator of the box [lo, hi]; prox = clip. Infinite bounds are
    fine (the sharing test uses IndBox(-Inf, 1), test_sharing.jl:25).
    ``lo`` and ``hi`` are scalars or (n,) tensors, kept as buffers; a
    Python number is kept in float64 and compared in x's dtype."""

    def __init__(self, lo=-float("inf"), hi=float("inf")):
        super().__init__()
        self.register_buffer("lo", _bound(lo))
        self.register_buffer("hi", _bound(hi))

    def value(self, x):
        # 0 on the box, with a 100·eps relative slack: a point rebuilt
        # from a prox output (ProShI's block sum Σx_i = av + hat_γ·z ≡
        # prox_g(av)) is feasible only up to roundoff, and an exact check
        # would read ∞ at the ulp
        rdt = x.dtype.to_real()
        tol = 100 * torch.finfo(rdt).eps * (1 + torch.abs(x))
        lo, hi = self.lo.to(rdt), self.hi.to(rdt)
        inside = torch.all((x >= lo - tol) & (x <= hi + tol))
        return torch.where(inside, torch.zeros((), dtype=rdt, device=x.device),
                           torch.full((), float("inf"), dtype=rdt,
                                      device=x.device))

    def prox_only(self, x, gamma):
        return torch.clamp(x, self.lo.to(x.dtype), self.hi.to(x.dtype))

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, torch.zeros((), dtype=z.dtype.to_real(), device=z.device)
