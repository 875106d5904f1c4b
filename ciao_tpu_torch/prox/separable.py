"""The prox library's core: ``Zero``, ``NormL1``, ``NormL2``,
``SqrNormL2``, ``ElasticNet``, ``IndBox``, ``IndBallL2``, ``IndSimplex``,
``NormNuclear`` and ``GroupNormL21``.

Counterpart of ``ciao_tpu/prox/separable.py``, the same closed forms.
Parameters are buffers; a Python number is kept in float64 and computed
with in the real dtype of ``x``, as a weakly typed JAX scalar is.
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.prox.base import (
    ProxOperator, _softsign, as_param, ind_value, real_of, times_gamma,
    zero_real,
)


def _norm2(x):
    """‖x‖₂ in x's real dtype (|x_i|² summed, complex entries too)."""
    return torch.sqrt(torch.sum(torch.abs(x) ** 2))


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


class NormL2(ProxOperator):
    """g(x) = lam·‖x‖₂ (not squared); prox = block soft-threshold."""

    separable = False

    def __init__(self, lam=1.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))

    def value(self, x):
        return real_of(self.lam, x) * _norm2(x)

    def prox_only(self, x, gamma):
        nrm = _norm2(x)
        scale = torch.clamp(
            1 - times_gamma(gamma, self.lam, x) / torch.clamp(nrm, min=1e-38),
            min=0)
        return scale * x


class SqrNormL2(ProxOperator):
    """g(x) = (lam/2)·‖x‖²; prox = shrink by 1/(1 + γ·lam)."""

    def __init__(self, lam=1.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))

    def value(self, x):
        return 0.5 * real_of(self.lam, x) * torch.sum(torch.abs(x) ** 2)

    def prox_only(self, x, gamma):
        return x / (1 + times_gamma(gamma, self.lam, x))


class ElasticNet(ProxOperator):
    """g(x) = lam·‖x‖₁ + (mu/2)·‖x‖²."""

    def __init__(self, lam=1.0, mu=1.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))
        self.register_buffer("mu", as_param(mu))

    def value(self, x):
        a = torch.abs(x)
        return (real_of(self.lam, x) * torch.sum(a)
                + 0.5 * real_of(self.mu, x) * torch.sum(a ** 2))

    def prox_only(self, x, gamma):
        soft = torch.clamp(torch.abs(x) - times_gamma(gamma, self.lam, x),
                           min=0)
        return _softsign(x) * soft / (1 + times_gamma(gamma, self.mu, x))


class IndBallL2(ProxOperator):
    """Indicator of {x : ‖x‖₂ ≤ r}; prox = radial projection."""

    separable = False

    def __init__(self, r=1.0):
        super().__init__()
        self.register_buffer("r", as_param(r))

    def value(self, x):
        nrm = _norm2(x)
        eps = 100 * torch.finfo(nrm.dtype).eps
        return ind_value(nrm <= real_of(self.r, x) * (1 + eps), x)

    def prox_only(self, x, gamma):
        nrm = _norm2(x)
        r = real_of(self.r, x)
        scale = torch.where(nrm > r, r / torch.clamp(nrm, min=1e-38),
                            torch.ones_like(nrm))
        return scale * x

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, zero_real(z)


class IndSimplex(ProxOperator):
    """Indicator of the simplex {x ≥ 0, Σx = a}; prox = the sort-based
    projection (Held, Wolfe, Crowder)."""

    separable = False

    def __init__(self, a=1.0):
        super().__init__()
        self.register_buffer("a", as_param(a))

    def value(self, x):
        feas = torch.all(x >= -1e-9) & (
            torch.abs(torch.sum(x) - real_of(self.a, x)) < 1e-6)
        return ind_value(feas, x)

    def prox_only(self, x, gamma):
        n = x.shape[-1]
        u = torch.flip(torch.sort(x, dim=-1).values, dims=(-1,))
        css = torch.cumsum(u, dim=-1) - real_of(self.a, x)
        ks = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
        k = torch.sum(u - css / ks > 0, dim=-1)
        tau = css[..., k - 1] / k.to(x.dtype)
        return torch.clamp(x - tau, min=0)

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, zero_real(z)


class NormNuclear(ProxOperator):
    """g(X) = lam·‖X‖_* on matrices; prox = singular-value soft-threshold."""

    separable = False

    def __init__(self, lam=1.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))

    def value(self, x):
        s = torch.linalg.svdvals(x)
        return real_of(self.lam, x) * torch.sum(s)

    def prox_only(self, x, gamma):
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        s_thr = torch.clamp(s - times_gamma(gamma, self.lam, x), min=0)
        return (u * s_thr[..., None, :].to(u.dtype)) @ vt


class GroupNormL21(ProxOperator):
    """g(u) = lam·Σ_p ‖(u_p, u_{p+m}, …)‖₂ over ``groups`` stacked fields
    of equal length m = len(u)/groups, on a flat vector: isotropic total
    variation on ``GradientMap2D``'s (∇_h, ∇_v) output (groups = 2). Prox
    = per-group block soft-threshold; complex entries keep their phase."""

    separable = False

    def __init__(self, lam=1.0, groups: int = 2):
        super().__init__()
        self.register_buffer("lam", as_param(lam))
        self.groups = int(groups)

    def _norms(self, v):
        return torch.sqrt(torch.sum(torch.abs(v) ** 2, dim=0))

    def value(self, u):
        v = u.reshape(self.groups, -1)
        return real_of(self.lam, u) * torch.sum(self._norms(v))

    def prox_only(self, u, gamma):
        v = u.reshape(self.groups, -1)
        nrm = self._norms(v)
        scale = torch.clamp(
            1 - times_gamma(gamma, self.lam, u) / torch.clamp(nrm, min=1e-38),
            min=0)
        return (scale[None, :] * v).reshape(u.shape)
