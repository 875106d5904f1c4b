"""The extended prox library: the ProximalOperators.jl surface beyond the
reference's own tests — hard thresholding, group lasso, the L1 and
L-inf ball machinery, affine and halfspace projections, the log-barrier,
the hinge loss, and the nonconvex MCP and SCAD penalties.

Counterpart of ``ciao_tpu/prox/extended.py``, the same closed forms
(elementwise, sort-based, or one small solve); no kernel serves them:
they run once a step on an x-sized vector. Parameters are buffers; a
Python number is kept in float64 and computed with in the real dtype of
``x``, as a weakly typed JAX scalar is.
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.prox.base import (
    ProxOperator, _softsign, as_param, ind_value, like, real_of, times_gamma,
    zero_real,
)


class _Indicator(ProxOperator):
    """An indicator: its prox value is 0 (the prox lands in the set)."""

    def prox(self, x, gamma):
        z = self.prox_only(x, gamma)
        return z, zero_real(z)


class NormL0(ProxOperator):
    """g(x) = lam·‖x‖₀ (nonconvex); prox = hard threshold: keep x_i iff
    |x_i|² > 2γ·lam (ties to zero, as ProximalOperators.NormL0)."""

    def __init__(self, lam=1.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))

    def value(self, x):
        return (real_of(self.lam, x) * torch.sum(x != 0)).to(
            x.dtype.to_real())

    def prox_only(self, x, gamma):
        keep = torch.abs(x) ** 2 > 2 * times_gamma(gamma, self.lam, x)
        return torch.where(keep, x, torch.zeros_like(x))


class SqrDistPoint(ProxOperator):
    """g(x) = (rho/2)·‖x − b‖², a proximable quadratic around a point;
    prox = (x + γ·rho·b)/(1 + γ·rho)."""

    def __init__(self, b=0.0, rho=1.0):
        super().__init__()
        self.register_buffer("b", as_param(b))
        self.register_buffer("rho", as_param(rho))

    def value(self, x):
        return 0.5 * real_of(self.rho, x) * torch.sum(
            torch.abs(x - like(self.b, x)) ** 2)

    def prox_only(self, x, gamma):
        grho = times_gamma(gamma, self.rho, x)
        return (x + grho * like(self.b, x)) / (1 + grho)


class NormL21(ProxOperator):
    """Group lasso g(X) = lam·Σ_j ‖X_slice_j‖₂, each group a slice along
    ``axis`` (0: the column norms of a matrix); prox = per-group block
    soft-threshold."""

    separable = False

    def __init__(self, lam=1.0, axis: int = 0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))
        self.axis = int(axis)

    def _group_norms(self, x):
        return torch.sqrt(torch.sum(torch.abs(x) ** 2, dim=self.axis,
                                    keepdim=True))

    def value(self, x):
        return real_of(self.lam, x) * torch.sum(self._group_norms(x))

    def prox_only(self, x, gamma):
        nrm = self._group_norms(x)
        scale = torch.clamp(
            1 - times_gamma(gamma, self.lam, x) / torch.clamp(nrm, min=1e-38),
            min=0)
        return scale * x


def _project_l1_ball(x, r):
    """Euclidean projection onto {z : ‖z‖₁ ≤ r} (Duchi et al. 2008;
    sort-based, as the simplex projection)."""
    mag = torch.abs(x)
    inside = torch.sum(mag) <= r
    n = x.shape[-1]
    u = torch.flip(torch.sort(mag, dim=-1).values, dims=(-1,))
    css = torch.cumsum(u, dim=-1) - r
    ks = torch.arange(1, n + 1, dtype=mag.dtype, device=x.device)
    k = torch.clamp(torch.sum(u - css / ks > 0, dim=-1), min=1)
    tau = torch.clamp(css[..., k - 1] / k.to(mag.dtype), min=0)
    shrunk = _softsign(x) * torch.clamp(mag - tau, min=0)
    return torch.where(inside, x, shrunk)


class IndBallL1(_Indicator):
    """Indicator of {x : ‖x‖₁ ≤ r}; prox = sort-based projection."""

    separable = False

    def __init__(self, r=1.0):
        super().__init__()
        self.register_buffer("r", as_param(r))

    def value(self, x):
        nrm = torch.sum(torch.abs(x))
        eps = 100 * torch.finfo(nrm.dtype).eps
        return ind_value(nrm <= real_of(self.r, x) * (1 + eps), x)

    def prox_only(self, x, gamma):
        return _project_l1_ball(x, real_of(self.r, x))


class NormLinf(ProxOperator):
    """g(x) = lam·max_i |x_i|; prox by Moreau's decomposition,
    z = x − proj onto the γ·lam L1 ball."""

    separable = False

    def __init__(self, lam=1.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))

    def value(self, x):
        return real_of(self.lam, x) * torch.max(torch.abs(x))

    def prox_only(self, x, gamma):
        return x - _project_l1_ball(x, times_gamma(gamma, self.lam, x))


class IndNonnegative(_Indicator):
    """Indicator of the nonnegative orthant; prox = clip below at 0."""

    def value(self, x):
        return ind_value(torch.all(x >= 0), x)

    def prox_only(self, x, gamma):
        return torch.clamp(x, min=0)


class IndNonpositive(_Indicator):
    """Indicator of the nonpositive orthant; prox = clip above at 0."""

    def value(self, x):
        return ind_value(torch.all(x <= 0), x)

    def prox_only(self, x, gamma):
        return torch.clamp(x, max=0)


class IndBallLinf(_Indicator):
    """Indicator of {x : ‖x‖∞ ≤ r}; prox = clip to [−r, r]."""

    def __init__(self, r=1.0):
        super().__init__()
        self.register_buffer("r", as_param(r))

    def value(self, x):
        return ind_value(torch.all(torch.abs(x) <= real_of(self.r, x)), x)

    def prox_only(self, x, gamma):
        r = real_of(self.r, x)
        return torch.clamp(x, -r, r)


class IndHalfspace(_Indicator):
    """Indicator of {x : ⟨a, x⟩ ≤ b}; prox = affine projection."""

    separable = False

    def __init__(self, a, b=0.0):
        super().__init__()
        self.register_buffer("a", as_param(a))
        self.register_buffer("b", as_param(b))

    def _viol(self, x):
        a = like(self.a, x)
        return torch.real(torch.vdot(a, x)) - real_of(self.b, x)

    def value(self, x):
        eps = 1e-6 * torch.clamp(torch.abs(real_of(self.b, x)), min=1.0)
        return ind_value(self._viol(x) <= eps, x)

    def prox_only(self, x, gamma):
        a = like(self.a, x)
        step = torch.clamp(self._viol(x), min=0) / torch.clamp(
            torch.sum(torch.abs(a) ** 2), min=1e-38)
        return x - step * a


class IndPoint(_Indicator):
    """Indicator of the single point {p}; prox = p."""

    separable = False

    def __init__(self, p=0.0):
        super().__init__()
        self.register_buffer("p", as_param(p))

    def value(self, x):
        return ind_value(torch.all(torch.abs(x - like(self.p, x)) <= 1e-9), x)

    def prox_only(self, x, gamma):
        return torch.broadcast_to(like(self.p, x), x.shape)


class IndAffine(_Indicator):
    """Indicator of {x : A x = b}; prox = x − Aᴴ(AAᴴ)⁻¹(Ax − b). A is
    (m, n) with full row rank; the m × m solve runs per prox call."""

    separable = False

    def __init__(self, A, b=0.0):
        super().__init__()
        self.register_buffer("A", as_param(A))
        self.register_buffer("b", as_param(b))

    def value(self, x):
        res = like(self.A, x) @ x - like(self.b, x)
        return ind_value(torch.max(torch.abs(res)) <= 1e-6, x)

    def prox_only(self, x, gamma):
        A = like(self.A, x)
        res = A @ x - like(self.b, x)
        G = A @ A.conj().T
        return x - A.conj().T @ torch.linalg.solve(G, res)


class IndSphereL2(_Indicator):
    """Indicator of {x : ‖x‖₂ = r} (nonconvex); prox = radial rescale to
    the sphere (x = 0 maps to r·e₁, a valid selection)."""

    separable = False

    def __init__(self, r=1.0):
        super().__init__()
        self.register_buffer("r", as_param(r))

    def value(self, x):
        nrm = torch.sqrt(torch.sum(torch.abs(x) ** 2))
        eps = 100 * torch.finfo(nrm.dtype).eps
        r = real_of(self.r, x)
        return ind_value(torch.abs(nrm - r) <= r * eps + eps, x)

    def prox_only(self, x, gamma):
        nrm = torch.sqrt(torch.sum(torch.abs(x) ** 2))
        e1 = torch.zeros_like(x)
        e1[..., 0] = 1
        safe = torch.where(nrm > 0, x, e1)
        return safe * (real_of(self.r, x) / torch.clamp(
            torch.where(nrm > 0, nrm, torch.ones_like(nrm)), min=1e-38))


class LogBarrier(ProxOperator):
    """g(x) = −mu·Σ_i log(x_i) (domain x > 0); prox_i = (x_i +
    √(x_i² + 4γ·mu))/2, strictly inside the domain."""

    def __init__(self, mu=1.0):
        super().__init__()
        self.register_buffer("mu", as_param(mu))

    def value(self, x):
        ok = torch.all(x > 0)
        v = -real_of(self.mu, x) * torch.sum(
            torch.log(torch.where(x > 0, x, torch.ones_like(x))))
        return torch.where(ok, v, torch.full_like(v, float("inf")))

    def prox_only(self, x, gamma):
        return 0.5 * (x + torch.sqrt(x * x
                                     + 4 * times_gamma(gamma, self.mu, x)))


class HingeLoss(ProxOperator):
    """g(x) = mu·Σ_i max(0, 1 − y_i·x_i), labels y_i in {−1, +1}; the
    elementwise prox: x_i on the flat side (y_i·x_i ≥ 1), x_i + γ·mu·y_i
    on the linear side (y_i·x_i < 1 − γ·mu), else the kink y_i."""

    def __init__(self, y=1.0, mu=1.0):
        super().__init__()
        self.register_buffer("y", as_param(y))
        self.register_buffer("mu", as_param(mu))

    def value(self, x):
        return real_of(self.mu, x) * torch.sum(
            torch.clamp(1 - like(self.y, x) * x, min=0))

    def prox_only(self, x, gamma):
        y = like(self.y, x)
        t = times_gamma(gamma, self.mu, x)
        yx = y * x
        z_lin = x + t * y
        z_kink = torch.broadcast_to(y, yx.shape)
        return torch.where(yx >= 1, x, torch.where(yx < 1 - t, z_lin, z_kink))


class MCP(ProxOperator):
    """The minimax concave penalty (Zhang 2010; nonconvex, elementwise):
    g(t) = lam·|t| − t²/(2·beta) for |t| ≤ beta·lam, beta·lam²/2 beyond.
    Prox (the firm threshold, exact for γ < beta): 0 for |v| ≤ γ·lam,
    softsign(v)·(|v| − γ·lam)/(1 − γ/beta) up to beta·lam, else v."""

    def __init__(self, lam=1.0, beta=3.0):
        super().__init__()
        self.register_buffer("lam", as_param(lam))
        self.register_buffer("beta", as_param(beta))

    def value(self, x):
        a = torch.abs(x)
        lam, beta = real_of(self.lam, x), real_of(self.beta, x)
        inner = lam * a - a * a / (2 * beta)
        return torch.sum(torch.where(a <= beta * lam, inner,
                                     beta * lam * lam / 2))

    def prox_only(self, x, gamma):
        a = torch.abs(x)
        lam, beta = real_of(self.lam, x), real_of(self.beta, x)
        thr = times_gamma(gamma, self.lam, x)
        firm = _softsign(x) * (a - thr) / (1 - gamma / beta)
        z = torch.where(a <= thr, torch.zeros_like(x),
                        torch.where(a <= beta * lam, firm, x))
        return z.to(x.dtype)


class SCAD(ProxOperator):
    """Smoothly clipped absolute deviation (Fan & Li 2001; nonconvex,
    elementwise): lam·|t| up to lam, (2a·lam·|t| − t² − lam²)/(2(a − 1))
    up to a·lam, (a + 1)·lam²/2 beyond. Prox (generalized Fan-Li
    thresholding, exact for γ < a − 1): soft(v, γ·lam) up to lam(1 + γ),
    ((a − 1)v − softsign(v)·a·γ·lam)/(a − 1 − γ) up to a·lam, else v."""

    def __init__(self, lam=1.0, a=3.7):
        super().__init__()
        self.register_buffer("lam", as_param(lam))
        self.register_buffer("a", as_param(a))

    def value(self, x):
        t = torch.abs(x)
        lam, a = real_of(self.lam, x), real_of(self.a, x)
        mid = (2 * a * lam * t - t * t - lam * lam) / (2 * (a - 1))
        v = torch.where(t <= lam, lam * t,
                        torch.where(t <= a * lam, mid, (a + 1) * lam * lam / 2))
        return torch.sum(v)

    def prox_only(self, x, gamma):
        t = torch.abs(x)
        lam, a = real_of(self.lam, x), real_of(self.a, x)
        soft = _softsign(x) * torch.clamp(t - times_gamma(gamma, self.lam, x),
                                          min=0)
        mid = ((a - 1) * x - _softsign(x) * a * gamma * lam) / (a - 1 - gamma)
        z = torch.where(t <= lam * (1 + gamma), soft,
                        torch.where(t <= a * lam, mid, x))
        return z.to(x.dtype)
