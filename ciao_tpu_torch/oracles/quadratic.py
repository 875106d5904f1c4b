"""Quadratic and squared-distance-to-box oracle families.

Counterpart of ``ciao_tpu/oracles/quadratic.py`` for real data: the
reference's sharing test terms (``test/test_sharing.jl:13-24``),

  * ``Quadratic(diagm(d_i), q_i)``: f_i(x) = ½⟨x, D_i x⟩ + ⟨q_i, x⟩
    (``DiagQuadratic`` stacks d (N, n) and q (N, n); ``DenseQuadratic``
    stacks the full Q (N, n, n));
  * ``SqrDistL2(IndBox(lo, hi), eta)``: f_i(x) = (η/2)·dist(x, Box)²
    (``SqrDistBox``, one box for every term).
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.oracles.base import SmoothOracle, _arange


def _param(v):
    """A box bound or weight as a buffer: a tensor as it is, a number in
    float64 (used in x's dtype)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=torch.float64)


class DiagQuadratic(SmoothOracle):
    coordinate_separable = True  # grad = d ⊙ x + q, coordinatewise

    def __init__(self, d, q):
        super().__init__()
        self.register_buffer("d", d)
        self.register_buffer("q", q)

    @property
    def num_terms(self) -> int:
        return self.d.shape[0]

    @property
    def dim(self) -> int:
        return self.d.shape[1]

    def value_and_grad_i(self, x, i):
        di, qi = self.d[i], self.q[i]
        return 0.5 * torch.dot(x, di * x) + torch.dot(qi, x), di * x + qi

    @staticmethod
    def _vg(d_B, q_B, xs):
        vals = 0.5 * torch.sum(d_B * xs * xs, dim=-1) + torch.sum(q_B * xs,
                                                                   dim=-1)
        return vals, d_B * xs + q_B

    def value_and_grad_batch(self, x, idx):
        return self._vg(self.d[idx], self.q[idx], x[None, :])

    def value_and_grad_pointwise(self, xs, idx):
        return self._vg(self.d[idx], self.q[idx], xs)

    def grad_pointwise(self, xs, idx):
        return self.d[idx] * xs + self.q[idx]

    def _slice(self, start, size: int):
        if isinstance(start, int):
            return self.d.narrow(0, start, size), self.q.narrow(0, start, size)
        idx = _arange(start, size, self.d.device)
        return self.d[idx], self.q[idx]

    def grad_block(self, x, start, size: int):
        d_B, q_B = self._slice(start, size)
        return d_B * x[None, :] + q_B

    def grad_pointwise_block(self, xs, start, size: int):
        d_B, q_B = self._slice(start, size)
        return d_B * xs + q_B


class DenseQuadratic(SmoothOracle):
    """f_i(x) = ½⟨x, Q_i x⟩ + ⟨q_i, x⟩ with the full (N, n, n) stack."""

    def __init__(self, Q, q):
        super().__init__()
        self.register_buffer("Q", Q)
        self.register_buffer("q", q)

    @property
    def num_terms(self) -> int:
        return self.Q.shape[0]

    @property
    def dim(self) -> int:
        return self.Q.shape[1]

    def value_and_grad_i(self, x, i):
        Qx = self.Q[i] @ x
        return 0.5 * torch.dot(x, Qx) + torch.dot(self.q[i], x), Qx + self.q[i]


class SqrDistBox(SmoothOracle):
    """(η/2)·dist(x, [lo, hi])², the same box for every term.

    Smooth (gradient η·(x − proj_Box(x))): the soft box constraint of
    the sharing problem (test_sharing.jl:14-16). ``n_terms`` fixes the
    family size, since the data is shared by the terms."""

    coordinate_separable = True  # grad = η·(x − clip(x)), coordinatewise

    def __init__(self, lo, hi, eta, n_terms: int = 1):
        super().__init__()
        self.register_buffer("lo", _param(lo))
        self.register_buffer("hi", _param(hi))
        self.register_buffer("eta", _param(eta))
        self.n_terms = int(n_terms)

    @property
    def num_terms(self) -> int:
        return self.n_terms

    @property
    def dim(self) -> int:
        return -1  # shape-polymorphic

    def _r(self, xs):
        return xs - torch.clamp(xs, self.lo.to(xs.dtype), self.hi.to(xs.dtype))

    def value_and_grad_i(self, x, i):
        r = self._r(x)
        eta = self.eta.to(x.dtype)
        return 0.5 * eta * torch.sum(r * r), eta * r

    def value_and_grad_pointwise(self, xs, idx):
        r = self._r(xs)
        eta = self.eta.to(xs.dtype)
        return 0.5 * eta * torch.sum(r * r, dim=-1), eta * r

    def grad_pointwise(self, xs, idx):
        return self.eta.to(xs.dtype) * self._r(xs)

    def grad_pointwise_block(self, xs, start, size: int):
        return self.grad_pointwise(xs, None)
