"""Poisson-regression rows: the count-data GLM with the log link.

Counterpart of ``ciao_tpu/oracles/poisson.py``:

    f_i(x) = scale·(exp(a_i·x) − y_i·a_i·x),   ∇f_i(x) = c_i·a_i,
    c_i = scale·(exp(min(a_i·x, M)) − y_i),

the kernels' ``MODE_POISSON`` formula with the clamp M =
``POISSON_CLAMP`` = 30: past M the value is extended linearly, so the
pair stays consistent and exp never overflows f32. There is no global
Lipschitz modulus: ``local_smoothness(m_max)`` gives the moduli of a
trust region, and ``hess_weight_from_margin`` the polish's trust-region
weight. The per-row prox solves θ = scale·(exp(min(m_z − γ‖a‖²θ, M)) −
y) by 20 Newton steps from the table coefficient (φ(θ) = θ − c(θ) is
increasing and concave, so Newton converges globally).
"""

from __future__ import annotations

import math

import torch

from ciao_tpu_torch.ops.fused_block import POISSON_CLAMP
from ciao_tpu_torch.oracles.margin_rows import MarginRows, as_tensor


class PoissonRows(MarginRows):
    coeff_mode = 4  # ops.fused_block.MODE_POISSON

    def __init__(self, A, y, scale=1.0, row_scale=None,
                 supports_coeff: bool = True):
        super().__init__(A, y, row_scale, supports_coeff)
        self.register_buffer("scale", as_tensor(scale, self.b))

    @property
    def y(self):
        return self.b

    def _consts(self):
        return dict(scale=self.scale)

    def local_smoothness(self, m_max: float):
        """(N,) moduli valid while |a_i·x| ≤ m_max: scale·e^{m_max}·‖a_i‖²
        (the margin curvature is exp(m)); feed them to the solvers' L."""
        Ad = self._dense(self.A, self.row_scale, torch.float32)
        return self.scale * math.exp(m_max) * torch.sum(Ad * Ad, dim=1)

    def _values(self, m, y):
        M = POISSON_CLAMP
        e = torch.where(m <= M, torch.exp(torch.clamp(m, max=M)),
                        math.exp(M) * (1.0 + (m - M)))
        return self.scale * (e - y * m)

    def _coeffs(self, m, y):
        return self.scale * (torch.exp(torch.clamp(m, max=POISSON_CLAMP)) - y)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """The margin curvature scale·e^{min(m, M)} at the anchor margins
        ``r`` inflated by ``margin_slack``: a trust-region weight, valid
        while each margin moves by at most the slack."""
        m = r + margin_slack
        return self.scale.to(r.dtype) * torch.exp(
            torch.clamp(m, max=POISSON_CLAMP))
