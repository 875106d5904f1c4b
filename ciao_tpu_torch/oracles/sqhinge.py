"""Squared-hinge rows: the smooth (L2) SVM loss.

Counterpart of ``ciao_tpu/oracles/sqhinge.py``:

    f_i(x) = (scale/2)·max(0, 1 − y_i·a_i·x)²
    ∇f_i(x) = −scale·y_i·max(0, 1 − y_i·a_i·x)·a_i,

the kernels' ``MODE_SQHINGE`` formula, with modulus L_i = scale·‖a_i‖².
The per-row prox is closed-form: active iff the deficit 1 − y·m_z at
the row's prox point is positive, then θ = −scale·y·(1 − y·m_z)/(1 +
scale·γ‖a‖²), else 0.
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.oracles.margin_rows import MarginRows, as_tensor


class SquaredHingeRows(MarginRows):
    coeff_mode = 3  # ops.fused_block.MODE_SQHINGE

    def __init__(self, A, y, scale=1.0, row_scale=None,
                 supports_coeff: bool = True):
        super().__init__(A, y, row_scale, supports_coeff)
        self.register_buffer("scale", as_tensor(scale, self.b))

    @property
    def y(self):
        return self.b

    def _consts(self):
        return dict(scale=self.scale)

    def _values(self, m, y):
        h = torch.clamp(1.0 - y * m, min=0.0)
        return 0.5 * self.scale * h * h

    def _coeffs(self, m, y):
        return -self.scale * y * torch.clamp(1.0 - y * m, min=0.0)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Pointwise trust-region bound on the margin curvature:
        scale·1{y_i·r_i < 1 + slack} (scale on the active branch, 0 on
        the satisfied one)."""
        act = self.b * r < 1.0 + margin_slack
        return self.scale.to(r.dtype) * act.to(r.dtype)
