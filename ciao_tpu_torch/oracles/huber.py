"""Row-wise Huber-loss oracle (robust regression).

Counterpart of ``ciao_tpu/oracles/huber.py``:

    f_i(x) = scale·H_δ(a_i·x − b_i),  H_δ(r) = r²/2 for |r| ≤ δ,
                                              δ(|r| − δ/2) beyond;
    ∇f_i(x) = scale·clip(a_i·x − b_i, ±δ)·a_i,

the kernels' ``MODE_HUBER`` formula with δ in the scalars row's ``aux``
slot (``ops.fused_block.oracle_scalar_consts`` reads ``delta``). ∇f_i is
scale·‖a_i‖²-Lipschitz, as for least squares. The per-row prox is the
closed form θ = clip(scale·r₀/(1 + scale·γ‖a‖²), ±scale·δ), r₀ = m_z − b.
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.oracles.margin_rows import MarginRows, as_tensor


class HuberRows(MarginRows):
    coeff_mode = 2  # ops.fused_block.MODE_HUBER

    def __init__(self, A, b, delta=1.0, scale=1.0, row_scale=None,
                 supports_coeff: bool = True):
        super().__init__(A, b, row_scale, supports_coeff)
        self.register_buffer("delta", as_tensor(delta, self.b))
        self.register_buffer("scale", as_tensor(scale, self.b))

    def _consts(self):
        return dict(delta=self.delta, scale=self.scale)

    def _values(self, m, b):
        r = m - b
        a = r.abs()
        return self.scale * torch.where(a <= self.delta, 0.5 * r * r,
                                        self.delta * (a - 0.5 * self.delta))

    def _coeffs(self, m, b):
        return self.scale * torch.clamp(m - b, -self.delta, self.delta)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Pointwise trust-region bound on the margin curvature:
        scale·1{|r_i − b_i| ≤ δ + slack} (H_δ'' is 1 on the quadratic
        branch and 0 on the linear tails)."""
        act = (r - self.b).abs() <= self.delta + margin_slack
        return self.scale.to(r.dtype) * act.to(r.dtype)
