"""Row-wise logistic-loss oracle.

Counterpart of ``ciao_tpu/oracles/logistic.py``, the per-row objects
``Precompose(LogisticLoss([y_i], 1.0), a_i^T, 1.0)`` of the reference's
L1-logistic tests (reference ``test/test_logistic_l1.jl:34-41``):

    f_i(x) = log(1 + exp(−y_i·a_i·x))
    ∇f_i(x) = −y_i·σ(−y_i·a_i·x)·a_i

stored as the rows ``X`` (N, n) and labels ``y`` (N,) in {−1, +1}; the
Lipschitz modulus of ∇f_i is ¼‖a_i‖² (test_logistic_l1.jl:40). The
storage modes and the shared protocol are :class:`MarginRows`'s. The
coefficient is the kernels' ``MODE_LOGISTIC`` formula; the per-row prox
θ solves θ = −y·σ(−y·(m_z − γ‖a‖²θ)) by 20 Newton steps warm-started at
the table coefficient (``ops.fused_block.pointprox_theta``).
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.oracles.margin_rows import MarginRows


def _log1pexp(t):
    """log(1 + exp(t)), stable at large |t| (JAX's ``logaddexp(0, t)``)."""
    return torch.logaddexp(torch.zeros_like(t), t)


class LogisticRows(MarginRows):
    coeff_mode = 1  # ops.fused_block.MODE_LOGISTIC

    def __init__(self, X, y, row_scale=None, supports_coeff: bool = True):
        super().__init__(X, y, row_scale, supports_coeff)

    @property
    def X(self):
        return self.A

    @property
    def y(self):
        return self.b

    def _values(self, m, y):
        return _log1pexp(-y * m)

    def _coeffs(self, m, y):
        return -y * torch.sigmoid(-y * m)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Pointwise trust-region bound on the margin curvature
        σ(t)(1 − σ(t)) over |m − r_i| ≤ ``margin_slack``: σ' is even and
        unimodal with its peak ¼ at 0, so the bound is σ' at the end of
        the interval nearest 0 (¼ when it straddles 0)."""
        sg = torch.sigmoid(torch.clamp(r.abs() - margin_slack, min=0.0))
        return sg * (1.0 - sg)
