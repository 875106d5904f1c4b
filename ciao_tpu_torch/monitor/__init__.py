"""Convergence metrics (counterpart of ``ciao_tpu/monitor``, cut to the
objective and the fixed-point residual)."""

from __future__ import annotations

import torch


def fixed_point_residual(z_prev, z_next, gamma):
    """||z_next - z_prev|| / gamma — the stationarity surrogate of these
    fixed-point iterations."""
    return torch.sqrt(torch.sum(torch.abs(z_next - z_prev) ** 2)) / gamma


def objective(F, g, x):
    """(1/N) Σ f_i(x) + g(x), computed with the full-pass oracle."""
    vals, _ = F.value_and_grad_all(x)
    return torch.sum(vals) / F.num_terms + g.value(x)
