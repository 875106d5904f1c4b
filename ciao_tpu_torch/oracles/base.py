"""Smooth-term oracle protocol.

Counterpart of ``ciao_tpu/oracles/base.py``, cut to what the SAGA slice
calls. One oracle owns the data of all ``N`` terms as stacked tensors
(buffers of an ``nn.Module``, so ``.to(device)`` moves them) and exposes
batched entry points, so the hot paths are gathers and matrix products
rather than N scalar closure calls.
"""

from __future__ import annotations

import abc

import torch
from torch import nn

_STORAGE_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "i8": torch.int8,
    "f32": torch.float32, "float32": torch.float32, "fp32": torch.float32,
}


def parse_storage_dtype(dtype):
    """Resolve a ``with_storage`` argument (dtype or alias string) to a
    torch dtype, with a helpful error for unknown modes."""
    if isinstance(dtype, str):
        try:
            return _STORAGE_DTYPES[dtype]
        except KeyError:
            raise ValueError(
                f"unknown storage mode {dtype!r}; supported: "
                f"{sorted(_STORAGE_DTYPES)} (or a torch dtype)"
            ) from None
    return dtype


def quantize_rows(A):
    """Symmetric per-row int8 quantization of a real (N, n) row stack.

    Returns ``(q, row_scale)`` with ``q ∈ [-127, 127]`` int8 and f32
    ``row_scale`` such that ``a_i ≈ row_scale_i · q_i`` (absmax scaling;
    all-zero rows get scale 1 so they stay exactly zero). Bit-identical
    to the JAX package: the f32 division, then round half to even
    (``torch.round`` like ``jnp.rint``).
    """
    rs = torch.amax(torch.abs(A), dim=1).to(torch.float32) / 127.0
    rs = torch.where(rs > 0, rs, torch.ones_like(rs))
    q = torch.clamp(
        torch.round(A.to(torch.float32) / rs[:, None]), -127, 127
    ).to(torch.int8)
    return q, rs


class SmoothOracle(nn.Module, metaclass=abc.ABCMeta):
    """Protocol for a finite family ``{f_i}_{i=1..N}`` of smooth terms."""

    @property
    @abc.abstractmethod
    def num_terms(self) -> int:
        ...

    @abc.abstractmethod
    def value_and_grad_all(self, x):
        """``(vals[N], grads[N, n])`` of all terms at x."""
        ...

    def value_i(self, x, i):
        """f_i(x) of one term (the adaptive Finito line search)."""
        return self.value_and_grad_i(x, i)[0]
