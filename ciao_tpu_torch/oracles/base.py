"""Smooth-term oracle protocol.

Counterpart of ``ciao_tpu/oracles/base.py``. One oracle owns the data of
all ``N`` terms as stacked tensors (buffers of an ``nn.Module``, so
``.to(device)`` moves them) and exposes batched entry points, so the hot
paths are gathers and matrix products rather than N scalar closure
calls. A subclass defines ``num_terms`` and ``value_and_grad_i``; every
batched entry point has a generic version here (``torch.func.vmap`` over
``value_and_grad_i``, as JAX's ``vmap``), which the data-structured
oracles override with products:

  * ``grad_batch(x, idx)``        — per-term grads, all at x;
  * ``grad_sum_batch(x, idx)``    — their sum;
  * ``grad_pointwise(xs, idx)``   — one evaluation point per term (the
                                    ProShI blocks);
  * ``grad_block`` / ``grad_pointwise_block`` / ``grad_sum_diff_block``
                                  — the same over a contiguous block.
"""

from __future__ import annotations

import abc

import torch
from torch import nn
from torch.func import vmap

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


def abs_sq(r):
    """|r|² = Re(r·r̄) in r's real dtype (r·r on real values)."""
    return torch.real(r * r.conj())


def _arange(start, size: int, device):
    return torch.as_tensor(start, device=device).long() + torch.arange(
        size, device=device)


class SmoothOracle(nn.Module, metaclass=abc.ABCMeta):
    """Protocol for a finite family ``{f_i}_{i=1..N}`` of smooth terms.

    ``coordinate_separable``: whether every gradient is coordinatewise in
    x (∂f_i/∂x_j depends on x_j alone), so that a block of columns is
    exact on its own: the tensor-parallel ProShI needs it."""

    coordinate_separable: bool = False

    @property
    @abc.abstractmethod
    def num_terms(self) -> int:
        ...

    @abc.abstractmethod
    def value_and_grad_i(self, x, i):
        """``(f_i(x), ∇f_i(x))`` of one term ``i`` (an int or a 0-d
        tensor)."""
        ...

    def value_i(self, x, i):
        """f_i(x) of one term (the adaptive Finito line search)."""
        return self.value_and_grad_i(x, i)[0]

    def value_and_grad_batch(self, x, idx):
        """``(vals[B], grads[B, n])``: the terms ``idx`` all at x."""
        return vmap(self.value_and_grad_i, in_dims=(None, 0))(x, idx)

    def grad_batch(self, x, idx):
        return self.value_and_grad_batch(x, idx)[1]

    def grad_sum_batch(self, x, idx, mask=None):
        """Σ of the grads over ``idx``; ``mask`` zeroes padded slots."""
        g = self.grad_batch(x, idx)
        if mask is not None:
            g = torch.where(mask[:, None], g, 0)
        return torch.sum(g, dim=0)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        """Σ_{i ∈ idx} ∇f_i(x1) − ∇f_i(x2)."""
        return (self.grad_sum_batch(x1, idx, mask)
                - self.grad_sum_batch(x2, idx, mask))

    def _all(self, x):
        return torch.arange(self.num_terms, device=x.device)

    def grad_all(self, x):
        """The (N, n) per-term gradients (the full-table inits)."""
        return self.grad_batch(x, self._all(x))

    def value_and_grad_all(self, x):
        """``(vals[N], grads[N, n])`` of all terms at x."""
        return self.value_and_grad_batch(x, self._all(x))

    def grad_sum_all(self, x):
        return torch.sum(self.grad_all(x), dim=0)

    def value_sum_all(self, x):
        """Σ_i f_i(x), the value-only full pass (adaptive PANOC's γ test);
        row oracles override it with one margin pass."""
        return self.value_sum_and_grad_sum_all(x)[0]

    def value_sum_and_grad_sum_all(self, x):
        """(Σ_i f_i(x), Σ_i ∇f_i(x)) in one full pass: PANOC's and
        ZeroFPR's envelope read. Row oracles override it with both sums
        from one margin, without the (N, n) gradients."""
        vals, grads = self.value_and_grad_all(x)
        return torch.sum(vals), torch.sum(grads, dim=0)

    def value_and_grad_pointwise(self, xs, idx):
        """Per-term values and grads, term idx[k] at xs[k]."""
        return vmap(self.value_and_grad_i)(xs, idx)

    def grad_pointwise(self, xs, idx):
        return self.value_and_grad_pointwise(xs, idx)[1]

    # ---- contiguous blocks [start, start + size) ----------------------
    def grad_block(self, x, start, size: int):
        return self.grad_batch(x, _arange(start, size, x.device))

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        return self.grad_sum_diff(x1, x2, _arange(start, size, x1.device))

    def grad_pointwise_block(self, xs, start, size: int):
        return self.grad_pointwise(xs, _arange(start, size, xs.device))
