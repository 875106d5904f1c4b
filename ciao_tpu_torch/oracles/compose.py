"""Oracle combinators: ``SumOracle`` and ``ZeroOracle``.

Counterpart of ``ciao_tpu/oracles/compose.py:22-100``: ProximalOperators'
``Sum`` (test_sharing.jl:23) and the ``Zero()`` default smooth term
(reference ``Finito.jl:78``). ``Precompose`` and ``CustomOracle`` are not
ported yet (ROADMAP.md, queue 1 item 11).
"""

from __future__ import annotations

import torch
from torch import nn

from ciao_tpu_torch.oracles.base import SmoothOracle


class SumOracle(SmoothOracle):
    """Pointwise sum of oracle families sharing the same index set."""

    def __init__(self, terms):
        super().__init__()
        self.terms = nn.ModuleList(terms)

    @property
    def num_terms(self) -> int:
        return self.terms[0].num_terms

    def _sum(self, name, *args):
        return sum(getattr(t, name)(*args) for t in self.terms)

    def _sum2(self, name, *args):
        vals, grads = zip(*(getattr(t, name)(*args) for t in self.terms))
        return sum(vals), sum(grads)

    def value_and_grad_i(self, x, i):
        return self._sum2("value_and_grad_i", x, i)

    def value_and_grad_batch(self, x, idx):
        return self._sum2("value_and_grad_batch", x, idx)

    def grad_sum_batch(self, x, idx, mask=None):
        return self._sum("grad_sum_batch", x, idx, mask)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        return self._sum("grad_sum_diff", x1, x2, idx, mask)

    def grad_sum_all(self, x):
        return self._sum("grad_sum_all", x)

    def grad_all(self, x):
        return self._sum("grad_all", x)

    def value_and_grad_all(self, x):
        return self._sum2("value_and_grad_all", x)

    def value_and_grad_pointwise(self, xs, idx):
        return self._sum2("value_and_grad_pointwise", xs, idx)

    def grad_pointwise(self, xs, idx):
        return self._sum("grad_pointwise", xs, idx)

    def grad_block(self, x, start, size: int):
        return self._sum("grad_block", x, start, size)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        return self._sum("grad_sum_diff_block", x1, x2, start, size)

    def grad_pointwise_block(self, xs, start, size: int):
        return self._sum("grad_pointwise_block", xs, start, size)


class ZeroOracle(SmoothOracle):
    """f_i == 0 for all i: the reference's default F (Finito.jl:78),
    which the facades build for ``F=None``. ``example`` is JAX's field, a
    shape/dtype template for gradients, kept (as a buffer) and not read."""

    def __init__(self, n_terms: int, example=None):
        super().__init__()
        self.n_terms = int(n_terms)
        self.register_buffer(
            "example", None if example is None else torch.as_tensor(example))

    @property
    def num_terms(self) -> int:
        return self.n_terms

    def value_and_grad_i(self, x, i):
        return torch.zeros((), dtype=x.dtype.to_real(),
                           device=x.device), torch.zeros_like(x)

    def grad_sum_all(self, x):
        return torch.zeros_like(x)

    def grad_sum_batch(self, x, idx, mask=None):
        return torch.zeros_like(x)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        return torch.zeros_like(x1)
