"""Oracle combinators: ``SumOracle``, ``ZeroOracle``, ``Precompose`` and
``CustomOracle``.

Counterpart of ``ciao_tpu/oracles/compose.py``: ProximalOperators'
``Sum`` (test_sharing.jl:23), the ``Zero()`` default smooth term
(reference ``Finito.jl:78``), ``Precompose`` (test_logistic_l1.jl:36) in
stacked-operator form, and the user-defined family whose gradients come
from autodiff.

Complex iterates: every gradient here is the oracles' conj(a)·r
convention, ∂f/∂Re(x) + i·∂f/∂Im(x), which is what ``torch.func.grad``
returns for a real-valued f of a complex x. (The JAX package's
``CustomOracle`` takes ``jax.value_and_grad``, whose complex gradient is
the conjugate of that; the two agree on real iterates.)
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import grad_and_value, vmap
from torch.utils import _pytree as pytree

from ciao_tpu_torch.oracles.base import SmoothOracle


class SumOracle(SmoothOracle):
    """Pointwise sum of oracle families sharing the same index set."""

    def __init__(self, terms):
        super().__init__()
        self.terms = nn.ModuleList(terms)

    @property
    def num_terms(self) -> int:
        return self.terms[0].num_terms

    @property
    def coordinate_separable(self) -> bool:
        return all(t.coordinate_separable for t in self.terms)

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

    coordinate_separable = True

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


class Precompose(SmoothOracle):
    """f_i(x) = base_i(L_i x + t_i): ProximalOperators' ``Precompose`` in
    stacked-operator form (the row case ``Precompose(LogisticLoss, a_iᵀ,
    1.0)`` of test_logistic_l1.jl:36 is what ``LogisticRows`` folds).

    ``Lmat`` is (N, m, n); ``shift`` is (N, m) or None. Gradients follow
    the chain rule ∇f_i(x) = conj(L_i)ᵀ ∇base_i(L_i x + t_i). The batched
    paths map the block's points through one batched product and hand
    them to the base's pointwise path."""

    def __init__(self, base: SmoothOracle, Lmat, shift=None):
        super().__init__()
        self.base = base
        self.register_buffer("Lmat", Lmat)
        self.register_buffer("shift", shift)

    @property
    def num_terms(self) -> int:
        return self.Lmat.shape[0]

    def value_and_grad_i(self, x, i):
        L_i = self.Lmat[i]
        y = L_i @ x
        if self.shift is not None:
            y = y + self.shift[i]
        val, gy = self.base.value_and_grad_i(y, i)
        return val, L_i.conj().T @ gy

    def _pointwise(self, L_B, ys, idx):
        if self.shift is not None:
            ys = ys + self.shift[idx]
        vals, gy = self.base.value_and_grad_pointwise(ys, idx)
        return vals, torch.einsum("bmn,bm->bn", L_B.conj(), gy)

    def value_and_grad_batch(self, x, idx):
        L_B = self.Lmat[idx]
        return self._pointwise(L_B, L_B @ x, idx)

    def value_and_grad_pointwise(self, xs, idx):
        L_B = self.Lmat[idx]
        return self._pointwise(L_B, torch.einsum("bmn,bn->bm", L_B, xs),
                               idx)


class CustomOracle(SmoothOracle):
    """User-defined smooth family: ``fun(x, data_i) -> scalar``.

    ``data`` is a tree (dicts, lists, tuples) of tensors stacked over the
    leading N axis; its leaves are buffers, so ``.to(device)`` moves
    them. Gradients come from ``torch.func.grad_and_value``: the escape
    hatch matching the reference's ability to accept any ProximalOperators
    function as f_i. ``n_terms`` (JAX's field) overrides the leading
    size of the first leaf when nonzero. The batched paths gather the
    data rows of ``idx`` first and then ``vmap`` the gradient over them,
    so ``fun`` sees one term's data at a time."""

    def __init__(self, data, fun: Callable, n_terms: int = 0):
        super().__init__()
        leaves, self._spec = pytree.tree_flatten(data)
        for k, leaf in enumerate(leaves):
            self.register_buffer(f"_leaf{k}", torch.as_tensor(leaf))
        self.fun = fun
        self.n_terms = int(n_terms)
        self._vg = grad_and_value(fun)

    @property
    def data(self):
        return pytree.tree_unflatten(
            [getattr(self, f"_leaf{k}")
             for k in range(self._spec.num_leaves)],
            self._spec)

    @property
    def num_terms(self) -> int:
        if self.n_terms:
            return self.n_terms
        return self._leaf0.shape[0]

    def _rows(self, idx):
        return pytree.tree_map(lambda a: a[idx], self.data)

    def value_and_grad_i(self, x, i):
        grad, val = self._vg(x, self._rows(i))
        return val, grad

    def value_and_grad_batch(self, x, idx):
        grads, vals = vmap(self._vg, in_dims=(None, 0))(x, self._rows(idx))
        return vals, grads

    def value_and_grad_pointwise(self, xs, idx):
        grads, vals = vmap(self._vg)(xs, self._rows(idx))
        return vals, grads
