"""Dense rows whose loss is a function of the margin a_i·x alone.

The shared machinery of :class:`LogisticRows`, :class:`HuberRows`,
:class:`SquaredHingeRows` and :class:`PoissonRows`, the counterparts of
``ciao_tpu/oracles/logistic.py``, ``huber.py``, ``sqhinge.py`` and
``poisson.py``. Each row's loss f_i(x) = φ(a_i·x, b_i) has the rank-1
gradient c_i·a_i with the scalar coefficient c_i = φ'(a_i·x, b_i), so a
subclass gives two per-row formulas of the dequantized margin m — the
value (``_values``) and the coefficient (``_coeffs``) — its
``coeff_mode`` (the kernels' formula, which also picks the per-row
prox's solve) and the curvature weight of the polish
(``hess_weight_from_margin``); everything else is here.

Rows are stored as ONE (N, n) matrix ``A`` with the (N,) offsets or
labels ``b``. Storage modes (``with_storage``) are those of
``LeastSquaresRows``: f32, bf16 rows, and int8 rows with per-row
symmetric scales, where every path computes with Ã = diag(row_scale)·Q
and applies the scale to the row products, never to a dense
dequantized A. Narrow rows are widened to the iterate's dtype inside
each product, as JAX's type promotion does; the per-row square-norms of
the prox keep the stored dtype, as JAX's ``jnp.sum(A_B * A_B, axis=1)``
does.

The Point-SAGA pieces (the rank-1 per-row prox) are
:class:`PointProxRows`, shared with ``LeastSquaresRows``.

A tensor argument keeps its device; anything else is placed on
:func:`runtime.default_device` (the card when there is one).
"""

from __future__ import annotations

import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles.base import (
    SmoothOracle, abs_sq, parse_storage_dtype, quantize_rows,
)
from ciao_tpu_torch.ops.fused_block import pointprox_theta


def as_tensor(x, like=None):
    """``x`` as a tensor: a tensor as it is, else on ``like``'s device (or
    the default device) with ``like``'s dtype when given."""
    if isinstance(x, torch.Tensor):
        return x
    if like is None:
        return torch.as_tensor(x, device=runtime.default_device())
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


class PointProxRows:
    """The Point-SAGA pieces of a dense-rows oracle (the JAX oracles'
    ``pointprox_*``): the prox of one row is z − γθ·a_j with a scalar θ
    from the oracle's solve (``_theta``) at the margin
    m_z = a_j·v + γ·c_j·‖a_j‖² of the row's own prox point. The core
    returns (θ_B, Σ_j (c_j − θ_j)·conj(a_j)): one margin product and one
    apply product over the same rows (the conjugate, through ``_combine``,
    matters for complex least-squares rows alone). The row square-norms
    Re(a_j·ā_j) are summed in the stored dtype (a bf16 sum for bf16 rows,
    as JAX's ``jnp.sum(A_B * A_B, axis=1)``) and then used at the
    iterate's real dtype, as JAX promotes them against its f32
    stepsize. θ is the kernels' per-row solve for
    the host's ``coeff_mode`` (``ops.fused_block.pointprox_theta``, with
    its ``scale`` and Huber's ``delta``). A host needs ``_slice``,
    ``_gather``, ``_rows`` and ``_combine``."""

    supports_pointprox = True

    def _theta(self, mz, b_B, na2, c_B, gamma):
        return pointprox_theta(self.coeff_mode, mz, b_B, na2, c_B,
                               getattr(self, "scale", 1.0), gamma,
                               getattr(self, "delta", 0.0))

    def _pointprox_core(self, A_B, b_B, rs_B, v, c_B, gamma):
        Ad = self._rows(A_B, v.dtype)
        mv = Ad @ v
        if rs_B is not None:
            mv = mv * rs_B
            na2 = torch.sum(Ad * Ad, dim=1) * (rs_B * rs_B)
        else:
            na2 = torch.sum(abs_sq(A_B), dim=1).to(v.dtype.to_real())
        mz = mv + gamma * c_B * na2
        theta = self._theta(mz, b_B, na2, c_B, gamma)
        return theta, self._combine(c_B - theta, A_B, rs_B)

    def pointprox_block(self, v, c_B, gamma, start, size: int):
        return self._pointprox_core(*self._slice(start, size), v, c_B, gamma)

    def pointprox_batch(self, v, c_B, gamma, idx):
        return self._pointprox_core(*self._gather(idx), v, c_B, gamma)

    def pointprox_sqnorm_block(self, start, size: int):
        """Raw row square-norms (un-descaled for int8 rows, in the stored
        dtype for bf16 rows)."""
        A_B = self._slice(start, size)[0]
        if self.row_scale is not None:
            A_B = A_B.to(torch.float32)
        return torch.sum(abs_sq(A_B), dim=1)

    def pointprox_theta_block(self, m_raw, na2_raw, c_B, gamma, start,
                              size: int):
        """θ from the RAW (un-descaled) margins and square-norms."""
        _, b_B, rs_B = self._slice(start, size)
        na2_raw = na2_raw.to(m_raw.dtype.to_real())
        if rs_B is not None:
            m_raw = m_raw * rs_B
            na2_raw = na2_raw * (rs_B * rs_B)
        mz = m_raw + gamma * c_B * na2_raw
        return self._theta(mz, b_B, na2_raw, c_B, gamma)


class MarginRows(PointProxRows, SmoothOracle):
    """Protocol shared by the margin-loss rows (see the module note)."""

    coeff_mode = -1  # ops.fused_block.MODE_*: set by each subclass

    def __init__(self, A, b, row_scale=None, supports_coeff: bool = True):
        super().__init__()
        # JAX's field: False steers SAGA(table="auto") to the full table
        self.supports_coeff = bool(supports_coeff)
        A = as_tensor(A)
        if A.is_complex():
            # the margin of a complex row is complex, and these losses
            # (and the JAX package's tests) define none for it
            raise NotImplementedError(
                f"{type(self).__name__} takes real rows only: its loss "
                "of a complex margin is not defined")
        self.register_buffer("A", A)
        self.register_buffer("b", as_tensor(b).to(A.device))
        self.register_buffer("row_scale", None if row_scale is None
                             else as_tensor(row_scale).to(A.device))

    # ---- what a subclass gives: per-row formulas of the dequantized
    # margin m and the offsets/labels b_B ---------------------------------
    def _values(self, m, b_B):
        raise NotImplementedError

    def _coeffs(self, m, b_B):
        raise NotImplementedError

    def _consts(self) -> dict:
        """The constructor's keyword arguments besides the data and
        ``supports_coeff``."""
        return {}

    @property
    def num_terms(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    def with_storage(self, dtype=torch.bfloat16):
        """Copy with the rows STORED in ``dtype`` (f32, bf16, or int8 via
        symmetric per-row quantization ``a_i ≈ row_scale_i·q_i``)."""
        dtype = parse_storage_dtype(dtype)
        if self.row_scale is not None:
            raise ValueError("rows are already int8-quantized")
        if dtype == torch.int8:
            q, rs = quantize_rows(self.A)
            return type(self)(q, self.b, row_scale=rs,
                              supports_coeff=self.supports_coeff,
                              **self._consts())
        return type(self)(self.A.to(dtype), self.b,
                          supports_coeff=self.supports_coeff, **self._consts())

    # ---- row access: a view for a host start, a gather for a device
    # start (no host sync) --------------------------------------------
    def _slice(self, start, size: int):
        if isinstance(start, int):
            return (self.A.narrow(0, start, size),
                    self.b.narrow(0, start, size),
                    None if self.row_scale is None
                    else self.row_scale.narrow(0, start, size))
        idx = torch.as_tensor(start, device=self.A.device).long() + \
            torch.arange(size, device=self.A.device)
        return self._gather(idx)

    def _gather(self, idx):
        return (self.A.index_select(0, idx), self.b[idx],
                None if self.row_scale is None else self.row_scale[idx])

    @staticmethod
    def _rows(A_B, dtype):
        return A_B if A_B.dtype == dtype else A_B.to(dtype)

    def _dense(self, A_B, rs_B, dtype):
        """Rows as ``dtype`` with the int8 scales applied (the gradient
        tables hold (B, n) values anyway)."""
        A_B = self._rows(A_B, dtype)
        return A_B if rs_B is None else A_B * rs_B[:, None]

    def _margins(self, A_B, rs_B, x):
        """Dequantized margins a_i·x: the scale on the (B,) products."""
        m = self._rows(A_B, x.dtype) @ x
        return m if rs_B is None else m * rs_B

    def _combine(self, w, A_B, rs_B):
        """Σ_i w_i·a_i (·rs_i for int8 rows)."""
        if rs_B is not None:
            w = w * rs_B
        return w @ self._rows(A_B, w.dtype)

    # ---- per-term / batch / full oracle calls --------------------------
    def value_and_grad_i(self, x, i):
        """(f_i(x), ∇f_i(x)) of one row ``i`` (an int or a 0-d tensor)."""
        a = self._rows(self.A[i], x.dtype)
        if self.row_scale is not None:
            a = a * self.row_scale[i]
        m = a @ x
        return self._values(m, self.b[i]), self._coeffs(m, self.b[i]) * a

    def _vg(self, A_B, b_B, rs_B, x):
        Ad = self._dense(A_B, rs_B, x.dtype)
        m = Ad @ x
        return self._values(m, b_B), self._coeffs(m, b_B)[:, None] * Ad

    def value_and_grad_batch(self, x, idx):
        return self._vg(*self._gather(idx), x)

    def grad_batch(self, x, idx):
        return self.value_and_grad_batch(x, idx)[1]

    def grad_block(self, x, start, size: int):
        """Row gradients of the contiguous block [start, start + size)."""
        return self._vg(*self._slice(start, size), x)[1]

    def grad_sum_batch(self, x, idx, mask=None):
        A_B, b_B, rs_B = self._gather(idx)
        Ad = self._dense(A_B, rs_B, x.dtype)
        c = self._coeffs(Ad @ x, b_B)
        if mask is not None:
            c = torch.where(mask, c, 0)
        return c @ Ad

    def value_and_grad_all(self, x):
        return self._vg(self.A, self.b, self.row_scale, x)

    def grad_all(self, x):
        """The (N, n) table of row gradients (the full-table inits)."""
        return self.value_and_grad_all(x)[1]

    def grad_sum_all(self, x):
        return self._combine(self.coeff_all(x), self.A, self.row_scale)

    def _grad_sum_diff(self, A_B, b_B, rs_B, x1, x2, mask=None):
        d = (self._coeffs(self._margins(A_B, rs_B, x1), b_B)
             - self._coeffs(self._margins(A_B, rs_B, x2), b_B))
        if mask is not None:
            d = torch.where(mask, d, 0)
        return self._combine(d, A_B, rs_B)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        """Σ_{i ∈ idx} ∇f_i(x1) − ∇f_i(x2), one read of the rows."""
        return self._grad_sum_diff(*self._gather(idx), x1, x2, mask)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        return self._grad_sum_diff(*self._slice(start, size), x1, x2)

    def _pointwise(self, A_B, b_B, rs_B, xs):
        Ad = self._dense(A_B, rs_B, xs.dtype)
        m = torch.sum(Ad * xs, dim=-1)
        return self._values(m, b_B), self._coeffs(m, b_B)[:, None] * Ad

    def value_and_grad_pointwise(self, xs, idx):
        """Per-row values and gradients, row idx[k] at xs[k]."""
        return self._pointwise(*self._gather(idx), xs)

    def grad_pointwise(self, xs, idx):
        return self.value_and_grad_pointwise(xs, idx)[1]

    def grad_pointwise_block(self, xs, start, size: int):
        return self._pointwise(*self._slice(start, size), xs)[1]

    # ---- coefficient (rank-1) structure: ∇f_i(x) = c_i(x)·a_i ---------
    def coeff_rows_data(self):
        """(rows, offsets or labels) consumed by the multistep kernels."""
        return self.A, self.b

    def coeff_rows_scale(self):
        """(N,) per-row dequant scales for int8 rows; None otherwise."""
        return self.row_scale

    def coeff_batch(self, x, idx):
        A_B, b_B, rs_B = self._gather(idx)
        return self._coeffs(self._margins(A_B, rs_B, x), b_B)

    def coeff_block(self, x, start, size: int):
        A_B, b_B, rs_B = self._slice(start, size)
        return self._coeffs(self._margins(A_B, rs_B, x), b_B)

    def coeff_all(self, x):
        return self._coeffs(self._margins(self.A, self.row_scale, x), self.b)

    def apply_rows(self, w, idx):
        """Σ_i w_i·a_i over i in idx (the table-delta product)."""
        A_B, _, rs_B = self._gather(idx)
        return self._combine(w, A_B, rs_B)

    def apply_rows_block(self, w, start, size: int):
        A_B, _, rs_B = self._slice(start, size)
        return self._combine(w, A_B, rs_B)

    def apply_all(self, w):
        return self._combine(w, self.A, self.row_scale)

    # ---- margin protocol: the raw products A·x first (int8 margins stay
    # un-descaled until coeff_from_margin), then the loss -----------------
    def margin_block(self, x, start, size: int):
        return self._rows(self._slice(start, size)[0], x.dtype) @ x

    def margin_all(self, x):
        return self._rows(self.A, x.dtype) @ x

    def coeff_from_margin(self, r, start, size: int):
        _, b_B, rs_B = self._slice(start, size)
        return self._coeffs(r if rs_B is None else r * rs_B, b_B)

    def coeff_from_margin_all(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        return self._coeffs(r, self.b)

    def value_from_margin_all(self, r):
        """Σ_i f_i from the raw margins A·x."""
        if self.row_scale is not None:
            r = r * self.row_scale
        return torch.sum(self._values(r, self.b))

    def value_sum_all(self, x):
        """Σ_i f_i(x) in one margin pass, without the (N, n) gradient."""
        return self.value_from_margin_all(self.margin_all(x))

    def value_sum_and_grad_sum_all(self, x):
        """(Σ_i f_i(x), Σ_i ∇f_i(x)) from one margin: two products over A
        (PANOC's envelope read off the card's kernel)."""
        m = self._margins(self.A, self.row_scale, x)
        return (torch.sum(self._values(m, self.b)),
                self._combine(self._coeffs(m, self.b), self.A,
                              self.row_scale))
