"""Row-wise least-squares oracle.

Counterpart of ``ciao_tpu/oracles/least_squares.py``:

    f_i(x) = (scale / 2) * |<a_i, x> - b_i|^2
    grad f_i(x) = scale * conj(a_i) * (<a_i, x> - b_i)

with <a, x> = Σ_j a_j·x_j (no conjugate on a); on real rows the
conjugates are no-ops (``Tensor.conj`` of a real tensor is the tensor
itself). The rows are stored as ONE stacked matrix ``A (N, n)``. Storage
modes (``with_storage``): f32, bf16 rows (half the traffic) and int8 rows
with per-row symmetric scales (a quarter). With quantized rows every path
computes exactly with the perturbed operator Ã = diag(row_scale)·Q, and
the per-row scale is applied to the row products, never to a dense
dequantized A. Narrow rows are widened to the iterate's dtype inside each
product, as JAX's type promotion does.

The Point-SAGA pieces are :class:`PointProxRows`'s, with the closed-form
θ = scale·(m_z − b)/(1 + γ·scale·‖a‖²), ‖a‖² = Re(a·ā).

Complex rows (complex64 or complex128, the reference's dtype sweep) take
every path above except narrow storage: int8 raises JAX's ValueError,
and a real storage dtype (bf16, f32) raises too, where JAX's cast would
drop the imaginary part. No kernel serves complex rows; the facades'
gates take f32 iterates only.
"""

from __future__ import annotations

import torch

from ciao_tpu_torch.oracles.base import (
    SmoothOracle, abs_sq, parse_storage_dtype, quantize_rows,
)
from ciao_tpu_torch.oracles.margin_rows import PointProxRows


# A full pass widens rows stored narrower than the iterate (bf16, int8)
# to its dtype. Above this many entries it widens them a chunk of rows at
# a time, so that no widened copy of the whole matrix exists: int8 rows of
# 8,388,608 x 1,024 would widen to 32 GiB of f32.
_WIDEN_CHUNK_ENTRIES = 1 << 27


def _wconj(w, A):
    """Σ_i w_i·conj(a_i) = conj(w̄ @ A), one read of the rows (a product
    with ``A.conj()`` would first copy the rows conjugated); both
    conjugates are no-ops on real tensors."""
    return torch.conj_physical(w.conj() @ A)


class LeastSquaresRows(PointProxRows, SmoothOracle):
    """``supports_coeff`` (JAX's field, default True): whether solvers
    may keep the (N,) coefficient table; False steers ``SAGA(table=
    "auto")`` to the full (N, n) table."""

    coeff_mode = 0  # ops.fused_block.MODE_LSQ

    def __init__(self, A, b, scale, row_scale=None,
                 supports_coeff: bool = True):
        super().__init__()
        self.supports_coeff = bool(supports_coeff)
        self.register_buffer("A", A)
        self.register_buffer("b", b)
        self.register_buffer(
            "scale", torch.as_tensor(scale, dtype=b.dtype.to_real(),
                                     device=b.device)
            if not isinstance(scale, torch.Tensor) else scale)
        self.register_buffer("row_scale", row_scale)

    @property
    def num_terms(self) -> int:
        return self.A.shape[0]

    @property
    def dim(self) -> int:
        return self.A.shape[1]

    def with_storage(self, dtype=torch.bfloat16):
        """Copy with the data rows STORED in ``dtype`` (f32, bf16, or
        int8 via symmetric per-row quantization ``a_i ≈ row_scale_i·q_i``).
        Solver state and iterates stay f32 either way. Complex rows keep
        a complex dtype: int8 raises JAX's error, and a real dtype raises
        where JAX's cast would drop the imaginary part."""
        dtype = parse_storage_dtype(dtype)
        if self.row_scale is not None:
            raise ValueError("rows are already int8-quantized")
        if self.A.is_complex() and dtype == torch.int8:
            raise ValueError("int8 storage requires real rows")
        if self.A.is_complex() and not dtype.is_complex:
            raise ValueError(
                f"{dtype} storage of complex rows would drop their "
                "imaginary part; store them complex64 or complex128")
        if dtype == torch.int8:
            q, rs = quantize_rows(self.A)
            return LeastSquaresRows(q, self.b, self.scale, row_scale=rs,
                                    supports_coeff=self.supports_coeff)
        return LeastSquaresRows(self.A.to(dtype), self.b, self.scale,
                                supports_coeff=self.supports_coeff)

    def _rows(self, A_B, dtype):
        return A_B if A_B.dtype == dtype else A_B.to(dtype)

    def _dense(self, A_B, rs_B, dtype):
        """Rows as ``dtype`` with the int8 scales applied: the gradient
        tables hold (B, n) or (N, n) values anyway."""
        A_B = self._rows(A_B, dtype)
        return A_B if rs_B is None else A_B * rs_B[:, None]

    def _grads(self, Ad, r):
        return self.scale * Ad.conj() * r[:, None]

    def _values(self, r):
        """½·scale·Re(r·r̄), in the real dtype of the residuals."""
        return 0.5 * self.scale * abs_sq(r)

    def value_and_grad_all(self, x):
        Ad = self._dense(self.A, self.row_scale, x.dtype)
        r = Ad @ x - self.b
        return self._values(r), self._grads(Ad, r)

    def grad_all(self, x):
        """The (N, n) table of row gradients (the full-table inits)."""
        Ad = self._dense(self.A, self.row_scale, x.dtype)
        return self._grads(Ad, Ad @ x - self.b)

    def value_and_grad_i(self, x, i):
        """(f_i(x), ∇f_i(x)) of one row ``i`` (an int or a 0-d tensor)."""
        a = self._rows(self.A[i], x.dtype)
        if self.row_scale is not None:
            a = a * self.row_scale[i]
        r = a @ x - self.b[i]
        return self._values(r), self.scale * a.conj() * r

    def grad_block(self, x, start, size: int):
        """Row gradients of the contiguous block [start, start + size)."""
        A_B, b_B, rs_B = self._slice(start, size)
        Ad = self._dense(A_B, rs_B, x.dtype)
        return self._grads(Ad, Ad @ x - b_B)

    def grad_batch(self, x, idx):
        """Row gradients of the rows ``idx``, all at x."""
        A_B, b_B, rs_B = self._gather(idx)
        Ad = self._dense(A_B, rs_B, x.dtype)
        return self._grads(Ad, Ad @ x - b_B)

    def _pointwise(self, A_B, b_B, rs_B, xs):
        """(residuals, dense rows) with one evaluation point per row."""
        Ad = self._dense(A_B, rs_B, xs.dtype)
        return torch.sum(Ad * xs, dim=-1) - b_B, Ad

    def grad_pointwise(self, xs, idx):
        """Row gradients with one evaluation point per row: row idx[k]
        at xs[k] (the adaptive variant's probe, ProShI's blocks)."""
        r, Ad = self._pointwise(*self._gather(idx), xs)
        return self._grads(Ad, r)

    def grad_pointwise_block(self, xs, start, size: int):
        """:meth:`grad_pointwise` over the block [start, start + size)."""
        r, Ad = self._pointwise(*self._slice(start, size), xs)
        return self._grads(Ad, r)

    def value_and_grad_pointwise(self, xs, idx):
        r, Ad = self._pointwise(*self._gather(idx), xs)
        return self._values(r), self._grads(Ad, r)

    def _full_table_rows(self):
        if self.row_scale is not None:
            raise ValueError(
                "int8 rows: full-table fused kernels are not supported "
                "(the f32 table traffic dominates — use table='coeff')")
        return self.A.device

    def fused_saga_block(self, s, z, start, size: int,
                         precision: str = "highest"):
        """(s, Σ_B (∇f_i(z) − s_i_old)) with the rows [start, start +
        size) of the (N, n) table ``s`` set to ∇f_i(z) in place:
        ``ops.saga_block_update``."""
        from ciao_tpu_torch.ops.fused_block import _scalar, saga_block_update

        dev = self._full_table_rows()
        return saga_block_update(self.A, self.b, s, z, start,
                                 _scalar(self.scale, dev).reshape(1), size,
                                 precision=precision)

    def fused_finito_block(self, s, gamma, z, start, size: int, inv_N,
                           hat_gamma, precision: str = "highest"):
        """(s, Σ_B (s_new − s_old)·hat_γ/γ_i) with s_new = z −
        γ_i·inv_N·∇f_i(z) written over the rows [start, start + size) of
        the (N, n) table ``s`` in place: ``ops.finito_block_update``."""
        from ciao_tpu_torch.ops.fused_block import (
            _scalar, finito_block_update,
        )

        dev = self._full_table_rows()
        scalars = torch.stack([_scalar(self.scale, dev), _scalar(inv_N, dev),
                               _scalar(hat_gamma, dev)])
        return finito_block_update(self.A, self.b, s, gamma, z, start,
                                   scalars, size, precision=precision)

    # ---- contiguous blocks: a view for a host start, a gather for a
    # device start (no host sync) ---------------------------------------
    def _block_index(self, start, size: int):
        start = torch.as_tensor(start, device=self.A.device)
        return start.long() + torch.arange(size, device=self.A.device)

    def _slice(self, start, size: int):
        if isinstance(start, int):
            return (self.A.narrow(0, start, size),
                    self.b.narrow(0, start, size),
                    None if self.row_scale is None
                    else self.row_scale.narrow(0, start, size))
        idx = self._block_index(start, size)
        return self._gather(idx)

    def _gather(self, idx):
        return (self.A.index_select(0, idx), self.b[idx],
                None if self.row_scale is None else self.row_scale[idx])

    # ---- coefficient (rank-1) gradient structure ---------------------
    # grad f_i(x) = c_i(x) · conj(a_i) with SCALAR c_i = scale·(a_i·x − b_i):
    # an (N,) coefficient vector is an exact compression of the (N, n)
    # gradient table.

    def coeff_rows_data(self):
        """(rows, offsets) consumed by the multistep kernel."""
        return self.A, self.b

    def coeff_rows_scale(self):
        """(N,) per-row dequant scales for int8 rows; None otherwise."""
        return self.row_scale

    def _coeff(self, A_B, b_B, rs_B, x):
        m = self._rows(A_B, x.dtype) @ x
        if rs_B is not None:
            m = m * rs_B
        return self.scale * (m - b_B)

    def _combine(self, w, A_B, rs_B):
        """Σ_i w_i·conj(a_i) (·rs_i for int8 rows)."""
        if rs_B is not None:
            w = w * rs_B
        return _wconj(w, self._rows(A_B, w.dtype))

    def coeff_batch(self, x, idx):
        """c_i(x) for i in idx."""
        return self._coeff(*self._gather(idx), x)

    def coeff_block(self, x, start, size: int):
        return self._coeff(*self._slice(start, size), x)

    def coeff_all(self, x):
        return self._coeff(self.A, self.b, self.row_scale, x)

    def apply_rows(self, w, idx):
        """Σ_i w_i · conj(a_i) over i in idx (the table-delta matvec)."""
        A_B, _, rs_B = self._gather(idx)
        return self._combine(w, A_B, rs_B)

    def apply_rows_block(self, w, start, size: int):
        A_B, _, rs_B = self._slice(start, size)
        return self._combine(w, A_B, rs_B)

    def apply_all(self, w):
        return self._combine(w, self.A, self.row_scale)

    # ---- gradient sums of the SVRG and FB paths, in the JAX package's
    # order of operations: the int8 scale multiplies the row products
    # on both sides, and ``scale`` comes last ---------------------------
    def _grad_sum_diff(self, A_B, rs_B, x1, x2, mask=None):
        A_B = self._rows(A_B, x1.dtype)
        d = A_B @ (x1 - x2)
        if rs_B is not None:
            d = d * rs_B
        if mask is not None:
            d = torch.where(mask, d, 0)
        if rs_B is not None:
            d = d * rs_B
        return self.scale * _wconj(d, A_B)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        """Σ_{i ∈ idx} ∇f_i(x1) − ∇f_i(x2) = scale·A_Bᴴ A_B (x1 − x2):
        the SVRG anchor-minus-live direction in one read of the rows;
        ``mask`` zeroes the padded lanes of a ragged block."""
        A_B, _, rs_B = self._gather(idx)
        return self._grad_sum_diff(A_B, rs_B, x1, x2, mask)

    def grad_sum_diff_block(self, x1, x2, start, size: int):
        A_B, _, rs_B = self._slice(start, size)
        return self._grad_sum_diff(A_B, rs_B, x1, x2)

    def _row_chunks(self, dtype):
        """A full pass's rows as ``(A_c, b_c, rs_c)`` chunks widened to
        ``dtype``: one chunk, unless the rows are narrower and hold more
        than _WIDEN_CHUNK_ENTRIES."""
        N, n = self.A.shape[0], self.A.shape[-1]
        k = N
        if self.A.dtype != dtype and N * n > _WIDEN_CHUNK_ENTRIES:
            k = max(1, _WIDEN_CHUNK_ENTRIES // n)
        for s in range(0, N, k):
            A_c, b_c, rs_c = self._slice(s, min(k, N - s))
            yield self._rows(A_c, dtype), b_c, rs_c

    def _residual_pass(self, x):
        """([r_c], Σ_i w_i·conj(a_i)) in one widening of each chunk c of
        rows: the chunks' residuals r = rs·(A x) − b and the weights w =
        rs·r (w = r with no row scale), two products over A in the JAX
        package's order of operations."""
        r, g = [], None
        for A_c, b_c, rs_c in self._row_chunks(x.dtype):
            r_c = A_c @ x
            if rs_c is not None:
                r_c = r_c * rs_c - b_c
                g_c = _wconj(r_c * rs_c, A_c)
            else:
                r_c = r_c - b_c
                g_c = _wconj(r_c, A_c)
            r.append(r_c)
            g = g_c if g is None else g + g_c
        return r, g

    def grad_sum_all(self, x):
        """Σ_i ∇f_i(x) over all rows: two products over A."""
        return self.scale * self._residual_pass(x)[1]

    # ---- margin protocol: the row product A·x first, then the affine
    # part of the coefficient. The int8 per-row scale is applied to the
    # margin, never to the rows. The deep path uses margin_all,
    # coeff_from_margin, value_sum_all and hess_weight_from_margin; the
    # tensor-parallel solvers (parallel/tp.py) take margin_block and
    # margin_all on a block of columns, sum the partial margins over the
    # mesh's "model" axis, and only then apply coeff_from_margin(_all) --
    def margin_block(self, x, start, size: int):
        return self._rows(self._slice(start, size)[0], x.dtype) @ x

    def margin_all(self, x):
        return torch.cat([A_c @ x for A_c, _, _ in self._row_chunks(x.dtype)])

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Bound on the margin curvature d²f_i/dm²: the constant
        ``scale`` for least squares (global and exact; ``margin_slack``
        is ignored). Consumed by ``solvers.polish.power_lmax``."""
        del margin_slack
        return torch.real(self.scale).to(r.dtype.to_real())

    def coeff_from_margin(self, r, start, size: int):
        _, b_B, rs_B = self._slice(start, size)
        if rs_B is not None:
            r = r * rs_B
        return self.scale * (r - b_B)

    def coeff_from_margin_all(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        return self.scale * (r - self.b)

    def value_from_margin_all(self, r):
        """Σ_i f_i from the raw margins A·x."""
        if self.row_scale is not None:
            r = r * self.row_scale
        return 0.5 * self.scale * torch.sum(abs_sq(r - self.b))

    def value_sum_all(self, x):
        """Σ_i f_i(x) in one margin pass, without the (N, n) gradient."""
        return self.value_from_margin_all(self.margin_all(x))

    def value_sum_and_grad_sum_all(self, x):
        """(Σ_i f_i(x), Σ_i ∇f_i(x)) from one margin: two products over A
        (PANOC's envelope read off the card's kernel), in the JAX
        package's order of operations."""
        r, g = self._residual_pass(x)
        return (0.5 * self.scale * torch.sum(abs_sq(torch.cat(r))),
                self.scale * g)
