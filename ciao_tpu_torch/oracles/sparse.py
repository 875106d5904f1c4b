"""Sparse rows: the ELL layout and the hot/cold hybrid.

Counterpart of ``ciao_tpu/oracles/sparse.py``. An rcv1-scale sparse
problem (N ~ 1e5..1e7 rows, n ~ 5e4 columns, ~0.1 % density) does not fit
as dense rows: 524,288 × 65,536 f32 is 128 GiB. The ELL layout pads every
row to a fixed ``K`` nonzeros,

    idx (N, K) int32   column indices (padding slots: index 0)
    val (N, K)         values          (padding slots: value 0.0)

so a batch of rows is a gather of x (``index_select``) and its transpose
product a scatter-add (``index_add_``). The hybrid stores the ``D`` most
popular columns of power-law data densely,

    margin_i = <A_hot[i], x[hot_cols]> + Σ_k val[i,k]·x[idx[i,k]],

a matrix product for the dense block and ELL for the tail. ``hot_cols``
holds original column ids (padded with 0, whose ``A_hot`` column is all
zero), so x stays in the original feature space.

No CUDA kernel serves these classes, by design as in the JAX package,
which computes them with XLA gathers and scatter-adds outside any Pallas
kernel: the solvers' kernel gates close on ``coeff_rows_data``, which
sparse rows do not have, and every solver runs them stepwise. On a CUDA
device ``index_add_`` adds floats with atomics, so the scatter's order of
summation, and its last bits, can differ from run to run.

The int64 views of the index tensors are made once, at construction, as
buffers. The hot block's f32 product must be exact f32: on a CUDA device
it raises when TF32 matmuls are on. A bf16 hot block is widened to the
iterate's dtype before the product, as JAX promotes bf16 @ f32; the
iterate is never narrowed.

A tensor argument keeps its device; anything else is placed on
:func:`runtime.default_device` (the card when there is one).
"""

from __future__ import annotations

import numpy as np
import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.oracles.base import SmoothOracle, parse_storage_dtype
from ciao_tpu_torch.oracles.margin_rows import as_tensor


def _ell_fields(A, K, min_k: int):
    """(idx, val) of the dense numpy rows ``A``: each row's nonzeros in
    column order, at most K of them (default: the most in a row, at least
    ``min_k``), zero-padded (JAX's ``from_dense``
    call for call, so both packages fill the same slots)."""
    N, n = A.shape
    nnz = (A != 0).sum(axis=1)
    K = int(K if K is not None else max(min_k, nnz.max()))
    idx = np.zeros((N, K), np.int32)
    val = np.zeros((N, K), A.dtype)
    for i in range(N):
        (cols,) = np.nonzero(A[i])
        cols = cols[:K]
        idx[i, : len(cols)] = cols
        val[i, : len(cols)] = A[i, cols]
    return idx, val


def _hybrid_fields(A, D: int, K):
    """(A_hot, hot_cols, idx, val) of the dense numpy rows ``A``: the D
    columns with the most nonzeros (``np.argsort(-counts)``, as JAX picks
    them) dense and lane-padded to a multiple of 128, the rest ELL."""
    N, n = A.shape
    counts = (A != 0).sum(axis=0)
    D_pad = max(128, -(-D // 128) * 128)
    hot = np.argsort(-counts)[:min(D, n)]
    hot_cols = np.zeros(D_pad, np.int32)
    hot_cols[: len(hot)] = hot
    A_hot = np.zeros((N, D_pad), A.dtype)
    A_hot[:, : len(hot)] = A[:, hot]
    cold_mask = np.ones(n, bool)
    cold_mask[hot] = False
    idx, val = _ell_fields(A * cold_mask[None, :], K, 1)
    return A_hot, hot_cols, idx, val


def _on(a, device):
    return torch.as_tensor(np.asarray(a), device=device)


class SparseRows(SmoothOracle):
    """Rank-1 rows in the ELL layout, with a dense hot block for the
    hybrids. ``b`` holds the offsets (least squares) or the labels
    (logistic). A subclass gives the loss of the margin: ``_values``,
    ``_coeffs``, ``hess_weight_from_margin`` and ``coeff_mode``."""

    coeff_mode = -1

    def __init__(self, idx, val, b, n_dim: int, A_hot=None, hot_cols=None,
                 supports_coeff: bool = True):
        super().__init__()
        self.supports_coeff = bool(supports_coeff)
        idx = as_tensor(idx)
        dev = idx.device
        self.n_dim = int(n_dim)
        self.register_buffer("idx", idx)
        self.register_buffer("val", as_tensor(val).to(dev))
        self.register_buffer("b", as_tensor(b).to(dev))
        self.register_buffer("_idx64", idx.long(), persistent=False)
        if A_hot is None:
            self.A_hot = self.hot_cols = self._hot64 = None
            return
        hot_cols = as_tensor(hot_cols).to(dev)
        self.register_buffer("A_hot", as_tensor(A_hot).to(dev))
        self.register_buffer("hot_cols", hot_cols)
        self.register_buffer("_hot64", hot_cols.long(), persistent=False)

    # ---- what a subclass gives ----------------------------------------
    def _values(self, m, b_B):
        raise NotImplementedError

    def _coeffs(self, m, b_B):
        raise NotImplementedError

    def _coeff_diff(self, x1, x2, parts, b_B):
        """c(x1) − c(x2) of the rows ``parts``."""
        return (self._coeffs(self._margins(x1, parts), b_B)
                - self._coeffs(self._margins(x2, parts), b_B))

    @property
    def num_terms(self) -> int:
        return self.idx.shape[0]

    @property
    def dim(self) -> int:
        return self.n_dim

    @property
    def nnz_per_row(self) -> int:
        return self.idx.shape[1]

    # ---- row access: (idx64, val, A_hot) parts and the offsets; views
    # for a host start, gathers for a device start (no host sync) --------
    def _all_parts(self):
        return (self._idx64, self.val, self.A_hot), self.b

    def _slice(self, start, size: int):
        if isinstance(start, int):
            def sl(a):
                return None if a is None else a.narrow(0, start, size)
            return (sl(self._idx64), sl(self.val), sl(self.A_hot)), sl(self.b)
        rows = torch.as_tensor(start, device=self.idx.device).long() + \
            torch.arange(size, device=self.idx.device)
        return self._gather(rows)

    def _gather(self, rows):
        rows = torch.as_tensor(rows, device=self.idx.device).long()

        def g(a):
            return None if a is None else a.index_select(0, rows)
        return (g(self._idx64), g(self.val), g(self.A_hot)), g(self.b)

    # ---- the two products ------------------------------------------------
    def _hot(self, Ah_B, dtype, device):
        runtime.require_exact_f32_matmul(device, type(self).__name__)
        return Ah_B if Ah_B.dtype == dtype else Ah_B.to(dtype)

    def _margins(self, x, parts):
        """<a_i, x> of the rows ``parts``: a gather of x over the ELL slots
        and, for the hybrids, the hot block's product."""
        idx_B, val_B, Ah_B = parts
        xs = x.index_select(0, idx_B.reshape(-1)).view(idx_B.shape)
        cold = torch.sum(val_B * xs, dim=-1)
        if Ah_B is None:
            return cold
        dense = self._hot(Ah_B, x.dtype, x.device) @ x.index_select(
            0, self._hot64)
        return dense + cold

    def _combine(self, w, parts):
        """Σ_i w_i·a_i over the rows ``parts``: a scatter-add of the B·K
        weighted slots (and the hot block's product, added at hot_cols)."""
        idx_B, val_B, Ah_B = parts
        flat = (w[:, None] * val_B).reshape(-1)
        dtype = flat.dtype if Ah_B is None else w.dtype
        out = torch.zeros(self.n_dim, dtype=dtype, device=w.device)
        if Ah_B is not None:
            out.index_add_(0, self._hot64,
                           w @ self._hot(Ah_B, w.dtype, w.device))
        return out.index_add_(0, idx_B.reshape(-1), flat.to(dtype))

    def _dense_rows(self, c, parts):
        """The (B, n) gradients c_i·a_i (full-table mode only)."""
        idx_B, val_B, Ah_B = parts
        src = c[:, None] * val_B
        rows = torch.zeros(idx_B.shape[0], self.n_dim, dtype=src.dtype,
                           device=c.device)
        if Ah_B is not None:
            rows.index_add_(1, self._hot64,
                            c[:, None] * self._hot(Ah_B, c.dtype, c.device))
        return rows.scatter_add_(1, idx_B, src)

    # ---- single term -------------------------------------------------------
    def value_and_grad_i(self, x, i):
        """(f_i(x), ∇f_i(x)) of one row ``i`` (an int or a 0-d tensor)."""
        parts, b_B = self._gather(torch.as_tensor(i).reshape(1))
        m = self._margins(x, parts)
        c = self._coeffs(m, b_B)
        grad = self._combine(c, parts).to(x.dtype)
        return self._values(m, b_B)[0], grad

    # ---- coefficient (rank-1) protocol ---------------------------------
    def margin_all(self, x):
        """Raw margins <a_i, x> (no scale, offset or label): with
        :meth:`apply_all` the block-protocol pair of the weighted power
        bound (``solvers.polish.power_lmax_weighted``)."""
        return self._margins(x, self._all_parts()[0])

    def coeff_batch(self, x, idx):
        parts, b_B = self._gather(idx)
        return self._coeffs(self._margins(x, parts), b_B)

    def coeff_block(self, x, start, size: int):
        parts, b_B = self._slice(start, size)
        return self._coeffs(self._margins(x, parts), b_B)

    def coeff_all(self, x):
        parts, b = self._all_parts()
        return self._coeffs(self._margins(x, parts), b)

    def apply_rows(self, w, idx):
        return self._combine(w, self._gather(idx)[0])

    def apply_rows_block(self, w, start, size: int):
        return self._combine(w, self._slice(start, size)[0])

    def apply_all(self, w):
        return self._combine(w, self._all_parts()[0])

    # ---- batched gradient paths ------------------------------------------
    def grad_sum_all(self, x):
        return self.apply_all(self.coeff_all(x))

    def grad_sum_batch(self, x, idx, mask=None):
        c = self.coeff_batch(x, idx)
        if mask is not None:
            c = torch.where(mask, c, 0)
        return self.apply_rows(c, idx)

    def grad_sum_diff(self, x1, x2, idx, mask=None):
        parts, b_B = self._gather(idx)
        d = self._coeff_diff(x1, x2, parts, b_B)
        if mask is not None:
            d = torch.where(mask, d, 0)
        return self._combine(d, parts)

    # ---- per-row gradients (the full tables and the pointwise probes);
    # the block and all-row versions are the base class's gathers ------
    def value_and_grad_batch(self, x, idx):
        parts, b_B = self._gather(idx)
        m = self._margins(x, parts)
        return self._values(m, b_B), self._dense_rows(self._coeffs(m, b_B),
                                                      parts)

    def value_and_grad_pointwise(self, xs, idx):
        """Per-row values and gradients, row idx[k] at xs[k]."""
        parts, b_B = self._gather(idx)
        idx_B, val_B, Ah_B = parts
        m = torch.sum(val_B * torch.gather(xs, 1, idx_B), dim=1)
        if Ah_B is not None:
            m = torch.sum(self._hot(Ah_B, xs.dtype, xs.device)
                          * xs.index_select(1, self._hot64), dim=1) + m
        return self._values(m, b_B), self._dense_rows(self._coeffs(m, b_B),
                                                      parts)

    # ---- full sums from one margin pass: never the (N, n) gradients ----
    def value_sum_all(self, x):
        """Σ_i f_i(x) in one margin pass (the staged schedule's check)."""
        return torch.sum(self._values(self.margin_all(x), self.b))

    def value_sum_and_grad_sum_all(self, x):
        m = self.margin_all(x)
        return (torch.sum(self._values(m, self.b)),
                self.apply_all(self._coeffs(m, self.b)))


class _HotBlock:
    """What the hybrids add: the hot block's width and its storage."""

    @property
    def hot_width(self) -> int:
        return self.A_hot.shape[1]

    def with_storage(self, dtype=torch.bfloat16):
        """Copy with the dense hot block stored in ``dtype`` (f32 or bf16;
        the ELL tail keeps its dtype). Products widen it to the
        iterate's dtype."""
        dtype = parse_storage_dtype(dtype)
        if not dtype.is_floating_point:
            raise ValueError(f"the hot block stores f32 or bf16 values, "
                             f"not {dtype}")
        return self._replace_hot(self.A_hot.to(dtype))


class _LeastSquares:
    """f_i(x) = (scale/2)·(<a_i, x> − b_i)², c_i = scale·(<a_i, x> − b_i)."""

    coeff_mode = 0  # ops.fused_block.MODE_LSQ (no kernel serves it here)

    def _set_scale(self, scale):
        self.register_buffer("scale", torch.as_tensor(
            scale, dtype=scale.dtype if isinstance(scale, torch.Tensor)
            else self.b.dtype, device=self.b.device))

    def _values(self, m, b_B):
        r = m - b_B
        return 0.5 * self.scale * r * r

    def _coeffs(self, m, b_B):
        return self.scale * (m - b_B)

    def _coeff_diff(self, x1, x2, parts, b_B):
        return self.scale * self._margins(x1 - x2, parts)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        """Margin curvature ``scale``: global and exact for least squares
        (``margin_slack`` is ignored)."""
        del margin_slack
        return self.scale.to(r.dtype)


def _log1pexp(t):
    """log(1 + exp(t)), stable at large |t| (JAX's ``logaddexp(0, t)``)."""
    return torch.logaddexp(torch.zeros_like(t), t)


def _sigmoid_coeff(y_B, m):
    """Logistic rank-1 coefficient c = −y·σ(−y·m) (reference
    test_logistic_l1.jl:34-41)."""
    return -y_B * torch.sigmoid(-y_B * m)


def _logistic_trust_weight(r, margin_slack=0.0):
    """Pointwise bound on σ(t)(1 − σ(t)) over |m − r| ≤ ``margin_slack``:
    σ' is even and unimodal with its peak ¼ at 0, so the bound is σ' at
    the end of the interval nearest 0 (¼ when it straddles 0)."""
    sg = torch.sigmoid(torch.clamp(r.abs() - margin_slack, min=0.0))
    return sg * (1.0 - sg)


class _Logistic:
    """f_i(x) = log(1 + exp(−y_i·<a_i, x>)), c_i = −y_i·σ(−y_i·<a_i, x>);
    the Lipschitz modulus of ∇f_i is ¼‖a_i‖² (test_logistic_l1.jl:40)."""

    coeff_mode = 1  # ops.fused_block.MODE_LOGISTIC (no kernel serves it)

    @property
    def y(self):
        return self.b

    def _values(self, m, y_B):
        return _log1pexp(-y_B * m)

    def _coeffs(self, m, y_B):
        return _sigmoid_coeff(y_B, m)

    def hess_weight_from_margin(self, r, margin_slack=0.0):
        return _logistic_trust_weight(r, margin_slack)


class SparseLeastSquaresELL(_LeastSquares, SparseRows):
    """Least-squares rows in the ELL layout: ``idx`` (N, K) int32, ``val``
    (N, K), ``b`` (N,), ``scale`` (the reference passes N), ``n_dim``."""

    def __init__(self, idx, val, b, scale, n_dim: int,
                 supports_coeff: bool = True):
        super().__init__(idx, val, b, n_dim, supports_coeff=supports_coeff)
        self._set_scale(scale)

    @classmethod
    def from_dense(cls, A, b, scale, K: int | None = None, device=None):
        """From a dense (N, n) numpy matrix (a test and bench helper)."""
        device = runtime.default_device() if device is None else device
        A = np.asarray(A)
        idx, val = _ell_fields(A, K, 0)
        return cls(_on(idx, device), _on(val, device), _on(b, device),
                   scale, A.shape[1])


class HybridSparseLeastSquares(_HotBlock, _LeastSquares, SparseRows):
    """Least-squares rows split hot/cold: ``A_hot`` (N, D) with D a
    multiple of 128, ``hot_cols`` (D,) int32 original column ids, the ELL
    tail ``idx``/``val``, ``b``, ``scale``, ``n_dim``."""

    def __init__(self, A_hot, hot_cols, idx, val, b, scale, n_dim: int,
                 supports_coeff: bool = True):
        super().__init__(idx, val, b, n_dim, A_hot, hot_cols,
                         supports_coeff=supports_coeff)
        self._set_scale(scale)

    def _replace_hot(self, A_hot):
        return HybridSparseLeastSquares(A_hot, self.hot_cols, self.idx,
                                        self.val, self.b, self.scale,
                                        self.n_dim, self.supports_coeff)

    @classmethod
    def from_dense(cls, A, b, scale, D: int, K: int | None = None,
                   device=None):
        """Split a dense (N, n) numpy matrix: the D columns with the most
        nonzeros go dense, the rest to ELL."""
        device = runtime.default_device() if device is None else device
        A = np.asarray(A)
        fields = _hybrid_fields(A, D, K)
        return cls(*(_on(a, device) for a in fields), _on(b, device), scale,
                   A.shape[1])


class SparseLogisticELL(_Logistic, SparseRows):
    """Logistic rows in the ELL layout: ``idx``, ``val``, labels ``y`` in
    {−1, +1}, ``n_dim`` — the sparse counterpart of ``LogisticRows``."""

    def __init__(self, idx, val, y, n_dim: int, supports_coeff: bool = True):
        super().__init__(idx, val, y, n_dim, supports_coeff=supports_coeff)

    @classmethod
    def from_dense(cls, A, y, K: int | None = None, device=None):
        """From a dense (N, n) numpy matrix (a test and bench helper)."""
        device = runtime.default_device() if device is None else device
        A = np.asarray(A)
        idx, val = _ell_fields(A, K, 1)
        return cls(_on(idx, device), _on(val, device), _on(y, device),
                   A.shape[1])


class HybridSparseLogistic(_HotBlock, _Logistic, SparseRows):
    """Logistic rows split hot/cold: ``A_hot``, ``hot_cols``, the ELL
    tail ``idx``/``val``, labels ``y``, ``n_dim``."""

    def __init__(self, A_hot, hot_cols, idx, val, y, n_dim: int,
                 supports_coeff: bool = True):
        super().__init__(idx, val, y, n_dim, A_hot, hot_cols,
                         supports_coeff=supports_coeff)

    def _replace_hot(self, A_hot):
        return HybridSparseLogistic(A_hot, self.hot_cols, self.idx, self.val,
                                    self.b, self.n_dim, self.supports_coeff)

    @classmethod
    def from_dense(cls, A, y, D: int, K: int | None = None, device=None):
        """Split a dense (N, n) numpy matrix as
        ``HybridSparseLeastSquares.from_dense`` does (labels for b)."""
        device = runtime.default_device() if device is None else device
        A = np.asarray(A)
        fields = _hybrid_fields(A, D, K)
        return cls(*(_on(a, device) for a in fields), _on(y, device),
                   A.shape[1])
