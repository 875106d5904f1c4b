"""High-accuracy FISTA polish: compensated chunked gradients.

Counterpart of ``ciao_tpu/solvers/polish.py``. Every f32 stochastic
solver floors at rel ~4e-5 on the 10,485,760-row planted Lasso, not
because the iterate needs more than f32 but because the full-gradient
reduction over N rows rounds at ~√N·eps relative, and the solver stalls
once the true gradient sinks below that noise. The fix costs little:
read the rows in f32 with exact f32 products, chunk by chunk, and add
the per-chunk partial gradients with a compensated (two-sum) carry.
Within a chunk of C rows the dot rounds at ~√C·eps; across the N/C
chunks the compensation is exact to O(eps²).

:func:`fista_polish` wraps that gradient in monotone FISTA with a
gradient-mapping restart; near the planted optimum the Hessian has
κ ≈ (1 + √(n/N))⁴ ≈ 1.03, so a few rounds of a few steps close rel
4e-5 → 1e-6. :func:`power_lmax` bounds the curvature for its stepsize.

Exact f32 products are the point: on a CUDA device the gradient and the
power bound raise when TF32 matmuls are on (they never set the flag
themselves). The two-sum is kept as separate eager tensor operations,
which no compiler contracts, and its (hi, lo) carry stays f32 on the
device. Dense f32/bf16 rows only: int8 rows define another operator,
which belongs to the staged schedule, not the polish.

The sparse oracles (ELL and hot/cold hybrid) have no dense stored rows.
Their polish runs through the block protocol: ``grad_sum_chunked_blocks``
takes each chunk's ``coeff_block`` and ``apply_rows_block`` with the same
two-sum carry, and the stepsize comes from ``power_lmax_quadratic`` (least
squares: H·v = (∇Σf(v) − ∇Σf(0))/N exactly) or ``power_lmax_weighted``
(margin-weighted, the logistic rows' pointwise trust-region weights).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.ops.fused_block import _two_sum


class PolishResult(NamedTuple):
    x: torch.Tensor        # polished iterate
    fp_res: torch.Tensor   # ‖x_k − prox(x_k − η∇f)‖/η at the last step


def _require_wide_rows(F, who: str):
    if getattr(F, "coeff_rows_scale", lambda: None)() is not None:
        raise ValueError(f"{who} needs f32/bf16 rows (int8 dequant "
                         "defines a different operator — rebase to "
                         "wide storage first)")


def grad_sum_chunked(F, x, chunk: int):
    """Σᵢ ∇fᵢ(x) over the oracle's rows: per chunk of ``chunk`` rows an
    exact f32 margin product, the oracle's coefficient formula
    (``coeff_from_margin``) and the partial Σ cᵢaᵢ, added across chunks
    with a compensated carry. Un-normalized; f32/bf16 rows only."""
    _require_wide_rows(F, "polish")
    A, _ = F.coeff_rows_data()
    runtime.require_exact_f32_matmul(A.device, "grad_sum_chunked")
    N, n = A.shape
    if N % chunk:
        raise ValueError(f"chunk {chunk} must divide N={N}")
    hi = torch.zeros(n, dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(hi)
    for start in range(0, N, chunk):
        A_B = A.narrow(0, start, chunk).to(x.dtype)
        c = F.coeff_from_margin(A_B @ x, start, chunk)
        hi, lo = _two_sum(hi, lo, c @ A_B)
    return hi + lo


def grad_mean_chunked(F, x, chunk: int):
    """(1/N)·Σᵢ ∇fᵢ(x) — the compensated chunked sum, normalized."""
    return grad_sum_chunked(F, x, chunk) / F.num_terms


def grad_sum_chunked_blocks(F, x, chunk: int):
    """Σᵢ ∇fᵢ(x) through the block protocol (``coeff_block`` and
    ``apply_rows_block`` per chunk of ``chunk`` rows) with the compensated
    cross-chunk carry of :func:`grad_sum_chunked`: the sparse oracles'
    polish gradient. Any rank-1 block oracle works; dense rows prefer
    :func:`grad_sum_chunked`, which reads each row once, not twice."""
    N = F.num_terms
    if N % chunk:
        raise ValueError(f"chunk {chunk} must divide N={N}")
    hi = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(hi)
    for start in range(0, N, chunk):
        c = F.coeff_block(x, start, chunk)
        hi, lo = _two_sum(hi, lo, F.apply_rows_block(c, start, chunk))
    return hi + lo


def grad_mean_chunked_blocks(F, x, chunk: int):
    """(1/N)·Σᵢ ∇fᵢ(x) through the block protocol, compensated."""
    return grad_sum_chunked_blocks(F, x, chunk) / F.num_terms


def fista_polish(F, g, x0, eta, steps: int, chunk: int = 32_768,
                 block_protocol: bool = False):
    """``steps`` monotone-FISTA steps x ← prox_g(y − η∇f(y), η) with the
    compensated chunked gradient, queued on the device with no host
    read. Restart: when ⟨y − x_new, x_new − x⟩ > 0 the momentum points
    uphill, and it resets. ``block_protocol=True`` takes the gradient
    through :func:`grad_mean_chunked_blocks`, the sparse oracles' path.
    Returns the iterate and the last step's fixed-point residual."""
    grad_fn = (grad_mean_chunked_blocks if block_protocol
               else grad_mean_chunked)
    eta = torch.as_tensor(eta, dtype=x0.dtype, device=x0.device)
    x = y = x0
    t = torch.ones((), dtype=x0.dtype, device=x0.device)
    res = torch.zeros((), dtype=x0.dtype, device=x0.device)
    for _ in range(steps):
        gr = grad_fn(F, y, chunk)
        x_new = g.prox_only(y - eta * gr, eta)
        res = torch.linalg.vector_norm(x_new - y) / eta
        restart = torch.dot(y - x_new, x_new - x) > 0
        t_new = torch.where(restart, 1.0,
                            0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t)))
        beta = torch.where(restart, 0.0, (t - 1.0) / t_new)
        y = x_new + beta * (x_new - x)
        x, t = x_new, t_new
    return PolishResult(x=x, fp_res=res)


def power_lmax(F, x, seed: int, iters: int = 8, margin_slack=0.0):
    """λmax bound of the mean Hessian H̄ = (1/N)·Aᵀ diag(w̄ᵢ) A of a
    dense-rows margin oracle by power iteration, w̄ᵢ =
    ``F.hess_weight_from_margin`` at the margins of ``x`` (the constant
    ``scale`` for least squares). Each iteration is one two-product read
    of the rows; the start vector is a normal draw of a ``torch``
    generator seeded with ``seed`` (on the CPU, so every device starts
    alike). The polish takes η = 0.9/λ̂. Returns a 0-d tensor."""
    _require_wide_rows(F, "power_lmax")
    A, _ = F.coeff_rows_data()
    runtime.require_exact_f32_matmul(A.device, "power_lmax")
    N, n = A.shape
    A = A.to(torch.promote_types(A.dtype, torch.float32))
    w = F.hess_weight_from_margin(A @ x.to(torch.float32).to(A.dtype),
                                  margin_slack)
    v = _start_vector(n, seed, A.device, A.dtype)
    lam = None
    for _ in range(iters):
        hv = ((w * (A @ v)) @ A) / N
        lam = torch.linalg.vector_norm(hv)
        # all-zero weights (an anchor with no active rows) stay finite
        v = hv / torch.clamp(lam, min=torch.finfo(hv.dtype).tiny)
    return lam


def _start_vector(n: int, seed: int, device, dtype):
    """The power iteration's unit start: a normal draw of a CPU ``torch``
    generator seeded with ``seed`` (so every device starts alike), drawn
    in f32 and then moved to ``device`` and ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(n, generator=gen, dtype=torch.float32).to(device, dtype)
    return v / torch.linalg.vector_norm(v)


def power_lmax_weighted(F, x, seed: int, iters: int = 8, margin_slack=0.0):
    """λmax of the margin-weighted mean Hessian H̄ = (1/N)·Aᵀ diag(w̄ᵢ) A
    of a block-protocol (sparse ELL or hybrid) oracle, the analogue of
    :func:`power_lmax` without dense stored rows: w̄ᵢ =
    ``F.hess_weight_from_margin`` at the margins of ``x`` (one
    ``margin_all`` pass), then per iteration a ``margin_all`` and an
    ``apply_all`` pass. Least squares gets its constant ``scale``;
    logistic rows their pointwise trust-region bound over
    ``margin_slack``. Returns a 0-d tensor."""
    if not all(hasattr(F, m) for m in ("margin_all", "apply_all",
                                       "hess_weight_from_margin")):
        raise ValueError(
            "power_lmax_weighted needs the block margin protocol "
            "(margin_all / apply_all / hess_weight_from_margin)")
    N = F.num_terms
    m = F.margin_all(x.to(torch.float32))
    w = F.hess_weight_from_margin(m, margin_slack)
    v = _start_vector(F.dim, seed, m.device, m.dtype)
    lam = None
    for _ in range(iters):
        hv = F.apply_all(w * F.margin_all(v)) / N
        lam = torch.linalg.vector_norm(hv)
        v = hv / torch.clamp(lam, min=torch.finfo(hv.dtype).tiny)
    return lam


def power_lmax_quadratic(F, seed: int, iters: int = 8):
    """λmax of the mean Hessian of a quadratic (least-squares family,
    ``coeff_mode == 0``) oracle without dense stored rows: ∇ is affine,
    so H·v = (∇Σf(v) − ∇Σf(0))/N exactly: one ``grad_sum_all`` pass an
    iteration beside ∇Σf(0), taken once. Returns a 0-d tensor."""
    N = F.num_terms
    dev = next(F.buffers()).device
    g0 = F.grad_sum_all(torch.zeros(F.dim, dtype=torch.float32, device=dev))
    v = _start_vector(F.dim, seed, dev, g0.dtype)
    lam = None
    for _ in range(iters):
        hv = (F.grad_sum_all(v) - g0) / N
        lam = torch.linalg.vector_norm(hv)
        v = hv / lam
    return lam


def lsq_power_lmax(F, seed: int, iters: int = 8):
    """λmax of the mean Hessian (scale/N)·AᵀA of a least-squares rows
    oracle: :func:`power_lmax` at the origin (the weights are constant).
    Raises on int8 rows, whose raw values would give a wrong λ."""
    _require_wide_rows(F, "lsq_power_lmax")
    A, _ = F.coeff_rows_data()
    return power_lmax(F, torch.zeros(A.shape[1], dtype=torch.float32,
                                     device=A.device), seed, iters=iters)
