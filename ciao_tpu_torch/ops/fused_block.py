"""The coefficient kernels of the port, with their plain versions.

Counterpart of ``ciao_tpu/ops/fused_block.py``, cut to what the SAGA,
deep, SVRG, forward-backward, Finito, ProShI, Katyusha, SARAH, loopless
(L-SVRG, L-Katyusha), SSNM, Point-SAGA, PANOC/ZeroFPR and splitting paths
run: the oracle formula modes and their values, Point-SAGA's per-row prox
(:func:`pointprox_theta`), the coupling prox modes, the scalar constants,
the kernels' gates, and nineteen hand-written CUDA kernels for Hopper
beside their plain PyTorch versions:

- ``saga_coeff_multistep_streamed``
  (``csrc/saga_coeff_multistep_streamed.cu``), and with it
  ``saga_coeff_multistep`` (the same entry with no clamp count),
  ``svrg_coeff_multistep`` (``csrc/svrg_coeff_multistep.cu``),
  ``finito_coeff_multistep`` (``csrc/finito_coeff_multistep.cu``),
  ``lfinito_sweep_multistep`` (``csrc/lfinito_sweep_multistep.cu``),
  ``katyusha_coeff_multistep`` (``csrc/katyusha_coeff_multistep.cu``),
  ``sarah_multistep`` (``csrc/sarah_multistep.cu``),
  ``lsvrg_coeff_multistep`` (``csrc/lsvrg_coeff_multistep.cu``),
  ``lkatyusha_coeff_multistep`` (``csrc/lkatyusha_coeff_multistep.cu``),
  ``finito_coeff_multistep_streamed``
  (``csrc/finito_coeff_multistep_streamed.cu``), ``proshi_multistep``
  (``csrc/proshi_multistep.cu``, K ProShI steps on the block table),
  ``point_saga_multistep_streamed``
  (``csrc/point_saga_multistep_streamed.cu``, K Point-SAGA steps, a prox
  solve a row) and with it ``point_saga_multistep`` (the same entry with
  no clamp count), ``ssnm_multistep_streamed``
  (``csrc/ssnm_multistep_streamed.cu``, K SSNM steps) and with it
  ``ssnm_multistep`` (the same entry with no clamp count): K block steps
  each, one cooperative launch a call on the persistent engine of
  ``csrc/loopless_steps.cuh``;
- ``coeff_apply_all`` (``csrc/coeff_apply_all.cu``): one compensated pass
  over all rows, the anchors of the SVRG-shaped families, LFinito's and
  SARAH's, and the full gradient of forward-backward, Davis-Yin and
  Condat-Vũ; ``coeff_value_apply_all`` (``csrc/coeff_value_apply_all.cu``):
  the same pass with the loss sum, PANOC's and ZeroFPR's envelope read;
  both walk the rows with the device code of ``csrc/apply_rows.cuh``;
- ``saga_block_update`` (``csrc/saga_block_update.cu``) and
  ``finito_block_update`` (``csrc/finito_block_update.cu``): the
  full-table SAGA and Finito refresh of one block; both walk a block of
  an (N, n) table with the device code of ``csrc/table_rows.cuh``.

The row primitives they share are in ``csrc/row_ops.cuh``. With
``coeff_value_apply_all`` every TPU kernel of the JAX module has its
counterpart here.

Layouts are flat: coefficient tables ``c``/``canch``, the offsets ``b``,
the stepsizes ``gamma``, the int8 dequant scales ``rs`` and Point-SAGA's
row square-norms ``na`` are ``(N,)``, iterates and averages are
``(n,)``, Finito's per-block anchors and SSNM's stored points ``zb``
``(d, n)`` and the full tables ``s`` ``(N, n)``. The TPU's ``(8, N/8)``
slab exists only for its VMEM tiling and has no meaning here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ciao_tpu_torch import runtime
from ciao_tpu_torch.ops import _build

MODE_LSQ = 0       # c = scale·(a_i·z − b_i)        (least-squares rows)
MODE_LOGISTIC = 1  # c = −y_i·σ(−y_i·a_i·z)          (logistic rows)
MODE_HUBER = 2     # c = scale·clip(a_i·z − b_i, ±δ) (Huber rows; aux = δ)
MODE_SQHINGE = 3   # c = −scale·y_i·max(0, 1 − y_i·a_i·z)  (smooth SVM)
MODE_POISSON = 4   # c = scale·(exp(min(m, M)) − y_i)  (Poisson GLM, log link)

# Poisson link safeguard: beyond margin M the exponential is extended
# linearly (value) / frozen (coefficient), so exp never overflows f32.
POISSON_CLAMP = 30.0

# Shared memory a Hopper CTA may use (227 KB, opted in above 48 KB). A CTA
# of the row phase stages its R rows, z and four values per row there.
SMEM_BYTES = 232_448
# Widest row the kernel takes: one f32 row, z and a coefficient fit with
# room to spare.
MAX_COLS = 16_384

_STORAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _coeff_formula(mode, r, b_t, scale, aux=0.0):
    """Per-row coefficient c_i from the (dequantized) margin ``r`` for
    every oracle mode; ``mode`` may be a tensor (the scalars row)."""
    mode = torch.as_tensor(mode, device=r.device)
    c_lsq = scale * (r - b_t)
    c_log = -b_t * torch.sigmoid(-b_t * r)
    # Huber: clip(scale·(r−b), ±scale·δ) ≡ scale·clip(r−b, ±δ)
    c_hub = torch.clamp(c_lsq, -scale * aux, scale * aux)
    c_sqh = -scale * b_t * torch.clamp(1.0 - b_t * r, min=0.0)
    c_poi = scale * (torch.exp(torch.clamp(r, max=POISSON_CLAMP)) - b_t)
    return torch.where(
        mode == MODE_LSQ, c_lsq,
        torch.where(mode == MODE_LOGISTIC, c_log,
                    torch.where(mode == MODE_HUBER, c_hub,
                                torch.where(mode == MODE_SQHINGE, c_sqh,
                                            c_poi))))


def _value_formula(mode, r, b_t, scale, aux=0.0):
    """Per-row loss values f_i from the (dequantized) margin ``r`` for
    every oracle mode, the value-side twin of :func:`_coeff_formula`
    (PANOC's envelope needs f and ∇f from the same pass). Poisson's value
    (up to the x-independent log(y!)) is extended linearly past the clamp,
    C¹ with the frozen coefficient."""
    mode = torch.as_tensor(mode, device=r.device)
    res = r - b_t
    v_lsq = 0.5 * scale * res * res
    # stable log(1 + exp(t)), t = −y·r (b_t carries the labels y)
    t = -b_t * r
    v_log = torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-torch.abs(t)))
    a = torch.abs(res)
    v_hub = scale * torch.where(a <= aux, 0.5 * res * res,
                                aux * (a - 0.5 * aux))
    h = torch.clamp(1.0 - b_t * r, min=0.0)
    v_sqh = 0.5 * scale * h * h
    M = POISSON_CLAMP
    v_poi = scale * (torch.where(r <= M, torch.exp(torch.clamp(r, max=M)),
                                 math.exp(M) * (1.0 + (r - M))) - b_t * r)
    return torch.where(
        mode == MODE_LSQ, v_lsq,
        torch.where(mode == MODE_LOGISTIC, v_log,
                    torch.where(mode == MODE_HUBER, v_hub,
                                torch.where(mode == MODE_SQHINGE, v_sqh,
                                            v_poi))))


def _scalar(x, dev):
    """``x`` as a 0-d f32 tensor on ``dev``: a tensor is converted there,
    a Python number filled in on the device. ``torch.tensor(x,
    device=cuda)`` would copy from the host and sync the stream, which
    drains the queue of launches on every solver step that builds a
    scalars row."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def oracle_scalar_consts(F, g):
    """(scale, mode, lam, aux) of the kernel's scalars row, as f32
    tensors on the oracle's device (``lam`` keeps the prox's dtype),
    made there without a host copy."""
    dev = F.coeff_rows_data()[0].device
    lam = getattr(g, "lam", None)
    lam = _scalar(0.0, dev) if lam is None else lam.to(dev)
    return (_scalar(getattr(F, "scale", 1.0), dev),
            _scalar(F.coeff_mode, dev), lam,
            _scalar(getattr(F, "delta", 0.0), dev))


def _shape_ok(N: int, n: int, B=None) -> bool:
    """The shape half every kernel gate shares: ``n <= MAX_COLS`` and,
    for the block kernels (``B`` given), whole blocks of B rows."""
    return n <= MAX_COLS and (B is None or (0 < B and N % B == 0))


def full_grad_available(F, x0) -> bool:
    """Gate of :func:`coeff_apply_all`, the port's own: iterate and oracle
    rows on one CUDA device, f32 iterates, a dense-rows coefficient
    oracle (``coeff_rows_data``) with f32 offsets and f32, bf16 or int8
    rows, and ``n <= MAX_COLS``. The JAX gate's ``n % 128`` lanes and
    ``_pick_tile`` budget exist for the TPU alone."""
    if not (hasattr(F, "coeff_rows_data")
            and getattr(F, "supports_coeff", False)):
        return False
    A, b = F.coeff_rows_data()
    return (
        x0.device.type == "cuda"
        and A.device == x0.device
        and x0.dtype == torch.float32
        and A.dtype in _STORAGE_CODES
        and b.dtype == torch.float32
        and _shape_ok(*A.shape)
    )


def fused_block_available(N: int, n: int, B: int, dtype) -> bool:
    """The shape-and-dtype half of the port's block-kernel gates, in JAX's
    form ``(N, n, B, dtype)`` with JAX's meaning: ``dtype`` is the
    iterate's (``x0.dtype``). True for a CUDA device present, f32
    iterates, whole blocks (N % B == 0) and ``n <= MAX_COLS``: what
    ``_block_gate`` (kernels #1, #2) and :func:`saga_multistep_available`
    ask of the shapes and the iterate. The rows' storage (f32 or bf16 for
    #1 and #2; f32, bf16 or int8 for the coefficient kernels) and the
    offsets are the oracle's, which the gates the solvers call see: they
    take ``(F, g, x0, B)``, since they also need the oracle's formula mode
    and the prox. The JAX gate's TPU and ``n % 128`` rules exist for the
    TPU alone."""
    return (runtime.on_cuda() and dtype == torch.float32
            and _shape_ok(int(N), int(n), int(B)))


def coeff_multistep_available(N: int, n: int, B: int, dtype) -> bool:
    """Gate of the K-step coefficient kernels in JAX's ``(N, n, B,
    dtype)`` form: that of :func:`fused_block_available`. The JAX gate's
    (8, N/8) VMEM slab rules (N % (8·B), a 4 MB cap) have no counterpart:
    the port's coefficient table is a flat (N,) tensor in device
    memory."""
    return fused_block_available(N, n, B, dtype)


def saga_multistep_available(F, g, x0, B: int) -> bool:
    """Gate of the block-step kernels: that of
    :func:`full_grad_available`, whole blocks (N % B == 0) and an
    in-kernel prox (``NormL1`` or ``Zero``). No VMEM or lane rule carries
    over from the TPU kernel."""
    from ciao_tpu_torch.prox import NormL1, Zero

    return (isinstance(g, (NormL1, Zero)) and full_grad_available(F, x0)
            and _shape_ok(*F.coeff_rows_data()[0].shape, B))


def svrg_multistep_available(F, g, x0, B: int) -> bool:
    """Gate of :func:`svrg_coeff_multistep` and of the other SVRG-shaped
    kernels (Katyusha, SARAH, L-SVRG, L-Katyusha: JAX's one
    ``fused_inner_gate``): that of :func:`saga_multistep_available`. The
    JAX gate's N % (8·B) slab rule, ``_pick_tile`` ≥ 128 and ``batch > 1``
    exist for the TPU alone."""
    return saga_multistep_available(F, g, x0, B)


def saga_multistep_streamed_available(F, g, x0, B: int) -> bool:
    """Gate of the streamed kernel: that of :func:`saga_multistep_available`.
    The JAX gate's block minimum (d ≥ 64, for its birthday clamp) and row
    cap have no counterpart: the port does not clamp, and the table is a
    flat (N,) tensor in device memory."""
    return saga_multistep_available(F, g, x0, B)


def finito_multistep_available(F, g, x0, B: int) -> bool:
    """Gate of :func:`finito_coeff_multistep`: that of
    :func:`saga_multistep_available`. The JAX gate's slab, tile and VMEM
    rules (N % (8·B), d ≤ 1,024, 2 MB of anchors) exist for the TPU
    alone; the facade keeps its shape bounds only to pick this kernel
    over :func:`finito_coeff_multistep_streamed`."""
    return saga_multistep_available(F, g, x0, B)


def finito_multistep_streamed_available(F, g, x0, B: int) -> bool:
    """Gate of :func:`finito_coeff_multistep_streamed`: that of
    :func:`saga_multistep_available` (no block minimum: the port does
    not clamp)."""
    return saga_multistep_available(F, g, x0, B)


def lfinito_sweep_available(F, g, x0, B: int) -> bool:
    """Gate of :func:`lfinito_sweep_multistep` (and of its anchor pass,
    :func:`coeff_apply_all`): that of :func:`saga_multistep_available`."""
    return saga_multistep_available(F, g, x0, B)


def finito_block_available(F, x0, B: int) -> bool:
    """Gate of :func:`finito_block_update`, the port's own: iterate and
    rows on one CUDA device, f32 iterates, f32 or bf16 rows (int8 rows
    take the coefficient table: the f32 table traffic dominates) with
    f32 offsets, ``n <= MAX_COLS`` and whole blocks. The prox runs
    outside the kernel, so any prox will do."""
    return _block_gate(F, x0, B, "fused_finito_block")


def saga_block_available(F, x0, B: int) -> bool:
    """Gate of :func:`saga_block_update`: that of
    :func:`finito_block_available` (the JAX gate's ``n % 128`` lanes and
    ``_pick_tile`` budget exist for the TPU alone)."""
    return _block_gate(F, x0, B, "fused_saga_block")


def proshi_multistep_available(F, g, x0, B: int) -> bool:
    """Gate of :func:`proshi_multistep`, the port's own: that of
    :func:`full_grad_available` for a rank-1 row oracle with an
    in-kernel formula (``coeff_mode``), whole blocks, and an in-kernel
    coupling prox: ``Zero``, ``NormL1``, or ``IndBox`` with scalar
    bounds (either may be infinite). The JAX gate's ``n % 128`` lanes
    and ``_proshi_tile`` budget exist for the TPU alone."""
    from ciao_tpu_torch.prox import IndBox, NormL1, Zero

    if isinstance(g, IndBox):
        if g.lo.numel() != 1 or g.hi.numel() != 1:
            return False
    elif not isinstance(g, (NormL1, Zero)):
        return False
    return (hasattr(F, "coeff_mode") and full_grad_available(F, x0)
            and _shape_ok(*F.coeff_rows_data()[0].shape, B))


def _block_gate(F, x0, B: int, method: str) -> bool:
    if not hasattr(F, method):
        return False
    A, b = F.coeff_rows_data()
    return (x0.device.type == "cuda" and A.device == x0.device
            and x0.dtype == torch.float32
            and A.dtype in (torch.float32, torch.bfloat16)
            and F.coeff_rows_scale() is None and b.dtype == torch.float32
            and _shape_ok(*A.shape, B))


def _smem_bytes(rows: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one row-phase CTA of the table walk, as
    the rows rule counts it: the row tile rounded up to 16 bytes, then the
    margins' point (one (n,) vector) and four f32 values per row (one more
    than ``table_smem`` in ``csrc/table_rows.cuh`` stages)."""
    return -(-rows * n * itemsize // 16) * 16 + 4 * (n + 4 * rows)


def _rows_per_cta(B: int, n: int, itemsize: int) -> int:
    """Rows of the block each CTA of the row phase takes: the largest
    power of two up to 32 that divides B and whose tile fits in shared
    memory beside the staged (n,) point (32 at the headline B = 4096,
    n = 1024: 128 CTAs, about one per SM, with a 128 KB f32 tile)."""
    r = 32
    while B % r or _smem_bytes(r, n, itemsize) > SMEM_BYTES:
        r //= 2
    return r


def _lowp(A, precision: str) -> bool:
    """Whether both dot operands round to bf16 (the Pallas kernel's
    ``_stream_dot``): always for bf16 or int8 rows, and for f32 rows at
    ``precision="default"``."""
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', "
                         f"not {precision!r}")
    return A.dtype != torch.float32 or precision == "default"


def _soft(w, thr):
    """The L1 soft-threshold of the plain versions (NormL1's prox)."""
    return torch.sign(w) * torch.clamp(w.abs() - thr, min=0.0)


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def saga_coeff_multistep_ref(A, b, starts, c, z, av, scalars, B: int,
                             precision: str = "highest", rs=None,
                             wgts=None):
    """Plain PyTorch version of :func:`saga_coeff_multistep`: the same
    K steps as a Python loop of tensor ops, with the same bf16 roundings.
    Updates ``c``, ``z`` and ``av`` in place and returns them. On the
    card it needs exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "saga_coeff_multistep_ref")
    lowp = _lowp(A, precision)
    scale, gamma, thr, invB, invN, sag, mode, aux = scalars.unbind()
    ar = torch.arange(B, device=A.device)
    for k in range(starts.shape[0]):
        idx = starts[k].long() + ar
        A_t = A.index_select(0, idx).to(torch.float32)
        zq = z
        if lowp:
            A_t = _bf16_round(A_t)
            zq = _bf16_round(z)
        r = A_t @ zq
        rs_t = None if rs is None else rs[idx]
        if rs_t is not None:
            r = r * rs_t
        c_new = _coeff_formula(mode, r, b[idx], scale, aux)
        dc = c_new - c[idx]
        c.index_copy_(0, idx, c_new)
        if rs_t is not None:
            dc = dc * rs_t
        if lowp:
            dc = _bf16_round(dc)
        innov = dc @ A_t
        av_new = av + innov * invN
        wgt = 1.0 if wgts is None else wgts[k]
        # SAG refreshes the average before the direction (biased), SAGA
        # after (unbiased)
        w = torch.where(sag > 0, z - gamma * av_new,
                        z - gamma * (innov * (wgt * invB) + av))
        av.copy_(av_new)
        z.copy_(_soft(w, thr))
    return c, z, av


def saga_coeff_multistep_streamed_ref(A, b, starts, c, z, av, scalars,
                                      B: int, precision: str = "highest",
                                      rs=None, wgts=None, f=None):
    """Plain PyTorch version of :func:`saga_coeff_multistep_streamed`: the
    first ``f`` of the K steps of :func:`saga_coeff_multistep_ref` (all K
    when ``f`` is None); the masked steps k >= f leave c, z and av as
    they are. Reads ``f`` on the host."""
    live = starts.shape[0] if f is None else min(starts.shape[0], int(f))
    return saga_coeff_multistep_ref(
        A, b, starts[:live], c, z, av, scalars, B, precision=precision,
        rs=rs, wgts=None if wgts is None else wgts[:live])


_ARGTYPES = {
    # A, storage, lowp, b, rs, c, starts, f, wgts, z, av, sc, part, bar, n,
    # B, rows, ctas, stage_rows, stages, K, stream
    "saga_coeff_multistep_streamed": "PII" + "P" * 11 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, canch, starts, w, zs, av, sc, part, bar, n, B,
    # rows, ctas, stage_rows, stages, K, stream
    "svrg_coeff_multistep": "PII" + "P" * 10 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, z, sc, c, gsum, hi, lo, N, n, rows, ctas,
    # stream
    "coeff_apply_all": "PIIPPPPPPPPLIIIP",
    # A, storage, lowp, b, rs, z, sc, val, c, gsum, hi, lo, vhi, vlo, N, n,
    # rows, ctas, stream
    "coeff_value_apply_all": "PII" + "P" * 11 + "LIII" + "P",
    # A, storage, lowp, b, rs, c, starts, zb, invg, z, av, sc, part, bar, n,
    # B, rows, ctas, stage_rows, stages, K, stream
    "finito_coeff_multistep": "PII" + "P" * 11 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, c, starts, zb, invg_k, f, z, av, sc, part,
    # bar, n, B, rows, ctas, stage_rows, stages, K, stream
    "finito_coeff_multistep_streamed": "PII" + "P" * 12 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, canch, starts, invg, av, z, zf, sc, part, bar,
    # n, B, rows, ctas, stage_rows, stages, K, stream
    "lfinito_sweep_multistep": "PII" + "P" * 11 + "I" * 7 + "P",
    # A, storage, lowp, b, s, gamma, z, start, sc, part, innov, n, B, rows,
    # stream
    "finito_block_update": "PIIPPPPPPPPIIIP",
    # the same without gamma
    "saga_block_update": "PIIPPPPPPPIIIP",
    # A, storage, lowp, b, rs, gamma, starts, s, f, av, z, sc, part, bar, n,
    # B, rows, ctas, stage_rows, stages, K, stream
    "proshi_multistep": "PII" + "P" * 11 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, canch, starts, xt, y, z, ys, av, x, sc, part,
    # bar, n, B, rows, ctas, stage_rows, stages, K, stream
    "katyusha_coeff_multistep": "PII" + "P" * 13 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, starts, ww, v, sc, part, bar, n, B, rows,
    # ctas, stage_rows, stages, K, stream
    "sarah_multistep": "PII" + "P" * 8 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, canch, starts, stop, w, wpre, av, sc, part,
    # bar, n, B, rows, ctas, stage_rows, stages, K, stream
    "lsvrg_coeff_multistep": "PII" + "P" * 11 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, canch, starts, stop, wa, y, z, ypre, av, x,
    # sc, part, bar, n, B, rows, ctas, stage_rows, stages, K, stream
    "lkatyusha_coeff_multistep": "PII" + "P" * 14 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, c, starts, zb, f, y, x, gb, sc, part, bar, n,
    # B, rows, ctas, stage_rows, stages, K, stream
    "ssnm_multistep_streamed": "PII" + "P" * 12 + "I" * 7 + "P",
    # A, storage, lowp, b, rs, c, na, starts, mode, f, x, av, v, sc, part,
    # bar, n, B, rows, ctas, stage_rows, stages, K, stream
    "point_saga_multistep_streamed": ("PII" + "P" * 5 + "I" + "P" * 7
                                      + "I" * 7 + "P"),
}


def _kernel(name: str):
    fn = getattr(_build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        kinds = {"P": ctypes.c_void_p, "I": ctypes.c_int,
                 "L": ctypes.c_longlong}
        fn.argtypes = [kinds[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn


def _call(name: str, dev, *args) -> None:
    """Queue kernel ``name`` on the current stream of ``dev`` with the C
    arguments ``args`` (the stream is appended); raise on a CUDA error."""
    fn = _kernel(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the rows on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_f(f, dev):
    """A streamed kernel's clamp count as a (1,) int32 tensor on ``dev``
    (or None)."""
    if f is None:
        return None
    if f.numel() != 1:
        raise ValueError(f"f must hold one count, not {f.numel()}")
    f = f.reshape(1)
    _check("f", f, torch.int32, (1,), dev)
    return f


def _check_rows(A, b, rs):
    """Checks of the rows, offsets and dequant scales every kernel takes;
    returns (N, n)."""
    N, n = A.shape
    if A.dtype not in _STORAGE_CODES:
        raise TypeError(f"rows must be f32, bf16 or int8, not {A.dtype}")
    if (A.dtype == torch.int8) != (rs is not None):
        raise ValueError("rs is required iff the rows are int8")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    _check("b", b, torch.float32, (N,), A.device)
    if rs is not None:
        _check("rs", rs, torch.float32, (N,), A.device)
    return N, n


def _check_blocks(A, b, starts, B, rs):
    """Checks shared by every block-step kernel; returns (n, K)."""
    N, n = _check_rows(A, b, rs)
    K = starts.shape[0]
    # block starts are int32 on the device; row offsets are 64-bit there
    if N % B or K < 1 or n > MAX_COLS or N >= 2**31:
        raise ValueError(f"bad shape: N={N}, n={n}, B={B}, K={K}")
    _check("starts", starts, torch.int32, (K,), A.device)
    return n, K


def saga_coeff_multistep(A, b, starts, c, z, av, scalars, B: int,
                         precision: str = "highest", rs=None, wgts=None):
    """K = len(starts) SAGA/SAG coefficient-table block steps.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:saga_coeff_multistep``. Step k takes
    the block [starts[k], starts[k] + B) of the rows ``A`` (N, n), stored
    f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant scales),
    refreshes its coefficients in ``c`` (N,), adds the innovation
    Σ Δc_i·a_i to the running average ``av`` (n,), takes the SAGA or SAG
    direction — scaled by ``wgts[k]`` when given — and soft-thresholds
    ``z`` (n,) by γλ. ``scalars`` is the (8,) f32 row [scale, γ, γλ, 1/B,
    1/N, sag, mode, aux]. ``c``, ``z`` and ``av`` are updated in place
    (the Pallas kernel aliases its table the same way) and returned.

    CPU tensors take the plain version :func:`saga_coeff_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    On an H100 the step is bound by bytes: it must read the block's rows,
    B·n·itemsize bytes — 16 MB f32, 4 MB int8 at the headline B = 4096,
    n = 1024 — for 4·B·n flops. A TPU grid runs in order and carries z,
    av and the VMEM-resident table between steps; CUDA blocks do not, and
    step k+1's margins need z after step k's prox, which needs the whole
    block's reduction. The whole call is one cooperative launch of the
    persistent engine (``csrc/loopless_steps.cuh``, method
    ``kSagaSteps``): it is :func:`saga_coeff_multistep_streamed` with no
    clamp count, the same C entry and builds, so on block-aligned starts
    both give the same bits. The table is written every step and never
    prefetched: the formula thread of a row reads its old coefficient
    from L2 behind the barriers that end the previous step and writes the
    new one before the step's first barrier, so revisits inside a call
    read the previous visit's coefficients. A grid that cannot be
    resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return saga_coeff_multistep_ref(A, b, starts, c, z, av, scalars, B,
                                        precision=precision, rs=rs,
                                        wgts=wgts)
    if A.device.type != "cuda":
        raise ValueError(f"saga_coeff_multistep: no kernel for {A.device}")
    if wgts is not None:
        _check("wgts", wgts, torch.float32, (starts.shape[0],), A.device)
    _loopless_launch("saga_coeff_multistep_streamed", A, b, rs, dict(c=c),
                     starts, B, precision, scalars, 8, (None, _ptr(wgts)),
                     dict(z=z, av=av))
    saga_coeff_multistep.launches += 1
    saga_coeff_multistep.steps += starts.shape[0]
    saga_coeff_multistep.weighted_launches += wgts is not None
    return c, z, av


def saga_coeff_multistep_streamed(A, b, starts, c, z, av, scalars, B: int,
                                  precision: str = "highest", rs=None,
                                  wgts=None, f=None):
    """K = len(starts) SAGA/SAG coefficient-table block steps for any N,
    with the steps k ≥ ``f`` masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:saga_coeff_multistep_streamed``.
    Arguments and in-place updates are those of
    :func:`saga_coeff_multistep`, plus ``f``: the clamp count, a
    one-element int32 tensor on the rows' device, or None for K. A masked
    step writes nothing, so c, z and av leave the launch as step f − 1
    left them. CPU tensors take the plain version
    :func:`saga_coeff_multistep_streamed_ref`; CUDA tensors launch the
    kernel or raise.

    On the TPU the (1, N) table streams through aliased (1, TILE) VMEM
    windows, which is what lets that kernel serve any N, and a launch
    must not revisit a block: its stale in-window would race the aliased
    write-back of the first visit. So the JAX driver clamps each launch
    at its first repeated block (``f``), and ``_redirect_masked`` points
    the masked steps at a block with no committed visit, because a
    masked TPU step still writes its window back. Here c is a flat (N,)
    table in device memory, and a revisit inside a call reads the
    previous visit's c (below): the port's driver launches with ``f`` =
    None, and a masked step needs no redirect because it writes nothing.
    ``f`` stays a device tensor, read once on the device (no host sync):
    the call processes min(K, f) steps.

    The step is bound by the block's rows: 4 MiB f32, 1 MiB int8 at the
    deep target (N = 10,485,760, n = 128, B = 8,192). The whole call is
    one cooperative launch of the persistent engine of
    :func:`lsvrg_coeff_multistep` (``csrc/loopless_steps.cuh``, method
    ``kSagaSteps``): 128 CTAs of 64 rows at the deep target, each taking
    its rows as one stage of the ring the producer warp keeps loading
    ahead across steps, its 128-column rows split over eight row groups
    of one warp (one group would leave seven warps idle), and the finish
    of SAGA's average, direction and prox spread over every CTA between
    two grid barriers a step. The producer prefetches the rows, b and rs
    but not the table: the formula thread of a row reads its old
    coefficient from L2 when it takes the stage, after the barriers that
    end the previous step, and writes the new one before the step's
    first barrier, so revisits inside the call, aligned or not, read the
    previous visit's coefficients. Any start in [0, N − B] is taken. A
    grid that cannot be resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return saga_coeff_multistep_streamed_ref(
            A, b, starts, c, z, av, scalars, B, precision=precision, rs=rs,
            wgts=wgts, f=f)
    if A.device.type != "cuda":
        raise ValueError(f"saga_coeff_multistep_streamed: no kernel for "
                         f"{A.device}")
    f = _check_f(f, A.device)
    if wgts is not None:
        _check("wgts", wgts, torch.float32, (starts.shape[0],), A.device)
    _loopless_launch("saga_coeff_multistep_streamed", A, b, rs, dict(c=c),
                     starts, B, precision, scalars, 8,
                     (_ptr(f), _ptr(wgts)), dict(z=z, av=av))
    saga_coeff_multistep_streamed.launches += 1
    saga_coeff_multistep_streamed.steps += starts.shape[0]
    saga_coeff_multistep_streamed.weighted_launches += wgts is not None
    return c, z, av


# ---------------------------------------------------------------------------
# kernel #5: SVRG inner block steps against the anchor coefficient table
# ---------------------------------------------------------------------------

def svrg_coeff_multistep_ref(A, b, starts, canch, w, zs, av, scalars,
                             B: int, precision: str = "highest", rs=None):
    """Plain PyTorch version of :func:`svrg_coeff_multistep`: the same K
    inner steps as a Python loop of tensor ops, with the same bf16
    roundings. Updates ``w`` and ``zs`` in place and returns them. On the
    card it needs exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "svrg_coeff_multistep_ref")
    lowp = _lowp(A, precision)
    scale, gamma, thr, invB, mode, aux = scalars.unbind()
    ar = torch.arange(B, device=A.device)
    for k in range(starts.shape[0]):
        idx = starts[k].long() + ar
        A_t = A.index_select(0, idx).to(torch.float32)
        wq = w
        if lowp:
            A_t = _bf16_round(A_t)
            wq = _bf16_round(w)
        r = A_t @ wq
        rs_t = None if rs is None else rs[idx]
        if rs_t is not None:
            r = r * rs_t
        dc = canch[idx] - _coeff_formula(mode, r, b[idx], scale, aux)
        if rs_t is not None:
            dc = dc * rs_t
        if lowp:
            dc = _bf16_round(dc)
        d = (dc @ A_t) * invB
        v = w + gamma * (d - av)
        w.copy_(_soft(v, thr))
        zs.add_(w)
    return w, zs


def svrg_coeff_multistep(A, b, starts, canch, w, zs, av, scalars, B: int,
                         precision: str = "highest", rs=None):
    """K = len(starts) SVRG inner block steps (SVRG_basic.jl:74-81).

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:svrg_coeff_multistep``. Step k takes
    the block [starts[k], starts[k] + B) of the rows ``A`` (N, n), stored
    f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant scales),
    forms d = (1/B)·Σ (canch_i − c_i(w))·a_i against the anchor
    coefficients ``canch`` (N,), steps w ← soft(w + γ(d − av), γλ) and
    adds w to the running sum ``zs``. ``av`` is the anchor's mean
    gradient (n,); ``scalars`` the (6,) f32 row [scale, γ, γλ, 1/B, mode,
    aux]. ``w`` and ``zs`` are updated in place and returned; ``canch``
    and ``av`` are read only.

    CPU tensors take the plain version :func:`svrg_coeff_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    A step must read the block's rows, B·n·itemsize bytes (16 MiB f32,
    4 MiB int8 at B = 4,096, n = 1,024); the anchor coefficients are
    read, never written. The step is :func:`lsvrg_coeff_multistep`'s
    plus the running sum, and so is the engine: the whole call is one
    cooperative launch of ``csrc/loopless_steps.cuh`` (method
    ``kSvrgSteps``), whose finish also adds each step's w to zs on its
    columns. A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return svrg_coeff_multistep_ref(A, b, starts, canch, w, zs, av,
                                        scalars, B, precision=precision,
                                        rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"svrg_coeff_multistep: no kernel for {A.device}")
    _loopless_launch("svrg_coeff_multistep", A, b, rs, dict(canch=canch),
                     starts, B, precision, scalars, 6, (),
                     dict(w=w, zs=zs, av=av))
    svrg_coeff_multistep.launches += 1
    svrg_coeff_multistep.steps += starts.shape[0]
    return w, zs


# ---------------------------------------------------------------------------
# kernel #6: one compensated pass over all rows (anchor, full gradient)
# ---------------------------------------------------------------------------

# The one-pass walk's tiles (``csrc/apply_rows.cuh``), whole rows in a ring
# of APPLY_STAGES stages, at most APPLY_MAX_ROWS (the value column takes one
# row a thread of the CTA's APPLY_THREADS). Up to APPLY_NARROW_COLS columns
# (16 register columns a thread) two CTAs share an SM, each in half of its
# shared memory (less the 1 KB the card reserves per CTA), with tiles of as
# many rows as fit APPLY_TILE_BYTES and the half; wider rows take the wide
# walk (64 register columns a thread), one CTA an SM, its tiles as many rows
# as fit all of the SM's shared memory.
APPLY_TILE_BYTES = 48 * 1024
APPLY_THREADS = 256
APPLY_MAX_ROWS = APPLY_THREADS
APPLY_STAGES = 2
APPLY_CTAS_PER_SM = 2
APPLY_NARROW_COLS = 16 * APPLY_THREADS


def _two_sum(hi, lo, p):
    """Knuth two-sum: (hi, lo) ← (hi, lo) + p with the rounding error of
    the add kept exactly in the compensation term (``_comp_add`` of the
    JAX module). Separate eager tensor operations, which no compiler
    contracts."""
    s = hi + p
    t = s - hi
    e = (p - t) + (hi - (s - t))
    return s, lo + e


def _apply_smem_bytes(rows: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one CTA of the walk (``apply_smem_bytes``
    in ``csrc/apply_rows.cuh``): APPLY_STAGES row tiles, z, two f32 a row
    (the weighted coefficient, the margin), b and rs of each stage's rows,
    four f32 a thread (the row slices' partials), the warps' value sums
    and the ring's barriers."""
    tile = -(-rows * n * itemsize // 16) * 16
    return (APPLY_STAGES * tile + -(-4 * n // 16) * 16
            + 8 * rows * (1 + APPLY_STAGES) + 16 * APPLY_THREADS
            + 4 * (APPLY_THREADS // 32) + 8 * APPLY_STAGES)


def _apply_rows(n: int, itemsize: int) -> int:
    """Rows of a tile of the walk, shared by the kernels #6 and #7 and their
    plain versions, 1 to APPLY_MAX_ROWS: up to APPLY_NARROW_COLS columns as
    many whole rows as fit APPLY_TILE_BYTES and half of the SM's shared
    memory (256 int8 and 96 f32 rows at n = 128; 48 int8, 24 bf16 and 12
    f32 rows at n = 1,024: 48 KB tiles; 11 int8 and 2 f32 rows at n =
    4,096), beyond as many as fit all of it (the wide walk: 11 int8 and 2
    f32 rows at n = 8,192, one f32 row at n = 16,384)."""
    per_sm = _apply_ctas_per_sm(n)
    budget = SMEM_BYTES if per_sm == 1 else SMEM_BYTES // per_sm - 1024
    fixed = _apply_smem_bytes(0, n, itemsize)
    rows = (budget - fixed) // (APPLY_STAGES * n * itemsize
                                + 8 * (1 + APPLY_STAGES))
    if per_sm > 1:
        rows = min(rows, APPLY_TILE_BYTES // (n * itemsize))
    rows = max(1, min(APPLY_MAX_ROWS, rows))
    while rows > 1 and _apply_smem_bytes(rows, n, itemsize) > budget:
        rows -= 1  # the 16-byte rounding of a tile
    return rows


def _apply_ctas_per_sm(n: int) -> int:
    """CTAs of the walk an SM holds: two up to APPLY_NARROW_COLS columns,
    one in the wide walk (its 64 register columns a thread take the SM's
    registers)."""
    return APPLY_CTAS_PER_SM if n <= APPLY_NARROW_COLS else 1


def _comp_sum_rows(p):
    """Σ over the rows of ``p`` (T, n), two-sum compensated: a pairwise
    tree whose every add keeps its rounding error in a (T, n) carry."""
    hi, lo = p, torch.zeros_like(p)
    while hi.shape[0] > 1:
        if hi.shape[0] % 2:
            pad = hi.new_zeros((1, hi.shape[1]))
            hi, lo = torch.cat([hi, pad]), torch.cat([lo, pad])
        hi, lo = _two_sum(hi[0::2], lo[0::2] + lo[1::2], hi[1::2])
    return hi[0] + lo[0]


def _apply_margins_ref(A, z, precision, rs):
    """The rows as the dots see them (f32, bf16-rounded when ``_lowp``)
    and the dequantized margins A·z of the plain versions of #6 and #7.
    Each margin is summed in f64 and rounded once to f32: the margin any
    f32 summation order approaches. An f32 product of the library's own
    order lands one to three ulps from it, as far as the kernel's order
    does, and the two errors add up in a comparison: where a formula
    clips the residual, three ulps of a margin between 2 and 4 are 1.4e-6
    of a Huber c clipped at δ = 0.5."""
    lowp = _lowp(A, precision)
    A_f = A.to(torch.float32)
    zq = z
    if lowp:
        A_f = _bf16_round(A_f)
        zq = _bf16_round(z)
    step = max(1, 2**27 // max(A.shape[1], 1))  # 1 GiB of f64 rows a chunk
    zd = zq.double()
    r = torch.cat([A_f[i:i + step].double() @ zd
                   for i in range(0, A.shape[0], step)]).float()
    if rs is not None:
        r = r * rs
    return A_f, r, lowp


def _apply_gsum_ref(A_f, c, rs, lowp, R: int):
    """Σ c_i·a_i (·rs_i) of the plain versions: each R-row tile's partial
    as a batched product, the tiles' partials added by a compensated
    pairwise tree."""
    N, n = A_f.shape
    cw = c if rs is None else c * rs
    if lowp:
        cw = _bf16_round(cw)
    T = N // R
    parts = torch.bmm(cw[:T * R].view(T, 1, R),
                      A_f[:T * R].view(T, R, n)).view(T, n)
    if N % R:
        parts = torch.cat([parts, (cw[T * R:] @ A_f[T * R:])[None]])
    return _comp_sum_rows(parts)


def coeff_apply_all_ref(A, b, z, scalars, precision: str = "highest",
                        rs=None):
    """Plain PyTorch version of :func:`coeff_apply_all`, with the same
    bf16 roundings and tiles: the margins as one product, the formula,
    each tile's Σ c_i·a_i as a batched product, and the tiles' partials
    added by a compensated pairwise tree. Returns new (c, gsum). On the
    card it needs exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "coeff_apply_all_ref")
    scale, mode, aux = scalars.unbind()
    A_f, r, lowp = _apply_margins_ref(A, z, precision, rs)
    c = _coeff_formula(mode, r, b, scale, aux)
    return c, _apply_gsum_ref(A_f, c, rs, lowp,
                              _apply_rows(A.shape[1], A.element_size()))


def _check_apply(A, b, z, scalars, rs):
    N, n = _check_rows(A, b, rs)
    if N < 1 or n > MAX_COLS:
        raise ValueError(f"bad shape: N={N}, n={n}")
    _check("z", z, torch.float32, (n,), A.device)
    _check("scalars", scalars, torch.float32, (3,), A.device)
    return N, n


def _apply_ctas(dev, N: int, n: int, rows: int) -> int:
    """CTAs of the walk: :func:`_apply_ctas_per_sm` on each SM, at most
    one per tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return min(-(-N // rows), _apply_ctas_per_sm(n) * sms)


def coeff_apply_all(A, b, z, scalars, precision: str = "highest", rs=None):
    """One pass over all N rows: returns ``(c, gsum)``, the (N,)
    coefficients c_i = c(a_i·z) and the (n,) gradient sum Σ c_i·a_i
    (·rs_i for int8 rows), two-sum compensated across tiles.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:coeff_apply_all``: the SVRG anchor
    refresh and the forward-backward full gradient, in place of
    ``coeff_all`` + ``apply_all`` (two reads of A). ``A`` (N, n) is
    stored f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant
    scales); ``b`` is (N,), ``z`` (n,), ``scalars`` the (3,) f32 row
    [scale, mode, aux]. Any N; the caller divides gsum by N.

    CPU tensors take the plain version :func:`coeff_apply_all_ref`; CUDA
    tensors launch the kernel or raise.

    On an H100 the pass is bound by bytes: it must read A once, N·n·
    itemsize bytes (1 GiB f32, 256 MiB int8 at 262,144 × 1,024), for 4·N·n
    flops (16 µs of the card's f32 rate there, against 87-350 µs of
    bytes), so it uses no tensor cores. The TPU kernel walks its tiles in
    grid order and carries the (hi, lo) pair in VMEM; here the CTAs each
    walk every G-th tile of R whole rows (:func:`_apply_rows`) in a ring
    of two stages that one thread fills by bulk copies (``cp.async.bulk``
    on an mbarrier): up to n = 4,096 two CTAs an SM with tiles of up to
    48 KB (256 rows at n = 128 int8, 12-48 at n = 1,024), so that while
    an SM's two CTAs use a tile each, two more are in flight; wider rows
    one CTA an SM with tiles as large as its shared memory allows. Groups
    of 8-32 lanes form eight rows' margins at once (a tile of few rows
    splits each row over several groups); every thread owns fixed columns
    (16, or 64 past n = 4,096) and a row slice of the column sums, and
    two-sums each tile's partial into its (hi, lo) registers; a second
    launch combines the G pairs per column in a fixed order. int8 values
    are widened by the byte-permute trick, bf16 by a shift, and f32 rows
    at "default" are rounded to bf16 once a value: no I2F or F2F per use.
    No atomics: runs repeat bit for bit. The compensation's adds are
    ``__fadd_rn``/``__fsub_rn``, which ``-O3`` may not contract or
    reassociate. The design note is ``csrc/apply_rows.cuh``'s.
    """
    if A.device.type == "cpu":
        return coeff_apply_all_ref(A, b, z, scalars, precision=precision,
                                   rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"coeff_apply_all: no kernel for {A.device}")
    N, n = _check_apply(A, b, z, scalars, rs)
    dev, f32 = A.device, torch.float32
    lowp = _lowp(A, precision)
    rows = _apply_rows(n, A.element_size())
    ctas = _apply_ctas(dev, N, n, rows)
    c = torch.empty(N, dtype=f32, device=dev)
    gsum = torch.empty(n, dtype=f32, device=dev)
    hi = torch.empty((ctas, n), dtype=f32, device=dev)
    lo = torch.empty((ctas, n), dtype=f32, device=dev)
    _call("coeff_apply_all", dev, A.data_ptr(), _STORAGE_CODES[A.dtype],
          int(lowp), b.data_ptr(), _ptr(rs), z.data_ptr(), scalars.data_ptr(),
          c.data_ptr(), gsum.data_ptr(), hi.data_ptr(), lo.data_ptr(), N, n,
          rows, ctas)
    coeff_apply_all.launches += 1
    return c, gsum


def oracle_apply_all(F, z, precision: str = "highest"):
    """:func:`coeff_apply_all` on a dense-rows oracle's rows, offsets,
    formula constants and dequant scales: ``(c(z), Σ c_i·a_i)``, the SVRG
    anchor and the full gradient sum in one pass."""
    rows, offs = F.coeff_rows_data()
    scale, mode, _, aux = oracle_scalar_consts(F, None)
    return coeff_apply_all(rows, offs, z, torch.stack([scale, mode, aux]),
                           precision=precision, rs=F.coeff_rows_scale())


# ---------------------------------------------------------------------------
# kernel #7: the same pass with the loss sum (PANOC/ZeroFPR envelope)
# ---------------------------------------------------------------------------

def coeff_value_apply_all_ref(A, b, z, scalars, precision: str = "highest",
                              rs=None):
    """Plain PyTorch version of :func:`coeff_value_apply_all`: that of
    :func:`coeff_apply_all` at the kernel's tile of R rows, and the loss
    sum as the kernel forms it: each tile's values, padded with zeros to
    W = ⌈R/32⌉ warps of 32 lanes, each warp's 32 added by the kernel's
    xor-shuffle tree in f32 (lane i and lane i + 16, then + 8, ...), the W
    warp sums added in warp order, the tiles' sums added by a compensated
    pairwise tree. Returns new (val, c, gsum), val 0-d. On the card it
    needs exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "coeff_value_apply_all_ref")
    scale, mode, aux = scalars.unbind()
    A_f, r, lowp = _apply_margins_ref(A, z, precision, rs)
    c = _coeff_formula(mode, r, b, scale, aux)
    v = _value_formula(mode, r, b, scale, aux)
    N, n = A.shape
    R = _apply_rows(n, A.element_size())
    T, W = -(-N // R), -(-R // 32)
    tv = torch.cat([v, v.new_zeros(T * R - N)]).view(T, R)
    tv = torch.cat([tv, tv.new_zeros(T, 32 * W - R)], dim=1).view(T, W, 32)
    while tv.shape[2] > 1:
        half = tv.shape[2] // 2
        tv = tv[..., :half] + tv[..., half:]
    tile = tv[:, 0, 0]
    for w in range(1, W):
        tile = tile + tv[:, w, 0]
    val = _comp_sum_rows(tile[:, None])[0]
    return val, c, _apply_gsum_ref(A_f, c, rs, lowp, R)


def coeff_value_apply_all(A, b, z, scalars, precision: str = "highest",
                          rs=None):
    """PANOC's envelope read in one pass over all N rows: returns
    ``(val, c, gsum)``, the 0-d loss sum Σ f_i(z), the (N,) coefficients
    c_i = c(a_i·z) and the (n,) gradient sum Σ c_i·a_i (·rs_i for int8
    rows), both sums two-sum compensated across tiles.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:coeff_value_apply_all`` (in place of the
    oracle's ``value_sum_and_grad_sum_all``, two reads of A). Operands as
    :func:`coeff_apply_all`'s; the caller divides by N.

    CPU tensors take the plain version :func:`coeff_value_apply_all_ref`;
    CUDA tensors launch the kernel or raise.

    Kernel #6's pass (``csrc/apply_rows.cuh``) with a value column, bound
    by the same bytes (A read once, c written once): each row's value
    comes from the margin its coefficient comes from; after each tile,
    warp w computes the values of the tile's rows 32w .. 32w + 31 one lane
    a row and adds them by a fixed shuffle tree, the warps' sums are added
    in warp order and two-summed into the CTA's (hi, lo) value pair, and
    the finish launch combines the G pairs in a fixed order beside the
    columns. The value formula's logistic and Poisson terms use
    ``log1pf``/``expf``. c and gsum equal kernel #6's bit for bit (the
    same tiles); runs repeat bit for bit.
    """
    if A.device.type == "cpu":
        return coeff_value_apply_all_ref(A, b, z, scalars,
                                         precision=precision, rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"coeff_value_apply_all: no kernel for {A.device}")
    N, n = _check_apply(A, b, z, scalars, rs)
    dev, f32 = A.device, torch.float32
    lowp = _lowp(A, precision)
    rows = _apply_rows(n, A.element_size())
    ctas = _apply_ctas(dev, N, n, rows)
    val = torch.empty((), dtype=f32, device=dev)
    c = torch.empty(N, dtype=f32, device=dev)
    gsum = torch.empty(n, dtype=f32, device=dev)
    hi = torch.empty((ctas, n), dtype=f32, device=dev)
    lo = torch.empty((ctas, n), dtype=f32, device=dev)
    vpart = torch.empty((2, ctas), dtype=f32, device=dev)
    _call("coeff_value_apply_all", dev, A.data_ptr(), _STORAGE_CODES[A.dtype],
          int(lowp), b.data_ptr(), _ptr(rs), z.data_ptr(), scalars.data_ptr(),
          val.data_ptr(), c.data_ptr(), gsum.data_ptr(), hi.data_ptr(),
          lo.data_ptr(), vpart[0].data_ptr(), vpart[1].data_ptr(), N, n, rows,
          ctas)
    coeff_value_apply_all.launches += 1
    return val, c, gsum


def oracle_value_apply_all(F, z, precision: str = "highest"):
    """:func:`coeff_value_apply_all` on a dense-rows oracle:
    ``(Σ f_i(z), c(z), Σ c_i·a_i)``, the envelope's value and gradient
    sums in one pass."""
    rows, offs = F.coeff_rows_data()
    scale, mode, _, aux = oracle_scalar_consts(F, None)
    return coeff_value_apply_all(rows, offs, z,
                                 torch.stack([scale, mode, aux]),
                                 precision=precision, rs=F.coeff_rows_scale())


# ---------------------------------------------------------------------------
# kernels #9, #14: Finito coefficient-table block steps
# ---------------------------------------------------------------------------

def _finito_steps_ref(A, b, starts, c, zb, ig_of, z, av, scalars, B: int,
                      precision: str, rs, who: str):
    """The Finito coefficient steps of both plain versions; ``ig_of(k,
    j)`` is step k's Σ 1/γ_i of block j."""
    runtime.require_exact_f32_matmul(A.device, who)
    lowp = _lowp(A, precision)
    scale, inv_n, hat, thr, mode, aux = scalars.unbind()
    ar = torch.arange(B, device=A.device)
    for k in range(starts.shape[0]):
        j = (starts[k].long() // B).view(1)
        idx = starts[k].long() + ar
        A_t = A.index_select(0, idx).to(torch.float32)
        zq = z
        if lowp:
            A_t = _bf16_round(A_t)
            zq = _bf16_round(z)
        r = A_t @ zq
        rs_t = None if rs is None else rs[idx]
        if rs_t is not None:
            r = r * rs_t
        c_new = _coeff_formula(mode, r, b[idx], scale, aux)
        dc = c_new - c[idx]
        c.index_copy_(0, idx, c_new)
        if rs_t is not None:
            dc = dc * rs_t
        if lowp:
            dc = _bf16_round(dc)
        zb_j = zb.index_select(0, j)[0]
        av.add_((hat * ig_of(k, j[0])) * (z - zb_j)
                - (hat * inv_n) * (dc @ A_t))
        zb.index_copy_(0, j, z[None])
        z.copy_(_soft(av, thr))
    return c, zb, z, av


def finito_coeff_multistep_ref(A, b, starts, c, zb, invg, z, av, scalars,
                               B: int, precision: str = "highest", rs=None):
    """Plain PyTorch version of :func:`finito_coeff_multistep`: the same K
    steps as a Python loop of tensor ops, with the same bf16 roundings.
    Updates ``c``, ``zb``, ``z`` and ``av`` in place and returns them. On
    the card it needs exact f32 products, which it checks and does not
    set."""
    return _finito_steps_ref(A, b, starts, c, zb, lambda k, j: invg[j], z,
                             av, scalars, B, precision, rs,
                             "finito_coeff_multistep_ref")


def finito_coeff_multistep_streamed_ref(A, b, starts, invg_k, c, zb, z, av,
                                        scalars, B: int,
                                        precision: str = "highest", rs=None,
                                        f=None):
    """Plain PyTorch version of :func:`finito_coeff_multistep_streamed`:
    the first ``f`` of the K steps (all K when ``f`` is None), step k's
    Σ 1/γ_i being ``invg_k[k]``; the masked steps leave c, zb, z and av as
    they are. Reads ``f`` on the host."""
    live = starts.shape[0] if f is None else min(starts.shape[0], int(f))
    return _finito_steps_ref(A, b, starts[:live], c, zb,
                             lambda k, j: invg_k[k], z, av, scalars, B,
                             precision, rs,
                             "finito_coeff_multistep_streamed_ref")


def _check_anchors(A, zb, B):
    """Finito's (d, n) per-block anchors or SSNM's stored points: a
    stride-0 view (``expand``) would make every row one, and the kernels
    write rows of zb, so it must own each."""
    _check("zb", zb, torch.float32, (A.shape[0] // B, A.shape[-1]), A.device)


def finito_coeff_multistep(A, b, starts, c, zb, invg, z, av, scalars,
                           B: int, precision: str = "highest", rs=None):
    """K = len(starts) Finito-basic coefficient-table block steps
    (Finito_basic.jl:110-118 in the coefficient parameterization).

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:finito_coeff_multistep``. Step k takes
    block j = starts[k] / B of the rows ``A`` (N, n), stored f32, bf16 or
    int8 (then ``rs`` holds the (N,) f32 dequant scales): it refreshes the
    block's coefficients in ``c`` (N,), forms innov = hat·invg_j·(z −
    zb_j) − (hat/N)·Σ Δc_i·a_i, adds it to ``av`` (n,), sets the block's
    anchor zb_j ← z in ``zb`` (d, n) and z ← soft(av, hat·λ). ``invg``
    (d,) holds each block's Σ 1/γ_i by block id; ``scalars`` the (6,) f32
    row [scale, 1/N, hat, hat·λ, mode, aux]. ``c``, ``zb``, ``z`` and
    ``av`` are updated in place and returned; ``zb`` must own its rows
    (not an ``expand`` view).

    CPU tensors take the plain version :func:`finito_coeff_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    The step is bound by the block's rows, B·n·itemsize bytes (16 MB f32,
    4 MB int8 at the 262,144 × 1,024 headline's B = 4,096), plus one
    anchor row read and written. The whole call is one cooperative launch
    of the persistent engine (``csrc/loopless_steps.cuh``, method
    ``kFinitoSteps``): the row phase is
    :func:`saga_coeff_multistep_streamed`'s, whose formula threads read
    each row's old coefficient from L2 when they take its stage and write
    the new one before the step's first grid barrier; the finish, between
    the step's two grid barriers, reads block j's anchor row and Σ 1/γ
    from device memory (no d ≤ 1,024 cap, as the TPU's SMEM row had) and
    writes the row back on the CTA's columns. Everything the call writes
    (c, zb, z, av) is read back by coherent loads, so a block revisited
    within the call sees the previous visit's c and zb. A grid that
    cannot be resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return finito_coeff_multistep_ref(A, b, starts, c, zb, invg, z, av,
                                          scalars, B, precision=precision,
                                          rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"finito_coeff_multistep: no kernel for {A.device}")
    _check_anchors(A, zb, B)
    _check("invg", invg, torch.float32, (A.shape[0] // B,), A.device)
    _loopless_launch("finito_coeff_multistep", A, b, rs, dict(c=c), starts,
                     B, precision, scalars, 6,
                     (zb.data_ptr(), invg.data_ptr()), dict(z=z, av=av))
    finito_coeff_multistep.launches += 1
    finito_coeff_multistep.steps += starts.shape[0]
    return c, zb, z, av


def finito_coeff_multistep_streamed(A, b, starts, invg_k, c, zb, z, av,
                                    scalars, B: int,
                                    precision: str = "highest", rs=None,
                                    f=None):
    """K = len(starts) Finito coefficient-table block steps for any N,
    with the steps k ≥ ``f`` masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:finito_coeff_multistep_streamed``.
    Arguments and in-place updates are those of
    :func:`finito_coeff_multistep`, except ``invg_k`` (K,): step k's
    Σ 1/γ_i, pre-gathered by step (JAX's contract), and ``f``: the clamp
    count, a one-element int32 tensor on the rows' device, or None for K.
    A masked step writes neither c nor zb nor z nor av. CPU tensors take
    the plain version :func:`finito_coeff_multistep_streamed_ref`; CUDA
    tensors launch the kernel or raise.

    The TPU kernel streams c through aliased windows and keeps zb in
    VMEM, so its driver clamps each launch at the first same-launch
    revisit. Here c and zb live in device memory: the port's driver
    launches with ``f`` = None, and the ``f < K`` semantics stay for the
    tests. The whole call is one cooperative launch of the persistent
    engine (``csrc/loopless_steps.cuh``, method ``kFinitoStreamSteps``),
    :func:`finito_coeff_multistep`'s method but for two reads: step k's
    Σ 1/γ is ``invg_k[k]``, and ``f`` is read once on the device (no host
    sync), the call processing min(K, f) steps. At the 10,485,760 × 128
    deep shape (B = 8,192) a step reads 4 MB of f32 rows (1 MB int8): 128
    CTAs of 64 rows, one stage a step, the rows split over eight row
    groups of a warp, as :func:`saga_coeff_multistep_streamed` takes
    them. Everything the call writes (c, zb, z, av) is read back by
    coherent loads behind the engine's grid barriers, so a block
    revisited within the call sees the previous visit's c and zb. A grid
    that cannot be resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return finito_coeff_multistep_streamed_ref(
            A, b, starts, invg_k, c, zb, z, av, scalars, B,
            precision=precision, rs=rs, f=f)
    if A.device.type != "cuda":
        raise ValueError(f"finito_coeff_multistep_streamed: no kernel for "
                         f"{A.device}")
    f = _check_f(f, A.device)
    _check_anchors(A, zb, B)
    _check("invg_k", invg_k, torch.float32, (starts.shape[0],), A.device)
    _loopless_launch("finito_coeff_multistep_streamed", A, b, rs, dict(c=c),
                     starts, B, precision, scalars, 6,
                     (zb.data_ptr(), invg_k.data_ptr(), _ptr(f)),
                     dict(z=z, av=av))
    finito_coeff_multistep_streamed.launches += 1
    finito_coeff_multistep_streamed.steps += starts.shape[0]
    return c, zb, z, av


# ---------------------------------------------------------------------------
# kernel #8: an LFinito block sweep against the epoch's anchor
# ---------------------------------------------------------------------------

def lfinito_sweep_multistep_ref(A, b, canch, starts, av, zf, invg, scalars,
                                B: int, precision: str = "highest", rs=None):
    """Plain PyTorch version of :func:`lfinito_sweep_multistep`: the same
    K block steps as a Python loop of tensor ops, with the same bf16
    roundings. Updates ``av`` in place; returns ``(av, z)``. On the card
    it needs exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "lfinito_sweep_multistep_ref")
    lowp = _lowp(A, precision)
    scale, hat, thr, inv_n, mode, aux = scalars.unbind()
    ar = torch.arange(B, device=A.device)
    z = av
    for k in range(starts.shape[0]):
        z = _soft(av, thr)      # the block's start (Finito_LFinito.jl:92)
        idx = starts[k].long() + ar
        A_t = A.index_select(0, idx).to(torch.float32)
        zq = z
        if lowp:
            A_t = _bf16_round(A_t)
            zq = _bf16_round(z)
        r = A_t @ zq
        rs_t = None if rs is None else rs[idx]
        if rs_t is not None:
            r = r * rs_t
        dc = canch[idx] - _coeff_formula(mode, r, b[idx], scale, aux)
        if rs_t is not None:
            dc = dc * rs_t
        if lowp:
            dc = _bf16_round(dc)
        av.add_((hat * inv_n) * (dc @ A_t) + (hat * invg[k]) * (z - zf))
    return av, z.clone()


def lfinito_sweep_multistep(A, b, canch, starts, av, zf, invg, scalars,
                            B: int, precision: str = "highest", rs=None):
    """K = len(starts) LFinito block steps (Finito_LFinito.jl:91-101).

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:lfinito_sweep_multistep``. Step k
    visits block starts[k] of the rows ``A`` (N, n), stored f32, bf16 or
    int8 (then ``rs`` holds the (N,) f32 dequant scales): z = soft(av,
    hat·λ) at the block's start, then av += (hat/N)·Σ (canch_i −
    c_i(z))·a_i + hat·invg[k]·(z − zf), against the epoch's anchor
    coefficients ``canch`` (N,) at the anchor point ``zf`` (n,). ``invg``
    (K,) holds the visited blocks' Σ 1/γ_i in visit order; ``scalars``
    the (6,) f32 row [scale, hat, hat·λ, 1/N, mode, aux]. ``av`` is
    updated in place; returns ``(av, z)`` with z the LAST block's prox
    point (``LFinitoState.z``), not soft(av) of the returned av. No z
    comes in: each block forms its own.

    CPU tensors take the plain version :func:`lfinito_sweep_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    The step is :func:`svrg_coeff_multistep`'s row phase against the
    anchor coefficients (read, never written), bound by the block's rows,
    B·n·itemsize bytes (4 MB f32, 1 MB int8 at the 10,485,760 × 128 deep
    shape's B = 8,192). The TPU kernel carries av and z in VMEM and forms
    z at each block's first tile. Here the whole call is one cooperative
    launch of the persistent engine (``csrc/loopless_steps.cuh``, method
    ``kLFinitoSteps``; at the deep shape 128 CTAs of 64 rows, one stage a
    step, the 128-column rows split over eight row groups): every CTA
    forms the first block's z = soft(av) on all columns before its first
    grid barrier (writing its own finish columns of z), the finish of
    step k, between two grid barriers, steps av and forms step k+1's z on
    the CTA's columns, and the last finish leaves z as the returned prox
    point. A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return lfinito_sweep_multistep_ref(A, b, canch, starts, av, zf, invg,
                                           scalars, B, precision=precision,
                                           rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"lfinito_sweep_multistep: no kernel for {A.device}")
    _check("invg", invg, torch.float32, (starts.shape[0],), A.device)
    z = torch.empty(A.shape[-1], dtype=torch.float32, device=A.device)
    _loopless_launch("lfinito_sweep_multistep", A, b, rs, dict(canch=canch),
                     starts, B, precision, scalars, 6, (invg.data_ptr(),),
                     dict(av=av, z=z, zf=zf))
    lfinito_sweep_multistep.launches += 1
    lfinito_sweep_multistep.steps += starts.shape[0]
    return av, z


# Blocks per launch of the LFinito sweep driver (JAX's chunk).
LFINITO_CHUNK = 512


def lfinito_sweep_chunked(A, b, canch, starts, invg_v, av, zf, scalars,
                          B: int, precision: str = "highest", rs=None,
                          chunk: int = LFINITO_CHUNK):
    """A whole epoch's block sweep (visit order ``starts``, the visited
    blocks' Σ 1/γ_i in ``invg_v``) as launches of at most ``chunk``
    blocks of :func:`lfinito_sweep_multistep`, av carried across them (in
    place). Returns ``(av, z)``, z the last block's prox point."""
    z = None
    for k0 in range(0, starts.shape[0], chunk):
        av, z = lfinito_sweep_multistep(
            A, b, canch, starts[k0:k0 + chunk], av, zf,
            invg_v[k0:k0 + chunk], scalars, B, precision=precision, rs=rs)
    return av, z


# ---------------------------------------------------------------------------
# kernels #1, #2: the full-table SAGA and Finito refresh of one block
# ---------------------------------------------------------------------------

def _block_lowp(precision: str) -> bool:
    """Whether the margins' dot operands round to bf16 in the full-table
    kernel: at "default" only. Its Pallas kernel (``_row_grad``) widens
    bf16 rows to f32 and keeps z unrounded at "highest", unlike
    ``_stream_dot`` (:func:`_lowp`)."""
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', "
                         f"not {precision!r}")
    return precision == "default"


def _block_grads(A, b, z, start, scale, B: int, precision: str):
    """(rows of the block, their least-squares gradients G at z) as the
    block kernels compute them: the margins' dot with bf16 operands at
    "default", the gradient with the stored row values."""
    idx = torch.as_tensor(start, device=A.device).long() + torch.arange(
        B, device=A.device)
    A_t = A.index_select(0, idx).to(torch.float32)
    A_d, zq = A_t, z
    if _block_lowp(precision):
        A_d, zq = _bf16_round(A_t), _bf16_round(z)
    return idx, (scale * (A_d @ zq - b[idx]))[:, None] * A_t


def saga_block_update_ref(A, b, s, z, start, scalars, B: int,
                          precision: str = "highest"):
    """Plain PyTorch version of :func:`saga_block_update`, with the same
    bf16 roundings. Updates ``s`` in place; returns ``(s, innov)``. On
    the card it needs exact f32 products, which it checks and does not
    set."""
    runtime.require_exact_f32_matmul(A.device, "saga_block_update_ref")
    idx, G = _block_grads(A, b, z, start, scalars[0], B, precision)
    innov = (G - s[idx]).sum(dim=0)
    s.index_copy_(0, idx, G)
    return s, innov


def finito_block_update_ref(A, b, s, gamma, z, start, scalars, B: int,
                            precision: str = "highest"):
    """Plain PyTorch version of :func:`finito_block_update`, with the same
    bf16 roundings. Updates ``s`` in place; returns ``(s, innov)``. On
    the card it needs exact f32 products, which it checks and does not
    set."""
    runtime.require_exact_f32_matmul(A.device, "finito_block_update_ref")
    scale, inv_n, hat = scalars.unbind()
    idx, G = _block_grads(A, b, z, start, scale, B, precision)
    gi = gamma[idx]
    s_new = z[None, :] - (gi * inv_n)[:, None] * G
    innov = ((s_new - s[idx]) * (hat / gi)[:, None]).sum(dim=0)
    s.index_copy_(0, idx, s_new)
    return s, innov


def _launch_block(name, A, b, s, z, start, scalars, n_sc, B, precision,
                  gamma=()):
    """Check the arguments of a one-block kernel of ``table_rows.cuh``
    (``gamma``: Finito's (N,) stepsizes, absent for SAGA) and queue its
    two launches; returns the (n,) innovation."""
    N, n = A.shape
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows must be f32 or bf16, not {A.dtype} (int8 "
                        "rows take the coefficient table)")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if N % B or n > MAX_COLS or N >= 2**31:
        raise ValueError(f"bad shape: N={N}, n={n}, B={B}")
    dev, f32 = A.device, torch.float32
    _check("b", b, f32, (N,), dev)
    _check("s", s, f32, (N, n), dev)
    for g in gamma:
        _check("gamma", g, f32, (N,), dev)
    _check("z", z, f32, (n,), dev)
    _check("scalars", scalars, f32, (n_sc,), dev)
    if isinstance(start, torch.Tensor):
        st = start.reshape(1).to(torch.int32)
        _check("start", st, torch.int32, (1,), dev)
    else:
        if start % B or not 0 <= start <= N - B:
            raise ValueError(f"start {start} must be a multiple of B in "
                             f"[0, {N - B}]")
        st = torch.full((1,), int(start), dtype=torch.int32, device=dev)
    rows = _rows_per_cta(B, n, A.element_size())
    part = torch.empty((B // rows, n), dtype=f32, device=dev)
    innov = torch.empty(n, dtype=f32, device=dev)
    _call(name, dev, A.data_ptr(), _STORAGE_CODES[A.dtype],
          int(_block_lowp(precision)), b.data_ptr(), s.data_ptr(),
          *(g.data_ptr() for g in gamma), z.data_ptr(), st.data_ptr(),
          scalars.data_ptr(), part.data_ptr(), innov.data_ptr(), n, B, rows)
    return innov


def saga_block_update(A, b, s, z, start, scalars, B: int,
                      precision: str = "highest"):
    """The full-table SAGA refresh of the block [start, start + B)
    (SAGA_basic.jl:61-65): s_i ← ∇f_i(z) for its rows, in place, and
    ``innov`` = Σ_B (∇f_i(z) − s_i_old); returns ``(s, innov)``.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:saga_block_update``. ``A`` (N, n)
    least-squares rows stored f32 or bf16 (∇f_i(z) = scale·(a_i·z −
    b_i)·a_i), ``b`` (N,), ``s`` the (N, n) f32 table, ``z`` (n,),
    ``start`` a multiple of B (a Python int, or a 0-d tensor on the rows'
    device, read there), ``scalars`` the (1,) f32 row [scale]. Rows of
    ``s`` outside the block are not touched. Precision is
    :func:`finito_block_update`'s.

    CPU tensors take the plain version :func:`saga_block_update_ref`;
    CUDA tensors launch the kernel or raise.

    On an H100 the step is bound by bytes: the block's rows, and its
    table rows read and written, 12 B a column of a row with f32 rows
    (50,348,032 B at the 262,144 × 1,024 headline's B = 4,096: 0.0150 ms
    at 3.35 TB/s; bf16 rows 41,959,424 B, 0.0125 ms). The design is
    :func:`finito_block_update`'s, whose device code it shares
    (``csrc/table_rows.cuh``, rule ``SagaRule``): the walk writes c_i·a_i
    and sums the plain difference.
    """
    if A.device.type == "cpu":
        return saga_block_update_ref(A, b, s, z, start, scalars, B,
                                     precision=precision)
    if A.device.type != "cuda":
        raise ValueError(f"saga_block_update: no kernel for {A.device}")
    innov = _launch_block("saga_block_update", A, b, s, z, start, scalars, 1,
                          B, precision)
    saga_block_update.launches += 1
    saga_block_update.steps += 1
    return s, innov


def finito_block_update(A, b, s, gamma, z, start, scalars, B: int,
                        precision: str = "highest"):
    """The full-table Finito refresh of the block [start, start + B)
    (Finito_basic.jl:110-117): s_i ← z − (γ_i/N)·∇f_i(z) for its rows, in
    place, and ``innov`` = Σ_B (s_new − s_old)·hat/γ_i; returns
    ``(s, innov)``.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:finito_block_update``. ``A`` (N, n)
    least-squares rows stored f32 or bf16 (∇f_i(z) = scale·(a_i·z −
    b_i)·a_i), ``b`` and ``gamma`` (N,), ``s`` the (N, n) f32 table,
    ``z`` (n,), ``start`` a multiple of B (a Python int, or a 0-d tensor
    on the rows' device, read there), ``scalars`` the (3,) f32 row
    [scale, 1/N, hat]. Rows of ``s`` outside the block are not touched.

    CPU tensors take the plain version :func:`finito_block_update_ref`;
    CUDA tensors launch the kernel or raise.

    On an H100 the step is bound by bytes: the block's rows, and its
    table rows read and written, 12 B a column of a row with f32 rows
    (about 48 MB at the 262,144 × 1,024 headline's B = 4,096). Two
    launches, as the coefficient kernels: B/R CTAs each stage their R
    rows in shared memory with ``cp.async``, take the margins a warp a
    row, then walk the rows in order a column per thread, reading and
    writing the table and summing a partial innovation; a second launch
    sums the partials in a fixed order. The walk is shared with kernel
    #1 (``csrc/table_rows.cuh``). The TPU kernel streams its
    tiles in grid order with the table aliased in and out.
    """
    if A.device.type == "cpu":
        return finito_block_update_ref(A, b, s, gamma, z, start, scalars, B,
                                       precision=precision)
    if A.device.type != "cuda":
        raise ValueError(f"finito_block_update: no kernel for {A.device}")
    innov = _launch_block("finito_block_update", A, b, s, z, start, scalars,
                          3, B, precision, gamma=(gamma,))
    finito_block_update.launches += 1
    finito_block_update.steps += 1
    return s, innov


# ---------------------------------------------------------------------------
# kernel #18: K ProShI sharing steps on the (N, n) block table
# ---------------------------------------------------------------------------

# coupling prox modes (the scalars row's ``gmode``)
GPROX_ZERO = 0   # g = Zero: prox = id → z ≡ 0
GPROX_BOX = 1    # IndBox[glo, ghi]: prox = clip
GPROX_L1 = 2     # NormL1: soft-threshold at glo = hat·λ


def _gprox(av, gmode, glo, ghi):
    """The coupling prox of the scalars row's mode."""
    return torch.where(gmode == GPROX_BOX, torch.clamp(av, glo, ghi),
                       torch.where(gmode == GPROX_L1, _soft(av, glo), av))


def proshi_multistep_ref(A, b, gamma, s, starts, av, z, scalars, B: int,
                         precision: str = "highest", rs=None, f=None):
    """Plain PyTorch version of :func:`proshi_multistep`: the first ``f``
    of the K steps (all K when ``f`` is None) as a Python loop of tensor
    ops; the masked steps leave s, av and z as they are. Updates them in
    place and returns them. Reads ``f`` on the host."""
    _block_lowp(precision)  # checked; the margins are exact f32 either way
    scale, inv_n, invhat, mode, glo, ghi, gmode, aux = scalars.unbind()
    ar = torch.arange(B, device=A.device)
    live = starts.shape[0] if f is None else min(starts.shape[0], int(f))
    for k in range(live):
        idx = starts[k].long() + ar
        s_old = s.index_select(0, idx)
        gi = gamma[idx]
        s_tmp = s_old + gi[:, None] * z[None, :]
        A_f = A.index_select(0, idx).to(torch.float32)
        m = torch.sum(A_f * s_tmp, dim=1)
        rs_t = None if rs is None else rs[idx]
        if rs_t is not None:
            m = m * rs_t
        w = (gi * inv_n) * _coeff_formula(mode, m, b[idx], scale, aux)
        if rs_t is not None:
            w = w * rs_t
        s_new = s_tmp - w[:, None] * A_f
        av.add_(torch.sum(s_new - s_old, dim=0))
        s.index_copy_(0, idx, s_new)
        z.copy_((_gprox(av, gmode, glo, ghi) - av) * invhat)
    return s, av, z


def proshi_multistep(A, b, gamma, s, starts, av, z, scalars, B: int,
                     precision: str = "highest", rs=None, f=None):
    """K = len(starts) ProShI sharing steps (ProShI_basic.jl:111-123) on
    the block table, with the steps k ≥ ``f`` masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:proshi_multistep``. Step k takes the
    block [starts[k], starts[k] + B) of the rows ``A`` (N, n), stored f32,
    bf16 or int8 (then ``rs`` holds the (N,) f32 dequant scales): with
    s_tmp_i = s_i + γ_i·z it refreshes the block's rows of the (N, n) f32
    table ``s`` to s_tmp_i − (γ_i/N)·c_i(a_i·s_tmp_i)·a_i, adds their
    change to the coupling sum ``av`` (n,) and sets z = (prox_g(av) −
    av)/hat (n,). ``b`` and ``gamma`` are (N,); ``scalars`` the (8,) f32
    row [scale, 1/N, 1/hat, mode, glo, ghi, gmode, aux], gmode one of
    ``GPROX_ZERO``, ``GPROX_BOX`` (clip to [glo, ghi]) and ``GPROX_L1``
    (soft-threshold at glo = hat·λ). ``s``, ``av`` and ``z`` are updated
    in place and returned. ``precision`` is accepted and changes nothing:
    the Pallas kernel takes it and never uses it, its margins being exact
    f32 products of the widened rows. ``f`` is the clamp count, a
    one-element int32 tensor on the rows' device, or None for K; a masked
    step writes nothing.

    CPU tensors take the plain version :func:`proshi_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    On an H100 a step is bound by bytes: the block's rows, and its table
    rows read and written, plus b and γ (50,364,416 B with f32 rows at
    65,536 × 1,024, B = 4,096: 0.0150 ms at 3.35 TB/s; int8 rows
    37,797,888 B with rs, 0.0113 ms). Unlike the SAGA and Finito blocks,
    each row's margin is taken at its own point s_i + γ_i·z, so a row's
    table values must be read before the margin and written after it.
    The whole call is one cooperative launch of the persistent engine
    (``csrc/loopless_steps.cuh``, method ``kProshiSteps``): the producer
    warp stages the rows, b, γ and rs ahead across steps; a consumer
    thread reads its columns of a round of table rows once into
    registers (the next round's loads in flight while it works on this
    one), takes its share of the margins from them and, after the
    formula, writes the new table values from the same registers; the
    finish between two grid barriers a step applies av, the coupling
    prox and z. The TPU kernel carries av and z in VMEM across its (K,
    tiles) grid and must not revisit a block within a launch (the
    streamed table would race its aliased write-back), so its shuffled
    and random drivers clamp; here the table lives in device memory and
    every value written in the launch is read back by coherent loads
    behind the grid barriers, so the port's driver does not clamp and
    ``f`` stays a tested option, read once on the device. A grid that
    cannot be resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return proshi_multistep_ref(A, b, gamma, s, starts, av, z, scalars, B,
                                    precision=precision, rs=rs, f=f)
    if A.device.type != "cuda":
        raise ValueError(f"proshi_multistep: no kernel for {A.device}")
    _block_lowp(precision)
    dev = A.device
    _check("s", s, torch.float32, tuple(A.shape), dev)
    f = _check_f(f, dev)
    _loopless_launch("proshi_multistep", A, b, rs, dict(gamma=gamma), starts,
                     B, "highest", scalars, 8, (s.data_ptr(), _ptr(f)),
                     dict(av=av, z=z), lowp=False)
    proshi_multistep.launches += 1
    proshi_multistep.steps += starts.shape[0]
    return s, av, z


# ---------------------------------------------------------------------------
# kernels #10, #11, #16, #17: Katyusha, SARAH, L-SVRG and L-Katyusha steps
# ---------------------------------------------------------------------------

def _block_rows(A, starts_k, B: int, lowp: bool):
    """(indices, f32 rows as the dots see them) of one block."""
    idx = starts_k.long() + torch.arange(B, device=A.device)
    A_t = A.index_select(0, idx).to(torch.float32)
    return idx, _bf16_round(A_t) if lowp else A_t


def _margin_coeffs(A_t, idx, b, rs, p, scalars_mode_aux, scale, lowp):
    """c_i(a_i·p) of a block's rows at the point ``p``, ``p`` rounded to
    bf16 when the dots are."""
    mode, aux = scalars_mode_aux
    r = A_t @ (_bf16_round(p) if lowp else p)
    if rs is not None:
        r = r * rs[idx]
    return _coeff_formula(mode, r, b[idx], scale, aux)


def _innovation(A_t, idx, dc, rs, lowp):
    """Σ dc_i·a_i (·rs_i for int8 rows), dc rounded to bf16 when the dots
    are."""
    if rs is not None:
        dc = dc * rs[idx]
    if lowp:
        dc = _bf16_round(dc)
    return dc @ A_t


def _live_steps(K: int, stop) -> int:
    """Steps a launch processes: all K, or stop + 1 (read on the host)."""
    return K if stop is None else max(0, min(K, int(stop) + 1))


def katyusha_coeff_multistep_ref(A, b, canch, starts, xt, y, z, ys, av,
                                 scalars, B: int, precision: str = "highest",
                                 rs=None):
    """Plain PyTorch version of :func:`katyusha_coeff_multistep`: the same
    K inner steps as a Python loop of tensor ops, with the same bf16
    roundings. Updates ``y``, ``z`` and ``ys`` in place and returns them.
    On the card it needs exact f32 products, which it checks and does not
    set."""
    runtime.require_exact_f32_matmul(A.device, "katyusha_coeff_multistep_ref")
    lowp = _lowp(A, precision)
    (scale, alpha, beta, athr, bthr, invB, mode, tau1, tau2,
     aux) = scalars.unbind()
    for k in range(starts.shape[0]):
        x = tau1 * z + tau2 * xt + (1.0 - tau1 - tau2) * y
        idx, A_t = _block_rows(A, starts[k], B, lowp)
        dc = _margin_coeffs(A_t, idx, b, rs, x, (mode, aux), scale,
                            lowp) - canch[idx]
        gr = av + _innovation(A_t, idx, dc, rs, lowp) * invB
        z.copy_(_soft(z - alpha * gr, athr))
        y.copy_(_soft(x - beta * gr, bthr))
        ys.add_(y)
    return y, z, ys


def katyusha_coeff_multistep(A, b, canch, starts, xt, y, z, ys, av, scalars,
                             B: int, precision: str = "highest", rs=None):
    """K = len(starts) Katyusha inner block steps (Allen-Zhu 2018, Option
    II).

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:katyusha_coeff_multistep``. Step k takes
    the block [starts[k], starts[k] + B) of the rows ``A`` (N, n), stored
    f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant scales),
    forms x = τ₁z + τ₂x̃ + (1 − τ₁ − τ₂)y, the estimate ∇̃ = av + (1/B)·Σ
    (c_i(x) − canch_i)·a_i against the anchor coefficients ``canch`` (N,)
    of the anchor point ``xt`` (n,), and steps z ← soft(z − α∇̃, αλ),
    y ← soft(x − β∇̃, βλ), ys += y. ``av`` is the anchor's mean gradient;
    ``scalars`` the (10,) f32 row [scale, α, β, αλ, βλ, 1/B, mode, τ₁, τ₂,
    aux]. ``y``, ``z`` and ``ys`` (n,) are updated in place and returned;
    ``canch``, ``xt`` and ``av`` are read only.

    CPU tensors take the plain version :func:`katyusha_coeff_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    The step is :func:`lkatyusha_coeff_multistep`'s with Katyusha's
    finish: bound by the block's rows, B·n·itemsize bytes (16 MB f32,
    4 MB int8 at B = 4,096, n = 1,024), and the anchor coefficients,
    read, never written. The whole call is one cooperative launch of the
    persistent engine (``csrc/loopless_steps.cuh``, method
    ``kKatyushaSteps``): every CTA forms step 0's x on all columns inside
    the launch (writing its own finish columns of an (n,) scratch), the
    margins are taken at x, and each step's finish, between two grid
    barriers, updates z, y and ys on the CTA's columns and forms the next
    step's x there. A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return katyusha_coeff_multistep_ref(A, b, canch, starts, xt, y, z, ys,
                                            av, scalars, B,
                                            precision=precision, rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"katyusha_coeff_multistep: no kernel for "
                         f"{A.device}")
    x = torch.empty_like(y)
    _loopless_launch("katyusha_coeff_multistep", A, b, rs, dict(canch=canch),
                     starts, B, precision, scalars, 10, (),
                     dict(xt=xt, y=y, z=z, ys=ys, av=av, x=x))
    katyusha_coeff_multistep.launches += 1
    katyusha_coeff_multistep.steps += starts.shape[0]
    return y, z, ys


def svrg_inner_chunked(A, b, canch, w, zs, av, scalars, B: int, m: int,
                       starts_fn, precision: str = "highest", rs=None,
                       launch_steps: int = 64):
    """The first ``floor(m/K)·K`` of an SVRG inner loop's m block steps
    as launches of K = min(``launch_steps``, m) steps of
    :func:`svrg_coeff_multistep`, w and the running sum ``zs`` carried
    across them in place. ``starts_fn(k0, K)`` gives the (K,) int32
    block starts of inner steps [k0, k0 + K): the caller owns the draws,
    so the single-card and data-parallel paths keep their own. Returns
    ``(w, zs, done)``, JAX's ``(w2, zs2, done)``; the caller runs the
    m − done remaining steps on its stepwise path, on the same draws."""
    K = min(launch_steps, m)
    done = (m // K) * K
    for k0 in range(0, done, K):
        svrg_coeff_multistep(A, b, starts_fn(k0, K), canch, w, zs, av,
                             scalars, B, precision=precision, rs=rs)
    return w, zs, done


def katyusha_inner_chunked(A, b, canch, xt, y, z, ys, av, scalars, B: int,
                           starts, launch_steps: int,
                           precision: str = "highest", rs=None):
    """A whole Katyusha inner loop (the (m,) block starts ``starts``) as
    launches of at most ``launch_steps`` steps of
    :func:`katyusha_coeff_multistep`, y, z and ys carried across them in
    place; the last launch takes the remainder, so no step runs
    stepwise. Returns ``(y, z, ys, m)``, JAX's ``(y2, z2, ys2, done)``."""
    m = starts.shape[0]
    for k0 in range(0, m, launch_steps):
        katyusha_coeff_multistep(A, b, canch, starts[k0:k0 + launch_steps],
                                 xt, y, z, ys, av, scalars, B,
                                 precision=precision, rs=rs)
    return y, z, ys, m


def sarah_multistep_ref(A, b, starts, ww, v, scalars, B: int,
                        precision: str = "highest", rs=None):
    """Plain PyTorch version of :func:`sarah_multistep`: the same K steps
    as a Python loop of tensor ops, with the same bf16 roundings (both
    points rounded, as the TPU's stacked (2, n) dot rounds them). Updates
    ``ww`` and ``v`` in place and returns them. On the card it needs
    exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "sarah_multistep_ref")
    lowp = _lowp(A, precision)
    scale, gamma, thr, eta, invB, mode, aux = scalars.unbind()
    for k in range(starts.shape[0]):
        idx, A_t = _block_rows(A, starts[k], B, lowp)
        c_prev, c_w = (_margin_coeffs(A_t, idx, b, rs, ww[i], (mode, aux),
                                      scale, lowp) for i in (0, 1))
        v.add_(_innovation(A_t, idx, c_w - c_prev, rs, lowp) * invB)
        w = ww[1].clone()
        y = _soft(w - gamma * v, thr)
        ww[0].copy_(w)
        ww[1].copy_(w + eta * (y - w))
    return ww, v


def sarah_multistep(A, b, starts, ww, v, scalars, B: int,
                    precision: str = "highest", rs=None):
    """K = len(starts) SARAH / ProxSARAH recursive block steps.

    Replaces the Pallas TPU kernel ``ciao_tpu/ops/fused_block.py:
    sarah_multistep``. ``ww`` is the (2, n) pair [w_prev; w], ``v`` the
    (n,) estimator. Step k takes the block [starts[k], starts[k] + B) of
    the rows ``A`` (N, n), stored f32, bf16 or int8 (then ``rs`` holds the
    (N,) f32 dequant scales): v ← v + (1/B)·Σ (c_i(w) − c_i(w_prev))·a_i,
    y = soft(w − γv, γλ), then w_prev ← w and w ← w + η(y − w).
    ``scalars`` is the (7,) f32 row [scale, γ, γλ, η, 1/B, mode, aux].
    ``ww`` and ``v`` are updated in place and returned.

    CPU tensors take the plain version :func:`sarah_multistep_ref`; CUDA
    tensors launch the kernel or raise.

    The step needs each row's margin at two points. The TPU kernel takes
    both from one stacked (2, TILE) dot on the MXU; here the whole call is
    one cooperative launch of the persistent engine
    (``csrc/loopless_steps.cuh``, method ``kSarahSteps``), whose consumer
    warps copy both points into shared memory (rounded to bf16 when the
    dots are) and feed each unit they load of a staged row into two sets
    of sums, so a step still reads its block's rows once: B·n·itemsize
    bytes, 16 MB f32 and 4 MB int8 at B = 4,096, n = 1,024, for 6·B·n
    operations. There is no coefficient table to load. Each step's
    finish, between two grid barriers, writes v, w_prev ← w and
    w ← w_next on the CTA's columns. The shared memory counts both
    points (:func:`_loopless_grid` with ``points=2``): f32 rows wider
    than 14,456 columns leave room for one ring stage only, which the
    producer refills once it has been read. A grid that cannot be
    resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return sarah_multistep_ref(A, b, starts, ww, v, scalars, B,
                                   precision=precision, rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"sarah_multistep: no kernel for {A.device}")
    _check("ww", ww, torch.float32, (2, A.shape[-1]), A.device)
    _loopless_launch("sarah_multistep", A, b, rs, {}, starts, B, precision,
                     scalars, 7, (ww.data_ptr(),), dict(v=v), points=2)
    sarah_multistep.launches += 1
    sarah_multistep.steps += starts.shape[0]
    return ww, v


def sarah_inner_chunked(A, b, ww, v, scalars, B: int, starts,
                        launch_steps: int, precision: str = "highest",
                        rs=None):
    """A whole SARAH inner loop (the (m,) block starts ``starts``) as
    launches of at most ``launch_steps`` steps of :func:`sarah_multistep`,
    ww and v carried across them in place. Returns ``(ww, v, m)``, JAX's
    ``(ww2, v2, done)``."""
    m = starts.shape[0]
    for k0 in range(0, m, launch_steps):
        sarah_multistep(A, b, starts[k0:k0 + launch_steps], ww, v, scalars,
                        B, precision=precision, rs=rs)
    return ww, v, m


# The persistent engine of kernels #3, #4, #5, #8, #9, #10, #11, #12, #14,
# #16, #17 and #18 (``csrc/loopless_steps.cuh``): one cooperative launch a
# call, LOOPLESS_THREADS consumer threads and one producer warp a CTA, a ring
# of 2 to LOOPLESS_MAX_STAGES stages of whole rows (as many as fit
# LOOPLESS_STAGE_BYTES, at most LOOPLESS_MAX_STAGE_ROWS) in shared memory,
# one stage where two do not fit beside SARAH's two points.
LOOPLESS_THREADS = 256
LOOPLESS_STAGE_BYTES = 32 * 1024
LOOPLESS_MAX_STAGES = 8
LOOPLESS_MAX_STAGE_ROWS = 256


def _loopless_groups(units: int) -> int:
    """The engine's row groups for rows of ``units`` column units
    (``loopless_groups`` in ``csrc/loopless_steps.cuh``): groups of U
    threads, U the units rounded up to a power of two, at least a warp
    and at most LOOPLESS_THREADS (8 groups at n = 128 on the 16-byte
    path, whose units are four columns; 1 from 1,024 columns)."""
    U = 32
    while U < units and U < LOOPLESS_THREADS:
        U *= 2
    return LOOPLESS_THREADS // U


def _loopless_smem_bytes(stage_rows: int, stages: int, n: int,
                         itemsize: int, points: int = 1) -> int:
    """Dynamic shared memory of one CTA of the engine
    (``loopless_smem_bytes`` in ``csrc/loopless_steps.cuh``): the ring,
    the ``points`` (n,) points (SARAH's two), the row groups' column sums
    (g rows of n where the 16-byte path gives g > 1 groups), two
    mbarriers a stage, b, the anchor coefficient and rs of each stage's
    rows, dc of two stages, the warps' margin sums of a stage's rows (a
    set a point) and the finish's warp sums."""
    tile = -(-stage_rows * n * itemsize // 16) * 16
    g = _loopless_groups(-(-n // 4))
    groups = -(-4 * g * n // 16) * 16 if g > 1 else 0
    return (stages * tile + -(-4 * points * n // 16) * 16 + groups
            + 16 * stages
            + 4 * (3 * stages * stage_rows
                   + (2 + points * LOOPLESS_THREADS // 32) * stage_rows
                   + LOOPLESS_THREADS))


@functools.lru_cache(maxsize=64)
def _loopless_grid(B: int, n: int, itemsize: int, sms: int, points: int = 1):
    """(rows a CTA, CTAs, rows a stage, stages) of the engine on a card of
    ``sms`` SMs, as ``loopless_grid`` in ``csrc/loopless_steps.cuh``
    checks it: R rows a CTA, the smallest power of two with ceil(B / R)
    ≤ sms (R = 32 at B = 4,096, 8 at B = 1,024 and 64 at B = 8,192: 128
    CTAs on an H100's 132 SMs; the last CTA takes the rest of a B that R
    does not divide); stages of S whole rows, the largest power of two up
    to R and LOOPLESS_MAX_STAGE_ROWS whose tile fits LOOPLESS_STAGE_BYTES
    (at least one row: 8 f32, 16 bf16 and 32 int8 rows at n = 1,024, 64
    rows of any storage at n = 128), and as many stages as fit the SM's
    shared memory beside the ``points`` points, up to LOOPLESS_MAX_STAGES
    (6 f32 stages at n = 1,024 and at n = 128, 2 of one f32 row at n =
    16,384). Two stages fit beside one point at every width up to
    MAX_COLS; beside SARAH's two points they fit f32 rows up to 14,456
    columns, and wider f32 rows take one stage (n = 16,384: 197,732 B)."""
    rows = 1
    while -(-B // rows) > sms:
        rows *= 2
    ctas = -(-B // rows)
    S = 1
    while (2 * S <= min(rows, LOOPLESS_MAX_STAGE_ROWS)
           and 2 * S * n * itemsize <= LOOPLESS_STAGE_BYTES):
        S *= 2
    P = LOOPLESS_MAX_STAGES
    while (P > 1 and _loopless_smem_bytes(S, P, n, itemsize, points)
           > SMEM_BYTES):
        P -= 1
    return rows, ctas, S, P


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _grid_barrier(index: int, stream: int):
    """The engine's grid-barrier word for the CUDA stream ``stream`` (its
    handle) of card ``index``: one zeroed int32, made once; each barrier
    leaves its low bits at zero again, so it is never reset. Calls on one
    stream run one after the other; calls on two streams, which may run at
    once, take two words. A word a call, zeroed by a memset before each
    launch, cost 0.1-0.2 µs a step at the engine's floor on an H100
    (PERF.md section 6)."""
    return torch.zeros(1, dtype=torch.int32,
                       device=torch.device("cuda", index))


def _loopless_launch(name, A, b, rs, table, starts, B, precision, scalars,
                     n_sc, before, vectors, points: int = 1, lowp=None):
    """Check the arguments of a kernel of the persistent engine (#3, #4,
    #5, #8, #9, #10, #11, #12, #13, #14, #16, #17, #18, #19) and make its
    one cooperative launch on the current stream. ``table``: the (N,) f32
    coefficients, by name (SARAH has none: empty; ProShI's γ; Point-SAGA's
    c and ‖a_i‖²); ``before``: the C call's arguments between ``starts``
    and the vectors (the stop index or clamp count, SAGA's weights,
    SARAH's pair, the Finitos' anchors and Σ 1/γ, LFinito's Σ 1/γ,
    ProShI's table, Point-SAGA's mode, SSNM's stored points and clamp
    count), checked by the caller; ``vectors``:
    the (n,) f32 tensors after them, by name, in its order; ``points``:
    the points the margins are taken at (SARAH's two); ``lowp``: whether
    the dots round to bf16, by default as ``precision`` and the rows
    say."""
    n, K = _check_blocks(A, b, starts, B, rs)
    dev, f32 = A.device, torch.float32
    for key, c in table.items():
        _check(key, c, f32, (A.shape[0],), dev)
    for key, t in vectors.items():
        _check(key, t, f32, (n,), dev)
    _check("scalars", scalars, f32, (n_sc,), dev)
    rows, ctas, S, P = _loopless_grid(B, n, A.element_size(),
                                      _sm_count(dev.index), points)
    part = torch.empty((ctas, n), dtype=f32, device=dev)
    bar = _grid_barrier(dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if lowp is None:
        lowp = _lowp(A, precision)
    _call(name, dev, A.data_ptr(), _STORAGE_CODES[A.dtype], int(lowp),
          b.data_ptr(), _ptr(rs),
          *(c.data_ptr() for c in table.values()), starts.data_ptr(), *before,
          *(t.data_ptr() for t in vectors.values()), scalars.data_ptr(),
          part.data_ptr(), bar.data_ptr(), n, B, rows, ctas, S, P, K)


def _check_stop(stop, dev):
    """``stop`` as a (1,) int32 tensor on ``dev`` (or None)."""
    if stop is None:
        return None
    if stop.numel() != 1:
        raise ValueError(f"stop must hold one index, not {stop.numel()}")
    stop = stop.reshape(1)
    _check("stop", stop, torch.int32, (1,), dev)
    return stop


def lsvrg_coeff_multistep_ref(A, b, canch, starts, stop, w, av, scalars,
                              B: int, precision: str = "highest", rs=None):
    """Plain PyTorch version of :func:`lsvrg_coeff_multistep`: the first
    ``stop + 1`` of the K steps (all K when ``stop`` is None) as a Python
    loop of tensor ops. Updates ``w`` in place; returns ``(w, wpre)``.
    Reads ``stop`` on the host. On the card it needs exact f32 products,
    which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device, "lsvrg_coeff_multistep_ref")
    lowp = _lowp(A, precision)
    scale, gamma, thr, invB, mode, aux = scalars.unbind()
    wpre = w.clone()
    for k in range(_live_steps(starts.shape[0], stop)):
        idx, A_t = _block_rows(A, starts[k], B, lowp)
        dc = canch[idx] - _margin_coeffs(A_t, idx, b, rs, w, (mode, aux),
                                         scale, lowp)
        wpre.copy_(w)
        w.copy_(_soft(w + gamma * (_innovation(A_t, idx, dc, rs, lowp)
                                   * invB - av), thr))
    return w, wpre


def lsvrg_coeff_multistep(A, b, canch, starts, stop, w, av, scalars, B: int,
                          precision: str = "highest", rs=None):
    """Up to K = len(starts) L-SVRG block steps (Kovalev et al. 2020, Alg.
    2), the steps past ``stop`` masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:lsvrg_coeff_multistep``. Step k takes
    the block [starts[k], starts[k] + B) of the rows ``A`` (N, n), stored
    f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant scales),
    and steps w ← soft(w + γ((1/B)·Σ (canch_i − c_i(w))·a_i − av), γλ)
    against the anchor coefficients ``canch`` (N,) and the anchor's mean
    gradient ``av`` (n,). ``stop`` is the last step to process, a
    one-element int32 tensor on the rows' device (read there, no host
    sync), or None for all K; a masked step writes nothing. ``scalars``
    is SVRG's (6,) f32 row [scale, γ, γλ, 1/B, mode, aux]. ``w`` is
    updated in place; returns ``(w, wpre)``, wpre the pre-update iterate
    of the last processed step (the anchor-jump target of a coin flip).

    CPU tensors take the plain version :func:`lsvrg_coeff_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    The step is :func:`svrg_coeff_multistep`'s without the running sum,
    bound by the block's rows (16 MB f32, 4 MB int8 at the headline). The
    whole call is one cooperative launch of the persistent engine
    (``csrc/loopless_steps.cuh``, method ``kLsvrgSteps``): a CTA owns a
    fixed slice of every step's block (:func:`_loopless_grid`: 128 CTAs
    at B = 4,096 and at B = 1,024 on an H100), a producer warp keeps a
    ring of bulk-copied row stages loading ahead across steps, the
    consumer warps take each stage's margins and add it into column sums
    held in registers, and two grid-wide barriers a step bracket the
    finish, which every CTA runs on its own columns. The stop index is
    read once on the device: the call processes min(K, stop + 1) steps
    and the masked ones write nothing. The TPU kernel must launch a fixed
    K with the tail clamped onto the last processed block; the port's
    driver knows each window's length on the host and launches exactly
    the window's steps with ``stop`` None, so the masked steps stay a
    tested option. A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return lsvrg_coeff_multistep_ref(A, b, canch, starts, stop, w, av,
                                         scalars, B, precision=precision,
                                         rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"lsvrg_coeff_multistep: no kernel for {A.device}")
    wpre = w.clone()
    stop = _check_stop(stop, A.device)
    _loopless_launch("lsvrg_coeff_multistep", A, b, rs, dict(canch=canch),
                     starts, B, precision, scalars, 6, (_ptr(stop),),
                     dict(w=w, wpre=wpre, av=av))
    lsvrg_coeff_multistep.launches += 1
    lsvrg_coeff_multistep.steps += starts.shape[0]
    return w, wpre


def lkatyusha_coeff_multistep_ref(A, b, canch, starts, stop, wa, y, z, av,
                                  scalars, B: int, precision: str = "highest",
                                  rs=None):
    """Plain PyTorch version of :func:`lkatyusha_coeff_multistep`: the
    first ``stop + 1`` of the K steps (all K when ``stop`` is None) as a
    Python loop of tensor ops. Updates ``y`` and ``z`` in place; returns
    ``(y, z, ypre)``. Reads ``stop`` on the host. On the card it needs
    exact f32 products, which it checks and does not set."""
    runtime.require_exact_f32_matmul(A.device,
                                     "lkatyusha_coeff_multistep_ref")
    lowp = _lowp(A, precision)
    (scale, step, tthr, invden, etasig, th1, th2, invB, mode,
     aux) = scalars.unbind()
    ypre = y.clone()
    for k in range(_live_steps(starts.shape[0], stop)):
        x = th1 * z + th2 * wa + (1.0 - th1 - th2) * y
        idx, A_t = _block_rows(A, starts[k], B, lowp)
        dc = _margin_coeffs(A_t, idx, b, rs, x, (mode, aux), scale,
                            lowp) - canch[idx]
        gr = av + _innovation(A_t, idx, dc, rs, lowp) * invB
        z_new = _soft((z + etasig * x - step * gr) * invden, tthr)
        ypre.copy_(y)
        y.copy_(x + th1 * (z_new - z))
        z.copy_(z_new)
    return y, z, ypre


def lkatyusha_coeff_multistep(A, b, canch, starts, stop, wa, y, z, av,
                              scalars, B: int, precision: str = "highest",
                              rs=None):
    """Up to K = len(starts) L-Katyusha block steps (Kovalev et al. 2020,
    Alg. 3, proximal z-step), the steps past ``stop`` masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:lkatyusha_coeff_multistep``. Step k
    takes the block [starts[k], starts[k] + B) of the rows ``A`` (N, n),
    stored f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant
    scales), forms x = θ₁z + θ₂w + (1 − θ₁ − θ₂)y against the anchor
    point ``wa`` (n,), the estimate ∇̃ = av + (1/B)·Σ (c_i(x) −
    canch_i)·a_i, and steps z ← soft((z + ησ̂x − (η/L)∇̃)/(1 + ησ̂), τλ),
    y ← x + θ₁(z_new − z). ``scalars`` is the (10,) f32 row [scale, η/L,
    τλ, 1/(1 + ησ̂), ησ̂, θ₁, θ₂, 1/B, mode, aux]; ``stop`` as in
    :func:`lsvrg_coeff_multistep`. ``y`` and ``z`` are updated in place;
    returns ``(y, z, ypre)``, ypre the pre-update y of the last processed
    step (the anchor-jump target).

    CPU tensors take the plain version
    :func:`lkatyusha_coeff_multistep_ref`; CUDA tensors launch the kernel
    or raise.

    The engine is :func:`lsvrg_coeff_multistep`'s (method
    ``kLKatyushaSteps`` of ``csrc/loopless_steps.cuh``), one cooperative
    launch a call, with the margins at x: every CTA forms step 0's x on
    all columns inside the launch (writing its own finish columns of the
    x scratch), and each finish forms the next step's x on its columns;
    bound by the block's rows (16 MB f32, 4 MB int8 at the headline).
    """
    if A.device.type == "cpu":
        return lkatyusha_coeff_multistep_ref(A, b, canch, starts, stop, wa, y,
                                             z, av, scalars, B,
                                             precision=precision, rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"lkatyusha_coeff_multistep: no kernel for "
                         f"{A.device}")
    ypre = y.clone()
    x = torch.empty_like(y)
    stop = _check_stop(stop, A.device)
    _loopless_launch("lkatyusha_coeff_multistep", A, b, rs, dict(canch=canch),
                     starts, B, precision, scalars, 10, (_ptr(stop),),
                     dict(wa=wa, y=y, z=z, ypre=ypre, av=av, x=x))
    lkatyusha_coeff_multistep.launches += 1
    lkatyusha_coeff_multistep.steps += starts.shape[0]
    return y, z, ypre


# ---------------------------------------------------------------------------
# kernels #19, #13: SSNM steps; #12, #15: Point-SAGA steps
# ---------------------------------------------------------------------------

def _ssnm_steps_ref(A, b, starts, c, zb, x, gb, scalars, B: int,
                    precision: str, rs, who: str):
    """The SSNM steps of both plain versions."""
    runtime.require_exact_f32_matmul(A.device, who)
    lowp = _lowp(A, precision)
    scale, eta, thr, invB, invN, mode, tau, aux = scalars.unbind()
    for k in range(starts.shape[0]):
        j = (starts[k].long() // B).view(1)
        y = tau * x + (1.0 - tau) * zb.index_select(0, j)[0]
        idx, A_t = _block_rows(A, starts[k], B, lowp)
        c_new = _margin_coeffs(A_t, idx, b, rs, y, (mode, aux), scale, lowp)
        dc = c_new - c[idx]
        c.index_copy_(0, idx, c_new)
        innov = _innovation(A_t, idx, dc, rs, lowp)
        x.copy_(_soft(x - eta * (innov * invB + gb), thr))
        gb.add_(innov * invN)
        zb.index_copy_(0, j, y[None])
    return c, zb, x, gb


def ssnm_multistep_ref(A, b, starts, c, zb, x, gb, scalars, B: int,
                       precision: str = "highest", rs=None):
    """Plain PyTorch version of :func:`ssnm_multistep`: the same K steps
    as a Python loop of tensor ops, with the same bf16 roundings. Updates
    ``c``, ``zb``, ``x`` and ``gb`` in place and returns them. On the card
    it needs exact f32 products, which it checks and does not set."""
    return _ssnm_steps_ref(A, b, starts, c, zb, x, gb, scalars, B, precision,
                           rs, "ssnm_multistep_ref")


def ssnm_multistep_streamed_ref(A, b, starts, c, zb, x, gb, scalars, B: int,
                                precision: str = "highest", rs=None, f=None):
    """Plain PyTorch version of :func:`ssnm_multistep_streamed`: the first
    ``f`` of the K steps (all K when ``f`` is None); the masked steps
    leave c, zb, x and gb as they are. Reads ``f`` on the host."""
    live = starts.shape[0] if f is None else min(starts.shape[0], int(f))
    return _ssnm_steps_ref(A, b, starts[:live], c, zb, x, gb, scalars, B,
                           precision, rs, "ssnm_multistep_streamed_ref")


def ssnm_multistep(A, b, starts, c, zb, x, gb, scalars, B: int,
                   precision: str = "highest", rs=None):
    """K = len(starts) SSNM block steps (SAGA with sampled negative
    momentum, Zhou, Shang and Cheng 2019).

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:ssnm_multistep``. Step k takes block
    j = starts[k] / B of the rows ``A`` (N, n), stored f32, bf16 or int8
    (then ``rs`` holds the (N,) f32 dequant scales): it forms the momentum
    point y = τx + (1 − τ)zb_j from the iterate ``x`` (n,) and the block's
    stored point in ``zb`` (d, n), refreshes the block's coefficients in
    ``c`` (N,) at y, and with innov = Σ Δc_i·a_i steps
    x ← soft(x − η(innov/B + gb), ηλ), gb += innov/N, zb_j ← y.
    ``scalars`` is the (8,) f32 row [scale, η, ηλ, 1/B, 1/N, mode, τ,
    aux]. ``c``, ``zb``, ``x`` and ``gb`` are updated in place and
    returned; ``zb`` must own its rows (not an ``expand`` view).

    CPU tensors take the plain version :func:`ssnm_multistep_ref`; CUDA
    tensors launch the kernel or raise.

    The step is SAGA's at the point y: bound by the block's rows,
    B·n·itemsize bytes (16 MB f32, 4 MB int8 at the 262,144 × 1,024
    headline's B = 4,096), plus the block's stored point read and
    written. The whole call is one cooperative launch of the persistent
    engine (``csrc/loopless_steps.cuh``, method ``kSsnmSteps``): it is
    :func:`ssnm_multistep_streamed` with no clamp count, the same C entry
    and builds, so on block-aligned starts both give the same bits. The
    row phase is :func:`saga_coeff_multistep`'s: the table is written
    every step and never prefetched, each row's formula thread reading
    its old coefficient from L2 behind the barriers that end the previous
    step. y is formed once per step into an (n,) scratch: every CTA forms
    step 0's from x and the block's stored point, and each finish, whose
    columns are its own, writes x, gb and zb_j and then forms the next
    step's y from the new x and the next block's stored point (y itself
    when the block repeats: a column of zb is written by its finish
    thread alone, so the next point is loaded beside the partials, the
    blocks of the step and the next read at the step's start). Forming y
    twice, for the margins and
    again in the finish, would let the compiler contract the two
    expressions differently and store a zb_j that differs from the point
    of the margins. A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return ssnm_multistep_ref(A, b, starts, c, zb, x, gb, scalars, B,
                                  precision=precision, rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"ssnm_multistep: no kernel for {A.device}")
    _check_anchors(A, zb, B)
    y = torch.empty(A.shape[-1], dtype=torch.float32, device=A.device)
    _loopless_launch("ssnm_multistep_streamed", A, b, rs, dict(c=c), starts,
                     B, precision, scalars, 8, (zb.data_ptr(), None),
                     dict(y=y, x=x, gb=gb))
    ssnm_multistep.launches += 1
    ssnm_multistep.steps += starts.shape[0]
    return c, zb, x, gb


def ssnm_multistep_streamed(A, b, starts, c, zb, x, gb, scalars, B: int,
                            precision: str = "highest", rs=None, f=None):
    """K = len(starts) SSNM block steps for any N, with the steps k ≥ ``f``
    masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:ssnm_multistep_streamed``. Arguments
    and in-place updates are those of :func:`ssnm_multistep`, plus ``f``:
    the clamp count, a one-element int32 tensor on the rows' device, or
    None for K. A masked step writes neither c nor zb nor x nor gb. CPU
    tensors take the plain version :func:`ssnm_multistep_streamed_ref`;
    CUDA tensors launch the kernel or raise.

    The TPU kernel streams c through aliased windows with zb in VMEM, so
    its driver clamps each launch at the first same-launch revisit. Here
    c and zb live in device memory, read and written in place by the one
    launch, a block revisited within the call reading the previous
    visit's c and zb: the port's driver launches with ``f`` = None, and
    the ``f < K`` semantics stay for the tests. ``f`` is read once on the
    device (no host sync): the call processes min(K, f) steps. The design
    is :func:`ssnm_multistep`'s (``csrc/loopless_steps.cuh``, method
    ``kSsnmSteps``): at the 10,485,760 × 128 deep target (B = 8,192) a
    step reads 4 MB of f32 rows (1 MB int8), 128 CTAs of 64 rows, one
    stage a step, the rows split over eight row groups of a warp, as
    :func:`saga_coeff_multistep_streamed` takes them. Everything the call
    writes (c, zb, x, gb, y) is read back by coherent loads behind the
    engine's grid barriers. Any start in [0, N − B] is taken, step k's
    stored point being zb[starts[k] // B]. A grid that cannot be
    resident at once raises ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return ssnm_multistep_streamed_ref(A, b, starts, c, zb, x, gb,
                                           scalars, B, precision=precision,
                                           rs=rs, f=f)
    if A.device.type != "cuda":
        raise ValueError(f"ssnm_multistep_streamed: no kernel for "
                         f"{A.device}")
    f = _check_f(f, A.device)
    _check_anchors(A, zb, B)
    y = torch.empty(A.shape[-1], dtype=torch.float32, device=A.device)
    _loopless_launch("ssnm_multistep_streamed", A, b, rs, dict(c=c), starts,
                     B, precision, scalars, 8, (zb.data_ptr(), _ptr(f)),
                     dict(y=y, x=x, gb=gb))
    ssnm_multistep_streamed.launches += 1
    ssnm_multistep_streamed.steps += starts.shape[0]
    return c, zb, x, gb


POINTPROX_NEWTON_STEPS = 20  # Newton steps of the logistic and Poisson θ
_POINTPROX_MODES = (MODE_LSQ, MODE_LOGISTIC, MODE_HUBER, MODE_SQHINGE,
                    MODE_POISSON)  # the oracle formulas with a θ-solve


def pointprox_theta(mode: int, mz, b, na, c_old, scale, gamma, aux=0.0):
    """The per-row prox θ of Point-SAGA for the oracle formula ``mode``
    (a Python int: the kernels specialize on it), from the margin ``mz``
    at the row's prox point, the offset or label ``b``, the row
    square-norm ``na`` and the table coefficient ``c_old``:
    least squares and Huber in closed form (Huber: one clip of the
    least-squares θ, δ = ``aux``), squared hinge by one activity test of
    the deficit at mz, logistic and Poisson by 20 Newton steps from
    θ₀ = c_old. JAX's ``_pointprox_theta`` and the oracles'
    ``_logistic_pointprox_theta`` / ``_poisson_pointprox_theta``."""
    if mode == MODE_LOGISTIC:
        gna2 = gamma * na
        th = c_old
        for _ in range(POINTPROX_NEWTON_STEPS):
            s = torch.sigmoid(-b * (mz - gna2 * th))
            th = th - (th + b * s) / (1.0 + gna2 * s * (1.0 - s))
        return th
    if mode == MODE_POISSON:
        # φ(θ) = θ − c(θ) is increasing and concave (φ' ≥ 1): Newton
        # converges globally; the clamp keeps exp finite
        gna2 = gamma * na
        th = c_old
        for _ in range(POINTPROX_NEWTON_STEPS):
            u = mz - gna2 * th
            e = torch.exp(torch.clamp(u, max=POISSON_CLAMP))
            dphi = 1.0 + scale * gna2 * torch.where(u <= POISSON_CLAMP, e,
                                                    0.0)
            th = th - (th - scale * (e - b)) / dphi
        return th
    if mode == MODE_SQHINGE:
        deficit = 1.0 - b * mz
        return torch.where(deficit > 0,
                           -scale * b * deficit / (1.0 + scale * gamma * na),
                           torch.zeros_like(mz))
    theta = scale * (mz - b) / (1.0 + gamma * scale * na)
    if mode == MODE_HUBER:
        return torch.clamp(theta, -scale * aux, scale * aux)
    if mode != MODE_LSQ:
        raise ValueError(f"no Point-SAGA θ for oracle mode {mode}")
    return theta



def _point_saga_steps_ref(A, b, na, c, starts, x, av, scalars, B: int,
                          mode: int, precision: str, rs, who: str):
    """The Point-SAGA steps of both plain versions."""
    runtime.require_exact_f32_matmul(A.device, who)
    lowp = _lowp(A, precision)
    scale, gamma, invB, invN, _, aux = scalars.unbind()
    for k in range(starts.shape[0]):
        v = x - gamma * av
        idx, A_t = _block_rows(A, starts[k], B, lowp)
        r = A_t @ (_bf16_round(v) if lowp else v)
        if rs is not None:
            r = r * rs[idx]
        c_old = c[idx]
        na_t = na[idx]
        theta = pointprox_theta(mode, r + gamma * c_old * na_t, b[idx], na_t,
                                c_old, scale, gamma, aux)
        c.index_copy_(0, idx, theta)
        u = _innovation(A_t, idx, c_old - theta, rs, lowp)
        x.copy_(v + (gamma * invB) * u)
        av.sub_(u * invN)
    return c, x, av


def point_saga_multistep_ref(A, b, na, c, starts, x, av, scalars, B: int,
                             mode: int = MODE_LSQ, precision: str = "highest",
                             rs=None):
    """Plain PyTorch version of :func:`point_saga_multistep`: the same K
    steps as a Python loop of tensor ops, with the same bf16 roundings.
    Updates ``c``, ``x`` and ``av`` in place and returns them. On the card
    it needs exact f32 products, which it checks and does not set."""
    return _point_saga_steps_ref(A, b, na, c, starts, x, av, scalars, B,
                                 mode, precision, rs,
                                 "point_saga_multistep_ref")


def point_saga_multistep_streamed_ref(A, b, na, c, starts, x, av, scalars,
                                      B: int, mode: int = MODE_LSQ,
                                      precision: str = "highest", rs=None,
                                      f=None):
    """Plain PyTorch version of :func:`point_saga_multistep_streamed`: the
    first ``f`` of the K steps (all K when ``f`` is None); the masked
    steps leave c, x and av as they are. Reads ``f`` on the host."""
    live = starts.shape[0] if f is None else min(starts.shape[0], int(f))
    return _point_saga_steps_ref(A, b, na, c, starts[:live], x, av, scalars,
                                 B, mode, precision, rs,
                                 "point_saga_multistep_streamed_ref")


def point_saga_multistep(A, b, na, c, starts, x, av, scalars, B: int,
                         mode: int = MODE_LSQ, precision: str = "highest",
                         rs=None):
    """K = len(starts) Point-SAGA block steps (Defazio 2016, the block
    mean of the rows' prox points).

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:point_saga_multistep``. Step k takes
    the block [starts[k], starts[k] + B) of the rows ``A`` (N, n), stored
    f32, bf16 or int8 (then ``rs`` holds the (N,) f32 dequant scales):
    with v = x − γ·av it takes each row's margin at its prox point,
    m_z = a_i·v + γ·c_i·na_i, solves the row's prox θ_i
    (:func:`pointprox_theta` for the oracle formula ``mode``), writes
    c_i ← θ_i, and with u = Σ (c_i_old − θ_i)·a_i steps x ← v + (γ/B)·u,
    av ← av − u/N. ``na`` (N,) holds the row square-norms ‖a_i‖² (for
    int8 rows the dequantized ones); ``scalars`` is the (6,) f32 row
    [scale, γ, 1/B, 1/N, mode, aux]. ``c``, ``x`` and ``av`` are updated
    in place and returned; x is the iterate, never v.

    CPU tensors take the plain version :func:`point_saga_multistep_ref`;
    CUDA tensors launch the kernel or raise.

    The step is :func:`saga_coeff_multistep`'s with the coefficient
    formula replaced by the θ-solve: bound by the block's rows,
    B·n·itemsize bytes (16 MB f32, 4 MB int8 at the headline), plus b,
    na, rs and the c slice. The whole call is one cooperative launch of
    the persistent engine (``csrc/loopless_steps.cuh``, method
    ``kPointSagaSteps``), through the C entry of
    :func:`point_saga_multistep_streamed` with no clamp count: the two
    share one build and their bits. Every CTA forms step 0's v from x and
    av; each finish writes x and av for its columns, and the next step's v
    but after the call's last step. The table is written in the call and
    never prefetched (the formula thread of a row reads c_old behind the
    barriers), the square-norms ride the producer's ring beside b and rs.
    Logistic and Poisson rows take 20
    Newton steps a row (an ``expf`` and two IEEE divisions each), a chain
    of 4.2-4.5 µs on an H100, so where a step has several stages their
    step takes the margins of all its stages first, then solves every row
    of the CTA's share at once, a thread a row, and then adds the stages
    into its column sums: one chain a step, where the step's stages fit
    the ring, a thread takes a row and n ≤ 4,096 (every storage at n =
    1,024 and B = 4,096 or 1,024, and at n = 128; f32 rows of 2,048
    columns or more at B = 4,096 take one chain a stage). The closed
    forms take a stage at a time, as the other formulas do. The mode is a value of the call (one build for all five
    formulas: a uniform branch a row, where the TPU kernel specializes
    statically). A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return point_saga_multistep_ref(A, b, na, c, starts, x, av, scalars,
                                        B, mode=mode, precision=precision,
                                        rs=rs)
    if A.device.type != "cuda":
        raise ValueError(f"point_saga_multistep: no kernel for {A.device}")
    if mode not in _POINTPROX_MODES:
        raise ValueError(f"no Point-SAGA θ for oracle mode {mode}")
    v = torch.empty_like(x)
    _loopless_launch("point_saga_multistep_streamed", A, b, rs,
                     dict(c=c, na=na), starts, B, precision, scalars, 6,
                     (int(mode), None), dict(x=x, av=av, v=v))
    point_saga_multistep.launches += 1
    point_saga_multistep.steps += starts.shape[0]
    return c, x, av


def point_saga_multistep_streamed(A, b, na, c, starts, x, av, scalars,
                                  B: int, mode: int = MODE_LSQ,
                                  precision: str = "highest", rs=None,
                                  f=None):
    """K = len(starts) Point-SAGA block steps for any N, with the steps
    k ≥ ``f`` masked.

    Replaces the Pallas TPU kernel
    ``ciao_tpu/ops/fused_block.py:point_saga_multistep_streamed``.
    Arguments and in-place updates are those of
    :func:`point_saga_multistep`, plus ``f``: the clamp count, a
    one-element int32 tensor on the rows' device, or None for K. A masked
    step writes neither c nor x nor av. CPU tensors take the plain version
    :func:`point_saga_multistep_streamed_ref`; CUDA tensors launch the
    kernel or raise.

    The TPU kernel streams c through aliased windows, so its driver
    clamps each launch at the first same-launch revisit. Here c lives in
    device memory, read and written in place by the one launch, a block
    revisited within the call reading the previous visit's c: the port's
    driver launches with ``f`` = None, and the ``f < K`` semantics stay
    for the tests. ``f`` is read once on the device (no host sync): the
    call processes min(K, f) steps, and f = 0 returns before it forms
    step 0's v. The design is :func:`point_saga_multistep`'s
    (``csrc/loopless_steps.cuh``, method ``kPointSagaSteps``; one C entry
    serves both): at the 10,485,760 × 128 deep target (B = 8,192) a step
    reads 4 MB of f32 rows (1 MB int8), 128 CTAs of 64 rows, one stage a
    step in every storage, so each CTA solves its 64 rows' θ at once, one
    Newton chain a step for logistic and Poisson rows; the rows are split
    over eight row groups of a warp, as
    :func:`saga_coeff_multistep_streamed` takes them. Any start in
    [0, N − B] is taken. A grid that cannot be resident at once raises
    ``RuntimeError``.
    """
    if A.device.type == "cpu":
        return point_saga_multistep_streamed_ref(
            A, b, na, c, starts, x, av, scalars, B, mode=mode,
            precision=precision, rs=rs, f=f)
    if A.device.type != "cuda":
        raise ValueError(f"point_saga_multistep_streamed: no kernel for "
                         f"{A.device}")
    if mode not in _POINTPROX_MODES:
        raise ValueError(f"no Point-SAGA θ for oracle mode {mode}")
    f = _check_f(f, A.device)
    v = torch.empty_like(x)
    _loopless_launch("point_saga_multistep_streamed", A, b, rs,
                     dict(c=c, na=na), starts, B, precision, scalars, 6,
                     (int(mode), _ptr(f)), dict(x=x, av=av, v=v))
    point_saga_multistep_streamed.launches += 1
    point_saga_multistep_streamed.steps += starts.shape[0]
    return c, x, av


# Launches of the CUDA kernels (one per wrapper call that reaches one),
# and those of them with direction weights (importance sampling); the step
# kernels' steps (K = len(starts) a launch, one block a block update).
saga_coeff_multistep.launches = 0
saga_coeff_multistep.weighted_launches = 0
saga_coeff_multistep_streamed.launches = 0
saga_coeff_multistep_streamed.weighted_launches = 0
svrg_coeff_multistep.launches = 0
coeff_apply_all.launches = 0
coeff_value_apply_all.launches = 0
finito_coeff_multistep.launches = 0
finito_coeff_multistep_streamed.launches = 0
lfinito_sweep_multistep.launches = 0
saga_block_update.launches = 0
finito_block_update.launches = 0
proshi_multistep.launches = 0
katyusha_coeff_multistep.launches = 0
sarah_multistep.launches = 0
lsvrg_coeff_multistep.launches = 0
lkatyusha_coeff_multistep.launches = 0
ssnm_multistep.launches = 0
ssnm_multistep_streamed.launches = 0
point_saga_multistep.launches = 0
point_saga_multistep_streamed.launches = 0
saga_block_update.steps = 0
finito_block_update.steps = 0
saga_coeff_multistep.steps = 0
saga_coeff_multistep_streamed.steps = 0
svrg_coeff_multistep.steps = 0
finito_coeff_multistep.steps = 0
finito_coeff_multistep_streamed.steps = 0
lfinito_sweep_multistep.steps = 0
proshi_multistep.steps = 0
katyusha_coeff_multistep.steps = 0
sarah_multistep.steps = 0
lsvrg_coeff_multistep.steps = 0
lkatyusha_coeff_multistep.steps = 0
ssnm_multistep.steps = 0
ssnm_multistep_streamed.steps = 0
point_saga_multistep.steps = 0
point_saga_multistep_streamed.steps = 0
