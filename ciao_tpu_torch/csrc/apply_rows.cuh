// The one-pass walk over all rows shared by kernel #6 (coeff_apply_all.cu) and
// kernel #7 (coeff_value_apply_all.cu) on an NVIDIA Hopper card (sm_90a):
// every row's coefficient c_i = c(a_i . z), written out, and the full gradient
// sum gsum = sum_i c_i a_i (x rs_i for int8 rows), two-sum compensated; with
// kValue also the loss sum val = sum_i f_i(z) from the same margins, two-sum
// compensated the same way.
//
// Replaces the Pallas TPU kernels ciao_tpu/ops/fused_block.py:coeff_apply_all
// and coeff_value_apply_all (bodies _coeff_apply_kernel and
// _coeff_value_apply_kernel, compensation _comp_add). The Python wrappers are
// in ciao_tpu_torch/ops/fused_block.py, beside the plain PyTorch versions
// coeff_apply_all_ref and coeff_value_apply_all_ref; the wrappers pick the
// tile's R rows (_apply_rows there: as many whole rows as fit 48 KB, 1 to
// kMaxRows, fewer where that keeps two CTAs an SM) and the plain versions
// sum by the same tiles.
//
// What bounds it. The pass must read A once: N.n.itemsize bytes, 1 GiB f32
// and 256 MiB int8 at 262,144 x 1,024, against 4.N.n flops (1.07 GFLOP
// there: about 16 us at the card's 67 TFLOP/s of f32 outside the tensor
// cores, against 87-350 us of bytes at 3.35 TB/s). It is bound by bytes, by
// a factor of 5 to 20, so tensor cores would buy nothing: the work is two
// matrix-vector products, one operation per byte or less, and a wgmma would
// need the int8 and f32 rows converted to its operand types first. What the
// walk must do is keep the copies in flight and spend few instructions per
// byte. On an H100 this walk reads f32 and bf16 rows at 88-96 % of the read
// ceiling at n = 128 to 1,024, int8 rows at about 60 %: widening a value (a
// PRMT and an FADD) twice, for the margin and for the column sum, beside its
// two FMAs, takes more issue slots than the SM has for those bytes; rows of
// 4,096 to 16,384 columns, 1 to 11 rows a tile, at 19-71 %
// (tools/apply_walk_times.py, PERF.md). Three things held the first walk
// (32-row tiles, a cp.async double buffer, per-column (hi, lo) pairs in
// device memory) further below:
//   (1) int8 values were widened by I2F (16 a clock per SM) twice, once per
//       use, and f32 rows at "default" precision rounded to bf16 by two F2F
//       per use: 2 x 268M conversions at the headline, more time than the
//       bytes;
//   (2) narrow rows were latency-bound per tile: at n = 128 a 32-row tile is
//       4 KB int8, and each paid three barriers, a device-memory round trip
//       of the CTA's column pairs and a column pass in which 32 of the 256
//       threads worked down a 32-row chain;
//   (3) one tile ahead was all that was in flight, and the (hi, lo) pairs
//       went through L2 on every tile.
//
// The walk, two launches on one stream:
//
//   (a) apply_rows_kernel: a grid of G CTAs (one or two per SM) walks the
//       ceil(N / R) tiles of R rows, tile t going to CTA t mod G; against
//       (1)-(3):
//       - tiles sized by bytes: up to n = 4,096, R = min(256, 48 KB / row
//         bytes) whole rows (256 rows at n = 128 int8, 96 f32; 12-48 at
//         n = 1,024), fewer where two CTAs would not fit an SM (2 f32 rows
//         at n = 4,096), in a ring of kStages = 2 stages a CTA, two CTAs an
//         SM; wider rows take the wide walk (kWide: 64 register columns a
//         thread, one CTA an SM, its tiles as many rows as fit all of the
//         SM's shared memory: 2 f32 rows at n = 8,192); each
//         stage is filled by one thread's bulk copy (cp.async.bulk, TMA's
//         one-dimensional form: a tile of consecutive rows is one
//         contiguous range) completing on the stage's mbarrier, so the other
//         threads spend no instruction on copies, and while the SM's two
//         CTAs use a tile each, two more are in flight (3). On an H100 the
//         pass was bound by its fixed work a tile, not by the depth of the
//         ring: three stages of 32 KB ran no faster than two of 32 KB, and
//         two of 48 KB (three do not fit two CTAs an SM; one CTA an SM ran
//         at about half the rate) were up to 12 % faster than three of 32
//         KB (PERF.md). The offsets b (and rs) of each
//         stage's rows ride beside it by cp.async, one row a thread. Rows
//         that are not whole 16-byte chunks, or an A that is not 16-byte
//         aligned, take a plain path (kVec false): the tile copied by all
//         threads, one value each, into stage 0;
//       - the margins: groups of LPR lanes (the row's 16-byte chunks, 8 to
//         32: 8 at n = 128 int8) each take eight rows at once; a lane reads
//         its z chunk once for the eight, and three halving shuffle steps
//         over the group leave each lane one row's margin (seven shuffles
//         for eight rows, where a tree a row takes forty), so the lanes
//         apply the formula to their rows side by side, write c_i and leave
//         the weighted coefficient in shared memory; the slots a warp has
//         no rows for (one row a warp at n = 1,024 f32) issue nothing. A
//         tile of at most half as many rows as groups (wide rows, a ragged
//         last tile) splits each row's chunks over several groups, whose
//         parts are added in a fixed order: with a row a warp, one warp of
//         eight would otherwise do a tile's margins, which then took most
//         of a pass at one or two rows a tile;
//       - each value widened at full rate (1): int8 by the byte-permute
//         trick (an XOR, a PRMT into 0x4B0000xx and one FADD of 2^23 + 128:
//         exact), bf16 by a shift, f32 at "default" rounded to bf16 once
//         per value (a packed F2FP per two values) and written back in
//         place, so that the column pass reads it rounded;
//       - the column sums in registers (2): every thread owns a fixed unit
//         (four columns, one on the plain path) and a fixed row slice for the
//         whole walk (at n = 128: 32 units x 8 slices, all 256 threads); a
//         tile's slice partials are combined in shared memory in slice
//         order and two-summed into the owner's (hi, lo) registers, written
//         to hi_part, lo_part once, at the end. A thread keeps 16 columns in
//         registers (n <= 4,096, under 128 registers: two CTAs an SM), or
//         64 in the wide walk (n <= 16,384 = MAX_COLS, 211-254 registers:
//         one CTA). Pairs kept in device memory instead, read and written
//         once a tile, cost more traffic than the rows at 1-4 rows a tile;
//       - with kValue: each row's margin is left in shared memory; warp w
//         computes the values of rows 32w .. 32w + 31 (the transcendental
//         terms one lane a row), adds them by an xor tree in plain f32, and
//         the W = ceil(R / 32) warp sums are added in warp order: the tile's
//         sum, two-summed into the CTA's value pair (vhi, vlo: (G,));
//   (b) apply_finish_kernel: per column, the G pairs combined by two-sum in a
//       fixed order, gsum = hi + lo; with kValue one more block combines the
//       G value pairs the same way. No atomics: runs repeat bit for bit, and
//       kernel #7's c and gsum are kernel #6's to the bit (the same tiles,
//       the same code with the value column off).
//
// The two-sum runs on __fadd_rn/__fsub_rn, which the compiler neither
// contracts nor reassociates, so the compensation survives -O3: the error of
// the cross-tile sum is O(eps^2) of the sum of magnitudes, the TPU kernel's
// bound, at R-row tiles instead of its _pick_tile rows.

#pragma once

#include "row_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = kThreads;  // the value column takes one row a thread
constexpr int kStages = 2;
// columns whose (hi, lo) pair a thread keeps in registers: 16 (n up to
// 4,096, two CTAs an SM) or, in the wide walk, 64 (n up to 16,384, one CTA)
constexpr int kNarrowCols = 16;
constexpr int kWideCols = 64;
constexpr size_t kMaxSmem = 232448;

// Knuth two-sum: (hi, lo) <- (hi, lo) + p, the rounding error of the add
// kept exactly in lo (ops/fused_block.py _comp_add).
__device__ __forceinline__ void two_sum(float& hi, float& lo, float p) {
  const float s = __fadd_rn(hi, p);
  const float t = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(p, t), __fsub_rn(hi, __fsub_rn(s, t)));
  lo = __fadd_rn(lo, e);
  hi = s;
}

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory of a CTA (ops/fused_block.py _apply_smem_bytes): the ring,
// z, two floats a row (the weighted coefficient, the margin), b and rs of
// each stage's rows, the slice partials (four floats a thread), the warps'
// value sums and the stages' mbarriers.
__host__ __device__ __forceinline__ size_t apply_smem_bytes(int rows, int n,
                                                           int itemsize) {
  return kStages * tile_bytes(rows, n, itemsize) + round16(4 * size_t(n)) +
         8 * size_t(rows) * (1 + kStages) + 16 * kThreads + 4 * kWarps +
         8 * kStages;
}

// Threads across the columns of the column pass: the units (four columns on
// the 16-byte path, one on the plain path), rounded up to a power of two,
// at most all of them; the others are row slices.
__host__ __device__ __forceinline__ int column_threads(int units) {
  int ct = 1;
  while (ct < units && ct < kThreads) ct *= 2;
  return ct;
}

// Wait for this thread's cp.async groups but the newest kStages - 1.
__device__ __forceinline__ void wait_groups_but_newest() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
}

// One 16-byte chunk at `p` (shared memory) against the matching z values
// `zc` (registers), added to the row's partial `acc` by one FMA a value; f32
// rows at kLowp are rounded to bf16 here, once, and written back in place
// for the column pass.
// f32 rows: the chunk's four products summed first, then added, as the
// first walk summed them (its margins, and so its c, are these bits)
template <bool kLowp>
__device__ __forceinline__ float chunk_dot(float* p, const float* zc,
                                           float acc) {
  float4 x = *reinterpret_cast<const float4*>(p);
  if (kLowp) {
    x = round4_bf16(x);
    *reinterpret_cast<float4*>(p) = x;
  }
  return acc + (x.x * zc[0] + x.y * zc[1] + x.z * zc[2] + x.w * zc[3]);
}
template <bool kLowp>
__device__ __forceinline__ float chunk_dot(__nv_bfloat16* p, const float* zc,
                                           float acc) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[2];
    widen2_bf16(ws[q], v);
    acc = fmaf(v[0], zc[2 * q], acc);
    acc = fmaf(v[1], zc[2 * q + 1], acc);
  }
  return acc;
}
template <bool kLowp>
__device__ __forceinline__ float chunk_dot(int8_t* p, const float* zc,
                                           float acc) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[4];
    widen4_i8(ws[q], v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc = fmaf(v[e], zc[4 * q + e], acc);
  }
  return acc;
}

// The sums over a group of lpr lanes (8, 16 or 32) of each lane's partials
// p[0..7] of eight rows: three halving steps (offsets lpr/2, lpr/4, lpr/8),
// in each of which a lane keeps half of its rows and sends its partner the
// other half, leave lane gl the partial of row gl / (lpr / 8); plain steps
// over the lanes that share a row finish it. Seven shuffles and up to two
// for eight rows.
__device__ __forceinline__ float group_sums8(float (&p)[8], int lpr, int gl) {
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) {
    const int off = lpr / 8 * m;
    const bool up = (gl & off) != 0;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = up ? p[i] : p[i + m];
      const float keep = up ? p[i + m] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  for (int off = lpr / 16; off > 0; off >>= 1)
    p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
  return p[0];
}

// One value of the plain path as the dot sees it; f32 rows at kLowp rounded
// once and written back.
template <bool kLowp>
__device__ __forceinline__ float plain_value(float* p) {
  if (!kLowp) return *p;
  const float v = bf16_round(*p);
  *p = v;
  return v;
}
template <bool kLowp>
__device__ __forceinline__ float plain_value(__nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <bool kLowp>
__device__ __forceinline__ float plain_value(int8_t* p) {
  return static_cast<float>(*p);
}

// The values of a column unit of one row in shared memory (already rounded
// where kLowp rounds f32 rows): four on the 16-byte path, one otherwise.
template <bool kVec>
__device__ __forceinline__ void unit_values(const float* p, float (&v)[4]) {
  if (kVec) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = *p;
  }
}
template <bool kVec>
__device__ __forceinline__ void unit_values(const __nv_bfloat16* p,
                                            float (&v)[4]) {
  if (kVec) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    widen2_bf16(x.x, v);
    float hi[2];
    widen2_bf16(x.y, hi);
    v[2] = hi[0], v[3] = hi[1];
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <bool kVec>
__device__ __forceinline__ void unit_values(const int8_t* p, float (&v)[4]) {
  if (kVec)
    widen4_i8(*reinterpret_cast<const unsigned*>(p), v);
  else
    v[0] = static_cast<float>(*p);
}

// sc = [scale, mode, aux]. hi_part, lo_part: (G, n); vhi, vlo: (G,).
template <typename T, bool kLowp, bool kVec, bool kValue, bool kWide>
__global__ void __launch_bounds__(kThreads, kWide ? 1 : 2)
apply_rows_kernel(const T* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ rs, const float* __restrict__ z,
                  const float* __restrict__ sc, float* __restrict__ c,
                  float* __restrict__ hi_part, float* __restrict__ lo_part,
                  float* __restrict__ vhi, float* __restrict__ vlo, int64_t N,
                  int n, int rows) {
  constexpr int kUnit = kVec ? 4 : 1;         // columns of a unit
  constexpr int kRegUnits = (kWide ? kWideCols : kNarrowCols) / kUnit;
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t tb = tile_bytes(rows, n, sizeof(T));
  auto stage_ptr = [&](int s) { return reinterpret_cast<T*>(smem + s * tb); };
  float* zs = reinterpret_cast<float*>(smem + kStages * tb);
  float* cws = zs + round16(4 * size_t(n)) / 4;
  float* ms = cws + rows;
  float* bq = ms + rows;  // kStages x rows
  float* rq = bq + kStages * rows;
  float* part = rq + kStages * rows;  // kThreads x 4
  float* part_m = part;  // a split row's parts (the margin pass; see below)
  float* vw = part + 4 * kThreads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vw + kWarps);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tiles = (N + rows - 1) / rows;
  const int64_t G = gridDim.x;
  const int count = static_cast<int>((tiles - blockIdx.x + G - 1) / G);
  const size_t row_bytes = static_cast<size_t>(n) * sizeof(T);
  auto tile_of = [&](int k) { return blockIdx.x + k * G; };
  auto rows_of = [&](int64_t t) {
    const int64_t left = N - t * rows;
    return left < rows ? static_cast<int>(left) : rows;
  };

  for (int j = tid; j < n; j += kThreads) {
    const float v = z[j];
    zs[j] = kLowp ? bf16_round(v) : v;
  }
  if (kVec && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (kVec && tid == 0)
    for (int k = 0; k < kStages && k < count; ++k) {
      const int64_t t = tile_of(k);
      bulk_load(stage_ptr(k), A + t * rows * n,
                static_cast<unsigned>(rows_of(t) * row_bytes), &bars[k]);
    }
  // the offsets (and scales) of tile k into the stage's slots by cp.async,
  // one row a thread, one group a tile for every thread
  auto stage_offsets = [&](int k) {
    const int64_t t = tile_of(k);
    if (k < count && tid < rows_of(t)) {
      const int at = (k % kStages) * rows + tid;
      __pipeline_memcpy_async(bq + at, b + t * rows + tid, 4);
      if (rs != nullptr)
        __pipeline_memcpy_async(rq + at, rs + t * rows + tid, 4);
    }
    __pipeline_commit();
  };
  for (int k = 0; k < kStages; ++k) stage_offsets(k);

  // the margin pass: groups of lpr lanes (the row's 16-byte chunks, 8 to
  // 32) each take eight rows at once, rows slot, slot + stride, ... of a
  // block of 8 * stride rows; lane gl ends with row gl / (lpr / 8)
  const int chunks = kVec ? static_cast<int>(row_bytes / 16) : n;
  int lpr = 8;
  while (lpr * 2 <= chunks && lpr < 32) lpr *= 2;
  const int gl = lane & (lpr - 1);
  const int stride = kWarps * (32 / lpr);
  const int slot = warp * (32 / lpr) + lane / lpr;
  const int mine = gl / (lpr / 8);
  const bool owner = (gl & (lpr / 8 - 1)) == 0;
  // the column pass: unit cu of the row slice sl
  const int units = n / kUnit;
  const int ct = column_threads(units);
  const int slices = kThreads / ct;
  const int sl = tid / ct;
  const int cu = tid % ct;
  const int value_warps = (rows + 31) / 32;

  float hi[kRegUnits][kUnit], lo[kRegUnits][kUnit];
#pragma unroll
  for (int k = 0; k < kRegUnits; ++k)
#pragma unroll
    for (int q = 0; q < kUnit; ++q) hi[k][q] = lo[k][q] = 0.0f;
  float vh = 0.0f, vl = 0.0f;  // the value pair, kept by thread 0
  const float scale = sc[0];
  const int mode = static_cast<int>(sc[1]);
  const float aux = sc[2];

  for (int k = 0; k < count; ++k) {
    const int64_t t = tile_of(k);
    const int64_t row0 = t * rows;
    const int here = rows_of(t);
    const int s = k % kStages;
    T* tile = stage_ptr(kVec ? s : 0);
    const float* bs = bq + s * rows;
    const float* rss = rq + s * rows;
    wait_groups_but_newest();
    if (kVec) {
      mbar_wait(&bars[s], (k / kStages) & 1);
    } else {
      const T* src = A + row0 * n;
      for (int i = tid; i < here * n; i += kThreads) tile[i] = src[i];
    }
    __syncthreads();

    // margins, coefficients
    auto finish_row = [&](int r, float m) {
      if (rs != nullptr) m *= rss[r];
      const float ci = coeff_formula(mode, m, bs[r], scale, aux);
      c[row0 + r] = ci;
      const float cw = rs != nullptr ? ci * rss[r] : ci;
      cws[r] = kLowp ? bf16_round(cw) : cw;
      if (kValue) ms[r] = m;
    };
    // each row split over sp groups (a power of two), group sub of them
    // taking the chunks sub, sub + sp, ... of each lane's share, where that
    // evens out the groups' work: a group takes ceil(here * sp / stride)
    // rows of 1 / sp of a row's chunks, and the smallest sp that makes that
    // least is taken (1 where the rows fill the groups evenly; at 1 to 4
    // rows and 8 groups, one warp a group, 8 / here: wide rows, a ragged
    // last tile). Each lane keeps at least two chunks a row, and the parts
    // (here * sp of them) fit part_m; they are added in order below.
    int sp = 1;
    {
      int cost = (here + stride - 1) / stride;  // over sp
      for (int q = 2; q <= stride && 2 * lpr * q <= chunks &&
                      here * q <= 4 * kThreads;
           q *= 2) {
        const int c_q = (here * q + stride - 1) / stride;
        if (c_q * sp < cost * q) cost = c_q, sp = q;
      }
    }
    const int gstride = stride / sp;
    const int gslot = slot / sp;
    const int sub = slot % sp;
    for (int r0 = 0; r0 < here; r0 += 8 * gstride) {
      float p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i] = 0.0f;
      // the rows the warp's first group fills in this block, the same for
      // its lanes: at n = 1,024 f32 one row a warp, so the seven empty
      // slots issue nothing, and a warp with none skips the chunks
      const int fill =
          (here - r0 - warp * (32 / lpr) / sp + gstride - 1) / gstride;
      if (kVec && fill > 0) {
        constexpr int kPer16 = 16 / sizeof(T);
#pragma unroll 2
        for (int ch = gl + lpr * sub; ch < chunks; ch += lpr * sp) {
          float zc[kPer16];
#pragma unroll
          for (int q = 0; q < kPer16; q += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(zs + ch * kPer16 + q);
            zc[q] = t.x, zc[q + 1] = t.y, zc[q + 2] = t.z, zc[q + 3] = t.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i >= fill) break;
            const int r = r0 + i * gstride + gslot;
            if (r < here)
              p[i] = chunk_dot<kLowp>(
                  tile + static_cast<size_t>(r) * n + ch * kPer16, zc, p[i]);
          }
        }
      } else if (fill > 0) {
        for (int j = gl + lpr * sub; j < n; j += lpr * sp) {
          const float zj = zs[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i >= fill) break;
            const int r = r0 + i * gstride + gslot;
            if (r < here)
              p[i] = fmaf(
                  plain_value<kLowp>(tile + static_cast<size_t>(r) * n + j),
                  zj, p[i]);
          }
        }
      }
      const float m = group_sums8(p, lpr, gl);
      const int r = r0 + mine * gstride + gslot;
      if (owner && r < here) {
        if (sp == 1)
          finish_row(r, m);
        else
          part_m[r * sp + sub] = m;
      }
    }
    if (sp > 1) {
      __syncthreads();
      for (int r = tid; r < here; r += kThreads) {
        float m = part_m[r * sp];
        for (int q = 1; q < sp; ++q) m += part_m[r * sp + q];
        finish_row(r, m);
      }
    }
    if (kVec && kLowp && sizeof(T) == 4)  // rounded rows before the next copy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    if (kValue && warp < value_warps) {
      // warp w takes rows 32w + lane; the rows past the tile add 0; the xor
      // tree's order is fixed (the plain version mirrors it)
      const int r = warp * 32 + lane;
      float v = r < here ? value_formula(mode, ms[r], bs[r], scale, aux)
                         : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) vw[warp] = v;
    }
    // the tile's sum of cw_r a_r over the slice's rows r = sl, sl + slices,
    // ..., per unit: into the registers (one slice) or the slice partials
    auto unit_sum = [&](int u, float (&acc)[4]) {
      acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
      const T* col = tile + u * kUnit;
#pragma unroll 8
      for (int r = sl; r < here; r += slices) {
        float v[4];
        unit_values<kVec>(col + static_cast<size_t>(r) * n, v);
        const float w = cws[r];
#pragma unroll
        for (int q = 0; q < kUnit; ++q) acc[q] += w * v[q];
      }
    };
    float acc0[kUnit] = {};
#pragma unroll
    for (int kq = 0; kq < kRegUnits; ++kq) {
      const int u = cu + kq * ct;
      if (u < units) {
        float acc[4];
        unit_sum(u, acc);
        if (slices == 1) {
#pragma unroll
          for (int q = 0; q < kUnit; ++q) two_sum(hi[kq][q], lo[kq][q], acc[q]);
        } else {  // one unit a thread (units <= ct)
#pragma unroll
          for (int q = 0; q < kUnit; ++q) {
            part[4 * tid + q] = acc[q];
            acc0[q] = acc[q];
          }
        }
      }
    }
    __syncthreads();

    // the stage is read: its next tile may land in it
    if (kVec && tid == 0 && k + kStages < count) {
      const int64_t tn = tile_of(k + kStages);
      bulk_load(tile, A + tn * rows * n,
                static_cast<unsigned>(rows_of(tn) * row_bytes), &bars[s]);
    }
    stage_offsets(k + kStages);
    if (slices > 1 && sl == 0 && cu < units) {
      // the slices' partials in slice order, then the owner's pair
#pragma unroll
      for (int q = 0; q < kUnit; ++q) {
        float p = acc0[q];
#pragma unroll 4
        for (int o = 1; o < slices; ++o) p += part[4 * (o * ct + cu) + q];
        two_sum(hi[0][q], lo[0][q], p);
      }
    }
    if (kValue && tid == 0) {
      float v = vw[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        if (w < value_warps) v = __fadd_rn(v, vw[w]);
      two_sum(vh, vl, v);
    }
  }

  if (sl == 0) {
    float* hip = hi_part + static_cast<int64_t>(blockIdx.x) * n;
    float* lop = lo_part + static_cast<int64_t>(blockIdx.x) * n;
#pragma unroll
    for (int kq = 0; kq < kRegUnits; ++kq) {
      const int u = cu + kq * ct;
      if (u < units)
#pragma unroll
        for (int q = 0; q < kUnit; ++q) {
          hip[u * kUnit + q] = hi[kq][q];
          lop[u * kUnit + q] = lo[kq][q];
        }
    }
  }
  if (kValue && tid == 0) {
    vhi[blockIdx.x] = vh;
    vlo[blockIdx.x] = vl;
  }
}

// Column j = blockIdx.x * 32 + lane: warp w two-sums the pairs p = w, w + 8,
// ...; warp 0 then combines the eight pairs in order. gsum = hi + lo. With a
// value sum (val not null) the grid has one block more, which treats the
// (G,) value pairs as one more column of width 1: val = hi + lo.
__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
apply_finish_kernel(const float* __restrict__ hi_part,
                    const float* __restrict__ lo_part, int parts,
                    float* __restrict__ gsum, int n,
                    const float* __restrict__ vhi,
                    const float* __restrict__ vlo, float* __restrict__ val) {
  __shared__ float red_hi[kFinishWarps][kFinishCols];
  __shared__ float red_lo[kFinishWarps][kFinishCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool value = blockIdx.x * kFinishCols >= n;  // the value block
  const float* hp = value ? vhi : hi_part;
  const float* lp = value ? vlo : lo_part;
  const int width = value ? 1 : n;
  float* out = value ? val : gsum;
  const int j = (value ? 0 : blockIdx.x * kFinishCols) + lane;
  float h = 0.0f, l = 0.0f;
  if (j < width)
    for (int p = warp; p < parts; p += kFinishWarps) {
      const int64_t o = static_cast<int64_t>(p) * width + j;
      two_sum(h, l, hp[o]);
      l = __fadd_rn(l, lp[o]);
    }
  red_hi[warp][lane] = h;
  red_lo[warp][lane] = l;
  __syncthreads();
  if (warp != 0 || j >= width) return;
  h = 0.0f;
  l = 0.0f;
#pragma unroll
  for (int w = 0; w < kFinishWarps; ++w) {
    two_sum(h, l, red_hi[w][lane]);
    l = __fadd_rn(l, red_lo[w][lane]);
  }
  out[j] = __fadd_rn(h, l);
}

template <typename T, bool kLowp, bool kVec, bool kValue, bool kWide>
cudaError_t run_apply(const void* A, const float* b, const float* rs,
                      const float* z, const float* sc, float* c, float* gsum,
                      float* hi_part, float* lo_part, float* val, float* vhi,
                      float* vlo, int64_t N, int n, int rows, int ctas,
                      cudaStream_t stream) {
  const size_t smem = apply_smem_bytes(rows, n, sizeof(T));
  auto kernel = apply_rows_kernel<T, kLowp, kVec, kValue, kWide>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<ctas, kThreads, smem, stream>>>(static_cast<const T*>(A), b, rs, z,
                                           sc, c, hi_part, lo_part, vhi, vlo,
                                           N, n, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int blocks = (n + kFinishCols - 1) / kFinishCols + (kValue ? 1 : 0);
  apply_finish_kernel<<<blocks, kFinishCols * kFinishWarps, 0, stream>>>(
      hi_part, lo_part, ctas, gsum, n, vhi, vlo, val);
  return cudaGetLastError();
}

// The 16-byte path or the plain one; the wide walk past kNarrowCols columns
// a thread (n > 4,096).
template <typename T, bool kLowp, bool kValue>
cudaError_t dispatch_apply(bool vec, const void* A, const float* b,
                           const float* rs, const float* z, const float* sc,
                           float* c, float* gsum, float* hi_part,
                           float* lo_part, float* val, float* vhi, float* vlo,
                           int64_t N, int n, int rows, int ctas,
                           cudaStream_t stream) {
  const bool wide = n > kNarrowCols * kThreads;
  auto run = vec ? (wide ? run_apply<T, kLowp, true, kValue, true>
                         : run_apply<T, kLowp, true, kValue, false>)
                 : (wide ? run_apply<T, kLowp, false, kValue, true>
                         : run_apply<T, kLowp, false, kValue, false>);
  return run(A, b, rs, z, sc, c, gsum, hi_part, lo_part, val, vhi, vlo, N, n,
             rows, ctas, stream);
}

// The launches of either kernel: checks, the 16-byte test, the storage switch.
// Returns cudaGetLastError() after queueing the two launches (0 on success).
template <bool kValue>
int launch_apply(const void* A, int storage, int lowp, const float* b,
                 const float* rs, const float* z, const float* sc, float* c,
                 float* gsum, float* hi_part, float* lo_part, float* val,
                 float* vhi, float* vlo, long long N, int n, int rows,
                 int ctas, void* stream) {
  const int isz = storage_itemsize(storage);
  if (rows < 1 || rows > kMaxRows || n < 1 || n > kWideCols * kThreads ||
      N < 1 || ctas < 1 ||
      ctas > (N + rows - 1) / rows ||
      apply_smem_bytes(rows, n, isz) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_rows(A, n, isz);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (storage) {
    case kF32:
      e = lowp ? dispatch_apply<float, true, kValue>(
                     vec, A, b, rs, z, sc, c, gsum, hi_part, lo_part, val,
                     vhi, vlo, N, n, rows, ctas, st)
               : dispatch_apply<float, false, kValue>(
                     vec, A, b, rs, z, sc, c, gsum, hi_part, lo_part, val,
                     vhi, vlo, N, n, rows, ctas, st);
      break;
    case kBF16:
      e = dispatch_apply<__nv_bfloat16, true, kValue>(
          vec, A, b, rs, z, sc, c, gsum, hi_part, lo_part, val, vhi, vlo, N,
          n, rows, ctas, st);
      break;
    case kI8:
      e = dispatch_apply<int8_t, true, kValue>(
          vec, A, b, rs, z, sc, c, gsum, hi_part, lo_part, val, vhi, vlo, N,
          n, rows, ctas, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace
