// The one-pass walk over all rows shared by kernel #6 (coeff_apply_all.cu) and
// kernel #7 (coeff_value_apply_all.cu) on an NVIDIA Hopper card (sm_90a):
// every row's coefficient c_i = c(a_i . z), written out, and the full gradient
// sum gsum = sum_i c_i a_i (x rs_i for int8 rows), two-sum compensated; with
// kValue also the loss sum val = sum_i f_i(z) from the same margins, two-sum
// compensated the same way.
//
// Replaces the Pallas TPU kernels ciao_tpu/ops/fused_block.py:coeff_apply_all
// and coeff_value_apply_all (bodies _coeff_apply_kernel and
// _coeff_value_apply_kernel, compensation _comp_add). The Python wrappers and
// the design note are in ciao_tpu_torch/ops/fused_block.py, beside the plain
// PyTorch versions coeff_apply_all_ref and coeff_value_apply_all_ref.
//
// Two launches on one stream:
//
//   (a) apply_rows_kernel: a grid of G CTAs (about two per SM) walks the
//       ceil(N / R) tiles of R rows, tile t going to CTA t mod G. Each CTA
//       double-buffers its tiles in shared memory: the next tile's 16-byte
//       loads are in flight with cp.async while the current one is used, so
//       the rows leave device memory once. Per tile: the margins (one warp
//       per row, shuffle reduction), the formula, the write of c_i, and the
//       tile's sum over its rows of c_i a_i into the CTA's per-column (hi, lo)
//       two-sum pair, kept in device memory (hi_part, lo_part: (G, n)) and
//       read and written only by the thread that owns the column. With
//       kValue, each row's warp also leaves its margin and offset in shared
//       memory; after the tile's barrier warp 0 computes the R row values,
//       one lane a row (the transcendental terms of all rows at once, off
//       the rows' chains), adds them by a fixed shuffle tree in plain f32,
//       as the TPU kernel sums a tile, and lane 0 two-sums that into the
//       CTA's value pair, written once at the end (vhi, vlo: (G,));
//   (b) apply_finish_kernel: per column, the G pairs combined by two-sum in a
//       fixed order, gsum = hi + lo; with kValue one more block combines the
//       G value pairs the same way. No atomics: runs repeat bit for bit, and
//       kernel #7's c and gsum are kernel #6's to the bit.
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
constexpr int kMaxRows = 32;

// Knuth two-sum: (hi, lo) <- (hi, lo) + p, the rounding error of the add
// kept exactly in lo (ops/fused_block.py _comp_add).
__device__ __forceinline__ void two_sum(float& hi, float& lo, float p) {
  const float s = __fadd_rn(hi, p);
  const float t = __fsub_rn(s, hi);
  const float e = __fadd_rn(__fsub_rn(p, t), __fsub_rn(hi, __fsub_rn(s, t)));
  lo = __fadd_rn(lo, e);
  hi = s;
}

// Shared memory: two tile buffers (rows x n of T each), z (n floats), the
// rows' weighted coefficients cw (rows floats) and, with kValue, the rows'
// dequantized margins and offsets (rows floats each). sc = [scale, mode,
// aux].
template <typename T, bool kLowp, bool kVec, bool kValue>
__global__ void __launch_bounds__(kThreads)
apply_rows_kernel(const T* __restrict__ A, const float* __restrict__ b,
                  const float* __restrict__ rs, const float* __restrict__ z,
                  const float* __restrict__ sc, float* __restrict__ c,
                  float* __restrict__ hi_part, float* __restrict__ lo_part,
                  float* __restrict__ vhi, float* __restrict__ vlo, int64_t N,
                  int n, int rows) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const size_t tb = tile_bytes(rows, n, sizeof(T));
  auto buf = [&](int i) { return reinterpret_cast<T*>(smem + i * tb); };
  float* zs = reinterpret_cast<float*>(smem + 2 * tb);
  float* cws = zs + n;
  float* ms = cws + rows;
  float* bs = ms + rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tiles = (N + rows - 1) / rows;
  float* hi = hi_part + static_cast<int64_t>(blockIdx.x) * n;
  float* lo = lo_part + static_cast<int64_t>(blockIdx.x) * n;
  float vh = 0.0f, vl = 0.0f;  // the value pair, kept by thread 0

  // each thread zeroes the columns it owns in the transposed product below
  if (kVec) {
    for (int j = tid * 4; j < n; j += kThreads * 4) {
      *reinterpret_cast<float4*>(hi + j) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(lo + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int j = tid; j < n; j += kThreads) hi[j] = lo[j] = 0.0f;
  }
  for (int j = tid; j < n; j += kThreads) {
    const float v = z[j];
    zs[j] = kLowp ? bf16_round(v) : v;
  }
  const float scale = sc[0];
  const int mode = static_cast<int>(sc[1]);
  const float aux = sc[2];

  // rows of tile t (the last tile may be short)
  auto rows_of = [&](int64_t t) {
    const int64_t left = N - t * rows;
    return left < rows ? static_cast<int>(left) : rows;
  };
  auto stage = [&](T* dst, int64_t t) {
    stage_rows<T, kVec>(dst, A + t * rows * n, rows_of(t) * n, tid, kThreads);
  };
  int s = 0;
  if (blockIdx.x < tiles) stage(buf(0), blockIdx.x);
  if (kVec) __pipeline_commit();
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, s ^= 1) {
    // the other buffer was last read before the previous iteration's final
    // barrier, so the next tile may land in it now
    if (t + gridDim.x < tiles) stage(buf(s ^ 1), t + gridDim.x);
    if (kVec) {
      __pipeline_commit();
      __pipeline_wait_prior(1);  // all but the next tile's copies are done
    }
    __syncthreads();
    const T* tile = buf(s);
    const int64_t row0 = t * rows;
    const int here = rows_of(t);

    for (int r = warp; r < here; r += kWarps) {
      const int64_t i = row0 + r;
      float bi = 0.0f, rsi = 1.0f;
      if (lane == 0) {  // in flight while the warp runs its dot
        bi = b[i];
        if (rs != nullptr) rsi = rs[i];
      }
      float m = warp_dot<kLowp, kVec>(tile + r * n, zs, n, lane);
      if (lane == 0) {
        if (rs != nullptr) m *= rsi;
        const float ci = coeff_formula(mode, m, bi, scale, aux);
        c[i] = ci;
        const float cw = rs != nullptr ? ci * rsi : ci;
        cws[r] = kLowp ? bf16_round(cw) : cw;
        if (kValue) {
          ms[r] = m;
          bs[r] = bi;
        }
      }
    }
    __syncthreads();

    if (kValue && warp == 0) {
      // rows <= 32: lane r takes row r, the lanes past the tile add 0; the
      // xor tree's order is fixed (the plain version mirrors it)
      float v = lane < here ? value_formula(mode, ms[lane], bs[lane], scale,
                                            aux)
                            : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) two_sum(vh, vl, v);
    }
    // the tile's sum of cw_r a_r, per owned column, into the (hi, lo) pair
    if (kVec) {
      for (int j = tid * 4; j < n; j += kThreads * 4) {
        float acc[4];
        tile_colsum4<kLowp>(tile, cws, here, n, j, acc);
        float4 h = *reinterpret_cast<float4*>(hi + j);
        float4 l = *reinterpret_cast<float4*>(lo + j);
        two_sum(h.x, l.x, acc[0]);
        two_sum(h.y, l.y, acc[1]);
        two_sum(h.z, l.z, acc[2]);
        two_sum(h.w, l.w, acc[3]);
        *reinterpret_cast<float4*>(hi + j) = h;
        *reinterpret_cast<float4*>(lo + j) = l;
      }
    } else {
      for (int j = tid; j < n; j += kThreads) {
        float h = hi[j], l = lo[j];
        two_sum(h, l, tile_colsum<kLowp>(tile, cws, here, n, j));
        hi[j] = h;
        lo[j] = l;
      }
    }
    __syncthreads();
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

template <typename T, bool kLowp, bool kVec, bool kValue>
cudaError_t run_apply(const void* A, const float* b, const float* rs,
                      const float* z, const float* sc, float* c, float* gsum,
                      float* hi_part, float* lo_part, float* val, float* vhi,
                      float* vlo, int64_t N, int n, int rows, int ctas,
                      cudaStream_t stream) {
  const size_t smem =
      2 * tile_bytes(rows, n, sizeof(T)) +
      sizeof(float) * (static_cast<size_t>(n) +
                       static_cast<size_t>(rows) * (kValue ? 3 : 1));
  auto kernel = apply_rows_kernel<T, kLowp, kVec, kValue>;
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

template <typename T, bool kLowp, bool kValue>
cudaError_t dispatch_apply(bool vec, const void* A, const float* b,
                           const float* rs, const float* z, const float* sc,
                           float* c, float* gsum, float* hi_part,
                           float* lo_part, float* val, float* vhi, float* vlo,
                           int64_t N, int n, int rows, int ctas,
                           cudaStream_t stream) {
  return vec ? run_apply<T, kLowp, true, kValue>(
                   A, b, rs, z, sc, c, gsum, hi_part, lo_part, val, vhi, vlo,
                   N, n, rows, ctas, stream)
             : run_apply<T, kLowp, false, kValue>(
                   A, b, rs, z, sc, c, gsum, hi_part, lo_part, val, vhi, vlo,
                   N, n, rows, ctas, stream);
}

// The launches of either kernel: checks, the 16-byte test, the storage switch.
// Returns cudaGetLastError() after queueing the two launches (0 on success).
template <bool kValue>
int launch_apply(const void* A, int storage, int lowp, const float* b,
                 const float* rs, const float* z, const float* sc, float* c,
                 float* gsum, float* hi_part, float* lo_part, float* val,
                 float* vhi, float* vlo, long long N, int n, int rows,
                 int ctas, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 1 || N < 1 || ctas < 1 ||
      ctas > (N + rows - 1) / rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_rows(A, n, storage_itemsize(storage));
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
      e = dispatch_apply<int8_t, true, kValue>(vec, A, b, rs, z, sc, c, gsum,
                                               hi_part, lo_part, val, vhi,
                                               vlo, N, n, rows, ctas, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace
