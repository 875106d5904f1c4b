// SAGA/SAG coefficient-table block steps on an NVIDIA Hopper card (sm_90a):
// the device code shared by the two kernels of ciao_tpu_torch/ops/fused_block.py,
//
//   saga_coeff_multistep.cu           replaces ciao_tpu/ops/fused_block.py
//                                     saga_coeff_multistep (table resident);
//   saga_coeff_multistep_streamed.cu  replaces saga_coeff_multistep_streamed
//                                     (any N, steps k >= f masked).
//
// The Python wrappers and the design notes are in ops/fused_block.py; the plain
// PyTorch versions of the same arithmetic are the *_ref functions there.
//
// One solver step on the block [s, s + B) of the (N, n) rows A is two launches:
//
//   (a) saga_rows_kernel, B / R CTAs of R rows. The CTA's R rows are one
//       contiguous span of A: it is copied into shared memory with cp.async,
//       every 16-byte load in flight at once, and read from device memory only
//       this once. From shared memory: the margins a_i . z (one warp per row,
//       shuffle reduction), the int8 dequant scale, the coefficient formula,
//       the table write c_i <- c_new, and the CTA's partial innovation
//       sum_rows dc_i . a_i into part[cta, :];
//   (b) saga_finish_kernel, 32 columns per CTA: the partials summed in a fixed
//       order (no atomics, so runs repeat bit for bit), the running average, the
//       SAG or SAGA direction and the L1 soft-threshold.
//
// The K steps are issued from the host on one stream with no host sync; the
// stream order carries z, av and c from one step to the next. The block start
// of step k is read on the device from starts[k]. With a clamp count (fclamp
// not NULL, one int32 on the device) both launches of a step k >= *fclamp
// return before any other load, so a masked step writes nothing and leaves c,
// z and av bit for bit as the step before left them.
//
// Precision follows the Pallas kernel's _stream_dot: when kLowp is set (rows
// stored bf16 or int8, or f32 rows at "default" precision) both operands of
// each dot are rounded to bf16 and multiplied with f32 accumulation; int8 and
// bf16 row values are exact in bf16.
//
// Row offsets are 64-bit (start * n reaches 1.3e9 at the 10,485,760 x 128
// deep target); block starts are int32, which the wrappers check (N < 2^31).

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxRowsPerCta = 32;
constexpr int kFinishCols = 32;  // one warp's width of columns per CTA
constexpr int kFinishWarps = 8;  // warps splitting the partials of a column

enum Storage { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Mode { kLsq = 0, kLogistic = 1, kHuber = 2, kSqHinge = 3, kPoisson = 4 };
constexpr float kPoissonClamp = 30.0f;  // ops/fused_block.py POISSON_CLAMP

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Whether step k is masked by the clamp count (a uniform branch: every thread
// of the launch reads the same value).
__device__ __forceinline__ bool masked(const int* fclamp, int k) {
  return fclamp != nullptr && k >= *fclamp;
}

// A row value as the dot sees it: f32 rows round to bf16 when kLowp; bf16 and
// int8 values are exact in bf16 already.
template <bool kLowp>
__device__ __forceinline__ float row_value(float x) {
  return kLowp ? bf16_round(x) : x;
}
template <bool kLowp>
__device__ __forceinline__ float row_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <bool kLowp>
__device__ __forceinline__ float row_value(int8_t x) {
  return static_cast<float>(x);
}

// Four consecutive row values from shared memory (16, 8 or 4 bytes, aligned
// to their size): the vector reads of the kVec path.
template <bool kLowp>
__device__ __forceinline__ void row4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = row_value<kLowp>(x.x);
  v[1] = row_value<kLowp>(x.y);
  v[2] = row_value<kLowp>(x.z);
  v[3] = row_value<kLowp>(x.w);
}
// a bf16 value is the upper half of an f32; element 0 is the low half of the
// first word (little endian)
template <bool kLowp>
__device__ __forceinline__ void row4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
template <bool kLowp>
__device__ __forceinline__ void row4(const int8_t* p, float (&v)[4]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = static_cast<float>(static_cast<int8_t>(w >> (8 * q)));
}

// ops/fused_block.py _coeff_formula: c_i from the (dequantized) margin r.
__device__ __forceinline__ float coeff_formula(int mode, float r, float b,
                                               float scale, float aux) {
  switch (mode) {
    case kLsq:
      return scale * (r - b);
    case kLogistic:
      return -b * (1.0f / (1.0f + expf(b * r)));  // -b * sigmoid(-b r)
    case kHuber: {
      const float c = scale * (r - b);
      const float h = scale * aux;
      return fminf(fmaxf(c, -h), h);
    }
    case kSqHinge:
      return -scale * b * fmaxf(1.0f - b * r, 0.0f);
    default:
      return scale * (expf(fminf(r, kPoissonClamp)) - b);
  }
}

// Bytes of the row tile in shared memory, rounded up to 16 so that z follows
// it aligned.
__host__ __device__ __forceinline__ size_t tile_bytes(int rows, int n,
                                                      int itemsize) {
  return (static_cast<size_t>(rows) * n * itemsize + 15) / 16 * 16;
}

// Scalars row sc = [scale, gamma, gamma*lambda, 1/B, 1/N, sag, mode, aux].
// kVec: a row is a whole number of 16-byte chunks and A is 16-byte aligned,
// so the tile is copied 16 bytes at a time and read four values at a time;
// otherwise one value at a time. Shared memory: the tile (rows x n of T),
// then z (n floats), then per row dc, b, c_old and rs (rows floats each); the
// per-row values are fetched while the tile is in flight.
template <typename T, bool kLowp, bool kVec>
__global__ void __launch_bounds__(kRowThreads)
saga_rows_kernel(const T* __restrict__ A, const float* __restrict__ b,
                 const float* __restrict__ rs, float* __restrict__ c,
                 const float* __restrict__ z, const int* __restrict__ starts,
                 const int* __restrict__ fclamp, int k,
                 const float* __restrict__ sc, float* __restrict__ part, int n,
                 int rows) {
  if (masked(fclamp, k)) return;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* tile = reinterpret_cast<T*>(smem);
  float* zs = reinterpret_cast<float*>(smem + tile_bytes(rows, n, sizeof(T)));
  float* dcs = zs + n;
  float* bs = dcs + rows;
  float* cs = bs + rows;
  float* rss = cs + rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t start =
      static_cast<int64_t>(starts[k]) + static_cast<int64_t>(blockIdx.x) * rows;
  const T* src = A + start * n;
  const int count = rows * n;  // values in the tile

  if (kVec) {
    constexpr int kPer16 = 16 / sizeof(T);
    for (int i = tid * kPer16; i < count; i += kRowThreads * kPer16)
      __pipeline_memcpy_async(tile + i, src + i, 16);
    __pipeline_commit();
  } else {
    for (int i = tid; i < count; i += kRowThreads) tile[i] = src[i];
  }
  for (int j = tid; j < n; j += kRowThreads) {
    const float v = z[j];
    zs[j] = kLowp ? bf16_round(v) : v;
  }
  if (tid < rows) {
    bs[tid] = b[start + tid];
    cs[tid] = c[start + tid];
    rss[tid] = rs != nullptr ? rs[start + tid] : 1.0f;
  }
  if (kVec) __pipeline_wait_prior(0);
  __syncthreads();

  const float scale = sc[0];
  const int mode = static_cast<int>(sc[6]);
  const float aux = sc[7];
  for (int r = warp; r < rows; r += kRowWarps) {
    const T* a = tile + r * n;
    float acc = 0.0f;
    if (kVec) {
      for (int j = lane * 4; j < n; j += 32 * 4) {
        float v[4];
        row4<kLowp>(a + j, v);
        const float4 zz = *reinterpret_cast<const float4*>(zs + j);
        acc += v[0] * zz.x + v[1] * zz.y + v[2] * zz.z + v[3] * zz.w;
      }
    } else {
      for (int j = lane; j < n; j += 32) acc += row_value<kLowp>(a[j]) * zs[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float m = acc;
      if (rs != nullptr) m *= rss[r];
      const float c_new = coeff_formula(mode, m, bs[r], scale, aux);
      float dc = c_new - cs[r];
      c[start + r] = c_new;
      if (rs != nullptr) dc *= rss[r];
      dcs[r] = kLowp ? bf16_round(dc) : dc;
    }
  }
  __syncthreads();

  // Transposed product over the tile: each thread owns columns and walks the
  // rows in order.
  float* out = part + static_cast<int64_t>(blockIdx.x) * n;
  if (kVec) {
    for (int j = tid * 4; j < n; j += kRowThreads * 4) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int r = 0; r < rows; ++r) {
        float v[4];
        row4<kLowp>(tile + r * n + j, v);
        const float d = dcs[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += d * v[q];
      }
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
    for (int j = tid; j < n; j += kRowThreads) {
      float acc = 0.0f;
      for (int r = 0; r < rows; ++r)
        acc += dcs[r] * row_value<kLowp>(tile[r * n + j]);
      out[j] = acc;
    }
  }
}

// Warp w of a CTA sums the partials p = w, w + 8, ... of its 32 columns; warp
// 0 then adds the eight sums in order. The order is fixed, so the result
// repeats bit for bit.
__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
saga_finish_kernel(const float* __restrict__ part, int parts,
                   float* __restrict__ z, float* __restrict__ av,
                   const float* __restrict__ sc,
                   const float* __restrict__ wgts,
                   const int* __restrict__ fclamp, int k, int n) {
  if (masked(fclamp, k)) return;
  __shared__ float red[kFinishWarps][kFinishCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kFinishCols + lane;
  float s = 0.0f;
  if (j < n)
    for (int p = warp; p < parts; p += kFinishWarps)
      s += part[static_cast<int64_t>(p) * n + j];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || j >= n) return;
  float innov = 0.0f;
#pragma unroll
  for (int w = 0; w < kFinishWarps; ++w) innov += red[w][lane];
  const float gamma = sc[1];
  const float thr = sc[2];
  const float inv_b = sc[3];
  const float inv_n = sc[4];
  const float sag = sc[5];
  const float av_old = av[j];
  const float z_old = z[j];
  const float av_new = av_old + innov * inv_n;
  const float wgt = wgts != nullptr ? wgts[k] : 1.0f;
  // SAG refreshes the average before the direction, SAGA after; the weight
  // scales the SAGA direction only, never the average's delta.
  const float w = sag > 0.0f ? z_old - gamma * av_new
                             : z_old - gamma * (innov * (wgt * inv_b) + av_old);
  av[j] = av_new;
  const float sgn = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  z[j] = isnan(w) ? w : sgn * fmaxf(fabsf(w) - thr, 0.0f);
}

// The arguments of one call: K steps on one stream.
struct StepArgs {
  const void* A;
  const float* b;
  const float* rs;
  float* c;
  float* z;
  float* av;
  const int* starts;
  const float* wgts;
  const int* fclamp;
  const float* sc;
  float* part;
  int n, B, rows, K;
  cudaStream_t stream;
};

template <typename T, bool kLowp, bool kVec>
cudaError_t run_steps(const StepArgs& a) {
  const int parts = a.B / a.rows;
  const size_t smem = tile_bytes(a.rows, a.n, sizeof(T)) +
                      sizeof(float) * static_cast<size_t>(a.n + 4 * a.rows);
  auto rows_kernel = saga_rows_kernel<T, kLowp, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int finish_blocks = (a.n + kFinishCols - 1) / kFinishCols;
  for (int k = 0; k < a.K; ++k) {
    rows_kernel<<<parts, kRowThreads, smem, a.stream>>>(
        static_cast<const T*>(a.A), a.b, a.rs, a.c, a.z, a.starts, a.fclamp, k,
        a.sc, a.part, a.n, a.rows);
    saga_finish_kernel<<<finish_blocks, kFinishCols * kFinishWarps, 0,
                         a.stream>>>(a.part, parts, a.z, a.av, a.sc, a.wgts,
                                     a.fclamp, k, a.n);
    if (k == 0) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

template <typename T, bool kLowp>
cudaError_t dispatch_vec(bool vec, const StepArgs& a) {
  return vec ? run_steps<T, kLowp, true>(a) : run_steps<T, kLowp, false>(a);
}

// Checks the shape, picks the instantiation for the storage and queues the 2K
// launches; returns cudaGetLastError() after the last (0 on success). rows
// divides B and is at most 32; part is (B / rows, n) f32 scratch, 16-byte
// aligned.
cudaError_t launch_steps(int storage, int lowp, const StepArgs& a) {
  if (a.rows < 1 || a.rows > kMaxRowsPerCta || a.B % a.rows != 0 || a.n < 1 ||
      a.K < 1)
    return cudaErrorInvalidValue;
  const int itemsize = storage == kF32 ? 4 : (storage == kBF16 ? 2 : 1);
  // 16-byte copies need rows of whole 16-byte chunks and a 16-byte aligned A
  // (then n % 4 == 0 as well, for the four-value reads)
  const bool vec = (static_cast<int64_t>(a.n) * itemsize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.A) % 16 == 0;
  switch (storage) {
    case kF32:
      return lowp ? dispatch_vec<float, true>(vec, a)
                  : dispatch_vec<float, false>(vec, a);
    case kBF16:
      return dispatch_vec<__nv_bfloat16, true>(vec, a);
    case kI8:
      return dispatch_vec<int8_t, true>(vec, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
