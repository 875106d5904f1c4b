// Row primitives shared by the port's kernels on an NVIDIA Hopper card
// (sm_90a): the storage codes, the bf16 rounding of the dot operands, reads
// of one or four row values from shared memory, a row's margin by one warp,
// the oracle's coefficient and value formulas, the Point-SAGA per-row prox,
// the L1 soft-threshold, the fixed-order sum of per-CTA partials, the coupled
// point of Katyusha and L-Katyusha, bulk copies into shared memory on
// mbarriers and the size of a row tile in shared memory.
//
// Precision follows the Pallas kernels' _stream_dot: when kLowp is set (rows
// stored bf16 or int8, or f32 rows at "default" precision) both operands of
// each dot are rounded to bf16 and multiplied with f32 accumulation; int8 and
// bf16 row values are exact in bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Storage { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Mode { kLsq = 0, kLogistic = 1, kHuber = 2, kSqHinge = 3, kPoisson = 4 };
constexpr float kPoissonClamp = 30.0f;  // ops/fused_block.py POISSON_CLAMP
// The finish kernels' CTA: one warp's width of columns, eight warps splitting
// the partials of a column.
constexpr int kFinishCols = 32;
constexpr int kFinishWarps = 8;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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
// to their size): the vector reads of the kVec paths.
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

// Full-rate widening for the one-pass walk (apply_rows.cuh), no I2F or F2F:
// four int8 values of a word by the byte-permute trick (the word biased by
// 0x80 a byte, each byte moved into the mantissa of 2^23, one FADD of
// 2^23 + 128 takes the bias and the exponent out: exact), two bf16 values
// of a word by a shift and a mask, and four f32 values rounded to bf16 by
// two packed conversions.
__device__ __forceinline__ void widen4_i8(unsigned w, float (&v)[4]) {
  const unsigned x = w ^ 0x80808080u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + q)) -
           8388736.0f;
}
__device__ __forceinline__ void widen2_bf16(unsigned w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float4 round4_bf16(float4 x) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 q = __floats2bfloat162_rn(x.z, x.w);
  float v[4];
  widen2_bf16(*reinterpret_cast<const unsigned*>(&p), v);
  widen2_bf16(*reinterpret_cast<const unsigned*>(&q), v + 2);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The margin a . zs of one row a of a tile in shared memory, by one warp: the
// lanes stride the row (four values a lane on the kVec path) and a shuffle
// reduction gives every lane the sum.
template <bool kLowp, bool kVec, typename T>
__device__ __forceinline__ float warp_dot(const T* a, const float* zs, int n,
                                          int lane) {
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
  return acc;
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

// ops/fused_block.py _value_formula: the row's loss f_i from the same margin r,
// with expf/log1pf (not the fast intrinsics) and no contracted products, as the
// plain version computes it. Poisson's value is extended linearly past the
// clamp, the C^1 twin of the frozen coefficient.
__device__ __forceinline__ float value_formula(int mode, float r, float b,
                                               float scale, float aux) {
  switch (mode) {
    case kLsq: {
      const float res = r - b;
      return __fmul_rn(__fmul_rn(__fmul_rn(0.5f, scale), res), res);
    }
    case kLogistic: {
      const float t = -__fmul_rn(b, r);
      return fmaxf(t, 0.0f) + log1pf(expf(-fabsf(t)));
    }
    case kHuber: {
      const float res = r - b;
      const float a = fabsf(res);
      const float v = a <= aux ? __fmul_rn(__fmul_rn(0.5f, res), res)
                               : __fmul_rn(aux, a - __fmul_rn(0.5f, aux));
      return __fmul_rn(scale, v);
    }
    case kSqHinge: {
      const float h = fmaxf(1.0f - __fmul_rn(b, r), 0.0f);
      return __fmul_rn(__fmul_rn(__fmul_rn(0.5f, scale), h), h);
    }
    default: {
      // e^30 rounded to f32, as the plain version's exp(30) is
      constexpr float kExpClamp = 1.0686474581524463e13f;
      const float e = r <= kPoissonClamp
                          ? expf(fminf(r, kPoissonClamp))
                          : __fmul_rn(kExpClamp, 1.0f + (r - kPoissonClamp));
      return __fmul_rn(scale, e - __fmul_rn(b, r));
    }
  }
}

// ops/fused_block.py pointprox_theta: Point-SAGA's per-row prox theta for the
// oracle formula kMode (pointprox_theta_of below takes it at run time), from
// the margin mz at the row's prox point, the offset or label b, the row
// square-norm na and the table coefficient c_old. Least squares and Huber
// are closed forms, squared hinge one activity test of the deficit at mz,
// logistic and Poisson 20 Newton steps from theta = c_old.
constexpr int kPointProxNewtonSteps = 20;
template <int kMode>
__device__ __forceinline__ float pointprox_theta(float mz, float b, float na,
                                                float c_old, float scale,
                                                float gamma, float aux) {
  if constexpr (kMode == kLogistic) {
    // theta = -y sigmoid(-y (mz - gamma na theta))
    const float gna2 = gamma * na;
    float th = c_old;
#pragma unroll 4
    for (int it = 0; it < kPointProxNewtonSteps; ++it) {
      const float s = 1.0f / (1.0f + expf(b * (mz - gna2 * th)));
      th = th - (th + b * s) / (1.0f + gna2 * s * (1.0f - s));
    }
    return th;
  } else if constexpr (kMode == kPoisson) {
    // theta = scale (exp(min(mz - gamma na theta, M)) - y); the derivative
    // keeps the clamp's branch
    const float gna2 = gamma * na;
    float th = c_old;
#pragma unroll 4
    for (int it = 0; it < kPointProxNewtonSteps; ++it) {
      const float u = mz - gna2 * th;
      const float e = expf(fminf(u, kPoissonClamp));
      const float dphi = 1.0f + scale * gna2 * (u <= kPoissonClamp ? e : 0.0f);
      th = th - (th - scale * (e - b)) / dphi;
    }
    return th;
  } else if constexpr (kMode == kSqHinge) {
    // active iff the deficit at the prox point mz is positive
    const float deficit = 1.0f - b * mz;
    return deficit > 0.0f
               ? -scale * b * deficit / (1.0f + scale * gamma * na)
               : 0.0f;
  } else {
    const float theta = scale * (mz - b) / (1.0f + gamma * scale * na);
    if constexpr (kMode == kHuber) {
      const float h = scale * aux;
      return fminf(fmaxf(theta, -h), h);
    }
    return theta;
  }
}

// pointprox_theta for the oracle formula `mode` given at run time (the
// persistent engine's Point-SAGA: one build for all five formulas, a
// uniform branch a row), each formula's arithmetic as above. Not inlined:
// the five solves are compiled once for a source, not into each of the
// engine's 28 builds (a call a row and step costs nothing beside a chain of
// microseconds).
__device__ __noinline__ float pointprox_theta_of(int mode, float mz, float b,
                                                 float na, float c_old,
                                                 float scale, float gamma,
                                                 float aux) {
  switch (mode) {
    case kLogistic:
      return pointprox_theta<kLogistic>(mz, b, na, c_old, scale, gamma, aux);
    case kHuber:
      return pointprox_theta<kHuber>(mz, b, na, c_old, scale, gamma, aux);
    case kSqHinge:
      return pointprox_theta<kSqHinge>(mz, b, na, c_old, scale, gamma, aux);
    case kPoisson:
      return pointprox_theta<kPoisson>(mz, b, na, c_old, scale, gamma, aux);
    default:
      return pointprox_theta<kLsq>(mz, b, na, c_old, scale, gamma, aux);
  }
}

// Point-SAGA's shifted iterate x - gamma av, rounded as the plain versions
// round it (no contraction into an fma).
__device__ __forceinline__ float shifted_point(float gamma, float x,
                                               float av) {
  return __fsub_rn(x, __fmul_rn(gamma, av));
}

// SSNM's momentum point tau x + (1 - tau) zb, rounded as the plain versions
// round it (no contraction into an fma).
__device__ __forceinline__ float momentum_point(float tau, float x, float zb) {
  return __fadd_rn(__fmul_rn(tau, x), __fmul_rn(1.0f - tau, zb));
}

// The L1 soft-threshold sign(w)·max(|w| − thr, 0), NaN passed through.
__device__ __forceinline__ float soft_threshold(float w, float thr) {
  const float sgn = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  return isnan(w) ? w : sgn * fmaxf(fabsf(w) - thr, 0.0f);
}

// The fixed-order sum of the partials of column j = blockIdx.x * 32 + lane:
// warp w sums p = w, w + 8, ...; warp 0 then adds the eight sums in order and
// gets true (the other warps and the columns past n get false). The order is
// fixed, so the result repeats bit for bit.
__device__ __forceinline__ bool column_sum(const float* __restrict__ part,
                                           int parts, int n, int& j,
                                           float& sum) {
  __shared__ float red[kFinishWarps][kFinishCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  j = blockIdx.x * kFinishCols + lane;
  float s = 0.0f;
  if (j < n)
    for (int p = warp; p < parts; p += kFinishWarps)
      s += part[static_cast<int64_t>(p) * n + j];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || j >= n) return false;
  sum = 0.0f;
#pragma unroll
  for (int w = 0; w < kFinishWarps; ++w) sum += red[w][lane];
  return true;
}

// The coupled point t1 z + t2 xa + (1 - t1 - t2) y of Katyusha and
// L-Katyusha, in the plain versions' order of operations.
__device__ __forceinline__ float coupled_point(float t1, float t2, float z,
                                               float xa, float y) {
  return (t1 * z + t2 * xa) + ((1.0f - t1) - t2) * y;
}

// Bulk copies into shared memory on mbarriers (the rings of apply_rows.cuh
// and loopless_steps.cuh).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier whose phase completes after `count` arrivals (and the bytes
// its arrivals expect).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One thread: arrive on the stage's barrier expecting `bytes` and start the
// bulk copy of `bytes` from global `src` into shared `dst` that completes on
// it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Wait until the stage's barrier has completed phase `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
}

// Bytes of a row tile in shared memory, rounded up to 16 so that what follows
// it stays aligned.
__host__ __device__ __forceinline__ size_t tile_bytes(int rows, int n,
                                                      int itemsize) {
  return (static_cast<size_t>(rows) * n * itemsize + 15) / 16 * 16;
}

// Copy `count` values of a row tile from device memory into shared memory.
// kVec: the rows are whole 16-byte chunks and A is 16-byte aligned, so every
// 16-byte load is put in flight with cp.async (the caller commits and waits);
// otherwise a plain copy, one value at a time.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int count,
                                           int tid, int threads) {
  if (kVec) {
    constexpr int kPer16 = 16 / sizeof(T);
    for (int i = tid * kPer16; i < count; i += threads * kPer16)
      __pipeline_memcpy_async(dst + i, src + i, 16);
  } else {
    for (int i = tid; i < count; i += threads) dst[i] = src[i];
  }
}

// Whether the 16-byte path applies: rows of whole 16-byte chunks (then n % 4
// == 0 as well, for the four-value reads) and a 16-byte aligned A.
inline bool vec_rows(const void* A, int n, int itemsize) {
  return (static_cast<int64_t>(n) * itemsize) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(A) % 16 == 0;
}

inline int storage_itemsize(int storage) {
  return storage == kF32 ? 4 : (storage == kBF16 ? 2 : 1);
}

}  // namespace
