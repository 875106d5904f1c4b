// Coefficient block steps on an NVIDIA Hopper card (sm_90a), two launches a
// step: the device code of one kernel of ciao_tpu_torch/ops/fused_block.py,
//
//   point_saga_multistep_streamed.cu    replaces
//                                       ciao_tpu/ops/fused_block.py
//                                       point_saga_multistep_streamed
//                                       (Point-SAGA steps, a per-row prox,
//                                       steps k >= f masked).
//
// The Python wrapper and the design note are in ops/fused_block.py; the plain
// PyTorch version of the same arithmetic is the *_ref function there.
// Kernels #3 and #4 (SAGA), #5 (SVRG), #8 (LFinito), #9 (Finito), #10
// (Katyusha), #11 (SARAH), #12 (Point-SAGA), #13 and #19 (SSNM), #14
// (streamed Finito), #16 and #17 (the loopless pair) and #18 (ProShI) run on
// the persistent engine of loopless_steps.cuh.
//
// One solver step on the block [s, s + B) of the (N, n) rows A is two launches:
//
//   (a) rows_kernel, B / R CTAs of R rows. The CTA's R rows are one
//       contiguous span of A: it is copied into shared memory with cp.async,
//       every 16-byte load in flight at once, and read from device memory only
//       this once. From shared memory: the margins a_i . z (one warp per row,
//       shuffle reduction), the int8 dequant scale, the coefficient formula,
//       the coefficient difference dc_i and the CTA's partial innovation
//       sum_rows dc_i . a_i into part[cta, :];
//   (b) the finish kernel, 32 columns per CTA: the partials summed in a fixed
//       order (no atomics, so runs repeat bit for bit), then Point-SAGA's
//       finish below.
//
// The K steps are issued from the host on one stream with no host sync; the
// stream order carries the iterate and the table from one step to the next.
// The block start of step k is read on the device from starts[k]. With a
// clamp count (fclamp not NULL, one int32 on the device) both launches of a
// step k >= *fclamp return before any other load, so a masked step writes
// nothing and leaves the state bit for bit as the step before left it.
//
// Point-SAGA takes its margins at the shifted iterate v = x - gamma av,
// formed once per step into an (n,) scratch: a prologue launch forms step
// 0's, and each finish, after updating its columns of the iterate, forms the
// next step's. Its row phase is the row's prox solve, a template parameter
// (one instantiation per oracle mode): theta_i at the margin a_i . v + gamma
// c_i |a_i|^2 of the row's prox point, the table write c_i <- theta_i and
// dc_i = c_i_old - theta_i; its finish steps x <- v + (gamma / B) sum, av <-
// av - sum / N.
//
// Row offsets are 64-bit (start * n reaches 1.3e9 at the 10,485,760 x 128
// deep target); block starts are int32, which the wrappers check (N < 2^31).

#pragma once

#include "row_ops.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kMaxRowsPerCta = 32;

// The methods of the engine: Point-SAGA alone, its scalars row [scale,
// gamma, 1/B, 1/N, mode, aux].
enum Method {
  kPointSaga = 9
};

// The f32 values the row phase stages per row: dc, b, c, rs and the
// square-norm na.
constexpr int kRowValues = 5;
constexpr int kAuxSlot = 5;

// Shared memory: the tile (rows x n of T), then the point (n floats), then
// per row dc, b, c, rs and na (rows floats each); the per-row values are
// fetched while the tile is in flight. c is the table, refreshed by the
// prox solve and written back; z is the point of the margins, v. kPMode is
// Point-SAGA's oracle mode.
template <Method M, typename T, bool kLowp, bool kVec, int kPMode>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const T* __restrict__ A, const float* __restrict__ b,
            const float* __restrict__ rs, const float* __restrict__ na,
            float* __restrict__ c, const float* __restrict__ z,
            const int* __restrict__ starts, const int* __restrict__ fclamp,
            int k, const float* __restrict__ sc, float* __restrict__ part,
            int n, int rows) {
  if (masked(fclamp, k)) return;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* tile = reinterpret_cast<T*>(smem);
  float* zs = reinterpret_cast<float*>(smem + tile_bytes(rows, n, sizeof(T)));
  float* dcs = zs + n;
  float* bs = dcs + rows;
  float* cs = bs + rows;
  float* rss = cs + rows;
  float* nas = rss + rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t start =
      static_cast<int64_t>(starts[k]) + static_cast<int64_t>(blockIdx.x) * rows;

  stage_rows<T, kVec>(tile, A + start * n, rows * n, tid, kRowThreads);
  if (kVec) __pipeline_commit();
  for (int j = tid; j < n; j += kRowThreads) {
    const float v = z[j];
    zs[j] = kLowp ? bf16_round(v) : v;
  }
  if (tid < rows) {
    bs[tid] = b[start + tid];
    cs[tid] = c[start + tid];
    rss[tid] = rs != nullptr ? rs[start + tid] : 1.0f;
    nas[tid] = na[start + tid];
  }
  if (kVec) __pipeline_wait_prior(0);
  __syncthreads();

  const float scale = sc[0];
  const float aux = sc[kAuxSlot];
  for (int r = warp; r < rows; r += kRowWarps) {
    float m = warp_dot<kLowp, kVec>(tile + r * n, zs, n, lane);
    if (rs != nullptr) m *= rss[r];
    // the row's prox point z_i = v + gamma c_i a_i has the margin
    // m + gamma c_i |a_i|^2; every lane solves (the warp is uniform)
    const float gamma = sc[1];
    const float c_old = cs[r];
    const float theta = pointprox_theta<kPMode>(
        m + gamma * c_old * nas[r], bs[r], nas[r], c_old, scale, gamma, aux);
    if (lane == 0) c[start + r] = theta;
    float dc = c_old - theta;
    if (lane == 0) {
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
      float acc[4];
      tile_colsum4<kLowp>(tile, dcs, rows, n, j, acc);
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
    for (int j = tid; j < n; j += kRowThreads)
      out[j] = tile_colsum<kLowp>(tile, dcs, rows, n, j);
  }
}

// v <- x - gamma av on every column: step 0's shifted iterate.
__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
shifted_point_kernel(const float* __restrict__ x,
                     const float* __restrict__ av, float* __restrict__ v,
                     const float* __restrict__ sc, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) v[j] = shifted_point(sc[1], x[j], av[j]);
}

// Point-SAGA (Defazio 2016, the block mean of the rows' prox points) on a
// block: with sum = sum (c_old - theta) a_i, x <- v + (gamma / B) sum,
// av <- av - sum / N, then the next step's v = x - gamma av. A masked step
// writes nothing.
__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
point_saga_finish_kernel(const float* __restrict__ part, int parts,
                         float* __restrict__ v, float* __restrict__ x,
                         float* __restrict__ av, const float* __restrict__ sc,
                         const int* __restrict__ fclamp, int k, int n) {
  if (masked(fclamp, k)) return;
  int j;
  float u;
  if (!column_sum(part, parts, n, j, u)) return;
  const float gamma = sc[1];
  const float x_new = v[j] + (gamma * sc[2]) * u;
  const float av_new = av[j] - u * sc[3];
  x[j] = x_new;
  av[j] = av_new;
  v[j] = shifted_point(gamma, x_new, av_new);
}

// The arguments of one call: K steps on one stream. c the table, z an (n,)
// scratch for v, av the table mean, xi the iterate x, na the (N,) row
// square-norms.
struct StepArgs {
  const void* A;
  const float* b;
  const float* rs;
  float* c;
  float* z;
  float* av;
  const int* starts;
  const int* fclamp;
  const float* sc;
  float* part;
  int n, B, rows, K;
  cudaStream_t stream;
  float* xi = nullptr;
  const float* na = nullptr;
};

template <Method M, typename T, bool kLowp, bool kVec, int kPMode>
cudaError_t run_steps(const StepArgs& a) {
  const int parts = a.B / a.rows;
  const size_t smem =
      tile_bytes(a.rows, a.n, sizeof(T)) +
      sizeof(float) * static_cast<size_t>(a.n + kRowValues * a.rows);
  auto kernel = rows_kernel<M, T, kLowp, kVec, kPMode>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int finish_blocks = (a.n + kFinishCols - 1) / kFinishCols;
  constexpr int kFinishThreads = kFinishCols * kFinishWarps;
  const int col_blocks = (a.n + kFinishThreads - 1) / kFinishThreads;
  shifted_point_kernel<<<col_blocks, kFinishThreads, 0, a.stream>>>(
      a.xi, a.av, a.z, a.sc, a.n);
  for (int k = 0; k < a.K; ++k) {
    kernel<<<parts, kRowThreads, smem, a.stream>>>(
        static_cast<const T*>(a.A), a.b, a.rs, a.na, a.c, a.z, a.starts,
        a.fclamp, k, a.sc, a.part, a.n, a.rows);
    point_saga_finish_kernel<<<finish_blocks, kFinishThreads, 0, a.stream>>>(
        a.part, parts, a.z, a.xi, a.av, a.sc, a.fclamp, k, a.n);
    if (k == 0) {
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

template <Method M, typename T, bool kLowp, int kPMode>
cudaError_t dispatch_vec(bool vec, const StepArgs& a) {
  return vec ? run_steps<M, T, kLowp, true, kPMode>(a)
             : run_steps<M, T, kLowp, false, kPMode>(a);
}

// Checks the shape, picks the instantiation for the storage and queues the
// 2K + 1 launches; returns cudaGetLastError() after the last (0 on success).
// rows divides B and is at most 32; part is (B / rows, n) f32 scratch,
// 16-byte aligned. kPMode is Point-SAGA's oracle mode.
template <Method M, int kPMode = 0>
cudaError_t launch_steps(int storage, int lowp, const StepArgs& a) {
  if (a.rows < 1 || a.rows > kMaxRowsPerCta || a.B % a.rows != 0 || a.n < 1 ||
      a.K < 1)
    return cudaErrorInvalidValue;
  const bool vec = vec_rows(a.A, a.n, storage_itemsize(storage));
  switch (storage) {
    case kF32:
      return lowp ? dispatch_vec<M, float, true, kPMode>(vec, a)
                  : dispatch_vec<M, float, false, kPMode>(vec, a);
    case kBF16:
      return dispatch_vec<M, __nv_bfloat16, true, kPMode>(vec, a);
    case kI8:
      return dispatch_vec<M, int8_t, true, kPMode>(vec, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The host dispatch on the oracle mode, which the row phase takes as a
// template parameter: one instantiation per mode, so each per-row solve is
// compiled for its formula alone.
template <Method M>
cudaError_t launch_steps_by_mode(int mode, int storage, int lowp,
                                 const StepArgs& a) {
  switch (mode) {
    case kLsq:
      return launch_steps<M, kLsq>(storage, lowp, a);
    case kLogistic:
      return launch_steps<M, kLogistic>(storage, lowp, a);
    case kHuber:
      return launch_steps<M, kHuber>(storage, lowp, a);
    case kSqHinge:
      return launch_steps<M, kSqHinge>(storage, lowp, a);
    case kPoisson:
      return launch_steps<M, kPoisson>(storage, lowp, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
