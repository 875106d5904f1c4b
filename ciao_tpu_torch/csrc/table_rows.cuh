// The walk over one block of an (N, n) table on an NVIDIA Hopper card
// (sm_90a): the device code shared by two kernels of
// ciao_tpu_torch/ops/fused_block.py,
//
//   saga_block_update.cu    replaces ciao_tpu/ops/fused_block.py
//                           saga_block_update (SAGA's full-table refresh);
//   finito_block_update.cu  replaces finito_block_update (Finito's).
//
// (ProShI's K steps on its table, proshi_multistep.cu, run on the persistent
// engine of loopless_steps.cuh.) Each rewrites the rows [s0, s0 + B) of the
// table s in place and sums the block's innovation. The row phase,
// table_rows_kernel, runs B / R CTAs of R rows (R <= 32):
//
//   1. the CTA's R rows of A are copied into shared memory with cp.async (read
//      from device memory once), with the per-row values (b, gamma);
//   2. one warp per row takes the row's margin m_i = a_i . z and coefficient
//      c_i = scale (m_i - b_i);
//   3. the column walk: each thread owns four columns (one on the narrow
//      path) and walks the R rows in order, kChunk rows at a time: it loads
//      the chunk's old table values (their loads in flight together), then
//      writes the new ones and sums the CTA's partial innovation into
//      part[cta, :]:
//        SAGA    s_i <- c_i a_i                      sum (s_new - s_old)
//        Finito  s_i <- z - (gamma_i / N) c_i a_i    sum (s_new - s_old) hat/gamma_i
//
// A second launch, innov_finish_kernel, sums the partials per column in a
// fixed order (no atomics, so runs repeat bit for bit).
//
// Bound: bytes. A block moves its rows, its table rows read and written and
// the per-row values: 12 B a column of a row with f32 rows, about 48 MB at
// B = 4,096, n = 1,024.
//
// Precision: SAGA and Finito follow the Pallas kernels' _row_grad: bf16 rows
// are widened to f32 and the margin's dot is exact f32 at "highest" (z is not
// rounded); at "default" (kLowp) both dot operands round to bf16. The walk
// always uses the stored row values.

#pragma once

#include "row_ops.cuh"

namespace {

constexpr int kTableThreads = 256;
constexpr int kTableWarps = kTableThreads / 32;
constexpr int kTableMaxRows = 32;
// Rows of the column walk whose table values are loaded before any of them
// is written back: the loads of a chunk are in flight together.
constexpr int kChunk = 8;

// The rules. row_setup fills a row's two per-row values w, h from gamma_i;
// coeff turns the margin into the value the walk uses (c_i); value and innov
// are the walk's new table value and the weight of its innovation.
struct SagaRule {
  // sc = [scale]
  __device__ static void row_setup(const float*, float, float&, float&) {}
  __device__ static float coeff(float m, float b, const float* sc) {
    return sc[0] * (m - b);
  }
  __device__ static float value(float, float a, float, float c, float) {
    return c * a;
  }
  __device__ static float innov(float d, float) { return d; }
};

struct FinitoRule {
  // sc = [scale, 1/N, hat]; w = gamma_i / N, h = hat / gamma_i
  __device__ static void row_setup(const float* sc, float g, float& w,
                                   float& h) {
    w = g * sc[1];
    h = sc[2] / g;
  }
  __device__ static float coeff(float m, float b, const float* sc) {
    return sc[0] * (m - b);
  }
  __device__ static float value(float, float a, float zj, float c, float w) {
    return zj - w * (c * a);
  }
  __device__ static float innov(float d, float h) { return d * h; }
};

// Shared memory: the tile (rows x n of T), then z as the dot sees it (n
// floats), then per row the coefficient (b until the margins are done) and
// the rule's two values w and h. The block starts at *start.
template <class Rule, typename T, bool kLowp, bool kVec>
__global__ void __launch_bounds__(kTableThreads)
table_rows_kernel(const T* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ s, const float* __restrict__ gamma,
                  const float* __restrict__ z,
                  const int* __restrict__ block_start,
                  const float* __restrict__ sc, float* __restrict__ part,
                  int n, int rows) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* tile = reinterpret_cast<T*>(smem);
  float* zs = reinterpret_cast<float*>(smem + tile_bytes(rows, n, sizeof(T)));
  float* cs = zs + n;
  float* ws = cs + rows;
  float* hs = ws + rows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t start = static_cast<int64_t>(*block_start) +
                        static_cast<int64_t>(blockIdx.x) * rows;

  stage_rows<T, kVec>(tile, A + start * n, rows * n, tid, kTableThreads);
  if (kVec) __pipeline_commit();
  for (int j = tid; j < n; j += kTableThreads) {
    const float v = z[j];
    zs[j] = kLowp ? bf16_round(v) : v;
  }
  if (tid < rows) {
    cs[tid] = b[start + tid];
    Rule::row_setup(sc, gamma != nullptr ? gamma[start + tid] : 0.0f,
                    ws[tid], hs[tid]);
  }
  if (kVec) __pipeline_wait_prior(0);
  __syncthreads();

  // The table's rows of the CTA: row r of the block at s + (start + r) * n.
  float* srow = s + start * n;
  for (int r = warp; r < rows; r += kTableWarps) {
    const float m = warp_dot<kLowp, kVec>(tile + r * n, zs, n, lane);
    if (lane == 0) cs[r] = Rule::coeff(m, cs[r], sc);
  }
  __syncthreads();

  float* out = part + static_cast<int64_t>(blockIdx.x) * n;
  if (kVec) {
    for (int j = tid * 4; j < n; j += kTableThreads * 4) {
      const float4 zz = *reinterpret_cast<const float4*>(z + j);
      const float zj[4] = {zz.x, zz.y, zz.z, zz.w};
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int r0 = 0; r0 < rows; r0 += kChunk) {
        float4 old[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          if (r0 + q < rows)
            old[q] = *reinterpret_cast<const float4*>(
                srow + static_cast<int64_t>(r0 + q) * n + j);
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          const int r = r0 + q;
          if (r >= rows) break;
          float a[4];
          row4<false>(tile + r * n + j, a);
          const float so[4] = {old[q].x, old[q].y, old[q].z, old[q].w};
          float sn[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sn[e] = Rule::value(so[e], a[e], zj[e], cs[r], ws[r]);
            acc[e] += Rule::innov(sn[e] - so[e], hs[r]);
          }
          *reinterpret_cast<float4*>(srow + static_cast<int64_t>(r) * n +
                                     j) = make_float4(sn[0], sn[1], sn[2],
                                                      sn[3]);
        }
      }
      *reinterpret_cast<float4*>(out + j) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
    for (int j = tid; j < n; j += kTableThreads) {
      const float zj = z[j];
      float acc = 0.0f;
      for (int r0 = 0; r0 < rows; r0 += kChunk) {
        float old[kChunk];
#pragma unroll
        for (int q = 0; q < kChunk; ++q)
          if (r0 + q < rows)
            old[q] = srow[static_cast<int64_t>(r0 + q) * n + j];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) {
          const int r = r0 + q;
          if (r >= rows) break;
          const float a = row_value<false>(tile[r * n + j]);
          const float sn = Rule::value(old[q], a, zj, cs[r], ws[r]);
          acc += Rule::innov(sn - old[q], hs[r]);
          srow[static_cast<int64_t>(r) * n + j] = sn;
        }
      }
      out[j] = acc;
    }
  }
}

__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
innov_finish_kernel(const float* __restrict__ part, int parts,
                    float* __restrict__ innov, int n) {
  int j;
  float sum;
  if (column_sum(part, parts, n, j, sum)) innov[j] = sum;
}

// Dynamic shared memory of one row-phase CTA (within ops/fused_block.py
// _smem_bytes, which the wrapper's rows rule counts with a fourth value a
// row); above 48 KB the kernel must opt in.
template <typename T, typename Kernel>
cudaError_t table_smem(Kernel kernel, int rows, int n, size_t& smem) {
  smem = tile_bytes(rows, n, sizeof(T)) +
         sizeof(float) * static_cast<size_t>(n + 3 * rows);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The one-block kernels (SAGA, Finito): the arguments of one call.
struct BlockArgs {
  const void* A;
  const float* b;
  float* s;
  const float* gamma;  // NULL for SAGA
  const float* z;
  const int* start;
  const float* sc;
  float* part;
  float* innov;
  int n, B, rows;
  cudaStream_t stream;
};

template <class Rule, typename T, bool kLowp, bool kVec>
cudaError_t run_block(const BlockArgs& a) {
  const int parts = a.B / a.rows;
  auto kernel = table_rows_kernel<Rule, T, kLowp, kVec>;
  size_t smem;
  cudaError_t e = table_smem<T>(kernel, a.rows, a.n, smem);
  if (e != cudaSuccess) return e;
  kernel<<<parts, kTableThreads, smem, a.stream>>>(
      static_cast<const T*>(a.A), a.b, a.s, a.gamma, a.z, a.start, a.sc,
      a.part, a.n, a.rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  innov_finish_kernel<<<(a.n + kFinishCols - 1) / kFinishCols,
                        kFinishCols * kFinishWarps, 0, a.stream>>>(
      a.part, parts, a.innov, a.n);
  return cudaGetLastError();
}

template <class Rule, typename T>
cudaError_t dispatch_block(bool lowp, bool vec, const BlockArgs& a) {
  if (lowp)
    return vec ? run_block<Rule, T, true, true>(a)
               : run_block<Rule, T, true, false>(a);
  return vec ? run_block<Rule, T, false, true>(a)
             : run_block<Rule, T, false, false>(a);
}

// Checks the shape, picks the instantiation for the storage (f32 or bf16;
// int8 rows are refused) and queues the two launches; returns
// cudaGetLastError() after the last (0 on success).
template <class Rule>
int launch_block(int storage, int lowp, const BlockArgs& a) {
  if (a.rows < 1 || a.rows > kTableMaxRows || a.B % a.rows != 0 || a.n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the 16-byte path: whole 16-byte row chunks of A and of the f32 table
  const bool vec = vec_rows(a.A, a.n, storage_itemsize(storage)) &&
                   vec_rows(a.s, a.n, 4) && vec_rows(a.z, a.n, 4);
  switch (storage) {
    case kF32:
      return static_cast<int>(dispatch_block<Rule, float>(lowp != 0, vec, a));
    case kBF16:
      return static_cast<int>(
          dispatch_block<Rule, __nv_bfloat16>(lowp != 0, vec, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
