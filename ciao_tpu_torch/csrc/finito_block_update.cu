// The full-table Finito refresh of one block on an NVIDIA Hopper card
// (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:finito_block_update
// (body _finito_kernel). The Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py finito_block_update, its plain PyTorch
// version finito_block_update_ref.
//
// On the rows [s0, s0 + B) of the (N, n) table s, with s0 = *start read on the
// device: s_i <- z - (gamma_i / N) grad f_i(z), grad f_i(z) = c_i a_i with
// c_i = scale (a_i . z - b_i), and innov = sum_i (s_new_i - s_old_i) hat /
// gamma_i. Rows outside the block are not touched. Two launches:
//
//   (a) rows_kernel, B / R CTAs of R rows: the CTA's R rows copied into shared
//       memory with cp.async (read from device memory once), the margins by
//       one warp a row, then a column pass (each thread owns four columns,
//       or one on the narrow path) that walks the R rows in order, chunks of
//       kChunk rows at a time: it loads the chunk's old table values, then
//       writes the new ones and sums the CTA's partial innovation into
//       part[cta, :];
//   (b) finish_kernel: the partials summed per column in a fixed order (no
//       atomics, so runs repeat bit for bit) into innov.
//
// The step is bound by bytes: the block's rows, the table's rows read and
// written (12 B a column of a row with f32 rows: about 48 MB at the 262,144 x
// 1,024 headline's B = 4,096) and b and gamma.
//
// Precision follows the Pallas kernel's _row_grad, not _stream_dot: bf16 rows
// are widened to f32 and the margin's dot is exact f32 at "highest" (z is not
// rounded); at "default" (kLowp) both dot operands round to bf16, as the
// TPU's one-pass product does. The gradient itself always uses the stored
// row values.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "row_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 32;
// Rows of the column walk whose table values are loaded before any of them
// is written back: the loads of a chunk are in flight together.
constexpr int kChunk = 8;

// Shared memory: the tile (rows x n of T), then z as the dot sees it (n
// floats), then per row the coefficient c_i (b_i until the margins are done),
// gamma_i / N and hat / gamma_i.
template <typename T, bool kLowp, bool kVec>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ A, const float* __restrict__ b,
            float* __restrict__ s, const float* __restrict__ gamma,
            const float* __restrict__ z, const int* __restrict__ start0,
            const float* __restrict__ sc, float* __restrict__ part, int n,
            int rows) {
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
  const int64_t start =
      static_cast<int64_t>(*start0) + static_cast<int64_t>(blockIdx.x) * rows;
  const float scale = sc[0];
  const float inv_n = sc[1];
  const float hat = sc[2];

  stage_rows<T, kVec>(tile, A + start * n, rows * n, tid, kThreads);
  if (kVec) __pipeline_commit();
  for (int j = tid; j < n; j += kThreads) {
    const float v = z[j];
    zs[j] = kLowp ? bf16_round(v) : v;
  }
  if (tid < rows) {
    const float g = gamma[start + tid];
    cs[tid] = b[start + tid];
    ws[tid] = g * inv_n;
    hs[tid] = hat / g;
  }
  if (kVec) __pipeline_wait_prior(0);
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    const float m = warp_dot<kLowp, kVec>(tile + r * n, zs, n, lane);
    if (lane == 0) cs[r] = scale * (m - cs[r]);
  }
  __syncthreads();

  // The table's rows of the CTA: row r of the block at s + (start + r) * n.
  float* srow = s + start * n;
  float* out = part + static_cast<int64_t>(blockIdx.x) * n;
  if (kVec) {
    for (int j = tid * 4; j < n; j += kThreads * 4) {
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
            sn[e] = zj[e] - ws[r] * (cs[r] * a[e]);
            acc[e] += (sn[e] - so[e]) * hs[r];
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
    for (int j = tid; j < n; j += kThreads) {
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
          const float sn = zj - ws[r] * (cs[r] * a);
          acc += (sn - old[q]) * hs[r];
          srow[static_cast<int64_t>(r) * n + j] = sn;
        }
      }
      out[j] = acc;
    }
  }
}

__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
finish_kernel(const float* __restrict__ part, int parts,
              float* __restrict__ innov, int n) {
  int j;
  float sum;
  if (column_sum(part, parts, n, j, sum)) innov[j] = sum;
}

struct Args {
  const void* A;
  const float* b;
  float* s;
  const float* gamma;
  const float* z;
  const int* start;
  const float* sc;
  float* part;
  float* innov;
  int n, B, rows;
  cudaStream_t stream;
};

template <typename T, bool kLowp, bool kVec>
cudaError_t run(const Args& a) {
  const int parts = a.B / a.rows;
  const size_t smem = tile_bytes(a.rows, a.n, sizeof(T)) +
                      sizeof(float) * static_cast<size_t>(a.n + 4 * a.rows);
  auto kernel = rows_kernel<T, kLowp, kVec>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<parts, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.A), a.b, a.s, a.gamma, a.z, a.start, a.sc,
      a.part, a.n, a.rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finish_kernel<<<(a.n + kFinishCols - 1) / kFinishCols,
                  kFinishCols * kFinishWarps, 0, a.stream>>>(a.part, parts,
                                                             a.innov, a.n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool lowp, bool vec, const Args& a) {
  if (lowp) return vec ? run<T, true, true>(a) : run<T, true, false>(a);
  return vec ? run<T, false, true>(a) : run<T, false, false>(a);
}

}  // namespace

// Returns cudaGetLastError() after queueing the two launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16; int8 rows are refused); b,
// gamma: (N,) f32; s: (N, n) f32 table, its rows [*start, *start + B)
// rewritten in place; z: (n,) f32; start: one int32 on the device, a multiple
// of rows; sc: (3,) f32 scalars row [scale, 1/N, hat]; part: (B / rows, n) f32
// scratch, 16-byte aligned; innov: (n,) f32 output. lowp rounds the margins'
// dot operands to bf16 ("default"). rows divides B and is at most 32.
extern "C" int finito_block_update_launch(
    const void* A, int storage, int lowp, const float* b, float* s,
    const float* gamma, const float* z, const int* start, const float* sc,
    float* part, float* innov, int n, int B, int rows, void* stream) {
  if (rows < 1 || rows > kMaxRows || B % rows != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{A, b, s, gamma, z, start, sc, part, innov, n, B, rows,
               static_cast<cudaStream_t>(stream)};
  // the 16-byte path: whole 16-byte row chunks of A and of the f32 table
  const bool vec = vec_rows(A, n, storage_itemsize(storage)) &&
                   vec_rows(s, n, 4) && vec_rows(z, n, 4);
  switch (storage) {
    case kF32:
      return static_cast<int>(dispatch<float>(lowp != 0, vec, a));
    case kBF16:
      return static_cast<int>(dispatch<__nv_bfloat16>(lowp != 0, vec, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
