// K ProShI sharing steps on the (N, n) block table, steps k >= f masked, on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:proshi_multistep
// (body _proshi_multi_kernel). The Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py proshi_multistep, its plain PyTorch
// version proshi_multistep_ref.
//
// Step k on the block [s0, s0 + B), s0 = starts[k] (ProShI_basic.jl:111-123):
//
//   s_tmp_i = s_i + gamma_i z,  m_i = a_i . s_tmp_i (rs_i for int8 rows),
//   w_i = (gamma_i / N) c(m_i) (rs_i),  s_i <- s_tmp_i - w_i a_i,
//   av += sum_i (s_new_i - s_old_i),
//   z = (prox_g(av, hat) - av) / hat,
//
// prox_g by gmode: the identity (Zero: z = 0), clip(av, glo, ghi) (IndBox,
// glo may be -inf) or the soft-threshold at glo = hat lambda (NormL1). Each
// step is two launches on one stream, as for the coefficient kernels of
// saga_steps.cuh: the table walk of table_rows.cuh (rule ProshiRule), whose
// margins are pointwise (each row at its own point, so a row's table values
// are read for the margin and again by the walk), then proshi_finish_kernel:
// the partials summed per column in a fixed order, av, the prox and z. The
// stream order carries the table, av and z from one step to the next, so a
// block revisited within a call reads the previous step's rows: the port's
// driver does not clamp. With a clamp count (fclamp not NULL, one int32 on the
// device) both launches of a step k >= *fclamp return before any load, so a
// masked step leaves s, av and z bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "table_rows.cuh"

namespace {

enum GProx { kGproxZero = 0, kGproxBox = 1, kGproxL1 = 2 };

__global__ void __launch_bounds__(kFinishCols * kFinishWarps)
proshi_finish_kernel(const float* __restrict__ part, int parts,
                     float* __restrict__ av, float* __restrict__ z,
                     const float* __restrict__ sc,
                     const int* __restrict__ fclamp, int k, int n) {
  if (masked(fclamp, k)) return;
  int j;
  float innov;
  if (!column_sum(part, parts, n, j, innov)) return;
  const float a = av[j] + innov;
  const float glo = sc[4];
  const float ghi = sc[5];
  const int gmode = static_cast<int>(sc[6]);
  float p = a;
  if (gmode == kGproxBox)
    p = a < glo ? glo : (a > ghi ? ghi : a);  // NaN passes through
  else if (gmode == kGproxL1)
    p = soft_threshold(a, glo);
  av[j] = a;
  z[j] = (p - a) * sc[2];
}

struct Args {
  const void* A;
  const float* b;
  const float* gamma;
  const float* rs;
  float* s;
  const int* starts;
  const int* fclamp;
  const float* sc;
  float* part;
  float* av;
  float* z;
  int n, B, rows, K;
  cudaStream_t stream;
};

template <typename T, bool kVec>
cudaError_t run(const Args& a) {
  const int parts = a.B / a.rows;
  auto kernel = table_rows_kernel<ProshiRule, T, false, kVec>;
  size_t smem;
  cudaError_t e = table_smem<T>(kernel, a.rows, a.n, smem);
  if (e != cudaSuccess) return e;
  const int finish_blocks = (a.n + kFinishCols - 1) / kFinishCols;
  for (int k = 0; k < a.K; ++k) {
    kernel<<<parts, kTableThreads, smem, a.stream>>>(
        static_cast<const T*>(a.A), a.b, a.rs, a.s, a.gamma, a.z, a.starts, k,
        a.fclamp, a.sc, a.part, a.n, a.rows);
    proshi_finish_kernel<<<finish_blocks, kFinishCols * kFinishWarps, 0,
                           a.stream>>>(a.part, parts, a.av, a.z, a.sc,
                                       a.fclamp, k, a.n);
    if (k == 0) {
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool vec, const Args& a) {
  return vec ? run<T, true>(a) : run<T, false>(a);
}

}  // namespace

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8, then rs holds the (N,)
// f32 dequant scales, else NULL); b, gamma: (N,) f32; s: (N, n) f32 table,
// updated in place; starts: (K,) int32 block starts on the device, multiples
// of rows; fclamp: one int32 on the device, the clamp count f (steps k >= f
// are masked), or NULL for f = K; sc: (8,) f32 [scale, 1/N, 1/hat, mode, glo,
// ghi, gmode, aux]; part: (B / rows, n) f32 scratch, 16-byte aligned; av, z:
// (n,) f32, updated in place. rows divides B and is at most 32.
extern "C" int proshi_multistep_launch(
    const void* A, int storage, const float* b, const float* gamma,
    const float* rs, float* s, const int* starts, const int* fclamp,
    const float* sc, float* part, float* av, float* z, int n, int B, int rows,
    int K, void* stream) {
  if (rows < 1 || rows > kTableMaxRows || B % rows != 0 || n < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{A,  b,  gamma, rs, s, starts, fclamp, sc,
               part, av, z, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  const bool vec = vec_rows(A, n, storage_itemsize(storage)) &&
                   vec_rows(s, n, 4) && vec_rows(z, n, 4);
  switch (storage) {
    case kF32:
      return static_cast<int>(dispatch<float>(vec, a));
    case kBF16:
      return static_cast<int>(dispatch<__nv_bfloat16>(vec, a));
    case kI8:
      return static_cast<int>(dispatch<int8_t>(vec, a));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
