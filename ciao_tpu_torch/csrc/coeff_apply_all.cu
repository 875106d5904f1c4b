// Kernel #6 on an NVIDIA Hopper card (sm_90a): one pass over the rows, every
// row's coefficient c_i = c(a_i . z), written out, and the full gradient sum
// gsum = sum_i c_i a_i (x rs_i for int8 rows), two-sum compensated.
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:coeff_apply_all.
// The walk, the compensation and the design are apply_rows.cuh's, shared with
// kernel #7 (coeff_value_apply_all.cu), here without the value column. The
// Python wrapper is ciao_tpu_torch/ops/fused_block.py coeff_apply_all, its
// plain PyTorch version coeff_apply_all_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "apply_rows.cuh"

// Returns cudaGetLastError() after queueing the two launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, rs: (N,) f32 (rs
// NULL unless int8); z: (n,) f32; sc: (3,) f32 [scale, mode, aux]; c: (N,)
// f32 and gsum: (n,) f32, written; hi_part, lo_part: (ctas, n) f32 scratch,
// 16-byte aligned. rows is 1 to 256 (a tile's whole rows, as many as fit 48
// KB, or fewer: ops/fused_block.py _apply_rows); ctas is at most
// ceil(N / rows).
extern "C" int coeff_apply_all_launch(const void* A, int storage, int lowp,
                                      const float* b, const float* rs,
                                      const float* z, const float* sc,
                                      float* c, float* gsum, float* hi_part,
                                      float* lo_part, long long N, int n,
                                      int rows, int ctas, void* stream) {
  return launch_apply<false>(A, storage, lowp, b, rs, z, sc, c, gsum, hi_part,
                             lo_part, nullptr, nullptr, nullptr, N, n, rows,
                             ctas, stream);
}
