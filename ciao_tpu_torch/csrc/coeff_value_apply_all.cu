// Kernel #7 on an NVIDIA Hopper card (sm_90a): PANOC's and ZeroFPR's
// forward-backward envelope read in one pass over the rows: the loss sum
// val = sum_i f_i(z), every row's coefficient c_i = c(a_i . z), written out,
// and the full gradient sum gsum = sum_i c_i a_i (x rs_i for int8 rows), both
// sums two-sum compensated across tiles.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:coeff_value_apply_all (body
// _coeff_value_apply_kernel, value formula _value_formula). It is kernel #6's
// walk (apply_rows.cuh) with its value column: each row's value comes from
// the margin its coefficient comes from (value_formula in row_ops.cuh, one
// lane a row, warp w taking rows 32w .. 32w + 31 of the tile), each warp's
// values are added by a fixed xor tree, the warps' sums in warp order, the
// tile's sum two-summed into the CTA's value pair, and the finish combines
// the G pairs in a fixed order. c and gsum are kernel #6's to the bit. Bound
// by bytes, as #6 is: A is read once, c written once. The Python wrapper is
// ciao_tpu_torch/ops/fused_block.py coeff_value_apply_all, its plain PyTorch
// version coeff_value_apply_all_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "apply_rows.cuh"

// Returns cudaGetLastError() after queueing the two launches (0 on success).
// As coeff_apply_all_launch, and val: (1,) f32, written; vhi, vlo: (ctas,) f32
// scratch.
extern "C" int coeff_value_apply_all_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* z, const float* sc, float* val, float* c, float* gsum,
    float* hi_part, float* lo_part, float* vhi, float* vlo, long long N, int n,
    int rows, int ctas, void* stream) {
  return launch_apply<true>(A, storage, lowp, b, rs, z, sc, c, gsum, hi_part,
                            lo_part, val, vhi, vlo, N, n, rows, ctas, stream);
}
