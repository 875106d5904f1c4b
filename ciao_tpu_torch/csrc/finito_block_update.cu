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
// gamma_i. Rows outside the block are not touched. The device code is the
// table walk of table_rows.cuh (rule FinitoRule): a row phase of B / R CTAs
// (rows staged with cp.async, the margins a warp a row, a column walk with
// eight table rows' loads in flight) and a fixed-order finish.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "table_rows.cuh"

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
  const BlockArgs a{A,  b,    s,     gamma, z, start, sc, part,
                    innov, n, B, rows, static_cast<cudaStream_t>(stream)};
  return launch_block<FinitoRule>(storage, lowp, a);
}
