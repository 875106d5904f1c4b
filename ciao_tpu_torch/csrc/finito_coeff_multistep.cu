// K Finito coefficient-table block steps on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:finito_coeff_multistep
// (body _finito_coeff_multi_kernel). The device code is in saga_steps.cuh
// (method kFinito: SAGA's row phase, finito_finish_kernel); the Python
// wrapper and the design note are ciao_tpu_torch/ops/fused_block.py
// finito_coeff_multistep, its plain PyTorch version finito_coeff_multistep_ref.
//
// The TPU kernel keeps the (8, N/8) coefficient slab, the (d, n) anchors zb
// and the (1, d) sums of 1/gamma in VMEM and SMEM for the whole launch, which
// caps it at N <= 1M, d <= 1,024 and 2 MB of anchors. Here c, zb and invg stay
// in device memory, read and written by stream-ordered launches, so a block
// revisited within a launch reads the previous step's c and zb, and no cap
// applies; the facade keeps JAX's bounds only to pick this kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32
// (rs NULL unless int8); zb: (N / B, n) f32 per-block anchors and c, z, av
// ((n,) f32) updated in place; invg: (N / B,) f32 sums of 1/gamma_i by block
// id; starts: (K,) int32 block starts; sc: (6,) f32 scalars row [scale, 1/N,
// hat, hat*lambda, mode, aux]; part: (B / rows, n) f32 scratch, 16-byte
// aligned. rows divides B and is at most 32.
extern "C" int finito_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, float* zb, const float* invg, float* z, float* av,
    const int* starts, const float* sc, float* part, int n, int B, int rows,
    int K, void* stream) {
  StepArgs a{A, b, rs, c, z, av, starts, nullptr, nullptr,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.zb = zb;
  a.invg = invg;
  return static_cast<int>(launch_steps<kFinito>(storage, lowp, a));
}
