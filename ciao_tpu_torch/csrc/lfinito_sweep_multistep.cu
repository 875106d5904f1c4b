// K LFinito block steps (a sweep, or a chunk of one) on an NVIDIA Hopper card
// (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:lfinito_sweep_multistep
// (body _lfinito_sweep_kernel). The device code is in saga_steps.cuh (method
// kLFinito: SVRG's row phase against the epoch's anchor coefficients,
// lfinito_finish_kernel, and a prologue that forms the first block's z); the
// Python wrapper and the design note are ciao_tpu_torch/ops/fused_block.py
// lfinito_sweep_multistep, its plain PyTorch version
// lfinito_sweep_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K + 1 launches (0 on
// success). A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, canch, rs:
// (N,) f32 (rs NULL unless int8), canch the epoch's anchor coefficients, read
// only; zf: (n,) f32 anchor point; invg: (K,) f32 sums of 1/gamma_i of the
// visited blocks in visit order; av: (n,) f32 running average, updated in
// place; z: (n,) f32 output, the last block's prox point; starts: (K,) int32
// block starts in visit order; sc: (6,) f32 scalars row [scale, hat,
// hat*lambda, 1/N, mode, aux]; part: (B / rows, n) f32 scratch, 16-byte
// aligned. rows divides B and is at most 32.
extern "C" int lfinito_sweep_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const float* zf, const float* invg, float* av,
    float* z, const int* starts, const float* sc, float* part, int n, int B,
    int rows, int K, void* stream) {
  // the kLFinito kernels never write canch
  StepArgs a{A, b, rs, const_cast<float*>(canch), z, av, starts,
             nullptr, nullptr, sc, part, n, B, rows, K,
             static_cast<cudaStream_t>(stream)};
  a.invg = invg;
  a.zf = zf;
  return static_cast<int>(launch_steps<kLFinito>(storage, lowp, a));
}
