// K SAGA/SAG coefficient-table block steps on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:saga_coeff_multistep
// (body _saga_coeff_multi_kernel). The device code is in saga_steps.cuh; the
// Python wrapper and the design note are ciao_tpu_torch/ops/fused_block.py
// saga_coeff_multistep, its plain PyTorch version saga_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32
// (rs NULL unless int8); z, av: (n,) f32, updated in place; starts: (K,)
// int32 block starts; wgts: (K,) f32 direction weights or NULL; sc: (8,) f32
// scalars row; part: (B / rows, n) f32 scratch, 16-byte aligned. rows divides
// B and is at most 32.
extern "C" int saga_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, float* z, float* av, const int* starts, const float* wgts,
    const float* sc, float* part, int n, int B, int rows, int K,
    void* stream) {
  const StepArgs a{A, b, rs, c, z, av, starts, wgts, nullptr,
                   sc, part, n, B, rows, K,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_steps<kSaga>(storage, lowp, a));
}
