// K SVRG inner block steps against an anchor coefficient table on an NVIDIA
// Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:svrg_coeff_multistep
// (body _svrg_coeff_multi_kernel). The device code is in saga_steps.cuh,
// shared with the SAGA kernels (method kSvrg); the Python wrapper and the
// design note are ciao_tpu_torch/ops/fused_block.py svrg_coeff_multistep, its
// plain PyTorch version svrg_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, canch, rs: (N,) f32
// (rs NULL unless int8), canch the anchor coefficients, read only; w, zs:
// (n,) f32 inner iterate and running sum, updated in place; av: (n,) f32
// anchor mean gradient, read only; starts: (K,) int32 block starts; sc: (6,)
// f32 scalars row [scale, gamma, gamma*lambda, 1/B, mode, aux]; part:
// (B / rows, n) f32 scratch, 16-byte aligned. rows divides B and is at most 32.
extern "C" int svrg_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, float* w, float* zs, const float* av,
    const int* starts, const float* sc, float* part, int n, int B, int rows,
    int K, void* stream) {
  // the kSvrg kernels never write canch or av
  const StepArgs a{A, b, rs, const_cast<float*>(canch), w,
                   const_cast<float*>(av), zs, starts, nullptr, nullptr,
                   sc, part, n, B, rows, K,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_steps<kSvrg>(storage, lowp, a));
}
