// Up to K L-SVRG block steps against an anchor coefficient table, masked past
// a stop index, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:lsvrg_coeff_multistep (body
// _lsvrg_coeff_multi_kernel). The device code is in saga_steps.cuh (method
// kLsvrg: SVRG's row phase and lsvrg_finish_kernel, which records the
// pre-update iterate; both launches of a step k > *stop return before any
// other load); the Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py lsvrg_coeff_multistep, its plain PyTorch
// version lsvrg_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, canch, rs: (N,) f32
// (rs NULL unless int8), canch the anchor coefficients, read only; starts:
// (K,) int32 block starts; stop: one int32 on the device, the last step to
// process (NULL: all K); w: (n,) f32 iterate, updated in place; wpre: (n,)
// f32, the pre-update iterate of each processed step (the caller fills it
// with w); av: (n,) f32 anchor mean gradient, read only; sc: (6,) f32
// scalars row [scale, gamma, gamma*lambda, 1/B, mode, aux]; part: (B / rows,
// n) f32 scratch, 16-byte aligned. rows divides B and is at most 32.
extern "C" int lsvrg_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const int* starts, const int* stop, float* w,
    float* wpre, const float* av, const float* sc, float* part, int n, int B,
    int rows, int K, void* stream) {
  // the kLsvrg kernels never write canch or av
  StepArgs a{A, b, rs, const_cast<float*>(canch), w,
             const_cast<float*>(av), nullptr, starts, nullptr, stop,
             sc, part, n, B, rows, K,
             static_cast<cudaStream_t>(stream)};
  a.pre = wpre;
  return static_cast<int>(launch_steps<kLsvrg>(storage, lowp, a));
}
