// K SARAH / ProxSARAH recursive block steps on an NVIDIA Hopper card
// (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:sarah_multistep
// (body _sarah_multi_kernel). The device code is in saga_steps.cuh (method
// kSarah: a row phase that stages w_prev and w beside the rows and takes both
// margins from one read of each row, and sarah_finish_kernel, the recursion
// and the damped prox); the Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py sarah_multistep, its plain PyTorch
// version sarah_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, rs: (N,) f32 (rs
// NULL unless int8); ww: (2, n) f32 pair [w_prev; w] and v: (n,) f32
// estimator, updated in place; starts: (K,) int32 block starts; sc: (7,) f32
// scalars row [scale, gamma, gamma*lambda, eta, 1/B, mode, aux]; part:
// (B / rows, n) f32 scratch, 16-byte aligned. rows divides B and is at most
// 32.
extern "C" int sarah_multistep_launch(const void* A, int storage, int lowp,
                                      const float* b, const float* rs,
                                      float* ww, float* v, const int* starts,
                                      const float* sc, float* part, int n,
                                      int B, int rows, int K, void* stream) {
  StepArgs a{A, b, rs, nullptr, ww, nullptr, nullptr, starts, nullptr,
             nullptr, sc, part, n, B, rows, K,
             static_cast<cudaStream_t>(stream)};
  a.v = v;
  return static_cast<int>(launch_steps<kSarah>(storage, lowp, a));
}
