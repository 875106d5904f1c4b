// K Katyusha inner block steps against an anchor coefficient table on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:katyusha_coeff_multistep (body
// _katyusha_coeff_multi_kernel). The device code is in saga_steps.cuh (method
// kKatyusha: a prologue that forms step 0's coupled point x, SVRG's row phase
// at x with dc = c(x) - c_anchor, and katyusha_finish_kernel, which updates z,
// y and the running sum of y and forms the next step's x); the Python wrapper
// and the design note are ciao_tpu_torch/ops/fused_block.py
// katyusha_coeff_multistep, its plain PyTorch version
// katyusha_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K + 1 launches (0 on
// success). A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, canch, rs:
// (N,) f32 (rs NULL unless int8), canch the anchor coefficients c(x~), read
// only; xt: (n,) f32 anchor point x~; y, z, ys: (n,) f32 sequences and the
// running sum of y, updated in place; av: (n,) f32 anchor mean gradient, read
// only; x: (n,) f32 scratch for the coupled point; starts: (K,) int32 block
// starts; sc: (10,) f32 scalars row [scale, alpha, beta, alpha*lambda,
// beta*lambda, 1/B, mode, tau1, tau2, aux]; part: (B / rows, n) f32 scratch,
// 16-byte aligned. rows divides B and is at most 32.
extern "C" int katyusha_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const float* xt, float* y, float* z, float* ys,
    const float* av, float* x, const int* starts, const float* sc,
    float* part, int n, int B, int rows, int K, void* stream) {
  // the kKatyusha kernels never write canch or av
  StepArgs a{A, b, rs, const_cast<float*>(canch), x,
             const_cast<float*>(av), ys, starts, nullptr, nullptr,
             sc, part, n, B, rows, K,
             static_cast<cudaStream_t>(stream)};
  a.y = y;
  a.zm = z;
  a.xa = xt;
  return static_cast<int>(launch_steps<kKatyusha>(storage, lowp, a));
}
