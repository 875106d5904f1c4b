// Up to K L-Katyusha block steps against an anchor coefficient table, masked
// past a stop index, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:lkatyusha_coeff_multistep (body
// _lkatyusha_coeff_multi_kernel). The device code is in saga_steps.cuh
// (method kLKatyusha: Katyusha's prologue and row phase at the coupled point
// x, and lkatyusha_finish_kernel, the proximal z-step, the y coupling, the
// pre-update y and the next step's x; both launches of a step k > *stop
// return before any other load); the Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py lkatyusha_coeff_multistep, its plain
// PyTorch version lkatyusha_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K + 1 launches (0 on
// success). A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, canch, rs:
// (N,) f32 (rs NULL unless int8), canch the anchor coefficients c(w), read
// only; starts: (K,) int32 block starts; stop: one int32 on the device, the
// last step to process (NULL: all K); wa: (n,) f32 anchor point w; y, z: (n,)
// f32 sequences, updated in place; ypre: (n,) f32, the pre-update y of each
// processed step (the caller fills it with y); av: (n,) f32 anchor mean
// gradient, read only; x: (n,) f32 scratch for the coupled point; sc: (10,)
// f32 scalars row [scale, eta/L, tau*lambda, 1/(1 + eta*sigma), eta*sigma,
// theta1, theta2, 1/B, mode, aux]; part: (B / rows, n) f32 scratch, 16-byte
// aligned. rows divides B and is at most 32.
extern "C" int lkatyusha_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const int* starts, const int* stop, const float* wa,
    float* y, float* z, float* ypre, const float* av, float* x,
    const float* sc, float* part, int n, int B, int rows, int K,
    void* stream) {
  // the kLKatyusha kernels never write canch or av
  StepArgs a{A, b, rs, const_cast<float*>(canch), x,
             const_cast<float*>(av), nullptr, starts, nullptr, stop,
             sc, part, n, B, rows, K,
             static_cast<cudaStream_t>(stream)};
  a.y = y;
  a.zm = z;
  a.xa = wa;
  a.pre = ypre;
  return static_cast<int>(launch_steps<kLKatyusha>(storage, lowp, a));
}
