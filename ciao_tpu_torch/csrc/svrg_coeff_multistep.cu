// K SVRG inner block steps against an anchor coefficient table on an NVIDIA
// Hopper card (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:svrg_coeff_multistep
// (body _svrg_coeff_multi_kernel). The device code and the design note are in
// loopless_steps.cuh (method kSvrgSteps: L-SVRG's persistent engine, whose
// finish also adds each step's w to the running sum of its columns); the
// Python wrapper is ciao_tpu_torch/ops/fused_block.py svrg_coeff_multistep,
// its plain PyTorch version svrg_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, canch, rs: (N,) f32 (rs NULL unless int8),
// canch the anchor coefficients, read only; starts: (K,) int32 block starts;
// w, zs: (n,) f32 inner iterate and running sum, updated in place; av: (n,)
// f32 anchor mean gradient, read only; sc: (6,) f32 scalars row [scale,
// gamma, gamma*lambda, 1/B, mode, aux]; part, bar, rows, ctas, stage_rows,
// stages: as lsvrg_coeff_multistep's.
extern "C" int svrg_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const int* starts, float* w, float* zs,
    const float* av, const float* sc, float* part, unsigned* bar, int n,
    int B, int rows, int ctas, int stage_rows, int stages, int K,
    void* stream) {
  // the kSvrgSteps kernels never write canch or av
  LooplessArgs a{A,       b,       rs,      const_cast<float*>(canch), starts,
                 nullptr, w,       nullptr, const_cast<float*>(av),    sc,
                 nullptr, nullptr, nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K, zs};
  return launch_loopless<kSvrgSteps>(storage, lowp, a, stream);
}
