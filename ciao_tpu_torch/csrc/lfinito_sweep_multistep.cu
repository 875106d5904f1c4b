// K LFinito block steps (a sweep, or a chunk of one) on an NVIDIA Hopper card
// (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:lfinito_sweep_multistep
// (body _lfinito_sweep_kernel). The device code and the design note are in
// loopless_steps.cuh (method kLFinitoSteps: SVRG's row phase against the
// epoch's anchor coefficients, every CTA forming the first block's z =
// soft(av) inside the launch, and a finish that steps the running average and
// forms the next block's z); the Python wrapper is
// ciao_tpu_torch/ops/fused_block.py lfinito_sweep_multistep, its plain
// PyTorch version lfinito_sweep_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, canch, rs: (N,) f32 (rs NULL unless int8),
// canch the epoch's anchor coefficients, read only; starts: (K,) int32 block
// starts in visit order; invg: (K,) f32 sums of 1/gamma_i of the visited
// blocks in visit order; av: (n,) f32 running average, updated in place; z:
// (n,) f32 output, the last block's prox point; zf: (n,) f32 anchor point;
// sc: (6,) f32 scalars row [scale, hat, hat*lambda, 1/N, mode, aux]; part,
// bar, rows, ctas, stage_rows, stages: as lsvrg_coeff_multistep's.
extern "C" int lfinito_sweep_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const int* starts, const float* invg, float* av,
    float* z, const float* zf, const float* sc, float* part, unsigned* bar,
    int n, int B, int rows, int ctas, int stage_rows, int stages, int K,
    void* stream) {
  // the kLFinitoSteps kernels never write canch
  LooplessArgs a{A,       b,       rs,      const_cast<float*>(canch), starts,
                 nullptr, z,       nullptr, av,                        sc,
                 nullptr, nullptr, zf,      part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  a.invg = invg;
  return launch_loopless<kLFinitoSteps>(storage, lowp, a, stream);
}
