// K Finito coefficient-table block steps on an NVIDIA Hopper card (sm_90a):
// one cooperative launch a call.
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:finito_coeff_multistep
// (body _finito_coeff_multi_kernel). The device code and the design note are
// in loopless_steps.cuh (method kFinitoSteps: SAGA's row phase, its formula
// threads reading and writing the table, and a finish that steps the running
// average against block j's anchor row zb_j, writes zb_j <- z and takes z
// <- soft(av)); the Python wrapper is ciao_tpu_torch/ops/fused_block.py
// finito_coeff_multistep, its plain PyTorch version
// finito_coeff_multistep_ref.
//
// The TPU kernel keeps the (8, N/8) coefficient slab, the (d, n) anchors zb
// and the (1, d) sums of 1/gamma in VMEM and SMEM for the whole launch, which
// caps it at N <= 1M, d <= 1,024 and 2 MB of anchors. Here c, zb and invg stay
// in device memory, c and zb read and written in place by the one launch, a
// block revisited within it reading the previous visit's c and zb (the
// engine's grid barriers order them), so no cap applies; the facade keeps
// JAX's bounds only to pick this kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32 (rs NULL unless int8), c the
// table; starts: (K,) int32 block starts (multiples of B); zb: (N / B, n) f32
// per-block anchors; invg: (N / B,) f32 sums of 1/gamma_i by block id; z, av:
// (n,) f32 iterate and running average; c, zb, z and av are updated in place;
// sc: (6,) f32 scalars row [scale, 1/N, hat, hat*lambda, mode, aux]; part,
// bar, rows, ctas, stage_rows, stages: as lsvrg_coeff_multistep's.
extern "C" int finito_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, const int* starts, float* zb, const float* invg, float* z,
    float* av, const float* sc, float* part, unsigned* bar, int n, int B,
    int rows, int ctas, int stage_rows, int stages, int K, void* stream) {
  LooplessArgs a{A,       b,       rs,      c,    starts,
                 nullptr, z,       nullptr, av,   sc,
                 nullptr, nullptr, nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  a.zb = zb;
  a.invg = invg;
  return launch_loopless<kFinitoSteps>(storage, lowp, a, stream);
}
