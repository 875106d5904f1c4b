// K SARAH / ProxSARAH recursive block steps on an NVIDIA Hopper card
// (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:sarah_multistep
// (body _sarah_multi_kernel). The device code and the design note are in
// loopless_steps.cuh (method kSarahSteps: the persistent engine with two
// points, w_prev and w, staged in shared memory and both margins taken from
// one read of each staged row, dc = c(w) - c(w_prev), no coefficient table,
// and a finish of the recursion, the damped prox and the shift w_prev <- w);
// the Python wrapper is ciao_tpu_torch/ops/fused_block.py sarah_multistep, its
// plain PyTorch version sarah_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, rs: (N,) f32 (rs NULL unless int8); starts:
// (K,) int32 block starts; ww: (2, n) f32 pair [w_prev; w] and v: (n,) f32
// estimator, updated in place; sc: (7,) f32 scalars row [scale, gamma,
// gamma*lambda, eta, 1/B, mode, aux]; part, bar, rows, ctas, stage_rows,
// stages: as lsvrg_coeff_multistep's (stages may be 1 where two stages do not
// fit beside the two points).
extern "C" int sarah_multistep_launch(const void* A, int storage, int lowp,
                                      const float* b, const float* rs,
                                      const int* starts, float* ww, float* v,
                                      const float* sc, float* part,
                                      unsigned* bar, int n, int B, int rows,
                                      int ctas, int stage_rows, int stages,
                                      int K, void* stream) {
  LooplessArgs a{A,       b,       rs,      nullptr, starts,
                 nullptr, ww,      nullptr, v,       sc,
                 nullptr, nullptr, nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  return launch_loopless<kSarahSteps>(storage, lowp, a, stream);
}
