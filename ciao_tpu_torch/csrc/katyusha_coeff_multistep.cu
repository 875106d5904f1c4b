// K Katyusha inner block steps against an anchor coefficient table on an
// NVIDIA Hopper card (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:katyusha_coeff_multistep (body
// _katyusha_coeff_multi_kernel). The device code and the design note are in
// loopless_steps.cuh (method kKatyushaSteps: L-Katyusha's persistent engine,
// the margins at the coupled point x formed for step 0 inside the launch,
// dc = c(x) - c_anchor, and Katyusha's Option II finish: the z- and y-steps,
// the running sum of y and the next step's x); the Python wrapper is
// ciao_tpu_torch/ops/fused_block.py katyusha_coeff_multistep, its plain
// PyTorch version katyusha_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, canch, rs: (N,) f32 (rs NULL unless int8),
// canch the anchor coefficients c(x~), read only; starts: (K,) int32 block
// starts; xt: (n,) f32 anchor point x~; y, z, ys: (n,) f32 sequences and the
// running sum of y, updated in place; av: (n,) f32 anchor mean gradient, read
// only; x: (n,) f32 scratch for the coupled point; sc: (10,) f32 scalars row
// [scale, alpha, beta, alpha*lambda, beta*lambda, 1/B, mode, tau1, tau2,
// aux]; part, bar, rows, ctas, stage_rows, stages: as
// lsvrg_coeff_multistep's.
extern "C" int katyusha_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const int* starts, const float* xt, float* y,
    float* z, float* ys, const float* av, float* x, const float* sc,
    float* part, unsigned* bar, int n, int B, int rows, int ctas,
    int stage_rows, int stages, int K, void* stream) {
  // the kKatyushaSteps kernels never write canch or av
  LooplessArgs a{A,       b, rs,      const_cast<float*>(canch), starts,
                 nullptr, x, nullptr, const_cast<float*>(av),    sc,
                 y,       z, xt,      part, bar, n, B, rows, ctas, stage_rows,
                 stages, K, ys};
  return launch_loopless<kKatyushaSteps>(storage, lowp, a, stream);
}
