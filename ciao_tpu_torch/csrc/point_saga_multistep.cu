// K Point-SAGA block steps on an NVIDIA Hopper card (sm_90a): one
// cooperative launch a call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:point_saga_multistep (body
// _point_saga_multi_kernel, theta solve _pointprox_theta). The device
// code and the design note are in loopless_steps.cuh (method kPointSagaSteps:
// the persistent engine, step 0's shifted iterate v = x - gamma av formed in
// every CTA, each row's prox theta solved by one thread with row_ops.cuh
// pointprox_theta_of, the rows of a step solved together after all its
// margins, and a finish that steps x and av and forms the next step's v);
// the Python wrapper is ciao_tpu_torch/ops/fused_block.py
// point_saga_multistep, its plain PyTorch version point_saga_multistep_ref.
//
// The oracle mode is a value of the call, not of the build (the TPU kernel
// specializes on it statically, where a dynamic select costs its vector
// unit the Newton's work for every mode): a uniform branch a row here, and
// one build of the engine's 28 instead of five.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success; cudaErrorInvalidValue for a
// mode outside 0..4). A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8);
// b, c, na, rs: (N,) f32 (rs NULL unless int8), c the table, updated in
// place, na the row square-norms |a_i|^2 (dequantized for int8 rows);
// starts: (K,) int32 block starts, any in [0, N - B]; mode: the oracle
// formula (0 least squares, 1 logistic, 2 Huber, 3 squared hinge, 4
// Poisson); x, av: (n,) f32 iterate and table mean, updated in place; v:
// (n,) f32 scratch for the shifted iterate; sc: (6,) f32 scalars row [scale,
// gamma, 1/B, 1/N, mode, aux]; part, bar, rows, ctas, stage_rows, stages: as
// lsvrg_coeff_multistep's.
extern "C" int point_saga_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, const float* na, const int* starts, int mode, float* x,
    float* av, float* v, const float* sc, float* part, unsigned* bar, int n,
    int B, int rows, int ctas, int stage_rows, int stages, int K,
    void* stream) {
  if (mode < kLsq || mode > kPoisson)
    return static_cast<int>(cudaErrorInvalidValue);
  LooplessArgs a{A,       b,       rs,      c,    starts,
                 nullptr, v,       nullptr, av,   sc,
                 nullptr, x,       nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  a.na = na;
  a.pmode = mode;
  return launch_loopless<kPointSagaSteps>(storage, lowp, a, stream);
}
