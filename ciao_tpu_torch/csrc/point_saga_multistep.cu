// K Point-SAGA block steps on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:point_saga_multistep
// (body _point_saga_multi_kernel, theta solve _pointprox_theta). The device
// code is in saga_steps.cuh (method kPointSaga: a prologue that forms step 0's
// shifted iterate v = x - gamma av, a row phase that solves each row's prox
// theta with row_ops.cuh pointprox_theta<mode>, and point_saga_finish_kernel,
// which steps x and av and forms the next step's v); the Python wrapper and
// the design note are ciao_tpu_torch/ops/fused_block.py point_saga_multistep,
// its plain PyTorch version point_saga_multistep_ref.
//
// The oracle mode is a template parameter of the row phase (the TPU kernel
// specializes statically as well): 5 modes x 4 row types x 2 load paths
// instantiate 40 row kernels, each with its solve compiled alone.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K + 1 launches (0 on
// success; cudaErrorInvalidValue for a mode outside 0..4). A: (N, n) rows of
// `storage` (0 f32, 1 bf16, 2 int8); mode: the oracle formula (0 least
// squares, 1 logistic, 2 Huber, 3 squared hinge, 4 Poisson); b, na, c, rs:
// (N,) f32 (rs NULL unless int8), na the row square-norms |a_i|^2
// (dequantized for int8 rows); x, av: (n,) f32 iterate and table mean; c, x
// and av are updated in place; v: (n,) f32 scratch for the shifted iterate;
// starts: (K,) int32 block starts; sc: (6,) f32 scalars row [scale, gamma,
// 1/B, 1/N, mode, aux]; part: (B / rows, n) f32 scratch, 16-byte aligned.
// rows divides B and is at most 32.
extern "C" int point_saga_multistep_launch(
    const void* A, int storage, int lowp, int mode, const float* b,
    const float* rs, const float* na, float* c, float* x, float* av, float* v,
    const int* starts, const float* sc, float* part, int n, int B, int rows,
    int K, void* stream) {
  StepArgs a{A, b, rs, c, v, av, starts, nullptr, nullptr,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.xi = x;
  a.na = na;
  return static_cast<int>(
      launch_steps_by_mode<kPointSaga>(mode, storage, lowp, a));
}
