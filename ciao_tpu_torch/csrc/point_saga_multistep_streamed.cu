// K Point-SAGA block steps for any N, steps k >= f masked, on an NVIDIA
// Hopper card (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:point_saga_multistep_streamed (body
// _point_saga_stream_kernel). The device code and the design note are in
// loopless_steps.cuh (method kPointSagaSteps: the persistent engine, step
// 0's shifted iterate v = x - gamma av formed in every CTA, each row's prox
// theta solved by one thread with row_ops.cuh pointprox_theta_of, the rows
// of a step solved together after all its margins, and a finish that steps
// x and av and forms the next step's v); the Python wrapper is
// ciao_tpu_torch/ops/fused_block.py point_saga_multistep_streamed, its
// plain PyTorch version point_saga_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased windows and clamps
// each launch at its first same-launch block revisit. Here c lives in device
// memory, read and written in place by the one launch, a block revisited
// within it reading the previous visit's c (the engine's grid barriers order
// them), so the port's driver launches with f = NULL. With a clamp count the
// call processes min(K, f) steps, and a masked step writes neither c nor x
// nor av.
//
// With fclamp NULL this entry is also kernel #12, which replaces
// ciao_tpu/ops/fused_block.py:point_saga_multistep (body
// _point_saga_multi_kernel, theta solve _pointprox_theta: the same steps on
// block-aligned starts, the (8, N/8) table slab resident in VMEM): its
// wrapper, fused_block.point_saga_multistep, launches this library's engine
// builds rather than compiling the same 28 instantiations again.
//
// The oracle mode is a value of the call, not of the build (the TPU kernels
// specialize on it statically, where a dynamic select costs their vector
// unit the Newton's work for every mode): a uniform branch a row here, and
// one build of the engine's 28 instead of five.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success; cudaErrorInvalidValue for a
// mode outside 0..4). A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8);
// b, c, na, rs: (N,) f32 (rs NULL unless int8), c the table, updated in
// place, na the row square-norms |a_i|^2 (dequantized for int8 rows);
// starts: (K,) int32 block starts, any in [0, N - B]; mode: the oracle
// formula (0 least squares, 1 logistic, 2 Huber, 3 squared hinge, 4
// Poisson); fclamp: one int32 on the device, the clamp count f, or NULL for
// f = K; x, av: (n,) f32 iterate and table mean, updated in place; v: (n,)
// f32 scratch for the shifted iterate; sc: (6,) f32 scalars row [scale,
// gamma, 1/B, 1/N, mode, aux]; part, bar, rows, ctas, stage_rows, stages: as
// lsvrg_coeff_multistep's.
extern "C" int point_saga_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, const float* na, const int* starts, int mode,
    const int* fclamp, float* x, float* av, float* v, const float* sc,
    float* part, unsigned* bar, int n, int B, int rows, int ctas,
    int stage_rows, int stages, int K, void* stream) {
  if (mode < kLsq || mode > kPoisson)
    return static_cast<int>(cudaErrorInvalidValue);
  LooplessArgs a{A,       b,       rs,      c,    starts,
                 fclamp,  v,       nullptr, av,   sc,
                 nullptr, x,       nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  a.na = na;
  a.pmode = mode;
  return launch_loopless<kPointSagaSteps>(storage, lowp, a, stream);
}
