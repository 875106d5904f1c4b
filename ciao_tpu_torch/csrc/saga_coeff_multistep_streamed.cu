// K SAGA/SAG coefficient-table block steps for any N, steps k >= f masked, on
// an NVIDIA Hopper card (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:saga_coeff_multistep_streamed (body
// _saga_stream_kernel). The device code and the design note are in
// loopless_steps.cuh (method kSagaSteps: the persistent engine of the
// loopless pair, its finish SAGA's average, direction and prox, its formula
// threads reading and writing the table); the Python wrapper is
// ciao_tpu_torch/ops/fused_block.py saga_coeff_multistep_streamed, its plain
// PyTorch version saga_coeff_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased (1, TILE) windows
// and masks the steps k >= f after the first same-launch block revisit. Here c
// is a flat (N,) table in device memory, read and written in place by the
// one launch, a revisit reading the previous visit's coefficients (the
// engine's grid barriers order them), so it serves any N and any schedule as
// it is; the clamp count f is read on the device once, and the masked steps
// write nothing.
//
// With fclamp NULL this entry is also kernel #3, which replaces
// ciao_tpu/ops/fused_block.py:saga_coeff_multistep (body
// _saga_coeff_multi_kernel: the same steps on block-aligned starts, the
// table resident in VMEM): its wrapper, fused_block.saga_coeff_multistep,
// launches this library's engine builds rather than compiling the same 28
// instantiations again.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32 (rs NULL unless int8), c the
// table, updated in place; starts: (K,) int32 block starts, any in [0, N -
// B]; fclamp: one int32 on the device, the clamp count f (steps k >= f are
// masked), or NULL for f = K; wgts: (K,) f32 direction weights or NULL; z,
// av: (n,) f32 iterate and running average, updated in place; sc: (8,) f32
// scalars row [scale, gamma, gamma*lambda, 1/B, 1/N, sag, mode, aux]; part,
// bar, rows, ctas, stage_rows, stages: as lsvrg_coeff_multistep's.
extern "C" int saga_coeff_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, const int* starts, const int* fclamp, const float* wgts,
    float* z, float* av, const float* sc, float* part, unsigned* bar, int n,
    int B, int rows, int ctas, int stage_rows, int stages, int K,
    void* stream) {
  LooplessArgs a{A,       b,       rs,      c,    starts,
                 fclamp,  z,       nullptr, av,   sc,
                 nullptr, nullptr, nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K, nullptr, wgts};
  return launch_loopless<kSagaSteps>(storage, lowp, a, stream);
}
