// K Finito coefficient-table block steps for any N, steps k >= f masked, on an
// NVIDIA Hopper card (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:finito_coeff_multistep_streamed (body
// _finito_stream_kernel). The device code and the design note are in
// loopless_steps.cuh (method kFinitoStreamSteps: kernel #9's method
// kFinitoSteps with the sum of 1/gamma_i read by step and the clamp count f
// read once on the device); the Python wrapper is
// ciao_tpu_torch/ops/fused_block.py finito_coeff_multistep_streamed, its
// plain PyTorch version finito_coeff_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased windows and clamps
// each launch at its first same-launch block revisit. Here c and zb live in
// device memory, read and written in place by the one launch, a block
// revisited within it reading the previous visit's c and zb (the engine's
// grid barriers order them), so the port's driver launches with f = NULL.
// With a clamp count the call processes min(K, f) steps, and a masked step
// writes neither c nor zb nor av nor z.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32 (rs NULL unless int8), c the
// table; starts: (K,) int32 block starts (multiples of B); zb: (N / B, n) f32
// per-block anchors; invg_k: (K,) f32 sums of 1/gamma_i of the steps'
// blocks, by step; fclamp: one int32 on the device, the clamp count f, or
// NULL for f = K; z, av: (n,) f32 iterate and running average; c, zb, z and
// av are updated in place; sc: (6,) f32 scalars row [scale, 1/N, hat,
// hat*lambda, mode, aux]; part, bar, rows, ctas, stage_rows, stages: as
// lsvrg_coeff_multistep's.
extern "C" int finito_coeff_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, const int* starts, float* zb, const float* invg_k,
    const int* fclamp, float* z, float* av, const float* sc, float* part,
    unsigned* bar, int n, int B, int rows, int ctas, int stage_rows,
    int stages, int K, void* stream) {
  LooplessArgs a{A,       b,       rs,      c,    starts,
                 fclamp,  z,       nullptr, av,   sc,
                 nullptr, nullptr, nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  a.zb = zb;
  a.invg = invg_k;
  return launch_loopless<kFinitoStreamSteps>(storage, lowp, a, stream);
}
