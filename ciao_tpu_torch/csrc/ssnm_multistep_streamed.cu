// K SSNM block steps for any N, steps k >= f masked, on an NVIDIA Hopper card
// (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:ssnm_multistep_streamed (body
// _ssnm_stream_kernel). The device code and the design note are in
// loopless_steps.cuh (method kSsnmSteps: SAGA's row phase of kSagaSteps at
// the momentum point y = tau x + (1 - tau) zb_j, formed once a step, step
// 0's by every CTA inside the launch and each later one by the finish that
// steps x, adds the innovation to the table mean gb and stores y as block
// j's point); the Python wrapper is ciao_tpu_torch/ops/fused_block.py
// ssnm_multistep_streamed, its plain PyTorch version
// ssnm_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased windows, with the
// stored points in VMEM, and clamps each launch at its first same-launch
// block revisit. Here c and zb live in device memory, read and written in
// place by the one launch, a block revisited within it reading the previous
// visit's c and zb (the engine's grid barriers order them), so the port's
// driver launches with f = NULL. With a clamp count the call processes
// min(K, f) steps, and a masked step writes neither c nor zb nor x nor gb.
//
// With fclamp NULL this entry is also kernel #19, which replaces
// ciao_tpu/ops/fused_block.py:ssnm_multistep (body _ssnm_multi_kernel: the
// same steps on block-aligned starts, the (8, N/8) table slab and the stored
// points resident in VMEM): its wrapper, fused_block.ssnm_multistep,
// launches this library's engine builds rather than compiling the same 28
// instantiations again.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32 (rs NULL unless int8), c the
// table; starts: (K,) int32 block starts, any in [0, N - B] (step k's stored
// point is zb[starts[k] / B]); zb: (N / B, n) f32 stored points; fclamp: one
// int32 on the device, the clamp count f, or NULL for f = K; y: (n,) f32
// scratch for the momentum point; x, gb: (n,) f32 iterate and table mean; c,
// zb, x and gb are updated in place; sc: (8,) f32 scalars row [scale, eta,
// eta*lambda, 1/B, 1/N, mode, tau, aux]; part, bar, rows, ctas, stage_rows,
// stages: as lsvrg_coeff_multistep's.
extern "C" int ssnm_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, const int* starts, float* zb, const int* fclamp, float* y,
    float* x, float* gb, const float* sc, float* part, unsigned* bar, int n,
    int B, int rows, int ctas, int stage_rows, int stages, int K,
    void* stream) {
  LooplessArgs a{A,       b,       rs,      c,    starts,
                 fclamp,  y,       nullptr, gb,   sc,
                 nullptr, x,       nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  a.zb = zb;
  return launch_loopless<kSsnmSteps>(storage, lowp, a, stream);
}
