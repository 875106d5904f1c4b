// K Finito coefficient-table block steps for any N, steps k >= f masked, on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:finito_coeff_multistep_streamed (body
// _finito_stream_kernel). The device code is in saga_steps.cuh (method
// kFinito: SAGA's row phase, finito_finish_kernel); the Python wrapper and
// the design note are ciao_tpu_torch/ops/fused_block.py
// finito_coeff_multistep_streamed, its plain PyTorch version
// finito_coeff_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased windows and clamps
// each launch at its first same-launch block revisit. Here c and zb live in
// device memory and every step's two launches are stream-ordered, so a
// revisit reads the previous step's values and the port's driver launches
// with f = NULL. With a clamp count both launches of a step k >= f return
// before any other load: a masked step writes neither c nor zb nor av nor z.
// invg_k holds the sums of 1/gamma_i of the K steps' blocks, by step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K launches (0 on success).
// A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, c, rs: (N,) f32
// (rs NULL unless int8); zb: (N / B, n) f32 per-block anchors and c, z, av
// ((n,) f32) updated in place; invg_k: (K,) f32 sums of 1/gamma_i of the
// steps' blocks, by step; starts: (K,) int32 block starts; fclamp: one int32
// on the device, the clamp count f, or NULL for f = K; sc: (6,) f32 scalars
// row [scale, 1/N, hat, hat*lambda, mode, aux]; part: (B / rows, n) f32
// scratch, 16-byte aligned. rows divides B and is at most 32.
extern "C" int finito_coeff_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, float* zb, const float* invg_k, float* z, float* av,
    const int* starts, const int* fclamp, const float* sc, float* part, int n,
    int B, int rows, int K, void* stream) {
  StepArgs a{A, b, rs, c, z, av, starts, nullptr, fclamp,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.zb = zb;
  a.invg = invg_k;
  return static_cast<int>(launch_steps<kFinito>(storage, lowp, a));
}
