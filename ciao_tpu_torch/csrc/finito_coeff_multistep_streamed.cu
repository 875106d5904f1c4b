// K Finito coefficient-table block steps for any N, steps k >= f masked, on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:finito_coeff_multistep_streamed (body
// _finito_stream_kernel). The device code is in saga_steps.cuh (method
// kFinito), shared with finito_coeff_multistep.cu; the Python wrapper and the
// design note are ciao_tpu_torch/ops/fused_block.py
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

// As finito_coeff_multistep_launch, with invg_k: (K,) f32 by step, and
// fclamp: one int32 on the device, the clamp count f, or NULL for f = K.
extern "C" int finito_coeff_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, float* zb, const float* invg_k, float* z, float* av,
    const int* starts, const int* fclamp, const float* sc, float* part, int n,
    int B, int rows, int K, void* stream) {
  StepArgs a{A, b, rs, c, z, av, starts, nullptr, fclamp,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.zb = zb;
  a.invg = invg_k;
  a.invg_by_pos = 1;
  return static_cast<int>(launch_steps<kFinito>(storage, lowp, a));
}
