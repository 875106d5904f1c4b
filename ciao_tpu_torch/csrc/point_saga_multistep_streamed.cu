// K Point-SAGA block steps for any N, steps k >= f masked, on an NVIDIA
// Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:point_saga_multistep_streamed (body
// _point_saga_stream_kernel). The device code is in saga_steps.cuh (method
// kPointSaga), shared with point_saga_multistep.cu; the Python wrapper and the
// design note are ciao_tpu_torch/ops/fused_block.py
// point_saga_multistep_streamed, its plain PyTorch version
// point_saga_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased windows and clamps
// each launch at its first same-launch block revisit; here the table lives in
// device memory and the launches are stream-ordered, so the port's driver
// launches with f = NULL. With a clamp count both launches of a step k >= f
// return before any other load: a masked step writes neither c nor x nor av.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// As point_saga_multistep_launch, with fclamp: one int32 on the device, the
// clamp count f, or NULL for f = K.
extern "C" int point_saga_multistep_streamed_launch(
    const void* A, int storage, int lowp, int mode, const float* b,
    const float* rs, const float* na, float* c, float* x, float* av, float* v,
    const int* starts, const int* fclamp, const float* sc, float* part, int n,
    int B, int rows, int K, void* stream) {
  StepArgs a{A, b, rs, c, v, av, starts, fclamp,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.xi = x;
  a.na = na;
  return static_cast<int>(
      launch_steps_by_mode<kPointSaga>(mode, storage, lowp, a));
}
