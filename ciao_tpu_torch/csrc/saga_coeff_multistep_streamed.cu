// K SAGA/SAG coefficient-table block steps for any N, steps k >= f masked, on
// an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:saga_coeff_multistep_streamed (body
// _saga_stream_kernel). The device code is in saga_steps.cuh, shared with
// saga_coeff_multistep.cu; the Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py saga_coeff_multistep_streamed, its plain
// PyTorch version saga_coeff_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased (1, TILE) windows
// and masks the steps k >= f after the first same-launch block revisit. Here c
// is a flat (N,) table in device memory, read and written in place by stream-
// ordered launches, so it serves any N as it is; the clamp count f is read on
// the device, and both launches of a masked step return before any other load.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// As saga_coeff_multistep_launch, plus fclamp: one int32 on the device, the
// clamp count f (steps k >= f are masked), or NULL for f = K.
extern "C" int saga_coeff_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, float* z, float* av, const int* starts, const float* wgts,
    const int* fclamp, const float* sc, float* part, int n, int B, int rows,
    int K, void* stream) {
  const StepArgs a{A, b, rs, c, z, av, nullptr, starts, wgts, fclamp,
                   sc, part, n, B, rows, K,
                   static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_steps<kSaga>(storage, lowp, a));
}
