// K SSNM block steps for any N, steps k >= f masked, on an NVIDIA Hopper card
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:ssnm_multistep_streamed (body
// _ssnm_stream_kernel). The device code is in saga_steps.cuh (method kSsnm),
// shared with ssnm_multistep.cu; the Python wrapper and the design note are
// ciao_tpu_torch/ops/fused_block.py ssnm_multistep_streamed, its plain PyTorch
// version ssnm_multistep_streamed_ref.
//
// The TPU kernel streams the (1, N) table through aliased windows and clamps
// each launch at its first same-launch block revisit. Here c and zb live in
// device memory and every step's two launches are stream-ordered, so a
// revisit reads the previous step's values and the port's driver launches
// with f = NULL. With a clamp count both launches of a step k >= f return
// before any other load: a masked step writes neither c nor zb nor x nor gb.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// As ssnm_multistep_launch, with fclamp: one int32 on the device, the clamp
// count f, or NULL for f = K.
extern "C" int ssnm_multistep_streamed_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    float* c, float* zb, float* x, float* gb, float* y, const int* starts,
    const int* fclamp, const float* sc, float* part, int n, int B, int rows,
    int K, void* stream) {
  StepArgs a{A, b, rs, c, y, gb, starts, fclamp,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.zb = zb;
  a.xi = x;
  return static_cast<int>(launch_steps<kSsnm>(storage, lowp, a));
}
