// K SSNM block steps on an NVIDIA Hopper card (sm_90a).
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:ssnm_multistep
// (body _ssnm_multi_kernel). The device code is in saga_steps.cuh (method
// kSsnm: a prologue that forms step 0's momentum point y, SAGA's row phase at
// y, and ssnm_finish_kernel, which steps x, adds the innovation to the table
// mean, stores y as the block's point and forms the next step's y); the Python
// wrapper and the design note are ciao_tpu_torch/ops/fused_block.py
// ssnm_multistep, its plain PyTorch version ssnm_multistep_ref.
//
// The TPU kernel keeps the (8, N/8) coefficient slab and the (d, n) stored
// points in VMEM for the whole launch. Here c and zb stay in device memory,
// read and written by stream-ordered launches, so a block revisited within a
// launch reads the previous step's c and zb.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "saga_steps.cuh"

// Returns cudaGetLastError() after queueing the 2K + 1 launches (0 on
// success). A: (N, n) rows of `storage` (0 f32, 1 bf16, 2 int8); b, c, rs:
// (N,) f32 (rs NULL unless int8); zb: (N / B, n) f32 stored points; x, gb:
// (n,) f32 iterate and table mean; c, zb, x and gb are updated in place; y:
// (n,) f32 scratch for the momentum point; starts: (K,) int32 block starts;
// sc: (8,) f32 scalars row [scale, eta, eta*lambda, 1/B, 1/N, mode, tau, aux];
// part: (B / rows, n) f32 scratch, 16-byte aligned. rows divides B and is at
// most 32.
extern "C" int ssnm_multistep_launch(const void* A, int storage, int lowp,
                                     const float* b, const float* rs, float* c,
                                     float* zb, float* x, float* gb, float* y,
                                     const int* starts, const float* sc,
                                     float* part, int n, int B, int rows,
                                     int K, void* stream) {
  StepArgs a{A, b, rs, c, y, gb, starts, nullptr,
             sc, part, n, B, rows, K, static_cast<cudaStream_t>(stream)};
  a.zb = zb;
  a.xi = x;
  return static_cast<int>(launch_steps<kSsnm>(storage, lowp, a));
}
