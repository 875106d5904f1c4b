// Up to K L-SVRG block steps against an anchor coefficient table, masked past
// a stop index, on an NVIDIA Hopper card (sm_90a): one cooperative launch a
// call.
//
// Replaces the Pallas TPU kernel
// ciao_tpu/ops/fused_block.py:lsvrg_coeff_multistep (body
// _lsvrg_coeff_multi_kernel). The device code and the design note are in
// loopless_steps.cuh (method kLsvrgSteps: a persistent grid of one CTA an SM
// at the headline, a ring of bulk-copied row stages that runs ahead across
// steps, two grid-wide barriers a step around the finish); the Python wrapper
// is ciao_tpu_torch/ops/fused_block.py lsvrg_coeff_multistep, its plain
// PyTorch version lsvrg_coeff_multistep_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8); b, canch, rs: (N,) f32 (rs NULL unless int8),
// canch the anchor coefficients, read only; starts: (K,) int32 block starts;
// stop: one int32 on the device, the last step to process (NULL: all K); w:
// (n,) f32 iterate, updated in place; wpre: (n,) f32, the pre-update iterate
// of each processed step (the caller fills it with w); av: (n,) f32 anchor
// mean gradient, read only; sc: (6,) f32 scalars row [scale, gamma,
// gamma*lambda, 1/B, mode, aux]; part: (ctas, n) f32 scratch, 16-byte
// aligned; bar: the grid barrier's word of the stream (zero before its first
// call, left so by each; calls on another stream take another word). rows,
// ctas: the grid rule's (checked against it); stage_rows, stages: the ring
// (ops/fused_block.py _loopless_grid).
extern "C" int lsvrg_coeff_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* canch, const int* starts, const int* stop, float* w,
    float* wpre, const float* av, const float* sc, float* part,
    unsigned* bar, int n, int B, int rows, int ctas, int stage_rows,
    int stages, int K, void* stream) {
  // the kLsvrgSteps kernels never write canch or av
  LooplessArgs a{A,       b,    rs,   const_cast<float*>(canch), starts,
                 stop,    w,    wpre, const_cast<float*>(av),    sc,
                 nullptr, nullptr, nullptr, part, bar, n, B, rows, ctas,
                 stage_rows, stages, K};
  return launch_loopless<kLsvrgSteps>(storage, lowp, a, stream);
}
