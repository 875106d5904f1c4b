// K ProShI sharing steps on the (N, n) block table, steps k >= f masked, on an
// NVIDIA Hopper card (sm_90a): one cooperative launch a call.
//
// Replaces the Pallas TPU kernel ciao_tpu/ops/fused_block.py:proshi_multistep
// (body _proshi_multi_kernel). The device code and the design note are in
// loopless_steps.cuh (method kProshiSteps); the Python wrapper is
// ciao_tpu_torch/ops/fused_block.py proshi_multistep, its plain PyTorch
// version proshi_multistep_ref.
//
// Step k on the block [s0, s0 + B), s0 = starts[k] (ProShI_basic.jl:111-123):
//
//   s_tmp_i = s_i + gamma_i z,  m_i = a_i . s_tmp_i (rs_i for int8 rows),
//   w_i = (gamma_i / N) c(m_i) (rs_i),  s_i <- s_tmp_i - w_i a_i,
//   av += sum_i (s_new_i - s_old_i),
//   z = (prox_g(av, hat) - av) / hat,
//
// prox_g by gmode: the identity (Zero: z = 0), clip(av, glo, ghi) (IndBox,
// glo may be -inf) or the soft-threshold at glo = hat lambda (NormL1). The
// engine's row phase takes each row's margin at its own point: a thread
// reads its units of the row's table values once, into registers, and
// writes the new ones from them after the formula; gamma_i is staged beside
// b and rs by the producer warp. The finish sums the column partials in a
// fixed order and applies av, the prox and z. The table, av and z are read
// back in the launch by coherent loads behind the grid barriers, so a block
// revisited within a call reads the previous visit's rows: the port's driver
// does not clamp. With a clamp count (one int32 on the device) the call
// processes min(K, f) steps and a masked step writes neither s nor av nor z.
//
// The TPU kernel takes a precision and ignores it: its margin is an exact f32
// product of the widened row and s_i + gamma_i z. So this kernel is built
// with exact f32 margins alone, for bf16 and int8 rows too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include "loopless_steps.cuh"

// Returns the launch's CUDA error (0 on success). A: (N, n) rows of `storage`
// (0 f32, 1 bf16, 2 int8, then rs holds the (N,) f32 dequant scales, else
// NULL); b, gamma: (N,) f32; starts: (K,) int32 block starts; s: (N, n) f32
// table, updated in place; fclamp: one int32 on the device, the clamp count f
// (steps k >= f are masked), or NULL for f = K; av, z: (n,) f32, updated in
// place; sc: (8,) f32 [scale, 1/N, 1/hat, mode, glo, ghi, gmode, aux]; lowp
// is ignored (exact f32 margins); part, bar, rows, ctas, stage_rows, stages:
// as lsvrg_coeff_multistep's.
extern "C" int proshi_multistep_launch(
    const void* A, int storage, int lowp, const float* b, const float* rs,
    const float* gamma, const int* starts, float* s, const int* fclamp,
    float* av, float* z, const float* sc, float* part, unsigned* bar, int n,
    int B, int rows, int ctas, int stage_rows, int stages, int K,
    void* stream) {
  LooplessArgs a{A,       b,       rs,      const_cast<float*>(gamma),
                 starts,  fclamp,  z,       nullptr,
                 av,      sc,      nullptr, nullptr,
                 nullptr, part,    bar,     n,
                 B,       rows,    ctas,    stage_rows,
                 stages,  K};
  a.s = s;
  return launch_loopless<kProshiSteps>(storage, lowp, a, stream);
}
