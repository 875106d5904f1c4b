// The persistent step engine of all fifteen step kernels on an NVIDIA Hopper
// card (sm_90a): a whole call of K block steps in one cooperative launch,
//
//   lsvrg_coeff_multistep.cu          replaces ciao_tpu/ops/fused_block.py
//                                     lsvrg_coeff_multistep (L-SVRG steps,
//                                     body _lsvrg_coeff_multi_kernel);
//   lkatyusha_coeff_multistep.cu      replaces lkatyusha_coeff_multistep
//                                     (L-Katyusha steps, body
//                                     _lkatyusha_coeff_multi_kernel);
//   svrg_coeff_multistep.cu           replaces svrg_coeff_multistep (SVRG
//                                     inner steps, body
//                                     _svrg_coeff_multi_kernel);
//   saga_coeff_multistep_streamed.cu  replaces saga_coeff_multistep_streamed
//                                     (SAGA/SAG steps for any N, steps k >= f
//                                     masked, body _saga_stream_kernel) and,
//                                     with no clamp count,
//                                     saga_coeff_multistep (body
//                                     _saga_coeff_multi_kernel);
//   katyusha_coeff_multistep.cu       replaces katyusha_coeff_multistep
//                                     (Katyusha inner steps, body
//                                     _katyusha_coeff_multi_kernel);
//   sarah_multistep.cu                replaces sarah_multistep (SARAH's
//                                     recursive steps, body
//                                     _sarah_multi_kernel);
//   finito_coeff_multistep.cu         replaces finito_coeff_multistep
//                                     (Finito-basic coefficient steps with
//                                     per-block anchors, body
//                                     _finito_coeff_multi_kernel);
//   lfinito_sweep_multistep.cu        replaces lfinito_sweep_multistep (an
//                                     LFinito block sweep, body
//                                     _lfinito_sweep_kernel);
//   finito_coeff_multistep_streamed.cu
//                                     replaces
//                                     finito_coeff_multistep_streamed
//                                     (Finito's steps for any N, Σ 1/gamma
//                                     by step, steps k >= f masked, body
//                                     _finito_stream_kernel);
//   proshi_multistep.cu               replaces proshi_multistep (ProShI
//                                     sharing steps on the (N, n) block
//                                     table, steps k >= f masked, body
//                                     _proshi_multi_kernel);
//   point_saga_multistep_streamed.cu  replaces
//                                     point_saga_multistep_streamed
//                                     (Point-SAGA steps for any N, a prox
//                                     solve a row, steps k >= f masked,
//                                     body _point_saga_stream_kernel) and,
//                                     with no clamp count,
//                                     point_saga_multistep (body
//                                     _point_saga_multi_kernel, theta
//                                     solve _pointprox_theta);
//   ssnm_multistep_streamed.cu        replaces ssnm_multistep_streamed
//                                     (SSNM steps for any N, steps k >= f
//                                     masked, body _ssnm_stream_kernel)
//                                     and, with no clamp count,
//                                     ssnm_multistep (body
//                                     _ssnm_multi_kernel).
//
// The Python wrappers are in ciao_tpu_torch/ops/fused_block.py, beside the
// plain PyTorch versions (the *_ref functions), whose arithmetic (bf16
// roundings included) this computes; _loopless_grid there is the grid and
// ring rule below.
//
// What bounds it. A step must read its block's rows once: B.n.itemsize bytes,
// 16 MiB f32 and 4 MiB int8 at B = 4,096, n = 1,024 (5.0 and 1.25 us at the
// card's 3.35 TB/s), 4 MiB f32 and 1 MiB int8 at the deep target's B = 8,192,
// n = 128, for 4.B.n flops: bytes, by a factor of 5 to 20. The kernels this
// engine replaced, a row phase and a finish launched in turn for each step,
// reached 31-35 % (f32) and 8-11 % (int8) of that on an H100 at the headline
// and 13 % (f32) at the deep shape, where the host's enqueue of two launches
// a step set the pace: a CTA staged all its rows before any margin, the
// finish ran on n / 32 CTAs while the rest of the card idled, and no load of
// the next step's rows could start before the finish had ended, though
// nothing but the stream order held it: the rows do not depend on the
// iterate.
//
// The engine, one launch of G CTAs, all resident at once (a cooperative
// launch; refused, never split, if they do not fit):
//
//   - the grid rule: CTA c owns rows [c R, c R + R) of every step's block, R
//     the smallest power of two with ceil(B / R) <= the SMs (R = 32 at B =
//     4,096, 8 at B = 1,024 and 64 at B = 8,192: 128 CTAs each time; the last
//     CTA of a B that R does not divide takes the rest);
//   - the ring: P stages of S whole rows in shared memory (S the largest
//     power of two up to R and 256 rows in 32 KB, one row where a row is
//     larger; P as many as fit, 2 to 8: 8 f32 rows and 6 stages at n =
//     1,024, 64 f32 rows and 6 stages at n = 128, one f32 row and 2 stages at
//     n = 16,384; one stage only where two do not fit beside SARAH's two
//     points, f32 rows wider than 14,456 columns: the producer then loads a
//     stage once the consumers have read the last, with no overlap);
//     one producer warp fills stage after stage, each by one bulk copy
//     (cp.async.bulk) of its contiguous rows and the rows' b, anchor
//     coefficients (none for SAGA and SARAH) and rs by cp.async, all
//     completing on the stage's full
//     mbarrier, and refills a stage as soon as its empty mbarrier says the
//     eight consumer warps have read it. It runs ahead across step
//     boundaries (step k + 1's rows, read from starts[k + 1], are loading
//     while step k's finish and barriers run: with P S >= R all of them);
//   - step k on the eight consumer warps: the point (w for L-SVRG and SVRG,
//     x for L-Katyusha and Katyusha, z for SAGA, the Finitos and ProShI,
//     both w_prev and w for SARAH, v = x - gamma av for Point-SAGA, the
//     momentum point y = tau x + (1 - tau) zb_j for SSNM)
//     copied into shared memory, rounded to bf16 where the dots round, by
//     plain loads from L2 (the last finish wrote it through the generic
//     proxy); then for each stage as it lands: the margins, every thread
//     taking its own units (the columns it owns in the column sums) of eight
//     rows at once, reduced over the warp by a halving butterfly (nine
//     shuffles for eight rows) and over the warps of its row group in warp
//     order (SARAH: each loaded unit feeds two sets of sums, one a point,
//     and two butterflies reduce them, so both margins come from one read of
//     the staged row); the coefficient formula and dc, a thread a row
//     (anchor minus live for L-SVRG and SVRG, live at x minus anchor for
//     L-Katyusha and Katyusha, new minus old for SAGA, SSNM and Finito,
//     which write the new one to their table, anchor minus live for
//     LFinito, c at w minus c at w_prev for SARAH, ProShI's row weight w_i,
//     old minus the prox solve theta_i for Point-SAGA, which writes theta_i
//     to its table;
//     rounded to bf16 where the dots round and scaled by rs for int8 rows);
//     and the stage's rows added into column sums held in registers,
//     each thread the same units all call. int8 is widened by the
//     byte-permute trick, bf16 by a shift;
//   - Point-SAGA's prox solve: logistic and Poisson rows take 20 Newton
//     steps a row (an expf and two IEEE divisions each, 4.2-4.5 us in a
//     chain on an H100), so where a step has two stages or more their step
//     takes the margins of all its stages first, each row's margin kept by
//     the thread of its index in the CTA's share (one barrier a stage: the
//     stages' margin sums alternate between two buffers), then solves every
//     row of the share at once, a thread a row, and only then adds the
//     stages into the column sums: one chain a step on the critical path,
//     not one a stage (at n = 1,024, B = 4,096, four f32 stages of eight
//     rows, two bf16 of sixteen; one int8 stage of 32, as at B = 1,024 and
//     n = 128, is one chain anyway). This needs the step's stages in the
//     ring at once, a thread a row and at most four units a thread
//     (ceil(R / S) <= P, R <= 256, S <= 32, n <= 4,096 on the 16-byte
//     path); elsewhere (at B = 4,096 f32 rows of 2,048 columns or more,
//     bf16 of 4,096; n = 1,024 f32 at B = 8,192), and for the closed forms
//     (least squares, Huber, squared hinge, for which holding a step's
//     stages cost 0.3 us a step and 0.6 us a stage on an H100), each stage
//     solves its rows after its margins, as the other methods' formulas;
//   - narrow rows: where a row has fewer column units than the 256 consumer
//     threads (four columns a unit on the 16-byte path), the threads form g =
//     256 / U row groups of U threads, U the units rounded up to a power of
//     two and at least a warp (g = 8 at n = 128: a warp a group). Group i
//     takes the stage's rows 8i..8i+7, 8(i + g)..., both for its margins and
//     for its column sums, so every warp has work; at the step's end the
//     groups' sums are added in group order through shared memory. The
//     split is a build of its own (rows of at most 128 units): wider rows,
//     n = 1,024 among them, keep one group and the code they had;
//   - the CTA's partial into part[c, :], a grid-wide barrier, the finish:
//     CTA c takes ceil(n / G) columns, sums their G partials in a fixed order
//     (lanes over CTAs, a shuffle tree, then the eight warps in order: runs
//     repeat bit for bit) and applies L-SVRG's w-step (wpre <- w), SVRG's
//     w-step and running sum (zs += w), SAGA's average, SAGA or SAG
//     direction (weighted by wgts[k] where given) and prox, L-Katyusha's
//     z-step, y coupling, ypre and the next x, Katyusha's (Option II) z- and
//     y-steps, running sum (ys += y) and next x, SARAH's recursion (v +=
//     sum / B), damped prox and shift (w_prev <- w, w <- w + eta (y - w)),
//     Finito's average against block j's anchor (av += hat invg_j (z -
//     zb_j) - (hat / N) sum, zb_j <- z, z <- soft(av); streamed Finito's
//     the same with invg by step), LFinito's against the epoch's anchor
//     point (av += (hat / N) sum + hat invg_k (z - zf), then the next
//     block's z <- soft(av) but after the call's last step), ProShI's
//     coupling (av += sum, z = (prox_g(av) - av) / hat), Point-SAGA's x-
//     and av-steps or SSNM's (x <- soft(x - eta (sum / B + gb), eta
//     lambda), gb += sum / N, zb_j <- y, then the next step's y from the
//     new x and the next block's stored point) to its columns,
//     their state loaded beside the partials; a second barrier before the
//     next step's point;
//   - ProShI's (N, n) table: each row's margin is taken at its own point
//     s_i + gamma_i z, so the row phase reads the table rows as well as A's.
//     A thread reads its units of a round of rows (eight a row group, two
//     or one where a thread owns 4 or 16 units) into registers with
//     coherent loads, takes its share of the margins from them, and after
//     the formula (w_i = (gamma_i / N) c_i) writes s_new = s_i + gamma_i z -
//     w_i a_i from the values it holds and adds s_new - s_old into its
//     column sums: each table value leaves device memory once and goes back
//     once, before the step's first barrier. The next round's loads are
//     issued before this round's work, within the step (its rows are
//     distinct), never across its barriers. gamma_i takes the anchor
//     coefficient's slot of the stage (the producer prefetches it: it is
//     only read). The margins are exact f32 at any storage, as the Pallas
//     kernel's;
//   - SAGA's, SSNM's, Finito's and Point-SAGA's table: the producer
//     prefetches no coefficient of their rows,
//     since a block revisited within the ring's lookahead (or overlapping an
//     earlier block: starts need not be block-aligned) would read it stale.
//     The formula thread of a row loads its old coefficient from L2 when its
//     stage is taken, after the barriers that end the previous step, and
//     writes the new one before the step's first barrier, so a revisit reads
//     the previous visit's value. Finito's anchor row zb_j and SSNM's stored
//     point zb_j are read and written by the finish alone (a column's owner
//     thread, the same every step; SSNM's step 0 point reads its block's
//     before the first barrier), the point by the next step: every value
//     written in the launch (c, zb, z, x, av) is read by coherent loads from
//     L2, never through the read-only path, which may return a line that an
//     earlier step of the launch wrote over;
//   - the two Katyushas' first x is formed by every CTA for all columns from
//     z, the anchor point and y, LFinito's first z = soft(av, hat lambda)
//     from the incoming av, Point-SAGA's first v = x - gamma av from the
//     iterate and av, and SSNM's first y from x and step 0's stored point
//     (each CTA writes its own finish columns of the point, so the finish
//     reads the point the margins used, and SSNM stores that very y as
//     zb_j: y is formed once a step, never twice, which the compiler might
//     contract in two ways; every CTA reads its inputs before its first
//     barrier, and the finishes write them only after it); the stop index
//     (L-SVRG, L-Katyusha) or clamp count (SAGA, SSNM, streamed Finito,
//     ProShI, Point-SAGA) is read once: a call processes min(K, stop + 1)
//     or min(K, f) steps and the masked ones write nothing.
//
// What it reaches on an H100 (tools/loopless_step_times.py, PERF.md): a step
// costs a floor of about 5 us whatever its rows (the two barriers, the finish
// and the point's copy: B = 128, one row a CTA), and each stage adds a serial
// chain of about 1 us (loads, FMAs, butterfly, barrier, formula, barrier,
// column pass: latency, with two warps a scheduler), so the headline stays
// well above its bytes. The deep target's step (one 64-row stage) takes
// 5.9-6.1 us f32 and 5.2 int8, 4.8 us less than with one row group. Two things that cost more, found on the way: the
// units past a row's width, compiled in and switched off, still took their
// instructions in every pass (hence the kRU tiers below), and two
// sequentially consistent fences around each barrier's add cost about 0.3 us
// (hence the release add and acquire polls).
//
// The grid-wide barrier is a word in device memory: each CTA adds 1 (CTA 0
// adds 2^31 - (G - 1)), and the top bit flips when the last one arrives, so the
// word's low bits are back at zero after every barrier (the scheme of
// cooperative_groups' grid sync). A call reads the top bit once at its start.
// The wrapper keeps one zeroed word for each (card, stream) and never resets
// it: calls on one stream run one after the other, and calls on two streams
// of one card, which may run at once, use two words. (A word a call, zeroed
// by a memset on the stream before each launch, cost 0.1-0.2 us a step at
// the engine's floor, B = 128 and K = 32, on an H100: PERF.md section 6.)

#pragma once

#include <atomic>

#include "row_ops.cuh"

namespace {

enum LooplessMethod {
  kLsvrgSteps = 0,
  kLKatyushaSteps = 1,
  kSvrgSteps = 2,
  kSagaSteps = 3,
  kKatyushaSteps = 4,
  kSarahSteps = 5,
  kFinitoSteps = 6,
  kLFinitoSteps = 7,
  kFinitoStreamSteps = 8,
  kProshiSteps = 9,
  kPointSagaSteps = 10,
  kSsnmSteps = 11
};

// ProShI's coupling prox (the scalars row's gmode): Zero (z = 0), IndBox
// (clip to [glo, ghi]), NormL1 (soft-threshold at glo = hat lambda).
enum GProx { kGproxZero = 0, kGproxBox = 1, kGproxL1 = 2 };

constexpr int kLlThreads = 256;              // the consumer warps' threads
constexpr int kLlWarps = kLlThreads / 32;
constexpr int kLlBlock = kLlThreads + 32;    // and one producer warp
constexpr int kLlMaxStages = 16;
constexpr int kLlMaxStageRows = 256;
// The widest rows (ops/fused_block.py MAX_COLS). A consumer thread owns kRU
// units of the rows' columns (four columns on the 16-byte path, one on the
// plain path) for the whole call, in registers: the build takes the fewest
// that cover the row (16-byte path 1, 4 or 16 units: n up to 1,024, 4,096
// and 16,384; plain path 4 or 64), since the units past the row still cost
// their instructions in every margin and column pass.
constexpr int kLlMaxCols = 16384;
constexpr size_t kLlMaxSmem = 232448;

// The scalars row's mode and aux slots of each method; the finish's scalars
// are the slots between the scale and the mode (ProShI reads its own where
// it uses them, to leave its widest builds the registers):
// L-SVRG, SVRG  [scale, gamma, gamma*lambda, 1/B, mode, aux];
// L-Katyusha    [scale, eta/L, tau*lambda, 1/(1 + eta*sigma), eta*sigma,
//                theta1, theta2, 1/B, mode, aux];
// SAGA          [scale, gamma, gamma*lambda, 1/B, 1/N, sag, mode, aux];
// Katyusha      [scale, alpha, beta, alpha*lambda, beta*lambda, 1/B, mode,
//                tau1, tau2, aux];
// SARAH         [scale, gamma, gamma*lambda, eta, 1/B, mode, aux];
// Finito (both) [scale, 1/N, hat, hat*lambda, mode, aux];
// LFinito       [scale, hat, hat*lambda, 1/N, mode, aux];
// ProShI        [scale, 1/N, 1/hat, mode, glo, ghi, gmode, aux];
// Point-SAGA    [scale, gamma, 1/B, 1/N, mode, aux] (its prox solve takes
//                the wrapper's mode, LooplessArgs::pmode, as the plain
//                version does, not the row's);
// SSNM          [scale, eta, eta*lambda, 1/B, 1/N, mode, tau, aux].
__host__ __device__ constexpr int mode_slot(int M) {
  return M == kLKatyushaSteps                        ? 8
         : (M == kSagaSteps || M == kKatyushaSteps) ? 6
         : (M == kSarahSteps || M == kSsnmSteps)     ? 5
         : M == kProshiSteps                         ? 3
                                                     : 4;
}
__host__ __device__ constexpr int aux_slot(int M) {
  return M == kKatyushaSteps                        ? 9
         : (M == kProshiSteps || M == kSsnmSteps) ? 7
                                                    : mode_slot(M) + 1;
}

// Whether the margins are taken at the coupled point x (the Katyushas), and
// the slot of its (t1, t2) pair: L-Katyusha's theta1, theta2, Katyusha's
// tau1, tau2; SSNM's tau.
__host__ __device__ constexpr bool coupled(int M) {
  return M == kLKatyushaSteps || M == kKatyushaSteps;
}
__host__ __device__ constexpr int tau_slot(int M) {
  return M == kKatyushaSteps ? 7 : M == kSsnmSteps ? 6 : 5;
}

// The (n,) points the margins are taken at: SARAH's w_prev and w, else one.
__host__ __device__ constexpr int ll_points(int M) {
  return M == kSarahSteps ? 2 : 1;
}

// Finito's coefficient steps: Σ 1/gamma by block id (#9) or by step (#14).
__host__ __device__ constexpr bool finito_coeff(int M) {
  return M == kFinitoSteps || M == kFinitoStreamSteps;
}

// Whether the call writes its coefficient table (SAGA, the Finitos,
// Point-SAGA, SSNM).
__host__ __device__ constexpr bool ll_table(int M) {
  return M == kSagaSteps || finito_coeff(M) || M == kPointSagaSteps ||
         M == kSsnmSteps;
}

// ProShI's rows a row group takes at once (a round): a thread holds its
// units' table values of them (kPR x kRU x kUnit floats: 32, and 64 for the
// widest builds of one row) from its margins to its column pass.
__host__ __device__ constexpr int proshi_rows(bool vec, int ru, bool split) {
  return split ? 8
         : vec ? (ru >= 16 ? 1 : ru >= 4 ? 2 : 8)
               : (ru >= 64 ? 1 : 8);
}

// Whether every CTA forms step 0's point inside the launch: the Katyushas'
// x, LFinito's z = soft(av), Point-SAGA's v = x - gamma av and SSNM's y =
// tau x + (1 - tau) zb_j.
__host__ __device__ constexpr bool forms_point(int M) {
  return coupled(M) || M == kLFinitoSteps || M == kPointSagaSteps ||
         M == kSsnmSteps;
}

// The arguments of one call. L-SVRG: pt the iterate w, pre = wpre, c the
// anchor coefficients; L-Katyusha: pt the (n,) scratch of the coupled point
// x, y and z the sequences, wa the anchor point, pre = ypre; SVRG: pt the
// iterate w, zs the running sum; SAGA: pt the iterate z, c the table, av
// the running average (written), stop the clamp count f, wgts the steps'
// direction weights (or NULL); Katyusha: pt the (n,) scratch of x, y and z
// the sequences, wa the anchor point, zs the running sum of y; SARAH: pt
// the (2, n) pair [w_prev; w], av the estimator v (written), c NULL;
// Finito: pt the iterate z, c the table, av the running average, zb the
// (d, n) per-block anchors (all written), invg the blocks' sums of
// 1/gamma_i by block id (streamed Finito: by step, and stop its clamp count
// f); LFinito: pt the (n,) output z (the margins' point, then the last
// block's prox point), c the epoch's anchor coefficients, av the running
// average (written), wa the anchor point z_full, invg the visited blocks'
// sums of 1/gamma_i in visit order; ProShI: pt the point z, av the coupling
// sum, s the (N, n) table (all written), c the stepsizes gamma_i (read
// only, in the anchor coefficients' slot), stop the clamp count f;
// Point-SAGA: pt the (n,) scratch of the shifted iterate v, z the iterate
// x, av the table mean, c the table (all written), na the row square-norms
// (read only, in the anchor coefficients' slot), pmode the oracle formula
// of its prox solve, stop the clamp count f; SSNM: pt the (n,) scratch of
// the momentum point y, z the iterate x, av the table mean gb, c the table,
// zb the (d, n) stored points (all written), stop the clamp count f. av is
// read only but for SAGA, SARAH, the Finitos, ProShI, Point-SAGA and SSNM,
// c but for SAGA, the Finitos, Point-SAGA and SSNM; stop and pre are NULL
// but for L-SVRG, L-Katyusha (and the clamp counts of SAGA, streamed
// Finito, ProShI, Point-SAGA and SSNM).
// part: (ctas, n) f32 scratch; bar: the grid barrier's word of the call's
// stream (low bits zero between calls).
struct LooplessArgs {
  const void* A;
  const float* b;
  const float* rs;
  float* c;
  const int* starts;
  const int* stop;
  float* pt;
  float* pre;
  float* av;
  const float* sc;
  float* y;
  float* z;
  const float* wa;
  float* part;
  unsigned* bar;
  int n, B, rows, ctas, stage_rows, stages, K;
  float* zs = nullptr;
  const float* wgts = nullptr;
  float* zb = nullptr;
  const float* invg = nullptr;
  float* s = nullptr;
  const float* na = nullptr;
  int pmode = 0;
};

// The grid rule (ops/fused_block.py _loopless_grid): R rows a CTA, the
// smallest power of two with ceil(B / R) <= sms, and ceil(B / R) CTAs.
inline void loopless_grid(int B, int sms, int& rows, int& ctas) {
  rows = 1;
  while ((B + rows - 1) / rows > sms) rows *= 2;
  ctas = (B + rows - 1) / rows;
}

// The row groups of the consumer threads for rows of `units` column units:
// groups of U threads, U the units rounded up to a power of two, at least a
// warp and at most all 256 threads.
__host__ __device__ __forceinline__ int loopless_groups(int units) {
  int U = 32;
  while (U < units && U < kLlThreads) U *= 2;
  return kLlThreads / U;
}

// f32 values of the groups' column sums: g rows of n where the 16-byte
// path's units (the most groups) give g > 1.
__host__ __device__ __forceinline__ int group_floats(int n) {
  const int g = loopless_groups((n + 3) / 4);
  return g > 1 ? g * n : 0;
}

// Shared memory of a CTA (ops/fused_block.py _loopless_smem_bytes): the
// ring, the `pts` points, the groups' column sums, the stages' full and
// empty barriers, then b, the anchor coefficients and rs of each stage's
// rows, dc of two stages, the warps' margin sums of a stage's rows (one set
// a point) and the finish's 256 warp sums.
__host__ __device__ __forceinline__ size_t loopless_smem_bytes(int S, int P,
                                                              int n,
                                                              int itemsize,
                                                              int pts) {
  return P * tile_bytes(S, n, itemsize) + tile_bytes(pts, n, 4) +
         tile_bytes(group_floats(n), 1, 4) + 16 * size_t(P) +
         4 * (3 * size_t(P) * S + (2 + pts * kLlWarps) * size_t(S) +
              kLlThreads);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kLlThreads) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on the barrier once this thread's earlier cp.async copies have
// landed (counted in the barrier's arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA's consumer threads wait here until all CTAs have arrived; their
// writes before it are seen by every CTA's reads after it (cutlass/barrier.h's
// scheme: the CTA's barrier, then thread 0's release add; thread 0's acquire
// polls, then the CTA's barrier). `phase` (thread 0's) is the word's top bit
// before the barrier; it flips when the last CTA arrives.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& phase) {
  consumer_sync();
  if (threadIdx.x == 0) {
    phase ^= 0x80000000u;
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar),
                 "r"(inc)
                 : "memory");
    while ((load_acquire(bar) & 0x80000000u) != phase) {
    }
  }
  consumer_sync();
}

// The values of a column unit of one row in shared memory as the dots see
// them: four on the 16-byte path, one otherwise.
template <bool kLowp, bool kVec>
__device__ __forceinline__ void ll_unit(const float* p, float (&v)[4]) {
  if (kVec) {
    float4 x = *reinterpret_cast<const float4*>(p);
    if (kLowp) x = round4_bf16(x);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = row_value<kLowp>(*p);
  }
}
template <bool kLowp, bool kVec>
__device__ __forceinline__ void ll_unit(const __nv_bfloat16* p,
                                        float (&v)[4]) {
  if (kVec) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    widen2_bf16(x.x, v);
    widen2_bf16(x.y, v + 2);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <bool kLowp, bool kVec>
__device__ __forceinline__ void ll_unit(const int8_t* p, float (&v)[4]) {
  if (kVec)
    widen4_i8(*reinterpret_cast<const unsigned*>(p), v);
  else
    v[0] = static_cast<float>(*p);
}

// Asks L2 for the lines of [p, p + bytes), split over the consumer threads:
// a hint that moves no value into the SM (a later coherent load sees every
// write made since), so it may run ahead of the grid barriers.
__device__ __forceinline__ void l2_warm(const float* p, int64_t bytes,
                                        int tid) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127);
  const uintptr_t end = reinterpret_cast<uintptr_t>(p) + bytes;
  for (uintptr_t q = first + 128 * uintptr_t(tid); q < end;
       q += 128 * uintptr_t(kLlThreads))
    asm volatile("prefetch.global.L2 [%0];" ::"l"(q));
}

// ProShI's table values of a thread: its units loc + kq U of the table rows
// row, row + 1, ... (rows of them; zeros past them and past the row's units),
// read by coherent loads (the launch writes the table).
template <bool kVec, int kPR, int kRU, int kUnit>
__device__ __forceinline__ void proshi_load(float (&so)[kPR][kRU][kUnit],
                                            const float* s, int64_t row,
                                            int rows, int n, int loc, int U,
                                            int units) {
#pragma unroll
  for (int i = 0; i < kPR; ++i)
#pragma unroll
    for (int kq = 0; kq < kRU; ++kq) {
      const int u = loc + kq * U;
#pragma unroll
      for (int e = 0; e < kUnit; ++e) so[i][kq][e] = 0.0f;
      if (i < rows && u < units) {
        const float* src = s + (row + i) * n + u * kUnit;
        if constexpr (kVec) {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(src));
          so[i][kq][0] = f.x, so[i][kq][1] = f.y;
          so[i][kq][2] = f.z, so[i][kq][3] = f.w;
        } else {
          so[i][kq][0] = __ldcg(src);
        }
      }
    }
}

// The sums over a warp of each lane's partials p[0..7] of eight rows: three
// halving steps (lane offsets 16, 8, 4), in each of which a lane keeps half of
// its rows and sends its partner the other half, then two plain steps (2, 1):
// lane l ends with the warp's sum of row l / 4, in a fixed order (nine
// shuffles for eight rows, where a tree a row takes forty).
__device__ __forceinline__ float warp_sums8(float (&p)[8], int lane) {
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1) {
    const int off = 4 * m;
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = up ? p[i] : p[i + m];
      const float keep = up ? p[i + m] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  p[0] += __shfl_xor_sync(0xffffffffu, p[0], 2);
  p[0] += __shfl_xor_sync(0xffffffffu, p[0], 1);
  return p[0];
}

template <int M, typename T, bool kLowp, bool kVec, int kRU, bool kSplit>
__global__ void __launch_bounds__(kLlBlock, 1)
loopless_steps_kernel(const LooplessArgs a) {
  constexpr int kUnit = kVec ? 4 : 1;  // columns of a unit
  constexpr int kRegUnits = kRU;
  constexpr bool kTable = ll_table(M);  // the call writes its table
  // the producer loads the rows' anchor coefficients (SARAH has none) or
  // Point-SAGA's square-norms
  constexpr bool kAnchor =
      M == kPointSagaSteps || (!kTable && M != kSarahSteps);
  const float* anchor = M == kPointSagaSteps ? a.na : a.c;
  constexpr int kPts = ll_points(M);
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n, S = a.stage_rows, P = a.stages;
  const size_t tb = tile_bytes(S, n, sizeof(T));
  auto stage_ptr = [&](int s) { return reinterpret_cast<T*>(smem + s * tb); };
  float* zs = reinterpret_cast<float*>(smem + P * tb);  // [kPts][n]
  float* gsum =
      reinterpret_cast<float*>(smem + P * tb + tile_bytes(kPts, n, 4));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + P * tb + tile_bytes(kPts, n, 4) +
      tile_bytes(group_floats(n), 1, 4));
  uint64_t* empty = full + P;
  float* vals = reinterpret_cast<float*>(empty + P);  // [P][b, c, rs][S]
  float* dcs = vals + 3 * P * S;                      // [2][S]
  float* msum = dcs + 2 * S;                          // [kPts][8][S]
  float* red = msum + kPts * kLlWarps * S;            // [8][32]

  const int K = a.K;
  const int live = a.stop == nullptr                ? K
                   : kTable || M == kProshiSteps ? max(0, min(K, *a.stop))
                   : *a.stop >= K - 1 ? K
                   : (*a.stop < 0 ? 0 : *a.stop + 1);
  if (live == 0) return;
  const int G = gridDim.x;
  const int cta = blockIdx.x;
  const int first = cta * a.rows;  // the CTA's first row of a block
  const int mine = min(a.rows, a.B - first);
  const int spc = (mine + S - 1) / S;  // stages a step
  const int total = live * spc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row_bytes = static_cast<size_t>(n) * sizeof(T);
  const T* A = static_cast<const T*>(a.A);

  if (tid == 0) {
    for (int s = 0; s < P; ++s) {
      // the producer's 32 lanes each arrive once a stage (and, on the 16-byte
      // path, lane 0 once more with the bulk copy's bytes)
      mbar_init(&full[s], kVec ? 33 : 32);
      mbar_init(&empty[s], kLlWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kLlWarps) {
    // the producer: stage t holds rows [i S, i S + here) of the CTA's share
    // of step k's block, k = t / spc, i = t % spc (SAGA's, SSNM's,
    // Finito's and Point-SAGA's table is not prefetched: its consumers read
    // it; SARAH has none)
    for (int t = 0; t < total; ++t) {
      const int s = t % P;
      if (t >= P) mbar_wait(&empty[s], (t / P - 1) & 1);
      const int k = t / spc, i = t % spc;
      const int64_t r0 = static_cast<int64_t>(a.starts[k]) + first + i * S;
      const int here = min(S, mine - i * S);
      T* dst = stage_ptr(s);
      float* v = vals + 3 * S * s;
      if (kVec) {
        if (lane == 0)
          bulk_load(dst, A + r0 * n, static_cast<unsigned>(here * row_bytes),
                    &full[s]);
        for (int r = lane; r < here; r += 32) {
          __pipeline_memcpy_async(v + r, a.b + r0 + r, 4);
          if (kAnchor)
            __pipeline_memcpy_async(v + S + r, anchor + r0 + r, 4);
          if (a.rs != nullptr)
            __pipeline_memcpy_async(v + 2 * S + r, a.rs + r0 + r, 4);
        }
        cp_async_arrive(&full[s]);
      } else {
        const T* src = A + r0 * n;
        for (int j = lane; j < here * n; j += 32) dst[j] = src[j];
        for (int r = lane; r < here; r += 32) {
          v[r] = a.b[r0 + r];
          if (kAnchor) v[S + r] = anchor[r0 + r];
          v[2 * S + r] = a.rs != nullptr ? a.rs[r0 + r] : 1.0f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumers
  const float* sc = a.sc;
  const float scale = sc[0];
  const int mode =
      M == kPointSagaSteps ? a.pmode : static_cast<int>(sc[mode_slot(M)]);
  const float aux = sc[aux_slot(M)];
  const bool scaled = a.rs != nullptr;
  // the finish's scalars, the row's slots between the scale and the mode
  float fs[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) fs[q] = q < mode_slot(M) - 1 ? sc[1 + q] : 0.0f;
  const int units = n / kUnit;
  // the row groups (kSplit builds, rows of at most 128 units): U threads a
  // group own units loc + kq U of its rows; otherwise one group of all
  const int groups = kSplit ? loopless_groups(units) : 1;
  const int U = kLlThreads / groups;
  const int grp = kSplit ? tid / U : 0;
  const int loc = kSplit ? tid % U : tid;
  const int wpg = U / 32;  // warps a group
  // the finish: CTA c's columns [j0, j1) in blocks of cw columns, lpc lanes
  // a column, 8 lpc slices of the G partials a column
  const int cpc = (n + G - 1) / G;
  const int j0 = min(n, cta * cpc);
  const int j1 = min(n, j0 + cpc);
  int cw = 1;
  while (cw < cpc && cw < 32) cw *= 2;
  const int lpc = 32 / cw;
  const int fcol = lane % cw;
  const int slice = warp * lpc + lane / cw;
  const int slices = kLlWarps * lpc;

  float acc[kRegUnits][kUnit];
#pragma unroll
  for (int kq = 0; kq < kRegUnits; ++kq)
#pragma unroll
    for (int q = 0; q < kUnit; ++q) acc[kq][q] = 0.0f;

  // row r of a stage whose rows start at row0: its margin m (SARAH's at w,
  // m0 at w_prev), its old table coefficient c_old (loaded when the stage
  // or step was taken); ProShI's dc is w_i = (gamma_i / N) c_i (rs_i), the
  // weight of the row in its table refresh; Point-SAGA's c_i is its prox
  // solve theta_i at the margin m + gamma c_old |a_i|^2 of the row's prox
  // point, and dc = c_old - theta_i
  auto finish_row = [&](const float* v, float* dc, int r, float m, float m0,
                        int64_t row0, float c_old) {
    const float rsv = scaled ? v[2 * S + r] : 1.0f;
    if (scaled) m *= rsv;
    const float c_live =
        M == kProshiSteps
            ? coeff_formula(static_cast<int>(sc[3]), m, v[r], sc[0], sc[7])
        : M == kPointSagaSteps
            ? pointprox_theta_of(mode, m + sc[1] * c_old * v[S + r], v[r],
                                 v[S + r], c_old, scale, sc[1], aux)
            : coeff_formula(mode, m, v[r], scale, aux);
    float d;
    if constexpr (kTable) {
      a.c[row0 + r] = c_live;
      d = M == kPointSagaSteps ? c_old - c_live : c_live - c_old;
    } else if constexpr (M == kSarahSteps) {
      // grad f_i(w) - grad f_i(w_prev)
      if (scaled) m0 *= rsv;
      d = c_live - coeff_formula(mode, m0, v[r], scale, aux);
    } else if constexpr (M == kProshiSteps) {
      d = (v[S + r] * sc[1]) * c_live;
    } else {
      d = coupled(M) ? c_live - v[S + r] : v[S + r] - c_live;
    }
    if (scaled) d *= rsv;
    dc[r] = kLowp ? bf16_round(d) : d;
  };

  // the barrier word's top bit before this call's first barrier (no CTA can
  // open it before this one arrives)
  unsigned phase = tid == 0 ? load_acquire(a.bar) & 0x80000000u : 0u;
  // SSNM's stored point of step 0's block, which step 0's y takes
  const float* zb0 =
      M == kSsnmSteps ? a.zb + static_cast<int64_t>(a.starts[0] / a.B) * n
                      : nullptr;
  int t = 0;
  for (int k = 0; k < live; ++k) {
    // SSNM: the blocks of steps k and k + 1, read at the step's start, so
    // that the finish's load of the next stored point does not wait behind
    // a read of starts (0.2-0.3 us a step on an H100)
    const int blk = M == kSsnmSteps ? a.starts[k] / a.B : 0;
    const int blk_next =
        M == kSsnmSteps && k + 1 < live ? a.starts[k + 1] / a.B : blk;
    // step k's point: w, z, x, v, y (at k = 0 formed here, the Katyushas' x
    // from z, wa and y, LFinito's z from av, Point-SAGA's v from x and av,
    // SSNM's y from x and zb_j; each CTA writes its own finish columns of
    // the point), or SARAH's w_prev and w, one after the other
    auto point = [&](int j) {
      if (forms_point(M) && k == 0) {
        float x;
        if constexpr (coupled(M))
          x = coupled_point(sc[tau_slot(M)], sc[tau_slot(M) + 1],
                            __ldcg(a.z + j), a.wa[j], __ldcg(a.y + j));
        else if constexpr (M == kPointSagaSteps)
          x = shifted_point(fs[0], __ldcg(a.z + j), __ldcg(a.av + j));
        else if constexpr (M == kSsnmSteps)
          x = momentum_point(sc[tau_slot(M)], __ldcg(a.z + j),
                             __ldcg(zb0 + j));
        else
          x = soft_threshold(__ldcg(a.av + j), fs[1]);
        if (j >= j0 && j < j1) a.pt[j] = x;
        return x;
      }
      return __ldcg(a.pt + j);
    };
    if (kVec) {
#pragma unroll 4
      for (int j = tid * 4; j < kPts * n; j += kLlThreads * 4) {
        float x[4];
        if (forms_point(M) && k == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) x[q] = point(j + q);
        } else {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(a.pt + j));
          x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
        }
        float4 o;
        o.x = kLowp ? bf16_round(x[0]) : x[0];
        o.y = kLowp ? bf16_round(x[1]) : x[1];
        o.z = kLowp ? bf16_round(x[2]) : x[2];
        o.w = kLowp ? bf16_round(x[3]) : x[3];
        *reinterpret_cast<float4*>(zs + j) = o;
      }
    } else {
#pragma unroll 4
      for (int j = tid; j < kPts * n; j += kLlThreads) {
        const float x = point(j);
        zs[j] = kLowp ? bf16_round(x) : x;
      }
    }
    consumer_sync();

    if constexpr (M == kProshiSteps) {
      // ProShI (ProShI_basic.jl:111-123): each row at its own point s_i +
      // gamma_i z, its table row read once, into registers, and written
      // back. The step's rows go in rounds of RR rows (a group's kPR at
      // once, every group's in turn), each round inside one stage: a
      // thread loads its units of the round's table rows by coherent loads
      // (a block revisited by a later step of the launch reads this step's
      // writes), takes its share of m_i = a_i . (s_i + gamma_i z), and after
      // the formula writes s_new = (s_i + gamma_i z) - w_i a_i and adds s_new
      // - s_old into its column sums. The rows of a step are distinct, so the
      // next round's loads are issued before this round's work (where a
      // thread holds 32 values a round, the 16-byte path's narrower rows);
      // never across the step's barriers. L2 is asked for the rows two
      // rounds ahead, across the barriers too: a hint, not a read.
      constexpr int kPR = proshi_rows(kVec, kRU, kSplit);
      constexpr int kSlots = kPR * kRegUnits * kUnit <= 32 ? 2 : 1;
      const int RR = min(S, kPR * groups);
      const int rounds = (mine + RR - 1) / RR;
      const int64_t base = static_cast<int64_t>(a.starts[k]) + first;
      // the thread's table values of a round in flight or in use, a slot a
      // round (two where they fit: the next round's load ahead)
      float sv[kSlots][kPR][kRegUnits][kUnit];
      // the thread's rows of round j: j RR + grp kPR + i of the CTA's share,
      // while below the round's end
      auto first_row = [&](int j) { return j * RR + grp * kPR; };
      auto rows_of = [&](int j) {
        return min(j * RR + RR, mine) - first_row(j);
      };
      // round g of the call counted from this step's first: its rows asked
      // of L2 kWarm rounds ahead, this step's or the next's (the register
      // loads, a round ahead, do not cover the bytes' latency alone; three
      // rounds ahead was slower than none on an H100, two the fastest)
      constexpr int kWarm = 2;
      auto warm = [&](int g) {
        const int kk = k + g / rounds, jj = g % rounds;
        if (kk < live)
          l2_warm(a.s + (static_cast<int64_t>(a.starts[kk]) + first +
                         jj * RR) * n,
                  static_cast<int64_t>(min(RR, mine - jj * RR)) * n * 4, tid);
      };
      if (k == 0)
        for (int g = 0; g < kWarm; ++g) warm(g);
      if (kSlots == 2)
        proshi_load<kVec>(sv[0], a.s, base + first_row(0), rows_of(0), n, loc,
                          U, units);
      for (int j0 = 0; j0 < rounds; j0 += kSlots) {
#pragma unroll
        for (int h = 0; h < kSlots; ++h) {
          const int j = j0 + h;
          if (j >= rounds) break;
          const int jl = kSlots == 1 ? j : j + 1;  // the round loaded now
          if (jl < rounds)
            proshi_load<kVec>(sv[kSlots == 1 ? 0 : 1 - h], a.s,
                              base + first_row(jl), rows_of(jl), n, loc, U,
                              units);
          warm(j + kWarm);
          const int ist = j * RR / S;  // the round's stage of the step
          const int lr0 = j * RR - ist * S;
          const int ts = t + ist;
          const int s = ts % P;
          const int here = min(S, mine - ist * S);
          const int rend = min(lr0 + RR, here);
          const int rb = lr0 + grp * kPR;  // the thread's first row, in stage
          const T* tile = stage_ptr(s);
          const float* v = vals + 3 * S * s;
          float* dc = dcs + (ts & 1) * S;
          if (lr0 == 0) mbar_wait(&full[s], (ts / P) & 1);
          float p[8] = {};
#pragma unroll
          for (int kq = 0; kq < kRegUnits; ++kq) {
            const int u = loc + kq * U;
            if (u < units) {
              float z[4];
              ll_unit<false, kVec>(zs + u * kUnit, z);
#pragma unroll
              for (int i = 0; i < kPR; ++i) {
                if (rb + i < rend) {
                  float x[4];
                  ll_unit<false, kVec>(
                      tile + static_cast<size_t>(rb + i) * n + u * kUnit, x);
                  const float g = v[S + rb + i];
#pragma unroll
                  for (int e = 0; e < kUnit; ++e)
                    p[i] = fmaf(x[e], sv[h][i][kq][e] + g * z[e], p[i]);
                }
              }
            }
          }
          const float m = warp_sums8(p, lane);
          if ((lane & 3) == 0 && lane / 4 < kPR && rb + lane / 4 < rend)
            msum[warp * S + rb + lane / 4] = m;
          consumer_sync();
          if (tid < rend - lr0) {
            const int w0 = (tid / kPR) * wpg;  // the row's group
            float mm = msum[w0 * S + lr0 + tid];
            for (int w = 1; w < wpg; ++w) mm += msum[(w0 + w) * S + lr0 + tid];
            finish_row(v, dc, lr0 + tid, mm, mm, 0, 0.0f);
          }
          consumer_sync();
#pragma unroll
          for (int i = 0; i < kPR; ++i) {
            if (rb + i < rend) {
              const float w = dc[rb + i];
              const float g = v[S + rb + i];
              float* srow = a.s + (base + ist * S + rb + i) * n;
#pragma unroll
              for (int kq = 0; kq < kRegUnits; ++kq) {
                const int u = loc + kq * U;
                if (u < units) {
                  float x[4], z[4], sn[4];
                  ll_unit<false, kVec>(
                      tile + static_cast<size_t>(rb + i) * n + u * kUnit, x);
                  ll_unit<false, kVec>(zs + u * kUnit, z);
#pragma unroll
                  for (int e = 0; e < kUnit; ++e) {
                    const float so = sv[h][i][kq][e];
                    sn[e] = (so + g * z[e]) - w * x[e];
                    acc[kq][e] += sn[e] - so;
                  }
                  if constexpr (kVec)
                    *reinterpret_cast<float4*>(srow + u * kUnit) =
                        make_float4(sn[0], sn[1], sn[2], sn[3]);
                  else
                    srow[u] = sn[0];
                }
              }
            }
          }
          if (rend == here) {
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
          }
        }
      }
      t += spc;
    } else {
      // margins: every thread takes its units' share (the units it owns in
      // the column sums) of its group's rows of a stage, eight rows at once
      // (SARAH: each loaded unit into the sums of both points); warp_sums8
      // leaves lane 4i the warp's sum of row i
      auto stage_margins = [&](const T* tile, int here, float* ms) {
        for (int r0 = 8 * grp; r0 < here; r0 += 8 * groups) {
          float p[kPts][8] = {};
          const bool whole = here - r0 >= 8;
#pragma unroll
          for (int kq = 0; kq < kRegUnits; ++kq) {
            const int u = loc + kq * U;
            if (u < units) {
              float z[kPts][4];
#pragma unroll
              for (int q = 0; q < kPts; ++q) {
                if (kVec) {
                  const float4 f =
                      *reinterpret_cast<const float4*>(zs + q * n + 4 * u);
                  z[q][0] = f.x, z[q][1] = f.y, z[q][2] = f.z, z[q][3] = f.w;
                } else {
                  z[q][0] = zs[q * n + u];
                }
              }
              const T* col = tile + static_cast<size_t>(r0) * n + u * kUnit;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                if (whole || r0 + i < here) {
                  float x[4];
                  ll_unit<kLowp, kVec>(col + static_cast<size_t>(i) * n, x);
#pragma unroll
                  for (int q = 0; q < kPts; ++q)
#pragma unroll
                    for (int e = 0; e < kUnit; ++e)
                      p[q][i] = fmaf(x[e], z[q][e], p[q][i]);
                }
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kPts; ++q) {
            const float m = warp_sums8(p[q], lane);
            if ((lane & 3) == 0 && r0 + lane / 4 < here)
              ms[(q * kLlWarps + warp) * S + r0 + lane / 4] = m;
          }
        }
      };
      // row r's margins from the warps' sums of its group in ms, added in
      // warp order
      auto row_margins = [&](const float* ms, int r, float (&m)[kPts]) {
        const int w0 = ((r >> 3) % groups) * wpg;  // the row's group
#pragma unroll
        for (int q = 0; q < kPts; ++q) {
          const float* mq = ms + q * kLlWarps * S;
          m[q] = mq[w0 * S + r];
#pragma unroll
          for (int w = 1; w < wpg; ++w) m[q] += mq[(w0 + w) * S + r];
        }
      };
      // the group's rows of a stage into the column sums, weighted by dc:
      // each unit's rows in order (a group's octets, or all rows at once),
      // four rows' loads at once; then the stage is released
      auto stage_sums = [&](const T* tile, int here, const float* dc, int s) {
#pragma unroll
        for (int kq = 0; kq < kRegUnits; ++kq) {
          const int u = loc + kq * U;
          if (u < units) {
            const T* col = tile + u * kUnit;
            for (int o = 8 * grp; o < here; o += kSplit ? 8 * groups : here) {
              const int end = kSplit ? min(here, o + 8) : here;
              int r = o;
              for (; r + 4 <= end; r += 4) {
                float x[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  ll_unit<kLowp, kVec>(col + static_cast<size_t>(r + i) * n,
                                       x[i]);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float d = dc[r + i];
#pragma unroll
                  for (int q = 0; q < kUnit; ++q) acc[kq][q] += d * x[i][q];
                }
              }
              for (; r < end; ++r) {
                float x[4];
                ll_unit<kLowp, kVec>(col + static_cast<size_t>(r) * n, x);
                const float d = dc[r];
#pragma unroll
                for (int q = 0; q < kUnit; ++q) acc[kq][q] += d * x[q];
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
      };
      // Point-SAGA's logistic and Poisson rows, where a step has two stages
      // or more and fits: every stage's margins (thread j keeping row j's of
      // the CTA's share; the stages' margin sums alternate between msum and
      // red, free until the finish, so one barrier a stage keeps a stage's
      // sums until they are read), then the Newton solves of all its rows at
      // once, their dc in the buffer the last stage did not use, then the
      // column sums stage by stage: one chain a step, not one a stage. The
      // step fits where its stages are in the ring at once, a thread takes a
      // row, msum or red holds their dc and red a stage's margin sums (with
      // one stage, the stage loop below solves the step's rows at once
      // already). Built only for rows of up to four units a thread (n <=
      // 4,096 on the 16-byte path, 1,024 on the plain one), the main path's
      // widths: in every build it made the file's compile 2.3 times as long
      bool stepped = false;
      if constexpr (M == kPointSagaSteps && kRU <= 4) {
        if ((mode == kLogistic || mode == kPoisson) && spc >= 2 &&
            spc <= P && spc <= kLlWarps && mine <= kLlThreads &&
            kLlWarps * S <= kLlThreads) {
          const int64_t base = static_cast<int64_t>(a.starts[k]) + first;
          const float c_old = tid < mine ? __ldcg(a.c + base + tid) : 0.0f;
          float m[kPts] = {};
          for (int i = 0; i < spc; ++i) {
            const int ts = t + i;
            const int here = min(S, mine - i * S);
            float* ms = i & 1 ? red : msum;
            mbar_wait(&full[ts % P], (ts / P) & 1);
            stage_margins(stage_ptr(ts % P), here, ms);
            consumer_sync();
            if (tid >= i * S && tid < i * S + here)
              row_margins(ms, tid - i * S, m);
          }
          float* dc = spc & 1 ? red : msum;
          if (tid < mine) {
            const int i = tid / S;
            finish_row(vals + 3 * S * ((t + i) % P), dc + i * S, tid - i * S,
                       m[0], m[0], base + i * S, c_old);
          }
          consumer_sync();
          for (int i = 0; i < spc; ++i, ++t)
            stage_sums(stage_ptr(t % P), min(S, mine - i * S), dc + i * S,
                       t % P);
          stepped = true;
        }
      }
      // a stage at a time: its margins, its rows' formula, its column sums
      if (!stepped) {
        for (int i = 0; i < spc; ++i, ++t) {
          const int s = t % P;
          const int here = min(S, mine - i * S);
          const T* tile = stage_ptr(s);
          const float* v = vals + 3 * S * s;
          float* dc = dcs + (t & 1) * S;
          // a table: the stage's first row, and the row's old coefficient from
          // L2, in flight during the margins (every earlier visit's write is
          // behind the barriers)
          const int64_t row0 =
              kTable ? static_cast<int64_t>(a.starts[k]) + first + i * S : 0;
          const float c_old =
              kTable && tid < here ? __ldcg(a.c + row0 + tid) : 0.0f;
          mbar_wait(&full[s], (t / P) & 1);
          stage_margins(tile, here, msum);
          consumer_sync();
          if (tid < here) {
            float m[kPts];
            row_margins(msum, tid, m);
            finish_row(v, dc, tid, m[kPts - 1], m[0], row0, c_old);
          }
          consumer_sync();
          stage_sums(tile, here, dc, s);
        }
      }
    }

    // the CTA's partial (the groups' sums added in group order), then the
    // finish of its columns
    float* out = a.part + static_cast<int64_t>(cta) * n;
    float* sums = groups == 1 ? out : gsum + grp * n;
#pragma unroll
    for (int kq = 0; kq < kRegUnits; ++kq) {
      const int u = loc + kq * U;
      if (u < units) {
        if (kVec)
          *reinterpret_cast<float4*>(sums + 4 * u) =
              make_float4(acc[kq][0], acc[kq][1], acc[kq][2], acc[kq][3]);
        else
          sums[u] = acc[kq][0];
      }
#pragma unroll
      for (int q = 0; q < kUnit; ++q) acc[kq][q] = 0.0f;
    }
    if (groups > 1) {
      consumer_sync();
      for (int j = tid; j < units * kUnit; j += kLlThreads) {
        float sum = gsum[j];
        for (int g = 1; g < groups; ++g) sum += gsum[g * n + j];
        out[j] = sum;
      }
    }
    grid_sync(a.bar, phase);

    // SAGA's direction weight of step k; the Finitos' sum of 1/gamma_i of
    // step k's block (Finito's by block id, streamed Finito's by step,
    // LFinito's by visit); Finito's anchor row or SSNM's stored point of
    // that block, and SSNM's of step k + 1's block
    const float wgt =
        M == kSagaSteps && a.wgts != nullptr ? a.wgts[k] : 1.0f;
    const float ig = M == kFinitoSteps ? a.invg[a.starts[k] / a.B]
                     : M == kLFinitoSteps || M == kFinitoStreamSteps
                         ? a.invg[k]
                         : 0.0f;
    float* zb_row =
        finito_coeff(M)   ? a.zb + static_cast<int64_t>(a.starts[k] / a.B) * n
        : M == kSsnmSteps ? a.zb + static_cast<int64_t>(blk) * n
                          : nullptr;
    const float* zb_next =
        M == kSsnmSteps ? a.zb + static_cast<int64_t>(blk_next) * n : nullptr;
    for (int jb = j0; jb < j1; jb += cw) {
      const int j = jb + fcol;
      const bool owner = warp == 0 && lane < cw && j < j1;
      // the column's state (L-SVRG: w, av; SVRG: w, av, zs; SAGA: z, av;
      // L-Katyusha: x, av, z, y, wa; Katyusha: x, av, z, y, wa, ys; SARAH:
      // w, v; Finito: z, av, zb_j; LFinito: z, av, zf; ProShI: z, av;
      // Point-SAGA: v, av; SSNM: y, gb, x and column j of step k + 1's
      // stored point),
      // loaded beside its partials
      float st[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (owner) {
        st[0] = __ldcg(a.pt + (M == kSarahSteps ? n : 0) + j);
        st[1] = kTable || M == kSarahSteps || M == kLFinitoSteps ||
                        M == kProshiSteps
                    ? __ldcg(a.av + j)
                    : a.av[j];
        if (coupled(M)) {
          st[2] = __ldcg(a.z + j);
          st[3] = __ldcg(a.y + j);
          st[4] = a.wa[j];
        }
        if (M == kSvrgSteps) st[2] = __ldcg(a.zs + j);
        if (M == kKatyushaSteps) st[5] = __ldcg(a.zs + j);
        if (finito_coeff(M)) st[2] = __ldcg(zb_row + j);
        if (M == kSsnmSteps) {
          st[2] = __ldcg(a.z + j);
          st[3] = __ldcg(zb_next + j);
        }
        if (M == kLFinitoSteps) st[2] = a.wa[j];
      }
      float sum = 0.0f;
      if (j < j1) {
#pragma unroll 4
        for (int q = slice; q < G; q += slices)
          sum += __ldcg(a.part + static_cast<int64_t>(q) * n + j);
      }
      for (int off = cw; off < 32; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < cw) red[warp * 32 + lane] = sum;
      consumer_sync();
      if (owner) {
        float innov = red[lane];
#pragma unroll
        for (int w = 1; w < kLlWarps; ++w) innov += red[w * 32 + lane];
        if (M == kLsvrgSteps || M == kSvrgSteps) {
          // L-SVRG (Kovalev et al. 2020, Alg. 2): wpre <- w,
          // w <- soft(w + gamma (sum / B - av), gamma lambda); SVRG
          // (SVRG_basic.jl:74-81) the same w-step and zs += w
          const float w_new =
              soft_threshold(st[0] + fs[0] * (innov * fs[2] - st[1]), fs[1]);
          if (M == kLsvrgSteps)
            a.pre[j] = st[0];
          else
            a.zs[j] = st[2] + w_new;
          a.pt[j] = w_new;
        } else if (M == kSagaSteps) {
          // SAGA/SAG: av_new = av + sum / N; SAG steps from av_new, SAGA
          // from sum wgt / B + av (the weight scales the direction only)
          const float av_new = st[1] + innov * fs[3];
          const float w = fs[4] > 0.0f
                              ? st[0] - fs[0] * av_new
                              : st[0] - fs[0] * (innov * (wgt * fs[2]) + st[1]);
          a.av[j] = av_new;
          a.pt[j] = soft_threshold(w, fs[1]);
        } else if (M == kKatyushaSteps) {
          // Katyusha (Allen-Zhu 2018, Option II): g~ = av + sum / B,
          // z <- soft(z - alpha g~, alpha lambda), y <- soft(x - beta g~,
          // beta lambda), ys += y; then the next step's x against the anchor
          // point wa
          const float gr = st[1] + innov * fs[4];
          const float z_new = soft_threshold(st[2] - fs[0] * gr, fs[2]);
          const float y_new = soft_threshold(st[0] - fs[1] * gr, fs[3]);
          a.z[j] = z_new;
          a.y[j] = y_new;
          a.zs[j] = st[5] + y_new;
          a.pt[j] = coupled_point(sc[tau_slot(M)], sc[tau_slot(M) + 1], z_new,
                                  st[4], y_new);
        } else if (M == kSarahSteps) {
          // SARAH's recursion and ProxSARAH's damped prox: v += sum / B,
          // y = soft(w - gamma v, gamma lambda), w_prev <- w,
          // w <- w + eta (y - w)
          const float v_new = st[1] + innov * fs[3];
          const float w = st[0];
          const float yv = soft_threshold(w - fs[0] * v_new, fs[1]);
          a.av[j] = v_new;
          a.pt[j] = w;
          a.pt[n + j] = w + fs[2] * (yv - w);
        } else if (finito_coeff(M)) {
          // Finito_basic.jl:110-118 on block j: av += hat invg_j (z - zb_j)
          // - (hat / N) sum, zb_j <- z, z <- soft(av, hat lambda)
          const float av_new = st[1] + ((fs[1] * ig) * (st[0] - st[2]) -
                                        (fs[1] * fs[0]) * innov);
          a.av[j] = av_new;
          zb_row[j] = st[0];
          a.pt[j] = soft_threshold(av_new, fs[2]);
        } else if (M == kLFinitoSteps) {
          // Finito_LFinito.jl:92-100 on the k'th visited block: av += (hat /
          // N) sum + hat invg_k (z - zf), sum = sum (c_anchor - c(z)) a_i;
          // then the next block's z = soft(av, hat lambda), but after the
          // call's last block, whose z the call returns
          const float av_new = st[1] + ((fs[0] * fs[2]) * innov +
                                        (fs[0] * ig) * (st[0] - st[2]));
          a.av[j] = av_new;
          if (k + 1 < live) a.pt[j] = soft_threshold(av_new, fs[1]);
        } else if (M == kProshiSteps) {
          // ProShI_basic.jl:111-123: av += sum, z = (prox_g(av) - av) / hat,
          // prox_g by gmode: the identity, clip(av, glo, ghi) (NaN passes
          // through) or the soft-threshold at glo
          const float av_new = st[1] + innov;
          const float glo = sc[4], ghi = sc[5];
          const int gmode = static_cast<int>(sc[6]);
          float p = av_new;
          if (gmode == kGproxBox)
            p = av_new < glo ? glo : (av_new > ghi ? ghi : av_new);
          else if (gmode == kGproxL1)
            p = soft_threshold(av_new, glo);
          a.av[j] = av_new;
          a.pt[j] = (p - av_new) * sc[2];
        } else if (M == kPointSagaSteps) {
          // Point-SAGA (Defazio 2016, the block mean of the rows' prox
          // points): with sum = sum (c_old - theta) a_i, x <- v + (gamma /
          // B) sum, av <- av - sum / N, then the next step's v = x - gamma
          // av but after the call's last step (x, never v, is the iterate)
          const float x_new = st[0] + (fs[0] * fs[1]) * innov;
          const float av_new = st[1] - innov * fs[2];
          a.z[j] = x_new;
          a.av[j] = av_new;
          if (k + 1 < live) a.pt[j] = shifted_point(fs[0], x_new, av_new);
        } else if (M == kSsnmSteps) {
          // SSNM (Zhou, Shang and Cheng 2019) on block j, the margins taken
          // at y: x <- soft(x - eta (sum / B + gb), eta lambda), gb += sum /
          // N, zb_j <- y (the unrounded y the margins rounded); then the
          // next step's y from the new x and the next block's stored point.
          // Only this thread writes column j of zb, so that point is the
          // value loaded beside the partials, or y where the next block is
          // this one: no load waits behind the store
          const float x_new =
              soft_threshold(st[2] - fs[0] * (innov * fs[2] + st[1]), fs[1]);
          a.z[j] = x_new;
          a.av[j] = st[1] + innov * fs[3];
          zb_row[j] = st[0];
          if (k + 1 < live)
            a.pt[j] = momentum_point(sc[tau_slot(M)], x_new,
                                     blk_next == blk ? st[0] : st[3]);
        } else {
          // L-Katyusha (Alg. 3, proximal z-step): g~ = av + sum / B,
          // z_new = soft((z + eta sigma x - (eta/L) g~) / (1 + eta sigma),
          // tau lambda), ypre <- y, y <- x + theta1 (z_new - z), z <- z_new;
          // then the next step's x against the anchor point wa
          const float th1 = fs[4];
          const float xj = st[0], z_old = st[2];
          const float gr = st[1] + innov * fs[6];
          const float z_new =
              soft_threshold((z_old + fs[3] * xj - fs[0] * gr) * fs[2], fs[1]);
          const float y_new = xj + th1 * (z_new - z_old);
          a.pre[j] = st[3];
          a.y[j] = y_new;
          a.z[j] = z_new;
          a.pt[j] = coupled_point(th1, fs[5], z_new, st[4], y_new);
        }
      }
      consumer_sync();
    }
    if (k + 1 < live) grid_sync(a.bar, phase);
  }
}

template <int M, typename T, bool kLowp, bool kVec, int kRU, bool kSplit>
cudaError_t run_loopless(const LooplessArgs& a, size_t smem, int sms,
                         cudaStream_t stream) {
  auto kernel = loopless_steps_kernel<M, T, kLowp, kVec, kRU, kSplit>;
  // the shared-memory attribute and the CTAs an SM holds, asked of the
  // driver once for each (device, shared memory) this build meets in a row:
  // a short window's call is bound by the host
  static std::atomic<unsigned long long> known{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long key = (static_cast<unsigned long long>(smem) << 16) |
                                 (static_cast<unsigned long long>(dev) << 8);
  unsigned long long seen = known.load(std::memory_order_relaxed);
  int per_sm = static_cast<int>(seen & 0xff);
  if ((seen & ~0xffull) != key || seen == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kLlBlock, smem);
    if (e != cudaSuccess) return e;
    known.store(key | static_cast<unsigned long long>(per_sm & 0xff),
                std::memory_order_relaxed);
  }
  // every CTA must be resident at once, or the grid barrier never opens
  if (per_sm * sms < a.ctas) return cudaErrorCooperativeLaunchTooLarge;
  LooplessArgs arg = a;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(a.ctas), dim3(kLlBlock), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The 16-byte path or the plain one, the fewest register units a thread
// that cover a row, and the narrow-row split where a row has at most 128
// units (two row groups or more; the other builds have one).
template <int M, typename T, bool kLowp>
cudaError_t dispatch_loopless(bool vec, const LooplessArgs& a, size_t smem,
                              int sms, cudaStream_t stream) {
  const int units = vec ? a.n / 4 : a.n;
  const int per_thread = (units + kLlThreads - 1) / kLlThreads;
  const bool split = loopless_groups(units) > 1;
  auto run =
      vec ? (split             ? run_loopless<M, T, kLowp, true, 1, true>
             : per_thread <= 1 ? run_loopless<M, T, kLowp, true, 1, false>
             : per_thread <= 4 ? run_loopless<M, T, kLowp, true, 4, false>
                               : run_loopless<M, T, kLowp, true, 16, false>)
          : (split             ? run_loopless<M, T, kLowp, false, 1, true>
             : per_thread <= 4 ? run_loopless<M, T, kLowp, false, 4, false>
                               : run_loopless<M, T, kLowp, false, 64, false>);
  return run(a, smem, sms, stream);
}

// Checks the grid and the ring against the rule, picks the instantiation and
// makes the one cooperative launch; returns its error (0 on success).
template <int M>
int launch_loopless(int storage, int lowp, const LooplessArgs& a,
                    void* stream) {
  const int isz = storage_itemsize(storage);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int rows = 0, ctas = 0;
  if (a.B < 1) return static_cast<int>(cudaErrorInvalidValue);
  loopless_grid(a.B, sms, rows, ctas);
  const int S = a.stage_rows, P = a.stages, pts = ll_points(M);
  // at least two stages, one only where two do not fit (SARAH's two points
  // beside f32 rows wider than 14,456 columns)
  if (a.n < 1 || a.n > kLlMaxCols || a.K < 1 ||
      rows != a.rows || ctas != a.ctas || S < 1 || S > rows ||
      S > kLlMaxStageRows || (S & (S - 1)) != 0 || P < 1 ||
      (P == 1 && loopless_smem_bytes(S, 2, a.n, isz, pts) <= kLlMaxSmem) ||
      P > kLlMaxStages || loopless_smem_bytes(S, P, a.n, isz, pts) > kLlMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = loopless_smem_bytes(S, P, a.n, isz, pts);
  // ProShI's 16-byte path also reads and writes its table rows and point in
  // whole 16-byte chunks
  const bool vec = vec_rows(a.A, a.n, isz) &&
                   (M != kProshiSteps ||
                    (vec_rows(a.s, a.n, 4) && vec_rows(a.pt, a.n, 4)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // ProShI's margins are exact f32 whatever the rows and precision (the
  // Pallas kernel ignores its precision): its builds are kLowp false alone
  constexpr bool kRound = M != kProshiSteps;
  switch (storage) {
    case kF32:
      if constexpr (kRound)
        e = lowp ? dispatch_loopless<M, float, true>(vec, a, smem, sms, st)
                 : dispatch_loopless<M, float, false>(vec, a, smem, sms,
                                                      st);
      else
        e = dispatch_loopless<M, float, false>(vec, a, smem, sms, st);
      break;
    case kBF16:
      e = dispatch_loopless<M, __nv_bfloat16, kRound>(vec, a, smem, sms,
                                                      st);
      break;
    case kI8:
      e = dispatch_loopless<M, int8_t, kRound>(vec, a, smem, sms, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace
