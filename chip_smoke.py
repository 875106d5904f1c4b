#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ciao_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's main paths through its nineteen hand-written CUDA kernels,
``ciao_tpu_torch/csrc/saga_coeff_multistep_streamed.cu`` (kernels #3 and #4
of PERF.md: #3 is its entry with no clamp count), ``svrg_coeff_multistep.cu``
(kernel #5), ``coeff_apply_all.cu`` (kernel #6), ``finito_coeff_multistep.cu``
(kernel #9), ``finito_coeff_multistep_streamed.cu`` (kernel #14),
``lfinito_sweep_multistep.cu`` (kernel #8), ``finito_block_update.cu``
(kernel #2), ``saga_block_update.cu`` (kernel #1), ``proshi_multistep.cu``
(kernel #18), ``katyusha_coeff_multistep.cu`` (kernel #10),
``sarah_multistep.cu`` (kernel #11), ``lsvrg_coeff_multistep.cu`` (kernel
#16), ``lkatyusha_coeff_multistep.cu`` (kernel #17),
``ssnm_multistep_streamed.cu`` (kernels #13 and #19: #19 is its entry with
no clamp count), ``point_saga_multistep_streamed.cu`` (kernels #15 and #12:
#12 is its entry with no clamp count) and ``coeff_value_apply_all.cu``
(kernel #7):

- the SAGA headline of ``bench.py``: a dense Lasso with N = 262,144 rows of
  n = 1,024 columns stored int8 or f32, NormL1(0.1), block-sampled
  coefficient-table SAGA at B = 4,096 through ``saga_init`` and
  ``saga_run`` (kernel #3), and the ``SAGA`` facade;
- the deep target of ``bench.py``: ``deep_solve`` on the planted
  10,485,760 x 128 Lasso (100 live columns) at B = 8,192, whose streamed
  SAGA stage runs kernel #4, then the compensated FISTA polish; and the
  ``SAGA`` facade with importance sampling on the same problem;
- the SVRG configuration of ``bench.py`` (``svrg fused``): the headline
  Lasso, B = 4,096, m = N/B = 64 inner steps on kernel #5 and a one-pass
  anchor on kernel #6 per outer step, and the ``SVRG`` facade (SVRG and
  SVRG++) on a planted Lasso;
- the FISTA configuration of ``bench.py`` (``fista fused``): one kernel #6
  pass per step at the headline, and the ``FISTA`` facade on the planted
  Lasso;
- the Finito configuration of ``bench.py`` (``finito fused``): the headline,
  B = 4,096, sweeping=3, the coefficient table on kernel #9; the ``Finito``
  facade on the planted Lasso (coefficient table on #9, full table on #2)
  and adaptive Finito; on the deep target, streamed Finito (#14), its
  importance-sampled facade, and LFinito (#6 and #8), the counterpart of
  ``bench.py``'s ``lfinito_10m_epochs_per_s``;
- the ProShI configurations of ``bench.py``: the first 65,536 rows of the
  headline, IndBox(-inf, 1), B = 4,096, cyclic (f32 and int8 rows) and
  shuffled, and random with block sampling at 262,144 rows, on kernel #18,
  and the ``Proshi`` facade;
- SAGA's full (N, n) table at the headline on kernel #1 (f32 and bf16
  rows), and the ``SAGA(table="full")`` and ``SAG`` facades;
- ``bench.py``'s sharing deep route: ``deep_solve_sharing`` on the planted
  65,536 x 128 sharing problem to rel <= 1e-6 (stepwise by design);
- the families of ``bench.py`` whose inner step is SVRG's, at the headline
  with f32 and int8 rows: Katyusha (ns) and SARAH, m = N/B = 64 inner steps
  and 150 outer steps (kernels #10 and #11, anchors on #6), L-SVRG and
  L-Katyusha, p = B/N and 24,576 steps (kernels #16 and #17, windows of at
  most 32 steps ending at each coin flip, anchors on #6); their facades on
  the planted Lasso, and Katyusha's time to rel 1e-3 on the planted 65,536 x
  1,024 Lasso with 64 nonzeros (``bench.py:1596-1649``);
- SSNM and Point-SAGA as ``bench.py`` runs them (:1495-1550, :756-817,
  :946-987): SSNM at the headline (NormL1(0.1), τ = 0.5, η = 1/(1.5·L_max),
  f32 and int8; kernel #19) and on the deep target (kernel #13);
  Point-SAGA (g = Zero) at the headline with least-squares and logistic
  rows (f32, int8), squared-hinge and Poisson rows (f32; kernel #12) and
  on the deep target with least-squares rows (kernel #15); the ``SSNM`` and
  ``PointSAGA`` facades on the planted Lasso; and ``deep_solve`` on
  logistic rows (the logistic formula on kernel #3);
- PANOC and ZeroFPR as ``bench.py`` runs them (:745-754, :838-848): ZeroFPR
  fused at the headline with f32, bf16 and int8 rows and PANOC fused at f32
  with adaptive γ off and on, every FBE evaluation one pass of kernel #7;
  the ``PANOC`` and ``ZeroFPR`` facades on the planted Lasso; Davis-Yin and
  Condat-Vũ (:850-903) at the headline, one kernel #6 pass a step;
- the sparse route of ``bench.py`` (``bench_sparse_e2e``, :1261-1383): the
  planted power-law sparse Lasso in the ELL and hot/cold hybrid layouts,
  FISTA and SAGA on both, ``deep_solve`` on both with least-squares and
  logistic rows; it runs none of the nineteen kernels, by design;
- the primal-dual deep route of ``bench.py`` (``bench_pd_deep``,
  :1131-1258): ``deep_solve_pd`` on the planted 262,144 x 1,024 fused lasso
  and three-term problems assembled on the card; it runs none of the
  nineteen kernels, by design.

Phases, one line each:

  1. device: CUDA present (else exit 2), the card's name and power limit;
  2. build: the nineteen kernels' sixteen sources compiled by nvcc from
     this checkout, in parallel;
  3. kernel #3 == plain version: f32/bf16/int8 rows, SAGA and SAG, with and
     without direction weights, at a small shape (and at widths that are not
     whole 16-byte chunks), at the headline shape, and f32 and int8 rows at
     the persistent engine's edges (LOOPLESS_EDGES);
  3b. kernel #4 == plain version: the same matrix at N = 8,192, n = 128,
     B = 128, K = 64 with clamp counts f = K and f = 23, masked steps bit
     for bit, and K = 8 at the deep target's shape;
  4. headline path: 8 epochs of the headline at int8 and at f32 rows, and
     the ``SAGA`` facade on a planted Lasso, with kernel #3's launch count;
  4b. deep path: ``deep_solve`` to rel <= 1e-6 (f32 cold, f32 warm, and
     int8 -> f32), kernel #4's launch count against the epochs run and
     kernel #3's unmoved;
  4c. importance route: ``SAGA(importance_sampling=True)`` for 32 epochs on
     the streamed route through kernel #4 with weights;
  5. times at the headline shape: ms per step of kernel #3 and of its plain
     version, with the card's name and power limit, and a window of SAGA's
     headline steps profiled (int8, f32), showing one launch of the
     persistent engine a kernel #3 call and no kernel of the two-launch
     engine;
  5b. times at the deep target's shape: the same for kernel #4, and a
     window of SAGA's streamed route profiled (f32, int8), showing one
     launch of the persistent engine a call and no kernel of the two-launch
     engine;
  3c. kernel #6 == plain version: every formula mode, f32/bf16/int8 rows,
     "highest" and "default", at N = 8,192, n = 256 and at n = 128 (tiles
     of 96-256 rows, the last ragged), ragged N, widths that are not whole
     16-byte chunks, the adversarial compensated stream of
     tests/test_ops.py, a bit-for-bit repeat, and the headline;
  3d. kernel #5 == plain version: NormL1 and Zero, every storage and
     precision at N = 8,192, n = 128, B = 128, K = 64, and K = 8 at the
     headline;
  4d. SVRG path: 150 outer steps at int8 and at f32 rows, the ``SVRG`` and
     SVRG++ facades, kernel #5 and #6 launch counts, #3 and #4 unmoved;
  4e. FISTA path: 600 steps at f32 and int8 rows and the ``FISTA`` facade,
     kernel #6 once per step;
  6. times at the headline: kernel #6 per pass against its plain version,
     its bound, the read ceiling (a ``torch.sum`` over 2 GiB, measured
     after the build) and the two-gemv yardstick, and the same at the deep
     target's shape on its rows (f32 and int8, timed inside 4g's block);
     kernel #5 per step against its plain version; ms per SVRG outer step
     and per FISTA step; a window of SVRG outer steps profiled, showing one
     launch of the persistent engine a kernel #5 call and no kernel of the
     two-launch engine.
  3e. kernel #9 == plain version: every storage and precision, NormL1 and
     Zero, repeated blocks, at SMALL; K = 8 at the headline; f32 and int8
     rows at the persistent engine's edges (LOOPLESS_EDGES);
  3f. kernel #14 == plain version at SMALL_STREAM with f = K and f = 23,
     masked steps bit for bit, f32 and int8 rows at the persistent engine's
     edges (LOOPLESS_EDGES, blocks revisited), and K = 8 at the deep shape;
  3g. kernel #8 == plain version: a whole shuffled sweep of d = 64 blocks at
     SMALL_STREAM, a whole sweep at LOOPLESS_EDGES (f32 and int8), and K =
     8 at the deep shape, its z the last block's prox point;
  3h. kernel #2 == plain version: f32 and bf16 rows at SMALL and at the
     headline, rows outside the block bit for bit;
  4g. deep-shape Finito paths (after 4b/4c, on the same problem): streamed
     Finito and importance-sampled Finito on #14, LFinito on #6 and #8,
     ms/epoch and epochs/s; times of #14 and #8 per step, and a window of
     streamed Finito steps and two LFinito epochs profiled, showing one
     launch of the persistent engine a kernel #14 or #8 call and no kernel
     of the two-launch engine;
  4f. Finito headline path: 256 epochs at f32 and int8 rows on #9, and the
     facades: the coefficient table on #9, the full table on #2, adaptive
     with no kernel;
  7. times: kernel #9 per step at the headline, kernel #2 per step at the
     headline, each in turns with its plain version and with its bound;
     Finito steps at the headline profiled, on the coefficient table (one
     launch of the persistent engine a kernel #9 call, no kernel of the
     two-launch engine) and on the full table;
  3i. kernel #18 == plain version: f32/bf16/int8 rows, IndBox/NormL1/Zero
     couplings, "default" precision bit for bit the same as "highest", a
     masked window (f < K) with masked steps bit for bit, a narrow width on
     the one-value path, f32 and int8 rows at the persistent engine's edges
     (LOOPLESS_EDGES), and K = 8 at the ProShI configuration;
  3j. kernel #1 == plain version: f32 and bf16 rows, both precisions, at
     SMALL and at the headline, rows outside the block bit for bit;
  4h. ProShI path: cyclic 8,192 steps at f32 and int8 rows, shuffled,
     random with block sampling at d = 64, and the facade, on kernel #18
     alone;
  4i. SAGA full-table path: 512 steps at the headline (f32, bf16) and the
     SAGA/SAG facades on kernel #1 alone;
  4j. sharing deep route: rel against the f64 optimum, no kernel launch;
  8. times: kernel #18 per step and kernel #1 per block, in turns with
     their plain versions and with their bounds; ProShI steps profiled
     (one launch of the persistent engine a kernel #18 call, no kernel of
     the two-launch engine or of the table walk) and a full-table SAGA
     epoch;
  3k-3n. kernels #10, #11, #16, #17 == plain versions: f32/bf16/int8 rows,
     "highest" and "default", NormL1 and Zero, Katyusha at τ₁ = 0.5 (ns)
     and 0.3, the logistic and Huber formulas, a width that is not whole
     16-byte chunks, the loopless kernels' masked windows (stop < K − 1
     and stop = K − 1) bit for bit, K = 8 at the headline, and the
     persistent engine's grid at its edges for all four (LOOPLESS_EDGES: B
     = 4,096 and 1,024 at n = 1,024, n = 16,384 and n = 202; the loopless
     pair f32 with a stop and int8 step by step, each with its masked
     windows);
  4k-4n. Katyusha, SARAH, L-SVRG and L-Katyusha at the headline (f32 and
     int8 rows) with launch counts and falling objectives, their facades
     on the planted Lasso, and Katyusha's time to rel 1e-3;
  9. times: the four kernels per step in turns with their plain versions
     and with their bounds, also at B = 1,024 (the facades' batch); a
     window of each family profiled, showing one launch of its kernel of
     the persistent engine a call and no kernel of the two-launch engine.
  3o-3p. kernels #19, #13, #12, #15 == their plain version: SSNM in f32
     "highest" and "default", bf16 and int8 rows at τ = 0.5 and 1, #13 with
     f = K and f = 23; Point-SAGA in all five oracle modes (least squares,
     logistic, Huber δ = 0.7, squared hinge, Poisson on 0.05·A) with f32 and
     int8 rows, bf16 for least squares and logistic, #15 with f = 23; the
     K-step calls equal to their one-step calls and the masked steps, bit
     for bit, #15 with no clamp count equal to #12 and f = 0 writing
     nothing; K = 8 at the headline and (inside 4g's block) at the deep
     shape, #15 there with least-squares and logistic rows; #19 with f32
     and int8 rows, #13 with f32 rows and a clamp count, and #12 and #15
     (with a clamp count) with logistic f32 and int8 rows at the
     persistent engine's edges (LOOPLESS_EDGES);
  4p, 4r. (on the deep target, after 4g) SSNM on #13 and least-squares
     Point-SAGA on #15, f32 and int8, two epochs each, and #13 and #15 per
     step in turns with their plain version; a window of each profiled,
     showing one launch of the persistent engine a kernel #13 or #15 call
     and no kernel of the two-launch engine;
  4o, 4q. SSNM and Point-SAGA at the headline with launch counts, falling
     objectives, ms per step and a profiled window each (reported in phase
     10, showing one launch of the persistent engine a kernel #19 or #12
     call and no kernel of the two-launch engine);
  4s. the ``SSNM`` (cost − f*) and ``PointSAGA`` (mean gradient) facades
     on the planted Lasso against the folds of a CPU run of the same seed;
  4t. ``deep_solve`` on logistic rows (2,048 x 32) to rel <= 1e-6 of the
     f64 optimum;
  10. times: kernels #19 and #12 per step at the headline in turns with
     their plain version and with their bounds.
  3q. kernel #7 == plain version: every formula mode, f32/bf16/int8 rows,
     "highest" and "default", at N = 8,192, n = 256, at the deep target's
     width n = 128 (tiles of 96-256 rows, the last ragged) and at the
     headline, ragged N and widths that are not whole 16-byte chunks,
     bit-for-bit repeats, c and gsum equal to kernel #6's; kernel #6's
     output bit for bit its pinned digests;
  4u. PANOC/ZeroFPR at the headline (128 steps each): kernel #7 launched once
     per FBE evaluation and nothing else, ms per step, evaluations per step,
     a profiled window's idle share;
  4v. the ``PANOC`` and ``ZeroFPR`` facades on the planted Lasso: cost − f*
     against the bar, beside the same facades on the CPU in f64;
  4w. Davis-Yin and Condat-Vũ (FirstDifference; DenseMap 1,024 and 8,192 x
     1,024 at f32) at the headline, 600 steps each, kernel #6 once a step;
  4x. the sparse route (gathers, scatter-adds and the hot block's product
     in torch; no kernel launches, by design): (a) bench.py's
     bench_sparse_e2e problem, the planted power-law 131,072 x 16,384
     Lasso (hot 512, k 24 + 8, p 64) in the ELL and hybrid layouts, its
     KKT certificate, spectral-step FISTA to rel 1e-3 on both layouts
     (passes and seconds), SAGA at B = 2,048 in ms a step on ELL and the
     hybrid in f32 and bf16, each with a profiled window and its idle
     share, the ELL window run twice (do the bits repeat?); (c)
     ``deep_solve`` on both layouts to rel <= 1e-6; (d) ``deep_solve`` on
     sparse logistic rows of the same design, both layouts, to rel <= 1e-6
     of an f64 ELL FISTA reference; (b) the full rcv1 shape 524,288 x
     65,536 (hot 1,024, k 48 + 16): SAGA at B = 4,096 on each layout;
  4y. the primal-dual deep route (compensated Condat-Vũ and the certified
     reduced solves in torch; no kernel launches, by design): bench.py's
     bench_pd_deep plants of 262,144 x 1,024 f32 rows with 16 jumps built
     on the card, ``deep_solve_pd`` on the fused lasso (h = λ‖D·‖₁) and on
     the three-term objective (g = λ₁‖·‖₁ as well) at chunk 4,096, 256 steps
     a round, at most 8,192: each leg refined and certified, rel <= 1e-6
     from the difference-form gap, the three-term leg's planted zeros
     exactly zero; seconds split into the Condat-Vũ rounds and the
     refinement, ms a step, and a profiled window of 64 steps (idle share,
     device launches a step);
  11. times: kernel #7 per pass at the headline in turns with its plain
     version and kernel #6, its bound, the read ceiling and the two-gemv +
     value yardstick, and the same at the deep target's shape.

Then a JSON line of the kernels (with each one's bound, computed from this
run's inputs), and last ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits non-zero and prints no result.
Data are random from ``--seed``, made on the card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# the bench.py headline
N, n, B, LAM = 262_144, 1_024, 4_096, 0.1
EPOCH_STEPS = N // B          # 64 steps visit N rows on average
MAIN_STEPS = 8 * EPOCH_STEPS  # 512 steps: four 128-step kernel launches

# kernel-vs-plain comparisons: the small shape, and K steps at the headline
SMALL = dict(N=8_192, n=256, B=512, K=64)
HEADLINE_K = 8

# the facade's planted Lasso: 16,384 steps of B = 1,024 are 256 epochs
FACADE = dict(N=65_536, p=16, batch=1_024, maxit=16_385)

# the deep target of bench.py (deep_target_10m): 10,485,760 rows, 128
# columns of which 100 are live, B = 8,192 (d = 1,280 blocks), 8 planted
# nonzeros, λ = 1, ρ = 10, scale N, L_i = ‖a_i‖²·N
DEEP = dict(N=10 * 1024 * 1024, n=128, live=100, B=8_192, p=8, lam=1.0,
            rho=10.0)
DEEP_KW = dict(batch=DEEP["B"], chunk_epochs=16, plateau_rtol=1e-5,
               max_epochs=192, polish_steps=4, polish_max_rounds=8,
               polish_chunk=32_768)
DEEP_REL = 1e-6
IMPORTANCE_EPOCHS = 32
# kernel #4 against its plain version: d = 64 blocks, as tests/test_ops.py
SMALL_STREAM = dict(N=8_192, n=128, B=128, K=64, f=23)
DEEP_K = 8

# the SVRG configuration of bench.py (svrg fused): m = N/B inner steps per
# outer step, γ = 1/(10·L_max); the facades' planted Lasso is FACADE's
SVRG_M = N // B
SVRG_OUTER = 150
SVRG_FACADE = dict(batch=1_024, m=64, maxit=513, gamma_L=3.0)
SVRG_PLUS = dict(batch=1_024, m=1, maxit=16, gamma_L=3.0)
FACADE_DROP = 1_000.0  # the least fall of cost − f* each facade must show
# the FISTA configuration of bench.py (fista fused): γ = 1/mean(L)
FISTA_STEPS = 600
FISTA_FACADE_STEPS = 200
# kernel #6 against its plain version
APPLY_SMALL = dict(N=8_192, n=256)
# the deep target's width with tiles of more than 32 rows (96 f32, 192 bf16,
# 256 int8) and a ragged last tile of 5 rows (f32), 101 (bf16) or 37 (int8)
APPLY_NARROW = dict(N=65_573, n=128)
# wide rows, each with a ragged N: n = 4,096 (11 int8 rows a tile, the
# widest of the two-CTA walk) and the wide walk beyond (64 register columns a
# thread, one CTA an SM: 2 f32 rows a tile at n = 8,192, 2 bf16 rows at
# n = 16,384; its plain path at n = 8,200 int8, rows that are not whole
# 16-byte chunks); z is scaled by sqrt(1024 / n) (walk_z) so that the
# margins keep the headline's spread
APPLY_WIDE = (("int8", "highest", 4_099, 4_096), ("f32", "default", 1_029,
              8_192), ("bf16", "highest", 517, 16_384),
              ("int8", "highest", 1_031, 8_200))


def walk_z(n_: int, gen, dev):
    """The point of the walk's checks: 0.05 per entry up to n = 1,024,
    scaled by sqrt(1024 / n) beyond, so that the margins of Gaussian rows
    keep the spread they have at the headline (a standard deviation of
    1.6)."""
    return 0.05 * min(1.0, (1024 / n_) ** 0.5) * torch.randn(
        n_, generator=gen, device=dev)
ADVERSARIAL = dict(N=262_144, n=128, tile=2_048)
# kernel #5 against its plain version: d = 64 blocks
SVRG_SMALL = dict(N=8_192, n=128, B=128, K=64)
# the Finito configuration of bench.py (finito fused, :1418): the headline,
# B = 4,096, sweeping=3, the coefficient table on kernel #9; 256 epochs of
# 64 steps, as bench.py times, in 128 launches
FINITO_EPOCHS = 256
# the facades on the planted Lasso (FACADE): Finito(sweeping=3) for 256
# epochs of batch 1,024 on kernel #9; the full table (kernel #2, one launch
# a step, each reading and writing its block's 4 MiB of table) for 16
# epochs, cut from 256 to keep the run short; adaptive Finito (no kernel,
# a host-read line search every step) for 1,500 single-row steps on a
# small planted Lasso. Finito's rate over the 64 blocks of this Lasso
# allows no FACADE_DROP-fold fall in these budgets (a CPU run of the same
# seed: 2.16-fold in 256 epochs, 1.059-fold in 16 full-table epochs; the
# JAX package's Finito falls as slowly), so each has its own bar
FINITO_FACADE = dict(batch=1_024, maxit=16_385, drop=2.0)
FULL_FACADE = dict(batch=1_024, maxit=1_025, drop=1.03)
ADAPTIVE = dict(N=256, n=32, p=4, maxit=1_501, drop=10.0)
# the deep shape: streamed Finito (kernel #14) and importance-sampled
# Finito for 4 epochs of d = 1,280 steps, LFinito (kernels #6 and #8,
# bench.py's lfinito_10m_epochs_per_s at the deep target's data) for 16
# timed epochs after one warm-up: cut from bench.py's 512 at most
DEEP_FINITO_EPOCHS = 4
LFINITO_EPOCHS = 16
# the ProShI configuration of bench.py (:1564-1591): the first 65,536 rows
# of the headline's Lasso, IndBox(-inf, 1), cyclic, B = 4,096, γ_i =
# 0.999·N/L_i, 8,192 steps; bench.py:1072-1095 adds shuffled at 65,536 and
# random with block_sampling at 262,144 (d = 64), each 8,192 steps there,
# cut here to 2,048 and 1,024 steps; the facade runs 2,048 steps
PROSHI = dict(N=65_536, B=4_096, hi=1.0, steps=8_192, shuffled=2_048,
              random=1_024, facade=2_049)
# kernel #18 against its plain version: a small shape with a masked window
# (steps k >= f), a narrow ragged width (not whole 16-byte chunks: the
# one-value path), and K steps at the configuration
PROSHI_SMALL = dict(N=8_192, n=256, B=512, K=16, f=5)
PROSHI_RAGGED = dict(N=1_024, n=130, B=128, K=8)
PROSHI_K = 8
# SAGA's full table at the headline: 8 epochs of B = 4,096 on kernel #1,
# f32 and bf16 rows; the facades on the facades' planted Lasso (FACADE):
# SAGA(table="full") for 256 epochs of batch 4,096 and SAG (γ = 1/(16·L_max),
# biased) for 64. A CPU run of the same seed: 8.25-fold and 1.107-fold
# falls of cost − f*; the bars keep a margin
FULL_SAGA_STEPS = MAIN_STEPS
FULL_SAGA_FACADE = dict(batch=4_096, maxit=4_097, drop=4.0, sag_maxit=1_025,
                        sag_drop=1.05)
# the sharing deep route of bench.py (bench_sharing_deep, :1098-1130):
# deep_solve_sharing on make_sharing_planted(65,536, 128, p=16), DiagQuadratic
# F and NormL1 g, batch 512, sweeping 2, 16-epoch chunks, at most 512
# epochs, resync chunk 4,096; stepwise by design (no kernel: not rank 1).
# Its accuracy record on the TPU (BASELINE.md:100) is rel 1.55e-7, an
# accuracy, which holds on any hardware.
SHARING_DEEP = dict(N=65_536, n=128, p=16, batch=512, sweeping=2,
                    chunk_epochs=16, max_epochs=512, resync_chunk=4_096)
SHARING_REL, SHARING_RECORD = 1e-6, 1.55e-7
# the SVRG-shaped families of bench.py (:1471-1534) at the headline:
# Katyusha (ns) and SARAH (γ = 1/(2·L_max), η = 1) with m = N/B = 64 inner
# steps and 150 outer steps; L-SVRG (γ = 1/(6·L_max)) and L-Katyusha
# (σ̂ = 0, θ₁ = 1/3, θ₂ = 1/2) with p = B/N and 24,576 steps
VR_M, VR_OUTER, LOOPLESS_STEPS = N // B, 150, 24_576
# the four kernels against their plain versions: d = 64 blocks, and the
# loopless kernels' masked window (steps k > stop)
VR_SMALL = dict(N=8_192, n=128, B=128, K=64, stop=22)
# the persistent engine's grid at its edges (N, n, B, K, stop): 128 CTAs of
# 32 and of 8 rows, one f32 row a stage (the wide build; SARAH's one-stage
# ring; Point-SAGA's solves a stage at a time), rows that are not whole
# 16-byte chunks; the stop is the loopless pair's (LOOPLESS_KINDS)
LOOPLESS_EDGES = ((32_768, 1_024, 4_096, 32, 20),
                  (32_768, 1_024, 1_024, 32, 20),
                  (8_192, 16_384, 1_024, 8, 5), (8_192, 202, 1_024, 32, 20))
LOOPLESS_KINDS = ("lsvrg", "lkatyusha")
# the facades on the facades' planted Lasso (FACADE), batch 1,024, default
# stepsizes. A CPU run of the same seed (stepwise, the same draws) fell
# 4,773-fold in Katyusha's 32 outer steps of m = 2N/B = 128, 132,247-fold in
# SARAH's 256 of m = N/B = 64, 61.4-fold in L-SVRG's 16,384 steps and
# 231,925-fold in L-Katyusha's 8,192; the bars keep a margin of at least 3x
VR_FACADE = {"katyusha": dict(batch=1_024, maxit=33, drop=FACADE_DROP),
             "sarah": dict(batch=1_024, maxit=257, drop=FACADE_DROP),
             "lsvrg": dict(batch=1_024, maxit=16_385, drop=20.0),
             "lkatyusha": dict(batch=1_024, maxit=8_193, drop=FACADE_DROP)}
# bench.py:1596-1649: Katyusha's time to rel 1e-3 on a planted 65,536 x
# 1,024 Lasso with 64 nonzeros, in chunks of 8 outer steps (at most 64)
KATYUSHA_TTR = dict(N=65_536, p=64, chunk=8, max_chunks=64, rel=1e-3)

# The card's published rates (NVIDIA's data sheet, H100 SXM): device
# memory, and the peak for the rows' type — f32 outside the tensor cores,
# bf16 and int8 in them. A kernel's bound is the larger of its bytes (each
# input read once, each output written once) and its operations over these.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {4: 67e12, 2: 989e12, 1: 1979e12}

# Tolerances of the kernel against its plain version, as errors relative to
# the largest entry of the plain version's output. Both run the same
# arithmetic in f32 but sum in other orders (the kernel per lane and by
# shuffles, cuBLAS by its own tiling), so the states drift apart by f32
# rounding over the K steps. On an H100 (700 W) the largest such errors over
# all comparisons below were 6e-8 for z and 2.3e-7 for c and av with
# exact-f32 dots, and 2.2e-7 for z and 2.9e-6 for c and av where both dot
# operands round to bf16, where a rounding difference in z can move one bf16
# operand by an ulp (2^-8). Kernel #5's w and zs stayed within 1.1e-7 of
# theirs, and kernel #6's c and gradient sum within 7.2e-7 (exact f32; the
# Huber clip) and 1.6e-6 (bf16 dots). The bounds keep a margin of at least
# 14x.
Z_TOL = {False: 1e-6, True: 1e-5}
STATE_TOL = {False: 1e-5, True: 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    lines = [l.strip() for l in out.stdout.splitlines() if l.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return lines[0]


def lasso(gen, dev, rows: int, cols: int, storage: str):
    """The headline's random Lasso on the card: Gaussian rows and offsets,
    scale N, stored ``storage``; SAGA's γ = 1/(3·L_max) as bench.py sets
    it, and the (rows,) moduli L_i = N·‖a_i‖² of the f32 rows."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    A = torch.randn(rows, cols, generator=gen, device=dev)
    b = torch.randn(rows, generator=gen, device=dev)
    L = (A * A).sum(dim=1) * rows
    F = LeastSquaresRows(A, b, torch.tensor(float(rows), device=dev))
    if storage != "f32":
        F = F.with_storage(storage)
    return F, torch.tensor(1.0 / (3.0 * float(L.max())), dtype=torch.float32,
                           device=dev), L


def cost(F, g, z) -> float:
    """(1/N) Σ f_i(z) + g(z) in one margin pass."""
    return float(F.value_sum_all(z) / F.num_terms + g.value(z))


def bound(nbytes: float, ops: float, itemsize: int):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``ops`` on rows of ``itemsize`` bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[itemsize]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def step_bytes(F, starts, B_: int, vec_bytes: int, row_extra: int) -> float:
    """Bytes per step of K block steps on ``starts``: the rows, offsets and
    other per-row values (``row_extra`` bytes a row, and the int8 scale) of
    every distinct block visited, once, and ``vec_bytes`` of (n,) vectors,
    over K."""
    rows, _ = F.coeff_rows_data()
    K = starts.shape[0]
    blocks = int(torch.unique(starts).numel())
    per_row = (rows.shape[1] * rows.element_size() + row_extra
               + 4 * (rows.dtype == torch.int8))
    return (blocks * B_ * per_row + vec_bytes + 4 * K) / K


def step_bound(F, starts, B_: int, vec_bytes: int, row_extra: int,
               flops: float = 4.0):
    """The bound per step of K block steps on ``starts``: step_bytes, and
    ``flops``·B·n operations a step (4: the margins and the innovation)."""
    rows, _ = F.coeff_rows_data()
    return bound(step_bytes(F, starts, B_, vec_bytes, row_extra),
                 flops * B_ * rows.shape[1], rows.element_size())


def kernel_inputs(F, gamma, gen, dev, B_: int, K: int, sag: bool,
                  weighted: bool):
    """A SAGA-like state and K block starts: z small and random, c its
    coefficients, av their mean row gradient."""
    from ciao_tpu_torch.solvers.saga import block_starts

    rows, cols = F.num_terms, F.dim
    z = 0.05 * torch.randn(cols, generator=gen, device=dev)
    c = F.coeff_all(z)
    av = F.apply_all(c) / rows
    seed = int(torch.randint(1 << 30, (1,), generator=gen, device=dev))
    starts = block_starts(seed, 1, K, rows // B_, B_, dev)
    sc = torch.tensor([rows, float(gamma), float(gamma) * LAM, 1.0 / B_,
                       1.0 / rows, 1.0 if sag else 0.0, 0.0, 0.0],
                      dtype=torch.float32, device=dev)
    wgts = (torch.rand(K, generator=gen, device=dev) * 1.5 + 0.5
            if weighted else None)
    return c, z, av, starts, sc, wgts


def compare(F, gamma, gen, dev, B_, K, sag, weighted, precision, tag,
            streamed=False, f=None):
    """A kernel and its plain version from one state on one schedule
    (kernel #4 with clamp count ``f`` when ``streamed``, else kernel #3);
    returns the largest absolute error of z and raises past the
    tolerances."""
    from ciao_tpu_torch.ops import fused_block as fb

    c, z, av, starts, sc, wgts = kernel_inputs(F, gamma, gen, dev, B_, K,
                                               sag, weighted)
    rows, offs = F.coeff_rows_data()
    if streamed:
        fns, kw = ((fb.saga_coeff_multistep_streamed,
                    fb.saga_coeff_multistep_streamed_ref), dict(f=f))
    else:
        fns, kw = (fb.saga_coeff_multistep, fb.saga_coeff_multistep_ref), {}
    outs = []
    for fn in fns:
        st = [c.clone(), z.clone(), av.clone()]
        fn(rows, offs, starts, *st, sc, B_, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts, **kw)
        outs.append(st)
    torch.cuda.synchronize()
    lowp = fb._lowp(rows, precision)
    errs = {}
    for name, kt, rt in zip(("c", "z", "av"), *outs):
        if not bool(torch.isfinite(kt).all()):
            raise AssertionError(f"{tag}: kernel {name} has non-finite values")
        err = float((kt - rt).abs().max())
        errs[name] = (err, err / max(float(rt.abs().max()), 1e-30))
    moved = float((outs[1][1] - z).abs().max())
    log(f"  {tag}: max|dz| kernel-plain {errs['z'][0]:.3e} "
        f"(rel {errs['z'][1]:.2e}), c rel {errs['c'][1]:.2e}, "
        f"av rel {errs['av'][1]:.2e}; z moved {moved:.3e}")
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move z")
    if errs["z"][1] > Z_TOL[lowp]:
        raise AssertionError(f"{tag}: z rel error {errs['z'][1]:.3e} > "
                             f"{Z_TOL[lowp]}")
    for name in ("c", "av"):
        if errs[name][1] > STATE_TOL[lowp]:
            raise AssertionError(f"{tag}: {name} rel error "
                                 f"{errs[name][1]:.3e} > {STATE_TOL[lowp]}")
    return errs["z"][0]


def masked_identity(F, gamma, gen, dev, B_, K, f, tag) -> None:
    """Kernel #4 clamped at f leaves c, z and av bit for bit as the first f
    steps alone leave them (a masked step writes nothing); f = 0 leaves
    the state as it was."""
    from ciao_tpu_torch.ops.fused_block import saga_coeff_multistep_streamed

    c, z, av, starts, sc, wgts = kernel_inputs(F, gamma, gen, dev, B_, K,
                                               False, True)
    rows, offs = F.coeff_rows_data()

    def run(st, wg, fc):
        out = [c.clone(), z.clone(), av.clone()]
        saga_coeff_multistep_streamed(rows, offs, st, *out, sc, B_,
                                      rs=F.coeff_rows_scale(), wgts=wg, f=fc)
        torch.cuda.synchronize()
        return out

    i32 = dict(dtype=torch.int32, device=dev)
    pairs = ((run(starts, wgts, torch.tensor([f], **i32)),
              run(starts[:f], wgts[:f], None)),
             (run(starts, wgts, torch.tensor([0], **i32)), [c, z, av]))
    for got, want in pairs:
        for name, a, b in zip(("c", "z", "av"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: masked steps changed {name}")
    log(f"  {tag}: steps k >= {f} masked: c, z, av bit-identical to the "
        f"state after step {f - 1}; f = 0 leaves the state as it was")


def phase_check(gen, dev) -> float:
    worst = 0.0
    s = SMALL
    for storage, precision in (("f32", "highest"), ("f32", "default"),
                               ("bf16", "highest"), ("int8", "highest")):
        F, gamma, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for sag in (False, True):
            for weighted in (False, True):
                tag = (f"N={s['N']} n={s['n']} B={s['B']} K={s['K']} "
                       f"{storage}/{precision} {'SAG' if sag else 'SAGA'}"
                       f"{' wgts' if weighted else ''}")
                worst = max(worst, compare(F, gamma, gen, dev, s["B"],
                                           s["K"], sag, weighted, precision,
                                           tag))
        del F
    # rows that are not whole 16-byte chunks: the one-value-at-a-time path
    for storage, cols in (("f32", 202), ("bf16", 200), ("int8", 200)):
        F, gamma, _ = lasso(gen, dev, s["N"], cols, storage)
        tag = f"N={s['N']} n={cols} B={s['B']} K={s['K']} {storage} SAGA"
        worst = max(worst, compare(F, gamma, gen, dev, s["B"], s["K"], False,
                                   True, "highest", tag))
        del F
    for storage in ("f32", "bf16", "int8"):
        F, gamma, _ = lasso(gen, dev, N, n, storage)
        tag = f"N={N} n={n} B={B} K={HEADLINE_K} {storage} SAGA"
        worst = max(worst, compare(F, gamma, gen, dev, B, HEADLINE_K, False,
                                   False, "highest", tag))
        del F
    for N_, n_, B_, K_, _ in LOOPLESS_EDGES:
        for storage in ("f32", "int8"):
            F, gamma, _ = lasso(gen, dev, N_, n_, storage)
            worst = max(worst, compare(
                F, gamma, gen, dev, B_, K_, False, True, "highest",
                f"#3 N={N_} n={n_} B={B_} K={K_} {storage} SAGA wgts"))
            del F
            torch.cuda.empty_cache()
    return worst


def phase_check_streamed(gen, dev) -> float:
    worst = 0.0
    s = SMALL_STREAM
    for storage, precision in (("f32", "highest"), ("f32", "default"),
                               ("bf16", "highest"), ("int8", "highest")):
        F, gamma, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for sag in (False, True):
            for weighted in (False, True):
                for f in (s["K"], s["f"]):
                    tag = (f"N={s['N']} n={s['n']} B={s['B']} K={s['K']} "
                           f"f={f} {storage}/{precision} "
                           f"{'SAG' if sag else 'SAGA'}"
                           f"{' wgts' if weighted else ''}")
                    fc = torch.tensor([f], dtype=torch.int32, device=dev)
                    worst = max(worst, compare(
                        F, gamma, gen, dev, s["B"], s["K"], sag, weighted,
                        precision, tag, streamed=True, f=fc))
        masked_identity(F, gamma, gen, dev, s["B"], s["K"], s["f"],
                        f"N={s['N']} K={s['K']} {storage}")
        del F
    for storage in ("f32", "int8"):
        F, gamma, _ = lasso(gen, dev, DEEP["N"], DEEP["n"], storage)
        tag = (f"N={DEEP['N']} n={DEEP['n']} B={DEEP['B']} K={DEEP_K} "
               f"{storage} SAGA")
        worst = max(worst, compare(F, gamma, gen, dev, DEEP["B"], DEEP_K,
                                   False, False, "highest", tag,
                                   streamed=True))
        del F
        torch.cuda.empty_cache()
    return worst


def run_headline(gen, dev, storage: str, kernel) -> dict:
    """saga_init, then 8 epochs of saga_run through the kernel's gate."""
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.ops import saga_multistep_available
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.saga import (
        LAUNCH_STEPS, SAGACfg, saga_init, saga_run,
    )

    F, gamma, _ = lasso(gen, dev, N, n, storage)
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    x0 = torch.zeros(n, device=dev)
    fused = saga_multistep_available(F, g, x0, B)
    if not fused:
        raise AssertionError(f"{storage}: the kernel's gate is closed")
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True,
                  fused=fused)
    st = saga_init(F, g, x0, gamma, 0, cfg)
    obj0 = float(objective(F, g, st.z))
    before = kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = saga_run(F, g, st, cfg, MAIN_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel.launches - before
    obj1 = float(objective(F, g, st.z))
    for name in ("s", "z", "av"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"{storage}: {name} has non-finite values")
    if launches != MAIN_STEPS // LAUNCH_STEPS:
        raise AssertionError(f"{storage}: {launches} kernel launches, "
                             f"expected {MAIN_STEPS // LAUNCH_STEPS}")
    if not (math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"{storage}: objective {obj0} -> {obj1}")
    if st.it != MAIN_STEPS + 1:
        raise AssertionError(f"{storage}: it = {st.it}")
    log(f"  headline {storage}: N={N} n={n} B={B} {MAIN_STEPS} steps in "
        f"{launches} launches, objective {obj0:.6e} -> {obj1:.6e}, "
        f"{dt * 1e3 / MAIN_STEPS:.4f} ms/step end to end (first run)")
    return dict(F=F, gamma=gamma)


def run_facade(dev, prob, F, kernel) -> None:
    """The SAGA facade, as a user calls it, on the planted Lasso."""
    import numpy as np

    from ciao_tpu_torch import SAGA, NormL1

    Np, batch, maxit = FACADE["N"], FACADE["batch"], FACADE["maxit"]
    gap0 = prob.cost(np.zeros(n)) - prob.f_star
    before = kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it = SAGA(maxit=maxit, block_sampling=True, batch=batch)(
        torch.zeros(n, device=dev), F=F, g=NormL1(prob.lam), L=prob.L)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel.launches - before
    gap1 = prob.cost(x.double().cpu().numpy()) - prob.f_star
    if launches != (maxit - 1) // 128:
        raise AssertionError(f"facade: {launches} kernel launches")
    if not (math.isfinite(gap1) and gap1 < gap0):
        raise AssertionError(f"facade: cost - f* {gap0} -> {gap1}")
    log(f"  facade SAGA(block_sampling=True, batch={batch}) on planted "
        f"make_lasso(N={Np}, n={n}, p={FACADE['p']}): cost - f* {gap0:.6e} -> "
        f"{gap1:.6e} (rel {gap1 / prob.f_star:.3e}) after {it - 1} steps "
        f"in {launches} launches, {dt:.3f} s")


class DeepProblem:
    """The planted deep-target Lasso of bench.py (``deep_target_10m``),
    built on the card from a seeded ``torch.Generator`` with its recipe:
    a unit dual vector y, random columns of which the first ``live`` are
    kept and capped so that |A_jᵀy| <= λ (= λ on the p largest), x* on
    those p columns with matching signs, b = A x* + y. f* = cost(x*) is
    exact up to the f32 rounding of b, so the gap needs no reference
    solver."""

    def __init__(self, gen, dev):
        Nd, nd, lam = DEEP["N"], DEEP["n"], DEEP["lam"]
        y = torch.rand(Nd, generator=gen, device=dev)
        y /= torch.linalg.vector_norm(y)
        mask = (torch.arange(nd, device=dev) < DEEP["live"]).float()
        A = torch.rand(Nd, nd, generator=gen, device=dev).mul_(2.0).sub_(1.0)
        A.mul_(mask)
        CTy = (y @ A).abs()
        pth = torch.sort(CTy).values[-DEEP["p"]]
        alpha = torch.where(mask > 0, torch.minimum(
            lam / torch.clamp(CTy, min=1e-30), lam / pth), 0.0)
        A.mul_(alpha)
        sgn = torch.sign(y @ A)
        xs = torch.where(CTy >= pth, torch.rand(nd, generator=gen, device=dev)
                         * (DEEP["rho"] / math.sqrt(DEEP["p"])) * sgn, 0.0)
        self.b = A @ xs + y
        # r* = A x* − b as computed: the f32 rounding of b is part of the
        # problem, and the gap's difference form uses this r*
        self.r_star = A @ xs - self.b
        self.A, self.xs, self.dev = A, xs, dev
        self.L = (A * A).sum(dim=1) * Nd
        self.xs64 = xs.double().cpu()
        self.f_star = (0.5 * float(self.r_star.double().square().sum())
                       + lam * float(self.xs64.abs().sum()))
        self.gamma = 1.0 / (3.0 * float(self.L.max()))

    def oracle(self, storage="f32"):
        from ciao_tpu_torch.oracles import LeastSquaresRows

        F = LeastSquaresRows(self.A, self.b, torch.tensor(
            float(DEEP["N"]), dtype=torch.float32, device=self.dev))
        return F if storage == "f32" else F.with_storage(storage)

    def prox(self):
        from ciao_tpu_torch.prox import NormL1

        return NormL1(torch.tensor(DEEP["lam"], dtype=torch.float32,
                                   device=self.dev))

    def gap_rel(self, z) -> float:
        """(cost(z) − f*)/f* in bench.py's difference form,
        ½‖u‖² + ⟨u, r*⟩ + λ(‖z‖₁ − ‖x*‖₁) with u = A(z − x*): b cancels
        exactly, the two sums run over chunks of 32,768 rows with two-sum
        carries on the card, and the L1 difference is f64 on the host."""
        from ciao_tpu_torch.solvers.polish import _two_sum

        C = 32_768
        dz = z - self.xs
        zero = torch.zeros((), device=self.dev)
        qhi = qlo = phi = plo = zero
        for i in range(0, DEEP["N"], C):
            u = self.A[i:i + C] @ dz
            qhi, qlo = _two_sum(qhi, qlo, 0.5 * (u @ u))
            phi, plo = _two_sum(phi, plo, u @ self.r_star[i:i + C])
        quad = float((qhi + qlo) + (phi + plo))
        l1 = DEEP["lam"] * (float(z.double().abs().sum().cpu())
                            - float(self.xs64.abs().sum()))
        return (quad + l1) / abs(self.f_star)

    def objective(self, F, g, z) -> float:
        return float(F.value_sum_all(z) / DEEP["N"] + g.value(z))


def run_deep(prob, storages, tag: str, card: str) -> float:
    """deep_solve on the deep target through the public call, with its
    checks: rel <= DEEP_REL, kernel #4 launched LAUNCH_STEPS-step launches
    over every epoch of the stochastic stage, kernel #3 never (the
    streamed route), a polish that ran, nothing NaN. Returns the rel gap.

    The solve's time is split by ``observe``, which deep_solve calls after
    every stochastic chunk and every polish round, each just after a host
    read of its own (the chunk's objective, the round's fp_res), so the
    sync it adds costs nothing: the stage ends at the last chunk's call,
    and the rest is the power bound and the polish rounds. The power
    bound is timed again alone after the solve."""
    from ciao_tpu_torch import deep_solve, power_lmax
    from ciao_tpu_torch.ops.fused_block import (
        saga_coeff_multistep, saga_coeff_multistep_streamed,
    )
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    F, g = prob.oracle(), prob.prox()
    k3, k4 = saga_coeff_multistep.launches, saga_coeff_multistep_streamed.launches
    marks = []

    def observe(_z):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = deep_solve(torch.zeros(DEEP["n"], device=prob.dev), F, g,
                         L=prob.L, N=DEEP["N"], storages=storages,
                         observe=observe, **DEEP_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d4 = saga_coeff_multistep_streamed.launches - k4
    want = sum(info.staged.epochs) * (DEEP["N"] // DEEP["B"]) // LAUNCH_STEPS
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{tag}: the solution has non-finite values")
    chunks = sum(info.staged.epochs) // DEEP_KW["chunk_epochs"]
    if len(marks) != chunks + len(info.fp_res):
        raise AssertionError(f"{tag}: {len(marks)} observe calls for "
                             f"{chunks} chunks and {len(info.fp_res)} rounds")
    stage, polish = marks[chunks - 1] - t0, marks[-1] - marks[chunks - 1]
    t1 = time.perf_counter()
    power_lmax(F, x, 1, iters=6)
    torch.cuda.synchronize()
    power = time.perf_counter() - t1
    rel = prob.gap_rel(x)
    log(f"  {tag}: storages {list(storages)}, epochs per stage "
        f"{info.staged.epochs} (plateau {info.staged.switched_early}), "
        f"objectives {['%.9e' % o for o in info.staged.objectives]}, "
        f"lmax {info.lmax:.6e}, eta {info.eta:.6e}, {info.polish_steps} "
        f"polish steps, fp_res {['%.3e' % r for r in info.fp_res]}; "
        f"rel {rel:.3e} in {dt:.3f} s: stochastic stage {stage:.3f} s "
        f"({chunks} chunks), power bound and {len(info.fp_res)} polish "
        f"rounds {polish:.3f} s, return {dt - (marks[-1] - t0):.4f} s; "
        f"power bound alone {power:.4f} s, so "
        f"{(polish - power) / info.polish_steps:.4f} s per polish step; "
        f"kernel #4 launches {d4} [{card}]")
    if not (math.isfinite(rel) and rel <= DEEP_REL):
        raise AssertionError(f"{tag}: rel {rel:.3e} > {DEEP_REL}")
    if d4 != want or saga_coeff_multistep.launches != k3:
        raise AssertionError(
            f"{tag}: kernel #4 launched {d4} times (expected {want}), "
            f"kernel #3 {saga_coeff_multistep.launches - k3} times")
    if info.polish_steps <= 0 or not all(map(math.isfinite, info.fp_res)):
        raise AssertionError(f"{tag}: the polish did not run: {info}")
    return rel


def run_importance(prob, card: str) -> None:
    """The SAGA facade with importance sampling on the deep target: the
    streamed route with the systematic schedule, whole 64-step windows
    through kernel #4 with weights (the wrapper's own counts), and a
    falling objective."""
    from ciao_tpu_torch import SAGA
    from ciao_tpu_torch.ops.fused_block import saga_coeff_multistep_streamed

    F, g = prob.oracle(), prob.prox()
    d = DEEP["N"] // DEEP["B"]
    steps = IMPORTANCE_EPOCHS * d
    solver = SAGA(maxit=steps + 1, block_sampling=True, batch=DEEP["B"],
                  importance_sampling=True)
    x0 = torch.zeros(DEEP["n"], device=prob.dev)
    cfg = solver._setup(x0, F, g, prob.L, DEEP["N"])[3]
    if not (cfg.importance and cfg.istrat and cfg.fused_stream
            and not cfg.fused):
        raise AssertionError(f"importance: not the streamed istrat route: "
                             f"{cfg}")
    kernel = saga_coeff_multistep_streamed
    K = min(cfg.iwin, d)
    windows = (1 + steps - K) // K  # steps before it = K are stepwise
    obj0 = prob.objective(F, g, x0)
    before = kernel.launches, kernel.weighted_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it = solver(x0, F=F, g=g, L=prob.L)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel.launches - before[0]
    weighted = kernel.weighted_launches - before[1]
    obj1 = prob.objective(F, g, x)
    log(f"  importance: SAGA(block_sampling=True, batch={DEEP['B']}, "
        f"importance_sampling=True), {steps} steps (iwin {cfg.iwin}): "
        f"{launches} launches of {K} steps, {weighted} of them weighted, "
        f"objective {obj0:.9e} -> {obj1:.9e}, rel {prob.gap_rel(x):.3e}, "
        f"{dt:.3f} s [{card}]")
    if not launches == weighted == windows:
        raise AssertionError(f"importance: {launches} launches, {weighted} "
                             f"weighted (expected {windows}, all weighted)")
    if not (math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"importance: objective {obj0} -> {obj1}")


def profile_deep_saga(prob, storage: str, card: str) -> None:
    """A profiled window of SAGA's streamed route on the deep target (two
    calls of LAUNCH_STEPS steps of kernel #4 through ``saga_run``), which
    fails unless every wrapper call was one launch of the persistent
    engine and no kernel of the two-launch engine ran."""
    from ciao_tpu_torch.solvers.saga import (
        LAUNCH_STEPS, SAGACfg, saga_init, saga_run,
    )

    F, g = prob.oracle(storage), prob.prox()
    cfg = SAGACfg(N=DEEP["N"], sag=False, batch=DEEP["B"], block=True,
                  coeff=True, fused_stream=True)
    st = saga_init(F, g, torch.zeros(DEEP["n"], device=prob.dev), prob.gamma,
                   0, cfg)
    steps = 2 * LAUNCH_STEPS
    profile_one_launch(f"SAGA at the deep target, {storage} rows",
                       lambda: saga_run(F, g, st, cfg, steps), steps, card,
                       SAGA_DEEP_GROUPS, "kernel #4",
                       "saga_coeff_multistep_streamed")


def profile_headline_saga(run: dict, storage: str, card: str) -> None:
    """A profiled window of SAGA at the headline (two calls of LAUNCH_STEPS
    steps of kernel #3 through ``saga_run``), which fails unless every
    wrapper call was one launch of the persistent engine and no kernel of
    the two-launch engine ran."""
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.saga import (
        LAUNCH_STEPS, SAGACfg, saga_init, saga_run,
    )

    F = run["F"]
    dev = F.coeff_rows_data()[0].device
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True,
                  fused=True)
    st = saga_init(F, g, torch.zeros(n, device=dev), run["gamma"], 0, cfg)
    steps = 2 * LAUNCH_STEPS
    profile_one_launch(f"SAGA at the headline, {storage} rows",
                       lambda: saga_run(F, g, st, cfg, steps), steps, card,
                       SAGA_GROUPS, "kernel #3", "saga_coeff_multistep")


def time_per_step(fn, F, gamma, gen, dev, B_: int, K: int,
                  reps: int) -> float:
    """(ms per step, the starts) of ``fn`` (kernel wrapper or plain
    version) at blocks of B_ rows of ``F``, by CUDA events over ``reps``
    calls of K steps after one warm-up call."""
    c, z, av, starts, sc, _ = kernel_inputs(F, gamma, gen, dev, B_, K, False,
                                            False)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    ms = time_events(lambda: fn(rows, offs, starts, c, z, av, sc, B_, rs=rs),
                     reps) / K
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("timed run gave non-finite z")
    return ms, starts


def check_close(tag, pairs, lowp, moved=None, slack=None):
    """Raise unless every (kernel, plain) output pair is finite and within
    STATE_TOL of the plain version's largest entry (plus ``slack[name]``,
    an absolute allowance, where given); returns the largest absolute
    error."""
    worst = 0.0
    rels = []
    for name, kt, rt in pairs:
        if not bool(torch.isfinite(kt).all()):
            raise AssertionError(f"{tag}: kernel {name} has non-finite values")
        err = float((kt - rt).abs().max())
        top = max(float(rt.abs().max()), 1e-30)
        rel = err / top
        rels.append(f"{name} rel {rel:.2e}")
        worst = max(worst, err)
        if err > STATE_TOL[lowp] * top + (slack or {}).get(name, 0.0):
            raise AssertionError(f"{tag}: {name} rel error {rel:.3e} > "
                                 f"{STATE_TOL[lowp]}")
    log(f"  {tag}: max abs err {worst:.3e} ({', '.join(rels)})"
        + ("" if moved is None else f"; moved {moved:.3e}"))
    return worst


def bf16_weight_slack(rows, z, rs, precision, kc, rc, kg, bound, tag):
    """(slack, rows) of the gsum check of kernels #6 and #7 where the dots
    round to bf16: the product weighs row i by c_i·rs_i rounded to bf16,
    and a c_i within the c tolerance of the plain one can round to the
    neighbouring bf16 value. One such row of int8 rows moved #7's gsum by
    2^-10 × 127.6 = 0.1246 (a weight in [1/8, 1/4) times the row's entry
    of 127) at N = 4,099, n = 4,096, squared hinge, on an H100. Where such
    rows exist, the kernel's gsum ``kg`` is held within ``bound`` to the
    plain product at the kernel's own c ``kc``, and the slack is what
    those rows can move any column by: their weights' difference times
    their largest entry. (0.0, 0) where the dots are exact or no weight
    differs."""
    from ciao_tpu_torch.ops import fused_block as fb

    if not fb._lowp(rows, precision):
        return 0.0, 0

    def weights(c):
        return fb._bf16_round(c if rs is None else c * rs)
    dw = (weights(kc) - weights(rc)).abs()
    flipped = dw > 0
    flips = int(flipped.sum())
    if not flips:
        return 0.0, 0
    A_f = fb._apply_margins_ref(rows, z, precision, rs)[0]
    own = fb._apply_gsum_ref(A_f, kc, rs, True,
                             fb._apply_rows(rows.shape[1],
                                            rows.element_size()))
    e_own = float((kg - own).abs().max())
    if e_own > bound:
        raise AssertionError(f"{tag}: gsum abs error {e_own} against the "
                             "plain product at the kernel's c")
    return float((dw[flipped] * A_f[flipped].abs().amax(dim=1)).sum()), flips


def compare_apply(F, z, sc, precision, tag):
    """Kernel #6 and its plain version on one input: c and gsum within
    STATE_TOL of their largest entries, gsum with the slack of rows whose
    bf16 weights a c within that tolerance puts a neighbour apart
    (:func:`bf16_weight_slack`)."""
    from ciao_tpu_torch.ops import fused_block as fb

    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    kc, kg = fb.coeff_apply_all(rows, offs, z, sc, precision=precision, rs=rs)
    rc, rg = fb.coeff_apply_all_ref(rows, offs, z, sc, precision=precision,
                                    rs=rs)
    torch.cuda.synchronize()
    lowp = fb._lowp(rows, precision)
    slack, flips = bf16_weight_slack(
        rows, z, rs, precision, kc, rc, kg,
        STATE_TOL[lowp] * max(float(rg.abs().max()), 1e-30), tag)
    if flips:
        tag += f" ({flips} rows' bf16 weights a neighbour apart)"
    return check_close(tag, (("c", kc, rc), ("gsum", kg, rg)), lowp,
                       slack={"gsum": slack})


def phase_check_apply(gen, dev) -> float:
    """Kernel #6 against its plain version: every mode through the scalars
    row, every storage and precision, at APPLY_SMALL and at the deep
    target's width n = 128 (tiles of 96-256 rows, the last one ragged);
    every mode at APPLY_WIDE; ragged N and widths that are not whole
    16-byte chunks; the adversarial
    compensated stream; a bit-for-bit repeat; the headline.
    The formula's scale is 1, so c and the gradient sum are O(1) to O(100)
    at the small shapes; at the headline the sum over 262,144 rows reaches
    O(1e4), and its absolute error grows with it (the checks are relative
    to the largest entry)."""
    from ciao_tpu_torch.ops import fused_block as fb

    worst = 0.0
    Ns, ns = APPLY_SMALL["N"], APPLY_SMALL["n"]
    for storage, precision in (("f32", "highest"), ("f32", "default"),
                               ("bf16", "highest"), ("int8", "highest")):
        F, _, _ = lasso(gen, dev, Ns, ns, storage)
        z = 0.05 * torch.randn(ns, generator=gen, device=dev)
        for mode in range(5):
            sc = torch.tensor([1.0, mode, 0.5], device=dev)
            worst = max(worst, compare_apply(
                F, z, sc, precision,
                f"N={Ns} n={ns} {storage}/{precision} mode {mode}"))
    Nw, nw = APPLY_NARROW["N"], APPLY_NARROW["n"]
    cases = [(s_, p_, Nw, nw) for s_, p_ in (
        ("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
        ("int8", "highest"))] + list(APPLY_WIDE)
    for storage, precision, Nw_, nw_ in cases:
        F, _, _ = lasso(gen, dev, Nw_, nw_, storage)
        z = walk_z(nw_, gen, dev)
        R = fb._apply_rows(nw_, F.coeff_rows_data()[0].element_size())
        for mode in range(5):
            sc = torch.tensor([1.0, mode, 0.5], device=dev)
            worst = max(worst, compare_apply(
                F, z, sc, precision, f"N={Nw_} n={nw_} {storage}/{precision}"
                f" mode {mode} (tiles of {R} rows)"))
    for storage, rows_, cols in (("f32", Ns - 1, 202), ("bf16", Ns, 200),
                                 ("int8", Ns - 5, 200)):
        F, _, _ = lasso(gen, dev, rows_, cols, storage)
        z = 0.05 * torch.randn(cols, generator=gen, device=dev)
        sc = torch.tensor([1.0, 0.0, 0.0], device=dev)
        worst = max(worst, compare_apply(F, z, sc, "highest",
                                         f"N={rows_} n={cols} {storage}"))
    # tests/test_ops.py:367: one tile of c = 2^18, then 1e-3; a plain f32
    # running sum loses the small rows in the big partial's ulp
    a = ADVERSARIAL
    A = torch.zeros(a["N"], a["n"], device=dev)
    A[:, 0] = 1.0
    b = torch.full((a["N"],), -1e-3, device=dev)
    b[:a["tile"]] = -(2.0 ** 18)
    sc = torch.tensor([1.0, 0.0, 0.0], device=dev)
    z = torch.zeros(a["n"], device=dev)
    _, g1 = fb.coeff_apply_all(A, b, z, sc)
    _, g2 = fb.coeff_apply_all(A, b, z, sc)
    torch.cuda.synchronize()
    exact = 2.0 ** 18 * a["tile"] + 1e-3 * (a["N"] - a["tile"])
    lost = 1e-3 * (a["N"] - a["tile"])
    err = abs(float(g1[0]) - exact)
    log(f"  adversarial N={a['N']} n={a['n']}: |gsum - exact| {err:.4f} "
        f"(bound 0.05 x lost = {0.05 * lost:.4f}); repeat bit for bit "
        f"{torch.equal(g1, g2)}")
    if not err < 0.05 * lost:
        raise AssertionError(f"adversarial: err {err} >= {0.05 * lost}")
    if not torch.equal(g1, g2):
        raise AssertionError("kernel #6 does not repeat bit for bit")
    del A, b
    for storage in ("f32", "bf16", "int8"):
        F, _, _ = lasso(gen, dev, N, n, storage)
        z = 0.05 * torch.randn(n, generator=gen, device=dev)
        sc = torch.tensor([1.0, 0.0, 0.0], device=dev)
        worst = max(worst, compare_apply(F, z, sc, "highest",
                                         f"N={N} n={n} {storage}"))
        del F
    return worst


def svrg_inputs(F, gamma, gen, dev, B_: int, K: int, lam: float):
    """An SVRG-like state and K block starts: the anchor z̃ small and
    random, its coefficients and mean gradient, w near z̃, zs zero, and
    the scalars row [scale, γ, γλ, 1/B, mode, aux]."""
    from ciao_tpu_torch.solvers.saga import block_starts

    rows, cols = F.num_terms, F.dim
    zt = 0.05 * torch.randn(cols, generator=gen, device=dev)
    canch = F.coeff_all(zt)
    av = F.apply_all(canch) / rows
    w = zt + 0.01 * torch.randn(cols, generator=gen, device=dev)
    seed = int(torch.randint(1 << 30, (1,), generator=gen, device=dev))
    starts = block_starts(seed, 1, K, rows // B_, B_, dev)
    sc = torch.tensor([rows, float(gamma), float(gamma) * lam, 1.0 / B_,
                       0.0, 0.0], dtype=torch.float32, device=dev)
    return canch, [w, torch.zeros_like(w)], av, starts, sc


def compare_svrg(F, gamma, gen, dev, B_, K, lam, precision, tag) -> float:
    """Kernel #5 and its plain version from one state on one schedule;
    returns the largest absolute error of w."""
    from ciao_tpu_torch.ops import fused_block as fb

    canch, state, av, starts, sc = svrg_inputs(F, gamma, gen, dev, B_, K, lam)
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (fb.svrg_coeff_multistep, fb.svrg_coeff_multistep_ref):
        st = [t.clone() for t in state]
        fn(rows, offs, starts, canch, *st, av, sc, B_, precision=precision,
           rs=F.coeff_rows_scale())
        outs.append(st)
    torch.cuda.synchronize()
    lowp = fb._lowp(rows, precision)
    moved = float((outs[1][0] - state[0]).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move w")
    (kw, kzs), (rw, rzs) = outs
    rel = float((kw - rw).abs().max()) / max(float(rw.abs().max()), 1e-30)
    if rel > Z_TOL[lowp]:
        raise AssertionError(f"{tag}: w rel error {rel:.3e} > {Z_TOL[lowp]}")
    check_close(tag, (("w", kw, rw), ("zs", kzs, rzs)), lowp, moved)
    return float((kw - rw).abs().max())


def phase_check_svrg(gen, dev) -> float:
    s = SVRG_SMALL
    worst = 0.0
    for storage, precision in (("f32", "highest"), ("f32", "default"),
                               ("bf16", "highest"), ("int8", "highest")):
        F, gamma, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for lam in (LAM, 0.0):
            tag = (f"N={s['N']} n={s['n']} B={s['B']} K={s['K']} "
                   f"{storage}/{precision} {'NormL1' if lam else 'Zero'}")
            worst = max(worst, compare_svrg(F, 0.3 * gamma, gen, dev, s["B"],
                                            s["K"], lam, precision, tag))
    for storage in ("f32", "bf16", "int8"):
        F, gamma, _ = lasso(gen, dev, N, n, storage)
        tag = f"N={N} n={n} B={B} K={HEADLINE_K} {storage} NormL1"
        worst = max(worst, compare_svrg(F, 0.3 * gamma, gen, dev, B,
                                        HEADLINE_K, LAM, "highest", tag))
        del F
    return worst


def run_svrg_headline(gen, dev, storage: str, card: str) -> dict:
    """svrg_init, then SVRG_OUTER outer steps of svrg_run at bench.py's
    svrg configuration, through both kernels; returns the ms per outer
    step and what phase 6 profiles again (the oracle, the prox, the
    moduli, the init state and the config)."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.svrg import SVRGCfg, svrg_init, svrg_run

    F, _, L = lasso(gen, dev, N, n, storage)
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    x0 = torch.zeros(n, device=dev)
    if not fb.svrg_multistep_available(F, g, x0, B):
        raise AssertionError(f"svrg {storage}: the kernel's gate is closed")
    cfg = SVRGCfg(N=N, plus=False, batch=B, block=True, fused=True)
    st0 = st = svrg_init(F, g, x0, 1.0 / (10.0 * float(L.max())), SVRG_M, 0,
                         cfg)
    obj0 = cost(F, g, st.z_full)
    k5, k6 = fb.svrg_coeff_multistep.launches, fb.coeff_apply_all.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = svrg_run(F, g, st, cfg, SVRG_OUTER)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d5 = fb.svrg_coeff_multistep.launches - k5
    d6 = fb.coeff_apply_all.launches - k6
    obj1 = cost(F, g, st.z_full)
    for name in ("z_full", "w", "av", "canch"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"svrg {storage}: {name} is not finite")
    if d5 != SVRG_OUTER or d6 != SVRG_OUTER:
        raise AssertionError(f"svrg {storage}: {d5} kernel #5 and {d6} "
                             f"kernel #6 launches, expected {SVRG_OUTER}")
    if not (math.isfinite(obj1) and obj1 < obj0) or st.it != SVRG_OUTER + 1:
        raise AssertionError(f"svrg {storage}: objective {obj0} -> {obj1}, "
                             f"it {st.it}")
    ms = dt * 1e3 / SVRG_OUTER
    log(f"  svrg headline {storage}: N={N} n={n} B={B} m={SVRG_M}, "
        f"{SVRG_OUTER} outer steps ({d5} kernel #5, {d6} kernel #6 "
        f"launches), objective {obj0:.6e} -> {obj1:.6e}, {ms:.4f} ms per "
        f"outer step end to end [{card}]")
    return dict(ms=ms, F=F, g=g, L=L, st=st0, cfg=cfg)


def facade_problem(dev, seed: int):
    """The facades' planted Lasso (FACADE) with its f32 oracle on the card."""
    from ciao_tpu_torch import LeastSquaresRows
    from ciao_tpu_torch.utils.problems import make_lasso

    Np = FACADE["N"]
    prob = make_lasso(N=Np, n=n, p=FACADE["p"], seed=seed,
                      well_conditioned=True)
    F = LeastSquaresRows(
        torch.tensor(prob.A, dtype=torch.float32, device=dev),
        torch.tensor(prob.b, dtype=torch.float32, device=dev), float(Np))
    return prob, F


def run_svrg_facades(dev, prob, F, card: str) -> None:
    """The SVRG facade, as a user calls it, in both modes on the planted
    Lasso: block sampling at batch 1,024 with m = N/batch, and SVRG++ from
    m = 1; each must bring cost − f* down FACADE_DROP-fold."""
    import numpy as np

    from ciao_tpu_torch import SVRG, NormL1
    from ciao_tpu_torch.ops import fused_block as fb

    gap0 = prob.cost(np.zeros(n)) - prob.f_star
    L_max = float(np.max(prob.L))
    for tag, kw in (("SVRG", SVRG_FACADE), ("SVRG++", SVRG_PLUS)):
        k5, k6 = fb.svrg_coeff_multistep.launches, fb.coeff_apply_all.launches
        solver = SVRG(maxit=kw["maxit"], gamma=1.0 / (kw["gamma_L"] * L_max),
                      m=kw["m"], plus=tag == "SVRG++", block_sampling=True,
                      batch=kw["batch"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it = solver(torch.zeros(n, device=dev), F=F, g=NormL1(prob.lam))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d5 = fb.svrg_coeff_multistep.launches - k5
        d6 = fb.coeff_apply_all.launches - k6
        gap1 = prob.cost(x.double().cpu().numpy()) - prob.f_star
        log(f"  facade {tag}(block_sampling=True, batch={kw['batch']}, "
            f"m={kw['m']}, maxit={kw['maxit']}, γ=1/({kw['gamma_L']}·L_max)) "
            f"on planted make_lasso(N={FACADE['N']}, n={n}): cost - f* "
            f"{gap0:.6e} -> {gap1:.6e} ({gap0 / gap1:.1f}-fold) after "
            f"{it - 1} outer steps, {d5} kernel #5 and {d6} kernel #6 "
            f"launches, {dt:.3f} s [{card}]")
        if not (math.isfinite(gap1) and gap0 / gap1 >= FACADE_DROP):
            raise AssertionError(f"facade {tag}: cost - f* {gap0} -> {gap1}")
        if d5 == 0 or d6 != it - 1:
            raise AssertionError(f"facade {tag}: {d5} kernel #5 and {d6} "
                                 f"kernel #6 launches for {it - 1} steps")


def run_fista(dev, F, g, L, steps: int, tag: str, card: str,
              gap=None) -> float:
    """FISTA(maxit=steps + 1) through the facade, γ = 1/mean(L): kernel #6
    once per step and a falling objective (or cost − f* through ``gap``);
    returns ms per step."""
    from ciao_tpu_torch import FISTA
    from ciao_tpu_torch.ops import fused_block as fb

    x0 = torch.zeros(F.dim, device=dev)
    before = fb.coeff_apply_all.launches
    obj0 = cost(F, g, x0) if gap is None else gap(x0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it = FISTA(maxit=steps + 1)(x0, F=F, g=g, L=L)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fb.coeff_apply_all.launches - before
    obj1 = cost(F, g, x) if gap is None else gap(x)
    ms = dt * 1e3 / steps
    what = "objective" if gap is None else "cost - f*"
    log(f"  FISTA {tag}: {steps} steps in {launches} kernel #6 launches, "
        f"{what} {obj0:.6e} -> {obj1:.6e}, {ms:.4f} ms per step end to end "
        f"[{card}]")
    if launches != steps or it != steps + 1:
        raise AssertionError(f"FISTA {tag}: {launches} kernel #6 launches "
                             f"for {steps} steps")
    if not (math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"FISTA {tag}: {what} {obj0} -> {obj1}")
    return ms


# kernels of a profiled window by name: the substrings of their launches
SVRG_GROUPS = {"kernel #6": ("apply_",),
               "kernel #5": ("loopless_steps_kernel",)}
SAGA_DEEP_GROUPS = {"kernel #4": ("loopless_steps_kernel",)}
SAGA_GROUPS = {"kernel #3": ("loopless_steps_kernel",)}
# profiled runs of a window before a trace that shows no device time, or
# (a kernel of the persistent engine) fewer launches than calls, is taken
# for a fault of the window and not for records the tracer dropped
PROFILE_TRIES = 3
# host seconds the profiled window stays open before and after the call:
# the tracer keeps only device events inside its window by its own clock,
# so a window that closes on the call's last event may lose edge events
PROFILE_MARGIN_S = 0.005


def profile_steps(tag: str, fn, steps: int, card: str,
                  groups=SVRG_GROUPS, unit: str = "step") -> dict:
    """One call of ``fn`` (``steps`` solver steps, or epochs: ``unit``) by
    the host clock, then once more under torch.profiler: ms per step, the
    device's busy time per step split by kernel (``groups``: label → name
    substrings), and the idle share 1 − busy/step; also the profiled call's
    kernel launches by group (``calls``), the names of its device events
    (``names``) and the calls of ``fn`` made in all (``runs``). A trace
    that shows no device time at all, though ``fn`` ran on the card, lost
    its records in the tracer (an H100 at 700 W gave one such trace of a
    window of two launches that another run traced whole): the call is
    profiled again, up to PROFILE_TRIES profiled calls in all. The window
    opens PROFILE_MARGIN_S before the call and closes as long after it;
    the idle share is taken against the host clock's unprofiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) * 1e3 / steps
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        split = dict.fromkeys([*groups, "other"], 0.0)
        calls = dict.fromkeys([*groups, "other"], 0)
        names = set()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            names.add(e.key)
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            key = next((k for k, subs in groups.items()
                        if any(sub in e.key for sub in subs)), "other")
            split[key] += us / 1e3 / steps
            calls[key] += e.count
        busy = sum(split.values())
        if busy > 0.0:
            break
        if attempt == PROFILE_TRIES:
            raise AssertionError(f"profile {tag}: {PROFILE_TRIES} traces "
                                 "show no device time")
        log(f"  profile {tag}: the trace shows no device time; profiling "
            f"the call again ({attempt + 1} of {PROFILE_TRIES})")
    log(f"  profiled {tag}: {step:.4f} ms per {unit} by the host clock; "
        f"device busy {busy:.4f} ms per {unit} ("
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"), idle share {1.0 - busy / step:.3f} [{card}]")
    return dict(step=step, busy=busy, **split, calls=calls, names=names,
                runs=2 + attempt)


def time_events(fn, reps: int) -> float:
    """ms per call of ``fn`` by CUDA events over ``reps`` calls after one
    warm-up call."""
    fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# the card's practical read ceiling: one torch.sum over 2 GiB of f32
CEILING_BYTES = 2 * 2**30


def read_ceiling(dev) -> float:
    """Bytes per second of one ``torch.sum`` over CEILING_BYTES of f32 on
    the card, the best of two turns of five calls: the ceiling a one-pass
    read can reach, beside which the passes' bounds are also given."""
    x = torch.ones(CEILING_BYTES // 4, device=dev)
    ms = min(time_events(lambda: x.sum(), 5) for _ in range(2))
    del x
    torch.cuda.empty_cache()
    return CEILING_BYTES / (ms * 1e-3)


def pass_bytes(rows, value: bool = False) -> int:
    """Bytes of one pass of kernel #6 (#7 with ``value``): A, b (and the
    int8 scales) read and c written once, z read and gsum written (and the
    value)."""
    N_, n_ = rows.shape
    return (N_ * (n_ * rows.element_size() + 8 + 4 * (rows.dtype
                                                      == torch.int8))
            + 8 * n_ + 12 + 4 * value)


def time_apply(gen, dev, storage: str, card: str, ceil: float) -> dict:
    """Kernel #6 per pass at the headline, in turns with its plain version
    (plain, kernel, kernel, plain), its bound, and the two-gemv yardstick
    (torch.mv for the margins, the formula, torch.mv for Σ c_i·a_i: two
    reads of A; f32 and bf16 rows only, torch.mv takes no int8)."""
    from ciao_tpu_torch.ops import fused_block as fb

    F, _, _ = lasso(gen, dev, N, n, storage)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    scale = float(N)
    sc = torch.tensor([scale, 0.0, 0.0], device=dev)

    def kernel():
        fb.coeff_apply_all(rows, offs, z, sc, rs=rs)

    def plain():
        fb.coeff_apply_all_ref(rows, offs, z, sc, rs=rs)

    def two_gemv():
        m = torch.mv(rows, z.to(rows.dtype)).float()
        c = scale * (m - offs)
        return torch.mv(rows.t(), c.to(rows.dtype))

    pl = [time_events(plain, 2)]
    kern = [time_events(kernel, 20) for _ in range(2)]
    pl.append(time_events(plain, 2))
    lib = None if storage == "int8" else time_events(two_gemv, 20)
    isz = rows.element_size()
    nbytes = pass_bytes(rows)
    b_ms, b_by = bound(nbytes, 4.0 * N * n, isz)
    ceil_ms = nbytes / ceil * 1e3
    log(f"  kernel #6, {storage} rows, N={N} n={n}: kernel "
        f"{kern[0]:.4f}/{kern[1]:.4f} ms per pass, plain version "
        f"{pl[0]:.4f}/{pl[1]:.4f}, bound {b_ms:.4f} ({b_by}: "
        f"{nbytes / 2**20:.1f} MiB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), "
        f"{ceil_ms:.4f} at the read ceiling ({ceil / 1e9:.0f} GB/s), "
        f"two-gemv yardstick "
        f"{'none' if lib is None else f'{lib:.4f}'} [{card}]")
    return dict(ms=sum(kern) / 2, plain_ms=sum(pl) / 2, bound_ms=b_ms,
                bound_by=b_by, ceil_ms=ceil_ms, two_gemv_ms=lib)


def time_walk(rows, offs, z, sc, rs, reps: int = 20) -> dict:
    """Kernels #6 and #7 on one input, each in turns with its plain version
    (plain #6, #6, #7, #6, #7, plain #7; ``reps`` passes a kernel turn, two
    a plain one): {"#6": {"kernel": [ms, ms], "plain": [ms]}, "#7": ...},
    ms per pass by CUDA events. Also times the walk of another checkout's
    package (tools/apply_walk_times.py)."""
    from ciao_tpu_torch.ops import fused_block as fb

    runs = {"#6": (fb.coeff_apply_all, fb.coeff_apply_all_ref),
            "#7": (fb.coeff_value_apply_all, fb.coeff_value_apply_all_ref)}

    def one(fn):
        return lambda: fn(rows, offs, z, sc, rs=rs)

    out = {k: dict(kernel=[], plain=[]) for k in runs}
    out["#6"]["plain"].append(time_events(one(runs["#6"][1]), 2))
    for _ in range(2):
        for k, (fn, _) in runs.items():
            out[k]["kernel"].append(time_events(one(fn), reps))
    out["#7"]["plain"].append(time_events(one(runs["#7"][1]), 2))
    return out


def time_apply_deep(prob, gen, dev, storage: str, card: str,
                    ceil: float) -> dict:
    """Kernels #6 and #7 per pass on the deep target's rows (10,485,760 x
    128, least squares, scale N): first held against their plain versions
    (compare_value_apply: #7's value, c and gsum at VALUE_TOL, C_TOL and
    GSUM_TOL, repeats, #6's c and gsum #7's to the bit), then timed by
    time_walk, with the bound at 3.35 TB/s and at the read ceiling
    ``ceil``, and for f32 rows the two-gemv yardstick (torch.mv takes no
    int8). Returns {"#6": ..., "#7": ..., "err": the largest absolute error
    of c and gsum}."""
    F = prob.oracle(storage)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    Nd, nd = rows.shape
    z = 0.05 * torch.randn(nd, generator=gen, device=dev)
    scale = float(Nd)
    sc = torch.tensor([scale, 0.0, 0.0], device=dev)
    err = compare_value_apply(rows, offs, z, sc, "highest", rs,
                              f"N={Nd} n={nd} {storage} (deep target)")
    t = time_walk(rows, offs, z, sc, rs)

    def two_gemv():
        m = torch.mv(rows, z)
        return torch.mv(rows.t(), scale * (m - offs))

    lib = None if storage == "int8" else time_events(two_gemv, 20)
    out = {"err": err}
    for k, tk in t.items():
        kern, pl = tk["kernel"], tk["plain"]
        nbytes = pass_bytes(rows, value=k == "#7")
        b_ms, b_by = bound(nbytes, 4.0 * Nd * nd, rows.element_size())
        out[k] = dict(ms=sum(kern) / 2, plain_ms=pl[0], bound_ms=b_ms,
                      bound_by=b_by, ceil_ms=nbytes / ceil * 1e3,
                      two_gemv_ms=lib)
        log(f"  kernel {k}, {storage} rows, N={Nd} n={nd} (deep target): "
            f"kernel {kern[0]:.4f}/{kern[1]:.4f} ms per pass, plain "
            f"version {pl[0]:.4f}, bound {b_ms:.4f} ({b_by}: "
            f"{nbytes / 2**20:.1f} MiB at {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s), {out[k]['ceil_ms']:.4f} at the read ceiling "
            f"({ceil / 1e9:.0f} GB/s), two-gemv yardstick "
            f"{'none' if lib is None else f'{lib:.4f}'} [{card}]")
    return out


def time_svrg(gen, dev, storage: str, card: str) -> dict:
    """Kernel #5 per inner step at the headline (LAUNCH_STEPS-step calls),
    in turns with its plain version, and its bound."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    F, gamma, _ = lasso(gen, dev, N, n, storage)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    canch, (w, zs), av, starts, sc = svrg_inputs(
        F, 0.3 * gamma, gen, dev, B, LAUNCH_STEPS, LAM)

    def run(fn):
        def call():
            fn(rows, offs, starts, canch, w, zs, av, sc, B, rs=rs)
            return LAUNCH_STEPS
        return call

    # rows, b and canch of the visited blocks; w, zs in and out, av
    times = time_turns(run(fb.svrg_coeff_multistep),
                       run(fb.svrg_coeff_multistep_ref),
                       f"kernel #5, {storage} rows, N={N} n={n} B={B}", card,
                       step_bound(F, starts, B, 5 * 4 * n, 8))
    if not bool(torch.isfinite(w).all()):
        raise AssertionError("timed kernel #5 run gave non-finite w")
    return times


# ---------------------------------------------------------------------------
# the Finito family: kernels #9, #14, #8, #2
# ---------------------------------------------------------------------------

def soft(v, thr):
    return torch.sign(v) * torch.clamp(v.abs() - thr, min=0.0)


def finito_inputs(F, gen, dev, B_: int, K: int, lam: float,
                  distinct=False) -> dict:
    """A Finito coefficient state on the card: γ_i ≈ 0.999/‖a_i‖² of
    Gaussian rows (α·N/L_i with L_i = N‖a_i‖², drawn around n), c at a
    point x0, per-block anchors zb near it, av of the identity
    hat·(invg @ zb − Σ c_i a_i/N), z = soft(av, hat·λ); K block ids
    (repeats included unless ``distinct``)."""
    rows_, cols = F.num_terms, F.dim
    d = rows_ // B_
    gamma = 0.999 / (cols * (0.8 + 0.4 * torch.rand(
        rows_, generator=gen, device=dev)))
    invg = (1.0 / gamma).reshape(d, B_).sum(1)
    hat = float(1.0 / (1.0 / gamma).sum())
    x0 = 0.05 * torch.randn(cols, generator=gen, device=dev)
    zb = x0 + 0.01 * torch.randn(d, cols, generator=gen, device=dev)
    c = F.coeff_all(x0)
    av = hat * (invg @ zb) - hat / rows_ * F.apply_all(c)
    blocks = (torch.randperm(d, generator=gen, device=dev)[:K] if distinct
              else torch.randint(d, (K,), generator=gen, device=dev))
    return dict(gamma=gamma, invg=invg, hat=hat,
                state=(c, zb, soft(av, hat * lam), av),
                starts=(blocks * B_).to(torch.int32),
                sc=torch.tensor([rows_, 1.0 / rows_, hat, hat * lam, 0.0,
                                 0.0], device=dev))


def run_finito_kernel(fn, F, S, B_, precision="highest", f=None,
                      starts=None, state=None):
    """Kernel #9 or #14 (or a plain version; #14's calling convention for
    the streamed functions) on ``state`` in place, by default a copy of
    S's state; returns the state."""
    from ciao_tpu_torch.ops import fused_block as fb

    rows, offs = F.coeff_rows_data()
    starts = S["starts"] if starts is None else starts
    c, zb, z, av = (state if state is not None
                    else [t.clone() for t in S["state"]])
    if fn in (fb.finito_coeff_multistep_streamed,
              fb.finito_coeff_multistep_streamed_ref):
        fn(rows, offs, starts, S["invg"][starts.long() // B_], c, zb, z, av,
           S["sc"], B_, precision=precision, rs=F.coeff_rows_scale(), f=f)
    else:
        fn(rows, offs, starts, c, zb, S["invg"], z, av, S["sc"], B_,
           precision=precision, rs=F.coeff_rows_scale())
    return [c, zb, z, av]


def compare_finito(F, gen, dev, B_, K, lam, precision, tag, streamed=False,
                   f=None, distinct=None) -> float:
    """Kernel #9 (or #14 with clamp count ``f``) against its plain version
    from one state on one schedule (distinct blocks, by default for #14
    alone): z within Z_TOL of its largest entry, c, zb and av within
    STATE_TOL; returns the largest |dz|."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = finito_inputs(F, gen, dev, B_, K, lam,
                      distinct=streamed if distinct is None else distinct)
    fns = ((fb.finito_coeff_multistep_streamed,
            fb.finito_coeff_multistep_streamed_ref) if streamed else
           (fb.finito_coeff_multistep, fb.finito_coeff_multistep_ref))
    kern, ref = (run_finito_kernel(fn, F, S, B_, precision, f) for fn in fns)
    torch.cuda.synchronize()
    lowp = fb._lowp(F.coeff_rows_data()[0], precision)
    moved = float((ref[2] - S["state"][2]).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move z")
    rel = float((kern[2] - ref[2]).abs().max()) / max(
        float(ref[2].abs().max()), 1e-30)
    if rel > Z_TOL[lowp]:
        raise AssertionError(f"{tag}: z rel error {rel:.3e} > {Z_TOL[lowp]}")
    check_close(tag, list(zip(("c", "zb", "z", "av"), kern, ref)), lowp,
                moved)
    return float((kern[2] - ref[2]).abs().max())


def finito_masked_identity(F, gen, dev, B_, K, f, tag) -> None:
    """Kernel #14 clamped at f leaves c, zb, z and av bit for bit as the
    first f steps alone leave them; f = 0 leaves the state as it was."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = finito_inputs(F, gen, dev, B_, K, LAM, distinct=True)
    kern = fb.finito_coeff_multistep_streamed
    i32 = dict(dtype=torch.int32, device=dev)
    pairs = ((run_finito_kernel(kern, F, S, B_, f=torch.tensor([f], **i32)),
              run_finito_kernel(kern, F, S, B_, starts=S["starts"][:f])),
             (run_finito_kernel(kern, F, S, B_, f=torch.tensor([0], **i32)),
              list(S["state"])))
    torch.cuda.synchronize()
    for got, want in pairs:
        for name, a, b in zip(("c", "zb", "z", "av"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: masked steps changed {name}")
    log(f"  {tag}: steps k >= {f} masked: c, zb, z, av bit-identical to the "
        f"state after step {f - 1}; f = 0 leaves the state as it was")


def lfinito_inputs(F, gen, dev, B_, K, lam) -> dict:
    """An LFinito epoch's start: the anchor z_full = soft(av) of a Finito
    state, its coefficients, av = z_full − hat·Σ c_i a_i/N, K distinct
    blocks in visit order, their Σ 1/γ_i and the scalars row [scale, hat,
    hat·λ, 1/N, mode, aux]."""
    S = finito_inputs(F, gen, dev, B_, K, lam, distinct=True)
    rows_ = F.num_terms
    zf = S["state"][2]
    canch = F.coeff_all(zf)
    hat = S["hat"]
    return dict(zf=zf, canch=canch, av=zf - hat / rows_ * F.apply_all(canch),
                starts=S["starts"], hat=hat, lam=lam,
                invg_v=S["invg"][S["starts"].long() // B_].contiguous(),
                sc=torch.tensor([rows_, hat, hat * lam, 1.0 / rows_, 0.0,
                                 0.0], device=dev))


def compare_lfinito(F, gen, dev, B_, K, lam, precision, tag) -> float:
    """Kernel #8 against its plain version on one sweep of K blocks: the
    returned z (the last block's prox point, which differs from soft of
    the returned av) within Z_TOL, av within STATE_TOL; returns |dz|."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = lfinito_inputs(F, gen, dev, B_, K, lam)
    rows, offs = F.coeff_rows_data()
    outs = [fn(rows, offs, S["canch"], S["starts"], S["av"].clone(), S["zf"],
               S["invg_v"], S["sc"], B_, precision=precision,
               rs=F.coeff_rows_scale())
            for fn in (fb.lfinito_sweep_multistep,
                       fb.lfinito_sweep_multistep_ref)]
    torch.cuda.synchronize()
    (kav, kz), (rav, rz) = outs
    lowp = fb._lowp(rows, precision)
    rel = float((kz - rz).abs().max()) / max(float(rz.abs().max()), 1e-30)
    if rel > Z_TOL[lowp]:
        raise AssertionError(f"{tag}: z rel error {rel:.3e} > {Z_TOL[lowp]}")
    if lam and torch.equal(kz, soft(kav, S["hat"] * lam)):
        raise AssertionError(f"{tag}: z is soft(av_out), not the last "
                             "block's prox point")
    check_close(tag, (("av", kav, rav), ("z", kz, rz)), lowp,
                float((rav - S["av"]).abs().max()))
    return float((kz - rz).abs().max())


def compare_block(F, gen, dev, B_, precision, tag) -> float:
    """Kernel #2 against its plain version on one block (its start a
    device tensor): the block's table rows within Z_TOL of their largest
    entry, the innovation within STATE_TOL, every other row bit for bit
    as it was; returns the largest error of the block's rows."""
    from ciao_tpu_torch.ops import fused_block as fb

    rows, offs = F.coeff_rows_data()
    rows_, cols = rows.shape
    s = torch.randn(rows_, cols, generator=gen, device=dev)
    z = 0.05 * torch.randn(cols, generator=gen, device=dev)
    gamma = 0.999 / (cols * (0.8 + 0.4 * torch.rand(
        rows_, generator=gen, device=dev)))
    start = torch.randint(rows_ // B_, (), generator=gen, device=dev) * B_
    sc = torch.tensor([rows_, 1.0 / rows_, 0.37], device=dev)
    ks, kin = fb.finito_block_update(rows, offs, s.clone(), gamma, z, start,
                                     sc, B_, precision=precision)
    rs_, rin = fb.finito_block_update_ref(rows, offs, s.clone(), gamma, z,
                                          start, sc, B_, precision=precision)
    torch.cuda.synchronize()
    lo = int(start)
    blk = slice(lo, lo + B_)
    if not (torch.equal(ks[:lo], s[:lo]) and torch.equal(ks[lo + B_:],
                                                         s[lo + B_:])):
        raise AssertionError(f"{tag}: rows outside the block changed")
    lowp = precision == "default"
    rel = float((ks[blk] - rs_[blk]).abs().max()) / float(
        rs_[blk].abs().max())
    if rel > Z_TOL[lowp]:
        raise AssertionError(f"{tag}: s rel error {rel:.3e} > {Z_TOL[lowp]}")
    check_close(tag + ", rows outside the block bit for bit",
                (("s", ks[blk], rs_[blk]), ("innov", kin, rin)), lowp)
    return float((ks[blk] - rs_[blk]).abs().max())


STORAGES = (("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
            ("int8", "highest"))


def phase_check_finito(gen, dev) -> float:
    """3e: kernel #9 at SMALL across storages, precisions and proxes
    (repeated blocks), K = 8 at the headline, and f32 and int8 rows at the
    persistent engine's edges (LOOPLESS_EDGES)."""
    s, worst = SMALL, 0.0
    for storage, precision in STORAGES:
        F, _, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for lam in (LAM, 0.0):
            tag = (f"N={s['N']} n={s['n']} B={s['B']} K={s['K']} "
                   f"{storage}/{precision} {'NormL1' if lam else 'Zero'}")
            worst = max(worst, compare_finito(F, gen, dev, s["B"], s["K"],
                                              lam, precision, tag))
    for storage in ("f32", "bf16", "int8"):
        F, _, _ = lasso(gen, dev, N, n, storage)
        worst = max(worst, compare_finito(
            F, gen, dev, B, HEADLINE_K, LAM, "highest",
            f"N={N} n={n} B={B} K={HEADLINE_K} {storage} NormL1"))
        del F
    for N_, n_, B_, K_, _ in LOOPLESS_EDGES:
        for storage in ("f32", "int8"):
            F, _, _ = lasso(gen, dev, N_, n_, storage)
            worst = max(worst, compare_finito(
                F, gen, dev, B_, K_, LAM, "highest",
                f"#9 N={N_} n={n_} B={B_} K={K_} {storage}"))
            del F
            torch.cuda.empty_cache()
    return worst


def phase_check_finito_small(gen, dev):
    """3f and 3g at SMALL_STREAM (d = 64): kernel #14 with f = K and f =
    23, masked steps bit for bit, and at the persistent engine's edges
    (LOOPLESS_EDGES, f32 and int8 rows, blocks revisited); kernel #8 over a
    whole shuffled sweep of the 64 blocks, and over a whole sweep at the
    edges. Returns the two largest errors."""
    s = SMALL_STREAM
    w14 = w8 = 0.0
    for storage, precision in STORAGES:
        F, _, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for f in (s["K"], s["f"]):
            fc = torch.tensor([f], dtype=torch.int32, device=dev)
            w14 = max(w14, compare_finito(
                F, gen, dev, s["B"], s["K"], LAM, precision,
                f"#14 N={s['N']} n={s['n']} B={s['B']} K={s['K']} f={f} "
                f"{storage}/{precision}", streamed=True, f=fc))
        finito_masked_identity(F, gen, dev, s["B"], s["K"], s["f"],
                               f"#14 N={s['N']} K={s['K']} {storage}")
        d = s["N"] // s["B"]
        for lam in (LAM, 0.0):
            w8 = max(w8, compare_lfinito(
                F, gen, dev, s["B"], d, lam, precision,
                f"#8 sweep of d={d} blocks, N={s['N']} n={s['n']} "
                f"{storage}/{precision} {'NormL1' if lam else 'Zero'}"))
    for N_, n_, B_, K_, _ in LOOPLESS_EDGES:
        for storage in ("f32", "int8"):
            F, _, _ = lasso(gen, dev, N_, n_, storage)
            w14 = max(w14, compare_finito(
                F, gen, dev, B_, K_, LAM, "highest",
                f"#14 N={N_} n={n_} B={B_} K={K_} {storage} (revisits)",
                streamed=True, distinct=False))
            d = N_ // B_
            w8 = max(w8, compare_lfinito(
                F, gen, dev, B_, d, LAM, "highest",
                f"#8 sweep of d={d} blocks, N={N_} n={n_} B={B_} "
                f"{storage}"))
            del F
            torch.cuda.empty_cache()
    return w14, w8


def phase_check_block(gen, dev) -> float:
    """3h: kernel #2, f32 and bf16 rows at SMALL and at the headline."""
    worst = 0.0
    for rows_, cols, B_ in ((SMALL["N"], SMALL["n"], SMALL["B"]), (N, n, B)):
        for storage in ("f32", "bf16"):
            F, _, _ = lasso(gen, dev, rows_, cols, storage)
            for precision in ("highest", "default"):
                worst = max(worst, compare_block(
                    F, gen, dev, B_, precision,
                    f"#2 N={rows_} n={cols} B={B_} {storage}/{precision}"))
            del F
            torch.cuda.empty_cache()
    return worst


def run_finito_headline(gen, dev, storage: str, card: str) -> dict:
    """finito_coeff_init, then FINITO_EPOCHS epochs of finito_run at
    bench.py's finito configuration through kernel #9; returns the ms per
    step and what phase 7 profiles again."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.finito import (
        FinitoCfg, _resident, finito_coeff_init, finito_run,
    )
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    F, _, L = lasso(gen, dev, N, n, storage)
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    x0 = torch.zeros(n, device=dev)
    if not (fb.finito_multistep_available(F, g, x0, B) and _resident(N, n, B)):
        raise AssertionError(f"finito {storage}: not kernel #9's route")
    cfg = FinitoCfg(N=N, batch=B, sweeping=3, alpha=0.999, fused=True)
    st0 = finito_coeff_init(F, g, x0, 0.999 * N / L, 0, cfg)
    steps = FINITO_EPOCHS * EPOCH_STEPS
    obj0 = cost(F, g, st0.z)
    k9 = fb.finito_coeff_multistep.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = finito_run(F, g, st0, cfg, "basic_coeff", steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d9 = fb.finito_coeff_multistep.launches - k9
    obj1 = cost(F, g, st.z)
    for name in ("c", "zb", "z", "av"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            raise AssertionError(f"finito {storage}: {name} is not finite")
    if d9 != steps // LAUNCH_STEPS or st.it != steps + 1:
        raise AssertionError(f"finito {storage}: {d9} kernel #9 launches, "
                             f"it {st.it}")
    if not (math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"finito {storage}: objective {obj0} -> {obj1}")
    ms = dt * 1e3 / steps
    log(f"  finito headline {storage}: N={N} n={n} B={B} sweeping=3, "
        f"{FINITO_EPOCHS} epochs = {steps} steps in {d9} kernel #9 launches, "
        f"objective {obj0:.6e} -> {obj1:.6e}, {ms:.4f} ms/step end to end "
        f"[{card}]")
    return dict(ms=ms, F=F, g=g, st=st0, cfg=cfg)


def run_finito_facades(dev, prob, F, seed: int, card: str) -> None:
    """The Finito facade, as a user calls it, on the planted Lasso: the
    coefficient table (kernel #9) and the full table (kernel #2); adaptive
    Finito on a small planted Lasso, with no kernel. Each brings cost − f*
    down by its stated bar (``drop``)."""
    import numpy as np

    from ciao_tpu_torch import Finito, LeastSquaresRows, NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    def gap(p, x):
        return p.cost(x.double().cpu().numpy()) - p.f_star

    small = make_lasso(N=ADAPTIVE["N"], n=ADAPTIVE["n"], p=ADAPTIVE["p"],
                       seed=seed, well_conditioned=True)
    Fs = LeastSquaresRows(
        torch.tensor(small.A, dtype=torch.float32, device=dev),
        torch.tensor(small.b, dtype=torch.float32, device=dev),
        float(ADAPTIVE["N"]))
    cases = (("Finito(sweeping=3)", prob, F, n,
              dict(sweeping=3, minibatch=(True, FINITO_FACADE["batch"]),
                   maxit=FINITO_FACADE["maxit"]),
              "finito_coeff_multistep", FINITO_FACADE["drop"]),
             ("Finito(table='full', sweeping=2)", prob, F, n,
              dict(sweeping=2, table="full",
                   minibatch=(True, FULL_FACADE["batch"]),
                   maxit=FULL_FACADE["maxit"]),
              "finito_block_update", FULL_FACADE["drop"]),
             ("Finito(adaptive=True, sweeping=2)", small, Fs, ADAPTIVE["n"],
              dict(sweeping=2, adaptive=True, maxit=ADAPTIVE["maxit"]),
              None, ADAPTIVE["drop"]))
    for tag, p, Fp, cols, kw, kernel, drop in cases:
        before = counts()
        gap0 = p.cost(np.zeros(cols)) - p.f_star
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it = Finito(**kw)(torch.zeros(cols, device=dev), F=Fp,
                             g=NormL1(p.lam), L=p.L)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        moved = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        gap1 = gap(p, x)
        log(f"  facade {tag}, batch {kw.get('minibatch', (0, 1))[1]}, "
            f"maxit {kw['maxit']}, on planted make_lasso(N={p.A.shape[0]}, "
            f"n={cols}): cost - f* {gap0:.6e} -> {gap1:.6e} "
            f"({gap0 / gap1:.1f}-fold), launches {moved}, {dt:.3f} s [{card}]")
        if not (math.isfinite(gap1) and gap0 / gap1 >= drop):
            raise AssertionError(f"facade {tag}: cost - f* {gap0} -> {gap1}")
        want = {} if kernel is None else {kernel: (
            it - 1 if kernel == "finito_block_update" else -(-(it - 1) // 128))}
        if moved != want:
            raise AssertionError(f"facade {tag}: launches {moved}, "
                                 f"expected {want}")


def run_deep_finito(prob, card: str) -> dict:
    """4g on the deep target: streamed Finito (kernel #14) for
    DEEP_FINITO_EPOCHS epochs at f32 and int8 rows, importance-sampled
    Finito through the facade on the streamed route, and LFinito
    (kernels #6 and #8) at f32 and int8 rows: one warm-up epoch, then
    LFINITO_EPOCHS timed. Every objective falls. Returns LFinito's ms per
    epoch and what 4g's block profiles again (LFinito's by storage,
    streamed Finito's by ("stream", storage))."""
    from ciao_tpu_torch import Finito
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.finito import (
        FinitoCfg, _resident, finito_coeff_init, finito_run, lfinito_init,
    )
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    Nd, nd, Bd = DEEP["N"], DEEP["n"], DEEP["B"]
    d = Nd // Bd
    x0 = torch.zeros(nd, device=prob.dev)
    gamma = 0.999 * Nd / prob.L
    g = prob.prox()
    obj0 = prob.objective(prob.oracle(), g, x0)
    out = {}
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        if not fb.finito_multistep_streamed_available(F, g, x0, Bd) or \
                _resident(Nd, nd, Bd):
            raise AssertionError("deep finito: not kernel #14's route")
        cfg = FinitoCfg(N=Nd, batch=Bd, sweeping=3, alpha=0.999,
                        fused_stream=True)
        steps = DEEP_FINITO_EPOCHS * d
        k14 = fb.finito_coeff_multistep_streamed.launches
        st = finito_coeff_init(F, g, x0, gamma, 0, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = finito_run(F, g, st, cfg, "basic_coeff", steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d14 = fb.finito_coeff_multistep_streamed.launches - k14
        obj1 = prob.objective(F, g, st.z)
        log(f"  deep streamed Finito {storage}: {DEEP_FINITO_EPOCHS} epochs = "
            f"{steps} steps in {d14} kernel #14 launches, objective "
            f"{obj0:.9e} -> {obj1:.9e}, rel {prob.gap_rel(st.z):.3e}, "
            f"{dt * 1e3 / steps:.4f} ms/step [{card}]")
        if d14 != -(-steps // LAUNCH_STEPS) or not (
                math.isfinite(obj1) and obj1 < obj0):
            raise AssertionError(f"deep finito {storage}: {d14} launches, "
                                 f"objective {obj0} -> {obj1}")
        out["stream", storage] = dict(F=F, g=g, st=st, cfg=cfg)
    F = prob.oracle()
    steps = DEEP_FINITO_EPOCHS * d
    solver = Finito(maxit=steps + 1, sweeping=1, minibatch=(True, Bd),
                    importance_sampling=True)
    cfg = solver._setup(x0, F, g, prob.L, Nd)[3]
    if not (cfg.importance and cfg.fused_stream and not cfg.fused):
        raise AssertionError(f"deep importance: not the streamed route {cfg}")
    k14 = fb.finito_coeff_multistep_streamed.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _ = solver(x0, F=F, g=g, L=prob.L)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d14 = fb.finito_coeff_multistep_streamed.launches - k14
    obj1 = prob.objective(F, g, x)
    log(f"  deep Finito(importance_sampling=True, sweeping=1, batch={Bd}): "
        f"{steps} steps in {d14} kernel #14 launches, objective {obj0:.9e} "
        f"-> {obj1:.9e}, {dt:.3f} s [{card}]")
    if d14 != -(-steps // LAUNCH_STEPS) or not (math.isfinite(obj1)
                                                and obj1 < obj0):
        raise AssertionError(f"deep importance: {d14} launches, objective "
                             f"{obj0} -> {obj1}")
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        if not fb.lfinito_sweep_available(F, g, x0, Bd):
            raise AssertionError("deep lfinito: the kernels' gate is closed")
        cfg = FinitoCfg(N=Nd, batch=Bd, sweeping=3, alpha=0.999, fused=True)
        st0 = finito_run(F, g, lfinito_init(F, g, x0, gamma, 0, cfg), cfg,
                         "lfinito", 1)   # the warm-up epoch
        k6, k8 = fb.coeff_apply_all.launches, fb.lfinito_sweep_multistep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = finito_run(F, g, st0, cfg, "lfinito", LFINITO_EPOCHS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d6 = fb.coeff_apply_all.launches - k6
        d8 = fb.lfinito_sweep_multistep.launches - k8
        obj1 = prob.objective(F, g, st.z)
        ms = dt * 1e3 / LFINITO_EPOCHS
        chunks = -(-d // fb.LFINITO_CHUNK)
        log(f"  deep LFinito {storage}: N={Nd} n={nd} B={Bd} sweeping=3, "
            f"{LFINITO_EPOCHS} epochs in {d6} kernel #6 and {d8} kernel #8 "
            f"launches, objective {obj0:.9e} -> {obj1:.9e}, rel "
            f"{prob.gap_rel(st.z):.3e}; {ms:.3f} ms/epoch, "
            f"{1e3 / ms:.1f} epochs/s [{card}]")
        if d6 != LFINITO_EPOCHS or d8 != chunks * LFINITO_EPOCHS:
            raise AssertionError(f"deep lfinito {storage}: {d6} kernel #6, "
                                 f"{d8} kernel #8 launches")
        if not (math.isfinite(obj1) and obj1 < obj0):
            raise AssertionError(f"deep lfinito {storage}: objective {obj0} "
                                 f"-> {obj1}")
        out[storage] = dict(ms=ms, F=F, g=g, st=st0, cfg=cfg)
    return out


def time_turns(kernel_fn, plain_fn, tag, card, bound_args, reps=4) -> dict:
    """(kernel, plain, bound) ms per step in turns: plain, kernel, kernel,
    plain; ``kernel_fn``/``plain_fn`` run K steps and return K."""
    def turn(fn, r):
        holder = {}

        def call():
            holder["K"] = fn()
        ms = time_events(call, r)
        return ms / holder["K"]

    pl = [turn(plain_fn, 1)]
    kern = [turn(kernel_fn, reps) for _ in range(2)]
    pl.append(turn(plain_fn, 1))
    b_ms, b_by = bound_args
    log(f"  {tag}: kernel {kern[0]:.4f}/{kern[1]:.4f} ms/step, plain version "
        f"{pl[0]:.4f}/{pl[1]:.4f} ms/step, bound {b_ms:.5f} ms/step "
        f"({b_by}) [{card}]")
    return dict(ms=sum(kern) / 2, plain_ms=sum(pl) / 2, bound_ms=b_ms,
                bound_by=b_by)


def time_finito(F, gen, dev, B_, streamed, tag, card) -> dict:
    """Kernel #9 (or #14) per step on LAUNCH_STEPS-step calls from one
    Finito state, against its plain version; the bound counts the rows, b
    and c (read and written) of the distinct blocks visited, their zb
    rows read and written, z and av in and out, and the Σ 1/γ read."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    K = LAUNCH_STEPS
    S = finito_inputs(F, gen, dev, B_, K, LAM)
    fns = ((fb.finito_coeff_multistep_streamed,
            fb.finito_coeff_multistep_streamed_ref) if streamed else
           (fb.finito_coeff_multistep, fb.finito_coeff_multistep_ref))
    cols = F.dim
    distinct = int(torch.unique(S["starts"]).numel())
    invg_bytes = 4 * (K if streamed else F.num_terms // B_)
    bnd = step_bound(F, S["starts"], B_,
                     16 * cols + 8 * cols * distinct + invg_bytes, 12)

    state = [t.clone() for t in S["state"]]  # stepped on in place

    def run(fn):
        def call():
            run_finito_kernel(fn, F, S, B_, state=state)
            return K
        return call
    times = time_turns(run(fns[0]), run(fns[1]), tag, card, bnd)
    if not bool(torch.isfinite(state[2]).all()):
        raise AssertionError(f"{tag}: the timed steps gave non-finite z")
    return times


def time_lfinito(F, gen, dev, B_, tag, card) -> dict:
    """Kernel #8 per step on whole-sweep chunks (LFINITO_CHUNK blocks, or
    the d blocks when fewer) against its plain version; the bound counts
    the visited blocks' rows, b and anchor c, av in and out, z_full, z
    out and the Σ 1/γ read."""
    from ciao_tpu_torch.ops import fused_block as fb

    K = min(fb.LFINITO_CHUNK, F.num_terms // B_)
    S = lfinito_inputs(F, gen, dev, B_, K, LAM)
    rows, offs = F.coeff_rows_data()
    bnd = step_bound(F, S["starts"], B_, 16 * F.dim + 4 * K, 8)

    def run(fn):
        def call():
            _, z = fn(rows, offs, S["canch"], S["starts"], S["av"].clone(),
                      S["zf"], S["invg_v"], S["sc"], B_,
                      rs=F.coeff_rows_scale())
            return K
        return call
    return time_turns(run(fb.lfinito_sweep_multistep),
                      run(fb.lfinito_sweep_multistep_ref), tag, card, bnd,
                      reps=2)


def time_block(gen, dev, storage, card) -> dict:
    """Kernel #2 per step at the headline (one block's refresh, 16 calls
    in turns) against its plain version; the bound counts the block's
    rows, its table rows read and written, b and γ, z in and the
    innovation out, and 8·B·n operations. Then an epoch of the full-table
    Finito driver on the same rows, profiled. A call of the wrapper is one
    step, and its host work outlasts the kernel, so the event time is that
    of a call (``call_ms``); the kernel's time (``ms``) is its device time
    in the profiled epoch."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.finito import (
        FinitoCfg, finito_basic_init, finito_run,
    )

    F, _, L = lasso(gen, dev, N, n, storage)
    rows, offs = F.coeff_rows_data()
    s = torch.randn(N, n, generator=gen, device=dev)
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    gamma = 0.999 / (n * (0.8 + 0.4 * torch.rand(N, generator=gen,
                                                  device=dev)))
    starts = torch.randint(N // B, (16,), generator=gen, device=dev) * B
    sc = torch.tensor([N, 1.0 / N, 0.37], device=dev)
    isz = rows.element_size()
    bnd = bound(B * (n * isz + 8 * n + 8) + 8 * n, 8.0 * B * n, isz)

    def run(fn):
        def call():
            for k in range(16):
                fn(rows, offs, s, gamma, z, starts[k], sc, B)
            return 16
        return call
    times = time_turns(run(fb.finito_block_update),
                       run(fb.finito_block_update_ref),
                       f"kernel #2, {storage} rows, N={N} n={n} B={B}", card,
                       bnd)
    del s
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    cfg = FinitoCfg(N=N, batch=B, sweeping=2, alpha=0.999, fused=True)
    st = finito_basic_init(F, g, torch.zeros(n, device=dev), 0.999 * N / L, 0,
                           cfg)
    prof = profile_steps(
        f"Finito full-table steps at the headline, {storage} rows",
        lambda: finito_run(F, g, st, cfg, "basic", EPOCH_STEPS), EPOCH_STEPS,
        card, BLOCK_GROUPS)
    return dict(times, call_ms=times["ms"], ms=prof["kernel #2"])


# ---------------------------------------------------------------------------
# the sharing family and SAGA's full table: kernels #18 and #1
# ---------------------------------------------------------------------------

def coupling(name: str, dev):
    """The coupling prox of the ProShI checks: IndBox(-inf, PROSHI['hi']),
    NormL1(LAM) or Zero."""
    from ciao_tpu_torch.prox import IndBox, NormL1, Zero

    return {"IndBox": lambda: IndBox(-math.inf, PROSHI["hi"]),
            "NormL1": lambda: NormL1(torch.tensor(LAM, device=dev)),
            "Zero": Zero}[name]().to(dev)


def proshi_inputs(F, g, gen, dev, B_: int, K: int, distinct=False) -> dict:
    """A ProShI state on the card: γ_i ≈ 0.999/‖a_i‖² of Gaussian rows
    (α·N/L_i), a small random table s, av = Σ s_i, z its coupling, K
    block starts (repeats included unless ``distinct``) and the kernel's
    scalars row, built by ``solvers.proshi._scalars_row``."""
    from ciao_tpu_torch.sampling import init_sweep
    from ciao_tpu_torch.solvers.proshi import (
        ProshiCfg, ProshiState, _coupling, _scalars_row,
    )

    rows_, cols = F.num_terms, F.dim
    d = rows_ // B_
    gamma = 0.999 / (cols * (0.8 + 0.4 * torch.rand(
        rows_, generator=gen, device=dev)))
    s = 0.05 * torch.randn(rows_, cols, generator=gen, device=dev)
    av = s.sum(dim=0)
    hat = gamma.sum()
    cfg = ProshiCfg(N=rows_, batch=B_, sweeping=2, alpha=0.999)
    st = ProshiState(s=s, gamma=gamma, hat_gamma=hat, av=av,
                     z=_coupling(g, av, hat),
                     sweep=init_sweep(0, rows_, B_, 2, dev), it=1, status=0)
    blocks = (torch.randperm(d, generator=gen, device=dev)[:K] if distinct
              else torch.randint(d, (K,), generator=gen, device=dev))
    return dict(st=st, starts=(blocks * B_).to(torch.int32),
                sc=_scalars_row(F, g, st, cfg))


def run_proshi_kernel(fn, F, S, B_, precision="highest", f=None, starts=None,
                      state=None):
    """Kernel #18 (or its plain version) on ``state`` in place, by default
    a copy of S's (s, av, z); returns the state."""
    rows, offs = F.coeff_rows_data()
    st = S["st"]
    s, av, z = (state if state is not None
                else [t.clone() for t in (st.s, st.av, st.z)])
    fn(rows, offs, st.gamma, s, S["starts"] if starts is None else starts,
       av, z, S["sc"], B_, precision=precision, rs=F.coeff_rows_scale(), f=f)
    return [s, av, z]


def compare_proshi(F, gname, gen, dev, B_, K, tag, f=None,
                   z_by_av=False) -> float:
    """Kernel #18 against its plain version from one state on one
    schedule (clamp count ``f``): z within Z_TOL of its largest entry, s
    and av within STATE_TOL (the margins are exact f32 with any rows, so
    the exact-f32 bounds); "default" precision gives the kernel's
    "highest" result bit for bit. Returns the largest |ds|. With
    ``z_by_av`` z is held to Z_TOL of max |av| / hat instead: z =
    (prox_g(av) − av)/hat is a difference of av-sized values, which at N
    ≥ 8,192 rows can dwarf z's largest entry (IndBox clips at 1 an av of
    tens), so the two versions' f32 av, 1e-8 apart relative to max |av|,
    differ by more than Z_TOL of max |z| there."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = proshi_inputs(F, coupling(gname, dev), gen, dev, B_, K)
    kern = run_proshi_kernel(fb.proshi_multistep, F, S, B_, f=f)
    low = run_proshi_kernel(fb.proshi_multistep, F, S, B_, "default", f=f)
    ref = run_proshi_kernel(fb.proshi_multistep_ref, F, S, B_, f=f)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, low)):
        raise AssertionError(f"{tag}: 'default' precision changed the result")
    moved = float((ref[0] - S["st"].s).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move s")
    scale = (float(ref[1].abs().max()) / float(S["st"].hat_gamma) if z_by_av
             else float(ref[2].abs().max()))
    rel = float((kern[2] - ref[2]).abs().max()) / max(scale, 1e-30)
    if not (bool(torch.isfinite(kern[2]).all()) and rel <= Z_TOL[False]):
        raise AssertionError(f"{tag}: z rel error {rel:.3e} > {Z_TOL[False]}")
    check_close(tag, list(zip(("s", "av", "z"), kern, ref))[:3 - z_by_av],
                False, moved)
    return float((kern[0] - ref[0]).abs().max())


def proshi_masked_identity(F, gen, dev, B_, K, f, tag) -> None:
    """Kernel #18 clamped at f leaves s, av and z bit for bit as the first f
    steps alone leave them; f = 0 leaves the state as it was."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = proshi_inputs(F, coupling("IndBox", dev), gen, dev, B_, K)
    kern = fb.proshi_multistep
    i32 = dict(dtype=torch.int32, device=dev)
    st = S["st"]
    pairs = ((run_proshi_kernel(kern, F, S, B_, f=torch.tensor([f], **i32)),
              run_proshi_kernel(kern, F, S, B_, starts=S["starts"][:f])),
             (run_proshi_kernel(kern, F, S, B_, f=torch.tensor([0], **i32)),
              [st.s, st.av, st.z]))
    torch.cuda.synchronize()
    for got, want in pairs:
        for name, a, b in zip(("s", "av", "z"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: masked steps changed {name}")
    log(f"  {tag}: steps k >= {f} masked: s, av, z bit-identical to the "
        f"state after step {f - 1}; f = 0 leaves the state as it was")


def phase_check_proshi(gen, dev) -> float:
    """3i: kernel #18 at PROSHI_SMALL (f = K and a masked f < K) across
    storages and couplings, the masked steps bit for bit; the ragged
    narrow width; f32 and int8 rows at the persistent engine's edges
    (LOOPLESS_EDGES); K = PROSHI_K at the configuration."""
    s, worst = PROSHI_SMALL, 0.0
    for storage in ("f32", "bf16", "int8"):
        F, _, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for gname in ("IndBox", "NormL1", "Zero"):
            for f in (None, s["f"]):
                fc = None if f is None else torch.tensor(
                    [f], dtype=torch.int32, device=dev)
                worst = max(worst, compare_proshi(
                    F, gname, gen, dev, s["B"], s["K"],
                    f"#18 N={s['N']} n={s['n']} B={s['B']} K={s['K']} "
                    f"f={f or s['K']} {storage} {gname}", f=fc))
        proshi_masked_identity(F, gen, dev, s["B"], s["K"], s["f"],
                               f"#18 N={s['N']} K={s['K']} {storage}")
    r = PROSHI_RAGGED
    for storage in ("f32", "int8"):
        F, _, _ = lasso(gen, dev, r["N"], r["n"], storage)
        worst = max(worst, compare_proshi(
            F, "NormL1", gen, dev, r["B"], r["K"],
            f"#18 N={r['N']} n={r['n']} (one-value path) B={r['B']} "
            f"K={r['K']} {storage} NormL1"))
    for N_, n_, B_, K_, _ in LOOPLESS_EDGES:
        for storage in ("f32", "int8"):
            F, _, _ = lasso(gen, dev, N_, n_, storage)
            worst = max(worst, compare_proshi(
                F, "IndBox", gen, dev, B_, K_,
                f"#18 N={N_} n={n_} B={B_} K={K_} {storage} IndBox",
                z_by_av=True))
            del F
            torch.cuda.empty_cache()
    for storage in ("f32", "bf16", "int8"):
        F, _, _ = lasso(gen, dev, PROSHI["N"], n, storage)
        worst = max(worst, compare_proshi(
            F, "IndBox", gen, dev, PROSHI["B"], PROSHI_K,
            f"#18 N={PROSHI['N']} n={n} B={PROSHI['B']} K={PROSHI_K} "
            f"{storage} IndBox"))
        del F
    return worst


def compare_saga_block(F, gen, dev, B_, precision, tag) -> float:
    """Kernel #1 against its plain version on one block (its start a
    device tensor): the block's rows within Z_TOL of their largest entry,
    the innovation within STATE_TOL, every other row bit for bit as it
    was; returns the largest error of the block's rows."""
    from ciao_tpu_torch.ops import fused_block as fb

    rows, offs = F.coeff_rows_data()
    rows_, cols = rows.shape
    s = torch.randn(rows_, cols, generator=gen, device=dev)
    z = 0.05 * torch.randn(cols, generator=gen, device=dev)
    start = torch.randint(rows_ // B_, (), generator=gen, device=dev) * B_
    sc = torch.tensor([float(rows_)], device=dev)
    ks, kin = fb.saga_block_update(rows, offs, s.clone(), z, start, sc, B_,
                                   precision=precision)
    rs_, rin = fb.saga_block_update_ref(rows, offs, s.clone(), z, start, sc,
                                        B_, precision=precision)
    torch.cuda.synchronize()
    lo = int(start)
    blk = slice(lo, lo + B_)
    if not (torch.equal(ks[:lo], s[:lo])
            and torch.equal(ks[lo + B_:], s[lo + B_:])):
        raise AssertionError(f"{tag}: rows outside the block changed")
    lowp = precision == "default"
    rel = float((ks[blk] - rs_[blk]).abs().max()) / float(
        rs_[blk].abs().max())
    if rel > Z_TOL[lowp]:
        raise AssertionError(f"{tag}: s rel error {rel:.3e} > {Z_TOL[lowp]}")
    check_close(tag + ", rows outside the block bit for bit",
                (("s", ks[blk], rs_[blk]), ("innov", kin, rin)), lowp)
    return float((ks[blk] - rs_[blk]).abs().max())


def phase_check_saga_block(gen, dev) -> float:
    """3j: kernel #1, f32 and bf16 rows, both precisions, at SMALL and at
    the headline."""
    worst = 0.0
    for rows_, cols, B_ in ((SMALL["N"], SMALL["n"], SMALL["B"]), (N, n, B)):
        for storage in ("f32", "bf16"):
            F, _, _ = lasso(gen, dev, rows_, cols, storage)
            for precision in ("highest", "default"):
                worst = max(worst, compare_saga_block(
                    F, gen, dev, B_, precision,
                    f"#1 N={rows_} n={cols} B={B_} {storage}/{precision}"))
            del F
            torch.cuda.empty_cache()
    return worst


def sharing_obj(F, g, st) -> float:
    from ciao_tpu_torch.solvers.proshi import sharing_objective

    return float(sharing_objective(F, g, st))


def run_proshi(gen, dev, card: str) -> dict:
    """4h: ProShI through proshi_init and proshi_run on kernel #18 alone:
    bench.py's cyclic configuration at f32 and int8 rows, shuffled at the
    same rows, random with block_sampling at 262,144 rows (d = 64), and
    the Proshi facade. Every sharing objective falls; returns what phase
    8 times and profiles."""
    from ciao_tpu_torch import Proshi
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.proshi import ProshiCfg, proshi_init, proshi_run
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    g = coupling("IndBox", dev)
    x0 = torch.zeros(n, device=dev)
    out = {}
    cases = (("cyclic", PROSHI["N"], 2, False, PROSHI["steps"], "f32"),
             ("cyclic", PROSHI["N"], 2, False, PROSHI["steps"], "int8"),
             ("shuffled", PROSHI["N"], 3, False, PROSHI["shuffled"], "f32"),
             ("random block_sampling", N, 1, True, PROSHI["random"], "f32"))
    for label, rows_, sweeping, blk, steps, storage in cases:
        F, _, L = lasso(gen, dev, rows_, n, storage)
        if not fb.proshi_multistep_available(F, g, x0, PROSHI["B"]):
            raise AssertionError(f"proshi {label} {storage}: the gate is "
                                 "closed")
        cfg = ProshiCfg(N=rows_, batch=PROSHI["B"], sweeping=sweeping,
                        alpha=0.999, fused=True, block_sampling=blk)
        st0 = proshi_init(F, g, x0, 0.999 * rows_ / L, 0, cfg)
        obj0 = sharing_obj(F, g, st0)
        k18 = fb.proshi_multistep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = proshi_run(F, g, st0, cfg, steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d18 = fb.proshi_multistep.launches - k18
        obj1 = sharing_obj(F, g, st)
        ms = dt * 1e3 / steps
        log(f"  proshi {label} {storage}: N={rows_} n={n} B={PROSHI['B']} "
            f"IndBox(-inf, {PROSHI['hi']}), {steps} steps in {d18} kernel "
            f"#18 launches, sharing objective {obj0:.6e} -> {obj1:.6e}, "
            f"{ms:.4f} ms/step end to end [{card}]")
        for name in ("s", "av", "z"):
            if not bool(torch.isfinite(getattr(st, name)).all()):
                raise AssertionError(f"proshi {label}: {name} not finite")
        if d18 != -(-steps // LAUNCH_STEPS) or st.it != steps + 1:
            raise AssertionError(f"proshi {label}: {d18} launches, it {st.it}")
        if not (math.isfinite(obj1) and obj1 < obj0):
            raise AssertionError(f"proshi {label}: objective {obj0} -> {obj1}")
        if label == "cyclic":
            out[storage] = dict(ms=ms, F=F, g=g, L=L, st=st0, cfg=cfg)
        del F, st, st0
    r = out["f32"]
    k18 = fb.proshi_multistep.launches
    maxit = PROSHI["facade"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it = Proshi(maxit=maxit, sweeping=2, minibatch=(True, PROSHI["B"]))(
        x0, F=r["F"], g=g, L=r["L"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d18 = fb.proshi_multistep.launches - k18
    from ciao_tpu_torch.monitor import sharing_objective as blocks_objective

    obj0, obj1 = sharing_obj(r["F"], g, r["st"]), float(
        blocks_objective(r["F"], g, x))
    log(f"  facade Proshi(sweeping=2, batch={PROSHI['B']}, maxit={maxit}): "
        f"sharing objective {obj0:.6e} -> {obj1:.6e} after {it - 1} steps "
        f"in {d18} kernel #18 launches, {dt:.3f} s [{card}]")
    if d18 != -(-(it - 1) // LAUNCH_STEPS) or not (
            math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"facade Proshi: {d18} launches, objective "
                             f"{obj0} -> {obj1}")
    return out


def run_saga_full(gen, dev, prob, F_facade, card: str) -> dict:
    """4i: SAGA's full table on kernel #1 alone: FULL_SAGA_STEPS block
    steps at the headline (f32 and bf16 rows, saga_init and saga_run),
    then the SAGA(table="full") and SAG facades on the facades' planted
    Lasso, each bringing cost − f* down by its bar in FULL_SAGA_FACADE."""
    import numpy as np

    from ciao_tpu_torch import SAG, SAGA, NormL1
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    x0 = torch.zeros(n, device=dev)
    out = {}
    for storage in ("f32", "bf16"):
        F, gamma, _ = lasso(gen, dev, N, n, storage)
        if not fb.saga_block_available(F, x0, B):
            raise AssertionError(f"saga full {storage}: the gate is closed")
        cfg = SAGACfg(N=N, sag=False, batch=B, block=True, fused=True)
        st0 = saga_init(F, g, x0, gamma, 0, cfg)
        obj0 = cost(F, g, st0.z)
        k1 = fb.saga_block_update.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = saga_run(F, g, st0, cfg, FULL_SAGA_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d1 = fb.saga_block_update.launches - k1
        obj1 = cost(F, g, st.z)
        ms = dt * 1e3 / FULL_SAGA_STEPS
        log(f"  saga full table {storage}: N={N} n={n} B={B}, "
            f"{FULL_SAGA_STEPS} steps in {d1} kernel #1 launches, objective "
            f"{obj0:.6e} -> {obj1:.6e}, {ms:.4f} ms/step end to end [{card}]")
        if d1 != FULL_SAGA_STEPS or not bool(torch.isfinite(st.s).all()):
            raise AssertionError(f"saga full {storage}: {d1} launches")
        if not (math.isfinite(obj1) and obj1 < obj0):
            raise AssertionError(f"saga full {storage}: objective {obj0} -> "
                                 f"{obj1}")
        out[storage] = dict(ms=ms, F=F, g=g, st=st0, cfg=cfg)
        del st
    kw = FULL_SAGA_FACADE
    gap0 = prob.cost(np.zeros(n)) - prob.f_star
    for tag, solver, drop in (
            (f"SAGA(table='full', block_sampling=True, batch={kw['batch']})",
             SAGA(maxit=kw["maxit"], table="full", block_sampling=True,
                  batch=kw["batch"]), kw["drop"]),
            (f"SAG(table='full', block_sampling=True, batch={kw['batch']})",
             SAG(maxit=kw["sag_maxit"], table="full", block_sampling=True,
                 batch=kw["batch"]), kw["sag_drop"])):
        k1 = fb.saga_block_update.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, it = solver(x0, F=F_facade, g=NormL1(prob.lam), L=prob.L)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d1 = fb.saga_block_update.launches - k1
        gap1 = prob.cost(x.double().cpu().numpy()) - prob.f_star
        log(f"  facade {tag} on planted make_lasso(N={FACADE['N']}, n={n}): "
            f"cost - f* {gap0:.6e} -> {gap1:.6e} ({gap0 / gap1:.2f}-fold) "
            f"after {it - 1} steps in {d1} kernel #1 launches, {dt:.3f} s "
            f"[{card}]")
        if d1 != it - 1 or not (math.isfinite(gap1) and gap0 / gap1 >= drop):
            raise AssertionError(f"facade {tag}: {d1} launches, cost - f* "
                                 f"{gap0} -> {gap1}")
    return out


def run_sharing_deep(dev, card: str) -> float:
    """4j: deep_solve_sharing on the planted sharing problem, stepwise by
    design (no kernel launches); returns the rel gap against the f64
    closed-form optimum, which must be <= SHARING_REL."""
    from ciao_tpu_torch import DiagQuadratic, NormL1, deep_solve_sharing
    from ciao_tpu_torch.utils.problems import make_sharing_planted

    c = SHARING_DEEP
    t0 = time.perf_counter()
    prob = make_sharing_planted(N=c["N"], n=c["n"], p=c["p"], seed=0)
    F = DiagQuadratic(torch.tensor(prob.d, dtype=torch.float32, device=dev),
                      torch.tensor(prob.q, dtype=torch.float32, device=dev))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32, device=dev))
    t1 = time.perf_counter()
    blocks, info = deep_solve_sharing(
        torch.zeros(c["n"], device=dev), F, g=g, L=prob.L, N=c["N"],
        batch=c["batch"], sweeping=c["sweeping"],
        chunk_epochs=c["chunk_epochs"], max_epochs=c["max_epochs"],
        resync_chunk=c["resync_chunk"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    rel = (prob.cost(blocks.double().cpu().numpy()) - prob.f_star) / abs(
        prob.f_star)
    steps = info.epochs * (c["N"] // c["batch"])
    log(f"  sharing deep route: deep_solve_sharing on make_sharing_planted("
        f"N={c['N']}, n={c['n']}, p={c['p']}) (built in {t1 - t0:.2f} s), "
        f"batch {c['batch']}, sweeping {c['sweeping']}: rel {rel:.3e} "
        f"(bar {SHARING_REL:g}; accuracy record rel {SHARING_RECORD:g}) in "
        f"{dt:.3f} s, {info.epochs} epochs, {info.resyncs} resyncs, "
        f"{dt * 1e3 / max(steps, 1):.4f} ms per stepwise step [{card}]")
    if tuple(blocks.shape) != (c["N"], c["n"]) or not (
            math.isfinite(rel) and rel <= SHARING_REL):
        raise AssertionError(f"sharing deep: rel {rel:.3e}, shape "
                             f"{tuple(blocks.shape)}")
    return rel


def time_proshi(r: dict, gen, dev, storage: str, card: str) -> dict:
    """Kernel #18 per step on calls of one epoch (the d = 16 blocks, each
    once) from one state at the ProShI configuration, in turns with its
    plain version; the bound counts the blocks' rows, b, γ (and rs) and
    their table rows read and written, av and z in and out, and 7·B·n
    operations a step."""
    from ciao_tpu_torch.ops import fused_block as fb

    F = r["F"]
    K = F.num_terms // PROSHI["B"]
    S = proshi_inputs(F, r["g"], gen, dev, PROSHI["B"], K, distinct=True)
    rows = F.coeff_rows_data()[0]
    isz = rows.element_size()
    blocks = int(torch.unique(S["starts"]).numel())
    per_row = n * isz + 8 * n + 8 + 4 * (rows.dtype == torch.int8)
    bnd = bound((blocks * PROSHI["B"] * per_row + 16 * n) / K,
                7.0 * PROSHI["B"] * n, isz)
    state = [t.clone() for t in (S["st"].s, S["st"].av, S["st"].z)]

    def run(fn):
        def call():
            run_proshi_kernel(fn, F, S, PROSHI["B"], state=state)
            return K
        return call
    times = time_turns(run(fb.proshi_multistep), run(fb.proshi_multistep_ref),
                       f"kernel #18, {storage} rows, N={PROSHI['N']} n={n} "
                       f"B={PROSHI['B']}", card, bnd)
    if not bool(torch.isfinite(state[2]).all()):
        raise AssertionError("the timed kernel #18 steps gave non-finite z")
    return times


def time_saga_block(r: dict, gen, dev, storage, card) -> dict:
    """Kernel #1 per block at the headline (16 calls in turns) against its
    plain version; the bound counts the block's rows, its table rows read
    and written, b, z in and the innovation out, and 5·B·n operations.
    Then an epoch of full-table SAGA steps profiled: a call of the
    wrapper is one step and its host work outlasts the kernel, so the
    event time is that of a call (``call_ms``) and the kernel's time
    (``ms``) its device time in the profiled epoch."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.saga import saga_run

    F = r["F"]
    rows, offs = F.coeff_rows_data()
    s = torch.randn(N, n, generator=gen, device=dev)
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    starts = torch.randint(N // B, (16,), generator=gen, device=dev) * B
    sc = torch.tensor([float(N)], device=dev)
    isz = rows.element_size()
    bnd = bound(B * (n * isz + 8 * n + 4) + 8 * n, 5.0 * B * n, isz)

    def run(fn):
        def call():
            for k in range(16):
                fn(rows, offs, s, z, starts[k], sc, B)
            return 16
        return call
    times = time_turns(run(fb.saga_block_update),
                       run(fb.saga_block_update_ref),
                       f"kernel #1, {storage} rows, N={N} n={n} B={B}", card,
                       bnd)
    del s
    prof = profile_steps(
        f"SAGA full-table steps at the headline, {storage} rows",
        lambda: saga_run(F, r["g"], r["st"], r["cfg"], EPOCH_STEPS),
        EPOCH_STEPS, card, SAGA_BLOCK_GROUPS)
    return dict(times, call_ms=times["ms"], ms=prof["kernel #1"])


# ---------------------------------------------------------------------------
# the SVRG-shaped families: Katyusha #10, SARAH #11, L-SVRG #16, L-Katyusha #17
# ---------------------------------------------------------------------------

# the four kernels: the wrapper, its plain version and a short label
VR = {"katyusha": ("katyusha_coeff_multistep", "#10"),
      "sarah": ("sarah_multistep", "#11"),
      "lsvrg": ("lsvrg_coeff_multistep", "#16"),
      "lkatyusha": ("lkatyusha_coeff_multistep", "#17")}


def vr_inputs(F, gen, dev, B_: int, K: int, mode: int = 0) -> dict:
    """Inputs of the four kernels on the card: an anchor point xa, its
    coefficients and mean gradient (kernel #6's plain version), two
    points near it and K block starts (repeats included). The logistic
    mode takes ±1 offsets from the caller's rows."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.saga import block_starts

    rows, offs = F.coeff_rows_data()
    N_, n_ = rows.shape
    xa = 0.05 * torch.randn(n_, generator=gen, device=dev)
    near = xa + 0.01 * torch.randn(2, n_, generator=gen, device=dev)
    seed = int(torch.randint(1 << 30, (1,), generator=gen, device=dev))
    scale = 1.0 if mode == 1 else float(N_)
    canch, gsum = fb.coeff_apply_all_ref(
        rows, offs, xa, torch.tensor([scale, mode, 0.5], device=dev),
        rs=F.coeff_rows_scale())
    # the rows' smoothness: scale·‖a_i‖² (a quarter of ‖a_i‖² for logistic)
    sq = (rows.float() ** 2).sum(1)
    if F.coeff_rows_scale() is not None:
        sq = sq * F.coeff_rows_scale() ** 2
    Lmax = float(sq.max()) * (0.25 if mode == 1 else N_)
    return dict(rows=rows, offs=offs, rs=F.coeff_rows_scale(), xa=xa,
                near=near, canch=canch, av=gsum / N_, Lmax=Lmax, scale=scale,
                mode=mode, starts=block_starts(seed, 1, K, N_ // B_, B_, dev))


def vr_scalars(S: dict, kind: str, B_: int, lam: float, tau1: float = 0.3):
    """The scalars row of ``kind`` at the inputs' formula mode (aux 0.5,
    Huber's δ): Katyusha at τ₁ (0.5 is the ns schedule's first epoch),
    τ₂ = 1/2; SARAH at γ = 1/(2 L_max), η = 0.7; L-SVRG at γ = 1/(6 L_max);
    L-Katyusha at θ₁ = 1/3, θ₂ = 1/2, σ̂ = 0.01."""
    L_, sc, md = S["Lmax"], S["scale"], S["mode"]
    if kind == "katyusha":
        a, b_ = 1.0 / (3.0 * tau1 * L_), 1.0 / (3.0 * L_)
        row = [sc, a, b_, a * lam, b_ * lam, 1.0 / B_, md, tau1, 0.5, 0.5]
    elif kind == "sarah":
        g_ = 1.0 / (2.0 * L_)
        row = [sc, g_, g_ * lam, 0.7, 1.0 / B_, md, 0.5]
    elif kind == "lsvrg":
        g_ = 1.0 / (6.0 * L_)
        row = [sc, g_, g_ * lam, 1.0 / B_, md, 0.5]
    else:
        th1, th2, sig = 1.0 / 3.0, 0.5, 0.01
        eta = th2 / ((1.0 + th2) * th1)
        step, den = eta / L_, 1.0 + eta * sig
        row = [sc, step, step / den * lam, 1.0 / den, eta * sig, th1, th2,
               1.0 / B_, md, 0.5]
    return torch.tensor(row, dtype=torch.float32,
                        device=S["rows"].device)


def vr_state(kind: str, S: dict) -> list:
    """Copies of the inputs' starting state of kernel ``kind``: the
    tensors it updates in place."""
    a = S["xa"]
    p, q = S["near"][0].clone(), S["near"][1].clone()
    return {"katyusha": lambda: [p, q, torch.zeros_like(p)],
            "sarah": lambda: [torch.stack([a, p]), S["av"].clone()],
            "lsvrg": lambda: [p],
            "lkatyusha": lambda: [p, q]}[kind]()


def vr_call(kind: str, fn, S: dict, sc, B_: int, precision="highest",
            stop=None, starts=None, state=None):
    """One call of kernel ``kind`` (or its plain version) ``fn`` from
    copies of the inputs' state (or on ``state``, in place); returns its
    outputs."""
    st = S["starts"] if starts is None else starts
    a = S["xa"]
    if state is None:
        state = vr_state(kind, S)
    kw = dict(precision=precision, rs=S["rs"])
    rows, offs, canch, av = S["rows"], S["offs"], S["canch"], S["av"]
    if kind == "katyusha":
        return fn(rows, offs, canch, st, a, *state, av, sc, B_, **kw)
    if kind == "sarah":
        return fn(rows, offs, st, *state, sc, B_, **kw)
    if kind == "lsvrg":
        return fn(rows, offs, canch, st, stop, *state, av, sc, B_, **kw)
    return fn(rows, offs, canch, st, stop, a, *state, av, sc, B_, **kw)


def compare_vr(kind, F, gen, dev, B_, K, lam, precision, tag, mode=0,
               tau1=0.3, stop=None) -> float:
    """Kernel ``kind`` and its plain version from one state on one
    schedule: every output within Z_TOL of its largest entry; SARAH, and
    every kernel where the dots round to bf16, step by step
    (compare_stepwise). ``stop``: the loopless pair's last step to process,
    read on the device (exact-f32 dots only). Returns the largest absolute
    error of the iterate (y, ww, w)."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = vr_inputs(F, gen, dev, B_, K, mode)
    sc = vr_scalars(S, kind, B_, lam, tau1)
    name = VR[kind][0]
    kern, plain = getattr(fb, name), getattr(fb, f"{name}_ref")
    lowp = fb._lowp(S["rows"], precision)
    if kind == "sarah" or lowp:
        if stop is not None:
            raise ValueError("a stop is compared with exact-f32 dots only")
        return compare_stepwise(kind, kern, plain, S, sc, B_, K, precision,
                                lowp, tag)
    st = None if stop is None else torch.tensor([stop], dtype=torch.int32,
                                                device=dev)
    kout = vr_call(kind, kern, S, sc, B_, precision, stop=st)
    rout = vr_call(kind, plain, S, sc, B_, precision, stop=st)
    torch.cuda.synchronize()
    moved = float((rout[0] - S["near"][0]).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move the iterate")
    rels = [check_rel(tag, i, k, r, Z_TOL[lowp])
            for i, (k, r) in enumerate(zip(kout, rout))]
    err = float((kout[0] - rout[0]).abs().max())
    log(f"  {tag}: max |d iterate| {err:.3e}, rel errors "
        f"{', '.join(f'{r:.2e}' for r in rels)}; moved {moved:.3e}")
    return err


def check_rel(tag, i, k, r, tol) -> float:
    """The error of kernel output ``i`` relative to the plain version's
    largest entry; raises past ``tol`` or on a non-finite value."""
    if not bool(torch.isfinite(k).all()):
        raise AssertionError(f"{tag}: kernel output {i} is not finite")
    rel = float((k - r).abs().max()) / max(float(r.abs().max()), 1e-30)
    if rel > tol:
        raise AssertionError(f"{tag}: output {i} rel error {rel:.3e} > {tol}")
    return rel


def compare_stepwise(kind, kern, plain, S, sc, B_, K, precision, lowp,
                     tag) -> float:
    """Kernel ``kind`` against its plain version step by step: each step of
    the plain trajectory is taken once more by the kernel from the same
    state (every state tensor within Z_TOL of its largest entry; SARAH's
    estimator v, a gradient mean, within STATE_TOL), and the kernel's
    K-step call equals its K one-step calls bit for bit. Where the dots
    round to bf16, an ulp of difference in a margin or a point (the plain
    version sums in another order) can flip a bf16 rounding, and the flip
    carries on through every later step: a K-step comparison then holds no
    fixed bound (#17 at f32 "default" read 1.2e-5 against Z_TOL's 1e-5 on
    one input). SARAH's Δc = c(w) − c(w_prev) subtracts two nearly equal
    margins, so a difference of summation order grows step by step through
    its recursion at any precision."""
    tols = [Z_TOL[lowp]] * 3
    if kind == "sarah":
        tols[1] = STATE_TOL[lowp]
    ref, chain = vr_state(kind, S), vr_state(kind, S)
    init = [t.clone() for t in ref]
    worst = [0.0] * len(ref)
    err = 0.0
    for k in range(K):
        st = S["starts"][k:k + 1]
        one = [t.clone() for t in ref]
        vr_call(kind, kern, S, sc, B_, precision, starts=st, state=one)
        last = vr_call(kind, kern, S, sc, B_, precision, starts=st,
                       state=chain)
        vr_call(kind, plain, S, sc, B_, precision, starts=st, state=ref)
        torch.cuda.synchronize()
        for i, (o, r) in enumerate(zip(one, ref)):
            worst[i] = max(worst[i], check_rel(f"{tag} step {k}", i, o, r,
                                               tols[i]))
        err = max(err, float((one[0] - ref[0]).abs().max()))
    full = vr_state(kind, S)
    out = vr_call(kind, kern, S, sc, B_, precision, state=full)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(full + list(out),
                                                 chain + list(last))):
        raise AssertionError(f"{tag}: the K-step call differs from its "
                             "one-step calls")
    moved = float((ref[0] - init[0]).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move the iterate")
    log(f"  {tag}: per step max |d iterate| {err:.3e}, rel errors "
        f"{', '.join(f'{w:.2e}' for w in worst)}; the K-step call equals "
        f"its {K} one-step calls bit for bit; moved {moved:.3e}")
    return err


def vr_masked_identity(kind, F, gen, dev, B_, K, stop, tag) -> None:
    """Kernels #16 and #17 with stop read on the device: stop < K − 1
    equals the first stop + 1 steps alone and stop = K − 1 the whole
    call, bit for bit (wpre/ypre included)."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = vr_inputs(F, gen, dev, B_, K)
    sc = vr_scalars(S, kind, B_, LAM)
    fn = getattr(fb, VR[kind][0])
    i32 = dict(dtype=torch.int32, device=dev)
    pairs = ((vr_call(kind, fn, S, sc, B_, stop=torch.tensor([stop], **i32)),
              vr_call(kind, fn, S, sc, B_, starts=S["starts"][:stop + 1])),
             (vr_call(kind, fn, S, sc, B_, stop=torch.tensor([K - 1], **i32)),
              vr_call(kind, fn, S, sc, B_)))
    torch.cuda.synchronize()
    for got, want in pairs:
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{tag}: masked steps changed the state")
    log(f"  {tag}: steps k > {stop} masked: outputs bit-identical to the "
        f"first {stop + 1} steps alone; stop = {K - 1} bit-identical to "
        "the whole call")


def phase_check_vr(gen, dev) -> dict:
    """3k-3n: each of the four kernels against its plain version in
    f32 "highest", f32 "default", bf16 and int8 rows, NormL1 and Zero, at
    N = 8,192, n = 128, B = 128, K = 64 (Katyusha at the ns τ₁ = 0.5 and a
    fixed 0.3), the Huber and logistic formulas (the mode and aux slots of
    each scalars row), a width that is not whole 16-byte chunks, the masked
    windows of #16 and #17, K = 8 at the headline, and all four at
    LOOPLESS_EDGES (#16 and #17 f32 with the stop, int8 step by step, and
    the masked windows of both; #10 and #11 as everywhere else)."""
    s = VR_SMALL
    errs = dict.fromkeys(VR, 0.0)
    for storage, precision in STORAGES:
        F, _, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for kind in VR:
            for lam in (LAM, 0.0):
                for tau1 in ((0.5, 0.3) if kind == "katyusha" else (0.3,)):
                    tag = (f"{VR[kind][1]} N={s['N']} n={s['n']} B={s['B']} "
                           f"K={s['K']} {storage}/{precision} "
                           f"{'NormL1' if lam else 'Zero'}"
                           + (f" tau1={tau1}" if kind == "katyusha" else ""))
                    errs[kind] = max(errs[kind], compare_vr(
                        kind, F, gen, dev, s["B"], s["K"], lam, precision,
                        tag, tau1=tau1))
        del F
    for storage, cols, mode in (("f32", 128, 1), ("int8", 128, 2),
                                ("f32", 202, 0)):
        F, _, _ = lasso(gen, dev, s["N"], cols, storage)
        if mode == 1:
            F = type(F)(F.A, torch.sign(F.b), 1.0, F.row_scale)
        for kind in VR:
            tag = (f"{VR[kind][1]} N={s['N']} n={cols} {storage} mode "
                   f"{mode}")
            errs[kind] = max(errs[kind], compare_vr(
                kind, F, gen, dev, s["B"], s["K"], LAM, "highest", tag,
                mode=mode))
        del F
    for storage in ("f32", "int8"):
        F, _, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for kind in ("lsvrg", "lkatyusha"):
            vr_masked_identity(kind, F, gen, dev, s["B"], s["K"], s["stop"],
                               f"{VR[kind][1]} K={s['K']} {storage}")
        del F
    for storage in ("f32", "int8"):
        F, _, _ = lasso(gen, dev, N, n, storage)
        for kind in VR:
            tag = f"{VR[kind][1]} N={N} n={n} B={B} K={HEADLINE_K} {storage}"
            errs[kind] = max(errs[kind], compare_vr(
                kind, F, gen, dev, B, HEADLINE_K, LAM, "highest", tag))
        del F
        torch.cuda.empty_cache()
    for N_, n_, B_, K_, stop in LOOPLESS_EDGES:
        for storage in ("f32", "int8"):
            F, _, _ = lasso(gen, dev, N_, n_, storage)
            for kind in VR:
                st = (stop if storage == "f32" and kind in LOOPLESS_KINDS
                      else None)
                tag = (f"{VR[kind][1]} N={N_} n={n_} B={B_} K={K_} {storage}"
                       + (f" stop={st}" if st is not None else ""))
                errs[kind] = max(errs[kind], compare_vr(
                    kind, F, gen, dev, B_, K_, LAM, "highest", tag, stop=st))
                if kind in LOOPLESS_KINDS:
                    vr_masked_identity(kind, F, gen, dev, B_, K_, stop, tag)
            del F
            torch.cuda.empty_cache()
    return {VR[k][0]: v for k, v in errs.items()}


def run_vr_headline(kind: str, gen, dev, storage: str, card: str) -> dict:
    """bench.py's configuration of ``kind`` at the headline, through its
    kernel and kernel #6 (init, then VR_OUTER outer steps or
    LOOPLESS_STEPS steps of the family's run): launch counts, a falling
    objective, ms per outer step or per step; returns what phase 9
    profiles."""
    import numpy as np

    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import katyusha as kat
    from ciao_tpu_torch.solvers import lsvrg as ls
    from ciao_tpu_torch.solvers import sarah as sar
    from ciao_tpu_torch.solvers.lsvrg import (
        LOOPLESS_LAUNCH, _windows, draw_coins,
    )

    F, _, L = lasso(gen, dev, N, n, storage)
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    x0 = torch.zeros(n, device=dev)
    if not fb.svrg_multistep_available(F, g, x0, B):
        raise AssertionError(f"{kind} {storage}: the kernel's gate is closed")
    Lm = L.max()
    p = B / N
    if kind == "katyusha":
        cfg = kat.KatyushaCfg(N=N, batch=B, m=VR_M, block=True, ns=True,
                              fused=True)
        st0 = kat.katyusha_init(F, g, x0, Lm, 0.5, 0.5, 0, cfg)
        run, steps, sol = kat.katyusha_run, VR_OUTER, "x_tilde"
    elif kind == "sarah":
        cfg = sar.SARAHCfg(N=N, batch=B, m=VR_M, block=True, fused=True)
        st0 = sar.sarah_init(F, g, x0, 1.0 / (2.0 * Lm), 1.0, 0, cfg)
        run, steps, sol = sar.sarah_run, VR_OUTER, "x_tilde"
    elif kind == "lsvrg":
        cfg = ls.LSVRGCfg(N=N, batch=B, block=True, fused=True)
        st0 = ls.lsvrg_init(F, g, x0, 1.0 / (6.0 * Lm), p, 0, cfg)
        run, steps, sol = ls.lsvrg_run, LOOPLESS_STEPS, "w"
    else:
        cfg = ls.LKatyushaCfg(N=N, batch=B, block=True, fused=True)
        st0 = ls.lkatyusha_init(F, g, x0, Lm, 0.0, 1.0 / 3.0, 0.5, p, 0, cfg)
        run, steps, sol = ls.lkatyusha_run, LOOPLESS_STEPS, "y"
    name, label = VR[kind]
    obj0 = cost(F, g, getattr(st0, sol))
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(F, g, st0, cfg, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d = {k: v - before[k] for k, v in counts().items()}
    obj1 = cost(F, g, getattr(st, sol))
    if kind in ("katyusha", "sarah"):
        want = {name: steps, "coeff_apply_all": steps}
        unit = "outer step"
    else:
        wins = _windows(np.flatnonzero(draw_coins(0, 1, steps, p)), steps,
                        LOOPLESS_LAUNCH)
        want = {name: len(wins),
                "coeff_apply_all": sum(f for _, _, f in wins)}
        unit = "step"
    moved = {k: v for k, v in d.items() if v}
    for t in st:
        if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{kind} {storage}: a state field is not "
                                 "finite")
    ms = dt * 1e3 / steps
    log(f"  {kind} headline {storage}: N={N} n={n} B={B}, {steps} "
        f"{unit}s: launches {moved}, objective {obj0:.6e} -> {obj1:.6e}, "
        f"{ms:.4f} ms per {unit} end to end [{card}]")
    if moved != want:
        raise AssertionError(f"{kind} {storage}: launches {moved}, expected "
                             f"{want}")
    if not (math.isfinite(obj1) and obj1 < obj0) or st.it != steps + 1:
        raise AssertionError(f"{kind} {storage}: objective {obj0} -> {obj1}, "
                             f"it {st.it}")
    return dict(ms=ms, F=F, g=g, st=st0, cfg=cfg, run=run)


def run_vr_facade(kind: str, dev, prob, F, card: str) -> None:
    """The family's facade, as a user calls it, on the facades' planted
    Lasso: block sampling at batch 1,024 and its default stepsizes; cost −
    f* must fall by its bar in VR_FACADE, every run on its kernel."""
    import numpy as np

    import ciao_tpu_torch as ct

    kw = VR_FACADE[kind]
    facade = {"katyusha": ct.Katyusha, "sarah": ct.SARAH,
              "lsvrg": ct.LSVRG, "lkatyusha": ct.LKatyusha}[kind]
    gap0 = prob.cost(np.zeros(n)) - prob.f_star
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it = facade(maxit=kw["maxit"], batch=kw["batch"],
                   block_sampling=True)(torch.zeros(n, device=dev), F=F,
                                        g=ct.NormL1(prob.lam), L=prob.L)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in counts().items() if v != before[k]}
    gap1 = prob.cost(x.double().cpu().numpy()) - prob.f_star
    log(f"  facade {facade.__name__}(block_sampling=True, batch="
        f"{kw['batch']}, maxit={kw['maxit']}) on planted make_lasso(N="
        f"{FACADE['N']}, n={n}): cost - f* {gap0:.6e} -> {gap1:.6e} "
        f"({gap0 / gap1:.1f}-fold, bar {kw['drop']:g}), launches {moved}, "
        f"{dt:.3f} s [{card}]")
    if not (math.isfinite(gap1) and gap0 / gap1 >= kw["drop"]):
        raise AssertionError(f"facade {kind}: cost - f* {gap0} -> {gap1}")
    if not moved.get(VR[kind][0]) or set(moved) - {VR[kind][0],
                                                    "coeff_apply_all"}:
        raise AssertionError(f"facade {kind}: launches {moved}")


def run_katyusha_to_rel(dev, seed: int, card: str) -> float:
    """bench.py:1596-1649: Katyusha (ns, m = 2N/B, B = 4,096, f32 rows) on
    the planted 65,536 x 1,024 Lasso with p = 64, in chunks of 8 outer
    steps until the cost is within rel 1e-3 of f*; returns the seconds
    (after one warm chunk, as bench.py times)."""
    import numpy as np

    from ciao_tpu_torch import LeastSquaresRows, NormL1
    from ciao_tpu_torch.solvers.katyusha import (
        KatyushaCfg, katyusha_init, katyusha_run,
    )
    from ciao_tpu_torch.utils.problems import make_lasso

    c = KATYUSHA_TTR
    Np = c["N"]
    prob = make_lasso(N=Np, n=n, p=c["p"], seed=seed, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A, device=dev),
                         torch.tensor(prob.b, device=dev), float(Np))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32, device=dev))
    target = prob.f_star + c["rel"] * abs(prob.f_star)
    A64 = torch.tensor(prob.A, dtype=torch.float64, device=dev)
    b64 = torch.tensor(prob.b, dtype=torch.float64, device=dev)

    def cost64(z):
        r = A64 @ z.double() - b64
        return float(0.5 * (r @ r) + prob.lam * z.double().abs().sum())

    cfg = KatyushaCfg(N=Np, batch=B, m=2 * Np // B, block=True, ns=True,
                      fused=True)
    st0 = katyusha_init(F, g, torch.zeros(n, device=dev),
                        float(np.max(prob.L)), 0.5, 0.5, 0, cfg)
    katyusha_run(F, g, st0, cfg, c["chunk"])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, outers, reached = st0, 0, False
    for _ in range(c["max_chunks"]):
        if cost64(st.x_tilde) <= target:
            reached = True
            break
        st = katyusha_run(F, g, st, cfg, c["chunk"])
        outers += c["chunk"]
    reached = reached or cost64(st.x_tilde) <= target
    dt = time.perf_counter() - t0
    rel = (cost64(st.x_tilde) - prob.f_star) / abs(prob.f_star)
    log(f"  time to rel {c['rel']:g}, {Np} x {n} planted Lasso (p="
        f"{c['p']}) [katyusha f32, ns, m={cfg.m}, B={B}]: "
        f"{'reached' if reached else 'NOT reached'} in {dt:.3f} s, "
        f"{outers} outer steps (~{2 * outers} epochs), rel {rel:.3e} "
        f"[{card}]")
    if not reached:
        raise AssertionError(f"katyusha time to rel: not reached in {outers} "
                             "outer steps")
    return dt


def time_vr(kind: str, r: dict, gen, dev, storage: str, card: str,
            B_: int = B) -> dict:
    """Kernel ``kind`` per step at the headline (blocks of ``B_`` rows) in
    turns with its plain version: calls of LAUNCH_STEPS steps (Katyusha,
    SARAH) or of LOOPLESS_LAUNCH steps (the loopless pair, whose windows
    are at most that long), one state stepped on in place. The bound
    counts the rows, b and (but SARAH) the anchor coefficients of the
    distinct blocks visited, the (n,) vectors in and out, and 4·B·n
    operations a step (SARAH's second margin: 6·B·n)."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.lsvrg import LOOPLESS_LAUNCH
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    K = LOOPLESS_LAUNCH if kind in ("lsvrg", "lkatyusha") else LAUNCH_STEPS
    S = vr_inputs(r["F"], gen, dev, B_, K)
    sc = vr_scalars(S, kind, B_, LAM)
    name = VR[kind][0]
    p, q = S["near"][0].clone(), S["near"][1].clone()
    state = {"katyusha": [p, q, torch.zeros_like(p)],
             "sarah": [torch.stack([S["xa"], p]), S["av"].clone()],
             "lsvrg": [p], "lkatyusha": [p, q]}[kind]
    vec = {"katyusha": 8, "sarah": 6, "lsvrg": 4, "lkatyusha": 7}[kind]
    bnd = step_bound(r["F"], S["starts"], B_, vec * 4 * n,
                     4 if kind == "sarah" else 8,
                     6.0 if kind == "sarah" else 4.0)

    def run(fn):
        def call():
            vr_call(kind, fn, S, sc, B_, state=state)
            return K
        return call
    times = time_turns(run(getattr(fb, name)), run(getattr(fb, f"{name}_ref")),
                       f"kernel {VR[kind][1]}, {storage} rows, N={N} n={n} "
                       f"B={B_}", card, bnd)
    if not all(bool(torch.isfinite(t).all()) for t in state):
        raise AssertionError(f"the timed kernel {VR[kind][1]} steps gave "
                             "non-finite values")
    return times


VR_GROUPS = {kind: {"kernel #6": ("apply_",),
                    f"kernel {label}": ("loopless_steps_kernel",)}
             for kind, (_, label) in VR.items()}
# the two-launch engines' kernels, which no window of a kernel of the
# persistent engine (#3, #4, #5, #8, #9, #10, #11, #12, #13, #14, #16, #17,
# #18, #19) may show (by function name: kernel #6's apply_rows_kernel is not
# one of them; the finish and prologue kernels that #3, #9, #8, #12, #13,
# #14, #18 and #19 launched before they joined the engine, and #18's table
# walk, among them)
TWO_LAUNCH = ("rows_kernel", "saga_finish_kernel", "svrg_finish_kernel",
              "point_kernel", "finito_finish_kernel",
              "lfinito_finish_kernel", "prox_kernel", "proshi_finish_kernel",
              "table_rows_kernel", "point_saga_finish_kernel",
              "shifted_point_kernel", "ssnm_point_kernel",
              "ssnm_finish_kernel")


def check_one_launch(tag: str, prof: dict, label: str, calls: int) -> None:
    """A profiled window of a kernel of the persistent engine: ``calls``
    wrapper calls (the window's, as profile_steps ran it) must be as many
    launches of ``loopless_steps_kernel`` (``label``'s group), and no
    kernel of the two-launch engine may have run."""
    seen = prof["calls"][label]
    stray = sorted(k for k in prof["names"] if kernel_name(k) in TWO_LAUNCH)
    log(f"  {tag}: {seen} launches of loopless_steps_kernel in the profiled "
        f"window for {calls} wrapper calls; two-launch kernels: "
        f"{stray or 'none'}")
    if seen != calls or stray or calls == 0:
        raise AssertionError(f"{tag}: {seen} kernel launches for {calls} "
                             f"calls, stray kernels {stray}")


def profile_one_launch(tag: str, fn, steps: int, card: str, groups: dict,
                       label: str, name: str, unit: str = "step") -> dict:
    """profile_steps of a window of kernel ``name`` (``label``'s group),
    then check_one_launch with the wrapper calls the window made (its
    launch count over profile_steps' runs of the window, divided by their
    number). The wrapper counts a call only once its launch has returned
    without error, so a trace that holds fewer launches than calls and
    no kernel of the two-launch engine has dropped a record (an H100 at
    700 W showed 9 of 10 launches of kernel #5 in one such window, with
    9/10 of their device time and the host clock unchanged): the window
    is profiled again, up to PROFILE_TRIES windows in all. Any other
    count, or a stray kernel, fails at once."""
    for attempt in range(1, PROFILE_TRIES + 1):
        before = counts()[name]
        prof = profile_steps(tag, fn, steps, card, groups, unit=unit)
        calls = (counts()[name] - before) // prof["runs"]
        seen = prof["calls"][label]
        stray = [k for k in prof["names"] if kernel_name(k) in TWO_LAUNCH]
        if seen < calls and not stray and attempt < PROFILE_TRIES:
            log(f"  {tag}: {seen} launches traced for {calls} wrapper "
                f"calls and no two-launch kernel: a dropped trace record; "
                f"profiling the window again ({attempt + 1} of "
                f"{PROFILE_TRIES})")
            continue
        check_one_launch(tag, prof, label, calls)
        return prof


def kernel_name(key: str) -> str:
    """The function name of a profiler's kernel key, without its return
    type, namespace and template arguments."""
    head = key.replace("(anonymous namespace)::", "")
    head = head.split("<")[0].split("(")[0].split()
    return head[-1].split("::")[-1] if head else key


PROSHI_GROUPS = {"kernel #18": ("loopless_steps_kernel",)}
SAGA_BLOCK_GROUPS = {"kernel #1": ("rows_kernel", "finish_kernel")}
FINITO_GROUPS = {"kernel #9": ("loopless_steps_kernel",)}
FINITO_STREAM_GROUPS = {"kernel #14": ("loopless_steps_kernel",)}
BLOCK_GROUPS = {"kernel #2": ("rows_kernel", "finish_kernel")}
LFINITO_GROUPS = {"kernel #6": ("apply_",),
                  "kernel #8": ("loopless_steps_kernel",)}


# ---------------------------------------------------------------------------
# SSNM #19, #13 and Point-SAGA #12, #15, and the row oracles beside least
# squares
# ---------------------------------------------------------------------------

PS_KINDS = ("lsq", "logistic", "huber", "sqhinge", "poisson")
# the kernel checks: d = 64 blocks, a masked window (steps k >= f)
NEW_SMALL = dict(N=8_192, n=128, B=128, K=64, f=23)
# bench.py's SSNM and Point-SAGA configurations at the headline
# (:1495-1550, :756-817): 8 epochs of 64 steps (four 128-step launches)
# each, cut from bench.py's 512 and 768 epochs; at the deep target
# (:952-987) two epochs of d = 1,280 steps (20 launches), cut from
# bench.py's timed runs
NEW_STEPS = MAIN_STEPS
NEW_DEEP_STEPS = 2 * (DEEP["N"] // DEEP["B"])
# the facades on the facades' planted Lasso (FACADE), batch 1,024, 4,096
# steps (64 epochs), default τ, η and γ: the fall of SSNM's (NormL1) cost −
# f* and of PointSAGA's (g = None) mean gradient must agree to three digits
# with a run of the same seed and schedule on the host's CPU
NEW_FACADE = dict(batch=1_024, maxit=4_097)
# deep_solve on logistic rows at tests/test_deep.py's shape (2,048 x 32,
# NormL1(0.05), batch 256): rel against the f64 optimum, bar 1e-6. The
# labels follow a planted direction, sign(A·w/√n + noise): with labels
# independent of A, as the JAX test draws them, the optimum is x = 0
LOGISTIC_DEEP = dict(N=2_048, n=32, lam=0.05, batch=256, chunk_epochs=8,
                     max_epochs=64, plateau_rtol=1e-4, ref_steps=20_000,
                     rel=1e-6)


def row_oracle(kind: str, A, b, gen):
    """The oracle ``kind`` on the rows ``A`` (f32, on the card) as bench.py
    builds it beside least squares (:724-740): logistic and squared hinge
    with the labels sign(b), Huber δ = 0.7 at scale N, Poisson on 0.05·A
    with counts |round(3·N(0, 1))|; and its moduli's max for γ (the
    margin's curvature bound times ‖a_i‖², Poisson's at |m| ≤ 1)."""
    from ciao_tpu_torch.oracles import (
        HuberRows, LeastSquaresRows, LogisticRows, PoissonRows,
        SquaredHingeRows,
    )

    rows = A.shape[0]
    sq = float((A * A).sum(dim=1).max())
    if kind == "lsq":
        return LeastSquaresRows(A, b, float(rows)), rows * sq
    if kind == "logistic":
        return LogisticRows(A, torch.sign(b)), 0.25 * sq
    if kind == "huber":
        return HuberRows(A, b, delta=0.7, scale=float(rows)), rows * sq
    if kind == "sqhinge":
        return SquaredHingeRows(A, torch.sign(b), scale=1.0), sq
    cnt = torch.round(3.0 * torch.randn(rows, generator=gen,
                                        device=A.device)).abs()
    return PoissonRows(0.05 * A, cnt, scale=1.0), math.e * 0.0025 * sq


def margin_rows(gen, dev, rows: int, cols: int, kind: str, storage: str):
    """Gaussian rows and offsets on the card as ``lasso`` draws them, the
    oracle ``kind`` on them stored ``storage``, and its moduli's max."""
    A = torch.randn(rows, cols, generator=gen, device=dev)
    b = torch.randn(rows, generator=gen, device=dev)
    F, Lmax = row_oracle(kind, A, b, gen)
    return (F if storage == "f32" else F.with_storage(storage)), Lmax


def ssnm_inputs(F, gen, dev, B_: int, K: int, tau: float, lam: float,
                distinct=False):
    """An SSNM-like state on the card: x small and random, c its
    coefficients, gb their mean row gradient, the stored points near x,
    K block starts (repeats included unless ``distinct``) and the scalars
    row at η = 1/(3τL_max)."""
    from ciao_tpu_torch.solvers.saga import block_starts

    rows, offs = F.coeff_rows_data()
    N_, n_ = rows.shape
    x = 0.05 * torch.randn(n_, generator=gen, device=dev)
    c = F.coeff_all(x)
    zb = x + 0.01 * torch.randn(N_ // B_, n_, generator=gen, device=dev)
    seed = int(torch.randint(1 << 30, (1,), generator=gen, device=dev))
    sq = (rows.float() ** 2).sum(1)
    if F.coeff_rows_scale() is not None:
        sq = sq * F.coeff_rows_scale() ** 2
    eta = 1.0 / (3.0 * tau * float(sq.max()) * N_)
    sc = torch.tensor([float(F.scale), eta, eta * lam, 1.0 / B_, 1.0 / N_,
                       float(F.coeff_mode), tau, 0.0], dtype=torch.float32,
                      device=dev)
    starts = (((torch.randperm(N_ // B_, generator=gen, device=dev)[:K]
                * B_).to(torch.int32)) if distinct
              else block_starts(seed, 1, K, N_ // B_, B_, dev))
    return dict(state=(c, zb, x, F.apply_all(c) / N_), sc=sc, starts=starts)


def ssnm_call(fn, F, S, B_, precision="highest", starts=None, state=None,
              **kw):
    """One call of ``fn`` (kernel #19, #13 or the plain version) from
    copies of the inputs' state (or on ``state``, in place)."""
    st = [t.clone() for t in S["state"]] if state is None else state
    rows, offs = F.coeff_rows_data()
    fn(rows, offs, S["starts"] if starts is None else starts, *st, S["sc"],
       B_, precision=precision, rs=F.coeff_rows_scale(), **kw)
    return st


def compare_ssnm(F, gen, dev, B_, K, tau, precision, tag, streamed=False,
                 f=None) -> float:
    """Kernel #19 (#13 with clamp count ``f`` when ``streamed``) and the
    plain version from one state on one schedule: x and the stored points
    within Z_TOL of their largest entry, c and gb within STATE_TOL; returns
    the largest absolute error of x."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = ssnm_inputs(F, gen, dev, B_, K, tau, LAM)
    kern = fb.ssnm_multistep_streamed if streamed else fb.ssnm_multistep
    kw = {} if f is None else dict(f=torch.tensor([f], dtype=torch.int32,
                                                  device=dev))
    plain_st = None if f is None else S["starts"][:f]
    kout = ssnm_call(kern, F, S, B_, precision, **kw)
    rout = ssnm_call(fb.ssnm_multistep_ref, F, S, B_, precision,
                     starts=plain_st)
    torch.cuda.synchronize()
    lowp = fb._lowp(F.coeff_rows_data()[0], precision)
    moved = float((rout[2] - S["state"][2]).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move x")
    rels = [check_rel(tag, i, k, r, (Z_TOL if i in (1, 2) else STATE_TOL)[
        lowp]) for i, (k, r) in enumerate(zip(kout, rout))]
    err = float((kout[2] - rout[2]).abs().max())
    log(f"  {tag}: max |dx| {err:.3e}, rel errors c, zb, x, gb "
        f"{', '.join(f'{r:.2e}' for r in rels)}; moved {moved:.3e}")
    return err


def ssnm_bit_for_bit(F, gen, dev, B_, K, f, tag) -> None:
    """Kernel #19's K-step call equals its K one-step calls, #13 equals
    #19, and #13 with f read on the device equals the first f steps alone,
    all bit for bit: y is formed once a step, by the prologue or the
    previous finish, with one rounding, and a masked step writes
    nothing."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = ssnm_inputs(F, gen, dev, B_, K, 0.5, LAM)
    whole = ssnm_call(fb.ssnm_multistep, F, S, B_)
    steps = [t.clone() for t in S["state"]]
    for k in range(K):
        ssnm_call(fb.ssnm_multistep, F, S, B_, starts=S["starts"][k:k + 1],
                  state=steps)
    i32 = dict(dtype=torch.int32, device=dev)
    pairs = ((whole, steps),
             (ssnm_call(fb.ssnm_multistep_streamed, F, S, B_), whole),
             (ssnm_call(fb.ssnm_multistep_streamed, F, S, B_,
                        f=torch.tensor([f], **i32)),
              ssnm_call(fb.ssnm_multistep, F, S, B_,
                        starts=S["starts"][:f])))
    torch.cuda.synchronize()
    for got, want in pairs:
        if not all(torch.equal(a, b_) for a, b_ in zip(got, want)):
            raise AssertionError(f"{tag}: not bit for bit")
    log(f"  {tag}: the {K}-step call of #19 equals its one-step calls and "
        f"#13's; #13 with f = {f} equals the first {f} steps alone, bit for "
        "bit")


def ps_inputs(F, gen, dev, B_: int, K: int, gamma: float, distinct=False):
    """A Point-SAGA-like state on the card: x small and random, c its
    coefficients, av their mean row gradient, the row square-norms, K
    block starts (repeats included unless ``distinct``) and the scalars
    row at ``gamma``."""
    from ciao_tpu_torch.solvers.point_saga import _sqnorms
    from ciao_tpu_torch.solvers.saga import block_starts

    rows, _ = F.coeff_rows_data()
    N_, n_ = rows.shape
    x = 0.05 * torch.randn(n_, generator=gen, device=dev)
    c = F.coeff_all(x)
    seed = int(torch.randint(1 << 30, (1,), generator=gen, device=dev))
    sc = torch.tensor([float(getattr(F, "scale", 1.0)), gamma, 1.0 / B_,
                       1.0 / N_, float(F.coeff_mode),
                       float(getattr(F, "delta", 0.0))], dtype=torch.float32,
                      device=dev)
    starts = (((torch.randperm(N_ // B_, generator=gen, device=dev)[:K]
                * B_).to(torch.int32)) if distinct
              else block_starts(seed, 1, K, N_ // B_, B_, dev))
    return dict(state=(c, x, F.apply_all(c) / N_), na=_sqnorms(F, N_), sc=sc,
                starts=starts)


def ps_call(fn, F, S, B_, precision="highest", starts=None, state=None,
            **kw):
    """One call of ``fn`` (kernel #12, #15 or the plain version) from
    copies of the inputs' state (or on ``state``, in place)."""
    c, x, av = [t.clone() for t in S["state"]] if state is None else state
    rows, offs = F.coeff_rows_data()
    fn(rows, offs, S["na"], c, S["starts"] if starts is None else starts, x,
       av, S["sc"], B_, mode=F.coeff_mode, precision=precision,
       rs=F.coeff_rows_scale(), **kw)
    return [c, x, av]


def compare_ps(F, Lmax, gen, dev, B_, K, precision, tag, streamed=False,
               f=None, gamma=None) -> float:
    """Kernel #12 (#15 with clamp count ``f`` when ``streamed``) against
    the plain version step by step, at 10x the default γ (the Newton
    solves then move θ well off its warm start): each step of the plain
    trajectory is taken once more by the kernel from the same state (x
    within Z_TOL of its largest entry, c and av within STATE_TOL), and the
    kernel's whole K-step call (steps k ≥ f masked) equals its chain of
    one-step calls bit for bit. Where the dots round to bf16, a last-bit
    difference of v can flip the bf16 rounding of a component, and the
    states drift apart step by step (1.1-2.7e-5 of x's largest entry after
    64 steps on an H100 at 700 W), so a K-step comparison holds no fixed
    bound. Returns the largest absolute error of x over the steps."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = ps_inputs(F, gen, dev, B_, K,
                  10.0 / (3.0 * Lmax) if gamma is None else gamma)
    kern = (fb.point_saga_multistep_streamed if streamed
            else fb.point_saga_multistep)
    lowp = fb._lowp(F.coeff_rows_data()[0], precision)
    ref = [t.clone() for t in S["state"]]
    chain = [t.clone() for t in S["state"]]
    worst, err = [0.0, 0.0, 0.0], 0.0
    for k in range(K if f is None else f):
        st = S["starts"][k:k + 1]
        one = ps_call(kern, F, S, B_, precision, starts=st,
                      state=[t.clone() for t in ref])
        ps_call(kern, F, S, B_, precision, starts=st, state=chain)
        ps_call(fb.point_saga_multistep_ref, F, S, B_, precision, starts=st,
                state=ref)
        torch.cuda.synchronize()
        for i, tol in ((0, STATE_TOL), (1, Z_TOL), (2, STATE_TOL)):
            worst[i] = max(worst[i], check_rel(f"{tag} step {k}", i, one[i],
                                               ref[i], tol[lowp]))
        err = max(err, float((one[1] - ref[1]).abs().max()))
    kw = {} if f is None else dict(f=torch.tensor([f], dtype=torch.int32,
                                                  device=dev))
    full = ps_call(kern, F, S, B_, precision, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(full, chain)):
        raise AssertionError(f"{tag}: the K-step call differs from its "
                             "one-step calls")
    moved = float((ref[1] - S["state"][1]).abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag}: the steps did not move x")
    log(f"  {tag}: per step max |dx| {err:.3e}, rel errors c, x, av "
        f"{', '.join(f'{r:.2e}' for r in worst)}; the {K}-step call"
        + ("" if f is None else f" (steps >= {f} masked)")
        + f" equals its one-step calls bit for bit; moved {moved:.3e}")
    return err


def ps_bit_for_bit(F, Lmax, gen, dev, B_, K, f, tag) -> None:
    """Kernel #15 with no clamp count equals #12 (one C entry), #15 with
    f read on the device equals #12 on the first f steps alone, and f = 0
    writes nothing, all bit for bit."""
    from ciao_tpu_torch.ops import fused_block as fb

    S = ps_inputs(F, gen, dev, B_, K, 10.0 / (3.0 * Lmax))
    i32 = dict(dtype=torch.int32, device=dev)
    pairs = ((ps_call(fb.point_saga_multistep_streamed, F, S, B_),
              ps_call(fb.point_saga_multistep, F, S, B_)),
             (ps_call(fb.point_saga_multistep_streamed, F, S, B_,
                      f=torch.tensor([f], **i32)),
              ps_call(fb.point_saga_multistep, F, S, B_,
                      starts=S["starts"][:f])),
             (ps_call(fb.point_saga_multistep_streamed, F, S, B_,
                      f=torch.tensor([0], **i32)), list(S["state"])))
    torch.cuda.synchronize()
    for got, want in pairs:
        if not all(torch.equal(a, b_) for a, b_ in zip(got, want)):
            raise AssertionError(f"{tag}: not bit for bit")
    log(f"  {tag}: #15 equals #12, with f = {f} the first {f} steps of "
        "#12, with f = 0 its inputs, bit for bit")


def phase_check_new(gen, dev) -> dict:
    """3o-3p: kernels #19 and #13 against their plain version in f32
    "highest" and "default", bf16 and int8 rows at τ = 0.5 and τ = 1, #13
    with f = K and f = 23, the bit-for-bit identities, K = 8 at the
    headline, and at the persistent engine's edges (#19 f32 and int8, #13
    f32 with the edge's clamp count); kernels #12 and #15 in all five
    oracle modes with f32 and int8 rows (and bf16 for least squares and
    logistic, "default" for least squares) step by step, #15 masked and
    bit for bit #12's, K = 8 at the headline, and at the engine's edges
    (#12 and #15 with the edge's clamp count, logistic f32 and int8)."""
    s = NEW_SMALL
    errs = dict.fromkeys(("ssnm_multistep", "ssnm_multistep_streamed",
                          "point_saga_multistep",
                          "point_saga_multistep_streamed"), 0.0)
    shape = f"N={s['N']} n={s['n']} B={s['B']} K={s['K']}"
    for storage, precision in STORAGES:
        F, _, _ = lasso(gen, dev, s["N"], s["n"], storage)
        for tau in (0.5, 1.0):
            tag = f"{shape} {storage}/{precision} tau={tau}"
            errs["ssnm_multistep"] = max(errs["ssnm_multistep"], compare_ssnm(
                F, gen, dev, s["B"], s["K"], tau, precision, f"#19 {tag}"))
        for f in (s["K"], s["f"]):
            errs["ssnm_multistep_streamed"] = max(
                errs["ssnm_multistep_streamed"], compare_ssnm(
                    F, gen, dev, s["B"], s["K"], 0.5, precision,
                    f"#13 {shape} {storage}/{precision} f={f}",
                    streamed=True, f=f))
        if precision == "highest" and storage != "bf16":
            ssnm_bit_for_bit(F, gen, dev, s["B"], s["K"], s["f"],
                             f"#19/#13 {shape} {storage}")
        del F
    for kind in PS_KINDS:
        cases = [("f32", "highest"), ("int8", "highest")]
        if kind in ("lsq", "logistic"):
            cases.append(("bf16", "highest"))
        if kind == "lsq":
            cases.append(("f32", "default"))
        for storage, precision in cases:
            F, Lm = margin_rows(gen, dev, s["N"], s["n"], kind, storage)
            tag = f"{shape} {kind} {storage}/{precision}"
            errs["point_saga_multistep"] = max(
                errs["point_saga_multistep"], compare_ps(
                    F, Lm, gen, dev, s["B"], s["K"], precision, f"#12 {tag}"))
            errs["point_saga_multistep_streamed"] = max(
                errs["point_saga_multistep_streamed"], compare_ps(
                    F, Lm, gen, dev, s["B"], s["K"], precision,
                    f"#15 {tag} f={s['f']}", streamed=True, f=s["f"]))
            if precision == "highest":
                ps_bit_for_bit(F, Lm, gen, dev, s["B"], s["K"], s["f"],
                               f"#15/#12 {tag}")
            del F
    for storage in ("f32", "int8"):
        F, _, _ = lasso(gen, dev, N, n, storage)
        errs["ssnm_multistep"] = max(errs["ssnm_multistep"], compare_ssnm(
            F, gen, dev, B, HEADLINE_K, 0.5, "highest",
            f"#19 N={N} n={n} B={B} K={HEADLINE_K} {storage}"))
        del F
        for kind in ("lsq", "logistic"):
            F, Lm = margin_rows(gen, dev, N, n, kind, storage)
            errs["point_saga_multistep"] = max(
                errs["point_saga_multistep"], compare_ps(
                    F, Lm, gen, dev, B, HEADLINE_K, "highest",
                    f"#12 N={N} n={n} B={B} K={HEADLINE_K} {kind} "
                    f"{storage}"))
            del F
        torch.cuda.empty_cache()
    for N_, n_, B_, K_, f_ in LOOPLESS_EDGES:
        for storage in ("f32", "int8"):
            F, _, _ = lasso(gen, dev, N_, n_, storage)
            tag = f"N={N_} n={n_} B={B_} K={K_} {storage}"
            errs["ssnm_multistep"] = max(errs["ssnm_multistep"], compare_ssnm(
                F, gen, dev, B_, K_, 0.5, "highest", f"#19 {tag}"))
            if storage == "f32":
                errs["ssnm_multistep_streamed"] = max(
                    errs["ssnm_multistep_streamed"], compare_ssnm(
                        F, gen, dev, B_, K_, 0.5, "highest",
                        f"#13 {tag} f={f_}", streamed=True, f=f_))
            del F
            F, Lm = margin_rows(gen, dev, N_, n_, "logistic", storage)
            errs["point_saga_multistep"] = max(
                errs["point_saga_multistep"], compare_ps(
                    F, Lm, gen, dev, B_, K_, "highest",
                    f"#12 N={N_} n={n_} B={B_} K={K_} logistic {storage}"))
            errs["point_saga_multistep_streamed"] = max(
                errs["point_saga_multistep_streamed"], compare_ps(
                    F, Lm, gen, dev, B_, K_, "highest",
                    f"#15 N={N_} n={n_} B={B_} K={K_} logistic {storage} "
                    f"f={f_}", streamed=True, f=f_))
            del F
            torch.cuda.empty_cache()
    return errs


SSNM_GROUPS = {"kernel #19": ("loopless_steps_kernel",)}
SSNM_STREAM_GROUPS = {"kernel #13": ("loopless_steps_kernel",)}
PS_GROUPS = {"kernel #12": ("loopless_steps_kernel",)}
PS_STREAM_GROUPS = {"kernel #15": ("loopless_steps_kernel",)}


def check_run(tag, st, moved, want, obj0, obj1, steps) -> None:
    """A run's launches, finite state, falling objective and step count."""
    for t in st:
        if isinstance(t, torch.Tensor) and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{tag}: a state field is not finite")
    if moved != want:
        raise AssertionError(f"{tag}: launches {moved}, expected {want}")
    if not (math.isfinite(obj1) and obj1 < obj0) or st.it != steps + 1:
        raise AssertionError(f"{tag}: objective {obj0} -> {obj1}, it "
                             f"{st.it}")


def timed_run(run, st0, steps):
    """(state, ms per step by the host clock, launches by kernel)."""
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st0, steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return st, ms, {k: v - before[k] for k, v in counts().items()
                    if v != before[k]}


def run_ssnm(F, g, Lmax: float, B_: int, steps: int, streamed: bool,
             tag: str, card: str) -> dict:
    """SSNM at bench.py's setting (τ = 0.5, η = 1/(1.5·L_max), NormL1)
    through ssnm_init and ssnm_run on kernel #19 (#13 when ``streamed``):
    launches, a falling objective, ms per step."""
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS
    from ciao_tpu_torch.solvers.ssnm import SSNMCfg, ssnm_init, ssnm_run

    rows = F.coeff_rows_data()[0]
    N_, n_ = rows.shape
    cfg = SSNMCfg(N=N_, batch=B_, fused=not streamed, fused_stream=streamed)
    st0 = ssnm_init(F, g, torch.zeros(n_, device=rows.device), 0.5,
                    1.0 / (1.5 * Lmax), 0, cfg)
    name = "ssnm_multistep" + ("_streamed" if streamed else "")
    obj0 = cost(F, g, st0.x)
    st, ms, moved = timed_run(lambda s, k: ssnm_run(F, g, s, cfg, k), st0,
                              steps)
    obj1 = cost(F, g, st.x)
    log(f"  SSNM {tag}: N={N_} n={n_} B={B_}, {steps} steps: launches "
        f"{moved}, objective {obj0:.6e} -> {obj1:.6e}, {ms:.4f} ms/step end "
        f"to end [{card}]")
    check_run(f"SSNM {tag}", st, moved,
              {name: -(-steps // LAUNCH_STEPS)}, obj0, obj1, steps)
    return dict(ms=ms, F=F, g=g, st=st0, cfg=cfg,
                run=lambda k: ssnm_run(F, g, st0, cfg, k))


def cost64(F, g, z) -> float:
    """``cost`` at the f64 copy of z: the products widen the rows to f64.
    bench.py's γ for the logistic, squared-hinge and Poisson rows moves
    their objective by less than an f32 ulp of it in NEW_STEPS steps."""
    return cost(F, g, z.double())


def run_ps(F, gamma: float, B_: int, steps: int, streamed: bool, tag: str,
           card: str, objective=cost) -> dict:
    """Point-SAGA (g = Zero) at ``gamma`` through point_saga_init and
    point_saga_run on kernel #12 (#15 when ``streamed``): launches, a
    falling ``objective``, ms per step."""
    from ciao_tpu_torch.prox import Zero
    from ciao_tpu_torch.solvers.point_saga import (
        PointSAGACfg, point_saga_init, point_saga_run,
    )
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    rows = F.coeff_rows_data()[0]
    N_, n_ = rows.shape
    g = Zero()
    cfg = PointSAGACfg(N=N_, batch=B_, block=True, fused=not streamed,
                       fused_stream=streamed)
    st0 = point_saga_init(F, g, torch.zeros(n_, device=rows.device), gamma,
                          0, cfg)
    name = "point_saga_multistep" + ("_streamed" if streamed else "")
    obj0 = objective(F, g, st0.x)
    st, ms, moved = timed_run(lambda s, k: point_saga_run(F, g, s, cfg, k),
                              st0, steps)
    obj1 = objective(F, g, st.x)
    log(f"  Point-SAGA {tag}: N={N_} n={n_} B={B_}, γ={gamma:.3e}, {steps} "
        f"steps: launches {moved}, objective {obj0:.12e} -> {obj1:.12e}, "
        f"{ms:.4f} ms/step end to end [{card}]")
    check_run(f"Point-SAGA {tag}", st, moved,
              {name: -(-steps // LAUNCH_STEPS)}, obj0, obj1, steps)
    return dict(ms=ms, F=F, st=st0, cfg=cfg,
                run=lambda k: point_saga_run(F, g, st0, cfg, k))


def run_new_headline(gen, dev, card: str) -> dict:
    """4o, 4q: SSNM and Point-SAGA at the headline, each with a profiled
    window (device busy time and idle share). Point-SAGA as bench.py:
    least squares f32 and int8 at γ = 1/(3·L_max), logistic f32 and int8
    at γ = 1/(3·0.25·max ‖a_i‖²·N), squared hinge f32 at 1/(3·L_max),
    Poisson f32 at 1/(30·L_max) (L_max of the least-squares rows)."""
    from ciao_tpu_torch.prox import NormL1

    out = {}
    for storage in ("f32", "int8"):
        F, _, L = lasso(gen, dev, N, n, storage)
        g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
        r = run_ssnm(F, g, float(L.max()), B, NEW_STEPS, False,
                     f"headline {storage}", card)
        r["prof"] = profile_one_launch(
            f"SSNM at the headline, {storage} rows", lambda: r["run"](128),
            128, card, SSNM_GROUPS, "kernel #19", "ssnm_multistep")
        out["ssnm", storage] = r
        del F
    for kind, storage in (("lsq", "f32"), ("lsq", "int8"),
                          ("logistic", "f32"), ("logistic", "int8"),
                          ("sqhinge", "f32"), ("poisson", "f32")):
        A = torch.randn(N, n, generator=gen, device=dev)
        b = torch.randn(N, generator=gen, device=dev)
        Lm = float((A * A).sum(dim=1).max()) * N
        F, _ = row_oracle(kind, A, b, gen)
        del A
        if storage != "f32":
            F = F.with_storage(storage)
        gamma = {"lsq": 1.0 / (3.0 * Lm), "logistic": 1.0 / (0.75 * Lm),
                 "sqhinge": 1.0 / (3.0 * Lm),
                 "poisson": 1.0 / (30.0 * Lm)}[kind]
        r = run_ps(F, gamma, B, NEW_STEPS, False,
                   f"headline {kind} {storage}", card, cost64)
        r["prof"] = profile_one_launch(
            f"Point-SAGA at the headline, {kind} {storage} rows",
            lambda: r["run"](128), 128, card, PS_GROUPS, "kernel #12",
            "point_saga_multistep")
        out["ps", kind, storage] = r
        del F
        torch.cuda.empty_cache()
    return out


def run_new_deep(prob, gen, dev, card: str) -> dict:
    """3o/3p at the deep shape (K = 8 of #13, and of #15 on least-squares
    and on logistic rows, against the plain version), then 4p, 4r: SSNM
    (#13, NormL1(1), τ = 0.5, η = 1/(1.5·L_max)) and least-squares
    Point-SAGA (#15, g = Zero, γ = 1/(3·L_max)) on the deep target, f32
    and int8 rows, NEW_DEEP_STEPS each, with launch counts and falling
    objectives. The logistic rows are the deep target's with the labels
    sign(b), at 10x the default γ (γ‖a_i‖² up to 13: every Newton solve
    moves θ well off its warm start)."""
    from ciao_tpu_torch.oracles import LogisticRows

    errs = {"ssnm_multistep_streamed": 0.0,
            "point_saga_multistep_streamed": 0.0}
    Lm = float(prob.L.max())
    logistic = LogisticRows(prob.A, torch.sign(prob.b))
    Lg = 0.25 * Lm / DEEP["N"]
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        tag = f"N={DEEP['N']} n={DEEP['n']} B={DEEP['B']} K={DEEP_K} {storage}"
        errs["ssnm_multistep_streamed"] = max(
            errs["ssnm_multistep_streamed"], compare_ssnm(
                F, gen, dev, DEEP["B"], DEEP_K, 0.5, "highest", f"#13 {tag}",
                streamed=True))
        errs["point_saga_multistep_streamed"] = max(
            errs["point_saga_multistep_streamed"], compare_ps(
                F, Lm, gen, dev, DEEP["B"], DEEP_K, "highest", f"#15 {tag}",
                streamed=True, gamma=1.0 / (3.0 * Lm)))
        F = logistic if storage == "f32" else logistic.with_storage(storage)
        errs["point_saga_multistep_streamed"] = max(
            errs["point_saga_multistep_streamed"], compare_ps(
                F, Lg, gen, dev, DEEP["B"], DEEP_K, "highest",
                f"#15 {tag} logistic", streamed=True))
        del F
    del logistic
    torch.cuda.empty_cache()
    reset_counts()
    runs = {}
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        runs["ssnm", storage] = run_ssnm(
            F, prob.prox(), Lm, DEEP["B"], NEW_DEEP_STEPS, True,
            f"deep target {storage}", card)
        runs["ps", storage] = run_ps(
            F, 1.0 / (3.0 * Lm), DEEP["B"], NEW_DEEP_STEPS, True,
            f"deep target lsq {storage}", card)
    c = counts()
    want = {"ssnm_multistep_streamed", "point_saga_multistep_streamed"}
    if any(c[k] == 0 for k in want) or sum(c.values()) != sum(
            c[k] for k in want):
        raise AssertionError(f"the deep SSNM and Point-SAGA paths did not "
                             f"run on kernels #13 and #15 alone: {c}")
    log(f"phase 4p/4r deep-target SSNM and Point-SAGA: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    return dict(errs=errs, runs=runs, launches=c)


def run_new_facades(dev, prob, F, card: str) -> None:
    """4s: the SSNM facade (NormL1) and the PointSAGA facade (g = None,
    block sampling) as a user calls them on the facades' planted Lasso,
    on the card and then on the CPU with the same seed (the same block
    draws): cost − f*, and the mean gradient's norm, must fall by the same
    factor to three digits, and every card run takes #19 or #12."""
    import numpy as np

    import ciao_tpu_torch as ct

    kw = NEW_FACADE
    F_cpu = ct.LeastSquaresRows(F.A.cpu(), F.b.cpu(), F.scale.cpu())

    def gap(Fx, x):
        return prob.cost(x.double().cpu().numpy()) - prob.f_star

    def gnorm(Fx, x):
        return float(torch.linalg.vector_norm(Fx.grad_sum_all(x))
                     / Fx.num_terms)

    for make, name, measure, extra in (
            (lambda d: ct.SSNM(maxit=kw["maxit"], batch=kw["batch"],
                               device=d), "ssnm_multistep", gap,
             lambda d: dict(g=ct.NormL1(prob.lam))),
            (lambda d: ct.PointSAGA(maxit=kw["maxit"], batch=kw["batch"],
                                    block_sampling=True, device=d),
             "point_saga_multistep", gnorm, lambda d: {})):
        folds, moved, dt = {}, None, 0.0
        for where, Fx in ((dev, F), (torch.device("cpu"), F_cpu)):
            x0 = torch.zeros(n, device=where)
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, _ = make(where)(x0, F=Fx, L=prob.L, **extra(where))
            torch.cuda.synchronize()
            if Fx is F:
                dt = time.perf_counter() - t0
                moved = {k: v - before[k] for k, v in counts().items()
                         if v != before[k]}
            m0, m1 = measure(Fx, x0), measure(Fx, x)
            folds["card" if Fx is F else "cpu"] = (m0, m1, m0 / m1)
        m0, m1, fold = folds["card"]
        what = "cost - f*" if name == "ssnm_multistep" else "|mean grad|"
        log(f"  facade {type(make(None)).__name__}(batch={kw['batch']}, "
            f"maxit={kw['maxit']}) on planted make_lasso(N={FACADE['N']}, "
            f"n={n}): {what} {m0:.6e} -> {m1:.6e} ({fold:.4f}-fold; the "
            f"CPU run of the same seed {folds['cpu'][2]:.4f}-fold), launches "
            f"{moved}, {dt:.3f} s [{card}]")
        if not (math.isfinite(fold) and fold > 1.0
                and np.isclose(fold, folds["cpu"][2], rtol=1e-3)):
            raise AssertionError(f"facade {name}: fold {fold}, CPU "
                                 f"{folds['cpu'][2]}")
        if set(moved) != {name}:
            raise AssertionError(f"facade {name}: launches {moved}")


def run_logistic_deep(dev, card: str) -> float:
    """4t: deep_solve on f32 LogisticRows (the logistic formula, mode 1,
    on kernel #3 in the stochastic stage) at tests/test_deep.py's shape,
    against the f64 optimum of 20,000 FISTA steps at the spectral stepsize
    (the port's stepwise FISTA on the CPU); rel must be within 1e-6."""
    from ciao_tpu_torch import FISTA, LogisticRows, NormL1, deep_solve

    c = LOGISTIC_DEEP
    g64 = torch.Generator().manual_seed(7)
    A = torch.randn(c["N"], c["n"], generator=g64)
    w = torch.randn(c["n"], generator=g64)
    y = torch.sign(A @ w / math.sqrt(c["n"])
                   + torch.randn(c["N"], generator=g64))
    A64, y64 = A.double(), y.double()
    lam_sp = float(torch.linalg.eigvalsh(0.25 * A64.T @ A64 / c["N"]).max())
    xref, _ = FISTA(maxit=c["ref_steps"], gamma=0.95 / lam_sp)(
        torch.zeros(c["n"], dtype=torch.float64),
        F=LogisticRows(A64, y64), g=NormL1(torch.tensor(
            c["lam"], dtype=torch.float64)), N=c["N"])

    def cost64(z):
        m = A64 @ z.double().cpu()
        return float(torch.nn.functional.softplus(-y64 * m).mean()
                     + c["lam"] * z.double().cpu().abs().sum())

    f_star = cost64(xref)
    if not bool((xref != 0).any()):
        raise AssertionError("deep_solve logistic: the optimum is x = 0")
    F = LogisticRows(A.to(dev), y.to(dev))
    t0 = time.perf_counter()
    x, info = deep_solve(
        torch.zeros(c["n"], device=dev), F,
        NormL1(torch.tensor(c["lam"], device=dev)),
        L=0.25 * (A * A).sum(dim=1).to(dev), N=c["N"], batch=c["batch"],
        chunk_epochs=c["chunk_epochs"], max_epochs=c["max_epochs"],
        plateau_rtol=c["plateau_rtol"])
    torch.cuda.synchronize()
    rel = (cost64(x) - f_star) / abs(f_star)
    log(f"  deep_solve logistic {c['N']} x {c['n']} NormL1({c['lam']}): rel "
        f"{rel:.3e} against the f64 optimum (bar {c['rel']:g}), polish steps "
        f"{info.polish_steps}, {time.perf_counter() - t0:.3f} s [{card}]")
    if not -c["rel"] < rel <= c["rel"]:
        raise AssertionError(f"deep_solve logistic: rel {rel}")
    return rel


def time_new(r: dict, kind: str, gen, dev, tag: str, card: str) -> dict:
    """Kernel #19/#13 (``kind`` "ssnm") or #12/#15 ("ps") per step in
    turns with its plain version: 128-step calls, one state stepped on in
    place. The bound counts the rows, b and c (read and written; and
    Point-SAGA's na, int8's rs) of the distinct blocks visited once, the
    (n,) vectors in and out (SSNM: x, gb and the visited stored points;
    Point-SAGA: x, av), and 4·B·n operations a step."""
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    F, cfg = r["F"], r["cfg"]
    rows = F.coeff_rows_data()[0]
    n_, B_ = rows.shape[1], cfg.batch
    streamed = cfg.fused_stream
    if kind == "ssnm":
        S = ssnm_inputs(F, gen, dev, B_, LAUNCH_STEPS, 0.5, LAM)
        name = "ssnm_multistep" + ("_streamed" if streamed else "")
        blocks = int(torch.unique(S["starts"]).numel())
        bnd = step_bound(F, S["starts"], B_, 16 * n_ + 8 * n_ * blocks, 12)
        call = ssnm_call
    else:
        S = ps_inputs(F, gen, dev, B_, LAUNCH_STEPS, r["st"].gamma.item())
        name = "point_saga_multistep" + ("_streamed" if streamed else "")
        bnd = step_bound(F, S["starts"], B_, 16 * n_, 16)
        call = ps_call
    state = [t.clone() for t in S["state"]]

    def run(fn):
        def go():
            call(fn, F, S, B_, state=state)
            return LAUNCH_STEPS
        return go
    times = time_turns(run(getattr(fb, name)), run(getattr(fb, f"{name}_ref")),
                       tag, card, bnd)
    if not all(bool(torch.isfinite(t).all()) for t in state):
        raise AssertionError(f"{tag}: the timed steps gave non-finite values")
    return times


# ---------------------------------------------------------------------------
# PANOC/ZeroFPR on kernel #7, and the splitting methods on kernel #6
# ---------------------------------------------------------------------------

# bench.py's PANOC configurations at the headline (:745-754, :838-848):
# ZeroFPR fused at f32, bf16 and int8 rows and PANOC fused with adaptive γ
# off and on, 128 steps each from x0 = 0, γ = 0.95/mean(L), σ = 0.5·0.05/(2γ)
PANOC_STEPS = 128
# the Davis-Yin and Condat-Vũ configurations (:850-903): 600 steps each
SPLIT_STEPS = 600
DENSE_MAPS = (1_024, 8_192)
# the PANOC and ZeroFPR facades on the facades' planted Lasso (FACADE), as a
# user calls them with L, maxit steps: on the card with f32 rows, cost − f*
# at most PANOC_FACADE["rel"]·f*; on the host's CPU in f64 on the same
# (f32-rounded) data, below the card's. f32 cannot reach 1e-6·f* here: the
# margins a_i·x − b_i cancel most of b_i, so an f32 run stalls
# at 1.1-1.3e-5·f* on an H100 (the CPU's f64 runs of the same data reach
# 6.9e-6 and 1.6e-7), and the bar keeps 4x margin
PANOC_FACADE = dict(maxit=200, rel=5e-5)
# kernel #7's checks: every mode and storage at APPLY_SMALL, ragged N and
# widths that are not whole 16-byte chunks. The value within 1e-6 of
# Σ|f_i|; c and gsum relative to their largest entries, by whether the dots
# round to bf16: there a margin that differs by an ulp between the kernel
# and the plain version (other summation orders) can flip a bf16-rounded
# weighted coefficient by 2^-8 and move gsum by 2^-8·|c_i·a_i| (an H100
# run saw 4.7e-5 of the largest entry in the logistic mode), so gsum keeps
# kernel #6's bound, 1e-4
VALUE_TOL = 1e-6
C_TOL = {False: 1e-6, True: 1e-5}
GSUM_TOL = {False: 1e-6, True: 1e-4}
PANOC_GROUPS = {"kernel #7": ("apply_",)}
# kernel #6's c and gsum from the walk of 48 KB tiles, on golden_inputs with
# 64 CTAs (43 at int8 rows: one a tile) (NVIDIA H100 80GB HBM3, CUDA 12.8's
# nvcc): sha256, first 16 hex digits. The inputs are dyadic, so the margins
# and the least-squares, Huber and squared-hinge sums are exact in any order:
# three of the five are the earlier walk's digests too
APPLY_GOLDEN = {
    ("f32", "highest", 0): "4ed0a7e6a73817d1",
    ("f32", "highest", 1): "d39380cf7f2921d4",
    ("f32", "default", 2): "fbb6d4962361206a",
    ("bf16", "highest", 3): "4fe538cb1badfe5b",
    ("int8", "highest", 4): "812e74b895accb8d",
}


def golden_inputs(dev, storage, N_=8_192, n_=256):
    """Exact dyadic rows, offsets and z (no generator, no libm): the inputs
    of kernel #6's pinned digests."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    i = torch.arange(N_)[:, None]
    j = torch.arange(n_)[None, :]
    F = LeastSquaresRows((((i * 31 + j * 17) % 97) - 48).float() / 64,
                         ((torch.arange(N_) * 13 % 29) - 14).float() / 8, 1.0)
    if storage != "f32":
        F = F.with_storage(storage)
    A, b = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    z = ((torch.arange(n_) * 7 % 11) - 5).float() / 256
    return A.to(dev), b.to(dev), z.to(dev), None if rs is None else rs.to(dev)


def apply_digest(dev, storage, precision, mode, ctas=64) -> str:
    """Kernel #6's c and gsum on ``golden_inputs`` with ``ctas`` CTAs, or
    one a tile where the tiles are fewer (the wrapper's own count depends
    on the card's SMs), as a digest."""
    import hashlib

    from ciao_tpu_torch.ops import fused_block as fb

    A, b, z, rs = golden_inputs(dev, storage)
    N_, n_ = A.shape
    rows = fb._apply_rows(n_, A.element_size())
    ctas = min(ctas, -(-N_ // rows))  # at most one a tile: 43 at int8
    sc = torch.tensor([1.0, mode, 0.5], device=dev)
    c = torch.empty(N_, device=dev)
    g = torch.empty(n_, device=dev)
    hi = torch.empty(ctas, n_, device=dev)
    lo = torch.empty(ctas, n_, device=dev)
    fb._call("coeff_apply_all", dev, A.data_ptr(), fb._STORAGE_CODES[A.dtype],
             int(fb._lowp(A, precision)), b.data_ptr(), fb._ptr(rs),
             z.data_ptr(), sc.data_ptr(), c.data_ptr(), g.data_ptr(),
             hi.data_ptr(), lo.data_ptr(), N_, n_, rows, ctas)
    torch.cuda.synchronize()
    h = hashlib.sha256(c.cpu().numpy().tobytes())
    h.update(g.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mode_offsets(b, mode: int):
    """Offsets for a formula mode: labels ±1 for the classification modes,
    counts for Poisson, the Gaussian offsets otherwise."""
    if mode in (1, 3):
        return torch.sign(b)
    if mode == 4:
        return torch.floor(2.0 * b.abs())
    return b


def compare_value_apply(rows, b, z, sc, precision, rs, tag) -> float:
    """Kernel #7 against its plain version on one input: the value within
    VALUE_TOL of Σ|f_i|, c and gsum within C_TOL and GSUM_TOL of their
    largest entries; a second launch repeats bit for bit; c and gsum are
    kernel #6's to the bit (the same tiles). Returns the largest
    absolute error of c and gsum (the value's, up to 1e11 at the
    headline, is logged relative to Σ|f_i|).

    Where the dots round to bf16, gsum's bound adds the slack of rows
    whose bf16 weights a c within C_TOL puts a neighbour apart, after
    holding gsum within GSUM_TOL to the plain product at the kernel's own
    c (:func:`bf16_weight_slack`)."""
    from ciao_tpu_torch.ops import fused_block as fb

    kv, kc, kg = fb.coeff_value_apply_all(rows, b, z, sc, precision=precision,
                                          rs=rs)
    rv, rc, rg = fb.coeff_value_apply_all_ref(rows, b, z, sc,
                                              precision=precision, rs=rs)
    again = fb.coeff_value_apply_all(rows, b, z, sc, precision=precision,
                                     rs=rs)
    torch.cuda.synchronize()
    lowp = fb._lowp(rows, precision)
    _, r, _ = fb._apply_margins_ref(rows, z, precision, rs)
    vabs = float(fb._value_formula(sc[1], r, b, sc[0], sc[2]).abs().sum())
    ev = abs(float(kv) - float(rv))
    if not (math.isfinite(float(kv)) and ev <= VALUE_TOL * vabs):
        raise AssertionError(f"{tag}: value {float(kv)} vs {float(rv)} "
                             f"(Σ|f_i| {vabs})")
    worst, flips = 0.0, 0
    for name, kt, rt, tol in (("c", kc, rc, C_TOL[lowp]),
                              ("gsum", kg, rg, GSUM_TOL[lowp])):
        if not bool(torch.isfinite(kt).all()):
            raise AssertionError(f"{tag}: kernel {name} is not finite")
        err = float((kt - rt).abs().max())
        bound = tol * max(float(rt.abs().max()), 1e-30)
        if name == "gsum":
            extra, flips = bf16_weight_slack(rows, z, rs, precision, kc, rc,
                                             kg, bound, tag)
            bound += extra
        if err > bound:
            raise AssertionError(f"{tag}: {name} abs error {err}")
        worst = max(worst, err)
    if not all(torch.equal(x, y) for x, y in zip((kv, kc, kg), again)):
        raise AssertionError(f"{tag}: kernel #7 does not repeat bit for bit")
    c6, g6 = fb.coeff_apply_all(rows, b, z, sc, precision=precision, rs=rs)
    torch.cuda.synchronize()
    same6 = torch.equal(c6, kc) and torch.equal(g6, kg)
    if not same6:
        raise AssertionError(f"{tag}: kernel #7's c, gsum differ from "
                             f"kernel #6's")
    log(f"  #7 {tag}: value rel {ev / max(vabs, 1e-30):.2e} of Σ|f_i|, c "
        f"rel {float((kc - rc).abs().max()) / float(rc.abs().max()):.2e}, "
        f"gsum rel {float((kg - rg).abs().max()) / float(rg.abs().max()):.2e}"
        + (f" ({flips} rows' bf16 weights a neighbour apart)" if flips
           else "")
        + f"; repeat bit for bit; c, gsum == #6's: {same6}")
    return worst


def phase_check_value(gen, dev) -> float:
    """3q: kernel #7 against its plain version in every mode, storage and
    precision at APPLY_SMALL and at the deep target's width (tiles of more
    than 32 rows, the last one ragged), at a ragged N and at widths that
    are not whole 16-byte chunks, and least squares in every storage and
    precision at the headline (the formula's scale 1, as phase 3c holds
    kernel #6), every mode at APPLY_WIDE; kernel #6's c and gsum bit for
    bit their pinned digests."""
    worst = 0.0
    check_golden(dev)
    full = (("f32", "highest"), ("f32", "default"), ("bf16", "highest"),
            ("int8", "highest"))
    cases = [(s_, p_, APPLY_SMALL["N"], APPLY_SMALL["n"], range(5))
             for s_, p_ in full]
    cases += [(s_, p_, APPLY_NARROW["N"], APPLY_NARROW["n"], range(5))
              for s_, p_ in full]
    cases += [(s_, p_, N_, n_, range(5)) for s_, p_, N_, n_ in APPLY_WIDE]
    cases += [("f32", "highest", APPLY_SMALL["N"] - 1, 202, range(5)),
              ("bf16", "highest", APPLY_SMALL["N"] - 2, 202, range(5)),
              ("int8", "highest", APPLY_SMALL["N"] - 192, 200, range(5))]
    # at the headline least squares alone: its margins reach 8, where one
    # ulp (9.5e-7) of a margin summed in another order exceeds 1e-6 of the
    # largest c of the clipped Huber formula (0.5)
    cases += [(s_, p_, N, n, (0,)) for s_, p_ in full]
    for storage, precision, rows_, cols, modes in cases:
        F, _, _ = lasso(gen, dev, rows_, cols, storage)
        rows, offs = F.coeff_rows_data()
        for mode in modes:
            z = walk_z(cols, gen, dev)
            sc = torch.tensor([1.0, mode, 0.5], device=dev)
            worst = max(worst, compare_value_apply(
                rows, mode_offsets(offs, mode), z, sc, precision,
                F.coeff_rows_scale(),
                f"N={rows_} n={cols} {storage}/{precision} mode {mode}"))
        del F, rows, offs
    return worst


def check_golden(dev) -> None:
    """Kernel #6's c and gsum on the pinned inputs, bit for bit their
    digests (APPLY_GOLDEN)."""
    for (storage, precision, mode), want in APPLY_GOLDEN.items():
        got = apply_digest(dev, storage, precision, mode)
        log(f"  #6 {storage}/{precision} mode {mode} on the pinned inputs: "
            f"digest {got} (pinned {want})")
        if got != want:
            raise AssertionError(f"kernel #6's output changed: {storage}/"
                                 f"{precision} mode {mode}")


class FBECount:
    """Counts the FBE evaluations of ``solvers.panoc`` (a wrapper around
    its ``_eval_fbe``, put in place and taken out by ``with``)."""

    def __enter__(self):
        from ciao_tpu_torch.solvers import panoc

        self.evals = 0
        self._real = panoc._eval_fbe

        def counted(*args, **kw):
            self.evals += 1
            return self._real(*args, **kw)

        panoc._eval_fbe = counted
        return self

    def __exit__(self, *exc):
        from ciao_tpu_torch.solvers import panoc

        panoc._eval_fbe = self._real


def run_panoc_headline(gen, dev, card: str) -> dict:
    """4u: ZeroFPR fused at f32, bf16 and int8 rows, and PANOC fused at f32
    with adaptive γ off and on, PANOC_STEPS steps each through panoc_init
    and panoc_run at the headline: kernel #7 launched once per FBE
    evaluation and no other kernel, a falling objective, ms per step, FBE
    evaluations per step (counted, and the ls_ewma gauge), a profiled
    window with its idle share."""
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.panoc import (
        PANOCCfg, panoc_init, panoc_run,
    )

    out = {}
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    runs = [("zerofpr", s_, False) for s_ in ("f32", "bf16", "int8")]
    runs += [("panoc", "f32", False), ("panoc", "f32", True)]
    F32, _, L = lasso(gen, dev, N, n, "f32")
    gamma = (0.95 / L.mean()).to(torch.float32)
    sigma = (0.5 * 0.05 / (2.0 * gamma)).to(torch.float32)
    x0 = torch.zeros(n, device=dev)
    for fam, storage, adaptive in runs:
        F = F32 if storage == "f32" else F32.with_storage(storage)
        cfg = PANOCCfg(N=N, zerofpr=fam == "zerofpr", fused=True,
                       adaptive=adaptive)
        tag = (f"{'ZeroFPR' if fam == 'zerofpr' else 'PANOC'} {storage}"
               + (" adaptive" if adaptive else ""))
        panoc_run(F, g, panoc_init(F, g, x0, gamma, sigma, cfg), cfg, 4)
        with FBECount() as fbe:
            before = counts()
            st0 = panoc_init(F, g, x0, gamma, sigma, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = panoc_run(F, g, st0, cfg, PANOC_STEPS)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / PANOC_STEPS
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
        evals_step = (fbe.evals - 1) / PANOC_STEPS
        obj0, obj1 = cost(F, g, st0.z), cost(F, g, st.z)
        prof = profile_steps(f"{tag} at the headline",
                             lambda: panoc_run(F, g, st0, cfg, 32), 32, card,
                             PANOC_GROUPS)
        log(f"  {tag}: N={N} n={n}, {PANOC_STEPS} steps: launches {moved}, "
            f"{fbe.evals} FBE evaluations ({evals_step:.3f} a step, ls_ewma "
            f"{float(st.ls_ewma):.3f}), objective {obj0:.6e} -> {obj1:.6e}, "
            f"γ {float(st.gamma):.4e}, {ms:.4f} ms/step end to end [{card}]")
        if moved != {"coeff_value_apply_all": fbe.evals}:
            raise AssertionError(f"{tag}: launches {moved} for {fbe.evals} "
                                 f"FBE evaluations")
        for t in st:
            if isinstance(t, torch.Tensor) and not bool(
                    torch.isfinite(t).all()):
                raise AssertionError(f"{tag}: a state field is not finite")
        if not (math.isfinite(obj1) and obj1 < obj0) or st.it != (
                PANOC_STEPS + 1):
            raise AssertionError(f"{tag}: objective {obj0} -> {obj1}, it "
                                 f"{st.it}")
        out[fam, storage, adaptive] = dict(ms=ms, evals=evals_step,
                                           ewma=float(st.ls_ewma), prof=prof,
                                           launches=fbe.evals)
        del F
    return out


def run_panoc_facades(dev, prob, F, card: str) -> None:
    """4v: the PANOC and ZeroFPR facades as a user calls them (f32 rows,
    NormL1, L) on the facades' planted Lasso: cost − f* at most
    PANOC_FACADE["rel"]·f* on the card, every FBE evaluation one launch
    of kernel #7; the same facades on the host's CPU in f64 on the same
    f32-rounded data, whose cost − f* must end below the card's (the
    card's gap is f32's floor, not the method's)."""
    import ciao_tpu_torch as ct

    kw = PANOC_FACADE
    F64 = ct.LeastSquaresRows(F.A.double().cpu(), F.b.double().cpu(),
                              float(FACADE["N"]))
    for S in (ct.PANOC, ct.ZeroFPR):
        rels = {}
        for side, where, Fx, dt in (
                ("card", dev, F, torch.float32),
                ("cpu", torch.device("cpu"), F64, torch.float64)):
            x0 = torch.zeros(n, dtype=dt, device=where)
            with FBECount() as fbe:
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, it = S(maxit=kw["maxit"])(x0, F=Fx, g=ct.NormL1(prob.lam),
                                             L=prob.L)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                moved = {k: v - before[k] for k, v in counts().items()
                         if v != before[k]}
            rel = (prob.cost(x.double().cpu().numpy()) - prob.f_star) \
                / prob.f_star
            rels[side] = rel
            log(f"  facade {S.__name__}(maxit={kw['maxit']}) on planted "
                f"make_lasso(N={FACADE['N']}, n={n}) on the "
                f"{'card, f32' if side == 'card' else 'CPU, f64'}: "
                f"rel {rel:.3e}, {fbe.evals} FBE evaluations, launches "
                f"{moved}, {secs:.3f} s [{card}]")
            if side == "card" and moved != {
                    "coeff_value_apply_all": fbe.evals}:
                raise AssertionError(f"facade {S.__name__}: launches {moved} "
                                     f"for {fbe.evals} FBE evaluations")
        if not (rels["card"] <= kw["rel"] and rels["cpu"] < rels["card"]):
            raise AssertionError(f"facade {S.__name__}: rel {rels['card']} "
                                 f"(bar {kw['rel']}), CPU f64 {rels['cpu']}")


def run_splitting_headline(gen, dev, card: str) -> dict:
    """4w: Davis-Yin (g = NormL1(0.1), h = IndBox(−1, 1), γ = 1/mean(L))
    and Condat-Vũ (h = NormL1(0.05) of FirstDifference, σ = 0.5, τ =
    0.99/(L_f/2 + σ‖K‖²)) at the headline with f32, bf16 and int8 rows,
    and Condat-Vũ with DenseMap K (1,024 and 8,192 x 1,024, entries
    N(0, 1/n)) at f32, SPLIT_STEPS steps each through dys_run and pd_run:
    kernel #6 once a step and no other kernel, a falling objective, ms
    per step."""
    from ciao_tpu_torch.ops.linmap import DenseMap, FirstDifference
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch.solvers.dys import DYSCfg, dys_init, dys_run
    from ciao_tpu_torch.solvers.primal_dual import PDCfg, pd_init, pd_run

    out = {}
    g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
    F32, _, L = lasso(gen, dev, N, n, "f32")
    Lf = float(L.mean())
    x0 = torch.zeros(n, device=dev)
    f32 = torch.float32
    runs = [("dys", s_, None) for s_ in ("f32", "bf16", "int8")]
    runs += [("cv", s_, None) for s_ in ("f32", "bf16", "int8")]
    runs += [("cv", "f32", m) for m in DENSE_MAPS]
    for fam, storage, mK in runs:
        F = F32 if storage == "f32" else F32.with_storage(storage)
        if fam == "dys":
            h = IndBox(-1.0, 1.0).to(dev)
            cfg = DYSCfg(N=N, fused=True)
            st0 = dys_init(F, g, h, x0, torch.tensor(1.0 / Lf, dtype=f32,
                                                     device=dev),
                           torch.ones((), device=dev), cfg)
            run = lambda s, k: dys_run(F, g, h, s, cfg, k)  # noqa: E731
            tag = f"Davis-Yin {storage}"

            def obj(st):
                return cost(F, g, st.xg)
        else:
            h = NormL1(torch.tensor(0.05, dtype=f32, device=dev))
            if mK is None:
                K, nK2 = FirstDifference(), 4.0
                tag = f"Condat-Vu {storage}"
            else:
                K = DenseMap(torch.randn(mK, n, generator=gen, device=dev)
                             / math.sqrt(n))
                nK2 = K.opnorm_bound(n) ** 2
                tag = f"Condat-Vu f32 DenseMap {mK} x {n}"
            cfg = PDCfg(N=N, fused=True)
            st0 = pd_init(F, g, h, K, x0,
                          torch.tensor(0.99 / (Lf / 2.0 + 0.5 * nK2),
                                       dtype=f32, device=dev),
                          torch.tensor(0.5, device=dev), cfg)
            run = lambda s, k: pd_run(F, g, h, K, s, cfg, k)  # noqa: E731

            def obj(st):
                return cost(F, g, st.x) + float(h.value(K.matvec(st.x)))
        run(st0, 8)  # warm
        st, ms, moved = timed_run(run, st0, SPLIT_STEPS)
        obj0, obj1 = obj(st0), obj(st)
        log(f"  {tag}: N={N} n={n}, {SPLIT_STEPS} steps: launches {moved}, "
            f"objective {obj0:.6e} -> {obj1:.6e}, {ms:.4f} ms/step end to "
            f"end [{card}]")
        check_run(tag, st, moved, {"coeff_apply_all": SPLIT_STEPS}, obj0,
                  obj1, SPLIT_STEPS)
        out[fam, storage, mK] = ms
        del F
    return out


# 4x: the sparse route, bench.py's bench_sparse_e2e (:1261) at its widths:
# the planted power-law Lasso in the pure-ELL and hot/cold layouts of one
# operator; FISTA chunks of 25 passes, at most 56 (1,400 passes) to rel 1e-3
# as bench.py runs them; SAGA windows cut from bench.py's 4,096 steps (512 at
# the full shape) to SPARSE_STEPS, timed by the host clock and profiled (a
# profiled window of 256 steps took ~10 s of the tracer's own time)
SPARSE = dict(N=131_072, n=16_384, hot=512, k_hot=24, k_cold=8, p=64,
              rho=1.0, seed=0, B=2_048, chunk=25, max_chunks=56)
SPARSE_FULL = dict(N=524_288, n=65_536, hot=1_024, k_hot=48, k_cold=16,
                   p=64, rho=1.0, seed=0, B=4_096)
SPARSE_STEPS = 64
SPARSE_POWER_ITERS = 8
# deep_solve on (a)'s layouts: the stage cut to one chunk of 16 epochs
# (bench.py runs no sparse deep_solve; 64 epochs took 2.5-4 s of host-bound
# steps for an objective the polish then takes from 5e4 to f*); polish
# rounds of 8 steps, as tests/test_deep.py:540 gives sparse logistic rows
SPARSE_DEEP = dict(batch=4_096, chunk_epochs=16, max_epochs=16,
                   plateau_rtol=1e-4, polish_steps=8, polish_max_rounds=64)
# sparse logistic rows on (a)'s design (tests/test_deep.py:495): labels ±1,
# λ = 0.002, and the f64 ELL reference by FISTA in chunks of 250 steps until
# its fixed-point residual contracts less than 1.5x a chunk
SPARSE_LOGISTIC = dict(lam=0.002, margin_slack=0.5, ref_chunk=250,
                       ref_max_chunks=48, ref_power_iters=64)
SPARSE_GROUPS = {"gather": ("indexSelect", "gather"),
                 "scatter-add": ("indexFunc", "scatter"),
                 "hot product": ("gemv", "gemm", "cutlass", "xmma")}


def sparse_problem(dev, shape: dict):
    """make_sparse_lasso_ell at ``shape`` on the card, with its build time
    logged."""
    from ciao_tpu_torch.utils import make_sparse_lasso_ell

    t0 = time.perf_counter()
    prob = make_sparse_lasso_ell(
        N=shape["N"], n=shape["n"], hot=shape["hot"], k_hot=shape["k_hot"],
        k_cold=shape["k_cold"], p=shape["p"], rho=shape["rho"],
        seed=shape["seed"], device=dev)
    torch.cuda.synchronize()
    log(f"  planted sparse Lasso {shape['N']} x {shape['n']} (hot "
        f"{shape['hot']}, k {shape['k_hot']} + {shape['k_cold']}, p "
        f"{shape['p']}) built on the card in {time.perf_counter() - t0:.2f} "
        f"s, f* = {prob.f_star:.9f}")
    return prob


def sparse_saga(prob, B_: int, seed: int, card: str, repeat=False) -> dict:
    """SAGA at γ = 1/(3·max L_i), blocks of B_ rows, on each layout: ms a
    step by the host clock and a profiled window of SPARSE_STEPS steps
    (idle share, device time by gather, scatter-add and hot product); with
    ``repeat``, the ELL window run twice more and whether its bits repeat
    (the scatter-add adds with atomics)."""
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    N_, n_ = prob.ell.num_terms, prob.ell.dim
    dev = prob.L.device
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32, device=dev))
    gamma = torch.tensor(1.0 / (3.0 * float(prob.L.max())), device=dev)
    cfg = SAGACfg(N=N_, sag=False, batch=B_, block=True, coeff=True)
    out = {}
    for name, F in (("ELL", prob.ell), ("hybrid f32", prob.hybrid),
                    ("hybrid bf16", prob.hybrid.with_storage("bf16"))):
        st0 = saga_init(F, g, torch.zeros(n_, device=dev), gamma, seed, cfg)
        run = lambda: saga_run(F, g, st0, cfg, SPARSE_STEPS)  # noqa: E731
        prof = profile_steps(f"sparse SAGA {name}, N={N_} n={n_} B={B_}",
                             run, SPARSE_STEPS, card, SPARSE_GROUPS)
        st = run()
        obj0 = float(F.value_sum_all(st0.z)) / N_
        obj1 = float(F.value_sum_all(st.z)) / N_
        if not (math.isfinite(obj1) and obj1 < obj0):
            raise AssertionError(f"sparse SAGA {name}: the smooth part went "
                                 f"{obj0} -> {obj1}")
        out[name] = dict(ms=prof["step"], idle=1.0 - prof["busy"]
                         / prof["step"], prof=prof)
        if repeat and name == "ELL":
            a, b = run(), run()
            same = torch.equal(a.z, b.z) and torch.equal(a.s, b.s)
            log(f"  sparse SAGA ELL, {SPARSE_STEPS} steps run twice from one "
                f"state: bits repeat {same} (max |dz| "
                f"{float((a.z - b.z).abs().max()):.3e})")
            out["repeat"] = same
    log(f"  sparse SAGA B={B_}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms/step, idle {v['idle']:.3f}"
        for k, v in out.items() if k != "repeat") + f" [{card}]")
    return out


def sparse_cost64(prob, z) -> float:
    """½‖A z − b‖² + λ‖z‖₁ in f64 (the ELL slots widened; f* is ½‖y*‖² +
    λ‖x*‖₁ of the same operator)."""
    F = prob.ell
    m = torch.sum(F.val.double() * z.double()[F.idx.long()], dim=1)
    r = m - F.b.double()
    return 0.5 * float(r @ r) + prob.lam * float(z.double().abs().sum())


def run_sparse_e2e(dev, seed: int, card: str) -> dict:
    """4x (a), (c), (d) on bench.py's bench_sparse_e2e problem; returns the
    times."""
    from ciao_tpu_torch import deep_solve
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.fb import FBCfg, fb_init, fb_run
    from ciao_tpu_torch.solvers.polish import power_lmax_quadratic

    S = SPARSE
    N_, n_ = S["N"], S["n"]
    out = {}
    t0 = time.perf_counter()
    prob = sparse_problem(dev, S)
    lam = prob.lam
    # (a) the KKT certificate (tests/test_sparse.py:457-464): |Aᵀr*| ≤ λ,
    # = λ on the support, ≤ 0.95λ off it; both layouts one operator
    gs = prob.ell.grad_sum_all(prob.x_star).double() / N_
    supp = prob.x_star != 0
    kkt = (float(gs.abs().max()), float((gs[supp].abs() - lam).abs().max()),
           float(gs[~supp].abs().max()))
    if not (kkt[0] <= lam * 1.001 and kkt[1] < 1e-3 and kkt[2] <= 0.96 * lam
            and int(supp.sum()) == S["p"]):
        raise AssertionError(f"sparse KKT certificate: {kkt}")
    v = torch.randn(n_, generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    ce, ch = prob.ell.coeff_all(v), prob.hybrid.coeff_all(v)
    same_op = float((ce - ch).abs().max()) / float(ce.abs().max())
    if same_op > 1e-5:
        raise AssertionError(f"the sparse layouts differ: rel {same_op}")
    f_ref = sparse_cost64(prob, prob.x_star)
    log(f"  sparse KKT: max |Aᵀr*|/λ {kkt[0] / lam:.6f}, support off λ by "
        f"{kkt[1]:.2e}, off-support max {kkt[2] / lam:.4f} λ; layouts one "
        f"operator (coeff rel {same_op:.2e}); cost(x*) {f_ref:.9f}")
    # (a) spectral-step FISTA to rel 1e-3 on both layouts
    g = NormL1(torch.tensor(lam, dtype=torch.float32, device=dev))
    t1 = time.perf_counter()
    lam_h = float(power_lmax_quadratic(prob.hybrid, seed + 1,
                                       SPARSE_POWER_ITERS))
    log(f"  sparse power bound: λ̂ {lam_h:.6e} ({SPARSE_POWER_ITERS} "
        f"iterations, {time.perf_counter() - t1:.2f} s)")
    fcfg = FBCfg(N=N_, fast=True)
    x0 = torch.zeros(n_, device=dev)
    gam = torch.tensor(0.95 / lam_h, device=dev)
    target = f_ref * (1 + 1e-3)
    fista = {}
    for name, F in (("ELL", prob.ell), ("hybrid f32", prob.hybrid)):
        fb_run(F, g, fb_init(F, g, x0, gam, fcfg), fcfg, S["chunk"])  # warm
        st = fb_init(F, g, x0, gam, fcfg)
        secs, passes, c = 0.0, 0, math.inf
        for _ in range(S["max_chunks"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = fb_run(F, g, st, fcfg, S["chunk"])
            torch.cuda.synchronize()
            secs += time.perf_counter() - t1
            passes += S["chunk"]
            c = sparse_cost64(prob, st.x)
            if c <= target:
                break
        if not c <= target:
            raise AssertionError(f"sparse FISTA {name}: rel "
                                 f"{(c - f_ref) / f_ref:.3e} after {passes} "
                                 "passes")
        fista[name] = dict(s=secs, passes=passes, ms=secs * 1e3 / passes)
        log(f"  sparse FISTA {name}: rel {(c - f_ref) / f_ref:.3e} <= 1e-3 "
            f"in {passes} passes, {secs:.3f} s ({secs * 1e3 / passes:.4f} "
            f"ms/pass) [{card}]")
    out["fista"] = fista
    # (a) SAGA per layout, profiled, the ELL window twice more
    out["saga"] = sparse_saga(prob, S["B"], seed, card, repeat=True)
    out["a_s"] = time.perf_counter() - t0
    # (c) deep_solve on both layouts to rel <= 1e-6 (tests/test_deep.py:227)
    t0 = time.perf_counter()
    deep = {}
    for name, F in (("ELL", prob.ell), ("hybrid f32", prob.hybrid)):
        t1 = time.perf_counter()
        x, info = deep_solve(x0, F, g, L=prob.L, N=N_, seed=seed,
                             **SPARSE_DEEP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        rel = (sparse_cost64(prob, x) - f_ref) / abs(f_ref)
        if not (math.isfinite(rel) and rel <= DEEP_REL):
            raise AssertionError(f"sparse deep_solve {name}: rel {rel}")
        deep[name] = dict(rel=rel, s=secs)
        log(f"  sparse deep_solve {name}: rel {rel:.3e} in {secs:.2f} s "
            f"(stage {info.staged.epochs} epochs, objective "
            f"{info.staged.objectives[-1]:.6e}; λ̂ {info.lmax:.6e}, "
            f"{info.polish_steps} polish steps, last residual "
            f"{info.fp_res[-1]:.3e}) [{card}]")
    out["deep"] = deep
    out["c_s"] = time.perf_counter() - t0
    # (d) deep_solve on sparse logistic rows of the same design
    t0 = time.perf_counter()
    out["logistic"] = run_sparse_logistic(prob, dev, seed, card)
    out["d_s"] = time.perf_counter() - t0
    return out


def run_sparse_logistic(prob, dev, seed: int, card: str) -> dict:
    """4x (d): labels ±1 from ``seed`` on (a)'s design, λ = 0.002;
    ``deep_solve`` on SparseLogisticELL and HybridSparseLogistic held to rel
    <= 1e-6 of an f64 ELL FISTA reference run on the card until its
    fixed-point residual stalls."""
    from ciao_tpu_torch import deep_solve
    from ciao_tpu_torch.oracles import HybridSparseLogistic, SparseLogisticELL
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.fb import FBCfg, fb_init, fb_run
    from ciao_tpu_torch.solvers.polish import power_lmax_weighted

    SL = SPARSE_LOGISTIC
    E, H = prob.ell, prob.hybrid
    N_, n_ = E.num_terms, E.dim
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    y = torch.where(torch.rand(N_, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    F64 = SparseLogisticELL(E.idx, E.val.double(), y.double(), n_)

    def cost64(z):
        z = z.double()
        return (float(F64.value_sum_all(z)) / N_
                + SL["lam"] * float(z.abs().sum()))

    # the reference: FISTA at 0.9/λ̂, λ̂ the bound at margin 0 (weights ¼:
    # the global logistic bound)
    t0 = time.perf_counter()
    g64 = NormL1(torch.tensor(SL["lam"], dtype=torch.float64, device=dev))
    lam_sp = float(power_lmax_weighted(F64, torch.zeros(n_, device=dev),
                                       seed + 3, SL["ref_power_iters"]))
    gam = torch.tensor(0.9 / lam_sp, dtype=torch.float64, device=dev)
    cfg = FBCfg(N=N_, fast=True)
    st = fb_init(F64, g64, torch.zeros(n_, dtype=torch.float64, device=dev),
                 gam, cfg)
    res_hist = []
    for _ in range(SL["ref_max_chunks"]):
        st = fb_run(F64, g64, st, cfg, SL["ref_chunk"])
        x = st.x
        grad = F64.grad_sum_all(x) / N_
        res = float(torch.linalg.vector_norm(
            x - g64.prox_only(x - gam * grad, gam)) / gam)
        res_hist.append(res)
        if res == 0.0 or (len(res_hist) >= 2
                          and res > res_hist[-2] / 1.5):
            break
    f_ref = cost64(st.x)
    ref_s = time.perf_counter() - t0
    log(f"  sparse logistic reference: f64 ELL FISTA, "
        f"{len(res_hist) * SL['ref_chunk']} steps at 0.9/λ̂ (λ̂ "
        f"{lam_sp:.6e}), residual {res_hist[0]:.3e} -> "
        f"{res_hist[-1]:.3e}, f_ref {f_ref:.12f}, {ref_s:.2f} s")
    L = 0.25 * prob.L / N_
    g = NormL1(torch.tensor(SL["lam"], dtype=torch.float32, device=dev))
    out = dict(ref_s=ref_s)
    for name, F in (("ELL", SparseLogisticELL(E.idx, E.val, y, n_)),
                    ("hybrid f32", HybridSparseLogistic(
                        H.A_hot, H.hot_cols, H.idx, H.val, y, n_))):
        t1 = time.perf_counter()
        x, info = deep_solve(torch.zeros(n_, device=dev), F, g, L=L, N=N_,
                             seed=seed, margin_slack=SL["margin_slack"],
                             **SPARSE_DEEP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        rel = (cost64(x) - f_ref) / abs(f_ref)
        if not (math.isfinite(rel) and abs(rel) <= DEEP_REL):
            raise AssertionError(f"sparse logistic deep_solve {name}: rel "
                                 f"{rel}")
        out[name] = dict(rel=rel, s=secs)
        log(f"  sparse logistic deep_solve {name}: rel {rel:.3e} in "
            f"{secs:.2f} s (λ̂ {info.lmax:.6e}, {info.polish_steps} polish "
            f"steps) [{card}]")
    return out


def run_sparse_full(dev, seed: int, card: str) -> dict:
    """4x (b): SAGA at blocks of 4,096 rows on each layout of the full
    rcv1 shape of bench.py (:1361-1383)."""
    t0 = time.perf_counter()
    prob = sparse_problem(dev, SPARSE_FULL)
    out = sparse_saga(prob, SPARSE_FULL["B"], seed, card)
    del prob
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


# 4y: the primal-dual deep route, bench.py's bench_pd_deep (:1131) at its
# widths: fused lasso and three-term problems of 262,144 x 1,024 f32 rows
# (1 GiB) with 16 jumps, x*, v*, u* and λ from the port's plants at a token
# N, the design C and residual y drawn on the card from a torch.Generator
# seeded from --seed (the port's own draws, not jax.random's: :1154-1167);
# deep_solve_pd at bench.py's chunk of 4,096 rows, 256 steps a round and at
# most 8,192 steps; a window of PD_PROFILE_STEPS compensated steps profiled
PD_DEEP = dict(N=262_144, n=1_024, jumps=16, chunk=4_096, chunk_steps=256,
               max_steps=8_192)
PD_PROFILE_STEPS = 64
PD_GROUPS = {"products": ("gemv", "gemm", "xmma", "cutlass", "dot_kernel",
                          "splitK"),
             "reductions": ("reduce_kernel",)}


def pd_plant(dev, seed: int, x_star, corr):
    """bench.py's device plant (:1154-1167): C ~ U(−1, 1) of (N, n) and y ~
    N(0, I)/‖y‖ in f32 from ``seed``, c = corr − Cᵀy (exact f32), A = C +
    y·cᵀ (formed in C's storage) and b = A·x* + y, so that Aᵀy = corr to
    f32 rounding and r* = −y. Returns (A, b, y)."""
    S = PD_DEEP
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.empty(S["N"], S["n"], device=dev).uniform_(-1.0, 1.0,
                                                         generator=gen)
    y = torch.randn(S["N"], generator=gen, device=dev)
    y = y / torch.linalg.vector_norm(y)
    c = torch.tensor(corr, dtype=torch.float32, device=dev) - y @ A
    A += y[:, None] * c[None, :]
    b = A @ torch.tensor(x_star, dtype=torch.float32, device=dev) + y
    return A, b, y


def quad_gap(A, y, d64, chunk: int) -> float:
    """½‖u‖² − ⟨u, y⟩ with u = A·d, d = z − x* (host f64) in double-single
    halves: the smooth part's gap f(z) − f(x*) in difference form against
    r* = −y, free of cancellation, chunk sums added with a two-sum carry
    (bench.py:1190-1207)."""
    import numpy as np

    from ciao_tpu_torch.ops.fused_block import _two_sum

    d_hi = np.asarray(d64, np.float32)
    d_lo = np.asarray(d64 - d_hi.astype(np.float64), np.float32)
    d_hi = torch.from_numpy(d_hi).to(A.device)
    d_lo = torch.from_numpy(d_lo).to(A.device)
    hi = torch.zeros((), device=A.device)
    lo = torch.zeros((), device=A.device)
    for start in range(0, A.shape[0], chunk):
        A_B = A.narrow(0, start, chunk)
        u = A_B @ d_hi + A_B @ d_lo
        p = torch.sum(0.5 * u * u - u * y.narrow(0, start, chunk))
        hi, lo = _two_sum(hi, lo, p)
    return float(hi + lo)


def run_pd_leg(dev, seed: int, three: bool, card: str) -> dict:
    """One leg of 4y: the plant on the card, deep_solve_pd on it with its
    seconds split into the Condat-Vũ rounds and the refinement (each timed
    by wrapping the module's function, with a synchronize either side), rel
    from quad_gap as bench.py:1205-1212 and :1246-1254 compute it, and a
    profiled window of PD_PROFILE_STEPS compensated steps (ms a step, idle
    share, device events a step)."""
    import numpy as np

    from ciao_tpu_torch import (
        CondatVu, FirstDifference, LeastSquaresRows, deep_solve_pd,
    )
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import deep_pd
    from ciao_tpu_torch.utils import (
        make_fused_lasso_planted, make_three_term_planted,
    )

    S = PD_DEEP
    N_, n_ = S["N"], S["n"]
    make = make_three_term_planted if three else make_fused_lasso_planted
    pp = make(N=8, n=n_, jumps=S["jumps"], seed=0)
    Dt_v = np.zeros(n_)
    Dt_v[:-1] -= pp.v_star
    Dt_v[1:] += pp.v_star
    corr = pp.u_star + Dt_v if three else Dt_v
    t0 = time.perf_counter()
    A, b, y = pd_plant(dev, seed + int(three), pp.x_star, corr)
    torch.cuda.synchronize()
    plant_s = time.perf_counter() - t0
    F = LeastSquaresRows(A, b, float(N_))
    lam = torch.tensor(pp.lam2 if three else pp.lam, device=dev)
    g = NormL1(torch.tensor(pp.lam1, device=dev)) if three else None
    h, K = NormL1(lam), FirstDifference()

    spent = dict(cv=0.0, refine=0.0, rounds=0, refines=0)

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t1
            spent["rounds" if key == "cv" else "refines"] += 1
            return out
        return run

    wrapped = {"pd_run_compensated": "cv", "tv_refine": "refine",
               "tv_refine3": "refine"}
    saved = {name: getattr(deep_pd, name) for name in wrapped}
    for name, key in wrapped.items():
        setattr(deep_pd, name, timed(key, saved[name]))
    try:
        t0 = time.perf_counter()
        x, info = deep_solve_pd(
            torch.zeros(n_, device=dev), F, g=g, h=h, K=K, N=N_,
            chunk=S["chunk"], chunk_steps=S["chunk_steps"],
            max_steps=S["max_steps"], seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(deep_pd, name, fn)
    if x.device != A.device:
        raise AssertionError(f"deep_solve_pd came back on {x.device}, not "
                             f"on the rows' {A.device}")

    x64 = x.double().cpu().numpy()
    gap = quad_gap(A, y, x64 - pp.x_star, S["chunk"])
    tv = np.sum(np.abs(np.diff(x64))) - np.sum(np.abs(np.diff(pp.x_star)))
    if three:
        ns = (pp.lam1 * (np.sum(np.abs(x64)) - np.sum(np.abs(pp.x_star)))
              + pp.lam2 * tv)
        f_star = (0.5 + pp.lam1 * np.sum(np.abs(pp.x_star))
                  + pp.lam2 * np.sum(np.abs(np.diff(pp.x_star))))
    else:
        ns = pp.lam * tv
        f_star = 0.5 + pp.lam * np.sum(np.abs(np.diff(pp.x_star)))
    rel = (gap + ns) / f_star
    jumps_ok = bool(np.array_equal(np.nonzero(np.diff(x64))[0],
                                   np.nonzero(np.diff(pp.x_star))[0]))
    zeros = bool(np.all(x64[pp.x_star == 0] == 0.0)) if three else None
    tag = "three-term" if three else "fused lasso"

    # the profiled window: PD_PROFILE_STEPS compensated steps from x
    facade = CondatVu(tau=info.tau, sigma=info.sigma, device=dev)
    _, Fp, gp, hp, Kp, cfg, init = facade._setup(x, F, g, h, K, None, N_)
    st = init()
    c = deep_pd._chunk_of(N_, S["chunk"])
    prof = profile_steps(
        f"compensated Condat-Vu {tag}, N={N_} n={n_} chunk={c}",
        lambda: deep_pd.pd_run_compensated(Fp, gp, hp, Kp, st, cfg,
                                           PD_PROFILE_STEPS, c),
        PD_PROFILE_STEPS, card, PD_GROUPS)
    per_step = sum(prof["calls"].values()) / PD_PROFILE_STEPS
    out = dict(rel=rel, certified=info.certified, refined=info.refined,
               steps=info.steps, s=secs, cv_s=spent["cv"],
               refine_s=spent["refine"],
               ms=spent["cv"] * 1e3 / max(info.steps, 1),
               idle=1.0 - prof["busy"] / prof["step"], launches=per_step,
               zeros=zeros)
    log(f"  pd deep {tag} {N_} x {n_}: rel {rel:.3e}, refined "
        f"{info.refined}, certified {info.certified}, {info.steps} Condat-Vu "
        f"steps in {spent['rounds']} rounds, jump set recovered {jumps_ok}"
        + ("" if zeros is None else f", planted zeros exact {zeros}")
        + f"; {secs:.3f} s in all: Condat-Vu {spent['cv']:.3f} s "
        f"({out['ms']:.4f} ms/step), refine {spent['refine']:.3f} s "
        f"({spent['refines']} call(s)), the rest (power bound, setup) "
        f"{secs - spent['cv'] - spent['refine']:.3f} s; λ̂ "
        f"{info.lam_hat:.6e}, τ {info.tau:.6e}; plant built in {plant_s:.2f} "
        f"s; profiled window {prof['step']:.4f} ms/step, idle "
        f"{out['idle']:.3f}, {per_step:.1f} device launches a step "
        f"({ {k: v for k, v in prof['calls'].items()} }) [{card}]")
    if not (info.refined and info.certified):
        raise AssertionError(f"pd deep {tag}: refined {info.refined}, "
                             f"certified {info.certified}")
    if not (math.isfinite(rel) and abs(rel) <= DEEP_REL):
        raise AssertionError(f"pd deep {tag}: rel {rel}")
    if three and not zeros:
        raise AssertionError("pd deep three-term: a planted zero is not "
                             "exactly zero")
    del A, b, y, F
    return out


def time_value_apply(gen, dev, storage: str, card: str,
                     ceil: float) -> dict:
    """11: kernel #7 per pass at the headline (least squares, scale N), in
    turns with its plain version and kernel #6 (plain, #7, #6, #7, #6,
    plain), its bound, and the yardstick: torch.mv for the margins, the
    coefficients and the value sum, torch.mv for Σ c_i·a_i (two reads of A;
    f32 and bf16 rows only, torch.mv takes no int8); then #7 and #6 in
    turns in the logistic and Poisson modes, whose value terms are
    transcendental."""
    from ciao_tpu_torch.ops import fused_block as fb

    F, _, _ = lasso(gen, dev, N, n, storage)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    z = 0.05 * torch.randn(n, generator=gen, device=dev)
    scale = float(N)
    sc = torch.tensor([scale, 0.0, 0.0], device=dev)

    def k7():
        fb.coeff_value_apply_all(rows, offs, z, sc, rs=rs)

    def k6():
        fb.coeff_apply_all(rows, offs, z, sc, rs=rs)

    def plain():
        fb.coeff_value_apply_all_ref(rows, offs, z, sc, rs=rs)

    def two_gemv():
        res = torch.mv(rows, z.to(rows.dtype)).float() - offs
        c = scale * res
        val = torch.sum(0.5 * scale * res * res)
        return val, torch.mv(rows.t(), c.to(rows.dtype))

    pl = [time_events(plain, 2)]
    t7, t6 = [], []
    for _ in range(2):
        t7.append(time_events(k7, 20))
        t6.append(time_events(k6, 20))
    pl.append(time_events(plain, 2))
    lib = None if storage == "int8" else time_events(two_gemv, 20)
    isz = rows.element_size()
    nbytes = pass_bytes(rows, value=True)
    b_ms, b_by = bound(nbytes, 4.0 * N * n, isz)
    ceil_ms = nbytes / ceil * 1e3
    modes = {}
    for mode in (1, 4):
        bm = mode_offsets(offs, mode)
        scm = torch.tensor([1.0, mode, 0.0], device=dev)
        tm = [time_events(lambda: fn(rows, bm, z, scm, rs=rs), 20)
              for _ in range(2)
              for fn in (fb.coeff_value_apply_all, fb.coeff_apply_all)]
        modes[mode] = ((tm[0] + tm[2]) / 2, (tm[1] + tm[3]) / 2)
    log(f"  kernel #7, {storage} rows, N={N} n={n}: kernel "
        f"{t7[0]:.4f}/{t7[1]:.4f} ms per pass, kernel #6 "
        f"{t6[0]:.4f}/{t6[1]:.4f}, plain version {pl[0]:.4f}/{pl[1]:.4f}, "
        f"bound {b_ms:.4f} ({b_by}: {nbytes} B at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {ceil_ms:.4f} at the read "
        f"ceiling ({ceil / 1e9:.0f} GB/s), two-gemv + value yardstick "
        f"{'none' if lib is None else f'{lib:.4f}'}; logistic #7 "
        f"{modes[1][0]:.4f} (#6 {modes[1][1]:.4f}), Poisson #7 "
        f"{modes[4][0]:.4f} (#6 {modes[4][1]:.4f}) [{card}]")
    return dict(ms=sum(t7) / 2, plain_ms=sum(pl) / 2, bound_ms=b_ms,
                bound_by=b_by, ceil_ms=ceil_ms, six_ms=sum(t6) / 2,
                two_gemv_ms=lib, modes=modes)


KERNELS = ("saga_coeff_multistep", "saga_coeff_multistep_streamed",
           "svrg_coeff_multistep", "coeff_apply_all",
           "finito_coeff_multistep", "finito_coeff_multistep_streamed",
           "lfinito_sweep_multistep", "finito_block_update",
           "saga_block_update", "proshi_multistep",
           "katyusha_coeff_multistep", "sarah_multistep",
           "lsvrg_coeff_multistep", "lkatyusha_coeff_multistep",
           "ssnm_multistep", "ssnm_multistep_streamed",
           "point_saga_multistep", "point_saga_multistep_streamed",
           "coeff_value_apply_all")
# the def line of the TPU kernel each replaces, in ciao_tpu/ops/fused_block.py
REPLACES = {"saga_coeff_multistep": 371, "saga_coeff_multistep_streamed": 577,
            "svrg_coeff_multistep": 966, "coeff_apply_all": 798,
            "finito_coeff_multistep": 1343,
            "finito_coeff_multistep_streamed": 2324,
            "lfinito_sweep_multistep": 1170, "finito_block_update": 1032,
            "saga_block_update": 164, "proshi_multistep": 2964,
            "katyusha_coeff_multistep": 1607, "sarah_multistep": 1774,
            "lsvrg_coeff_multistep": 2628, "lkatyusha_coeff_multistep": 2772,
            "ssnm_multistep": 3133, "ssnm_multistep_streamed": 2160,
            "point_saga_multistep": 1992,
            "point_saga_multistep_streamed": 2474,
            "coeff_value_apply_all": 916}


# the source of each kernel's C entry, by kernel (csrc/<name>.cu but for
# #3, #19 and #12, whose wrappers launch #4's, #13's and #15's entries with
# no clamp count)
SOURCE = {"saga_coeff_multistep": "saga_coeff_multistep_streamed",
          "ssnm_multistep": "ssnm_multistep_streamed",
          "point_saga_multistep": "point_saga_multistep_streamed"}
SOURCES = tuple(dict.fromkeys(SOURCE.get(k, k) for k in KERNELS))


def build_all() -> None:
    """The kernels' nvcc runs, one a source, started together, then
    loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from ciao_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    log(f"phase 2 build: {', '.join(f'{k}.cu' for k in SOURCES)} built "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def timed_turns(kernel, plain, F, gamma, gen, dev, B_, tag, card):
    """(kernel, plain, bound) ms per SAGA step in turns: plain, kernel,
    kernel, plain; the bound of the first kernel turn's schedule (rows, b,
    c read and written of the visited blocks; z and av in and out)."""
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    def turn(fn, reps):
        return time_per_step(fn, F, gamma, gen, dev, B_, LAUNCH_STEPS, reps)

    pl = [turn(plain, 1)[0]]
    (k0, starts), (k1, _) = turn(kernel, 4), turn(kernel, 4)
    pl.append(turn(plain, 1)[0])
    b_ms, b_by = step_bound(F, starts, B_, 4 * 4 * F.dim, 12)
    log(f"  {tag}: kernel {k0:.4f}/{k1:.4f} ms/step, plain version "
        f"{pl[0]:.4f}/{pl[1]:.4f} ms/step, bound {b_ms:.4f} ms/step "
        f"({b_by}) [{card}]")
    return dict(ms=(k0 + k1) / 2, plain_ms=sum(pl) / 2, bound_ms=b_ms,
                bound_by=b_by)


def kernel_line(name: str, launches: int, max_err: float, t: dict) -> dict:
    """One kernel's entry of the JSON line: what this run measured and the
    bound it computed from this run's inputs."""
    return {"name": name, "route": "cuda",
            "source": f"ciao_tpu_torch/csrc/{SOURCE.get(name, name)}.cu",
            "replaces": f"ciao_tpu/ops/fused_block.py:{REPLACES[name]}",
            "launches": launches, "max_abs_err": max_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


class Count(int):
    """A kernel's launches that carry its steps (``steps``: K a launch of
    a step kernel, one a block update, none a pass), through sums and
    differences, so that the path's tally of launches also gives its
    steps."""

    def __new__(cls, launches: int, steps: int = 0):
        self = super().__new__(cls, launches)
        self.steps = steps
        return self

    def __add__(self, other):
        return Count(int(self) + int(other),
                     self.steps + getattr(other, "steps", 0))

    __radd__ = __add__

    def __sub__(self, other):
        return Count(int(self) - int(other),
                     self.steps - getattr(other, "steps", 0))


def reset_counts() -> None:
    """Every kernel's launch and step counts to 0."""
    from ciao_tpu_torch.ops import fused_block as fb

    for name in KERNELS:
        fn = getattr(fb, name)
        fn.launches = 0
        if hasattr(fn, "steps"):
            fn.steps = 0


def counts() -> dict:
    """Every kernel's launches since the last reset, with its steps."""
    from ciao_tpu_torch.ops import fused_block as fb

    return {name: Count(getattr(fb, name).launches,
                        getattr(getattr(fb, name), "steps", 0))
            for name in KERNELS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port's "
              "kernels on an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ciao_tpu_torch.ops.fused_block import (
        saga_coeff_multistep, saga_coeff_multistep_ref,
        saga_coeff_multistep_streamed, saga_coeff_multistep_streamed_ref,
    )
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.finito import finito_run

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    log(card)
    log(f"phase 1 device: {kind}, {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {card}")

    # 2. build
    build_all()
    ceil = read_ceiling(dev)
    log(f"  read ceiling: torch.sum over {CEILING_BYTES / 2**30:.0f} GiB of "
        f"f32 at {ceil / 1e9:.1f} GB/s [{card}]")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3, 3b, 3c, 3d. each kernel == its plain version
    errs = {"saga_coeff_multistep": phase_check(gen, dev)}
    log(f"phase 3 kernel #3 == plain version: ok, max |dz| "
        f"{errs['saga_coeff_multistep']:.3e}")
    errs["saga_coeff_multistep_streamed"] = phase_check_streamed(gen, dev)
    log(f"phase 3b kernel #4 == plain version: ok, max |dz| "
        f"{errs['saga_coeff_multistep_streamed']:.3e}")
    errs["coeff_apply_all"] = phase_check_apply(gen, dev)
    log(f"phase 3c kernel #6 == plain version: ok, max abs err "
        f"{errs['coeff_apply_all']:.3e}")
    errs["svrg_coeff_multistep"] = phase_check_svrg(gen, dev)
    log(f"phase 3d kernel #5 == plain version: ok, max |dw| "
        f"{errs['svrg_coeff_multistep']:.3e}")
    errs["finito_coeff_multistep"] = phase_check_finito(gen, dev)
    log(f"phase 3e kernel #9 == plain version: ok, max |dz| "
        f"{errs['finito_coeff_multistep']:.3e}")
    (errs["finito_coeff_multistep_streamed"],
     errs["lfinito_sweep_multistep"]) = phase_check_finito_small(gen, dev)
    errs["finito_block_update"] = phase_check_block(gen, dev)
    log(f"phase 3h kernel #2 == plain version: ok, max |ds| "
        f"{errs['finito_block_update']:.3e}")
    errs["proshi_multistep"] = phase_check_proshi(gen, dev)
    log(f"phase 3i kernel #18 == plain version: ok, max |ds| "
        f"{errs['proshi_multistep']:.3e}")
    errs["saga_block_update"] = phase_check_saga_block(gen, dev)
    log(f"phase 3j kernel #1 == plain version: ok, max |ds| "
        f"{errs['saga_block_update']:.3e}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fprob, fF = facade_problem(dev, args.seed)
    log(f"  facades' planted Lasso {FACADE['N']} x {n} built in "
        f"{time.perf_counter() - t0:.2f} s")
    launches = {}

    # 4. the headline path, counts from 0
    reset_counts()
    int8 = run_headline(gen, dev, "int8", saga_coeff_multistep)
    f32 = run_headline(gen, dev, "f32", saga_coeff_multistep)
    run_facade(dev, fprob, fF, saga_coeff_multistep)
    c4 = counts()
    launches["saga_coeff_multistep"] = c4["saga_coeff_multistep"]
    if c4["saga_coeff_multistep"] == 0 or sum(c4.values()) != c4[
            "saga_coeff_multistep"]:
        raise AssertionError(f"the headline path did not run on kernel #3 "
                             f"alone: {c4}")
    log(f"phase 4 headline path: ok, launches {c4}")

    # 4b, 4c. the deep path, counts from 0
    t0 = time.perf_counter()
    prob = DeepProblem(gen, dev)
    torch.cuda.synchronize()
    log(f"  deep target: planted {DEEP['N']} x {DEEP['n']} Lasso "
        f"({DEEP['live']} live columns) built on the card in "
        f"{time.perf_counter() - t0:.2f} s, f* = {prob.f_star:.9f}")
    reset_counts()
    rels = [run_deep(prob, ("f32",), "deep_solve f32 (cold)", card),
            run_deep(prob, ("f32",), "deep_solve f32 (warm)", card),
            run_deep(prob, ("int8", "f32"), "deep_solve int8->f32", card)]
    run_importance(prob, card)
    c4b = counts()
    launches["saga_coeff_multistep_streamed"] = c4b[
        "saga_coeff_multistep_streamed"]
    if c4b["saga_coeff_multistep_streamed"] == 0 or sum(c4b.values()) != c4b[
            "saga_coeff_multistep_streamed"]:
        raise AssertionError(f"the deep path did not run on kernel #4 "
                             f"alone: {c4b}")
    log(f"phase 4b/4c deep path: ok, rel {['%.3e' % r for r in rels]}, "
        f"launches {c4b}")
    times4 = {}
    for storage in ("f32", "int8"):
        times4[storage] = timed_turns(
            saga_coeff_multistep_streamed, saga_coeff_multistep_streamed_ref,
            prob.oracle(storage), prob.gamma, gen, dev, DEEP["B"],
            f"kernel #4, {storage} rows, N={DEEP['N']} n={DEEP['n']} "
            f"B={DEEP['B']}", card)
        profile_deep_saga(prob, storage, card)

    # 3f, 3g at the deep shape, then 4g: the deep-shape Finito paths on the
    # deep target, counts from 0
    for storage in ("f32", "int8"):
        Fd = prob.oracle(storage)
        tag = f"N={DEEP['N']} n={DEEP['n']} B={DEEP['B']} K={DEEP_K} {storage}"
        errs["finito_coeff_multistep_streamed"] = max(
            errs["finito_coeff_multistep_streamed"], compare_finito(
                Fd, gen, dev, DEEP["B"], DEEP_K, DEEP["lam"], "highest",
                f"#14 {tag}", streamed=True))
        errs["lfinito_sweep_multistep"] = max(
            errs["lfinito_sweep_multistep"], compare_lfinito(
                Fd, gen, dev, DEEP["B"], DEEP_K, DEEP["lam"], "highest",
                f"#8 {tag}"))
    log(f"phase 3f kernel #14 == plain version: ok, max |dz| "
        f"{errs['finito_coeff_multistep_streamed']:.3e}")
    log(f"phase 3g kernel #8 == plain version: ok, max |dz| "
        f"{errs['lfinito_sweep_multistep']:.3e}")
    reset_counts()
    lfin = run_deep_finito(prob, card)
    c4g = counts()
    if (c4g["finito_coeff_multistep_streamed"] == 0
            or c4g["lfinito_sweep_multistep"] == 0
            or c4g["coeff_apply_all"] == 0
            or sum(c4g.values()) != c4g["finito_coeff_multistep_streamed"]
            + c4g["lfinito_sweep_multistep"] + c4g["coeff_apply_all"]):
        raise AssertionError(f"the deep Finito paths did not run on kernels "
                             f"#14, #8 and #6 alone: {c4g}")
    log(f"phase 4g deep-shape Finito paths: ok, launches {c4g}")
    times7 = {}
    for storage in ("f32", "int8"):
        Fd = prob.oracle(storage)
        tag = f"{storage} rows, N={DEEP['N']} n={DEEP['n']} B={DEEP['B']}"
        times7["#14", storage] = time_finito(Fd, gen, dev, DEEP["B"], True,
                                             f"kernel #14, {tag}", card)
        times7["#8", storage] = time_lfinito(Fd, gen, dev, DEEP["B"],
                                             f"kernel #8, {tag}", card)
        r = lfin["stream", storage]
        profile_one_launch(
            f"streamed Finito steps at the deep shape, {storage} rows",
            lambda: finito_run(r["F"], r["g"], r["st"], r["cfg"],
                               "basic_coeff", 256), 256, card,
            FINITO_STREAM_GROUPS, "kernel #14",
            "finito_coeff_multistep_streamed")
        r = lfin[storage]
        profile_one_launch(
            f"LFinito epochs at the deep shape, {storage} rows",
            lambda: finito_run(r["F"], r["g"], r["st"], r["cfg"], "lfinito",
                               2), 2, card, LFINITO_GROUPS, "kernel #8",
            "lfinito_sweep_multistep", unit="epoch")

    # 6, 11 at the deep shape: kernels #6 and #7 per pass on its rows
    t_deep = {s_: time_apply_deep(prob, gen, dev, s_, card, ceil)
              for s_ in ("f32", "int8")}
    deep_err = max(t["err"] for t in t_deep.values())
    errs["coeff_apply_all"] = max(errs["coeff_apply_all"], deep_err)

    # 3o/3p at the deep shape, then 4p, 4r: SSNM and Point-SAGA on the deep
    # target, counts from 0 (inside), and kernels #13 and #15 timed
    newdeep = run_new_deep(prob, gen, dev, card)
    newdeep_errs = newdeep["errs"]
    launches["ssnm_multistep_streamed"] = newdeep["launches"][
        "ssnm_multistep_streamed"]
    launches["point_saga_multistep_streamed"] = newdeep["launches"][
        "point_saga_multistep_streamed"]
    times10 = {}
    for storage in ("f32", "int8"):
        tag = f"{storage} rows, N={DEEP['N']} n={DEEP['n']} B={DEEP['B']}"
        times10["#13", storage] = time_new(newdeep["runs"]["ssnm", storage],
                                           "ssnm", gen, dev,
                                           f"kernel #13, {tag}", card)
        times10["#15", storage] = time_new(newdeep["runs"]["ps", storage],
                                           "ps", gen, dev,
                                           f"kernel #15, lsq {tag}", card)
    for (fam, storage), r in newdeep["runs"].items():
        if fam == "ssnm":
            profile_one_launch(
                f"SSNM at the deep target, {storage} rows",
                lambda: r["run"](128), 128, card, SSNM_STREAM_GROUPS,
                "kernel #13", "ssnm_multistep_streamed")
        else:
            profile_one_launch(
                f"Point-SAGA at the deep target, {storage} rows",
                lambda: r["run"](128), 128, card, PS_STREAM_GROUPS,
                "kernel #15", "point_saga_multistep_streamed")
    del prob, lfin, Fd, newdeep, r
    torch.cuda.empty_cache()

    # 4d. the SVRG path, counts from 0
    reset_counts()
    svrg = {s_: run_svrg_headline(gen, dev, s_, card) for s_ in ("int8", "f32")}
    svrg_ms = {s_: r["ms"] for s_, r in svrg.items()}
    run_svrg_facades(dev, fprob, fF, card)
    c4d = counts()
    if (c4d["svrg_coeff_multistep"] == 0 or c4d["coeff_apply_all"] == 0
            or c4d["saga_coeff_multistep"] or c4d[
                "saga_coeff_multistep_streamed"]):
        raise AssertionError(f"the SVRG path did not run on kernels #5 and "
                             f"#6 alone: {c4d}")
    log(f"phase 4d SVRG path: ok, launches {c4d}")

    # 4e. the FISTA path, counts from 0
    reset_counts()
    fista_ms = {}
    steps = 0
    for storage in ("f32", "int8"):
        F, _, L = lasso(gen, dev, N, n, storage)
        g = NormL1(torch.tensor(LAM, dtype=torch.float32, device=dev))
        fista_ms[storage] = run_fista(dev, F, g, L, FISTA_STEPS,
                                      f"headline {storage}", card)
        steps += FISTA_STEPS
        del F
    run_fista(dev, fF, NormL1(fprob.lam), fprob.L, FISTA_FACADE_STEPS,
              f"planted make_lasso(N={FACADE['N']}, n={n})", card,
              gap=lambda x: fprob.cost(x.double().cpu().numpy())
              - fprob.f_star)
    steps += FISTA_FACADE_STEPS
    c4e = counts()
    if c4e["coeff_apply_all"] != steps or sum(c4e.values()) != steps:
        raise AssertionError(f"the FISTA path: launches {c4e}, expected "
                             f"{steps} of kernel #6 alone")
    log(f"phase 4e FISTA path: ok, launches {c4e}")
    launches["svrg_coeff_multistep"] = c4d["svrg_coeff_multistep"]
    launches["coeff_apply_all"] = c4d["coeff_apply_all"] + c4e[
        "coeff_apply_all"] + c4g["coeff_apply_all"]

    # 4f. the Finito headline path, counts from 0
    reset_counts()
    fin = {s_: run_finito_headline(gen, dev, s_, card) for s_ in ("f32",
                                                                  "int8")}
    run_finito_facades(dev, fprob, fF, args.seed, card)
    c4f = counts()
    if (c4f["finito_coeff_multistep"] == 0 or c4f["finito_block_update"] == 0
            or sum(c4f.values()) != c4f["finito_coeff_multistep"]
            + c4f["finito_block_update"]):
        raise AssertionError(f"the Finito headline path did not run on "
                             f"kernels #9 and #2 alone: {c4f}")
    log(f"phase 4f Finito headline path: ok, launches {c4f}")
    launches["finito_coeff_multistep"] = c4f["finito_coeff_multistep"]
    launches["finito_block_update"] = c4f["finito_block_update"]
    launches["finito_coeff_multistep_streamed"] = c4g[
        "finito_coeff_multistep_streamed"]
    launches["lfinito_sweep_multistep"] = c4g["lfinito_sweep_multistep"]

    # 4h. the ProShI path, counts from 0
    reset_counts()
    prosh = run_proshi(gen, dev, card)
    c4h = counts()
    if c4h["proshi_multistep"] == 0 or sum(c4h.values()) != c4h[
            "proshi_multistep"]:
        raise AssertionError(f"the ProShI path did not run on kernel #18 "
                             f"alone: {c4h}")
    log(f"phase 4h ProShI path: ok, launches {c4h}")
    launches["proshi_multistep"] = c4h["proshi_multistep"]

    # 4i. SAGA's full table, counts from 0
    reset_counts()
    full = run_saga_full(gen, dev, fprob, fF, card)
    c4i = counts()
    if c4i["saga_block_update"] == 0 or sum(c4i.values()) != c4i[
            "saga_block_update"]:
        raise AssertionError(f"the full-table SAGA path did not run on "
                             f"kernel #1 alone: {c4i}")
    log(f"phase 4i SAGA full-table path: ok, launches {c4i}")
    launches["saga_block_update"] = c4i["saga_block_update"]

    # 4j. the sharing deep route, stepwise by design, counts from 0
    reset_counts()
    sharing_rel = run_sharing_deep(dev, card)
    c4j = counts()
    if sum(c4j.values()):
        raise AssertionError(f"the sharing deep route launched kernels: "
                             f"{c4j}")
    log(f"phase 4j sharing deep route: ok, rel {sharing_rel:.3e} (accuracy "
        f"record rel {SHARING_RECORD:g}), no kernel launches")

    # 5, 5b, 6. times, in turns
    times = {}
    for storage, run in (("int8", int8), ("f32", f32)):
        times[storage] = timed_turns(
            saga_coeff_multistep, saga_coeff_multistep_ref, run["F"],
            run["gamma"], gen, dev, B,
            f"kernel #3, {storage} rows, N={N} n={n} B={B}", card)
        profile_headline_saga(run, storage, card)
    del int8, f32
    log(f"phase 5 times: int8 kernel {times['int8']['ms']:.4f} ms/step, "
        f"plain {times['int8']['plain_ms']:.4f}; f32 kernel "
        f"{times['f32']['ms']:.4f}, plain {times['f32']['plain_ms']:.4f} "
        f"[{card}]")
    log(f"phase 5b times: f32 kernel {times4['f32']['ms']:.4f} ms/step, "
        f"plain {times4['f32']['plain_ms']:.4f}; int8 kernel "
        f"{times4['int8']['ms']:.4f}, plain {times4['int8']['plain_ms']:.4f} "
        f"[{card}]")
    t6 = {s_: time_apply(gen, dev, s_, card, ceil)
          for s_ in ("f32", "bf16", "int8")}
    t5 = {s_: time_svrg(gen, dev, s_, card) for s_ in ("f32", "int8")}
    from ciao_tpu_torch.solvers.fb import FBCfg, fb_init, fb_run
    from ciao_tpu_torch.solvers.svrg import svrg_run

    for storage, r in svrg.items():
        profile_one_launch(f"SVRG outer steps, {storage} rows",
                           lambda: svrg_run(r["F"], r["g"], r["st"],
                                            r["cfg"], 10), 10, card,
                           SVRG_GROUPS, "kernel #5", "svrg_coeff_multistep")
        fcfg = FBCfg(N=N, fast=True, fused=True)
        fst = fb_init(r["F"], r["g"], torch.zeros(n, device=dev),
                      1.0 / r["L"].mean(), fcfg)
        profile_steps(f"FISTA steps, {storage} rows",
                      lambda: fb_run(r["F"], r["g"], fst, fcfg, 50), 50, card)
    del svrg
    log(f"phase 6 times: kernel #6 f32 {t6['f32']['ms']:.4f} ms/pass (plain "
        f"{t6['f32']['plain_ms']:.4f}, bound {t6['f32']['bound_ms']:.4f}, "
        f"two-gemv {t6['f32']['two_gemv_ms']:.4f}), int8 "
        f"{t6['int8']['ms']:.4f} (bound {t6['int8']['bound_ms']:.4f}); "
        f"at the deep shape f32 {t_deep['f32']['#6']['ms']:.4f} (plain "
        f"{t_deep['f32']['#6']['plain_ms']:.4f}, bound "
        f"{t_deep['f32']['#6']['bound_ms']:.4f}), int8 "
        f"{t_deep['int8']['#6']['ms']:.4f} (bound "
        f"{t_deep['int8']['#6']['bound_ms']:.4f}); "
        f"kernel #5 f32 {t5['f32']['ms']:.4f} ms/step (plain "
        f"{t5['f32']['plain_ms']:.4f}, bound {t5['f32']['bound_ms']:.4f}), "
        f"int8 {t5['int8']['ms']:.4f}; SVRG outer step f32 "
        f"{svrg_ms['f32']:.4f} ms, int8 {svrg_ms['int8']:.4f}; FISTA step "
        f"f32 {fista_ms['f32']:.4f} ms, int8 {fista_ms['int8']:.4f} [{card}]")

    # 7. the Finito kernels' times, in turns, and the Finito step profiled
    for storage in ("f32", "int8"):
        r = fin[storage]
        times7["#9", storage] = time_finito(
            r["F"], gen, dev, B, False,
            f"kernel #9, {storage} rows, N={N} n={n} B={B}", card)
        profile_one_launch(
            f"Finito steps at the headline, {storage} rows",
            lambda: finito_run(r["F"], r["g"], r["st"], r["cfg"],
                               "basic_coeff", 256), 256, card, FINITO_GROUPS,
            "kernel #9", "finito_coeff_multistep")
    del fin
    for storage in ("f32", "bf16"):
        times7["#2", storage] = time_block(gen, dev, storage, card)
    log(f"phase 7 times: kernel #9 f32 {times7['#9', 'f32']['ms']:.4f} "
        f"ms/step (plain {times7['#9', 'f32']['plain_ms']:.4f}), int8 "
        f"{times7['#9', 'int8']['ms']:.4f}; kernel #14 f32 "
        f"{times7['#14', 'f32']['ms']:.4f}, int8 "
        f"{times7['#14', 'int8']['ms']:.4f}; kernel #8 f32 "
        f"{times7['#8', 'f32']['ms']:.4f}, int8 "
        f"{times7['#8', 'int8']['ms']:.4f}; kernel #2 f32 "
        f"{times7['#2', 'f32']['ms']:.4f} on the device, "
        f"{times7['#2', 'f32']['call_ms']:.4f} a call, bf16 "
        f"{times7['#2', 'bf16']['ms']:.4f}, "
        f"{times7['#2', 'bf16']['call_ms']:.4f} [{card}]")

    # 8. kernels #18 and #1 in turns with their plain versions; a ProShI
    # window and a full-table SAGA epoch profiled
    from ciao_tpu_torch.solvers.proshi import proshi_run

    times8 = {}
    for storage in ("f32", "int8"):
        r = prosh[storage]
        times8["#18", storage] = time_proshi(r, gen, dev, storage, card)
        profile_one_launch(
            f"ProShI steps at the configuration, {storage} rows",
            lambda: proshi_run(r["F"], r["g"], r["st"], r["cfg"], 256), 256,
            card, PROSHI_GROUPS, "kernel #18", "proshi_multistep")
    for storage in ("f32", "bf16"):
        times8["#1", storage] = time_saga_block(full[storage], gen, dev,
                                                storage, card)
    del prosh, full
    log(f"phase 8 times: kernel #18 f32 {times8['#18', 'f32']['ms']:.4f} "
        f"ms/step (plain {times8['#18', 'f32']['plain_ms']:.4f}, bound "
        f"{times8['#18', 'f32']['bound_ms']:.4f}), int8 "
        f"{times8['#18', 'int8']['ms']:.4f} (bound "
        f"{times8['#18', 'int8']['bound_ms']:.4f}); kernel #1 f32 "
        f"{times8['#1', 'f32']['ms']:.4f} on the device, "
        f"{times8['#1', 'f32']['call_ms']:.4f} a call (bound "
        f"{times8['#1', 'f32']['bound_ms']:.4f}), bf16 "
        f"{times8['#1', 'bf16']['ms']:.4f}, "
        f"{times8['#1', 'bf16']['call_ms']:.4f} [{card}]")

    # 3k-3n. kernels #10, #11, #16, #17 == their plain versions
    errs.update(phase_check_vr(gen, dev))
    log(f"phase 3k-3n kernels #10, #11, #16, #17 == plain versions: ok, max "
        f"|d iterate| " + ", ".join(f"{VR[k][1]} {errs[VR[k][0]]:.3e}"
                                    for k in VR))
    torch.cuda.empty_cache()

    # 4k-4n. the SVRG-shaped families at the headline, their facades and
    # Katyusha's time to rel 1e-3, each family with counts from 0
    vr = {}
    for phase, fam in zip("klmn", VR):
        name = VR[fam][0]
        reset_counts()
        vr[fam] = {s_: run_vr_headline(fam, gen, dev, s_, card)
                    for s_ in ("f32", "int8")}
        run_vr_facade(fam, dev, fprob, fF, card)
        if fam == "katyusha":
            run_katyusha_to_rel(dev, args.seed, card)
        c = counts()
        if c[name] == 0 or c["coeff_apply_all"] == 0 or sum(
                c.values()) != c[name] + c["coeff_apply_all"]:
            raise AssertionError(f"the {fam} path did not run on kernels "
                                 f"{VR[fam][1]} and #6 alone: {c}")
        launches[name] = c[name]
        launches["coeff_apply_all"] += c["coeff_apply_all"]
        log(f"phase 4{phase} {fam} path: ok, launches "
            f"{ {k: v for k, v in c.items() if v} }")
        torch.cuda.empty_cache()

    # 9. the four kernels in turns with their plain versions, and a window
    # of each family profiled
    times9 = {}
    for fam, runs in vr.items():
        steps = 8 if fam in ("katyusha", "sarah") else 2_048
        name, label = VR[fam]
        for storage, r in runs.items():
            times9[fam, storage] = time_vr(fam, r, gen, dev, storage, card)
            times9[fam, storage, VR_FACADE[fam]["batch"]] = time_vr(
                fam, r, gen, dev, storage, card, VR_FACADE[fam]["batch"])
            profile_one_launch(
                f"{fam} at the headline, {storage} rows",
                lambda: r["run"](r["F"], r["g"], r["st"], r["cfg"], steps),
                steps, card, VR_GROUPS[fam], f"kernel {label}", name,
                unit="outer step" if steps == 8 else "step")
    del vr, runs, r
    log("phase 9 times: " + "; ".join(
        f"kernel {VR[k[0]][1]} {k[1]}"
        + (f" B={k[2]}" if len(k) > 2 else "")
        + f" {t['ms']:.4f} ms/step (plain {t['plain_ms']:.4f}, bound "
        f"{t['bound_ms']:.5f})" for k, t in times9.items()) + f" [{card}]")

    # 3o-3p. kernels #19, #13, #12, #15 == their plain versions
    errs.update(phase_check_new(gen, dev))
    for k, v in newdeep_errs.items():
        errs[k] = max(errs[k], v)
    log("phase 3o-3p kernels #19, #13, #12, #15 == plain versions: ok, max "
        "|dx| " + ", ".join(f"{k} {errs[k]:.3e}" for k in (
            "ssnm_multistep", "ssnm_multistep_streamed",
            "point_saga_multistep", "point_saga_multistep_streamed")))
    torch.cuda.empty_cache()

    # 4o, 4q. SSNM and Point-SAGA at the headline, counts from 0
    reset_counts()
    newh = run_new_headline(gen, dev, card)
    c = counts()
    if (c["ssnm_multistep"] == 0 or c["point_saga_multistep"] == 0
            or sum(c.values()) != c["ssnm_multistep"]
            + c["point_saga_multistep"]):
        raise AssertionError(f"the SSNM and Point-SAGA headline paths did "
                             f"not run on kernels #19 and #12 alone: {c}")
    log(f"phase 4o/4q SSNM and Point-SAGA headline paths: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    launches["ssnm_multistep"] = c["ssnm_multistep"]
    launches["point_saga_multistep"] = c["point_saga_multistep"]

    # 4s. the SSNM and PointSAGA facades, counts from 0
    reset_counts()
    run_new_facades(dev, fprob, fF, card)
    c = counts()
    if (c["ssnm_multistep"] == 0 or c["point_saga_multistep"] == 0
            or sum(c.values()) != c["ssnm_multistep"]
            + c["point_saga_multistep"]):
        raise AssertionError(f"the SSNM and PointSAGA facades did not run on "
                             f"kernels #19 and #12 alone: {c}")
    log(f"phase 4s SSNM and PointSAGA facades: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    launches["ssnm_multistep"] += c["ssnm_multistep"]
    launches["point_saga_multistep"] += c["point_saga_multistep"]

    # 4t. deep_solve on logistic rows, counts from 0
    reset_counts()
    run_logistic_deep(dev, card)
    c = counts()
    if c["saga_coeff_multistep"] == 0 or sum(c.values()) != c[
            "saga_coeff_multistep"]:
        raise AssertionError(f"deep_solve on logistic rows did not run on "
                             f"kernel #3 alone: {c}")
    log(f"phase 4t deep_solve logistic: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    launches["saga_coeff_multistep"] += c["saga_coeff_multistep"]

    # 10. kernels #19 and #12 in turns with their plain versions at the
    # headline
    for storage in ("f32", "int8"):
        tag = f"{storage} rows, N={N} n={n} B={B}"
        times10["#19", storage] = time_new(newh["ssnm", storage], "ssnm", gen,
                                           dev, f"kernel #19, {tag}", card)
        for kind in ("lsq", "logistic"):
            times10["#12", kind, storage] = time_new(
                newh["ps", kind, storage], "ps", gen, dev,
                f"kernel #12, {kind} {tag}", card)
    log("phase 10 times: " + "; ".join(
        f"kernel {' '.join(k)} {t['ms']:.4f} ms/step (plain "
        f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.5f})"
        for k, t in times10.items()) + "; end to end " + "; ".join(
        f"{' '.join(k)} {r['ms']:.4f} ms/step, idle "
        f"{1.0 - r['prof']['busy'] / r['prof']['step']:.3f}"
        for k, r in newh.items()) + f" [{card}]")
    del newh

    # 3q. kernel #7 == its plain version, kernel #6 bit for bit its earlier
    # output
    errs["coeff_value_apply_all"] = max(phase_check_value(gen, dev),
                                        deep_err)
    log(f"phase 3q kernel #7 == plain version, kernel #6 on its digests: "
        f"ok, max abs err {errs['coeff_value_apply_all']:.3e}")
    torch.cuda.empty_cache()

    # 4u. PANOC and ZeroFPR at the headline, counts from 0
    reset_counts()
    pan = run_panoc_headline(gen, dev, card)
    c = counts()
    if c["coeff_value_apply_all"] == 0 or sum(c.values()) != c[
            "coeff_value_apply_all"]:
        raise AssertionError(f"the PANOC path did not run on kernel #7 "
                             f"alone: {c}")
    launches["coeff_value_apply_all"] = c["coeff_value_apply_all"]
    log(f"phase 4u PANOC/ZeroFPR headline path: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    torch.cuda.empty_cache()

    # 4v. the PANOC and ZeroFPR facades, counts from 0
    reset_counts()
    run_panoc_facades(dev, fprob, fF, card)
    c = counts()
    if c["coeff_value_apply_all"] == 0 or sum(c.values()) != c[
            "coeff_value_apply_all"]:
        raise AssertionError(f"the PANOC facades did not run on kernel #7 "
                             f"alone: {c}")
    launches["coeff_value_apply_all"] += c["coeff_value_apply_all"]
    log(f"phase 4v PANOC and ZeroFPR facades: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")

    # 4w. Davis-Yin and Condat-Vu at the headline, counts from 0
    reset_counts()
    split = run_splitting_headline(gen, dev, card)
    c = counts()
    if c["coeff_apply_all"] == 0 or sum(c.values()) != c["coeff_apply_all"]:
        raise AssertionError(f"the splitting paths did not run on kernel #6 "
                             f"alone: {c}")
    launches["coeff_apply_all"] += c["coeff_apply_all"]
    log(f"phase 4w Davis-Yin and Condat-Vu headline paths: ok, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    del fprob, fF
    torch.cuda.empty_cache()

    # 4x. the sparse route (no kernel by design), counts from 0
    t0 = time.perf_counter()
    reset_counts()
    sp = run_sparse_e2e(dev, args.seed, card)
    torch.cuda.empty_cache()
    spf = run_sparse_full(dev, args.seed, card)
    c = counts()
    if sum(c.values()):
        raise AssertionError(f"the sparse route launched kernels: {c}")
    log(f"phase 4x sparse route: ok, no kernel launches; FISTA to rel 1e-3 "
        + ", ".join(f"{k} {v['passes']} passes {v['s']:.3f} s"
                    for k, v in sp["fista"].items())
        + "; SAGA ms/step at B=2048 " + ", ".join(
            f"{k} {v['ms']:.4f} (idle {v['idle']:.3f})"
            for k, v in sp["saga"].items() if k != "repeat")
        + f", bits repeat {sp['saga']['repeat']}; at "
        f"{SPARSE_FULL['N']} x {SPARSE_FULL['n']} B={SPARSE_FULL['B']} "
        + ", ".join(f"{k} {v['ms']:.4f} (idle {v['idle']:.3f})"
                    for k, v in spf.items() if k != "s")
        + "; deep rel " + ", ".join(
            f"lsq {k} {v['rel']:.3e} ({v['s']:.2f} s)"
            for k, v in sp["deep"].items()) + ", " + ", ".join(
            f"logistic {k} {v['rel']:.3e} ({v['s']:.2f} s)"
            for k, v in sp["logistic"].items() if k != "ref_s")
        + f"; seconds (a) {sp['a_s']:.2f}, (b) {spf['s']:.2f}, (c) "
        f"{sp['c_s']:.2f}, (d) {sp['d_s']:.2f}, all "
        f"{time.perf_counter() - t0:.2f} [{card}]")

    # 4y. the primal-dual deep route (no kernel by design), counts from 0
    t0 = time.perf_counter()
    reset_counts()
    pd = {}
    for leg in ("fused lasso", "three-term"):
        pd[leg] = run_pd_leg(dev, args.seed, leg == "three-term", card)
        torch.cuda.empty_cache()
    c = counts()
    if sum(c.values()):
        raise AssertionError(f"the primal-dual deep route launched kernels: "
                             f"{c}")
    log(f"phase 4y primal-dual deep route: ok, none of the {len(c)} kernels "
        f"launched; at {PD_DEEP['N']} x {PD_DEEP['n']}, " + "; ".join(
            f"{k}: rel {v['rel']:.3e}, refined {v['refined']}, certified "
            f"{v['certified']}, {v['steps']} steps, {v['s']:.3f} s "
            f"(Condat-Vu {v['cv_s']:.3f} s, refine {v['refine_s']:.3f} s), "
            f"{v['ms']:.4f} ms/step, idle {v['idle']:.3f}, "
            f"{v['launches']:.1f} launches/step"
            + ("" if v["zeros"] is None else
               f", planted zeros exact {v['zeros']}")
            for k, v in pd.items())
        + f"; all {time.perf_counter() - t0:.2f} s [{card}]")

    # 11. kernel #7 per pass in turns with its plain version and kernel #6
    t11 = {s_: time_value_apply(gen, dev, s_, card, ceil)
           for s_ in ("f32", "bf16", "int8")}
    log("phase 11 times: " + "; ".join(
        f"kernel #7 {s_} {t['ms']:.4f} ms/pass (kernel #6 {t['six_ms']:.4f}, "
        f"plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f})"
        for s_, t in t11.items()) + "; " + "; ".join(
        f"at the deep shape kernel #7 {s_} {t['#7']['ms']:.4f} ms/pass "
        f"(kernel #6 {t['#6']['ms']:.4f}, plain {t['#7']['plain_ms']:.4f}, "
        f"bound {t['#7']['bound_ms']:.4f})"
        for s_, t in t_deep.items()) + "; " + "; ".join(
        f"{'ZeroFPR' if f == 'zerofpr' else 'PANOC'} {s_}"
        f"{' adaptive' if a else ''} {r['ms']:.4f} ms/step, "
        f"{r['evals']:.3f} FBE evaluations a step, idle "
        f"{1.0 - r['prof']['busy'] / r['prof']['step']:.3f}"
        for (f, s_, a), r in pan.items()) + "; " + "; ".join(
        f"{'Davis-Yin' if f == 'dys' else 'Condat-Vu'} {s_}"
        f"{'' if m is None else f' DenseMap {m}'} {ms:.4f} ms/step"
        for (f, s_, m), ms in split.items()) + f" [{card}]")

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log("steps on the main path (launches x K): " + json.dumps(
        {name: getattr(launches[name], "steps", 0) for name in KERNELS
         if name in launches}))
    log(json.dumps({"kernels": [
        kernel_line("saga_coeff_multistep", launches["saga_coeff_multistep"],
                    errs["saga_coeff_multistep"], times["int8"]),
        kernel_line("saga_coeff_multistep_streamed",
                    launches["saga_coeff_multistep_streamed"],
                    errs["saga_coeff_multistep_streamed"], times4["f32"]),
        kernel_line("svrg_coeff_multistep", launches["svrg_coeff_multistep"],
                    errs["svrg_coeff_multistep"], t5["f32"]),
        kernel_line("coeff_apply_all", launches["coeff_apply_all"],
                    errs["coeff_apply_all"], t6["f32"]),
        kernel_line("finito_coeff_multistep",
                    launches["finito_coeff_multistep"],
                    errs["finito_coeff_multistep"], times7["#9", "f32"]),
        kernel_line("finito_coeff_multistep_streamed",
                    launches["finito_coeff_multistep_streamed"],
                    errs["finito_coeff_multistep_streamed"],
                    times7["#14", "f32"]),
        kernel_line("lfinito_sweep_multistep",
                    launches["lfinito_sweep_multistep"],
                    errs["lfinito_sweep_multistep"], times7["#8", "f32"]),
        kernel_line("finito_block_update", launches["finito_block_update"],
                    errs["finito_block_update"], times7["#2", "f32"]),
        kernel_line("saga_block_update", launches["saga_block_update"],
                    errs["saga_block_update"], times8["#1", "f32"]),
        kernel_line("proshi_multistep", launches["proshi_multistep"],
                    errs["proshi_multistep"], times8["#18", "f32"]),
        *(kernel_line(VR[k][0], launches[VR[k][0]], errs[VR[k][0]],
                      times9[k, "f32"]) for k in VR),
        kernel_line("ssnm_multistep", launches["ssnm_multistep"],
                    errs["ssnm_multistep"], times10["#19", "f32"]),
        kernel_line("ssnm_multistep_streamed",
                    launches["ssnm_multistep_streamed"],
                    errs["ssnm_multistep_streamed"], times10["#13", "f32"]),
        kernel_line("point_saga_multistep", launches["point_saga_multistep"],
                    errs["point_saga_multistep"],
                    times10["#12", "lsq", "f32"]),
        kernel_line("point_saga_multistep_streamed",
                    launches["point_saga_multistep_streamed"],
                    errs["point_saga_multistep_streamed"],
                    times10["#15", "f32"]),
        kernel_line("coeff_value_apply_all",
                    launches["coeff_value_apply_all"],
                    errs["coeff_value_apply_all"], t11["f32"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
