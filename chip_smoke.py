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
  nineteen kernels, by design;
- checkpoints (``ciao_tpu_torch.checkpoint``) at full width: the headline
  and SAGA's 1 GiB full table saved, loaded and resumed, an async save
  while the solver steps, and every facade's iterator resumed;
- the sharded checkpoint (``save_async(..., mesh=)``, ``load_orbax``) at
  the headline's width on two gloo ranks and one NCCL rank: same-mesh
  resumes, 2 -> 1 and 1 -> 2 ranks, a TP state, the full table timed;
- the entry point ``ciao_tpu_torch.entry`` (traced by
  ``monitor.profiler_trace``) and the ten examples of ``examples_torch/``
  at their default sizes, ``multihost.py`` also as two processes.

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
  4u. PANOC/ZeroFPR at the headline (32 steps each): kernel #7 launched once
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
     65,536 (hot 1,024, k 48 + 16): SAGA at B = 4,096 on each layout, then
     the plant built again at --seed (the first freed) and held to the
     first bit for bit in every field;
  4y. the primal-dual deep route (compensated Condat-Vũ and the certified
     reduced solves in torch; no kernel launches, by design): bench.py's
     bench_pd_deep plants of 262,144 x 1,024 f32 rows with 16 jumps built
     on the card, ``deep_solve_pd`` on the fused lasso (h = λ‖D·‖₁) and on
     the three-term objective (g = λ₁‖·‖₁ as well) at chunk 4,096, 256 steps
     a round, at most 8,192: each leg refined and certified, rel <= 1e-6
     from the difference-form gap, the three-term leg's planted zeros
     exactly zero; seconds split into the Condat-Vũ rounds and the
     refinement, ms a step, and a profiled window of 8 steps (idle share,
     device launches a step);
  4z. complex rows and iterates (PyTorch ops; no kernel launches, by
     design, as the JAX package sends a complex iterate past every kernel
     gate): a planted complex64 Lasso of 262,144 x 1,024 rows (2 GiB) built
     on the card (make_lasso's KKT recipe with complex C and y, checked),
     whether TF32 touches complex64 products, FISTA at the spectral step
     to rel 1e-3 (steps, seconds), a short run of SAGA, SVRG, Finito,
     Katyusha, SARAH, L-SVRG, Point-SAGA, PANOC and Condat-Vũ through
     their facades, each cost falling, with ms a step, device launches a
     step, the idle share of a profiled window and the bound of the rows a
     step reads; one SAGA and one Point-SAGA step held to the same step
     recomputed in complex128 on the drawn block, closer than 1 % of how
     far it moves without the conjugates; CustomOracle's Welsch loss
     through SARAH and PANOC at tests/test_nonconvex.py's 256 x 16 and
     bars, and Precompose of a scalar logistic loss == LogisticRows;
  4ck. checkpoints: (a) the headline's coefficient SAGA through saga_run,
     2·128 steps straight against 128, ``save``, ``load`` and 128 more,
     split at a launch boundary so that both issue the same kernel #3
     launches, z, av and s bit for bit; (b) SAGA's full table at the
     headline (1 GiB of f32, kernel #1 a step) through the iterator:
     ``save`` and ``load`` timed (seconds, GB/s), ``save_async`` and 64
     steps while the write runs (ms a step with and without a write in
     flight), the file equal to its snapshot and the resume from it equal
     to the straight run, bit for bit; (c) an int8-stage SAGA state
     resumed under f32 rows with ``rebase=True``, its av within 1e-6 of
     kernel #6's f32 pass over its table; (d) every facade's iterator on
     the facades' planted Lasso (SAGA, SAG, SVRG, SVRG++, FISTA, Finito's
     coefficient and full tables, LFinito, adaptive Finito, ProShI,
     Katyusha, SARAH, L-SVRG, L-Katyusha, SSNM, Point-SAGA, PANOC,
     ZeroFPR, Davis-Yin, Condat-Vũ) and a complex64 SAGA state on 4z's
     plant, stopped, saved, loaded onto the card and resumed, bit for bit
     the straight run, with the kernels each resume launched; (e) a
     sparse-route SAGA state, held to 1e-5 of its largest entry (its
     scatter-adds add with atomics);
  4ex. ``entry()`` (one kernel #4 launch) inside
     ``monitor.profiler_trace``, whose Chrome trace must name the launch,
     then each example of ``examples_torch/`` at its default size
     (``large_scale_lasso`` in f32, bf16 and int8), its asserts holding,
     with its own numbers and the kernels it launched: #6 and #8 for the
     LFinito examples, #3 or #4 (and #6) for ``deep_accuracy``, none for
     ``fused_lasso_tv``, ``tv_denoise_2d`` and ``sparse_logistic``, #10
     and #6 for ``robust_regression`` and ``poisson_glm`` (Katyusha's;
     DPKatyusha runs lockstep on one NCCL rank of their own), #11 and #6
     for ``nonconvex_sparse_mcp`` (its L1 run; MCP's prox closes SARAH's
     gate), #3 for ``multihost`` (its local rounds; the lockstep run has
     none); before the parallel examples a timed window of the lockstep
     DPSAGA step on ``multihost.py``'s problem; beside them
     ``multihost.py`` as two processes on the one card over gloo, started
     from the ``torchrun`` environment with ``CIAO_MULTIHOST=1``;
  4dp. the data-parallel path (``ciao_tpu_torch.parallel``): (a) one rank
     over NCCL: bench.py's DP rounds at the headline (DPSAGA, K = 128 steps
     a round on kernel #3, 512 rounds, the exact av every 50; f32 and
     int8), the first round held to the single-card coefficient SAGA on
     the same starts within 1e-6 and ms a step beside the single-card
     SAGA's; SVRG++'s local inner loop, m 64 -> 8,192 over 8 outer steps,
     on kernels #5 and #6 and on the plain path (ms an inner step);
     ``deep_solve_dp`` on deep_accuracy.py's 1,048,576 x 128 problem to
     rel <= 1e-6 (seconds); (b) two ranks on the one card over gloo (CUDA
     tensors; NCCL refuses two ranks on one device), spawned after the
     build, 131,072 headline rows each: DPSAGA (#3) and coefficient
     DPFinito (#9) local rounds, the LFinito local sweep (#6, #8), DPSVRG's
     local inner loop (#5, #6) and DPProshi's cyclic local rounds on
     ProShI's 65,536 x 1,024 configuration (#18), and DPKatyusha's and
     DPSARAH's local inner loops (#10, #11, #6), each on its kernel path
     and its plain path (the gate closed), held within 1e-6 (z) and 1e-5
     (av, tables; Katyusha's and SARAH's vectors); DPLSVRG, DPLKatyusha, DPPointSAGA, DPSSNM,
     DPDavisYin, DPCondatVu, DPPANOC and DPZeroFPR a few steps each (no
     kernel), PANOC's and ZeroFPR's FBE evaluations equal on both ranks;
     every replicated vector bit for bit across the ranks; (c) one rank
     over NCCL at the headline: DPKatyusha and DPSARAH with local inner
     loops of m = 2N/batch = 128 steps on #10/#11 and #6 (f32 and int8),
     the first outer step held to the single-card fused solver on the same
     starts within 1e-6, ms an inner step beside the single card's and the
     launches an outer step; short runs of the eight families with no
     kernel (the cost falls, ms a step, launches a step and the idle share
     of a profiled window, PANOC's FBE evaluations a step, none of the 19
     kernels launched); ``deep_solve_pd_dp`` on 4y's fused-lasso plant,
     certified to rel <= 1e-6, its seconds beside 4y's ``deep_solve_pd``;
     the launches of the DP path counted (the comparison runs excluded);
  4tp. the tensor-parallel path (``make_mesh_2d`` and the TP facades; no
     kernel by design, none of the 19 launched): (a) one rank over NCCL on
     a (1, 1) mesh at the headline: TPSAGA and SAG, TPFinito sweep 3 (f32
     and int8), TPLFinito, TPSVRG at m = N/B and SVRG++, TPFISTA (f32),
     each's first steps held to the single card's plain path on the same
     schedule within 1e-6, ms a step beside the single card's stepwise
     step, all-reduces a step, launches a step and the idle share of a
     profiled window; TPProshi on 4j's 65,536 x 128 sharing plant;
     ``deep_solve_tp`` on deep_accuracy.py's 1,048,576 x 128 problem to rel
     <= 1e-6 beside 4dp's ``deep_solve_dp`` seconds; (b) two ranks on the
     one card over gloo: on a (1, 2) mesh (262,144 x 512 of the headline's
     rows a rank) TPSAGA (f32, int8), TPFinito, TPSVRG, TPFISTA and
     TPProshi, each rank's shards held within 1e-5 to (a)'s state of the
     same data and schedule and the fields whole on every rank bit for bit
     across the ranks, ``deep_solve_tp`` on 131,072 x 128 to rel <= 1e-6
     with x bit for bit on both; on a (2, 1) mesh TPFISTA held to (a)'s and
     TPSAGA's z and av bit for bit across the ranks; (c) one rank over NCCL
     on the (1, 1) mesh at the headline: TPLSVRG and TPLKatyusha at p =
     B/N, TPKatyusha and TPSARAH at m = N/B (two outer steps), TPPointSAGA
     (least squares) and TPSSNM, f32 and int8; TPDavisYin, TPCondatVu
     (FirstDifference), TPPANOC and TPZeroFPR, f32; each held and timed as
     (a)'s (the families that difference two whole margins, L-SVRG,
     L-Katyusha, Katyusha and SARAH, within 1e-5), with its launches of
     the 19 kernels (0);
     ``deep_solve_pd_tp`` on 4y's fused-lasso and three-term plants,
     certified to rel <= 1e-6, beside 4y's and 4dp's seconds; (d) on (b)'s
     (1, 2) mesh: those families a few steps each, each rank's shards held
     within 1e-5 to (c)'s state (PANOC's and ZeroFPR's envelope values;
     their iterates within 1e-2, their gradient and L-BFGS ring printed),
     TPCondatVu's halo held to the single card's CondatVu, PANOC's
     and ZeroFPR's FBE evaluations equal on both ranks; then
     ``entry.dryrun_multichip(2)`` on the two ranks;
  4sc. the sharded checkpoint at the headline's width: (c) DPSAGA's
     local rounds (kernel #3) on one NCCL rank saved with
     ``save_async(..., mesh=)``; two gloo ranks on the one card, 131,072
     rows each, restore it (``load_orbax``), their rows bit for bit its
     table, and resume with the cost falling; (a) the same solver saved
     while it steps on, restored on the same mesh and resumed, bit for bit
     the straight run in z, av and s, with kernel #3's launches; DPSAGA's
     full (131,072, 1,024) f32 table saved and restored bit for bit,
     seconds and GB/s of both; (d) a TPSAGA state on the (1, 2) mesh
     resumed bit for bit; (b) back on one NCCL rank, (a)'s checkpoint
     restored, the table bit for bit the two ranks', and resumed;
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
T_START = time.perf_counter()

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
    """Print a line; a phase's line ends with the script's seconds so far."""
    if msg.startswith("phase "):
        msg += f" (at {time.perf_counter() - T_START:.1f} s)"
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
# the facades on the facades' planted Lasso (FACADE), batch 1,024, 1,024
# steps (16 epochs; cut from 4,096, whose CPU runs took ~48 s), default τ,
# η and γ: the fall of SSNM's (NormL1) cost − f* and of PointSAGA's (g =
# None) mean gradient must agree to three digits with a run of the same
# seed and schedule on the host's CPU
NEW_FACADE = dict(batch=1_024, maxit=1_025)
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
# off and on, 32 steps each (cut from 128 for the script's time limit) from
# x0 = 0, γ = 0.95/mean(L), σ = 0.5·0.05/(2γ)
PANOC_STEPS = 32
# the Davis-Yin and Condat-Vũ configurations (:850-903): 600 steps each
SPLIT_STEPS = 600
DENSE_MAPS = (1_024, 8_192)
# the PANOC and ZeroFPR facades on the facades' planted Lasso (FACADE), as a
# user calls them with L, maxit steps: on the card with f32 rows, cost − f*
# at most PANOC_FACADE["rel"]·f*; on the host's CPU in f64 on the same
# (f32-rounded) data, below the card's. f32 cannot reach 1e-6·f* here: the
# margins a_i·x − b_i cancel most of b_i, so an f32 run stalls
# at 1.1-1.3e-5·f* on an H100 (the CPU's f64 runs of the same data reach
# 6.9e-6 and 1.6e-7), and the bar keeps 4x margin. The CPU twin of ZeroFPR
# takes cpu_zerofpr steps (1.2e-6·f* at 80 on the CPU, 10x under the card's
# floor, in a third of its 17.9 s at 200 on the card's host)
PANOC_FACADE = dict(maxit=200, rel=5e-5, cpu_zerofpr=80)
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
            maxit = (kw["cpu_zerofpr"] if side == "cpu"
                     and S is ct.ZeroFPR else kw["maxit"])
            with FBECount() as fbe:
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, it = S(maxit=maxit)(x0, F=Fx, g=ct.NormL1(prob.lam),
                                       L=prob.L)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                moved = {k: v - before[k] for k, v in counts().items()
                         if v != before[k]}
            rel = (prob.cost(x.double().cpu().numpy()) - prob.f_star) \
                / prob.f_star
            rels[side] = rel
            log(f"  facade {S.__name__}(maxit={maxit}) on planted "
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


def sparse_problem(dev, shape: dict, seed=None):
    """make_sparse_lasso_ell at ``shape`` on the card (at ``seed``, else
    the shape's), with its build time logged."""
    from ciao_tpu_torch.utils import make_sparse_lasso_ell

    t0 = time.perf_counter()
    prob = make_sparse_lasso_ell(
        N=shape["N"], n=shape["n"], hot=shape["hot"], k_hot=shape["k_hot"],
        k_cold=shape["k_cold"], p=shape["p"], rho=shape["rho"],
        seed=shape["seed"] if seed is None else seed, device=dev)
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


def plant_fields(prob) -> dict:
    """Every field of a sparse plant by name (both layouts' buffers and
    widths, x*, f*, λ, L), its tensors copied to the host."""
    out = dict(f_star=prob.f_star, lam=prob.lam, x_star=prob.x_star.cpu(),
               L=prob.L.cpu())
    for lay in ("ell", "hybrid"):
        F = getattr(prob, lay)
        out[f"{lay}.dim"] = F.dim
        out.update((f"{lay}.{k}", v.cpu()) for k, v in F.named_buffers())
    return out


def run_sparse_full(dev, seed: int, card: str) -> dict:
    """4x (b): SAGA at blocks of 4,096 rows on each layout of the full
    rcv1 shape of bench.py (:1361-1383), planted at ``seed``; then the
    plant built again at ``seed`` (the first freed), which must equal the
    first bit for bit, every field (``repeat``: the count of fields)."""
    t0 = time.perf_counter()
    prob = sparse_problem(dev, SPARSE_FULL, seed)
    first = plant_fields(prob)
    out = sparse_saga(prob, SPARSE_FULL["B"], seed, card)
    del prob
    torch.cuda.empty_cache()
    second = plant_fields(sparse_problem(dev, SPARSE_FULL, seed))
    torch.cuda.empty_cache()
    differ = [k for k, v in first.items()
              if not (torch.equal(v, second[k]) if torch.is_tensor(v)
                      else v == second[k])]
    if differ or first.keys() != second.keys():
        raise AssertionError(f"two sparse plants at seed {seed} differ in "
                             f"{differ}: f* {first['f_star']!r} and "
                             f"{second['f_star']!r}")
    out["repeat"] = len(first)
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
PD_PROFILE_STEPS = 8
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


def pd_problem(dev, seed: int, three: bool) -> dict:
    """A leg's planted problem on the card: the optimum's host plant
    (``pp``), the rows and offsets from pd_plant, the oracle and the
    terms g, h = λ‖D·‖₁, K, and the plant's seconds."""
    import numpy as np

    from ciao_tpu_torch import FirstDifference, LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils import (
        make_fused_lasso_planted, make_three_term_planted,
    )

    S = PD_DEEP
    n_ = S["n"]
    make = make_three_term_planted if three else make_fused_lasso_planted
    pp = make(N=8, n=n_, jumps=S["jumps"], seed=0)
    Dt_v = np.zeros(n_)
    Dt_v[:-1] -= pp.v_star
    Dt_v[1:] += pp.v_star
    corr = pp.u_star + Dt_v if three else Dt_v
    t0 = time.perf_counter()
    A, b, y = pd_plant(dev, seed + int(three), pp.x_star, corr)
    torch.cuda.synchronize()
    lam = torch.tensor(pp.lam2 if three else pp.lam, device=dev)
    return dict(pp=pp, A=A, b=b, y=y, F=LeastSquaresRows(A, b, float(S["N"])),
                g=NormL1(torch.tensor(pp.lam1, device=dev)) if three else None,
                h=NormL1(lam), K=FirstDifference(),
                plant_s=time.perf_counter() - t0)


def pd_rel(P: dict, x, three: bool) -> tuple:
    """(rel, jump set recovered, planted zeros exact or None) of a leg's
    solution x, rel from quad_gap as bench.py:1205-1212 and :1246-1254
    compute it."""
    import numpy as np

    pp = P["pp"]
    x64 = x.double().cpu().numpy()
    gap = quad_gap(P["A"], P["y"], x64 - pp.x_star, PD_DEEP["chunk"])
    tv = np.sum(np.abs(np.diff(x64))) - np.sum(np.abs(np.diff(pp.x_star)))
    if three:
        ns = (pp.lam1 * (np.sum(np.abs(x64)) - np.sum(np.abs(pp.x_star)))
              + pp.lam2 * tv)
        f_star = (0.5 + pp.lam1 * np.sum(np.abs(pp.x_star))
                  + pp.lam2 * np.sum(np.abs(np.diff(pp.x_star))))
    else:
        ns = pp.lam * tv
        f_star = 0.5 + pp.lam * np.sum(np.abs(np.diff(pp.x_star)))
    jumps_ok = bool(np.array_equal(np.nonzero(np.diff(x64))[0],
                                   np.nonzero(np.diff(pp.x_star))[0]))
    zeros = bool(np.all(x64[pp.x_star == 0] == 0.0)) if three else None
    return (gap + ns) / f_star, jumps_ok, zeros


def run_pd_leg(dev, seed: int, three: bool, card: str) -> dict:
    """One leg of 4y: the plant on the card, deep_solve_pd on it with its
    seconds split into the Condat-Vũ rounds and the refinement (each timed
    by wrapping the module's function, with a synchronize either side),
    rel (pd_rel), and a profiled window of PD_PROFILE_STEPS compensated
    steps (ms a step, idle share, device events a step)."""
    from ciao_tpu_torch import CondatVu, deep_solve_pd
    from ciao_tpu_torch.solvers import deep_pd

    S = PD_DEEP
    N_, n_ = S["N"], S["n"]
    P = pd_problem(dev, seed, three)
    A, F, g, h, K = P["A"], P["F"], P["g"], P["h"], P["K"]
    plant_s = P["plant_s"]

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

    rel, jumps_ok, zeros = pd_rel(P, x, three)
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
    del A, F, P
    return out


# 4z: complex rows and iterates (no kernel by design: the JAX package sends
# a complex iterate past every kernel gate, with no fallback warning): a
# planted complex64 Lasso of the headline's 262,144 x 1,024 (2 GiB of rows)
# built on the card from a torch.Generator seeded from --seed; FISTA to rel
# 1e-3 at the spectral step; a short run of each family through its
# facade's iterator (COMPLEX_RUNS: facade steps), a profiled window each,
# and one step of SAGA and of Point-SAGA held to complex128 on the drawn
# block; then CustomOracle and Precompose on the card (WELSCH, PRECOMPOSE)
COMPLEX = dict(N=262_144, n=1_024, p=16, B=4_096, lam=1.0, rho=10.0,
               power_iters=30, chunk=8, max_chunks=64, rel=1e-3)
COMPLEX_RUNS = dict(saga=16, svrg=1, finito=16, katyusha=1, sarah=1,
                    lsvrg=16, point_saga=16, panoc=4, condat_vu=16)
COMPLEX_TV = 0.05  # Condat-Vũ's h = 0.05‖D·‖₁, as 4w
# tests/test_nonconvex.py's Welsch problem; SARAH's 200 outer steps cut to
# 80, where its gradient already sits at the f32 floor (‖Σ∇f_i‖/N 8.99e-6
# at 80 and 200, 1.59e-5 at 60; bar 1e-4; the port on the CPU)
WELSCH = dict(N=256, n=16, frac=0.2, sigma=1.0, sarah_maxit=80)
PRECOMPOSE = dict(N=4_096, n=64)


def c_adjoint(A, u):
    """Aᴴu = Σ_i conj(a_i)·u_i in one read of A."""
    return torch.conj_physical(u.conj() @ A)


def complex_plant(dev, seed: int) -> dict:
    """make_lasso's KKT recipe (well-conditioned) with complex draws on the
    card: y a complex Gaussian unit vector, C with real and imaginary
    parts U(−1, 1), column scales α_j = min(λ/|C_jᴴy|, the largest
    on-support scale) so that |A_jᴴy| = λ on the p columns of largest
    |C_jᴴy| and ≤ λ off them, x*_j = u_j·ρ/√p along the phase of A_jᴴy,
    b = Ax* + y. Then r* = −y and Aᴴy ∈ λ∂‖x*‖₁: x* is optimal, f* =
    cost(x*) exact up to complex64 rounding. Checks the KKT conditions and
    that the rows and x* are truly complex."""
    S = COMPLEX
    N_, n_, p_, lam = S["N"], S["n"], S["p"], S["lam"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(N_, dtype=torch.complex64, generator=gen, device=dev)
    y = y / torch.linalg.vector_norm(y)
    A = torch.empty(N_, n_, dtype=torch.complex64, device=dev)
    torch.view_as_real(A).uniform_(-1.0, 1.0, generator=gen)
    cty = c_adjoint(A, y)
    mag = cty.abs()
    order = torch.argsort(mag, descending=True)
    sup = order[:p_]
    alpha = torch.clamp(lam / mag, max=float(lam / mag[order[p_ - 1]]))
    A.mul_(alpha)
    u = torch.rand(p_, generator=gen, device=dev)
    x = torch.zeros(n_, dtype=torch.complex64, device=dev)
    x[sup] = (u * (S["rho"] / math.sqrt(p_))) * (cty[sup] / mag[sup])
    b = A @ x + y
    L = N_ * torch.linalg.vector_norm(A, dim=1) ** 2
    P = dict(A=A, b=b, x=x, L=L, lam=lam, sup=sup)
    P["f_star"] = complex_cost(P, x)
    d = c_adjoint(A, y)
    on = float((d[sup] - lam * x[sup] / x[sup].abs()).abs().max())
    off = torch.ones(n_, dtype=torch.bool, device=dev)
    off[sup] = False
    off_max = float(d[off].abs().max())
    imag = float(A.imag.abs().max()), float(x[sup].imag.abs().max())
    if not (on <= 1e-3 * lam and off_max <= lam * (1 + 1e-3)
            and min(imag) > 0.01):
        raise AssertionError(f"complex plant: KKT on the support off by {on},"
                             f" off-support max {off_max}, largest imaginary "
                             f"parts {imag}")
    P["kkt"] = (on, off_max)
    return P


def complex_cost(P, x, lam=None, tv: float = 0.0) -> float:
    """½‖Ax − b‖² + λ‖x‖₁ (+ tv·‖Dx‖₁) with the product in complex64 and the
    sums in f64; ``lam`` defaults to the plant's."""
    r = P["A"] @ x - P["b"]
    lam = P["lam"] if lam is None else lam
    xd = x.to(torch.complex128)
    return (0.5 * float(torch.sum(r.real.double() ** 2
                                  + r.imag.double() ** 2))
            + lam * float(xd.abs().sum())
            + tv * float((xd[1:] - xd[:-1]).abs().sum()))


def complex_power(P, dev, seed: int) -> float:
    """λ̂ of AᴴA by COMPLEX['power_iters'] power steps (two reads of A each)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    v = torch.randn(P["A"].shape[1], dtype=torch.complex64, generator=gen,
                    device=dev)
    v = v / torch.linalg.vector_norm(v)
    lam_hat = 0.0
    for _ in range(COMPLEX["power_iters"]):
        w = c_adjoint(P["A"], P["A"] @ v)
        lam_hat = float(torch.linalg.vector_norm(w))
        v = w / lam_hat
    return lam_hat


def complex_tf32(P) -> dict:
    """Whether TF32 changes complex64 products on this card: an (8,192 x
    1,024) x (1,024 x 8) complex64 product with allow_tf32 off and on,
    against the complex128 product; and whether the plain paths' check
    (``runtime.require_exact_f32_matmul``) refuses TF32 whatever the
    dtype. The flag is restored."""
    from ciao_tpu_torch import runtime

    A = P["A"][:8_192]
    V = P["A"][:A.shape[1], :8].clone()
    exact = (A.to(torch.complex128) @ V.to(torch.complex128))
    prev = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            got = (A @ V).to(torch.complex128)
            out[flag] = float((got - exact).abs().max()
                              / exact.abs().max())
        try:
            runtime.require_exact_f32_matmul(A.device, "4z")
            refused = False
        except RuntimeError:
            refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    runtime.require_exact_f32_matmul(A.device, "4z")
    if not refused:
        raise AssertionError("require_exact_f32_matmul let TF32 through")
    return dict(off=out[False], on=out[True], refused=refused)


def complex_oracle(P):
    """The plant's rows as the port's oracle, scale N (the objective is
    ½‖Ax − b‖² + λ‖x‖₁)."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    return LeastSquaresRows(P["A"], P["b"], float(COMPLEX["N"]))


def complex_fista(P, gamma: float, card: str) -> dict:
    """The FISTA facade at γ = ``gamma`` from x = 0, in chunks of
    COMPLEX['chunk'] steps until rel = (cost − f*)/f* ≤ COMPLEX['rel']:
    seconds (steps only, by the host clock, after a warm-up chunk), steps
    (one gradient each: two reads of A on the stepwise path) and rel."""
    from ciao_tpu_torch import FISTA
    from ciao_tpu_torch.prox import NormL1

    S = COMPLEX
    dev = P["A"].device
    F = complex_oracle(P)
    g = NormL1(torch.tensor(S["lam"], device=dev))
    it = FISTA(gamma=gamma).iterator(
        torch.zeros(S["n"], dtype=torch.complex64, device=dev), F=F, g=g,
        N=S["N"])
    st = next(iter(it))
    step = it._step_fn
    warm = st
    for _ in range(S["chunk"]):  # the first products' one-time set-up
        warm = step(warm)
    del warm
    secs, steps, rel = 0.0, 0, math.inf
    for _ in range(S["max_chunks"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(S["chunk"]):
            st = step(st)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        steps += S["chunk"]
        rel = (complex_cost(P, st.solution) - P["f_star"]) / P["f_star"]
        if rel <= S["rel"]:
            break
    if not rel <= S["rel"]:
        raise AssertionError(f"complex FISTA: rel {rel} after {steps} steps")
    if st.solution.dtype != torch.complex64:
        raise AssertionError(f"complex FISTA: dtype {st.solution.dtype}")
    log(f"  complex FISTA to rel {S['rel']:g}: {steps} steps ({2 * steps} "
        f"reads of the 2 GiB rows), {secs:.3f} s ({secs * 1e3 / steps:.4f} "
        f"ms/step), rel {rel:.3e} [{card}]")
    return dict(s=secs, steps=steps, rel=rel)


# complex64 step vs complex128, as a share of how far the same step moves
# with the conjugates left out
COMPLEX_STEP_TOL = 1e-2


def complex_step_want(P, name: str, st, conj: bool = True):
    """One block step of SAGA or Point-SAGA from ``st``, recomputed in
    complex128 on the block that (seed, it) draws, from the textbook
    formulas with the conjugates written out (``conj=False`` drops them,
    as a slip in the port's row products would): SAGA's direction from the
    block's new and stored gradients conj(a_i)·scale·(a_i·z − b_i) and the
    complex soft-threshold; Point-SAGA's mean of the closed-form prox
    points z_j = u_j − γ·conj(a_j)·θ_j, u_j = v + γ·conj(a_j)·c_j. Returns
    (the new iterate, the old one)."""
    from ciao_tpu_torch.solvers.saga import block_starts

    S = COMPLEX
    N_, B_ = S["N"], S["B"]
    c128 = torch.complex128
    dev = P["A"].device
    j0 = int(block_starts(st.seed, st.it, 1, N_ // B_, B_, dev)[0])
    A_B = P["A"][j0:j0 + B_].to(c128)
    b_B = P["b"][j0:j0 + B_].to(c128)
    Ac = A_B.conj() if conj else A_B
    scale = float(N_)
    gamma = float(st.gamma)
    if name == "saga":
        z = st.z.to(c128)
        r = scale * (A_B @ z - b_B)
        old = st.s[j0:j0 + B_].to(c128)
        g_old = Ac * old[:, None] if old.dim() == 1 else old
        diff = torch.mean(Ac * r[:, None] - g_old, dim=0)
        w = z - gamma * (diff + st.av.to(c128))
        mag = w.abs()
        thr = gamma * S["lam"]
        new = torch.where(mag > thr, w * (1.0 - thr / mag.clamp(min=thr)),
                          torch.zeros_like(w))
        return new, z
    x = st.x.to(c128)
    v = x - gamma * st.av.to(c128)
    c = st.c[j0:j0 + B_].to(c128)
    aa = torch.sum(A_B * Ac, dim=1)  # |a_j|² (Σ a_j² without conj)
    theta = scale * (A_B @ v + gamma * c * aa - b_B) / (
        1.0 + gamma * scale * aa)
    new = v + (gamma / B_) * ((c - theta) @ Ac)
    return new, x


def complex_step_check(P, name: str, st, step, card: str) -> dict:
    """Holds one facade step of SAGA or Point-SAGA from ``st`` against
    :func:`complex_step_want`: the error must be under COMPLEX_STEP_TOL
    of the distance between that step and the same step without the
    conjugates, so a slip in the port's conjugates fails it. Both are
    printed also as shares of the step's length."""
    want, prev = complex_step_want(P, name, st)
    slip, _ = complex_step_want(P, name, st, conj=False)
    got = step(st).solution.to(torch.complex128)
    length = float((want - prev).abs().max())
    err = float((got - want).abs().max())
    slip_d = float((slip - want).abs().max())
    log(f"  complex {name} step against complex128 on the drawn block: "
        f"error {err:.3e}, {err / length:.3e} of the step's length; the "
        f"same step without conjugates {slip_d:.3e} ({slip_d / length:.3e}"
        f" of it); error/slip {err / slip_d:.3e} (tolerance "
        f"{COMPLEX_STEP_TOL:g}) [{card}]")
    if not err < COMPLEX_STEP_TOL * slip_d:
        raise AssertionError(f"complex {name} step: error {err}, "
                             f"conjugate slip {slip_d}")
    return dict(err=err / length, slip=slip_d / length,
                ratio=err / slip_d)


def complex_runs(P, lam_hat: float, ceil: float, card: str) -> dict:
    """A short run of each family (COMPLEX_RUNS facade steps) through its
    facade's iterator from x = 0 on the plant: the cost falls (Point-SAGA's
    smooth part; Condat-Vũ's with its TV term), ms a step by the host
    clock and a profiled window (idle share, device launches a step), and
    the bound: the rows the step must read (B a block step, N an anchor or
    gradient pass, as this run's draws need them) in complex64 at the
    card's measured read ceiling ``ceil``."""
    from ciao_tpu_torch import (
        SAGA, SARAH, SVRG, CondatVu, Finito, Katyusha, LSVRG, PANOC,
        PointSAGA,
    )
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.lsvrg import draw_coins

    S = COMPLEX
    N_, n_, B_ = S["N"], S["n"], S["B"]
    dev = P["A"].device
    F = complex_oracle(P)
    L = P["L"]
    Lmax = float(L.max())
    g = NormL1(torch.tensor(S["lam"], device=dev))
    x0 = torch.zeros(n_, dtype=torch.complex64, device=dev)
    blk = dict(batch=B_, block_sampling=True)
    kw = dict(F=F, g=g, L=L, N=N_)
    facades = {
        "saga": (SAGA(**blk), kw, B_),
        "svrg": (SVRG(m=N_ // B_, gamma=1.0 / (3.0 * Lmax), **blk),
                 dict(F=F, g=g, N=N_), N_ + N_),
        "finito": (Finito(minibatch=(True, B_), sweeping=3), kw, B_),
        "katyusha": (Katyusha(**blk), kw, N_ + 2 * N_),
        "sarah": (SARAH(**blk), kw, N_ + N_),
        "lsvrg": (LSVRG(**blk), kw, None),
        "point_saga": (PointSAGA(**blk), dict(F=F, L=L, N=N_), B_),
        "panoc": (PANOC(gamma=0.95 / lam_hat), kw, None),
        "condat_vu": (CondatVu(), dict(kw, h=NormL1(COMPLEX_TV),
                                       K=FirstDifference()), N_),
    }
    out = {}
    for name, (solver, args, rows) in facades.items():
        steps = COMPLEX_RUNS[name]
        it = solver.iterator(x0, **args)
        st0 = next(iter(it))
        step = it._step_fn

        def run(st0=st0, step=step, steps=steps):
            st = st0
            for _ in range(steps):
                st = step(st)
            return st

        lam = 0.0 if name == "point_saga" else S["lam"]
        tv = COMPLEX_TV if name == "condat_vu" else 0.0
        with FBECount() as fbe:
            prof = profile_steps(f"complex {name}, N={N_} n={n_} B={B_}", run,
                                 steps, card, PD_GROUPS)
            evals = fbe.evals
        st = run()
        check = (complex_step_check(P, name, step(st0), step, card)
                 if name in ("saga", "point_saga") else None)
        if name == "lsvrg":
            flips = int(draw_coins(st0.seed, st0.it, steps, st0.p).sum())
            rows = B_ + flips * N_ / steps
        elif name == "panoc":
            rows = N_ * evals / prof["runs"] / steps
        c0 = complex_cost(P, st0.solution, lam, tv)
        c1 = complex_cost(P, st.solution, lam, tv)
        if st.solution.dtype != torch.complex64:
            raise AssertionError(f"complex {name}: dtype "
                                 f"{st.solution.dtype}")
        if not (math.isfinite(c1) and c1 < c0):
            raise AssertionError(f"complex {name}: cost {c0} -> {c1}")
        bound_ms = rows * n_ * 8 / ceil * 1e3
        out[name] = dict(ms=prof["step"], idle=1.0 - prof["busy"]
                         / prof["step"], launches=sum(prof["calls"].values())
                         / steps, bound_ms=bound_ms, rows=rows, c0=c0, c1=c1,
                         steps=steps, check=check)
        log(f"  complex {name}: {steps} step(s), cost {c0:.6e} -> {c1:.6e}; "
            f"{prof['step']:.4f} ms/step, {out[name]['launches']:.1f} device "
            f"launches a step, idle {out[name]['idle']:.3f}; bound "
            f"{bound_ms:.4f} ms/step ({rows:.0f} rows of complex64 at "
            f"{ceil / 1e9:.1f} GB/s) [{card}]")
    return out


def _welsch_problem(dev):
    """tests/test_nonconvex.py's planted signal with 20 % gross outliers
    (numpy's generator, seed 0), on the card."""
    import numpy as np

    S = WELSCH
    rng = np.random.default_rng(0)
    A = rng.standard_normal((S["N"], S["n"])).astype(np.float32)
    x_true = rng.standard_normal(S["n"]).astype(np.float32)
    b = A @ x_true + 0.01 * rng.standard_normal(S["N"]).astype(np.float32)
    out = rng.choice(S["N"], size=int(S["frac"] * S["N"]), replace=False)
    b[out] += 50.0 * rng.standard_normal(out.size).astype(np.float32)
    x0 = np.linalg.lstsq(A, np.clip(b, -5, 5), rcond=None)[0]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    return t(A), t(b), x_true, t(x0), (A * A).sum(axis=1), np.linalg.lstsq(
        A, b, rcond=None)[0]


def run_compose(dev, card: str) -> dict:
    """CustomOracle and Precompose on the card: the Welsch loss of
    tests/test_nonconvex.py through SARAH (WELSCH["sarah_maxit"] outer
    steps of 32 blocks of 8) and PANOC (200 steps) from the least-squares warm start, held to
    JAX's bars (max |x − x_true| < 0.05, least squares 5x farther off,
    ‖Σ∇f_i‖/N < 1e-4 and 1e-5); Precompose of a scalar logistic loss over
    a_iᵀ rows against LogisticRows on PRECOMPOSE's rows (values and
    gradients of every row, and their sum, within 1e-5 of the largest)."""
    import numpy as np

    from ciao_tpu_torch import (
        PANOC, SARAH, CustomOracle, Precompose, runtime,
    )
    from ciao_tpu_torch.oracles import LogisticRows

    sigma = WELSCH["sigma"]
    A, b, x_true, x0, L, x_ls = _welsch_problem(dev)

    def welsch(x, d):
        r = torch.dot(d["a"], x) - d["b"]
        return 0.5 * sigma ** 2 * (1.0 - torch.exp(-(r * r) / sigma ** 2))

    F = CustomOracle({"a": A, "b": b}, fun=welsch)
    N_ = WELSCH["N"]
    out = {}
    for name, solver, gbar in (
            ("SARAH", SARAH(maxit=WELSCH["sarah_maxit"], m=32, batch=8,
                            block_sampling=True), 1e-4),
            ("PANOC", PANOC(maxit=200), 1e-5)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # no kernel takes a CustomOracle (JAX's gate warns of it as well)
        with runtime.expected_fallback():
            x, _ = solver(x0, F=F, L=L, N=N_)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        err = float(np.max(np.abs(x.double().cpu().numpy() - x_true)))
        gn = float(torch.linalg.vector_norm(F.grad_sum_all(x))) / N_
        ls_err = float(np.max(np.abs(x_ls - x_true)))
        log(f"  CustomOracle Welsch {name} on the card: max |x − x_true| "
            f"{err:.3e} (least squares {ls_err:.3e}), ‖Σ∇f_i‖/N {gn:.3e}, "
            f"{secs:.2f} s [{card}]")
        if not (x.device == A.device and err < 0.05 and ls_err > 5 * err
                and gn < gbar):
            raise AssertionError(f"CustomOracle Welsch {name}: err {err}, "
                                 f"least squares {ls_err}, gradient {gn}")
        out[name] = dict(err=err, gn=gn, s=secs)
    gen = torch.Generator(device=dev).manual_seed(11)
    X = torch.randn(PRECOMPOSE["N"], PRECOMPOSE["n"], generator=gen,
                    device=dev)
    y = torch.where(torch.rand(PRECOMPOSE["N"], generator=gen, device=dev)
                    > 0.5, 1.0, -1.0)
    pre = Precompose(CustomOracle(
        {"y": y}, fun=lambda v, d: torch.nn.functional.softplus(
            -d["y"] * v[0])), X[:, None, :])
    folded = LogisticRows(X, y)
    x = torch.randn(PRECOMPOSE["n"], generator=gen, device=dev)
    idx = torch.arange(PRECOMPOSE["N"], device=dev)
    err = 0.0
    for got, want in zip((*pre.value_and_grad_batch(x, idx),
                          pre.grad_sum_all(x)),
                         (*folded.value_and_grad_batch(x, idx),
                          folded.grad_sum_all(x))):
        err = max(err, float((got - want).abs().max() / want.abs().max()))
    log(f"  Precompose logistic == LogisticRows on the card: max rel err "
        f"{err:.3e} over {PRECOMPOSE['N']} x {PRECOMPOSE['n']} [{card}]")
    if not err < 1e-5:
        raise AssertionError(f"Precompose logistic: rel err {err}")
    out["precompose_err"] = err
    return out


def run_complex(dev, seed: int, ceil: float, card: str) -> dict:
    """Phase 4z; returns its numbers."""
    t0 = time.perf_counter()
    P = complex_plant(dev, seed)
    torch.cuda.synchronize()
    plant_s = time.perf_counter() - t0
    log(f"  complex plant {COMPLEX['N']} x {COMPLEX['n']} complex64 "
        f"({P['A'].numel() * 8 / 2**30:.0f} GiB) built on the card in "
        f"{plant_s:.2f} s: f* {P['f_star']:.9f}, KKT on the support off by "
        f"{P['kkt'][0]:.2e}, off-support max {P['kkt'][1]:.6f} (λ = "
        f"{P['lam']:g}) [{card}]")
    tf32 = complex_tf32(P)
    log(f"  TF32 on complex64 products: rel err {tf32['off']:.3e} with "
        f"allow_tf32 off, {tf32['on']:.3e} on; require_exact_f32_matmul "
        f"refuses TF32 {tf32['refused']} [{card}]")
    lam_hat = complex_power(P, dev, seed)
    fista = complex_fista(P, 0.95 / lam_hat, card)
    runs = complex_runs(P, lam_hat, ceil, card)
    del P
    torch.cuda.empty_cache()
    compose = run_compose(dev, card)
    return dict(plant_s=plant_s, tf32=tf32, lam_hat=lam_hat, fista=fista,
                runs=runs, compose=compose)


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


# 4ck: checkpoints at full width. The headline coefficient run through
# saga_run split at a launch boundary (LAUNCH_STEPS), so that both runs issue
# the same kernel #3 launches; SAGA's 1 GiB full table at the headline
# through the iterator (kernel #1 a step), saved, loaded, and saved in the
# background while CKPT_ASYNC_STEPS more steps run; a rebase of an int8-stage
# state; every facade's iterator on the facades' planted Lasso stopped after
# CKPT_STOP states, saved, loaded onto the card and resumed to CKPT_STATES,
# bit for bit the straight run; one complex64 SAGA state on 4z's plant, and
# one sparse-route SAGA state, held to CKPT_SPARSE_TOL of its largest entry
# (its scatter-adds add with atomics, so its bits do not repeat)
CKPT_ASYNC_STEPS = 64
CKPT_STOP, CKPT_STATES = 6, 12
CKPT_SPARSE_TOL = 1e-5
REBASE_TOL = 1e-6


def ckpt_leaves(node, path="state"):
    """(path, value) of every tensor and scalar of a state."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, v in zip(node._fields, node):
            yield from ckpt_leaves(v, f"{path}.{f}")
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            yield from ckpt_leaves(v, f"{path}[{i}]")
    else:
        yield path, node


def ckpt_compare(a, b, tag: str, tol: float = 0.0) -> float:
    """Raise unless two states hold the same fields, each tensor on one
    device with one dtype and equal bit for bit (``tol`` = 0) or within
    ``tol`` of its largest entry; returns the largest such error."""
    la, lb = list(ckpt_leaves(a)), list(ckpt_leaves(b))
    if type(a) is not type(b) or [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError(f"{tag}: the states' fields differ")
    worst = 0.0
    for (p, x), (_, y) in zip(la, lb):
        if not torch.is_tensor(x):
            if x != y:
                raise AssertionError(f"{tag}: {p} {x!r} != {y!r}")
            continue
        if (x.dtype, x.shape, x.device) != (y.dtype, y.shape, y.device):
            raise AssertionError(f"{tag}: {p} is {x.dtype} {tuple(x.shape)} "
                                 f"on {x.device} and {y.dtype} "
                                 f"{tuple(y.shape)} on {y.device}")
        if tol == 0.0:
            if not torch.equal(x, y):
                raise AssertionError(f"{tag}: {p} differs")
            continue
        err = float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"{tag}: {p} off by {err:.3e} of its "
                                 f"largest entry")
    return worst


def state_bytes(state) -> int:
    return sum(v.numel() * v.element_size() for _, v in ckpt_leaves(state)
               if torch.is_tensor(v))


def split_resume(make_iter, path: str, dev, tol: float = 0.0) -> dict:
    """CKPT_STATES states of ``make_iter()`` straight; CKPT_STOP states, a
    save, a load onto ``dev`` and the resume to CKPT_STATES, held to the
    straight run (bit for bit at ``tol`` = 0); the kernels the resume
    launched, counted from 0."""
    from ciao_tpu_torch import checkpoint
    from ciao_tpu_torch.solvers import loop, take

    straight = loop(take(iter(make_iter()), CKPT_STATES))
    mid = loop(take(iter(make_iter()), CKPT_STOP))
    checkpoint.save(path, mid)
    back = checkpoint.load(path, device=dev)
    ckpt_compare(back, mid, "load")
    del mid
    reset_counts()
    resumed = loop(take(checkpoint.resume_iterator(make_iter(), back),
                        CKPT_STATES - CKPT_STOP + 1))
    torch.cuda.synchronize()
    c = counts()
    err = ckpt_compare(resumed, straight, "resume", tol)
    return dict(launches={k: v for k, v in c.items() if v}, err=err)


def ckpt_facades(L_max: float):
    """(name, solver, keywords) of every facade of 4ck on the facades'
    planted Lasso."""
    from ciao_tpu_torch import (
        FISTA, LSVRG, PANOC, SAG, SAGA, SARAH, SSNM, SVRG, CondatVu,
        DavisYin, Finito, FirstDifference, IndBox, Katyusha, LKatyusha,
        NormL1, PointSAGA, Proshi, ZeroFPR,
    )

    Bf = FACADE["batch"]
    bs = dict(block_sampling=True, batch=Bf)
    gam = 1.0 / (3.0 * L_max)
    return [
        ("SAGA", SAGA(**bs), {}),
        ("SAG", SAG(**bs), {}),
        ("SVRG", SVRG(m=FACADE["N"] // Bf, gamma=gam, **bs), {}),
        ("SVRG++", SVRG(m=1, gamma=gam, plus=True, **bs), {}),
        ("FISTA", FISTA(), {}),
        ("Finito", Finito(sweeping=3, minibatch=(True, Bf)), {}),
        ("Finito full table", Finito(sweeping=3, minibatch=(True, Bf),
                                     table="full"), {}),
        ("LFinito", Finito(sweeping=3, minibatch=(True, Bf), LFinito=True),
         {}),
        ("Finito adaptive", Finito(adaptive=True), {}),
        ("ProShI", Proshi(sweeping=2, minibatch=(True, PROSHI["B"])),
         dict(g=IndBox(-float("inf"), PROSHI["hi"]))),
        ("Katyusha", Katyusha(**bs), {}),
        ("SARAH", SARAH(**bs), {}),
        ("L-SVRG", LSVRG(**bs), {}),
        ("L-Katyusha", LKatyusha(**bs), {}),
        ("SSNM", SSNM(batch=Bf), {}),
        ("Point-SAGA", PointSAGA(**bs), dict(g=None)),
        ("PANOC", PANOC(), {}),
        ("ZeroFPR", ZeroFPR(), {}),
        ("Davis-Yin", DavisYin(), dict(h=IndBox(-1.0, 1.0))),
        ("Condat-Vu", CondatVu(), dict(h=NormL1(0.05), K=FirstDifference())),
    ]


def ckpt_headline(gen, dev, tmp: str, card: str) -> dict:
    """4ck (a): 2·LAUNCH_STEPS steps of the headline's coefficient SAGA
    through saga_run straight, and LAUNCH_STEPS, save, load and
    LAUNCH_STEPS more: z, av and s bit for bit, each run on kernel #3's
    launches of LAUNCH_STEPS."""
    from ciao_tpu_torch import checkpoint
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.saga import (
        LAUNCH_STEPS, SAGACfg, saga_init, saga_run,
    )

    F, gamma, _ = lasso(gen, dev, N, n, "f32")
    g = NormL1(torch.tensor(0.1, device=dev))
    cfg = SAGACfg(N=N, sag=False, batch=B, block=True, coeff=True,
                  fused=True)
    st0 = saga_init(F, g, torch.zeros(n, device=dev), gamma, 0, cfg)
    reset_counts()
    straight = saga_run(F, g, st0, cfg, 2 * LAUNCH_STEPS)
    first = saga_run(F, g, st0, cfg, LAUNCH_STEPS)
    checkpoint.save(f"{tmp}/headline.pt", first)
    back = checkpoint.load(f"{tmp}/headline.pt", device=dev)
    resumed = saga_run(F, g, back, cfg, LAUNCH_STEPS)
    torch.cuda.synchronize()
    c = counts()
    if c["saga_coeff_multistep"] != 4 or sum(c.values()) != 4:
        raise AssertionError(f"4ck headline: {c}, not two kernel #3 "
                             f"launches a run")
    ckpt_compare(resumed, straight, "4ck headline")
    log(f"  4ck headline SAGA {N} x {n} f32, B={B}: {2 * LAUNCH_STEPS} "
        f"steps straight == {LAUNCH_STEPS} + save + load + {LAUNCH_STEPS} "
        f"bit for bit (z, av, s), each run 2 kernel #3 launches [{card}]")
    return c


def async_steps(path: str, state, stream) -> dict:
    """``save_async(path, state)``, then CKPT_ASYNC_STEPS steps of
    ``stream`` while the write runs: ms a step, whether the write was still
    running after them, seconds to the write's end; the file must equal
    ``state`` bit for bit. Returns the numbers and the last state."""
    from ciao_tpu_torch import checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr = checkpoint.save_async(path, state)
    ret_s = time.perf_counter() - t0
    for _ in range(CKPT_ASYNC_STEPS):
        last = next(stream)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / CKPT_ASYNC_STEPS
    in_flight = not mgr.done()
    mgr.wait_until_finished()
    done_s = time.perf_counter() - t0
    ckpt_compare(checkpoint.load(path, device=state.z.device), state,
                 "4ck async file against its snapshot")
    return dict(ret_s=ret_s, ms=ms, in_flight=in_flight, done_s=done_s,
                last=last)


def ckpt_full_table(gen, dev, tmp: str, card: str) -> dict:
    """4ck (b): SAGA's full table at the headline (1 GiB of f32) through the
    iterator: ``save`` and ``load`` timed; ``save_async``, then
    CKPT_ASYNC_STEPS steps while the write runs (the process's first
    write: its staging buffers and snapshot allocated cold), the file equal to the snapshot and those
    steps equal to the straight run, bit for bit; the resume from the file
    equal to the straight run bit for bit, CKPT_ASYNC_STEPS steps of it
    timed with no write, then as many beside a second write (the cache
    warm)."""
    from ciao_tpu_torch import SAGA, checkpoint
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import loop, take

    F, _, L = lasso(gen, dev, N, n, "f32")
    solver = SAGA(table="full", block_sampling=True, batch=B)

    def make_iter():
        return solver.iterator(torch.zeros(n, device=dev), F=F,
                               g=NormL1(torch.tensor(0.1, device=dev)),
                               L=L)

    stop, total = 17, 17 + CKPT_ASYNC_STEPS
    straight = loop(take(iter(make_iter()), total))
    stream = iter(make_iter())
    mid = loop(take(stream, stop))
    nbytes = state_bytes(mid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(f"{tmp}/full.pt", mid)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = checkpoint.load(f"{tmp}/full.pt", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ckpt_compare(back, mid, "4ck full table load")
    del back
    reset_counts()
    cold = async_steps(f"{tmp}/cold.pt", mid, stream)
    ckpt_compare(cold.pop("last"), straight,
                 "4ck full table, steps beside the write")
    snap = checkpoint.load(f"{tmp}/cold.pt", device=dev)
    del mid, stream
    resume = checkpoint.resume_iterator(make_iter(), snap)
    next(resume)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CKPT_ASYNC_STEPS):
        state = next(resume)
    torch.cuda.synchronize()
    without_ms = (time.perf_counter() - t0) * 1e3 / CKPT_ASYNC_STEPS
    ckpt_compare(state, straight, "4ck full table resume")
    del snap, straight
    warm = async_steps(f"{tmp}/warm.pt", state, resume)
    del warm["last"], state, resume
    c = counts()
    if c["saga_block_update"] != 3 * CKPT_ASYNC_STEPS or sum(
            c.values()) != c["saga_block_update"]:
        raise AssertionError(f"4ck full table: {c}, not kernel #1 a step")
    out = dict(bytes=nbytes, save_s=save_s, load_s=load_s, cold=cold,
               warm=warm, without_ms=without_ms, launches=c)
    log(f"  4ck SAGA full table {N} x {n} f32 through the iterator "
        f"({nbytes / 2**30:.3f} GiB state): save {save_s:.3f} s "
        f"({nbytes / save_s / 1e9:.2f} GB/s), load onto the card "
        f"{load_s:.3f} s ({nbytes / load_s / 1e9:.2f} GB/s); "
        + "; ".join(
            f"save_async ({k}) returned in "
            f"{v['ret_s'] * 1e3:.1f} ms, {CKPT_ASYNC_STEPS} steps beside the "
            f"write {v['ms']:.4f} ms/step (write still running after them: "
            f"{v['in_flight']}), the write done {v['done_s']:.3f} s after "
            f"the call" for k, v in (("cold", cold), ("warm", warm)))
        + f"; {CKPT_ASYNC_STEPS} steps with no write {without_ms:.4f} "
        f"ms/step; each file == its snapshot and the steps and the resume "
        f"== the straight run, bit for bit; kernel #1 "
        f"{c['saga_block_update']} launches [{card}]")
    return out


def ckpt_rebase(dev, fprob, fF, card: str) -> float:
    """4ck (c): an int8-stage SAGA state resumed under the f32 rows with
    ``rebase=True``: its first av equals Σ s_i·a_i / N from one f32 pass of
    kernel #6 over its table (c_i = s_i: least-squares mode at scale 1,
    z = 0, offsets −s) to REBASE_TOL of its largest entry."""
    from ciao_tpu_torch import SAGA, checkpoint
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import loop, take

    solver = SAGA(block_sampling=True, batch=FACADE["batch"])
    x0 = torch.zeros(n, device=dev)
    g = NormL1(torch.tensor(fprob.lam, dtype=torch.float32, device=dev))
    st = loop(take(iter(solver.iterator(x0, F=fF.with_storage("int8"), g=g,
                                        L=fprob.L)), 30))
    first = next(checkpoint.resume_iterator(
        solver.iterator(x0, F=fF, g=g, L=fprob.L), st, rebase=True))
    rows, _ = fF.coeff_rows_data()
    _, gsum = fb.coeff_apply_all(
        rows, -st.s, torch.zeros(n, device=dev),
        torch.tensor([1.0, fb.MODE_LSQ, 0.0], device=dev))
    want = gsum / FACADE["N"]
    err = float((first.av - want).abs().max() / want.abs().max())
    moved = float((first.av - st.av).abs().max() / want.abs().max())
    log(f"  4ck rebase: an int8-stage SAGA state resumed under f32 rows, "
        f"first av off kernel #6's f32 pass over its table by {err:.3e} of "
        f"its largest entry (bar {REBASE_TOL:g}); the int8 av was off by "
        f"{moved:.3e} [{card}]")
    if not (err <= REBASE_TOL and moved > err):
        raise AssertionError(f"4ck rebase: av off by {err}, moved {moved}")
    return err


def ckpt_complex_and_sparse(dev, seed: int, tmp: str, card: str) -> dict:
    """4ck (e): one complex64 SAGA state on 4z's plant, bit for bit, and
    one SAGA state on the sparse route's ELL rows (4x (a)'s plant), held to
    CKPT_SPARSE_TOL."""
    from ciao_tpu_torch import SAGA, LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1

    out = {}
    P = complex_plant(dev, seed)
    F = LeastSquaresRows(P["A"], P["b"], float(COMPLEX["N"]))
    solver = SAGA(block_sampling=True, batch=COMPLEX["B"])
    out["complex64 SAGA"] = split_resume(
        lambda: solver.iterator(
            torch.zeros(COMPLEX["n"], dtype=torch.complex64, device=dev),
            F=F, g=NormL1(P["lam"]), L=P["L"]), f"{tmp}/complex.pt", dev)
    del P, F
    torch.cuda.empty_cache()
    prob = sparse_problem(dev, SPARSE, seed)
    solver = SAGA(block_sampling=True, batch=SPARSE["B"])
    out["sparse ELL SAGA"] = split_resume(
        lambda: solver.iterator(
            torch.zeros(SPARSE["n"], device=dev), F=prob.ell,
            g=NormL1(torch.tensor(prob.lam, device=dev)), L=prob.L),
        f"{tmp}/sparse.pt", dev, tol=CKPT_SPARSE_TOL)
    del prob
    torch.cuda.empty_cache()
    return out


def run_checkpoints(gen, dev, seed: int, card: str) -> dict:
    """Phase 4ck; returns its numbers."""
    import tempfile

    from ciao_tpu_torch.prox import NormL1

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ciao-ckpt-") as tmp:
        out = {"headline": ckpt_headline(gen, dev, tmp, card)}
        torch.cuda.empty_cache()
        out["full"] = ckpt_full_table(gen, dev, tmp, card)
        torch.cuda.empty_cache()
        fprob, fF = facade_problem(dev, seed)
        out["rebase"] = ckpt_rebase(dev, fprob, fF, card)
        g = NormL1(torch.tensor(fprob.lam, dtype=torch.float32,
                                device=dev))
        facades = {}
        for name, solver, extra in ckpt_facades(float(fprob.L.max())):
            kw = dict(F=fF, g=g, L=fprob.L, N=FACADE["N"])
            kw.update(extra)
            t0 = time.perf_counter()
            facades[name] = split_resume(
                lambda: solver.iterator(torch.zeros(n, device=dev), **kw),
                f"{tmp}/facade.pt", dev)
            facades[name]["s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        del fprob, fF
        torch.cuda.empty_cache()
        facades.update(ckpt_complex_and_sparse(dev, seed, tmp, card))
    out["facades"] = facades
    out["s"] = time.perf_counter() - t_all
    log(f"  4ck resumes ({CKPT_STOP} states, save, load onto the card, "
        f"{CKPT_STATES - CKPT_STOP} more == {CKPT_STATES} straight): "
        + "; ".join(f"{k} {resume_text(v)}" for k, v in facades.items())
        + f" [{card}]")
    return out


def resume_text(r: dict) -> str:
    held = ("bit for bit" if r["err"] == 0.0
            else f"within {r['err']:.2e} of the largest entry")
    kernels = ", ".join(f"{k} {v}" for k, v in r["launches"].items())
    return f"{held}, resume launched {kernels or 'no kernel'}"


# 4ex: the entry point and the examples of examples_torch/ at their default
# sizes, each with the kernels it launched; large_scale_lasso in f32, bf16
# and int8 (8,388,608 rows)
EX_KERNELS = {"entry": ("saga_coeff_multistep_streamed",),
              # deep_solve's SAGA stage at 2^20 rows (saga.RESIDENT_MAX_ROWS);
              # its polish runs no kernel
              "deep_accuracy": ("saga_coeff_multistep",),
              "large_scale_lasso": ("coeff_apply_all",
                                    "lfinito_sweep_multistep"),
              "lasso_10m": ("coeff_apply_all", "lfinito_sweep_multistep"),
              "fused_lasso_tv": (), "tv_denoise_2d": (),
              "sparse_logistic": (),
              # the Huber and Poisson modes open Katyusha's gate (#10, its
              # anchors on #6)
              "robust_regression": ("katyusha_coeff_multistep",
                                    "coeff_apply_all"),
              "poisson_glm": ("katyusha_coeff_multistep", "coeff_apply_all"),
              # the L1 run on #11 (its bootstrap on #6); MCP's prox closes
              # SARAH's gate, so the MCP runs launch nothing
              "nonconvex_sparse_mcp": ("sarah_multistep", "coeff_apply_all"),
              # the lockstep run has no kernel; the local rounds run on #3
              "multihost": ("saga_coeff_multistep",)}
# the parallel examples and the multi-process template, 4ex's additions
EX_PARALLEL = ("robust_regression", "poisson_glm", "nonconvex_sparse_mcp",
               "multihost")


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(ROOT, "examples_torch",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traced_entry(card: str) -> dict:
    """``entry()`` inside ``monitor.profiler_trace``: one kernel #4 launch,
    and the Chrome trace the block writes names it (a window whose trace
    dropped the record is run again, up to PROFILE_TRIES times)."""
    import tempfile

    from ciao_tpu_torch.entry import entry
    from ciao_tpu_torch.monitor import profiler_trace

    for attempt in range(1, PROFILE_TRIES + 1):
        reset_counts()
        t0 = time.perf_counter()
        fn, args = entry()
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            with profiler_trace(tmp) as prof:
                st = fn(*args)
                torch.cuda.synchronize()
            with open(prof.trace_path) as f:
                events = json.load(f)["traceEvents"]
        dt = time.perf_counter() - t0
        c = counts()
        if c["saga_coeff_multistep_streamed"] != 1 or sum(c.values()) != 1:
            raise AssertionError(f"entry(): {c}, not one kernel #4 launch")
        names = [kernel_name(e["name"]) for e in events
                 if e.get("cat") == "kernel"]
        seen = sum(k in SAGA_DEEP_GROUPS["kernel #4"] for k in names)
        if seen == 1:
            break
        if seen or attempt == PROFILE_TRIES:
            raise AssertionError(f"entry(): the trace names {seen} kernel #4 "
                                 f"launches for one: {names}")
        log(f"  4ex entry(): the trace dropped the kernel #4 record; "
            f"tracing again ({attempt + 1} of {PROFILE_TRIES})")
    out = dict(it=st.it, s=dt, launches=c, events=len(events),
               kernels=len(names))
    log(f"  4ex entry(): it = {st.it}, one kernel #4 launch, named in the "
        f"profiler_trace Chrome trace ({len(events)} events, {len(names)} "
        f"device kernels), {dt:.2f} s with its setup and the trace [{card}]")
    return out


def multihost_start(tmp: str) -> list:
    """``examples_torch/multihost.py`` started as two processes on the one
    card, as ``torchrun`` starts them (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    with ``CIAO_MULTIHOST=1``: two ranks on one card join over gloo. Each
    rank's output goes to ``tmp``; the processes and their start time."""
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    env = dict(os.environ, CIAO_MULTIHOST="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    script = os.path.join(ROOT, "examples_torch", "multihost.py")
    t0 = time.perf_counter()
    procs = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.log"), "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, script],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=f, stderr=subprocess.STDOUT))
    return [procs, t0]


def multihost_stop(procs: list) -> None:
    """Kill whichever of the two processes still runs."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def multihost_finish(started: list, tmp: str, card: str) -> dict:
    """Wait for the two processes of ``multihost_start``: both exit 0 and
    rank 0 printed both solves' lines for two processes. Rank 0's lines,
    and the seconds from their start to the later exit."""
    procs, t0 = started
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        multihost_stop(procs)
    dt = time.perf_counter() - t0
    text = [open(os.path.join(tmp, f"rank{r}.log")).read() for r in range(2)]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"4ex multihost.py rank {r} of 2 exited "
                                 f"{p.returncode}:\n{text[r][-4000:]}")
    lines = [l for l in text[0].splitlines() if "suboptimality" in l]
    if len(lines) != 2 or "processes=2" not in lines[0]:
        raise AssertionError(f"4ex multihost.py: rank 0 printed {text[0]}")
    log(f"  4ex multihost.py, two processes on the one card over gloo "
        f"(CIAO_MULTIHOST=1, the torchrun environment), run beside the "
        f"parallel examples: {'; '.join(lines)}; {dt:.2f} s with the "
        f"processes' start [{card}]")
    return dict(lines=lines, s=dt)


# 4ex's timed window of multihost.py's lockstep DPSAGA on one NCCL rank:
# the seconds of LOCKSTEP[1] steps less those of LOCKSTEP[0] (each a whole
# solve from x0, setup included) over the steps between
LOCKSTEP = (1_000, 6_000)


def lockstep_window(card: str) -> dict:
    """ms per lockstep DPSAGA step on ``multihost.py``'s problem (N = 128,
    n = 64, batch 8, f32) on a one-rank NCCL group: two solves of
    LOCKSTEP's step counts, timed to the card's end, differenced."""
    import torch.distributed as dist

    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.parallel import DPSAGA, make_mesh, shard_finite_sum
    from ciao_tpu_torch.parallel.mesh import process_group
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    dev = torch.device("cuda", 0)
    with process_group(dev):
        mesh = make_mesh(device=dev)
        prob = make_lasso(N=128, n=64, p=8, seed=0)
        F = shard_finite_sum(LeastSquaresRows(
            torch.tensor(prob.A, dtype=torch.float32, device=dev),
            torch.tensor(prob.b, dtype=torch.float32, device=dev), 128.0),
            mesh)
        g, x0 = NormL1(float(prob.lam)), torch.zeros(64, device=dev)
        secs = []
        for k in (LOCKSTEP[0],) + LOCKSTEP:      # the first warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            DPSAGA(mesh=mesh, batch=8, block_sampling=True, maxit=k)(
                x0, F=F, g=g, L=prob.L)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ranks = dist.get_world_size()
    ms = (secs[2] - secs[1]) * 1e3 / (LOCKSTEP[1] - LOCKSTEP[0])
    log(f"  4ex lockstep DPSAGA on multihost.py's problem, {ranks} NCCL "
        f"rank: {ms:.4f} ms/step ({LOCKSTEP[0]:,} steps {secs[1]:.3f} s, "
        f"{LOCKSTEP[1]:,} steps {secs[2]:.3f} s) [{card}]")
    return dict(ms=ms, s=secs[1:])


def run_examples(card: str) -> dict:
    """Phase 4ex: ``entry()`` (one launch of kernel #4) traced by
    ``monitor.profiler_trace``, then each example's ``main()`` on the
    card at its defaults, its asserts holding; the kernels each launched,
    counted from 0, must be EX_KERNELS' (#6 and #8 for the LFinito
    examples, #3 for deep_accuracy, none for the routes with no kernel,
    #10 and #6 for the Katyusha examples, #11 and #6 for the SARAH one,
    #3 for the multi-process template). Then a timed window of the
    template's lockstep DPSAGA. The parallel examples start a one-rank
    NCCL group each; beside them ``multihost.py`` runs as two processes
    over gloo."""
    import tempfile

    out = {"entry": traced_entry(card)}
    runs = [("deep_accuracy", {}), ("large_scale_lasso", dict(storage="f32")),
            ("large_scale_lasso", dict(storage="bf16")),
            ("large_scale_lasso", dict(storage="int8")), ("lasso_10m", {}),
            ("fused_lasso_tv", {}), ("tv_denoise_2d", {}),
            ("sparse_logistic", {})] + [(k, {}) for k in EX_PARALLEL]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        started = None
        try:
            for name, kw in runs:
                if name == EX_PARALLEL[0]:
                    out["lockstep"] = lockstep_window(card)
                    started = multihost_start(tmp)
                tag = name + "".join(f" {k if v is True else v}"
                                     for k, v in kw.items())
                mod = load_example(name)
                torch.cuda.empty_cache()
                reset_counts()
                t0 = time.perf_counter()
                res = mod.main(**kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                c = {k: v for k, v in counts().items() if v}
                want = EX_KERNELS[name]
                if set(c) != set(want):
                    raise AssertionError(f"4ex {tag}: launched {c}, not "
                                         f"{want}")
                out[tag] = dict(result=res, s=dt, launches=c)
                del mod, res
            torch.cuda.empty_cache()
            out["multihost x2"] = multihost_finish(started, tmp, card)
        finally:
            if started is not None:
                multihost_stop(started[0])
    return out


def example_text(tag: str, r: dict) -> str:
    """One example's numbers for 4ex's line (``tag``: its name, and the
    storage of its rows where it runs more than one)."""
    res, name = r["result"], tag.split(" ")[0]
    if name == "deep_accuracy":
        what = f"rel {res:.3e}"
    elif name == "fused_lasso_tv":
        what = (f"rel {res[0]:.3e} in {res[2].steps} steps, certified "
                f"{res[2].certified}")
    elif name == "tv_denoise_2d":
        what = ", ".join(f"{k} {v.shape[0]} x {v.shape[1]}"
                         for k, v in res.items())
    elif name == "sparse_logistic":
        what = (f"objective {res['objective0']:.6f} -> SAGA {res['saga']:.6f} "
                f"({res['saga_steps']} steps, {res['saga_s']:.2f} s), "
                f"Katyusha {res['katyusha']:.6f} ({res['katyusha_outer']} "
                f"outer steps, {res['katyusha_s']:.2f} s)")
    elif name == "robust_regression":
        what = (f"|x - x_true| least squares {res['err_ls']:.4f}, Huber + "
                f"Katyusha {res['err']:.4f} ({res['iters']} outer steps), "
                f"DPKatyusha x{res['D']} {res['err_dp']:.4f}")
    elif name == "poisson_glm":
        what = (f"{res['nonzeros']} nonzeros, support {res['support']}/6, "
                f"corr {res['corr']:.3f} ({res['iters']} outer steps), "
                f"DPKatyusha x{res['D']} |x - x_single| {res['err_dp']:.5f}")
    elif name == "nonconvex_sparse_mcp":
        what = (f"|x - refit| L1 {res['err_l1']:.4f}, MCP + SARAH "
                f"{res['err_mcp']:.6f} ({res['iters']} outer steps), DPSARAH "
                f"x{res['D']} {res['err_dp']:.6f}")
    elif name == "multihost":
        what = (f"DPSAGA x{res['D']} {res['iters']} lockstep steps, gap "
                f"{res['gap']:.3e}; {res['steps']} steps in local rounds, "
                f"gap {res['gap_local']:.3e}")
    else:
        what = (f"N {res['N']}, {res['ms_per_epoch']:.2f} ms/epoch over "
                f"{res['epochs']} epochs, objective {res['objective0']:.6f} "
                f"-> {res['objective']:.6f}")
    kernels = ", ".join(f"{k} {v}" for k, v in r["launches"].items())
    return f"{tag}: {what}, {r['s']:.2f} s, launched {kernels or 'no kernel'}"


# ---------------------------------------------------------------------------
# phase 4dp: the data-parallel path (ciao_tpu_torch.parallel)
# ---------------------------------------------------------------------------

# (a) one rank over NCCL: bench.py's DP rounds at the headline (K = 128
# steps a round, 512 rounds, an exact av recompute every 50), SVRG++'s
# local inner loop with m growing 64 -> 8,192 over 8 outer steps, and
# deep_solve_dp on examples_torch/deep_accuracy.py's planted problem
DP = dict(K=128, rounds=512, rebase=50, warm=4, svrg_m0=64, svrg_outer=8)
DP_DEEP = dict(N=1_048_576, n=128, p=16, B=8_192, local_steps=128,
               chunk_rounds=8, max_rounds=128, plateau_rtol=1e-4)
# (b) two ranks on the one card over gloo, 131,072 headline rows each (and
# ProShI's 65,536 x 1,024 configuration): a few rounds of each family on
# its kernel path and on its plain path
DP_TWO = dict(ranks=2, K=32, rounds=2, lfinito_epochs=1, svrg_m=128,
              svrg_outer=2, proshi_K=16, proshi_rounds=2, vr_m=64,
              vr_outer=2, plain_steps=16, full_steps=4)
# (a)'s SVRG++ z_full, kernel path vs plain path, over 16,320 inner steps
# of f32 drift: read 6.556e-07 and 6.619e-07 on an H100 80GB HBM3 at
# 700 W; 1e-5 leaves that 15-fold room, Z_TOL[False] would leave 1.5-fold.
# (b)'s Katyusha and SARAH local inner loops (2 outer steps of 64 on
# 131,072 headline rows a rank) take the same bar: SARAH's x̃ read
# 1.134e-06 on the same card, its estimator's recursion carrying the f32
# drift of the kernel's dots from step to step
DP_SVRG_TOL = 1e-5
# the kernels of the DP path, each with the family whose rounds launch it
DP_KERNELS = {"saga_coeff_multistep": "saga", "finito_coeff_multistep":
              "finito", "lfinito_sweep_multistep": "lfinito",
              "svrg_coeff_multistep": "svrg", "coeff_apply_all": "lfinito",
              "proshi_multistep": "proshi",
              "katyusha_coeff_multistep": "katyusha",
              "sarah_multistep": "sarah"}
DP_LABEL = {"saga_coeff_multistep": "#3", "svrg_coeff_multistep": "#5",
            "coeff_apply_all": "#6", "lfinito_sweep_multistep": "#8",
            "finito_coeff_multistep": "#9", "proshi_multistep": "#18",
            "katyusha_coeff_multistep": "#10", "sarah_multistep": "#11"}
# the vectors of each DP state that are the same on every rank
DP_REPLICATED = ("z", "av", "z_full", "w", "x_tilde", "y", "x", "gbar",
                 "w_anchor", "xg", "fbe", "S", "Y", "rho", "ls_ewma")


def rel_gap(a, b) -> float:
    """max |a − b| over b's largest entry."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def timed(fn):
    """(result, seconds) of fn() with the card synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def count_of(fn, names) -> tuple:
    """(fn(), the launches of ``names`` it made), from the counts'
    difference (no reset: the phase's own reset stands)."""
    c0 = counts()
    out = fn()
    c1 = counts()
    return out, {k: c1[k] - c0[k] for k in names}


def dp_saga_one_rank(mesh, gen, dev, storage: str, seed: int, card: str):
    """DPSAGA local rounds on one rank (bench.py:1651-1684): the first
    round held against single-card coefficient SAGA on the same starts,
    then DP['rounds'] rounds timed, and the single-card SAGA run of the
    same steps beside them."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    F, gamma, _ = lasso(gen, dev, N, n, storage)
    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    Fd = parallel.shard_finite_sum(F, mesh)
    if not fb.saga_multistep_available(Fd, g, x0, B):
        raise AssertionError("4dp: kernel #3's gate is closed on the rank's "
                             "rows")
    K, R = DP["K"], DP["rounds"]
    cfg = tdp.DPCfg(N=N, D=1, b_loc=B, sweeping=1, alpha=0.999, block=True,
                    coeff=True, local_steps=K, fused=True,
                    rebase_every=DP["rebase"])
    init, _, run, _ = parallel.build_dp_functions("saga", mesh, Fd, g, cfg)
    st0 = init(x0, gamma, seed)
    starts = tdp._local_round_starts(seed, 1, N, B, K, 1, mesh.rank, dev)
    r1, c1 = count_of(lambda: run(st0, 1, starts=starts[None]),
                      ["saga_coeff_multistep"])
    scfg = SAGACfg(N=N, sag=False, batch=B, block=True, fused=True,
                   coeff=True)
    s0 = saga_init(F, g, x0, gamma, seed, scfg)
    s1 = saga_run(F, g, s0, scfg, K, starts=starts)
    err = max(rel_gap(r1.z, s1.z), rel_gap(r1.av, s1.av))
    if not err <= 1e-6:
        raise AssertionError(f"4dp {storage}: the first DP round is {err:.3e} "
                             f"off single-card SAGA on its starts")
    run(st0, DP["warm"])
    (st, c), dt = timed(lambda: count_of(lambda: run(st0, R),
                                         ["saga_coeff_multistep"]))
    c = {k: v + c1[k] for k, v in c.items()}
    _, dt1 = timed(lambda: saga_run(F, g, s0, scfg, R * K))
    cost0, cost1 = cost(F, g, x0), cost(F, g, st.z)
    if not (math.isfinite(cost1) and cost1 < cost0):
        raise AssertionError(f"4dp {storage}: DP SAGA cost {cost0} -> "
                             f"{cost1}")
    ms, ms1 = dt / (R * K) * 1e3, dt1 / (R * K) * 1e3
    log(f"  4dp (a) DPSAGA {storage}, one rank over NCCL, K = {K}, {R} "
        f"rounds (exact av every {DP['rebase']}): {ms:.5f} ms/step, "
        f"single-card SAGA {ms1:.5f} ms/step ({ms / ms1:.3f}x), "
        f"{(c['saga_coeff_multistep'] - c1['saga_coeff_multistep']) / R:.3f} "
        f"kernel #3 launches a round; first round vs single-card on its "
        f"starts {err:.3e}; cost {cost0:.6e} -> {cost1:.6e} [{card}]")
    return dict(ms=ms, single_ms=ms1, err=err, launches=c)


def dp_svrg_plus_one_rank(mesh, gen, dev, seed: int, card: str):
    """SVRG++'s local inner loop on one rank (bench.py:1686-1709): m
    from 64 to 8,192 over 8 outer steps, on kernels #5 and #6, then on
    the plain path (the same DP code with the gate closed)."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1

    F, _, L = lasso(gen, dev, N, n, "f32")
    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    Fd = parallel.shard_finite_sum(F, mesh)
    if not fb.svrg_multistep_available(Fd, g, x0, B):
        raise AssertionError("4dp: kernel #5's gate is closed")
    gamma = torch.tensor(1.0 / (10.0 * float(L.max())), device=dev)
    m0, T = DP["svrg_m0"], DP["svrg_outer"]
    inner = m0 * (2 ** T - 1)
    out = {}
    for fused in (True, False):
        cfg = tdp.DPCfg(N=N, D=1, b_loc=B, sweeping=1, alpha=0.999,
                        plus=True, block=True, coeff=fused, local=True,
                        fused=fused)
        init, _, run, _ = parallel.build_dp_functions("svrg", mesh, Fd, g,
                                                      cfg)
        st0 = init(x0, gamma, seed, m0)
        names = ["svrg_coeff_multistep", "coeff_apply_all"]
        (st, c), dt = timed(lambda: count_of(lambda: run(st0, T), names))
        out[fused] = dict(st=st, ms=dt / inner * 1e3, launches=c)
    err = rel_gap(out[True]["st"].z_full, out[False]["st"].z_full)
    cost0, cost1 = cost(F, g, x0), cost(F, g, out[True]["st"].z_full)
    if not (err <= DP_SVRG_TOL and cost1 < cost0):
        raise AssertionError(f"4dp SVRG++: kernel path {err:.3e} off the "
                             f"plain path (> {DP_SVRG_TOL}), cost {cost0} -> "
                             f"{cost1}")
    if out[False]["launches"]["svrg_coeff_multistep"]:
        raise AssertionError("4dp SVRG++: the plain path launched #5")
    lk = out[True]["launches"]
    log(f"  4dp (a) SVRG++ local inner, one rank, m {m0} -> "
        f"{m0 * 2 ** (T - 1)} over {T} outer steps ({inner} inner steps): "
        f"kernels {out[True]['ms']:.5f} ms/inner step "
        f"({lk['svrg_coeff_multistep']} #5 and {lk['coeff_apply_all']} #6 "
        f"launches), plain path {out[False]['ms']:.5f} ms/inner step; "
        f"z_full {err:.3e} apart; cost {cost0:.6e} -> {cost1:.6e} [{card}]")
    return dict(ms=out[True]["ms"], plain_ms=out[False]["ms"], err=err,
                launches=lk)


def dp_deep_one_rank(mesh, dev, card: str):
    """deep_solve_dp on deep_accuracy.py's planted problem (1,048,576 x
    128, B = 8,192) to rel <= 1e-6."""
    import numpy as np

    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    P = DP_DEEP
    prob = make_lasso(N=P["N"], n=P["n"], p=P["p"], seed=0, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A, device=dev),
                         torch.tensor(prob.b, device=dev), float(P["N"]))
    g = NormL1(float(prob.lam))
    (x, info), dt = timed(lambda: parallel.deep_solve_dp(
        torch.zeros(P["n"], device=dev), F, g, L=prob.L, N=P["N"],
        mesh=mesh, batch=P["B"], local_steps=P["local_steps"],
        chunk_rounds=P["chunk_rounds"], max_rounds=P["max_rounds"],
        plateau_rtol=P["plateau_rtol"]))
    rel = (prob.cost(x.double().cpu().numpy()) - prob.f_star) / abs(
        prob.f_star)
    if not rel <= 1e-6:
        raise AssertionError(f"4dp deep_solve_dp: rel {rel:.3e} > 1e-6")
    log(f"  4dp (a) deep_solve_dp, one rank, {P['N']} x {P['n']} at B = "
        f"{P['B']}: rel {rel:.3e} in {dt:.2f} s ({info.staged.epochs[0]} "
        f"SAGA epochs in {len(info.staged.objectives)} chunks, "
        f"{info.polish_steps} polish steps, lambda_max {info.lmax:.4e}) "
        f"[{card}]")
    return dict(rel=rel, s=dt)


# (c) one rank over NCCL: the families beyond the reference at the headline.
# DPKatyusha and DPSARAH with their local inner loops on kernels #10 and #11
# (the anchor and the bootstrap on #6) at m = 2N/batch = 128 inner steps an
# outer step, their first outer step held to the single-card fused solver on
# the same starts; short runs of the families JAX's DP path runs without a
# kernel; deep_solve_pd_dp on 4y's fused-lasso plant
DQ = dict(m=2 * N // B, outer=16, steps=256, profile=32, full_steps=32,
          full_profile=8, panoc_steps=16, panoc_profile=4)
# the first DP outer step against the single-card facade's, relative to the
# largest entry of each vector
DQ_FIRST_TOL = 1e-6
DQ_VR = {"katyusha": ("katyusha_coeff_multistep", "#10"),
         "sarah": ("sarah_multistep", "#11")}
DQ_LABEL = {"katyusha": "DPKatyusha", "sarah": "DPSARAH"}


def dq_vr_one_rank(mesh, gen, dev, kind: str, storage: str, seed: int,
                   card: str) -> dict:
    """DPKatyusha (ns) or DPSARAH with local_inner on one rank: the
    first outer step held to the single-card fused solver on the DP's own
    starts, then runs of DQ['outer'] outer steps timed beside the single
    card's (a warm-up run of each, then four turns of each in alternating
    order; ms an inner step the mean of the turns), with the launches of
    #10/#11 and #6 an outer step."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import katyusha as kat
    from ciao_tpu_torch.solvers import sarah as sar

    F, _, L = lasso(gen, dev, N, n, storage)
    Fd = parallel.shard_finite_sum(F, mesh)
    del F
    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    if not fb.svrg_multistep_available(Fd, g, x0, B):
        raise AssertionError(f"4dp (c) {kind}: the kernel gate is closed")
    m, T = DQ["m"], DQ["outer"]
    Lm = L.max()
    name, label = DQ_VR[kind]
    cfg = tdp.DPCfg(N=N, D=1, b_loc=B, sweeping=1, alpha=0.999, block=True,
                    coeff=True, local=True, m_inner=m, fused=True,
                    variant="ns" if kind == "katyusha" else "basic")
    init, _, run, _ = parallel.build_dp_functions(kind, mesh, Fd, g, cfg)
    if kind == "katyusha":
        st0 = init(x0, Lm, seed, 0.5, 0.5)
        scfg = kat.KatyushaCfg(N=N, batch=B, m=m, block=True, ns=True,
                               fused=True)
        s0 = kat.katyusha_init(Fd, g, x0, Lm, 0.5, 0.5, seed, scfg)
        srun, fields = kat.katyusha_run, ("x_tilde", "y", "z", "av")
    else:
        st0 = init(x0, 1.0 / (2.0 * Lm), seed, 1.0)
        scfg = sar.SARAHCfg(N=N, batch=B, m=m, block=True, fused=True)
        s0 = sar.sarah_init(Fd, g, x0, 1.0 / (2.0 * Lm), 1.0, seed, scfg)
        srun, fields = sar.sarah_run, ("x_tilde",)
    names = [name, "coeff_apply_all"]
    starts = tdp._inner_schedule(mesh, cfg, seed, 1, m, 0, m, None, None, dev)
    r1, c1 = count_of(lambda: run(st0, 1, starts=[starts]), names)
    s1 = srun(Fd, g, s0, scfg, 1, starts=[starts])
    err = max(rel_gap(getattr(r1, f), getattr(s1, f)) for f in fields)
    if not err <= DQ_FIRST_TOL:
        raise AssertionError(f"4dp (c) {kind} {storage}: the first DP outer "
                             f"step is {err:.3e} off the single card's on "
                             f"its starts (> {DQ_FIRST_TOL})")
    # a warm-up run of each, then four turns of each in alternating order
    (st, c), _ = timed(lambda: count_of(lambda: run(st0, T), names))
    srun(Fd, g, s0, scfg, T)
    turns = {"dp": [], "single": []}
    for t in range(4):
        for k in (("dp", "single") if t % 2 == 0 else ("single", "dp")):
            if k == "dp":
                (_, ct), dt = timed(lambda: count_of(lambda: run(st0, T),
                                                     names))
                c = {q: c[q] + ct[q] for q in names}
            else:
                _, dt = timed(lambda: srun(Fd, g, s0, scfg, T))
            turns[k].append(dt / (T * m) * 1e3)
    cost0, cost1 = cost(Fd, g, x0), cost(Fd, g, st.x_tilde)
    if not (math.isfinite(cost1) and cost1 < cost0):
        raise AssertionError(f"4dp (c) {kind} {storage}: cost {cost0} -> "
                             f"{cost1}")
    runs = 5 * T
    if c[name] != runs or c["coeff_apply_all"] != runs:
        raise AssertionError(f"4dp (c) {kind} {storage}: launches {c} over "
                             f"{runs} outer steps, not one {label} and one "
                             f"#6 each")
    ms, ms1 = (sum(turns["dp"]) / 4, sum(turns["single"]) / 4)
    log(f"  4dp (c) {DQ_LABEL[kind]} {storage} local_inner, one rank over "
        f"NCCL, m = {m}, {T} outer steps a turn: {ms:.5f} ms/inner step "
        f"(turns {', '.join(f'{x:.5f}' for x in turns['dp'])}), "
        f"single-card fused {ms1:.5f} "
        f"({', '.join(f'{x:.5f}' for x in turns['single'])}), "
        f"{ms / ms1:.3f}x; {c[name] / runs:.0f} {label} and "
        f"{c['coeff_apply_all'] / runs:.0f} #6 launches an outer step; "
        f"first "
        f"outer step vs single card on its starts {err:.3e} "
        f"({', '.join(fields)}); cost {cost0:.6e} -> {cost1:.6e} [{card}]")
    return dict(ms=ms, single_ms=ms1, err=err,
                launches={k: c[k] + c1[k] for k in names})


def dq_cost(F, g, h, K, z) -> float:
    """(1/N)Σ f_i + g (+ h(Kz)) at z."""
    v = cost(F, g, z)
    if h is not None:
        v += float(h.value(z if K is None else K.matvec(z)))
    return v


def dq_plain_one_rank(mesh, gen, dev, seed: int, card: str) -> dict:
    """The families JAX's DP path runs without a kernel, on one rank at
    the headline (f32 rows), through their facades' init and run: the
    cost falls, ms a step, a profiled window's device launches a step and
    idle share, PANOC's FBE evaluations a step, and none of the nineteen
    kernels launched."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch.solvers import panoc

    F, _, L = lasso(gen, dev, N, n, "f32")
    Fd = parallel.shard_finite_sum(F, mesh)
    del F
    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    box = IndBox(torch.tensor(-1.0, device=dev), torch.tensor(1.0, device=dev))
    tv = NormL1(torch.tensor(0.05, device=dev))
    K = FirstDifference()
    S, P = DQ["steps"], DQ["profile"]
    fams = {
        "DPLSVRG": (parallel.DPLSVRG(mesh=mesh, batch=B, block_sampling=True,
                                     seed=seed), g, None, None, S, P),
        "DPLKatyusha": (parallel.DPLKatyusha(mesh=mesh, batch=B,
                                             block_sampling=True, seed=seed),
                        g, None, None, S, P),
        "DPPointSAGA": (parallel.DPPointSAGA(mesh=mesh, batch=B, seed=seed),
                        None, None, None, S, P),
        "DPSSNM": (parallel.DPSSNM(mesh=mesh, batch=B, seed=seed), g, None,
                   None, S, P),
        "DPDavisYin": (parallel.DPDavisYin(mesh=mesh), g, box, None,
                       DQ["full_steps"], DQ["full_profile"]),
        "DPCondatVu": (parallel.DPCondatVu(mesh=mesh), g, tv, K,
                       DQ["full_steps"], DQ["full_profile"]),
        "DPPANOC": (parallel.DPPANOC(mesh=mesh), g, None, None,
                    DQ["panoc_steps"], DQ["panoc_profile"]),
        "DPZeroFPR": (parallel.DPZeroFPR(mesh=mesh), g, None, None,
                      DQ["panoc_steps"], DQ["panoc_profile"]),
    }
    evals = [0]
    inner = panoc._eval_fbe

    def counted(*a, **k):
        evals[0] += 1
        return inner(*a, **k)

    out = {}
    panoc._eval_fbe = counted
    try:
        for tag, (solver, gg, h, KK, steps, prof_steps) in fams.items():
            if tag in ("DPDavisYin", "DPCondatVu"):
                args = (x0, Fd, gg, h) + ((KK,) if KK is not None else ()) + (
                    L, None)
            else:
                args = (x0, Fd, gg, L, None)
            _, Fr, _, init, _, run, _ = solver._setup(*args)
            st0 = init()
            gc = gg if gg is not None else NormL1(torch.tensor(0.0,
                                                               device=dev))
            cost0 = dq_cost(Fr, gc, h if KK is not None else None, KK,
                            st0.solution)
            evals[0] = 0
            (st, c), dt = timed(lambda: count_of(lambda: run(st0, steps),
                                                 KERNELS))
            ev = evals[0] / steps
            cost1 = dq_cost(Fr, gc, h if KK is not None else None, KK,
                            st.solution)
            if any(c.values()):
                raise AssertionError(f"4dp (c) {tag}: launched "
                                     f"{ {k: v for k, v in c.items() if v} }")
            if not (math.isfinite(cost1) and cost1 < cost0):
                raise AssertionError(f"4dp (c) {tag}: cost {cost0} -> "
                                     f"{cost1}")
            prof = profile_steps(f"4dp (c) {tag}", lambda: run(st0, prof_steps),
                                 prof_steps, card, {})
            out[tag] = dict(ms=dt * 1e3 / steps, steps=steps, cost0=cost0,
                            cost1=cost1, evals=ev,
                            launches=sum(prof["calls"].values()) / prof_steps,
                            idle=1.0 - prof["busy"] / prof["step"])
    finally:
        panoc._eval_fbe = inner
    log("  4dp (c) one rank over NCCL at the headline (f32), no kernel: "
        + "; ".join(
            f"{k} {v['steps']} steps {v['ms']:.4f} ms/step, cost "
            f"{v['cost0']:.6e} -> {v['cost1']:.6e}, "
            f"{v['launches']:.1f} device launches/step, idle "
            f"{v['idle']:.3f}"
            + (f", {v['evals']:.3f} FBE evaluations/step"
               if k in ("DPPANOC", "DPZeroFPR") else "")
            for k, v in out.items())
        + f"; none of the {len(KERNELS)} kernels launched [{card}]")
    return out


def dq_deep_pd_one_rank(mesh, dev, seed: int, card: str) -> dict:
    """deep_solve_pd_dp on 4y's fused-lasso plant (bench.py's
    bench_pd_deep, 262,144 x 1,024): certified, rel <= 1e-6, seconds."""
    from ciao_tpu_torch import parallel

    S = PD_DEEP
    P = pd_problem(dev, seed, False)
    (x, info), dt = timed(lambda: parallel.deep_solve_pd_dp(
        torch.zeros(S["n"], device=dev), P["F"], h=P["h"], K=P["K"],
        N=S["N"], mesh=mesh, chunk_steps=S["chunk_steps"],
        max_steps=S["max_steps"], polish_chunk=S["chunk"], seed=seed))
    rel, jumps_ok, _ = pd_rel(P, x, False)
    log(f"  4dp (c) deep_solve_pd_dp, one rank, fused lasso {S['N']} x "
        f"{S['n']}: rel {rel:.3e}, refined {info.refined}, certified "
        f"{info.certified}, jump set recovered {jumps_ok}, {info.steps} "
        f"Condat-Vu steps, {dt:.3f} s [{card}]")
    if not (info.refined and info.certified):
        raise AssertionError(f"4dp (c) deep_solve_pd_dp: refined "
                             f"{info.refined}, certified {info.certified}")
    if not (math.isfinite(rel) and abs(rel) <= DEEP_REL):
        raise AssertionError(f"4dp (c) deep_solve_pd_dp: rel {rel}")
    del P
    return dict(rel=rel, s=dt, steps=info.steps)


def dp_two_rank_runs(mesh, seed: int) -> dict:
    """One rank's part of (b): each family a few rounds on its kernel
    path and on its plain path (the gate closed), on this rank's rows of
    the headline (ProShI: of its 65,536 x 1,024 configuration)."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1

    dev = mesh.device
    T = DP_TWO
    D = mesh.size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 4_000)  # the same rows on every rank
    F, gamma_saga, L = lasso(gen, dev, N, n, "f32")
    Fd = parallel.shard_finite_sum(F, mesh)
    del F  # the rank keeps only its rows
    rows_bytes = Fd.A.untyped_storage().nbytes()
    if rows_bytes != (N // D) * n * 4:
        raise AssertionError(f"4dp (b): the rank's part holds {rows_bytes} "
                             f"bytes of rows, not its {N // D} rows")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    lo, hi = mesh.rows(N)
    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    b_loc = B // D
    gam_fin = (0.999 * N / L[lo:hi]).float().contiguous()
    gam_svrg = torch.tensor(1.0 / (10.0 * float(L.max())), device=dev)
    gates = {"saga": fb.saga_multistep_available(Fd, g, x0, b_loc),
             "finito": fb.finito_multistep_available(Fd, g, x0, b_loc),
             "lfinito": fb.lfinito_sweep_available(Fd, g, x0, b_loc),
             "svrg": fb.svrg_multistep_available(Fd, g, x0, b_loc)}
    gates["katyusha"] = gates["sarah"] = gates["svrg"]
    Lm = L.max()
    base = dict(N=N, D=D, b_loc=b_loc, alpha=0.999)
    runs = {
        "saga": ("saga", dict(base, sweeping=1, block=True, coeff=True,
                              local_steps=T["K"], rebase_every=50),
                 gamma_saga, (), T["rounds"], ("z", "av", "s")),
        "finito": ("finito_coeff", dict(base, sweeping=3, coeff=True,
                                        local_steps=T["K"], rebase_every=50),
                   gam_fin, (), T["rounds"], ("z", "av", "c", "zb")),
        "lfinito": ("lfinito", dict(base, sweeping=3, local=True), gam_fin,
                    (), T["lfinito_epochs"], ("z", "av", "z_full")),
        "svrg": ("svrg", dict(base, sweeping=1, block=True, local=True),
                 gam_svrg, (T["svrg_m"],), T["svrg_outer"],
                 ("z_full", "w", "av")),
        "katyusha": ("katyusha", dict(base, sweeping=1, block=True,
                                      local=True, m_inner=T["vr_m"],
                                      variant="ns"),
                     Lm, (0.5, 0.5), T["vr_outer"],
                     ("x_tilde", "y", "z", "av")),
        "sarah": ("sarah", dict(base, sweeping=1, block=True, local=True,
                                m_inner=T["vr_m"]),
                  1.0 / (2.0 * Lm), (1.0,), T["vr_outer"], ("x_tilde",)),
    }
    out = {}

    def one(family, cfg, gamma, extra, steps, Fr, gr, xr, fields):
        res = {}
        for fused in (True, False):
            c = dict(cfg, fused=fused)
            if family in ("svrg", "katyusha", "sarah"):
                c["coeff"] = fused
            init, _, run, _ = parallel.build_dp_functions(
                family, mesh, Fr, gr, tdp.DPCfg(**c))
            st0 = init(xr, gamma, seed, *extra)
            (st, cn), dt = timed(lambda: count_of(
                lambda: run(st0, steps), list(DP_KERNELS)))
            res[fused] = dict({f: getattr(st, f).cpu() for f in fields},
                              s=dt, launches={k: int(v) for k, v in
                                              cn.items()},
                              steps={k: v.steps for k, v in cn.items()})
        return res

    for name, (family, cfg, gamma, extra, steps, fields) in runs.items():
        if not gates[name]:
            raise AssertionError(f"4dp (b) {name}: the kernel gate is closed")
        out[name] = one(family, cfg, gamma, extra, steps, Fd, g, x0, fields)
    # ProShI on its configuration, IndBox(-inf, hi) coupling
    Np = PROSHI["N"]
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(seed + 5_000)
    Fp, _, Lp = lasso(pgen, dev, Np, n, "f32")
    Fpd = parallel.shard_finite_sum(Fp, mesh)
    gp = coupling("IndBox", dev)
    xp = torch.zeros(n, device=dev)
    plo, phi = mesh.rows(Np)
    if not fb.proshi_multistep_available(Fpd, gp, xp, PROSHI["B"] // D):
        raise AssertionError("4dp (b) proshi: the kernel gate is closed")
    pcfg = dict(N=Np, D=D, b_loc=PROSHI["B"] // D, alpha=0.999, sweeping=2,
                local_steps=T["proshi_K"], rebase_every=50)
    out["proshi"] = one("proshi", pcfg,
                        (0.999 * Np / Lp[plo:phi]).float().contiguous(), (),
                        T["proshi_rounds"], Fpd, gp, xp, ("z", "av", "s"))
    out["held"] = dict(rows=rows_bytes, allocated=held)
    out["plain"] = dp_two_rank_plain(mesh, Fd, g, L, seed)
    return out


def dp_two_rank_plain(mesh, Fd, g, L, seed: int) -> dict:
    """(b)'s families with no kernel in JAX's DP path, a few steps each
    through their facades on this rank's rows: the replicated vectors of
    the last state, the launches of the nineteen kernels (none), and
    PANOC's and ZeroFPR's FBE evaluations on this rank."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch.solvers import panoc

    dev = mesh.device
    T = DP_TWO
    x0 = torch.zeros(n, device=dev)
    box = IndBox(torch.tensor(-1.0, device=dev), torch.tensor(1.0, device=dev))
    tv = NormL1(torch.tensor(0.05, device=dev))
    steps, full = T["plain_steps"], T["full_steps"]
    fams = {
        "lsvrg": (parallel.DPLSVRG(mesh=mesh, batch=B, block_sampling=True,
                                   seed=seed), (x0, Fd, g, L, None), steps),
        "lkatyusha": (parallel.DPLKatyusha(mesh=mesh, batch=B,
                                           block_sampling=True, seed=seed),
                      (x0, Fd, g, L, None), steps),
        "point_saga": (parallel.DPPointSAGA(mesh=mesh, batch=B, seed=seed),
                       (x0, Fd, None, L, None), steps),
        "ssnm": (parallel.DPSSNM(mesh=mesh, batch=B, seed=seed),
                 (x0, Fd, g, L, None), steps),
        "dys": (parallel.DPDavisYin(mesh=mesh), (x0, Fd, g, box, L, None),
                full),
        "pd": (parallel.DPCondatVu(mesh=mesh),
               (x0, Fd, g, tv, FirstDifference(), L, None), full),
        "panoc": (parallel.DPPANOC(mesh=mesh), (x0, Fd, g, L, None), full),
        "zerofpr": (parallel.DPZeroFPR(mesh=mesh), (x0, Fd, g, L, None),
                    full),
    }
    evals = [0]
    inner = panoc._eval_fbe

    def counted(*a, **k):
        evals[0] += 1
        return inner(*a, **k)

    out = {}
    panoc._eval_fbe = counted
    try:
        for fam, (solver, args, k) in fams.items():
            _, _, _, init, _, run, _ = solver._setup(*args)
            evals[0] = 0
            st, c = count_of(lambda: run(init(), k), KERNELS)
            out[fam] = dict({f: v.cpu() for f, v in st._asdict().items()
                             if f in DP_REPLICATED
                             and isinstance(v, torch.Tensor)},
                            evals=evals[0], it=st.it,
                            launches=sum(int(v) for v in c.values()))
    finally:
        panoc._eval_fbe = inner
    return out


def dp_rank_main(rank: int, D: int, store: str, out_dir: str, seed: int):
    """A rank process of (b): gloo over a FileStore, CUDA tensors on the
    one card, its results written to out_dir."""
    import datetime

    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, D), rank=rank,
                            world_size=D,
                            timeout=datetime.timedelta(minutes=5))
    try:
        mesh = parallel.make_mesh(device="cuda:0")
        out = dp_two_rank_runs(mesh, seed)
        torch.cuda.synchronize()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_two_ranks(seed: int, card: str) -> dict:
    """(b): DP_TWO['ranks'] processes on the one card over gloo, spawned
    after the build (they load it), each family's kernel path held to
    its plain path on each rank, and the replicated vectors held bit for
    bit across the ranks. Returns the launches of the kernel paths,
    summed over the ranks."""
    import tempfile

    import torch.multiprocessing as mp

    D = DP_TWO["ranks"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        mp.start_processes(dp_rank_main,
                           args=(D, os.path.join(tmp, "store"), tmp, seed),
                           nprocs=D, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(D)]
    launches = {k: 0 for k in DP_KERNELS}
    parts = []
    held = [o.pop("held") for o in outs]
    no_kernel = [o.pop("plain") for o in outs]
    for fam in outs[0]:
        worst = 0.0
        for r, o in enumerate(outs):
            kern, plain = o[fam][True], o[fam][False]
            for f, v in kern.items():
                if not isinstance(v, torch.Tensor):
                    continue
                tol = (DP_SVRG_TOL if fam in ("katyusha", "sarah") else
                       Z_TOL[False] if f in ("z", "z_full", "w") else
                       STATE_TOL[False])
                e = rel_gap(v, plain[f])
                if not e <= tol:
                    raise AssertionError(f"4dp (b) {fam} rank {r}: {f} of "
                                         f"the kernel path {e:.3e} off the "
                                         f"plain path (> {tol})")
                worst = max(worst, e)
            for path in (True, False):
                for f in DP_REPLICATED:
                    if f in o[fam][path] and not torch.equal(
                            o[fam][path][f], outs[0][fam][path][f]):
                        raise AssertionError(f"4dp (b) {fam}: {f} differs "
                                             f"between ranks 0 and {r}")
            if any(o[fam][False]["launches"].values()):
                raise AssertionError(f"4dp (b) {fam}: the plain path "
                                     f"launched {o[fam][False]['launches']}")
            for k, v in kern["launches"].items():
                launches[k] += Count(v, kern["steps"][k])
        mine = [k for k, f in DP_KERNELS.items() if f == fam]
        if any(outs[0][fam][True]["launches"][k] == 0 for k in mine):
            raise AssertionError(f"4dp (b) {fam}: no launch of {mine}: "
                                 f"{outs[0][fam][True]['launches']}")
        parts.append(
            f"{fam} {worst:.2e} (kernels {outs[0][fam][True]['s']:.2f} s, "
            f"plain {outs[0][fam][False]['s']:.2f} s on rank 0; " + ", ".join(
                f"{DP_LABEL[k]} x{outs[0][fam][True]['launches'][k]}"
                for k in DP_KERNELS if outs[0][fam][True]['launches'][k])
            + " a rank)")
    for fam, p0 in no_kernel[0].items():
        for r, pr in enumerate(no_kernel):
            mine = pr[fam]
            for f, v in mine.items():
                if isinstance(v, torch.Tensor) and not torch.equal(v, p0[f]):
                    raise AssertionError(f"4dp (b) {fam}: {f} differs "
                                         f"between ranks 0 and {r}")
            if mine["launches"]:
                raise AssertionError(f"4dp (b) {fam}: rank {r} launched "
                                     f"{mine['launches']} kernels")
            if (mine["evals"], mine["it"]) != (p0["evals"], p0["it"]):
                raise AssertionError(
                    f"4dp (b) {fam}: rank {r} took {mine['evals']} FBE "
                    f"evaluations in {mine['it'] - 1} steps, rank 0 "
                    f"{p0['evals']} in {p0['it'] - 1}")
    parts.append("no kernel, replicated vectors bit for bit across the "
                 "ranks: " + ", ".join(
                     f"{fam} ({p0['it'] - 1} steps"
                     + (f", {p0['evals']} FBE evaluations on each rank"
                        if fam in ("panoc", "zerofpr") else "") + ")"
                     for fam, p0 in no_kernel[0].items()))
    log(f"  4dp (b) {D} ranks on the one card over gloo (CUDA tensors), "
        f"{N // D} headline rows a rank (ProShI {PROSHI['N'] // D}): kernel "
        f"path vs plain path, largest gap " + "; ".join(parts)
        + f"; the replicated vectors bit for bit across the ranks; each "
        f"rank holds "
        f"{held[0]['rows'] / 2 ** 20:.1f} MiB of rows, "
        + ", ".join(f"{h['allocated'] / 2 ** 20:.1f}" for h in held)
        + f" MiB allocated after the cut; {wall:.2f} s with the spawn "
        f"[{card}]")
    return launches


def run_dp(dev, gen, seed: int, card: str) -> dict:
    """Phase 4dp: (a) and (c) one rank over NCCL, (b) two ranks on the
    one card over gloo. Returns the DP path's launches of each kernel
    (the comparison runs against the single-card solvers and the plain
    paths excluded)."""
    import tempfile

    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    t0 = time.perf_counter()
    launches = {k: 0 for k in DP_KERNELS}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(device=dev)
            saga = {s_: dp_saga_one_rank(mesh, gen, dev, s_, seed, card)
                    for s_ in ("f32", "int8")}
            svrg = dp_svrg_plus_one_rank(mesh, gen, dev, seed, card)
            deep = dp_deep_one_rank(mesh, dev, card)
            t_a = time.perf_counter() - t0
            vr = {(k, s_): dq_vr_one_rank(mesh, gen, dev, k, s_, seed, card)
                  for k in DQ_VR for s_ in ("f32", "int8")}
            torch.cuda.empty_cache()
            plain = dq_plain_one_rank(mesh, gen, dev, seed, card)
            torch.cuda.empty_cache()
            deep_pd = dq_deep_pd_one_rank(mesh, dev, seed, card)
            t_c = time.perf_counter() - t0 - t_a
        finally:
            dist.destroy_process_group()
    for r in (*saga.values(), svrg, *vr.values()):
        for k, v in r["launches"].items():
            launches[k] += v
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    for k, v in dp_two_ranks(seed, card).items():
        launches[k] += v
    return dict(saga=saga, svrg=svrg, deep=deep, vr=vr, plain=plain,
                deep_pd=deep_pd, launches=launches, s_a=t_a, s_c=t_c,
                s_b=time.perf_counter() - t_b, s=time.perf_counter() - t0)


# 4tp: the tensor-parallel path (no kernel by design: JAX's TP steps run the
# oracle's margin protocol outside any Pallas kernel). (a) one NCCL rank, a
# (1, 1) mesh, at the headline (B = 4,096): TPSAGA and SAG (f32, int8),
# TPFinito sweep 3 (f32, int8), TPLFinito, TPSVRG at m = N/B and SVRG++ and
# TPFISTA (f32), each's first steps held to the single card's plain path on
# the same schedule, a run timed beside the single card's stepwise run and a
# profiled window; TPProshi on 4j's 65,536 x 128 sharing plant;
# deep_solve_tp on deep_accuracy's 1,048,576 x 128 plant. (b) two gloo ranks
# on the one card, (1, 2) and (2, 1) meshes, held to (a)'s runs of the same
# data and schedule. (c) and (d): the families beyond the reference, the
# same way (TP_C below), deep_solve_pd_tp and dryrun_multichip(2).
TP_A = dict(check=8, steps=128, profile=16, lfinito=2, svrg=2, fista=32,
            fista_profile=8)
TP_PROSHI = dict(batch=512, sweeping=2, steps=256, profile=16)
# deep_solve_tp takes γ = 10/(3·L_max) (its default 1/(3·L_max) ran all 16
# chunks of 1,024 stepwise TPSAGA steps, 24.14 s on an H100 at 700 W; 8
# chunks of 256 at 10x on the CPU)
TP_DEEP = dict(N=1_048_576, n=128, p=16, B=8_192, chunk_steps=256,
               max_steps=4_096, plateau_rtol=1e-4, gamma_x=10.0)
# (b)'s deep_solve_tp takes γ = 10/(3·L_max): at the default 1/(3·L_max) of
# the row moduli this plant needs ~16,000 TPSAGA steps (a block of 4,096
# rows curves far less than L_max), 1,800 at 10x (CPU, f32)
TP_TWO = dict(ranks=2, steps=32, svrg_m=32, fista=16, proshi=32,
              deep_N=131_072, deep_B=4_096, deep_chunk=256, deep_max=4_096,
              deep_gamma_x=10.0, split=16, panoc=8)
# the first TP steps against the single card's plain path, and each rank's
# shard in (b) against (a)'s state, relative to the largest entry
TP_FIRST_TOL = 1e-6
# L-SVRG, L-Katyusha, Katyusha and SARAH difference the coefficients of two
# margins, each summed whole (JAX's TP steps: the stacked pair, or the live
# margin against the anchor's), where the single card's plain path takes
# one margin of the difference (``grad_sum_diff_block``); the cancellation
# left SARAH's first outer step 1.05-1.37e-6 off in f32 and L-SVRG's first
# eight int8 steps 1.065e-6 (H100): these are held to 1e-5
TP_PAIR_FIRST_TOL = 1e-5
TP_PAIR_FAMILIES = ("TPLSVRG", "TPLKatyusha", "TPKatyusha", "TPSARAH")
TP_TWO_TOL = 1e-5
# PANOC and ZeroFPR at M = 2 against (c)'s M = 1: the columns' order of
# summation moves the f32 margins by an ulp, and the L-BFGS direction
# amplifies it (the ring's s = Δx, y = Δr and ρ = 1/⟨s, y⟩ difference close
# f32 vectors): after 8 steps at the headline x sat 6.27e-5 off (H100)
# with the envelope f(x), φ_γ(x) bit for bit, and ∇f, which the
# curvature (L_f ~ 1e8) multiplies Δx by, 0.57 of its largest entry off. So
# the envelope's values are held to TP_TWO_TOL, the iterates x, z and x̄ to
# TP_TWO_ITER_TOL (a trial taken differently moves them O(1)), and the
# gradient, the ring and ZeroFPR's last residual are printed, not held
TP_TWO_ITER_TOL = 1e-2
TP_TWO_ITER = ("x", "z", "pbase")
TP_TWO_SHOWN = ("gradx", "S", "Y", "rho", "presid")
TP_GROUPS = {"all-reduce": ("nccl", "AllReduce", "allreduce"),
             "copies": ("Memcpy", "memcpy", "Memset")}
# the cut of each TP state field: the axes of its dimensions
TP_CUT = {"z": ("model",), "av": ("model",), "z_full": ("model",),
          "w": ("model",), "x": ("model",), "y": ("model",),
          "zb": ("data", "model"), "s": ("data",), "c": ("data",),
          "invg": ("data",), "gamma": ("data",), "x_tilde": ("model",),
          "w_anchor": ("model",), "gbar": ("model",), "xg": ("model",),
          "gradx": ("model",), "pbase": ("model",), "presid": ("model",),
          "S": (None, "model"), "Y": (None, "model")}
# ProShI's table holds the blocks' coordinates
TP_CUT_PROSHI = dict(TP_CUT, s=("data", "model"))


def tp_reductions():
    """A counter of the TP path's all-reduces: (counts, restore), the
    module's ``_allreduce`` wrapped until ``restore()``."""
    from ciao_tpu_torch.parallel import tp

    calls = [0]
    inner = tp._allreduce

    def counted(group, x):
        calls[0] += 1
        return inner(group, x)

    tp._allreduce = counted

    def restore():
        tp._allreduce = inner

    return calls, restore


def tp_case(tag: str, solver, F, g, L, x0, single, sched, fields, T: int,
            P: int, unit: str, card: str, setup=None,
            check_cost: bool = True, tol: float = TP_FIRST_TOL) -> dict:
    """One family of (a) or (c): the facade's init and run on the (1, 1)
    mesh; its first steps on ``sched`` held to the single card's plain
    path on the same schedule (``single``: (init(TP init state),
    run(state, steps, sched or None))); T steps timed beside the single
    card's T stepwise steps; the all-reduces a step; a profiled window of
    P steps (device launches a step, idle share); the launches of the 19
    kernels over all of it (``kernels``, which must read 0). ``setup``,
    when given, makes the facade's setup tuple (a splitting facade takes
    h and K); ``check_cost`` holds the cost (1/N)Σf_i + g to a fall."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    if not tag.startswith("("):
        tag = f"(a) {tag}"  # (c)'s tags name their part
    c0 = counts()
    _, _, _, init, _, run, _ = (setup() if setup is not None
                                else solver._setup(x0, F, g, L, None))
    st0 = init()
    s_init, s_run = single
    k = len(sched) if sched is not None else TP_A["check"]
    first = run(st0, k, starts=sched)
    s0 = s_init(st0)
    s1 = s_run(s0, k, sched)
    err = max(rel_gap(getattr(first, f), getattr(s1, f)) for f in fields)
    if not err <= tol:
        raise AssertionError(f"4tp {tag}: the first {k} {unit}s are "
                             f"{err:.3e} off the single card's plain path on "
                             f"their schedule (> {tol})")
    run(st0, 1)
    calls, restore = tp_reductions()
    try:
        st, dt = timed(lambda: run(st0, T))
    finally:
        restore()
    s_run(s0, 1, None)
    _, dt1 = timed(lambda: s_run(s0, T, None))
    sol = st.solution
    if not bool(torch.isfinite(sol).all()):
        raise AssertionError(f"4tp {tag}: a non-finite iterate")
    prof = profile_steps(f"4tp {tag}", lambda: run(st0, P), P, card,
                         TP_GROUPS, unit=unit)
    c1 = counts()
    out = dict(ms=dt * 1e3 / T, single_ms=dt1 * 1e3 / T, err=err,
               reductions=calls[0] / T, steps=T,
               launches=sum(prof["calls"].values()) / P,
               idle=1.0 - prof["busy"] / prof["step"], unit=unit,
               kernels=sum(c1[k] - c0[k] for k in KERNELS))
    if out["kernels"]:
        raise AssertionError(f"4tp {tag}: {out['kernels']} launches of the "
                             "19 kernels")
    if check_cost and isinstance(F, LeastSquaresRows):
        out["cost"] = (cost(F, g, x0), cost(F, g, sol))
        if not out["cost"][1] < out["cost"][0]:
            raise AssertionError(f"4tp {tag}: cost {out['cost']}")
    return out


def tp_headline(mesh, dev, seed: int, card: str) -> dict:
    """(a) at the headline: each family of the TP path beside the single
    card's plain path (f32, and int8 for SAGA, SAG and Finito)."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.sampling import _permutation
    from ciao_tpu_torch.solvers import fb as sfb
    from ciao_tpu_torch.solvers import finito as sfin
    from ciao_tpu_torch.solvers import saga as ssaga
    from ciao_tpu_torch.solvers import svrg as ssvrg
    from ciao_tpu_torch.solvers.svrg import _outer_seed

    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    K, T, P = TP_A["check"], TP_A["steps"], TP_A["profile"]
    d = N // B

    def blocks(sweeping, k=K):
        return tdp._local_round_starts(seed, 1, N, B, k, sweeping, 0, "cpu")

    def as_blocks(sched):
        return None if sched is None else torch.stack(
            [torch.as_tensor(s) for s in sched]) // B

    out = {}
    for storage in ("f32", "int8"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 6_000)
        F, _, L = lasso(gen, dev, N, n, storage)
        gam_i = (0.999 * N / L).float()
        for sag in (False, True):
            scfg = ssaga.SAGACfg(N=N, sag=sag, batch=B, block=True,
                                 coeff=True)
            out[("TPSAG" if sag else "TPSAGA", storage)] = tp_case(
                f"{'TPSAG' if sag else 'TPSAGA'} {storage}",
                parallel.TPSAGA(mesh=mesh, batch=B, SAG_flag=sag, seed=seed),
                F, g, L, x0,
                (lambda st, scfg=scfg: ssaga.saga_init(F, g, x0, st.gamma,
                                                       seed, scfg),
                 lambda s, k, sch, scfg=scfg: ssaga.saga_run(
                     F, g, s, scfg, k, starts=None if sch is None else
                     torch.tensor(sch, dtype=torch.int32, device=dev))),
                blocks(1).tolist(), ("z", "av", "s"), T, P, "step", card)
        fcfg = sfin.FinitoCfg(N=N, batch=B, sweeping=3, alpha=0.999)
        out[("TPFinito", storage)] = tp_case(
            f"TPFinito sweep 3 {storage}",
            parallel.TPFinito(mesh=mesh, batch=B, sweeping=3, seed=seed),
            F, g, L, x0,
            (lambda st: sfin.finito_coeff_init(F, g, x0, gam_i, seed, fcfg),
             lambda s, k, sch: sfin.finito_run(
                 F, g, s, fcfg, "basic_coeff", k, blocks=None if sch is None
                 else torch.tensor(sch) // B)),
            blocks(3).tolist(), ("z", "av", "c"), T, P, "step", card)
        if storage == "int8":
            break
        orders = [_permutation(tdp._rank_seed(seed, 0), 1, d, "cpu").long()
                  * B]
        out[("TPLFinito", storage)] = tp_case(
            f"TPLFinito sweep 3 {storage}",
            parallel.TPLFinito(mesh=mesh, batch=B, sweeping=3, seed=seed),
            F, g, L, x0,
            (lambda st: sfin.lfinito_init(F, g, x0, gam_i, seed, fcfg),
             lambda s, k, sch: sfin.finito_run(
                 F, g, s, fcfg, "lfinito", k, blocks=as_blocks(sch))),
            orders, ("z", "av", "z_full"), TP_A["lfinito"], 1, "epoch", card)
        for plus in (False, True):
            vcfg = ssvrg.SVRGCfg(N=N, plus=plus, batch=B, block=True)
            inner = [tdp._local_round_starts(_outer_seed(seed, it), 1, N, B,
                                             d * 2 ** (it - 1) if plus else d,
                                             1, 0, "cpu") for it in (1,)]
            tag = "TPSVRG++" if plus else "TPSVRG"
            out[(tag, storage)] = tp_case(
                f"{tag} m = {d} {storage}",
                parallel.TPSVRG(mesh=mesh, batch=B, m=d, plus=plus,
                                seed=seed), F, g, L, x0,
                (lambda st, vcfg=vcfg: ssvrg.svrg_init(
                    F, g, x0, st.gamma, d, seed, vcfg),
                 lambda s, k, sch, vcfg=vcfg: ssvrg.svrg_run(
                     F, g, s, vcfg, k, starts=None if sch is None else
                     [t.to(dev, torch.int32) for t in sch])),
                inner, ("z_full", "w", "av"), TP_A["svrg"], 1, "outer step",
                card)
        bcfg = sfb.FBCfg(N=N, fast=True)
        out[("TPFISTA", storage)] = tp_case(
            f"TPFISTA {storage}", parallel.TPFISTA(mesh=mesh), F, g, L, x0,
            (lambda st: sfb.fb_init(F, g, x0, st.gamma, bcfg),
             lambda s, k, sch: sfb.fb_run(F, g, s, bcfg, k)),
            None, ("x", "y"), TP_A["fista"], TP_A["fista_profile"], "step",
            card)
        del F
        torch.cuda.empty_cache()
    out[("TPProshi", "f32")] = tp_proshi_one_rank(mesh, dev, seed, card)
    tp_text("(a)", out, card)
    return out


def tp_text(part: str, out: dict, card: str) -> None:
    """A line for each family of (a) or (c)."""
    for (tag, storage), v in out.items():
        a = "an" if v["unit"][0] in "aeiou" else "a"
        log(f"  4tp {part} {tag} {storage}, one rank over NCCL: "
            f"{v['ms']:.4f} ms {a} {v['unit']} ({v['steps']} {v['unit']}s), "
            f"single card's plain path {v['single_ms']:.4f} "
            f"({v['ms'] / v['single_ms']:.3f}x), {v['reductions']:.2f} "
            f"all-reduces {a} {v['unit']}, {v['launches']:.1f} device "
            f"launches {a} {v['unit']}, idle {v['idle']:.3f}, "
            f"{v['kernels']} launches of the 19 kernels; first "
            f"{v['unit']}s vs the single card {v['err']:.3e}"
            + (f"; cost {v['cost'][0]:.6e} -> {v['cost'][1]:.6e}"
               if "cost" in v else "") + f" [{card}]")


def tp_sharing(dev, N_: int, n_: int):
    """4j's planted sharing problem on the card: (F, g, L, prob)."""
    from ciao_tpu_torch import DiagQuadratic
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_sharing_planted

    prob = make_sharing_planted(N=N_, n=n_, p=SHARING_DEEP["p"], seed=0)
    F = DiagQuadratic(torch.tensor(prob.d, dtype=torch.float32, device=dev),
                      torch.tensor(prob.q, dtype=torch.float32, device=dev))
    g = NormL1(torch.tensor(prob.lam, dtype=torch.float32, device=dev))
    return F, g, torch.tensor(prob.L, dtype=torch.float32, device=dev), prob


def tp_proshi_one_rank(mesh, dev, seed: int, card: str) -> dict:
    """TPProshi (cyclic) on 4j's 65,536 x 128 sharing plant beside the
    single card's stepwise ProShI."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.solvers import proshi as sprox

    c = SHARING_DEEP
    F, g, L, _ = tp_sharing(dev, c["N"], c["n"])
    x0 = torch.zeros(c["n"], device=dev)
    Bp, sw = TP_PROSHI["batch"], TP_PROSHI["sweeping"]
    pcfg = sprox.ProshiCfg(N=c["N"], batch=Bp, sweeping=sw, alpha=0.999)
    gam = 0.999 * c["N"] / L
    sched = tdp._local_round_starts(seed, 1, c["N"], Bp, TP_A["check"], sw,
                                    0, "cpu").tolist()
    return tp_case(
        f"TPProshi on the {c['N']} x {c['n']} sharing plant, batch {Bp}",
        parallel.TPProshi(mesh=mesh, batch=Bp, sweeping=sw, seed=seed),
        F, g, L, x0,
        (lambda st: sprox.proshi_init(F, g, x0, gam, seed, pcfg),
         lambda s, k, sch: sprox.proshi_run(
             F, g, s, pcfg, k, blocks=None if sch is None
             else torch.tensor(sch) // Bp)),
        sched, ("s", "av", "z"), TP_PROSHI["steps"], TP_PROSHI["profile"],
        "step", card)


def tp_deep_one_rank(mesh, dev, card: str, dp_s: float) -> dict:
    """deep_solve_tp on deep_accuracy.py's planted problem (1,048,576 x
    128, B = 8,192) to rel <= 1e-6, beside 4dp (a)'s deep_solve_dp."""
    import numpy as np

    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    P = TP_DEEP
    prob = make_lasso(N=P["N"], n=P["n"], p=P["p"], seed=0, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A, device=dev),
                         torch.tensor(prob.b, device=dev), float(P["N"]))
    g = NormL1(float(prob.lam))
    (x, info), dt = timed(lambda: parallel.deep_solve_tp(
        torch.zeros(P["n"], device=dev), F, g, L=prob.L, N=P["N"],
        mesh=mesh, batch=P["B"], chunk_steps=P["chunk_steps"],
        max_steps=P["max_steps"], plateau_rtol=P["plateau_rtol"],
        gamma=P["gamma_x"] / (3.0 * float(prob.L.max()))))
    rel = (prob.cost(x.double().cpu().numpy()) - prob.f_star) / abs(
        prob.f_star)
    if not (math.isfinite(rel) and rel <= DEEP_REL):
        raise AssertionError(f"4tp deep_solve_tp: rel {rel:.3e} > {DEEP_REL}")
    log(f"  4tp (a) deep_solve_tp, one rank, {P['N']} x {P['n']} at B = "
        f"{P['B']}, gamma {P['gamma_x']:g}/(3 L_max): rel {rel:.3e} in "
        f"{dt:.2f} s ({len(info.staged.objectives)}"
        f" chunks of {P['chunk_steps']} TPSAGA steps, {info.polish_steps} "
        f"polish steps, lambda_max {info.lmax:.4e}); 4dp (a)'s "
        f"deep_solve_dp {dp_s:.2f} s [{card}]")
    return dict(rel=rel, s=dt)


# 4tp (c): the families beyond the reference on one NCCL rank, a (1, 1)
# mesh, at the headline: the loopless pair at p = B/N, Katyusha and SARAH at
# m = N/B inner steps (two outer steps), Point-SAGA (least squares) and SSNM
# (f32 and int8 rows); Davis-Yin (h a box), Condat-Vũ (h = 0.05‖D·‖₁),
# PANOC and ZeroFPR (f32). Each's first steps held to the single card's plain
# path on the same schedule within TP_FIRST_TOL, timed beside it, its
# all-reduces, launches and idle share; then deep_solve_pd_tp on 4y's plants
TP_C = dict(steps=128, profile=16, outer=2, split=32, split_profile=8,
            panoc=16, panoc_profile=4, tv=0.05, box=0.6)


def tp_vr_one_rank(mesh, dev, seed: int, card: str) -> dict:
    """(c)'s block-step families, f32 and int8, beside the single card's
    plain (unfused) solvers."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1, Zero
    from ciao_tpu_torch.solvers import katyusha as sk
    from ciao_tpu_torch.solvers import lsvrg as sl
    from ciao_tpu_torch.solvers import point_saga as sp
    from ciao_tpu_torch.solvers import sarah as ss
    from ciao_tpu_torch.solvers import ssnm as sm
    from ciao_tpu_torch.solvers.lsvrg import draw_coins
    from ciao_tpu_torch.solvers.svrg import _outer_seed

    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    K, T, P, O = TP_A["check"], TP_C["steps"], TP_C["profile"], TP_C["outer"]
    m = N // B
    blocks = tdp._local_round_starts(seed, 1, N, B, K, 1, 0, "cpu").tolist()
    inner = [tdp._local_round_starts(_outer_seed(seed, it), 1, N, B, m, 1, 0,
                                     "cpu") for it in range(1, O + 1)]

    def dev_starts(sch):
        return None if sch is None else torch.tensor(sch, device=dev)

    def coins(st, sch):
        return None if sch is None else draw_coins(seed, 1, len(sch), st.p)

    out = {}
    for storage in ("f32", "int8"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 6_000)
        F, _, L = lasso(gen, dev, N, n, storage)
        lc = sl.LSVRGCfg(N=N, batch=B, block=True)
        kc = sl.LKatyushaCfg(N=N, batch=B, block=True)
        cases = {
            "TPLSVRG": (
                parallel.TPLSVRG(mesh=mesh, batch=B, seed=seed), g,
                (lambda st: sl.lsvrg_init(F, g, x0, st.gamma, st.p, seed, lc),
                 lambda s, k, sch: sl.lsvrg_run(
                     F, g, s, lc, k, starts=dev_starts(sch),
                     coins=coins(s, sch))),
                blocks, ("w", "z", "av"), T, P, "step"),
            "TPLKatyusha": (
                parallel.TPLKatyusha(mesh=mesh, batch=B, seed=seed), g,
                (lambda st: sl.lkatyusha_init(
                    F, g, x0, st.Lmax, st.sigma, st.theta1, st.theta2, st.p,
                    seed, kc),
                 lambda s, k, sch: sl.lkatyusha_run(
                     F, g, s, kc, k, starts=dev_starts(sch),
                     coins=coins(s, sch))),
                blocks, ("y", "z", "w_anchor", "av"), T, P, "step"),
        }
        for name, mod, cls in (("TPKatyusha", sk, parallel.TPKatyusha),
                               ("TPSARAH", ss, parallel.TPSARAH)):
            if mod is sk:
                cfg = sk.KatyushaCfg(N=N, batch=B, m=m, block=True, ns=True)
                s_init = (lambda st, cfg=cfg: sk.katyusha_init(
                    F, g, x0, st.Lmax, st.tau1, st.tau2, seed, cfg))
                s_run = (lambda s, k, sch, cfg=cfg: sk.katyusha_run(
                    F, g, s, cfg, k, starts=None if sch is None else
                    [t.to(dev) for t in sch]))
                fields = ("x_tilde", "y", "z", "av")
            else:
                cfg = ss.SARAHCfg(N=N, batch=B, m=m, block=True)
                s_init = (lambda st, cfg=cfg: ss.sarah_init(
                    F, g, x0, st.gamma, st.eta, seed, cfg))
                s_run = (lambda s, k, sch, cfg=cfg: ss.sarah_run(
                    F, g, s, cfg, k, starts=None if sch is None else
                    [t.to(dev) for t in sch]))
                fields = ("x_tilde",)
            # the first outer step is held, as 4dp (c) holds DP's; O timed
            cases[name] = (cls(mesh=mesh, batch=B, m=m, seed=seed), g,
                           (s_init, s_run), inner[:1], fields, O, 1,
                           "outer step")
        pc = sp.PointSAGACfg(N=N, batch=B, block=True)
        cases["TPPointSAGA"] = (
            parallel.TPPointSAGA(mesh=mesh, batch=B, seed=seed), Zero(),
            (lambda st: sp.point_saga_init(F, Zero(), x0, st.gamma, seed,
                                           pc),
             lambda s, k, sch: sp.point_saga_run(F, Zero(), s, pc, k,
                                                 starts=dev_starts(sch))),
            blocks, ("x", "av", "c"), T, P, "step")
        mc = sm.SSNMCfg(N=N, batch=B)
        cases["TPSSNM"] = (
            parallel.TPSSNM(mesh=mesh, batch=B, seed=seed), g,
            (lambda st: sm.ssnm_init(F, g, x0, st.tau, st.eta, seed, mc),
             lambda s, k, sch: sm.ssnm_run(F, g, s, mc, k,
                                           starts=dev_starts(sch))),
            blocks, ("x", "gbar", "c", "zb"), T, P, "step")
        for name, (solver, gg, single, sched, fields, T_, P_, unit) in (
                cases.items()):
            out[(name, storage)] = tp_case(
                f"(c) {name} {storage}", solver, F, gg, L, x0, single, sched,
                fields, T_, P_, unit, card, tol=TP_PAIR_FIRST_TOL
                if name in TP_PAIR_FAMILIES else TP_FIRST_TOL)
        del F, cases
        torch.cuda.empty_cache()
    return out


def tp_split_one_rank(mesh, dev, seed: int, card: str) -> dict:
    """(c)'s full-gradient families (f32): TPDavisYin (g = λ‖·‖₁, h a box),
    TPCondatVu (K = FirstDifference, h = 0.05‖·‖₁), TPPANOC and TPZeroFPR,
    beside the single card's plain paths."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch.solvers import dys as sdys
    from ciao_tpu_torch.solvers import panoc as spanoc
    from ciao_tpu_torch.solvers import primal_dual as spd

    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6_000)
    F, _, L = lasso(gen, dev, N, n, "f32")
    box = IndBox(-TP_C["box"], TP_C["box"]).to(dev)
    tv = NormL1(torch.tensor(TP_C["tv"], device=dev))
    Kd = FirstDifference()
    T, P = TP_C["split"], TP_C["split_profile"]
    out = {}
    dy = parallel.TPDavisYin(mesh=mesh)
    dc = sdys.DYSCfg(N=N)
    out[("TPDavisYin", "f32")] = tp_case(
        "(c) TPDavisYin f32", dy, F, g, L, x0,
        (lambda st: sdys.dys_init(F, g, box, x0, st.gamma, st.lam, dc),
         lambda s, k, sch: sdys.dys_run(F, g, box, s, dc, k)),
        None, ("xg", "z"), T, P, "step", card,
        setup=lambda: dy._setup(x0, F, g, box, L, None), check_cost=False)
    cv = parallel.TPCondatVu(mesh=mesh)
    pc = spd.PDCfg(N=N)
    out[("TPCondatVu", "f32")] = tp_case(
        "(c) TPCondatVu FirstDifference f32", cv, F, g, L, x0,
        (lambda st: spd.pd_init(F, g, tv, Kd, x0, st.tau, st.sigma, pc),
         lambda s, k, sch: spd.pd_run(F, g, tv, Kd, s, pc, k)),
        None, ("x",), T, P, "step", card,
        setup=lambda: cv._setup(x0, F, g, tv, Kd, L, None), check_cost=False)
    for zerofpr in (False, True):
        tag = "TPZeroFPR" if zerofpr else "TPPANOC"
        cfg = spanoc.PANOCCfg(N=N, zerofpr=zerofpr)
        out[(tag, "f32")] = tp_case(
            f"(c) {tag} f32", parallel.TPPANOC(mesh=mesh, zerofpr=zerofpr),
            F, g, L, x0,
            (lambda st, cfg=cfg: spanoc.panoc_init(F, g, x0, st.gamma,
                                                   st.sigma, cfg),
             lambda s, k, sch, cfg=cfg: spanoc.panoc_run(F, g, s, cfg, k)),
            None, ("x", "z", "gradx"), TP_C["panoc"], TP_C["panoc_profile"],
            "step", card)
    del F
    torch.cuda.empty_cache()
    return out


def tp_deep_pd_one_rank(mesh, dev, seed: int, card: str) -> dict:
    """deep_solve_pd_tp on 4y's two plants (262,144 x 1,024, 16 jumps):
    refined, certified, rel <= DEEP_REL, seconds."""
    from ciao_tpu_torch import parallel

    S = PD_DEEP
    out = {}
    for three in (False, True):
        tag = "three-term" if three else "fused lasso"
        P = pd_problem(dev, seed, three)
        (x, info), dt = timed(lambda: parallel.deep_solve_pd_tp(
            torch.zeros(S["n"], device=dev), P["F"], g=P["g"], h=P["h"],
            K=P["K"], N=S["N"], mesh=mesh, chunk_steps=S["chunk_steps"],
            max_steps=S["max_steps"], refine_chunk=S["chunk"], seed=seed))
        rel, jumps_ok, zeros = pd_rel(P, x, three)
        log(f"  4tp (c) deep_solve_pd_tp {tag}, one rank, {S['N']} x "
            f"{S['n']}: rel {rel:.3e}, refined {info.refined}, certified "
            f"{info.certified}, jump set recovered {jumps_ok}"
            + ("" if zeros is None else f", planted zeros exact {zeros}")
            + f", {info.steps} Condat-Vu steps, {dt:.3f} s [{card}]")
        if not (info.refined and info.certified):
            raise AssertionError(f"4tp (c) deep_solve_pd_tp {tag}: refined "
                                 f"{info.refined}, certified "
                                 f"{info.certified}")
        if not (math.isfinite(rel) and abs(rel) <= DEEP_REL):
            raise AssertionError(f"4tp (c) deep_solve_pd_tp {tag}: rel {rel}")
        if three and not zeros:
            raise AssertionError("4tp (c) deep_solve_pd_tp three-term: a "
                                 "planted zero is not exactly zero")
        out[tag] = dict(rel=rel, s=dt, steps=info.steps)
        del P
        torch.cuda.empty_cache()
    return out


def tp_two_rank_runs(mesh, dev, seed: int) -> dict:
    """(b)'s and (d)'s runs on one mesh (and (a)'s and (c)'s reference of
    them on the (1, 1) mesh): TP_TWO['steps'] steps of TPSAGA (f32, int8)
    and TPFinito, an outer step of TPSVRG at m = TP_TWO['svrg_m'],
    TP_TWO['fista'] TPFISTA steps on the headline's rows, TPProshi on 4j's
    sharing plant; (d): TP_TWO['steps'] steps of TPLSVRG, TPLKatyusha,
    TPPointSAGA and TPSSNM, an outer step of TPKatyusha and TPSARAH at
    m = TP_TWO['svrg_m'], TP_TWO['split'] of TPDavisYin and TPCondatVu
    (FirstDifference: the halo at M = 2) and TP_TWO['panoc'] of TPPANOC
    and TPZeroFPR, with their FBE evaluations counted; each state's
    fields (the rank's shards) on the host. On the (1, 1) mesh also the
    single card's CondatVu of the same data and steps. At D = 1 every
    mesh draws data row 0's schedule, the (1, 1) mesh's."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops.linmap import FirstDifference
    from ciao_tpu_torch.prox import IndBox, NormL1
    from ciao_tpu_torch.solvers import panoc as spanoc

    T = TP_TWO
    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    out = {}

    def fields(st):
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in st._asdict().items()}

    def one(tag, solver, F, gg, L, xx, steps, setup=None):
        _, _, _, init, _, run, _ = (setup() if setup is not None
                                    else solver._setup(xx, F, gg, L, None))
        out[tag] = fields(run(init(), steps))

    for storage in ("f32", "int8"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 6_000)
        F, _, L = lasso(gen, dev, N, n, storage)
        Fp = parallel.shard_finite_sum_2d(F, mesh)
        del F  # the rank keeps only its block
        torch.cuda.empty_cache()
        if storage == "f32":
            out["held"] = dict(rows=Fp.A.untyped_storage().nbytes(),
                               allocated=torch.cuda.memory_allocated(dev))
        one(f"TPSAGA {storage}", parallel.TPSAGA(mesh=mesh, batch=B,
                                                 seed=seed),
            Fp, g, L, x0, T["steps"])
        if storage == "int8":
            break
        one("TPFinito", parallel.TPFinito(mesh=mesh, batch=B, sweeping=3,
                                          seed=seed), Fp, g, L, x0,
            T["steps"])
        one("TPSVRG", parallel.TPSVRG(mesh=mesh, batch=B, m=T["svrg_m"],
                                      seed=seed), Fp, g, L, x0, 1)
        one("TPFISTA", parallel.TPFISTA(mesh=mesh), Fp, g, L, x0, T["fista"])
        for tag, solver in (
                ("TPLSVRG", parallel.TPLSVRG(mesh=mesh, batch=B, seed=seed)),
                ("TPLKatyusha", parallel.TPLKatyusha(mesh=mesh, batch=B,
                                                     seed=seed)),
                ("TPSSNM", parallel.TPSSNM(mesh=mesh, batch=B, seed=seed))):
            one(tag, solver, Fp, g, L, x0, T["steps"])
        one("TPPointSAGA", parallel.TPPointSAGA(mesh=mesh, batch=B,
                                                seed=seed), Fp, None, L, x0,
            T["steps"])
        for tag, cls in (("TPKatyusha", parallel.TPKatyusha),
                         ("TPSARAH", parallel.TPSARAH)):
            one(tag, cls(mesh=mesh, batch=B, m=T["svrg_m"], seed=seed), Fp,
                g, L, x0, 1)
        box = IndBox(-TP_C["box"], TP_C["box"]).to(dev)
        tv = NormL1(torch.tensor(TP_C["tv"], device=dev))
        dy = parallel.TPDavisYin(mesh=mesh)
        one("TPDavisYin", dy, Fp, g, L, x0, T["split"],
            setup=lambda: dy._setup(x0, Fp, g, box, L, None))
        cv = parallel.TPCondatVu(mesh=mesh)
        one("TPCondatVu", cv, Fp, g, L, x0, T["split"],
            setup=lambda: cv._setup(x0, Fp, g, tv, FirstDifference(), L,
                                    None))
        if mesh.size == 1:
            # the single card's plain Condat-Vũ on the same data, steps
            # and stepsizes: the halo's check in (d)
            from ciao_tpu_torch.solvers import primal_dual as spd

            st = out["TPCondatVu"]
            pc = spd.PDCfg(N=N)
            out["CondatVu single"] = dict(x=spd.pd_run(
                Fp, g, tv, FirstDifference(), spd.pd_init(
                    Fp, g, tv, FirstDifference(), x0, st["tau"].to(dev),
                    st["sigma"].to(dev), pc), pc, T["split"]).x.cpu())
        for tag, zerofpr in (("TPPANOC", False), ("TPZeroFPR", True)):
            evals = [0]
            inner = spanoc._eval_fbe

            def counted(*a, **k):
                evals[0] += 1
                return inner(*a, **k)

            spanoc._eval_fbe = counted
            try:
                one(tag, parallel.TPPANOC(mesh=mesh, zerofpr=zerofpr), Fp, g,
                    L, x0, T["panoc"])
            finally:
                spanoc._eval_fbe = inner
            out[tag]["evals"] = evals[0]
        del Fp
    c = SHARING_DEEP
    F, gs, L, _ = tp_sharing(dev, c["N"], c["n"])
    one("TPProshi", parallel.TPProshi(mesh=mesh, batch=TP_PROSHI["batch"],
                                      sweeping=TP_PROSHI["sweeping"],
                                      seed=seed), F, gs, L,
        torch.zeros(c["n"], device=dev), T["proshi"])
    return out


def tp_deep_two(mesh, dev) -> dict:
    """deep_solve_tp on a 131,072 x 128 planted Lasso: rel and the whole
    x."""
    import numpy as np

    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    T = TP_TWO
    prob = make_lasso(N=T["deep_N"], n=128, p=16, seed=0, dtype=np.float32,
                      well_conditioned=True)
    F = LeastSquaresRows(torch.tensor(prob.A, device=dev),
                         torch.tensor(prob.b, device=dev), float(T["deep_N"]))
    x, info = parallel.deep_solve_tp(
        torch.zeros(128, device=dev), F, NormL1(float(prob.lam)), L=prob.L,
        N=T["deep_N"], mesh=mesh, batch=T["deep_B"],
        chunk_steps=T["deep_chunk"], max_steps=T["deep_max"],
        plateau_rtol=1e-4,
        gamma=T["deep_gamma_x"] / (3.0 * float(prob.L.max())))
    rel = (prob.cost(x.double().cpu().numpy()) - prob.f_star) / abs(
        prob.f_star)
    return dict(rel=rel, x=x.cpu(), chunks=len(info.staged.objectives))


def tp_rank_main(rank: int, D: int, store: str, out_dir: str, seed: int):
    """A rank process of (b) and (d): gloo over a FileStore, CUDA tensors
    on the one card; the (1, 2) mesh's runs and deep_solve_tp, then the
    (2, 1) mesh's TPSAGA and TPFISTA, then ``dryrun_multichip(D)``,
    written to out_dir."""
    import datetime

    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, D), rank=rank,
                            world_size=D,
                            timeout=datetime.timedelta(minutes=5))
    try:
        wide = parallel.make_mesh_2d(1, D, device=dev)
        tall = parallel.make_mesh_2d(D, 1, device=dev)
        t0 = time.perf_counter()
        out = dict(wide=tp_two_rank_runs(wide, dev, seed),
                   deep=tp_deep_two(wide, dev), where=(wide.d, wide.m))
        out["wide_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        out["tall"] = tall_runs(tall, dev, seed)
        out["tall_where"] = (tall.d, tall.m)
        torch.cuda.empty_cache()
        from ciao_tpu_torch.entry import dryrun_multichip

        (_, out["dryrun_s"]) = timed(lambda: dryrun_multichip(D, device=dev))
        torch.cuda.synchronize()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tall_runs(mesh, dev, seed: int) -> dict:
    """The (2, 1) mesh's runs: TPSAGA (each data row its own draws) and
    TPFISTA on the headline's rows, each rank its 131,072 rows."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.prox import NormL1

    g = NormL1(torch.tensor(LAM, device=dev))
    x0 = torch.zeros(n, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6_000)
    F, _, L = lasso(gen, dev, N, n, "f32")
    Fp = parallel.shard_finite_sum_2d(F, mesh)
    del F
    out = {}
    for tag, solver, steps in (
            ("TPSAGA", parallel.TPSAGA(mesh=mesh, batch=B // mesh.D,
                                       seed=seed), TP_TWO["steps"]),
            ("TPFISTA", parallel.TPFISTA(mesh=mesh), TP_TWO["fista"])):
        _, _, _, init, _, run, _ = solver._setup(x0, Fp, g, L, None)
        st = run(init(), steps)
        out[tag] = {k: v.cpu() for k, v in st._asdict().items()
                    if isinstance(v, torch.Tensor)}
    return out


def tp_part(v, where: tuple, axes: tuple, D: int, M: int):
    """The rank (d, m)'s part of a whole (1, 1) field cut over ``axes``
    (None: a dimension left whole)."""
    for dim, axis in enumerate(axes if v.dim() else ()):
        if axis is None:
            continue
        parts, at = (D, where[0]) if axis == "data" else (M, where[1])
        k = v.shape[dim] // parts
        v = v.narrow(dim, at * k, k)
    return v


def tp_two_ranks(ref: dict, seed: int, card: str) -> dict:
    """(b): TP_TWO['ranks'] processes on the one card over gloo. (1, 2):
    each rank's shards of each family held to the slice of (a)'s (1, 1)
    state of the same data and schedule (``ref``), the fields that are
    whole on every rank (the tables at D = 1, the scalars) bit for bit
    across the ranks, deep_solve_tp's rel and x. (2, 1): TPFISTA held to
    (a)'s, TPSAGA's replicated vectors bit for bit across the ranks."""
    import tempfile

    import torch.multiprocessing as mp

    D = TP_TWO["ranks"]
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.perf_counter()
        mp.start_processes(tp_rank_main,
                           args=(D, os.path.join(tmp, "store"), tmp, seed),
                           nprocs=D, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(D)]
    worst = {}
    single_cv = ref.pop("CondatVu single")["x"]
    for fam, want in ref.items():
        cut = TP_CUT_PROSHI if fam == "TPProshi" else TP_CUT
        pairs = fam in ("TPPANOC", "TPZeroFPR")
        e = e_iter = 0.0
        for o in outs:
            got = o["wide"][fam]
            for f, v in got.items():
                if not isinstance(v, torch.Tensor) or not v.numel():
                    continue
                part = tp_part(want[f], o["where"], cut.get(f, ()), 1, D)
                if part.shape != v.shape:
                    raise AssertionError(f"4tp (b) {fam}: {f} of rank "
                                         f"{o['where']} is {tuple(v.shape)}, "
                                         f"not {tuple(part.shape)}")
                if pairs and f in TP_TWO_SHOWN:
                    worst[f"{fam} {f}"] = max(worst.get(f"{fam} {f}", 0.0),
                                              rel_gap(v, part))
                elif pairs and f in TP_TWO_ITER:
                    e_iter = max(e_iter, rel_gap(v, part))
                else:
                    e = max(e, rel_gap(v, part))
                if "model" not in cut.get(f, ()) and not torch.equal(
                        v, outs[0]["wide"][fam][f]):
                    raise AssertionError(f"4tp (b) {fam}: {f} differs "
                                         f"between the ranks")
        if not (e <= TP_TWO_TOL and e_iter <= TP_TWO_ITER_TOL):
            bad = {f: rel_gap(v, tp_part(want[f], o["where"], cut.get(f, ()),
                                         1, D))
                   for o in outs for f, v in o["wide"][fam].items()
                   if isinstance(v, torch.Tensor) and v.numel()}
            raise AssertionError(f"4tp (b) {fam}: a rank's shard is {e:.3e} "
                                 f"off (a)'s state (> {TP_TWO_TOL}), the "
                                 f"iterates {e_iter:.3e}: {bad}")
        worst[fam] = e
        if pairs:
            worst[fam + " iterates"] = e_iter
    # (d): the halo's Condat-Vũ against the single card's, and PANOC's and
    # ZeroFPR's FBE evaluations on both ranks
    e = 0.0
    for o in outs:
        x = o["wide"]["TPCondatVu"]["x"]
        e = max(e, rel_gap(x, tp_part(single_cv, o["where"], ("model",), 1,
                                      D)))
    if not e <= TP_TWO_TOL:
        raise AssertionError(f"4tp (d) TPCondatVu at M = {D}: {e:.3e} off "
                             f"the single card's CondatVu (> {TP_TWO_TOL})")
    worst["TPCondatVu vs CondatVu"] = e
    evals = {fam: [o["wide"][fam]["evals"] for o in outs]
             for fam in ("TPPANOC", "TPZeroFPR")}
    for fam, ev in evals.items():
        if len(set(ev)) != 1:
            raise AssertionError(f"4tp (d) {fam}: the ranks took {ev} FBE "
                                 "evaluations")
    dry_s = max(o["dryrun_s"] for o in outs)
    deep = [o["deep"] for o in outs]
    if not torch.equal(deep[0]["x"], deep[1]["x"]):
        raise AssertionError("4tp (b) deep_solve_tp: x differs between the "
                             "ranks")
    if not (math.isfinite(deep[0]["rel"]) and deep[0]["rel"] <= DEEP_REL):
        raise AssertionError(f"4tp (b) deep_solve_tp: rel {deep[0]['rel']}")
    fista_ref = ref["TPFISTA"]["x"]
    for o in outs:
        tall = o["tall"]
        e = rel_gap(tall["TPFISTA"]["x"], fista_ref)
        if not e <= TP_TWO_TOL:
            raise AssertionError(f"4tp (b) (2, 1) TPFISTA: {e:.3e} off (a)")
        worst["TPFISTA (2, 1)"] = max(worst.get("TPFISTA (2, 1)", 0.0), e)
        for f in ("z", "av"):
            if not torch.equal(tall["TPSAGA"][f], outs[0]["tall"]["TPSAGA"][f]):
                raise AssertionError(f"4tp (b) (2, 1) TPSAGA: {f} differs "
                                     f"between the ranks")
        if not bool(torch.isfinite(tall["TPSAGA"]["z"]).all()):
            raise AssertionError("4tp (b) (2, 1) TPSAGA: a non-finite z")
    held = outs[0]["wide"]["held"]
    log(f"  4tp (b)/(d) {D} ranks on the one card over gloo (CUDA tensors): "
        f"(1, {D}), each rank {N} x {n // D} of the headline's rows "
        f"({held['rows'] / 2 ** 20:.1f} MiB, "
        f"{held['allocated'] / 2 ** 20:.1f} MiB allocated after the cut), "
        f"largest gap of a rank's shard to (a)'s or (c)'s state: "
        + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items())
        + f"; the whole fields bit for bit across the ranks; deep_solve_tp "
        f"{TP_TWO['deep_N']} x 128 at (1, {D}): rel {deep[0]['rel']:.3e} in "
        f"{deep[0]['chunks']} chunks, x bit for bit on both ranks; (2, 1): "
        f"TPSAGA's z and av bit for bit across the ranks; (d) PANOC and "
        f"ZeroFPR took {evals['TPPANOC'][0]} and {evals['TPZeroFPR'][0]} FBE "
        f"evaluations on each rank, dryrun_multichip({D}) on the {D} ranks "
        f"{dry_s:.2f} s; (1, {D}) runs "
        f"{outs[0]['wide_s']:.2f} s, {wall:.2f} s with the spawn [{card}]")
    return dict(worst=worst, deep_rel=deep[0]["rel"], s=wall, dryrun_s=dry_s,
                evals={k: v[0] for k, v in evals.items()})


def run_tp(dev, seed: int, card: str, dp_deep_s: float) -> dict:
    """Phase 4tp: (a) and (c) one rank over NCCL on a (1, 1) mesh, (b) and
    (d) two ranks on the one card over gloo on (1, 2) and (2, 1) meshes."""
    import tempfile

    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh_2d(1, 1, device=dev)
            head = tp_headline(mesh, dev, seed, card)
            torch.cuda.empty_cache()
            deep = tp_deep_one_rank(mesh, dev, card, dp_deep_s)
            torch.cuda.empty_cache()
            t_c = time.perf_counter()
            new = tp_vr_one_rank(mesh, dev, seed, card)
            new.update(tp_split_one_rank(mesh, dev, seed, card))
            tp_text("(c)", new, card)
            deep_pd = tp_deep_pd_one_rank(mesh, dev, seed, card)
            t_c = time.perf_counter() - t_c
            torch.cuda.empty_cache()
            ref = tp_two_rank_runs(mesh, dev, seed)
            ref.pop("held")
        finally:
            dist.destroy_process_group()
    t_a = time.perf_counter() - t0
    torch.cuda.empty_cache()
    two = tp_two_ranks(ref, seed, card)
    return dict(head=head, deep=deep, new=new, deep_pd=deep_pd, two=two,
                s_a=t_a - t_c, s_c=t_c, s_b=time.perf_counter() - t0 - t_a,
                s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# 4sc: the sharded checkpoint (save_async(..., mesh=), load_orbax) at the
# headline's width: (c)'s one-rank checkpoint in this process, then two
# ranks on the one card over gloo for (a), the full table, (c) and (d),
# then (b) back in this process on one rank
# ---------------------------------------------------------------------------

# DPSAGA's local rounds (K steps a round, one kernel #3 launch a rank) as
# bench.py's DP rounds run them; rounds before the save, rounds stepped
# while the write runs, rounds compared after it; TP block steps
SC = dict(K=32, rounds=3, overlap=2, more=3, full_steps=1, tp_steps=2,
          seed=6_000)


def sc_problem(dev, seed: int):
    """The headline's f32 rows, the same on every rank and process."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + SC["seed"])
    return lasso(gen, dev, N, n, "f32")


def sc_stream(mesh, F, L, **kw):
    """A DPSAGA iterator on the rank's part of the headline: local rounds
    by default, ``table="full"`` for the (N/D, n) table."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.prox import NormL1

    dev = mesh.device
    if not kw:
        kw = dict(local_steps=SC["K"], rebase_every=50)
    solver = parallel.DPSAGA(mesh=mesh, batch=B, block_sampling=True,
                             seed=7, **kw)
    return solver.iterator(torch.zeros(n, device=dev), F=F,
                           g=NormL1(torch.tensor(LAM, device=dev)), L=L)


def sc_cost(mesh, F, z) -> float:
    """The global objective at z from the rank's rows (one all-reduce)."""
    from ciao_tpu_torch.parallel.dp import _psum

    return float(_psum(mesh, F.value_sum_all(z)) / N
                 + LAM * z.abs().sum())


def sc_equal(a, b, fields, tag: str) -> None:
    """Raise unless each of ``fields`` is bit for bit the same in the
    states ``a`` and ``b``."""
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x, y):
            gap = float((x.double() - y.double()).abs().max())
            raise AssertionError(f"4sc {tag}: {f} differs, max |d| "
                                 f"{gap:.3e}")


def sc_resume(mesh, it, like, path, more: int, tag: str):
    """load_orbax of ``path`` into ``like`` on ``mesh`` (timed), then
    ``more`` rounds resumed from it: (restored, resumed, seconds, the
    launches of kernel #3 in the resume, cost before and after)."""
    from ciao_tpu_torch import checkpoint

    restored, dt = timed(lambda: checkpoint.load_orbax(path, like,
                                                       mesh=mesh))
    c0 = counts()["saga_coeff_multistep"]
    res = checkpoint.resume_iterator(it, restored)
    st = next(res)
    for _ in range(more):
        st = next(res)
    torch.cuda.synchronize()
    return dict(restored=restored, resumed=st, s=dt,
                launches=counts()["saga_coeff_multistep"] - c0)


def sc_two_rank_runs(mesh, seed: int, tmp: str, grow_dir: str) -> dict:
    """One rank's part: (c) the one-rank checkpoint restored here and
    resumed; (a) the local rounds saved while stepping on, restored on
    the same mesh and resumed, and the full (N/D, n) table saved and
    restored, timed; (d) a TPSAGA state on the (1, 2) mesh."""
    import torch.distributed as dist

    from ciao_tpu_torch import checkpoint, parallel
    from ciao_tpu_torch.prox import NormL1

    dev = mesh.device
    out = {"launches": Count(0)}
    F, _, L = sc_problem(dev, seed)
    Fd = parallel.shard_finite_sum(F, mesh)
    del F
    torch.cuda.empty_cache()

    # (c) grow: the one-rank state onto the two ranks
    it = sc_stream(mesh, Fd, L)
    like = next(iter(it))
    r = sc_resume(mesh, it, like, grow_dir, SC["more"], "(c)")
    out["grow"] = dict(s=r["restored"].s.cpu(), z=r["restored"].z.cpu(),
                       load_s=r["s"], launches=int(r["launches"]),
                       cost0=sc_cost(mesh, Fd, r["restored"].z),
                       cost1=sc_cost(mesh, Fd, r["resumed"].z))
    out["launches"] += r["launches"]

    # (a) same mesh: save while the solver steps on, restore, resume
    c0 = counts()["saga_coeff_multistep"]
    stream = iter(it)
    st = next(stream)
    for _ in range(SC["rounds"]):
        st = next(stream)
    path = os.path.join(tmp, "a")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr = checkpoint.save_async(path, st, mesh=mesh)
    t_call = time.perf_counter() - t0
    live = st
    for _ in range(SC["overlap"]):
        live = it._step_fn(live)
    mgr.wait_until_finished()
    t_save = time.perf_counter() - t0
    straight = st
    for _ in range(SC["more"]):
        straight = it._step_fn(straight)
    torch.cuda.synchronize()
    out["launches"] += counts()["saga_coeff_multistep"] - c0
    r = sc_resume(mesh, it, next(iter(it)), path, SC["more"], "(a)")
    sc_equal(r["restored"], st, ("s", "z", "av", "gamma"), "(a) restored")
    if (r["restored"].seed, r["restored"].it) != (st.seed, st.it):
        raise AssertionError("4sc (a): seed or it differ after the restore")
    sc_equal(r["resumed"], straight, ("z", "av", "s"), "(a) resumed")
    if r["launches"] != SC["more"]:
        raise AssertionError(f"4sc (a): {r['launches']} kernel #3 launches "
                             f"in {SC['more']} resumed rounds")
    out["launches"] += r["launches"]
    out["same"] = dict(s=st.s.cpu(), z=st.z.cpu(), av=st.av.cpu(),
                       save_call_s=t_call, save_s=t_save, load_s=r["s"],
                       launches=int(r["launches"]),
                       bytes=os.path.getsize(os.path.join(
                           path, f"shard-{mesh.rank}-0.pt")))
    del it, st, live, straight, r

    # the full (N/D, n) table: 512 MiB a rank of f32
    itf = sc_stream(mesh, Fd, L, table="full")
    stream = iter(itf)
    st = next(stream)
    for _ in range(SC["full_steps"]):
        st = next(stream)
    path = os.path.join(tmp, "full")
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    checkpoint.save_async(path, st, mesh=mesh).wait_until_finished()
    t_save = time.perf_counter() - t0
    like = next(iter(itf))
    dist.barrier()
    back, t_load = timed(lambda: checkpoint.load_orbax(path, like,
                                                       mesh=mesh))
    sc_equal(back, st, ("s", "z", "av"), "full table restored")
    nbytes = os.path.getsize(os.path.join(path, f"shard-{mesh.rank}-0.pt"))
    out["full"] = dict(save_s=t_save, load_s=t_load, bytes=nbytes,
                       table=st.s.numel() * st.s.element_size())
    del itf, st, back, like
    torch.cuda.empty_cache()

    # (d) TPSAGA on the (1, 2) mesh: the rank's 512 columns of every row
    m2 = parallel.make_mesh_2d(1, 2, device=dev)
    del Fd
    F, _, L = sc_problem(dev, seed)
    F2 = parallel.shard_finite_sum_2d(F, m2, N)
    del F
    torch.cuda.empty_cache()
    tp = parallel.TPSAGA(mesh=m2, batch=B, seed=9)
    it = tp.iterator(torch.zeros(n, device=dev), F=F2,
                     g=NormL1(torch.tensor(LAM, device=dev)), L=L)
    stream = iter(it)
    st = next(stream)
    for _ in range(SC["tp_steps"]):
        st = next(stream)
    path = os.path.join(tmp, "tp")
    (_, t_save) = timed(lambda: checkpoint.save_async(
        path, st, mesh=m2).wait_until_finished())
    straight = it._step_fn(st)
    back = checkpoint.load_orbax(path, next(iter(it)), mesh=m2)
    sc_equal(back, st, ("s", "z", "av", "gamma"), "(d) restored")
    resumed = it._step_fn(back)
    sc_equal(resumed, straight, ("s", "z", "av"), "(d) resumed")
    out["tp"] = dict(save_s=t_save, cols=int(st.z.numel()),
                     rows=int(st.s.numel()))
    # plain ints: this module is another one in the spawning process
    out["launches"] = (int(out["launches"]), out["launches"].steps)
    return out


def sc_rank_main(rank: int, D: int, store: str, tmp: str, seed: int,
                 grow_dir: str):
    """A rank process of 4sc: gloo over a FileStore, CUDA tensors on the
    one card, its results written to tmp."""
    import datetime

    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, D), rank=rank,
                            world_size=D,
                            timeout=datetime.timedelta(minutes=5))
    try:
        mesh = parallel.make_mesh(device="cuda:0")
        out = sc_two_rank_runs(mesh, seed, tmp, grow_dir)
        torch.cuda.synchronize()
        torch.save(out, os.path.join(tmp, f"sc_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sc_one_rank(dev, tmp: str):
    """A one-rank NCCL group and its mesh (the caller destroys it)."""
    import torch.distributed as dist

    from ciao_tpu_torch import parallel

    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, f"store1-{time.time_ns()}"), 1), rank=0,
        world_size=1)
    return parallel.make_mesh(device=dev)


def run_sharded_ckpt(dev, seed: int, card: str) -> dict:
    """Phase 4sc. (c) first half: DPSAGA's local rounds on one rank here,
    saved with ``save_async(..., mesh=)``; then two gloo ranks on the one
    card (131,072 headline rows each) run (c) (that state restored onto
    them and resumed), (a) (a same-mesh resume bit for bit, saved while
    the solver steps on) and the full table's timed save and load, and
    (d) (TPSAGA on the (1, 2) mesh, bit for bit); (b) back here: (a)'s
    checkpoint restored onto one rank and resumed. Returns the numbers
    and the path's kernel #3 launches."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from ciao_tpu_torch import checkpoint, parallel

    t0 = time.perf_counter()
    out = {"launches": Count(0)}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        grow_dir = os.path.join(tmp, "one")
        F, _, L = sc_problem(dev, seed)
        mesh = sc_one_rank(dev, tmp)
        try:
            c0 = counts()["saga_coeff_multistep"]
            it = sc_stream(mesh, parallel.shard_finite_sum(F, mesh), L)
            stream = iter(it)
            st = next(stream)
            for _ in range(SC["rounds"]):
                st = next(stream)
            checkpoint.save_async(grow_dir, st, mesh=mesh) \
                .wait_until_finished()
            torch.cuda.synchronize()
            out["launches"] += counts()["saga_coeff_multistep"] - c0
            one_s, one_z = st.s.cpu(), st.z.cpu()
            del it, stream, st
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        t_spawn = time.perf_counter()
        mp.start_processes(sc_rank_main,
                           args=(2, os.path.join(tmp, "store2"), tmp, seed,
                                 grow_dir),
                           nprocs=2, join=True, start_method="spawn")
        wall = time.perf_counter() - t_spawn
        outs = [torch.load(os.path.join(tmp, f"sc_rank{r}.pt"),
                           weights_only=False) for r in range(2)]
        for o in outs:
            out["launches"] += Count(*o["launches"])
        # (c): the two ranks' rows are the one rank's table, bit for bit
        grown = torch.cat([o["grow"]["s"] for o in outs])
        if not (torch.equal(grown, one_s)
                and all(torch.equal(o["grow"]["z"], one_z) for o in outs)):
            raise AssertionError("4sc (c): the grown table or z differs from "
                                 "the one-rank state")
        for o in outs:
            g_ = o["grow"]
            if not (g_["cost1"] < g_["cost0"] and g_["launches"] > 0):
                raise AssertionError(f"4sc (c): resumed cost {g_['cost0']} "
                                     f"-> {g_['cost1']}, {g_['launches']} "
                                     f"launches")
        # (b) shrink: (a)'s two-rank checkpoint onto one rank here
        mesh = sc_one_rank(dev, tmp)
        try:
            Fd = parallel.shard_finite_sum(F, mesh)
            del F
            it = sc_stream(mesh, Fd, L)
            r = sc_resume(mesh, it, next(iter(it)), os.path.join(tmp, "a"),
                          SC["more"], "(b)")
            saved = torch.cat([o["same"]["s"] for o in outs])
            if not (torch.equal(r["restored"].s.cpu(), saved)
                    and torch.equal(r["restored"].z.cpu(),
                                    outs[0]["same"]["z"])
                    and torch.equal(r["restored"].av.cpu(),
                                    outs[0]["same"]["av"])):
                raise AssertionError("4sc (b): the restored table, z or av "
                                     "differs from the two ranks' state")
            shrink = dict(load_s=r["s"], launches=int(r["launches"]),
                          cost0=sc_cost(mesh, Fd, r["restored"].z),
                          cost1=sc_cost(mesh, Fd, r["resumed"].z))
            if not (shrink["cost1"] < shrink["cost0"] and r["launches"] > 0):
                raise AssertionError(f"4sc (b): {shrink}")
            out["launches"] += r["launches"]
            del it, r, Fd
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    out.update(outs=outs, shrink=shrink, wall=wall,
               s=time.perf_counter() - t0)
    fu = [o["full"] for o in outs]
    sa = [o["same"] for o in outs]
    together = (sum(f["bytes"] for f in fu) / max(f["save_s"] for f in fu)
                / 1e9)
    log(f"  4sc (a) two gloo ranks on the one card, {N // 2} headline rows "
        f"each: DPSAGA local rounds (K = {SC['K']}, kernel #3) saved with "
        f"save_async(mesh=) while {SC['overlap']} rounds ran on (the call "
        + "/".join(f"{s['save_call_s']:.3f}" for s in sa) + " s, the write "
        + "/".join(f"{s['save_s']:.3f}" for s in sa) + " s), restored in "
        + "/".join(f"{s['load_s']:.3f}" for s in sa) + f" s and resumed "
        f"{SC['more']} rounds bit for bit in z, av and s "
        f"({sa[0]['launches']} kernel #3 launches a rank); the full table "
        f"({fu[0]['table'] / 2**20:.0f} MiB a rank) saved in "
        + "/".join(f"{f['save_s']:.3f}" for f in fu) + " s ("
        + "/".join(f"{f['bytes'] / f['save_s'] / 1e9:.2f}" for f in fu)
        + f" GB/s a rank, {together:.2f} together), loaded in "
        + "/".join(f"{f['load_s']:.3f}" for f in fu) + " s ("
        + "/".join(f"{f['bytes'] / f['load_s'] / 1e9:.2f}" for f in fu)
        + " GB/s a rank, warm page cache), bit for bit [" + card + "]")
    log(f"  4sc (b) (a)'s checkpoint onto one rank: the {N}-row "
        f"coefficient table, z and av bit for bit the two ranks', restored in "
        f"{shrink['load_s']:.3f} s, cost {shrink['cost0']:.6f} -> "
        f"{shrink['cost1']:.6f} over {SC['more']} rounds; (c) a one-rank "
        f"checkpoint onto two ranks: restored in "
        + "/".join(f"{o['grow']['load_s']:.3f}" for o in outs)
        + f" s, the rows bit for bit the one rank's, cost "
        f"{outs[0]['grow']['cost0']:.6f} -> {outs[0]['grow']['cost1']:.6f};"
        f" (d) TPSAGA on (1, 2), {outs[0]['tp']['cols']} columns a rank, "
        f"saved in " + "/".join(f"{o['tp']['save_s']:.3f}" for o in outs)
        + f" s, restored and resumed bit for bit; spawn {wall:.2f} s, "
        f"all {out['s']:.2f} s [{card}]")
    return out


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
                    for k, v in spf.items() if k not in ("s", "repeat"))
        + f"; two builds of it at --seed bit-equal in all {spf['repeat']} "
        f"fields (support, x*, f*, L, both layouts)"
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

    # 4z. complex rows and iterates (no kernel by design), counts from 0
    t0 = time.perf_counter()
    reset_counts()
    cx = run_complex(dev, args.seed, ceil, card)
    c = counts()
    if sum(c.values()):
        raise AssertionError(f"the complex route launched kernels: {c}")
    log(f"phase 4z complex route: ok, none of the {len(c)} kernels launched; "
        f"at {COMPLEX['N']} x {COMPLEX['n']} complex64, FISTA to rel "
        f"{COMPLEX['rel']:g} in {cx['fista']['steps']} steps, "
        f"{cx['fista']['s']:.3f} s; " + "; ".join(
            f"{k} {v['ms']:.4f} ms/step (bound {v['bound_ms']:.4f}), "
            f"{v['launches']:.1f} launches/step, idle {v['idle']:.3f}"
            for k, v in cx["runs"].items())
        + "; " + ", ".join(
            f"{k} step vs complex128 error/slip {v['check']['ratio']:.2e}"
            for k, v in cx["runs"].items() if v["check"])
        + f"; CustomOracle Welsch SARAH max err "
        f"{cx['compose']['SARAH']['err']:.3e}, PANOC "
        f"{cx['compose']['PANOC']['err']:.3e}; Precompose rel err "
        f"{cx['compose']['precompose_err']:.2e}; TF32 changes complex64 "
        f"products by {cx['tf32']['on']:.2e} (off {cx['tf32']['off']:.2e}); "
        f"all {time.perf_counter() - t0:.2f} s [{card}]")
    torch.cuda.empty_cache()

    # 4ck. checkpoints, counts from 0 in each part
    ck = run_checkpoints(gen, dev, args.seed, card)
    for part in (ck["headline"], ck["full"]["launches"],
                 *(v["launches"] for v in ck["facades"].values())):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    fu = ck["full"]
    exact = [k for k, v in ck["facades"].items() if v["err"] == 0.0]
    log(f"phase 4ck checkpoints: ok; headline SAGA split at a launch "
        f"boundary bit for bit; the {fu['bytes'] / 2**30:.3f} GiB full-table "
        f"state saved in {fu['save_s']:.3f} s "
        f"({fu['bytes'] / fu['save_s'] / 1e9:.2f} GB/s), loaded in "
        f"{fu['load_s']:.3f} s ({fu['bytes'] / fu['load_s'] / 1e9:.2f} "
        f"GB/s); SAGA full table {fu['cold']['ms']:.4f} ms/step beside an "
        f"async write (the first), {fu['warm']['ms']:.4f} (a later one), "
        f"{fu['without_ms']:.4f} with none, the async files == their "
        f"snapshots and the resume == the straight run bit for bit; "
        f"rebase within {ck['rebase']:.3e}; {len(exact)} of "
        f"{len(ck['facades'])} resumes bit for bit ({', '.join(exact)}), "
        f"the sparse one within "
        f"{ck['facades']['sparse ELL SAGA']['err']:.3e}; {ck['s']:.2f} s "
        f"[{card}]")

    # 4ex. the entry point and the examples, counts from 0 in each
    t0 = time.perf_counter()
    ex = run_examples(card)
    two = ex.pop("multihost x2")
    lock = ex.pop("lockstep")
    for r in ex.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    log(f"phase 4ex entry point and examples: ok; entry() it = "
        f"{ex['entry']['it']} on one kernel #4 launch, named in its "
        f"profiler_trace; " + "; ".join(
            example_text(k, v) for k, v in ex.items() if k != "entry")
        + f"; lockstep DPSAGA on one NCCL rank {lock['ms']:.4f} ms/step; "
        f"multihost.py as two processes over gloo {two['s']:.2f} s, beside "
        f"the parallel examples; all {time.perf_counter() - t0:.2f} s "
        f"[{card}]")

    # 4dp. the data-parallel path: (a) one rank over NCCL, (b) two ranks on
    # the one card over gloo; counts from 0, the comparison runs excluded
    reset_counts()
    dp = run_dp(dev, gen, args.seed, card)
    for k, v in dp["launches"].items():
        launches[k] = launches.get(k, 0) + v
        if v == 0:
            raise AssertionError(f"4dp: the DP path launched no {k}")
    log(f"phase 4dp data-parallel path: ok; DPSAGA f32 "
        f"{dp['saga']['f32']['ms']:.5f} ms/step (single-card "
        f"{dp['saga']['f32']['single_ms']:.5f}), int8 "
        f"{dp['saga']['int8']['ms']:.5f} (single-card "
        f"{dp['saga']['int8']['single_ms']:.5f}); SVRG++ local inner "
        f"{dp['svrg']['ms']:.5f} ms/inner step on #5/#6, "
        f"{dp['svrg']['plain_ms']:.5f} plain; deep_solve_dp rel "
        f"{dp['deep']['rel']:.3e} in {dp['deep']['s']:.2f} s; " + "; ".join(
            f"{DQ_LABEL[k]} {s_} local inner {v['ms']:.5f} ms/inner step "
            f"(single-card fused {v['single_ms']:.5f}), first outer step "
            f"{v['err']:.3e} off"
            for (k, s_), v in dp["vr"].items())
        + f"; deep_solve_pd_dp rel {dp['deep_pd']['rel']:.3e} in "
        f"{dp['deep_pd']['s']:.2f} s (4y's deep_solve_pd "
        f"{pd['fused lasso']['s']:.2f} s, rel "
        f"{pd['fused lasso']['rel']:.3e}); DP launches "
        + json.dumps(dp["launches"]) + f"; (a) {dp['s_a']:.2f} s, (c) "
        f"{dp['s_c']:.2f} s, (b) {dp['s_b']:.2f} s, all {dp['s']:.2f} s "
        f"[{card}]")

    # 4tp. the tensor-parallel path (no kernel by design): (a) one rank over
    # NCCL on a (1, 1) mesh, (b) two ranks on the one card over gloo; counts
    # from 0
    reset_counts()
    tpr = run_tp(dev, args.seed, card, dp["deep"]["s"])
    c = counts()
    if sum(c.values()):
        raise AssertionError(f"the tensor-parallel path launched kernels: "
                             f"{ {k: v for k, v in c.items() if v} }")
    log(f"phase 4tp tensor-parallel path: ok, none of the {len(c)} kernels "
        f"launched; " + "; ".join(
            f"{tag} {s_} {v['ms']:.4f} ms per {v['unit']} (single card's "
            f"plain path {v['single_ms']:.4f}), {v['reductions']:.2f} "
            f"all-reduces and {v['launches']:.1f} launches per {v['unit']}, idle "
            f"{v['idle']:.3f}, first {v['unit']}s {v['err']:.2e} off"
            for (tag, s_), v in {**tpr["head"], **tpr["new"]}.items())
        + f"; deep_solve_tp rel {tpr['deep']['rel']:.3e} in "
        f"{tpr['deep']['s']:.2f} s (deep_solve_dp {dp['deep']['s']:.2f} s); "
        + "; ".join(
            f"deep_solve_pd_tp {k} rel {v['rel']:.3e} in {v['s']:.2f} s "
            f"({v['steps']} steps; 4y's deep_solve_pd {pd[k]['s']:.2f} s)"
            for k, v in tpr["deep_pd"].items())
        + f" (4dp's deep_solve_pd_dp, fused lasso, {dp['deep_pd']['s']:.2f} "
        f"s); (b)/(d) deep_solve_tp rel {tpr['two']['deep_rel']:.3e}, shards "
        f"within {max(tpr['two']['worst'].values()):.2e} of (a)/(c), "
        f"dryrun_multichip(2) {tpr['two']['dryrun_s']:.2f} s; (a) "
        f"{tpr['s_a']:.2f} s, (c) {tpr['s_c']:.2f} s, (b)/(d) "
        f"{tpr['s_b']:.2f} s, all {tpr['s']:.2f} s [{card}]")

    # 4sc. the sharded checkpoint at the headline's width: kernel #3's
    # launches of the DP path through it, counts from 0
    reset_counts()
    sc = run_sharded_ckpt(dev, args.seed, card)
    launches["saga_coeff_multistep"] += sc["launches"]
    if sc["launches"] == 0:
        raise AssertionError("4sc: the path launched no kernel #3")
    log(f"phase 4sc sharded checkpoint: ok; same-mesh resumes bit for bit "
        f"(DPSAGA on two ranks, TPSAGA on (1, 2)), the tables bit for bit "
        f"across 2 -> 1 and 1 -> 2 ranks; full table save "
        + "/".join(f"{o['full']['bytes'] / o['full']['save_s'] / 1e9:.2f}"
                   for o in sc["outs"])
        + " GB/s, load "
        + "/".join(f"{o['full']['bytes'] / o['full']['load_s'] / 1e9:.2f}"
                   for o in sc["outs"])
        + f" GB/s a rank; {int(sc['launches'])} kernel #3 launches; "
        f"{sc['s']:.2f} s [{card}]")

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
