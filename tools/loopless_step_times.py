#!/usr/bin/env python3
"""Times the kernels of the persistent engine (``csrc/loopless_steps.cuh``)
of one checkout of the port on one NVIDIA GPU, so that two versions can be
compared in one call: #16 (``lsvrg_coeff_multistep``) and #17
(``lkatyusha_coeff_multistep``), #5 (``svrg_coeff_multistep``), #10
(``katyusha_coeff_multistep``), #11 (``sarah_multistep``) and #9
(``finito_coeff_multistep``), #3 (``saga_coeff_multistep``), #12
(``point_saga_multistep``) and #19 (``ssnm_multistep``) at the headline,
#4 (``saga_coeff_multistep_streamed``), #8 (``lfinito_sweep_multistep``),
#14 (``finito_coeff_multistep_streamed``), #13
(``ssnm_multistep_streamed``) and #15 (``point_saga_multistep_streamed``)
at the deep target, and #18 (``proshi_multistep``) at the ProShI
configuration.

    python3 tools/loopless_step_times.py [--root DIR] [--tag NAME] [--seed 0]
        [--kernels 16,17,5,4,10,11,9,8,18,14,3,12,19,13,15] [--profile]

Builds the kernels from ``DIR/ciao_tpu_torch/csrc`` (default: this
checkout; all at once, one ``nvcc`` each) with that checkout's
``ops/_build.py`` and imports that checkout's wrappers; the inputs and
helpers are this checkout's ``chip_smoke.py`` (``vr_inputs``,
``vr_scalars``, ``vr_call``, ``svrg_inputs``, ``kernel_inputs``,
``finito_inputs``, ``lfinito_inputs``, ``proshi_inputs``,
``run_proshi_kernel``, ``row_oracle``, ``ps_inputs``, ``ps_call``,
``ssnm_inputs``, ``ssnm_call``, ``step_bound``). Times each kernel
per step by CUDA events, two turns each, one state stepped on in place:

- #16 and #17 alternating, in calls of K = 32 steps (``LOOPLESS_LAUNCH``,
  the longest coin window) and K = 4 (short windows pay the call's fixed
  cost), at 262,144 x 1,024 Gaussian rows stored f32, bf16 and int8
  (least-squares formula, scale N) with blocks of B = 4,096 (the
  headline), 1,024 (the facades' batch) and 128 (one row a CTA of the
  persistent engine: its floor, the barriers and the finish of a step with
  next to no rows);
- #5 on the same rows at B = 4,096 in calls of K = 128 (``LAUNCH_STEPS``,
  the SVRG driver's call), f32, bf16 and int8;
- #4 at the deep target's shape, 10,485,760 x 128 Gaussian rows, B =
  8,192, in calls of K = 128 (SAGA's ``LAUNCH_STEPS``), f32 and int8;
- #10 and #11 alternating on the headline's rows, f32, bf16 and int8, at
  B = 4,096 and 1,024 (the facades' batch) in calls of K = 64 (the
  headline's m = N/B, ``chip_smoke.VR_M``, one Katyusha or SARAH inner
  loop a call). The parent's wrappers of these two take the same
  arguments, so a checkout from before they joined the engine is timed
  the same way;
- #9 on the headline's rows, f32, bf16 and int8, at B = 4,096 (the Finito
  headline) and 1,024 (the ``Finito`` facade's batch) in calls of K = 128
  (``LAUNCH_STEPS``, a kernel call of ``finito_run``), repeated blocks
  drawn;
- #8 at the deep target's shape, f32 and int8, in calls of K = 512
  (``LFINITO_CHUNK``, a call of ``lfinito_sweep_chunked``) visiting 512
  distinct blocks, av restarted from the epoch's start every call;
- #14 at the deep target's shape, f32 and int8, in calls of K = 128
  (``LAUNCH_STEPS``, a call of the streamed Finito driver) visiting 128
  distinct blocks;
- #18 at the ProShI configuration (the first 65,536 rows of the
  headline's, n = 1,024, B = 4,096, IndBox(-inf, 1)), f32, bf16 and int8,
  in calls of K = 128 (``LAUNCH_STEPS``) on the cyclic sweep of its d = 16
  blocks (each visited eight times a call); its bound counts every step's
  block rows, table rows read and written, b, γ (and rs), as a step must
  move them (the table rows change every visit);
- #3 on the headline's rows, f32, bf16 and int8, at B = 4,096 (the SAGA
  headline) and 1,024 (the facades' batch) in calls of K = 128
  (``LAUNCH_STEPS``, a call of ``saga_run``), least squares, blocks drawn
  with repeats;
- #12 on the headline's rows with least-squares and logistic rows (labels
  sign(b); γ as ``chip_smoke.run_new_headline``'s), f32, bf16 and int8, at
  B = 4,096 and 1,024 in calls of K = 128 (a call of ``point_saga_run``):
  logistic minus least squares is what the Newton solves cost a step;
- #19 on the headline's rows (least squares, τ = 0.5), f32, bf16 and
  int8, at B = 4,096 (the SSNM headline) and 1,024 (the ``SSNM``
  facade's batch) in calls of K = 128 (a call of ``ssnm_run``), blocks
  drawn with repeats;
- #13 at the deep target's shape, f32 and int8, in calls of K = 128
  (a call of the streamed SSNM driver) visiting 128 distinct blocks;
- #15 at the deep target's shape with least-squares and logistic rows
  (labels sign(b); γ as #12's), f32, bf16 and int8, in calls of K = 128
  (a call of the streamed Point-SAGA driver) visiting 128 distinct
  blocks.
The wrappers of #3, #9, #8, #12, #13, #14, #15, #18 and #19 from before
they joined the engine take the same arguments too; #3's, #12's and
#19's C entries are their own sources where a checkout has them, else
#4's, #15's and #13's.

Beside each time: the step's bound at 3.35 TB/s and its bytes at the card's
read ceiling (``torch.sum`` over 2 GiB of f32, measured in the same
process), and the card's name and power limit. With ``--profile``, #18's,
#14's, #13's, #12's and #19's (f32, B = 4,096; #12 in both modes) and
#15's (f32, both modes) entries also hold one call traced by
``torch.profiler``: the
device time a step by kernel, the host clock's time a step and the rest
(gaps: launches, barriers the trace does not see), and, where the
profiler's CUPTI metrics are given, the DRAM bytes a step
(``dram__bytes_read.sum``, ``dram__bytes_write.sum``). Prints one JSON
line. To compare two checkouts A and B, run A, B, B, A in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N, n = 262_144, 1_024
BATCHES = (("headline", 4_096), ("facades", 1_024), ("floor", 128))
STEPS = (32, 4)
KINDS = (("#16", "lsvrg", 4), ("#17", "lkatyusha", 7))  # (n,) vectors moved
# Katyusha's and SARAH's: (n,) vectors moved, bytes a row beside the row
# (b, and but SARAH the anchor coefficient), operations a row and column
VR_KINDS = (("#10", "katyusha", 8, 8, 4.0), ("#11", "sarah", 6, 4, 6.0))
VR_BATCHES = (("headline", 4_096), ("facades", 1_024))
CALL_STEPS = 128  # the SAGA and SVRG drivers' LAUNCH_STEPS
SVRG_B = 4_096
DEEP_N, DEEP_n, DEEP_B = 10 * 1024 * 1024, 128, 8_192
FINITO_BATCHES = (("headline", 4_096), ("facades", 1_024))
LFINITO_STEPS = 512  # fused_block.LFINITO_CHUNK
PROSHI_N, PROSHI_B = 65_536, 4_096  # chip_smoke.PROSHI
# Point-SAGA's modes and their γ = 1/(c·max ‖a_i‖²·N) (chip_smoke's
# run_new_headline)
PS_MODES = (("lsq", 3.0), ("logistic", 0.75))
DRAM_METRICS = ("dram__bytes_read.sum", "dram__bytes_write.sum")
PROFILE = False  # --profile


def _profile(call, K: int) -> dict:
    """One call traced: device ms a step by kernel name, the host clock's
    ms a step, their difference (gaps), and the DRAM bytes a step where
    the CUPTI metrics are given (else the reason they are not)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / K
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.replace("(anonymous namespace)::", "").split("<")[0]
        name = name.split("(")[0].split()[-1] if name.split() else e.key
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        split[name] = split.get(name, 0.0) + us / 1e3 / K
    busy = sum(split.values())
    out = dict(wall_ms=wall, busy_ms=busy, gap_ms=wall - busy,
               kernels_ms=split)
    try:
        cfg = torch.profiler._ExperimentalConfig(
            profiler_metrics=list(DRAM_METRICS),
            profiler_measure_per_kernel=False)
        with profile(activities=[ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            call()
            torch.cuda.synchronize()
        found = {m: 0.0 for m in DRAM_METRICS}
        seen = False
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        for e in events:
            args = e.get("args") or {}
            for m in DRAM_METRICS:
                if m in args:
                    found[m] += float(args[m])
                    seen = True
        out["dram_bytes_per_step"] = ({m: v / K for m, v in found.items()}
                                      if seen else "not given by the "
                                      "profiler")
    except Exception as exc:  # a machine may refuse CUPTI's counters
        out["dram_bytes_per_step"] = f"not measured: {exc!r}"[:300]
    return out


def _record(out, cs, F, starts, B, vec_bytes, row_extra, ceil, flops=4.0,
            **kw):
    """One timed entry with its bound and its bytes at the ceiling."""
    nbytes = cs.step_bytes(F, starts, B, vec_bytes, row_extra)
    b_ms, b_by = cs.step_bound(F, starts, B, vec_bytes, row_extra, flops)
    out["steps"].append(dict(B=B, bound_ms=b_ms, bound_by=b_by,
                             ceil_ms=nbytes / ceil * 1e3, **kw))


def time_loopless(out, cs, fb, A, b, gen, dev, ceil):
    """#16 and #17 at every batch and call length, in alternation."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A, b, float(N))
        if storage != "f32":
            F = F.with_storage(storage)
        for shape, B in BATCHES:
            for K in STEPS:
                runs = {}
                for label, kind, vec in KINDS:
                    S = cs.vr_inputs(F, gen, dev, B, K)
                    sc = cs.vr_scalars(S, kind, B, cs.LAM)
                    state = cs.vr_state(kind, S)
                    fn = getattr(fb, cs.VR[kind][0])
                    runs[label] = (kind, fn, S, sc, state, vec)
                times = {label: [] for label in runs}
                for _ in range(2):
                    for label, (kind, fn, S, sc, state, _) in runs.items():
                        def call(kind=kind, fn=fn, S=S, sc=sc, state=state):
                            cs.vr_call(kind, fn, S, sc, B, state=state)
                        times[label].append(
                            cs.time_events(call, 640 // K) / K)
                for label, (kind, fn, S, sc, state, vec) in runs.items():
                    if not all(bool(torch.isfinite(t).all())
                               for t in state):
                        raise AssertionError(f"{label} {storage} B={B}: "
                                             "non-finite state")
                    _record(out, cs, F, S["starts"], B, vec * 4 * n, 8, ceil,
                            kernel=label, shape=shape, storage=storage, K=K,
                            ms=times[label])
        del F
        torch.cuda.empty_cache()


def time_vr(out, cs, fb, A, b, gen, dev, ceil):
    """#10 and #11 at both batches in calls of VR_M steps, in
    alternation."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    K = cs.VR_M
    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A, b, float(N))
        if storage != "f32":
            F = F.with_storage(storage)
        for shape, B in VR_BATCHES:
            runs = {}
            for label, kind, *_ in VR_KINDS:
                S = cs.vr_inputs(F, gen, dev, B, K)
                sc = cs.vr_scalars(S, kind, B, cs.LAM)
                state = cs.vr_state(kind, S)
                runs[label] = (kind, getattr(fb, cs.VR[kind][0]), S, sc,
                               state)
            times = {label: [] for label in runs}
            for _ in range(2):
                for label, (kind, fn, S, sc, state) in runs.items():
                    def call(kind=kind, fn=fn, S=S, sc=sc, state=state):
                        cs.vr_call(kind, fn, S, sc, B, state=state)
                    times[label].append(cs.time_events(call, 10) / K)
            for label, kind, vec, extra, flops in VR_KINDS:
                _, _, S, _, state = runs[label]
                if not all(bool(torch.isfinite(t).all()) for t in state):
                    raise AssertionError(f"{label} {storage} B={B}: "
                                         "non-finite state")
                _record(out, cs, F, S["starts"], B, vec * 4 * n, extra, ceil,
                        flops, kernel=label, shape=shape, storage=storage,
                        K=K, ms=times[label])
        del F
        torch.cuda.empty_cache()


def time_svrg(out, cs, fb, A, b, gen, dev, ceil):
    """#5 at the headline in calls of CALL_STEPS steps."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    B = SVRG_B
    gamma = 1.0 / (3.0 * float((A * A).sum(1).max()) * N)
    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A, b, float(N))
        if storage != "f32":
            F = F.with_storage(storage)
        rows, offs = F.coeff_rows_data()
        rs = F.coeff_rows_scale()
        canch, (w, zs), av, starts, sc = cs.svrg_inputs(
            F, 0.3 * gamma, gen, dev, B, CALL_STEPS, cs.LAM)

        def call():
            fb.svrg_coeff_multistep(rows, offs, starts, canch, w, zs, av, sc,
                                    B, rs=rs)
        ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
        if not bool(torch.isfinite(w).all()):
            raise AssertionError(f"#5 {storage}: non-finite w")
        # rows, b and canch of the visited blocks; w, zs in and out, av
        _record(out, cs, F, starts, B, 5 * 4 * n, 8, ceil, kernel="#5",
                shape="headline", storage=storage, K=CALL_STEPS, ms=ms)
        del F
        torch.cuda.empty_cache()


def time_finito(out, cs, fb, A, b, gen, dev, ceil):
    """#9 at the headline at both batches in calls of CALL_STEPS steps."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A, b, float(N))
        if storage != "f32":
            F = F.with_storage(storage)
        for shape, B in FINITO_BATCHES:
            S = cs.finito_inputs(F, gen, dev, B, CALL_STEPS, cs.LAM)
            state = [t.clone() for t in S["state"]]

            def call(S=S, B=B, state=state):
                cs.run_finito_kernel(fb.finito_coeff_multistep, F, S, B,
                                     state=state)
            ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
            if not all(bool(torch.isfinite(t).all()) for t in state):
                raise AssertionError(f"#9 {storage} B={B}: non-finite state")
            # rows, b and c read and written of the visited blocks; their
            # anchor rows read and written; z and av in and out; Σ 1/γ
            distinct = int(torch.unique(S["starts"]).numel())
            _record(out, cs, F, S["starts"], B,
                    16 * n + 8 * n * distinct + 4 * (N // B), 12, ceil,
                    kernel="#9", shape=shape, storage=storage, K=CALL_STEPS,
                    ms=ms)
        del F
        torch.cuda.empty_cache()


def time_lfinito_deep(out, cs, fb, A, b, gen, dev, ceil):
    """#8 at the deep target's shape in calls of LFINITO_STEPS blocks."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    K = LFINITO_STEPS
    for storage in ("f32", "int8"):
        F = LeastSquaresRows(A, b, float(DEEP_N))
        if storage != "f32":
            F = F.with_storage(storage)
        rows, offs = F.coeff_rows_data()
        rs = F.coeff_rows_scale()
        S = cs.lfinito_inputs(F, gen, dev, DEEP_B, K, cs.LAM)
        zs = []

        def call():
            zs[:] = fb.lfinito_sweep_multistep(
                rows, offs, S["canch"], S["starts"], S["av"].clone(),
                S["zf"], S["invg_v"], S["sc"], DEEP_B, rs=rs)
        ms = [cs.time_events(call, 3) / K for _ in range(2)]
        if not all(bool(torch.isfinite(t).all()) for t in zs):
            raise AssertionError(f"#8 {storage}: non-finite av or z")
        # rows, b and the anchor coefficients of the visited blocks; av in
        # and out, z_full, z out; Σ 1/γ by visit
        _record(out, cs, F, S["starts"], DEEP_B, 16 * DEEP_n + 4 * K, 8,
                ceil, kernel="#8", shape="deep", storage=storage, K=K, ms=ms)
        del F, S
        torch.cuda.empty_cache()


def time_finito_deep(out, cs, fb, A, b, gen, dev, ceil):
    """#14 at the deep target's shape in calls of CALL_STEPS distinct
    blocks."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    for storage in ("f32", "int8"):
        F = LeastSquaresRows(A, b, float(DEEP_N))
        if storage != "f32":
            F = F.with_storage(storage)
        S = cs.finito_inputs(F, gen, dev, DEEP_B, CALL_STEPS, cs.LAM,
                             distinct=True)
        state = [t.clone() for t in S["state"]]

        def call(S=S, state=state):
            cs.run_finito_kernel(fb.finito_coeff_multistep_streamed, F, S,
                                 DEEP_B, state=state)
        ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
        if not all(bool(torch.isfinite(t).all()) for t in state):
            raise AssertionError(f"#14 {storage}: non-finite state")
        extra = dict(profile=_profile(call, CALL_STEPS)) if PROFILE else {}
        # rows, b and c read and written of the visited blocks; their
        # anchor rows read and written; z and av in and out; Σ 1/γ by step
        _record(out, cs, F, S["starts"], DEEP_B,
                16 * DEEP_n + 8 * DEEP_n * CALL_STEPS + 4 * CALL_STEPS, 12,
                ceil, kernel="#14", shape="deep", storage=storage,
                K=CALL_STEPS, ms=ms, **extra)
        del F, S, state
        torch.cuda.empty_cache()


def time_proshi(out, cs, fb, A, b, gen, dev, ceil):
    """#18 at the ProShI configuration in calls of CALL_STEPS cyclic
    steps."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    d = PROSHI_N // PROSHI_B
    g = cs.coupling("IndBox", dev)
    starts = ((torch.arange(CALL_STEPS, device=dev) % d) * PROSHI_B).to(
        torch.int32)
    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A[:PROSHI_N].contiguous(), b[:PROSHI_N].clone(),
                             float(PROSHI_N))
        if storage != "f32":
            F = F.with_storage(storage)
        S = cs.proshi_inputs(F, g, gen, dev, PROSHI_B, CALL_STEPS)
        st = S["st"]
        state = [t.clone() for t in (st.s, st.av, st.z)]

        def call(F=F, S=S, state=state):
            cs.run_proshi_kernel(fb.proshi_multistep, F, S, PROSHI_B,
                                 starts=starts, state=state)
        ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
        if not all(bool(torch.isfinite(t).all()) for t in state):
            raise AssertionError(f"#18 {storage}: non-finite state")
        extra = dict(profile=_profile(call, CALL_STEPS)) if PROFILE else {}
        rows = F.coeff_rows_data()[0]
        # every step: its block's rows, table rows read and written, b, γ
        # (and rs); av and z in and out a call
        per_row = (n * rows.element_size() + 8 * n + 8
                   + 4 * (rows.dtype == torch.int8))
        nbytes = PROSHI_B * per_row + 16 * n / CALL_STEPS
        b_ms, b_by = cs.bound(nbytes, 7.0 * PROSHI_B * n,
                              rows.element_size())
        out["steps"].append(dict(
            kernel="#18", shape="proshi", storage=storage, K=CALL_STEPS,
            B=PROSHI_B, ms=ms, bound_ms=b_ms, bound_by=b_by,
            ceil_ms=nbytes / ceil * 1e3, model_bytes=nbytes, **extra))
        del F, S, st, state
        torch.cuda.empty_cache()


def time_saga(out, cs, fb, A, b, gen, dev, ceil):
    """#3 at the headline at both batches in calls of CALL_STEPS steps."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    gamma = 1.0 / (3.0 * float((A * A).sum(1).max()) * N)
    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A, b, float(N))
        if storage != "f32":
            F = F.with_storage(storage)
        rows, offs = F.coeff_rows_data()
        rs = F.coeff_rows_scale()
        for shape, B in FINITO_BATCHES:
            c, z, av, starts, sc, _ = cs.kernel_inputs(
                F, gamma, gen, dev, B, CALL_STEPS, False, False)

            def call(c=c, z=z, av=av, starts=starts, sc=sc, B=B):
                fb.saga_coeff_multistep(rows, offs, starts, c, z, av, sc, B,
                                        rs=rs)
            ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
            if not bool(torch.isfinite(z).all()):
                raise AssertionError(f"#3 {storage} B={B}: non-finite z")
            # rows, b, c read and written of the visited blocks; z and av in
            # and out
            _record(out, cs, F, starts, B, 4 * 4 * n, 12, ceil, kernel="#3",
                    shape=shape, storage=storage, K=CALL_STEPS, ms=ms)
        del F
        torch.cuda.empty_cache()


def time_point_saga(out, cs, fb, A, b, gen, dev, ceil):
    """#12 at the headline, least-squares and logistic rows, at both
    batches in calls of CALL_STEPS steps."""
    Lm = float((A * A).sum(1).max()) * N
    for storage in ("f32", "bf16", "int8"):
        for kind, cg in PS_MODES:
            F, _ = cs.row_oracle(kind, A, b, gen)
            if storage != "f32":
                F = F.with_storage(storage)
            for shape, B in FINITO_BATCHES:
                S = cs.ps_inputs(F, gen, dev, B, CALL_STEPS, 1.0 / (cg * Lm))
                state = [t.clone() for t in S["state"]]

                def call(S=S, B=B, state=state):
                    cs.ps_call(fb.point_saga_multistep, F, S, B, state=state)
                ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
                if not all(bool(torch.isfinite(t).all()) for t in state):
                    raise AssertionError(f"#12 {kind} {storage} B={B}: "
                                         "non-finite state")
                extra = (dict(profile=_profile(call, CALL_STEPS))
                         if PROFILE and storage == "f32" and B == 4_096
                         else {})
                # rows, b, na and c read and written of the visited blocks;
                # x and av in and out
                _record(out, cs, F, S["starts"], B, 16 * n, 16, ceil,
                        kernel="#12", mode=kind, shape=shape,
                        storage=storage, K=CALL_STEPS, ms=ms, **extra)
            del F
            torch.cuda.empty_cache()


def time_ssnm(out, cs, fb, A, b, gen, dev, ceil):
    """#19 at the headline at both batches in calls of CALL_STEPS steps."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    for storage in ("f32", "bf16", "int8"):
        F = LeastSquaresRows(A, b, float(N))
        if storage != "f32":
            F = F.with_storage(storage)
        for shape, B in FINITO_BATCHES:
            S = cs.ssnm_inputs(F, gen, dev, B, CALL_STEPS, 0.5, cs.LAM)
            state = [t.clone() for t in S["state"]]

            def call(S=S, B=B, state=state):
                cs.ssnm_call(fb.ssnm_multistep, F, S, B, state=state)
            ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
            if not all(bool(torch.isfinite(t).all()) for t in state):
                raise AssertionError(f"#19 {storage} B={B}: non-finite "
                                     "state")
            extra = (dict(profile=_profile(call, CALL_STEPS))
                     if PROFILE and storage == "f32" and B == 4_096 else {})
            # rows, b and c read and written of the visited blocks; their
            # stored points read and written; x and gb in and out
            distinct = int(torch.unique(S["starts"]).numel())
            _record(out, cs, F, S["starts"], B, 16 * n + 8 * n * distinct,
                    12, ceil, kernel="#19", shape=shape, storage=storage,
                    K=CALL_STEPS, ms=ms, **extra)
        del F
        torch.cuda.empty_cache()


def time_ssnm_deep(out, cs, fb, A, b, gen, dev, ceil):
    """#13 at the deep target's shape in calls of CALL_STEPS distinct
    blocks."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    for storage in ("f32", "int8"):
        F = LeastSquaresRows(A, b, float(DEEP_N))
        if storage != "f32":
            F = F.with_storage(storage)
        S = cs.ssnm_inputs(F, gen, dev, DEEP_B, CALL_STEPS, 0.5, cs.LAM,
                           distinct=True)
        state = [t.clone() for t in S["state"]]

        def call(S=S, state=state):
            cs.ssnm_call(fb.ssnm_multistep_streamed, F, S, DEEP_B,
                         state=state)
        ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
        if not all(bool(torch.isfinite(t).all()) for t in state):
            raise AssertionError(f"#13 {storage}: non-finite state")
        extra = dict(profile=_profile(call, CALL_STEPS)) if PROFILE else {}
        # rows, b and c read and written of the visited blocks; their
        # stored points read and written; x and gb in and out
        _record(out, cs, F, S["starts"], DEEP_B,
                16 * DEEP_n + 8 * DEEP_n * CALL_STEPS, 12, ceil,
                kernel="#13", shape="deep", storage=storage, K=CALL_STEPS,
                ms=ms, **extra)
        del F, S, state
        torch.cuda.empty_cache()


def time_point_saga_deep(out, cs, fb, A, b, gen, dev, ceil):
    """#15 at the deep target's shape, least-squares and logistic rows, in
    calls of CALL_STEPS distinct blocks."""
    Lm = float((A * A).sum(1).max()) * DEEP_N
    for storage in ("f32", "bf16", "int8"):
        for kind, cg in PS_MODES:
            F, _ = cs.row_oracle(kind, A, b, gen)
            if storage != "f32":
                F = F.with_storage(storage)
            S = cs.ps_inputs(F, gen, dev, DEEP_B, CALL_STEPS,
                             1.0 / (cg * Lm), distinct=True)
            state = [t.clone() for t in S["state"]]

            def call(S=S, state=state):
                cs.ps_call(fb.point_saga_multistep_streamed, F, S, DEEP_B,
                           state=state)
            ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
            if not all(bool(torch.isfinite(t).all()) for t in state):
                raise AssertionError(f"#15 {kind} {storage}: non-finite "
                                     "state")
            extra = (dict(profile=_profile(call, CALL_STEPS))
                     if PROFILE and storage == "f32" else {})
            # rows, b, na and c read and written of the visited blocks; x
            # and av in and out
            _record(out, cs, F, S["starts"], DEEP_B, 16 * DEEP_n, 16, ceil,
                    kernel="#15", mode=kind, shape="deep", storage=storage,
                    K=CALL_STEPS, ms=ms, **extra)
            del F, S, state
            torch.cuda.empty_cache()


def time_saga_deep(out, cs, fb, A, b, gen, dev, ceil):
    """#4 at the deep target's shape in calls of CALL_STEPS steps."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    gamma = 1.0 / (3.0 * float((A * A).sum(1).max()) * DEEP_N)
    for storage in ("f32", "int8"):
        F = LeastSquaresRows(A, b, float(DEEP_N))
        if storage != "f32":
            F = F.with_storage(storage)
        rows, offs = F.coeff_rows_data()
        rs = F.coeff_rows_scale()
        c, z, av, starts, sc, _ = cs.kernel_inputs(
            F, gamma, gen, dev, DEEP_B, CALL_STEPS, False, False)

        def call():
            fb.saga_coeff_multistep_streamed(rows, offs, starts, c, z, av,
                                             sc, DEEP_B, rs=rs)
        ms = [cs.time_events(call, 5) / CALL_STEPS for _ in range(2)]
        if not bool(torch.isfinite(z).all()):
            raise AssertionError(f"#4 {storage}: non-finite z")
        # rows, b, c read and written of the visited blocks; z and av in and
        # out
        _record(out, cs, F, starts, DEEP_B, 4 * 4 * DEEP_n, 12, ceil,
                kernel="#4", shape="deep", storage=storage, K=CALL_STEPS,
                ms=ms)
        del F, c
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels",
                    default="16,17,5,4,10,11,9,8,18,14,3,12,19,13,15",
                    help="which of #16/#17 (together), #5, #4, #10/#11 "
                         "(together), #9, #8, #18, #14, #3, #12, #19, #13, "
                         "#15 to time")
    ap.add_argument("--profile", action="store_true",
                    help="trace one call of #18, #14, #12, #19, #13 and #15 "
                         "as well")
    args = ap.parse_args()
    global PROFILE
    PROFILE = args.profile
    if not torch.cuda.is_available():
        print("loopless_step_times: no CUDA device", file=sys.stderr)
        return 2
    which = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    # this checkout's chip_smoke.py (its helpers), the other's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from ciao_tpu_torch.ops import _build
    from ciao_tpu_torch.ops import fused_block as fb

    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not from {root}")
    names = ([cs.VR[kind][0] for _, kind, _ in KINDS]
             if which & {"16", "17"} else [])
    names += ["svrg_coeff_multistep"] if "5" in which else []
    names += ["saga_coeff_multistep_streamed"] if "4" in which else []
    names += ([cs.VR[kind][0] for _, kind, *_ in VR_KINDS]
              if which & {"10", "11"} else [])
    names += ["finito_coeff_multistep"] if "9" in which else []
    names += ["lfinito_sweep_multistep"] if "8" in which else []
    names += ["proshi_multistep"] if "18" in which else []
    names += ["finito_coeff_multistep_streamed"] if "14" in which else []

    def entry(own, shared):
        """A kernel's C entry: its own source, or the entry its wrapper
        shares where the checkout has none (#3's #4's, #12's #15's, #19's
        #13's)."""
        return own if (_build.CSRC / f"{own}.cu").exists() else shared
    names += ([entry("saga_coeff_multistep", "saga_coeff_multistep_streamed")]
              if "3" in which else [])
    names += ([entry("point_saga_multistep", "point_saga_multistep_streamed")]
              if "12" in which else [])
    names += ([entry("ssnm_multistep", "ssnm_multistep_streamed")]
              if "19" in which else [])
    names += ["ssnm_multistep_streamed"] if "13" in which else []
    names += ["point_saga_multistep_streamed"] if "15" in which else []
    names = list(dict.fromkeys(names))
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        list(pool.map(_build.build, names))
    for name in names:
        _build.load(name)
    dev = torch.device("cuda", 0)
    card = cs.card_info()
    ceil = cs.read_ceiling(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tag": args.tag, "root": root, "card": card,
           "ceiling_gb_s": ceil / 1e9, "steps": []}
    A = torch.randn(N, n, generator=gen, device=dev)
    b = torch.randn(N, generator=gen, device=dev)
    if which & {"16", "17"}:
        time_loopless(out, cs, fb, A, b, gen, dev, ceil)
    if "5" in which:
        time_svrg(out, cs, fb, A, b, gen, dev, ceil)
    if which & {"10", "11"}:
        time_vr(out, cs, fb, A, b, gen, dev, ceil)
    if "9" in which:
        time_finito(out, cs, fb, A, b, gen, dev, ceil)
    if "18" in which:
        time_proshi(out, cs, fb, A, b, gen, dev, ceil)
    if "3" in which:
        time_saga(out, cs, fb, A, b, gen, dev, ceil)
    if "12" in which:
        time_point_saga(out, cs, fb, A, b, gen, dev, ceil)
    if "19" in which:
        time_ssnm(out, cs, fb, A, b, gen, dev, ceil)
    del A, b
    torch.cuda.empty_cache()
    if which & {"4", "8", "14", "13", "15"}:
        A = torch.randn(DEEP_N, DEEP_n, generator=gen, device=dev)
        b = torch.randn(DEEP_N, generator=gen, device=dev)
        if "4" in which:
            time_saga_deep(out, cs, fb, A, b, gen, dev, ceil)
        if "8" in which:
            time_lfinito_deep(out, cs, fb, A, b, gen, dev, ceil)
        if "14" in which:
            time_finito_deep(out, cs, fb, A, b, gen, dev, ceil)
        if "13" in which:
            time_ssnm_deep(out, cs, fb, A, b, gen, dev, ceil)
        if "15" in which:
            time_point_saga_deep(out, cs, fb, A, b, gen, dev, ceil)
        del A, b
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
