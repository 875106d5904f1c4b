#!/usr/bin/env python3
"""Times kernels #16 (``lsvrg_coeff_multistep``) and #17
(``lkatyusha_coeff_multistep``) of one checkout of the port on one NVIDIA
GPU, so that two versions of the loopless pair can be compared in one call.

    python3 tools/loopless_step_times.py [--root DIR] [--tag NAME] [--seed 0]

Builds the two kernels from ``DIR/ciao_tpu_torch/csrc`` (default: this
checkout) with that checkout's ``ops/_build.py`` and imports that checkout's
wrappers; the inputs and helpers are this checkout's ``chip_smoke.py``
(``vr_inputs``, ``vr_scalars``, ``vr_call``). Times each kernel per step by
CUDA events, in calls of K = 32 steps (``LOOPLESS_LAUNCH``, the longest
coin window) and K = 4 (short windows pay the call's fixed cost), two turns
of each with #16 and #17 alternating, one state stepped on in place, at
262,144 x 1,024 Gaussian rows stored f32, bf16 and int8 (least-squares
formula, scale N) with blocks of B = 4,096 (the headline), 1,024 (the
facades' batch) and 128 (one row a CTA of the persistent engine: its
floor, the barriers and the finish of a step with next to no rows; the
two-launch engine runs it on 128 CTAs too). Beside each time: the step's
bound at 3.35 TB/s and its bytes at the card's read ceiling (``torch.sum``
over 2 GiB of f32, measured in the same process), and the card's name and
power limit. Prints one JSON line. To compare two checkouts A and B, run A,
B, B, A in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N, n = 262_144, 1_024
BATCHES = (("headline", 4_096), ("facades", 1_024), ("floor", 128))
STEPS = (32, 4)
KINDS = (("#16", "lsvrg", 4), ("#17", "lkatyusha", 7))  # (n,) vectors moved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("loopless_step_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    # this checkout's chip_smoke.py (its helpers), the other's package
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from ciao_tpu_torch.ops import _build
    from ciao_tpu_torch.ops import fused_block as fb
    from ciao_tpu_torch.oracles import LeastSquaresRows

    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not from {root}")
    for _, kind, _ in KINDS:
        _build.load(cs.VR[kind][0])
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
                    nbytes = cs.step_bytes(F, S["starts"], B, vec * 4 * n, 8)
                    b_ms, b_by = cs.bound(nbytes, 4.0 * B * n,
                                          F.coeff_rows_data()[0]
                                          .element_size())
                    out["steps"].append(dict(
                        kernel=label, shape=shape, B=B, storage=storage,
                        K=K, ms=times[label], bound_ms=b_ms, bound_by=b_by,
                        ceil_ms=nbytes / ceil * 1e3))
        del F
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
