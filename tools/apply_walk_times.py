#!/usr/bin/env python3
"""Times kernels #6 (``coeff_apply_all``) and #7 (``coeff_value_apply_all``)
of one checkout of the port on one NVIDIA GPU, so that two versions of
their walk can be compared in one call.

    python3 tools/apply_walk_times.py [--root DIR] [--tag NAME] [--seed 0]

Builds the two kernels from ``DIR/ciao_tpu_torch/csrc`` (default: this
checkout) with that checkout's ``ops/_build.py``, and imports that checkout's
wrappers. Times each kernel per pass with this checkout's
``chip_smoke.time_walk`` (CUDA events; two turns of 20 passes, #6 and #7
alternating, between two turns of their plain versions) at the headline
(262,144 x 1,024 Gaussian rows stored f32, bf16 and int8), at the deep
target's shape (10,485,760 x 128, f32 and int8) and at three wide shapes
(32,768 x 4,096, 16,384 x 8,192 and 8,192 x 16,384, all three storages:
512 MiB of f32 rows each), least-squares
formula with scale N, rows from ``--seed``. Beside each pass: its byte
bound at 3.35 TB/s and at the card's read ceiling (``torch.sum`` over 2 GiB
of f32, measured in the same process), and the card's name and power
limit. Prints one JSON line. To compare two checkouts A and B, run A, B, B,
A in one call and compare the ratios to the ceiling.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = (("headline", 262_144, 1_024, ("f32", "bf16", "int8")),
          ("deep", 10 * 1024 * 1024, 128, ("f32", "int8")),
          ("wide", 32_768, 4_096, ("f32", "bf16", "int8")),
          ("wide", 16_384, 8_192, ("f32", "bf16", "int8")),
          ("wide", 8_192, 16_384, ("f32", "bf16", "int8")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("apply_walk_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    # this checkout's chip_smoke.py (its timing helpers), the other's package
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
    for name in ("coeff_apply_all", "coeff_value_apply_all"):
        _build.load(name)
    dev = torch.device("cuda", 0)
    card = cs.card_info()
    ceil = cs.read_ceiling(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    out = {"tag": args.tag, "root": root, "card": card,
           "ceiling_gb_s": ceil / 1e9, "passes": []}
    for shape, N_, n_, storages in SHAPES:
        A = torch.randn(N_, n_, generator=gen, device=dev)
        b = torch.randn(N_, generator=gen, device=dev)
        z = 0.05 * torch.randn(n_, generator=gen, device=dev)
        sc = torch.tensor([float(N_), 0.0, 0.0], device=dev)
        for storage in storages:
            F = LeastSquaresRows(A, b, float(N_))
            if storage != "f32":
                F = F.with_storage(storage)
            rows, offs = F.coeff_rows_data()
            t = cs.time_walk(rows, offs, z, sc, F.coeff_rows_scale())
            for k, tk in t.items():
                nbytes = cs.pass_bytes(rows, value=k == "#7")
                b_ms, _ = cs.bound(nbytes, 4.0 * N_ * n_,
                                   rows.element_size())
                out["passes"].append(dict(
                    kernel=k, shape=shape, N=N_, n=n_, storage=storage,
                    ms=tk["kernel"], plain_ms=tk["plain"], bound_ms=b_ms,
                    ceil_ms=nbytes / ceil * 1e3))
            del F, rows, offs
        del A, b
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
