#!/usr/bin/env python3
"""End-to-end steps of ProShI (kernel #18) and streamed Finito (kernel #14)
of one checkout of the port on one NVIDIA GPU, so that two versions can be
compared in one call.

    python3 tools/proshi_finito_e2e.py [--root DIR] [--tag NAME] [--seed 0]

Runs DIR's package (default: this checkout) through this checkout's
``chip_smoke.py`` helpers, as its phases 4h and 4g drive it:

- ProShI at ``chip_smoke.PROSHI`` (the first 65,536 rows of the
  headline's Lasso, n = 1,024, IndBox(-inf, 1), B = 4,096, cyclic, γ_i =
  0.999·N/L_i), f32 and int8 rows: ``proshi_init``, then ``proshi_run``
  for ``PROSHI["steps"]`` steps by the host clock around a synchronize;
- streamed Finito on the deep target (``chip_smoke.DeepProblem``,
  10,485,760 x 128, B = 8,192, sweeping 3, ``fused_stream``), f32 and
  int8 rows: ``finito_coeff_init``, then ``finito_run`` for
  ``DEEP_FINITO_EPOCHS`` epochs, the same way;

then a window of 256 steps of each profiled (``chip_smoke.profile_steps``:
ms a step by the host clock, the device's busy time by kernel and the idle
share), and that each objective fell. Prints one JSON line with the
card's name and power limit. Run A, B, B, A in one call to compare two
trees.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("proshi_finito_e2e: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    from ciao_tpu_torch.ops import fused_block as fb

    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tag": args.tag, "root": root, "card": cs.card_info(),
           "runs": measure(cs, dev, gen, cs.card_info())}
    print(json.dumps(out), flush=True)
    return 0


def drive(cs, card: str, label: str, run, st0, steps: int, objective,
          groups: dict) -> dict:
    """One run's record: ``run(st0, steps)`` by the host clock around a
    synchronize (after a one-step call that builds and warms the kernel),
    the objective before and after (it must fall), and a window of WINDOW
    steps profiled (``cs.profile_steps``: the device's busy time by
    ``groups`` and the idle share)."""
    obj0 = objective(st0)
    run(st0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st0, steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    obj1 = objective(st)
    if not (math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"{label}: objective {obj0} -> {obj1}")
    prof = cs.profile_steps(label, lambda: run(st0, WINDOW), WINDOW, card,
                            groups)
    return dict(run=label, steps=steps, ms_per_step=ms,
                objective=[obj0, obj1], profiled_ms=prof["step"],
                busy_ms=prof["busy"], idle=1.0 - prof["busy"] / prof["step"],
                split={k: prof[k] for k in groups})


def measure(cs, dev, gen, card: str) -> list:
    """The runs' records (``cs``: a ``chip_smoke`` module)."""
    from ciao_tpu_torch.solvers.finito import (
        FinitoCfg, finito_coeff_init, finito_run,
    )
    from ciao_tpu_torch.solvers.proshi import (
        ProshiCfg, proshi_init, proshi_run,
    )

    runs = []

    def drive_run(*a):
        runs.append(drive(cs, card, *a))

    P = cs.PROSHI
    g = cs.coupling("IndBox", dev)
    x0 = torch.zeros(cs.n, device=dev)
    for storage in ("f32", "int8"):
        F, _, L = cs.lasso(gen, dev, P["N"], cs.n, storage)
        cfg = ProshiCfg(N=P["N"], batch=P["B"], sweeping=2, alpha=0.999,
                        fused=True)
        st0 = proshi_init(F, g, x0, 0.999 * P["N"] / L, 0, cfg)
        drive_run(f"ProShI cyclic {storage}",
              lambda st, k, F=F, cfg=cfg: proshi_run(F, g, st, cfg, k),
              st0, P["steps"], lambda st, F=F: cs.sharing_obj(F, g, st),
              {"kernel #18": ("proshi", "loopless_steps", "table_rows")})
        del F, st0
        torch.cuda.empty_cache()
    prob = cs.DeepProblem(gen, dev)
    Nd, Bd = cs.DEEP["N"], cs.DEEP["B"]
    xd = torch.zeros(cs.DEEP["n"], device=dev)
    gd = prob.prox()
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        cfg = FinitoCfg(N=Nd, batch=Bd, sweeping=3, alpha=0.999,
                        fused_stream=True)
        st0 = finito_coeff_init(F, gd, xd, 0.999 * Nd / prob.L, 0, cfg)
        drive_run(f"streamed Finito deep {storage}",
              lambda st, k, F=F, cfg=cfg: finito_run(F, gd, st, cfg,
                                                     "basic_coeff", k),
              st0, cs.DEEP_FINITO_EPOCHS * (Nd // Bd),
              lambda st, F=F: prob.objective(F, gd, st.z),
              {"kernel #14": ("loopless_steps", "rows_kernel",
                              "finito_finish")})
        del F, st0
        torch.cuda.empty_cache()
    return runs


if __name__ == "__main__":
    sys.exit(main())
