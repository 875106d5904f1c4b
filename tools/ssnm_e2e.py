#!/usr/bin/env python3
"""End-to-end steps of SSNM at the headline (kernel #19) and on the deep
target (kernel #13) of one checkout of the port on one NVIDIA GPU, so that
two versions can be compared in one call.

    python3 tools/ssnm_e2e.py [--root DIR] [--tag NAME] [--seed 0]

Runs DIR's package (default: this checkout) through this checkout's
``chip_smoke.py`` helpers, as its phases 4o and 4p drive it, at
``bench.py``'s setting (τ = 0.5, η = 1/(1.5·L_max)):

- the 262,144 x 1,024 headline with B = 4,096, NormL1(0.1), f32 and int8
  rows: ``ssnm_init``, then ``ssnm_run`` on #19 for
  ``chip_smoke.NEW_STEPS`` steps by the host clock around a synchronize;
- the deep target (10,485,760 x 128, B = 8,192, ``chip_smoke.DeepProblem``
  and its prox), f32 and int8 rows: the same on #13 for
  ``chip_smoke.NEW_DEEP_STEPS`` steps;

then a window of 256 steps of each profiled (``chip_smoke.profile_steps``:
ms a step by the host clock, the device's busy time by kernel and the idle
share), and that each objective fell. Prints one JSON line with the card's
name and power limit. Run A, B, B, A in one call to compare two trees.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssnm_e2e: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    cs = _module("chip_smoke", os.path.join(os.path.dirname(HERE),
                                            "chip_smoke.py"))
    e2e = _module("proshi_finito_e2e", os.path.join(HERE,
                                                    "proshi_finito_e2e.py"))
    sys.path.insert(0, root)
    from ciao_tpu_torch.ops import fused_block as fb

    if not fb.__file__.startswith(root):
        raise RuntimeError(f"imported {fb.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    out = {"tag": args.tag, "root": root, "card": card,
           "runs": measure(cs, e2e, dev, gen, card)}
    print(json.dumps(out), flush=True)
    return 0


def measure(cs, e2e, dev, gen, card: str) -> list:
    """The runs' records (``cs``: a ``chip_smoke`` module, ``e2e``:
    ``proshi_finito_e2e``, whose ``drive`` takes each run). The profiled
    windows' groups name both engines' kernels, so that a checkout from
    before #19 and #13 joined the persistent engine is split the same
    way."""
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.ssnm import SSNMCfg, ssnm_init, ssnm_run

    runs = []
    names = ("loopless_steps", "rows_kernel", "ssnm_")
    g = NormL1(torch.tensor(cs.LAM, dtype=torch.float32, device=dev))
    x0 = torch.zeros(cs.n, device=dev)
    for storage in ("f32", "int8"):
        F, _, L = cs.lasso(gen, dev, cs.N, cs.n, storage)
        cfg = SSNMCfg(N=cs.N, batch=cs.B, fused=True)
        st0 = ssnm_init(F, g, x0, 0.5, 1.0 / (1.5 * float(L.max())), 0, cfg)
        runs.append(e2e.drive(
            cs, card, f"SSNM headline {storage}",
            lambda st, k, F=F, cfg=cfg: ssnm_run(F, g, st, cfg, k), st0,
            cs.NEW_STEPS, lambda st, F=F: cs.cost(F, g, st.x),
            {"kernel #19": names}))
        del F, st0
        torch.cuda.empty_cache()
    prob = cs.DeepProblem(gen, dev)
    Nd, Bd = cs.DEEP["N"], cs.DEEP["B"]
    xd = torch.zeros(cs.DEEP["n"], device=dev)
    gd = prob.prox()
    Lm = float(prob.L.max())
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        cfg = SSNMCfg(N=Nd, batch=Bd, fused_stream=True)
        st0 = ssnm_init(F, gd, xd, 0.5, 1.0 / (1.5 * Lm), 0, cfg)
        runs.append(e2e.drive(
            cs, card, f"SSNM deep {storage}",
            lambda st, k, F=F, cfg=cfg: ssnm_run(F, gd, st, cfg, k), st0,
            cs.NEW_DEEP_STEPS, lambda st, F=F: prob.objective(F, gd, st.x),
            {"kernel #13": names}))
        del F, st0
        torch.cuda.empty_cache()
    return runs


if __name__ == "__main__":
    sys.exit(main())
