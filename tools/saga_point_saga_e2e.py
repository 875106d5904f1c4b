#!/usr/bin/env python3
"""End-to-end steps of SAGA (kernel #3) and Point-SAGA (kernel #12) at the
headline, and of Point-SAGA (kernel #15) on the deep target, of one
checkout of the port on one NVIDIA GPU, so that two versions can be
compared in one call.

    python3 tools/saga_point_saga_e2e.py [--root DIR] [--tag NAME] [--seed 0]
        [--part all|headline|deep]

Runs DIR's package (default: this checkout) through this checkout's
``chip_smoke.py`` helpers, as its phases 4, 4q and 4r drive it; on the
262,144 x 1,024 headline with B = 4,096 (``--part headline``):

- SAGA (NormL1(0.1), γ = 1/(3·L_max), block sampling), int8 and f32 rows:
  ``saga_init``, then ``saga_run`` for ``chip_smoke.MAIN_STEPS`` steps by
  the host clock around a synchronize;
- Point-SAGA (g = Zero) with least-squares and logistic rows, f32 and
  int8, at ``chip_smoke.run_new_headline``'s γ: ``point_saga_init``, then
  ``point_saga_run`` for ``chip_smoke.NEW_STEPS`` steps, the same way;

and on the deep target (10,485,760 x 128, B = 8,192,
``chip_smoke.DeepProblem``; ``--part deep``):

- Point-SAGA (g = Zero) with its least-squares rows, f32 and int8, at
  γ = 1/(3·L_max) as phase 4r: the same on #15 for
  ``chip_smoke.NEW_DEEP_STEPS`` steps (two epochs);

then a window of 256 steps of each profiled (``chip_smoke.profile_steps``:
ms a step by the host clock, the device's busy time by kernel and the idle
share), and that each objective fell (Point-SAGA's at f64 at the
headline, as phase 4q reads it). The profiled windows' groups name both
engines' kernels, so that a checkout from before #12 or #15 joined the
persistent engine is split the same way. Prints one JSON line with the
card's name and power limit. Run A, B, B, A in one call to compare two
trees.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
# Point-SAGA's kernels by name: the persistent engine's, and the row phase,
# finish and shifted-point kernels that #12 and #15 launched before it
PS_KERNELS = ("loopless_steps", "rows_kernel", "point_saga_finish",
              "shifted_point")


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
    ap.add_argument("--part", choices=("all", "headline", "deep"),
                    default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("saga_point_saga_e2e: no CUDA device", file=sys.stderr)
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
    runs = []
    if args.part in ("all", "headline"):
        runs += measure(cs, e2e, dev, gen, card)
    if args.part in ("all", "deep"):
        runs += measure_deep(cs, e2e, dev, gen, card)
    out = {"tag": args.tag, "root": root, "card": card, "runs": runs}
    print(json.dumps(out), flush=True)
    return 0


def measure(cs, e2e, dev, gen, card: str) -> list:
    """The headline runs' records (``cs``: a ``chip_smoke`` module,
    ``e2e``: ``proshi_finito_e2e``, whose ``drive`` takes each run)."""
    from ciao_tpu_torch.prox import NormL1, Zero
    from ciao_tpu_torch.solvers.point_saga import (
        PointSAGACfg, point_saga_init, point_saga_run,
    )
    from ciao_tpu_torch.solvers.saga import SAGACfg, saga_init, saga_run

    runs = []
    x0 = torch.zeros(cs.n, device=dev)
    g = NormL1(torch.tensor(cs.LAM, dtype=torch.float32, device=dev))
    for storage in ("int8", "f32"):
        F, gamma, _ = cs.lasso(gen, dev, cs.N, cs.n, storage)
        cfg = SAGACfg(N=cs.N, sag=False, batch=cs.B, block=True, coeff=True,
                      fused=True)
        st0 = saga_init(F, g, x0, gamma, 0, cfg)
        runs.append(e2e.drive(
            cs, card, f"SAGA headline {storage}",
            lambda st, k, F=F, cfg=cfg: saga_run(F, g, st, cfg, k), st0,
            cs.MAIN_STEPS, lambda st, F=F: cs.cost(F, g, st.z),
            {"kernel #3": ("loopless_steps", "rows_kernel",
                           "saga_finish")}))
        del F, st0
        torch.cuda.empty_cache()
    zero = Zero()
    for kind, storage in (("lsq", "f32"), ("lsq", "int8"),
                          ("logistic", "f32"), ("logistic", "int8")):
        A = torch.randn(cs.N, cs.n, generator=gen, device=dev)
        b = torch.randn(cs.N, generator=gen, device=dev)
        Lm = float((A * A).sum(dim=1).max()) * cs.N
        F, _ = cs.row_oracle(kind, A, b, gen)
        del A
        if storage != "f32":
            F = F.with_storage(storage)
        gamma = 1.0 / ((3.0 if kind == "lsq" else 0.75) * Lm)
        cfg = PointSAGACfg(N=cs.N, batch=cs.B, block=True, fused=True)
        st0 = point_saga_init(F, zero, x0, gamma, 0, cfg)
        runs.append(e2e.drive(
            cs, card, f"Point-SAGA headline {kind} {storage}",
            lambda st, k, F=F, cfg=cfg: point_saga_run(F, zero, st, cfg, k),
            st0, cs.NEW_STEPS, lambda st, F=F: cs.cost64(F, zero, st.x),
            {"kernel #12": PS_KERNELS}))
        del F, st0
        torch.cuda.empty_cache()
    return runs


def measure_deep(cs, e2e, dev, gen, card: str) -> list:
    """The deep target's Point-SAGA records, as :func:`measure`'s."""
    from ciao_tpu_torch.prox import Zero
    from ciao_tpu_torch.solvers.point_saga import (
        PointSAGACfg, point_saga_init, point_saga_run,
    )

    runs = []
    prob = cs.DeepProblem(gen, dev)
    Nd, Bd = cs.DEEP["N"], cs.DEEP["B"]
    xd = torch.zeros(cs.DEEP["n"], device=dev)
    zero = Zero()
    gamma = 1.0 / (3.0 * float(prob.L.max()))
    for storage in ("f32", "int8"):
        F = prob.oracle(storage)
        cfg = PointSAGACfg(N=Nd, batch=Bd, block=True, fused_stream=True)
        st0 = point_saga_init(F, zero, xd, gamma, 0, cfg)
        runs.append(e2e.drive(
            cs, card, f"Point-SAGA deep lsq {storage}",
            lambda st, k, F=F, cfg=cfg: point_saga_run(F, zero, st, cfg, k),
            st0, cs.NEW_DEEP_STEPS,
            lambda st, F=F: prob.objective(F, zero, st.x),
            {"kernel #15": PS_KERNELS}))
        del F, st0
        torch.cuda.empty_cache()
    return runs


if __name__ == "__main__":
    sys.exit(main())
