#!/usr/bin/env python3
"""Time the halo of TPCondatVu's stencil K on two ranks of one GPU.

    python3 tools/tp_halo_times.py [--steps 64] [--turns 2]

Spawns two gloo ranks on the one card (CUDA tensors; NCCL refuses two
ranks on one device), makes a (1, 2) mesh and cuts the headline's
262,144 x 1,024 f32 Lasso rows over its columns. Each rank then times, in
turns A B B A, ``steps`` steps of TPCondatVu with K = FirstDifference (two
one-element halos a step over the model group) and with K = I (none), and
the two halos alone. Rank 0 prints the card's name and power limit and one
JSON line: ms a step of each, and of the halo pair.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, n, LAM, TV = 262_144, 1_024, 0.1, 0.05


def _rank(rank: int, size: int, store: str, steps: int, turns: int,
          out: str) -> None:
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.oracles import LeastSquaresRows
    from ciao_tpu_torch.ops.linmap import FirstDifference, IdentityMap
    from ciao_tpu_torch.parallel import tp
    from ciao_tpu_torch.prox import NormL1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, size),
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(minutes=5))
    try:
        mesh = parallel.make_mesh_2d(1, size, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        A = torch.randn(N, n, generator=gen, device=dev)
        b = torch.randn(N, generator=gen, device=dev)
        L = (A * A).sum(dim=1) * N
        F = parallel.shard_finite_sum_2d(LeastSquaresRows(A, b, float(N)),
                                         mesh)
        del A
        g = NormL1(torch.tensor(LAM, device=dev))
        h = NormL1(torch.tensor(TV, device=dev))
        x0 = torch.zeros(n, device=dev)
        runs = {}
        for name, K in (("firstdiff", FirstDifference()),
                        ("identity", IdentityMap())):
            _, _, _, init, _, run, _ = parallel.TPCondatVu(mesh=mesh)._setup(
                x0, F, g, h, K, L, None)
            st0 = init()
            run(st0, 4)
            runs[name] = (run, st0)
        v = torch.ones(1, device=dev)

        def halos():
            for _ in range(steps):
                tp._halo(mesh, v, -1)
                tp._halo(mesh, v, 1)

        def timed(fn):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps

        ms = {"firstdiff": [], "identity": [], "halos": []}
        for _ in range(turns):
            for name in ("firstdiff", "identity", "identity", "firstdiff"):
                run, st0 = runs[name]
                ms[name].append(timed(lambda: run(st0, steps)))
            ms["halos"].append(timed(halos))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(ms, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_halo_times: no CUDA device", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ms.json")
        mp.start_processes(_rank, args=(2, os.path.join(tmp, "store"),
                                        args.steps, args.turns, out),
                           nprocs=2, join=True, start_method="spawn")
        with open(out) as f:
            ms = json.load(f)
    print(card)
    print(json.dumps({"card": card, "steps": args.steps, "mesh": [1, 2],
                      "ms_per_step": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
