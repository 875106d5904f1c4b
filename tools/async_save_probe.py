#!/usr/bin/env python3
"""Times the steps of SAGA's full-table iterator at the headline (262,144 x
1,024 f32 rows, B = 4,096: a 1 GiB table, kernel #1 a step) on one NVIDIA
GPU while a checkpoint write is in flight, to find what slows them.

    python3 tools/async_save_probe.py MODE [--root DIR] [--tag NAME]

MODE is ``alloc``, ``clone`` or ``save``; run each in a process of its
own, so that PyTorch's device and pinned host caches start empty. Each
first times 64 steps twice with nothing beside them. Then ``alloc`` times
64 steps while a thread allocates pinned host memory of the table's size
(no copy, no file); ``clone`` times a device copy of the state's table
twice, the first into a cold device cache (what ``save_async``'s snapshot
costs the caller); and ``save`` times 64 steps beside each of three
``checkpoint.save_async`` writes of the state in turn (the first into
cold caches), each file loaded back and held to its snapshot bit for bit. A step's host time
is taken without a device sync, so a stall of the launching thread shows
as one long step. The package and ``chip_smoke.py``'s helpers are those of
``DIR`` (default: this checkout), so two versions compare in one call.
Prints one line ``PROBE {json}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import torch

STEPS = 64


def steps(stream, k: int):
    """k steps of ``stream``: ms a step (host start to device end), the
    longest step's host ms and how many steps took over 5 ms of host."""
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    for _ in range(k):
        last = next(stream)
        t.append(time.perf_counter())
    torch.cuda.synchronize()
    end = time.perf_counter()
    d = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return dict(ms=(end - t[0]) * 1e3 / k, max_ms=max(d),
                over_5ms=sum(x > 5 for x in d)), last


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("alloc", "clone", "save"))
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke as cs
    from ciao_tpu_torch import SAGA, checkpoint
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers import loop, take

    if not torch.cuda.is_available():
        raise SystemExit("async_save_probe: no CUDA device")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    F, _, L = cs.lasso(gen, dev, cs.N, cs.n, "f32")
    solver = SAGA(table="full", block_sampling=True, batch=cs.B)
    stream = iter(solver.iterator(torch.zeros(cs.n, device=dev), F=F,
                                  g=NormL1(torch.tensor(0.1, device=dev)),
                                  L=L))
    st = loop(take(stream, 17))
    out = {"tag": args.tag, "mode": args.mode}
    out["alone"], st = steps(stream, STEPS)
    out["alone2"], st = steps(stream, STEPS)
    if args.mode == "alloc":
        nbytes = st.s.numel() * st.s.element_size()
        res = {}

        def alloc():
            t0 = time.perf_counter()
            res["buf"] = torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
            res["s"] = time.perf_counter() - t0

        th = threading.Thread(target=alloc)
        th.start()
        out["beside_alloc"], st = steps(stream, STEPS)
        th.join()
        out["alloc_s"], out["alloc_bytes"] = res["s"], nbytes
        print("PROBE " + json.dumps(out), flush=True)
        return 0
    if args.mode == "clone":
        for k in ("clone_cold_ms", "clone_warm_ms"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = st.s.clone()
            torch.cuda.synchronize()
            out[k] = (time.perf_counter() - t0) * 1e3
            del c
        print("PROBE " + json.dumps(out), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="async_save_probe_")
    for k in ("cold", "warm", "warm2"):
        path = os.path.join(tmp, f"{k}.pt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        job = checkpoint.save_async(path, st)
        ret = time.perf_counter() - t0
        r, last = steps(stream, STEPS)
        r["ret_ms"] = ret * 1e3
        r["in_flight"] = not job.done()
        job.wait_until_finished()
        r["done_s"] = time.perf_counter() - t0
        back = checkpoint.load(path, device=dev)
        r["equal"] = all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(back, st))
        out[k] = r
        del back
        os.remove(path)
        st = last
    os.rmdir(tmp)
    print("PROBE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
