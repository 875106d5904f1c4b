#!/usr/bin/env python3
"""DPKatyusha's and DPSARAH's local inner loops on one rank beside the
single-card fused solvers, on one NVIDIA GPU, with the all-reduce in
three forms, so that the cost of the data-parallel path's collectives can
be told from the rest of its outer step.

    python3 tools/dp_vr_times.py [--outer 16] [--turns 4] [--seed 1]

At the headline of ``chip_smoke.py`` (262,144 x 1,024, B = 4,096,
NormL1(0.1), f32 and int8 rows), m = 2N/batch = 128 inner steps an outer
step on kernel #10 or #11 and the anchor or bootstrap pass on #6, it
times runs of ``--outer`` outer steps of:

- ``dp_nccl``: ``build_dp_functions``' run on a one-rank NCCL group;
- ``dp_gloo``: the same on a one-rank gloo group (CUDA tensors go
  through the host);
- ``dp_copy``: the NCCL run with every all-reduce replaced by a copy,
  which is what an all-reduce over one rank computes;
- ``single``: ``katyusha_run``/``sarah_run``, the single-card solver;

after a warm-up run of each, in ``--turns`` turns of alternating order,
by the host clock around a synchronize (ms an inner step), then one run
of ``dp_nccl`` and of ``single`` under ``torch.profiler``: the device's
busy time of the run. Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def busy_ms(fn) -> float:
    """The device's busy ms in one call of ``fn``, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return us / 1e3


def solvers(mesh, Fd, g, x0, Lm, kind: str, m: int):
    """(DP run, single-card run) of ``kind`` from x0, each a function of
    the outer steps."""
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.solvers import katyusha as kat
    from ciao_tpu_torch.solvers import sarah as sar

    import chip_smoke as cs

    cfg = tdp.DPCfg(N=cs.N, D=1, b_loc=cs.B, sweeping=1, alpha=0.999,
                    block=True, coeff=True, local=True, m_inner=m, fused=True,
                    variant="ns" if kind == "katyusha" else "basic")
    init, _, run, _ = parallel.build_dp_functions(kind, mesh, Fd, g, cfg)
    if kind == "katyusha":
        st0 = init(x0, Lm, 0, 0.5, 0.5)
        scfg = kat.KatyushaCfg(N=cs.N, batch=cs.B, m=m, block=True, ns=True,
                               fused=True)
        s0 = kat.katyusha_init(Fd, g, x0, Lm, 0.5, 0.5, 0, scfg)
        srun = kat.katyusha_run
    else:
        st0 = init(x0, 1.0 / (2.0 * Lm), 0, 1.0)
        scfg = sar.SARAHCfg(N=cs.N, batch=cs.B, m=m, block=True, fused=True)
        s0 = sar.sarah_init(Fd, g, x0, 1.0 / (2.0 * Lm), 1.0, 0, scfg)
        srun = sar.sarah_run
    return (lambda T: run(st0, T)), (lambda T: srun(Fd, g, s0, scfg, T))


def main() -> int:
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outer", type=int, default=16)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_vr_times: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from ciao_tpu_torch import parallel
    from ciao_tpu_torch.ops import _build
    from ciao_tpu_torch.parallel import dp as tdp
    from ciao_tpu_torch.prox import NormL1

    for name in ("coeff_apply_all", "katyusha_coeff_multistep",
                 "sarah_multistep"):
        _build.build(name)
        _build.load(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    m, T = 2 * cs.N // cs.B, args.outer
    psum = tdp._psum

    def as_copy(fn):
        def run(T_):
            tdp._psum = lambda mesh, x: x.clone()
            try:
                return fn(T_)
            finally:
                tdp._psum = psum
        return run

    out = {}
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
            dist.init_process_group(backend, store=dist.FileStore(
                os.path.join(tmp, "store"), 1), rank=0, world_size=1)
            try:
                mesh = parallel.make_mesh(device=dev)
                for storage in ("int8", "f32"):
                    F, _, L = cs.lasso(gen, dev, cs.N, cs.n, storage)
                    Fd = parallel.shard_finite_sum(F, mesh)
                    del F
                    g = NormL1(torch.tensor(cs.LAM, device=dev))
                    x0 = torch.zeros(cs.n, device=dev)
                    for kind in ("katyusha", "sarah"):
                        dp_run, single = solvers(mesh, Fd, g, x0, L.max(),
                                                 kind, m)
                        fns = {"dp_" + backend: dp_run}
                        if backend == "nccl":
                            fns.update(dp_copy=as_copy(dp_run), single=single)
                        for fn in fns.values():
                            fn(T)
                        for t in range(args.turns):
                            for k in (list(fns) if t % 2 == 0
                                      else list(fns)[::-1]):
                                torch.cuda.synchronize()
                                t0 = time.perf_counter()
                                fns[k](T)
                                torch.cuda.synchronize()
                                ms = (time.perf_counter() - t0) * 1e3 / (T * m)
                                out.setdefault(f"{storage} {kind} {k}",
                                               []).append(ms)
                        if backend == "nccl":
                            for k in ("dp_nccl", "single"):
                                out[f"{storage} {kind} {k} busy_ms"] = (
                                    busy_ms(lambda: fns[k](T)))
                    del Fd
                    torch.cuda.empty_cache()
            finally:
                dist.destroy_process_group()
    for k, v in out.items():
        if isinstance(v, list):
            print(f"{k}: {sum(v) / len(v):.5f} ms an inner step (turns "
                  + ", ".join(f"{x:.5f}" for x in v) + ")", flush=True)
        else:
            print(f"{k}: {v:.3f} ms of device time in {T} outer steps",
                  flush=True)
    print(json.dumps({"card": cs.card_info(), "outer": T, "m": m,
                      "turns": args.turns, "results": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
