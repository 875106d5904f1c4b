#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ciao_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's main path, the SAGA headline of ``bench.py``: a dense
Lasso with N = 262,144 rows of n = 1,024 columns stored int8, NormL1(0.1),
block-sampled coefficient-table SAGA at B = 4,096 through ``saga_init`` and
``saga_run``, whose steps run in the hand-written CUDA kernel
``ciao_tpu_torch/csrc/saga_coeff_multistep.cu``. Phases, one line each:

  1. device: CUDA present (else exit 2), the card's name and power limit;
  2. build: the kernel compiled by nvcc from this checkout;
  3. kernel == plain version: the kernel against its plain PyTorch version
     on the card, f32/bf16/int8 rows, SAGA and SAG, with and without
     direction weights, at a small shape (and at widths that are not
     whole 16-byte chunks) and at the headline shape;
  4. main path: 8 epochs of the headline at int8 and at f32 rows, and the
     ``SAGA`` facade on a planted Lasso, with the kernel's launch count;
  5. times: ms per step of the kernel and of the plain version at the
     headline shape, with the card's name and power limit.

Then a JSON line of the kernels, and last ``{"ok": true, "device": ...}``.
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

# the bench.py headline
N, n, B, LAM = 262_144, 1_024, 4_096, 0.1
EPOCH_STEPS = N // B          # 64 steps visit N rows on average
MAIN_STEPS = 8 * EPOCH_STEPS  # 512 steps: four 128-step kernel launches

# kernel-vs-plain comparisons: the small shape, and K steps at the headline
SMALL = dict(N=8_192, n=256, B=512, K=64)
HEADLINE_K = 8

# the facade's planted Lasso: 16,384 steps of B = 1,024 are 256 epochs
FACADE = dict(N=65_536, p=16, batch=1_024, maxit=16_385)

# Tolerances of the kernel against its plain version, as errors relative to
# the largest entry of the plain version's output. Both run the same
# arithmetic in f32 but sum in other orders (the kernel per lane and by
# shuffles, cuBLAS by its own tiling), so the states drift apart by f32
# rounding over the K steps. On an H100 (700 W) the largest such errors over
# all comparisons below were 6e-8 for z and 2.3e-7 for c and av with
# exact-f32 dots, and 2.2e-7 for z and 2.9e-6 for c and av where both dot
# operands round to bf16, where a rounding difference in z can move one bf16
# operand by an ulp (2^-8). The bounds keep a margin of at least 17x.
Z_TOL = {False: 1e-6, True: 1e-5}
STATE_TOL = {False: 1e-5, True: 1e-4}


def log(msg: str) -> None:
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
    scale N, stored ``storage``; γ = 1/(3·L_max) as bench.py sets it."""
    from ciao_tpu_torch.oracles import LeastSquaresRows

    A = torch.randn(rows, cols, generator=gen, device=dev)
    b = torch.randn(rows, generator=gen, device=dev)
    L_max = float((A * A).sum(dim=1).max()) * rows
    F = LeastSquaresRows(A, b, torch.tensor(float(rows), device=dev))
    if storage != "f32":
        F = F.with_storage(storage)
    return F, torch.tensor(1.0 / (3.0 * L_max), dtype=torch.float32,
                           device=dev)


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


def compare(F, gamma, gen, dev, B_, K, sag, weighted, precision, tag):
    """Kernel and plain version from one state on one schedule; returns
    the largest absolute error of z and raises past the tolerances."""
    from ciao_tpu_torch.ops.fused_block import (
        _lowp, saga_coeff_multistep, saga_coeff_multistep_ref,
    )

    c, z, av, starts, sc, wgts = kernel_inputs(F, gamma, gen, dev, B_, K,
                                               sag, weighted)
    rows, offs = F.coeff_rows_data()
    outs = []
    for fn in (saga_coeff_multistep, saga_coeff_multistep_ref):
        st = [c.clone(), z.clone(), av.clone()]
        fn(rows, offs, starts, *st, sc, B_, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts)
        outs.append(st)
    torch.cuda.synchronize()
    lowp = _lowp(rows, precision)
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


def phase_check(gen, dev) -> float:
    worst = 0.0
    s = SMALL
    for storage, precision in (("f32", "highest"), ("f32", "default"),
                               ("bf16", "highest"), ("int8", "highest")):
        F, gamma = lasso(gen, dev, s["N"], s["n"], storage)
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
        F, gamma = lasso(gen, dev, s["N"], cols, storage)
        tag = f"N={s['N']} n={cols} B={s['B']} K={s['K']} {storage} SAGA"
        worst = max(worst, compare(F, gamma, gen, dev, s["B"], s["K"], False,
                                   True, "highest", tag))
        del F
    for storage in ("f32", "bf16", "int8"):
        F, gamma = lasso(gen, dev, N, n, storage)
        tag = f"N={N} n={n} B={B} K={HEADLINE_K} {storage} SAGA"
        worst = max(worst, compare(F, gamma, gen, dev, B, HEADLINE_K, False,
                                   False, "highest", tag))
        del F
    return worst


def run_headline(gen, dev, storage: str, kernel) -> dict:
    """saga_init, then 8 epochs of saga_run through the kernel's gate."""
    from ciao_tpu_torch.monitor import objective
    from ciao_tpu_torch.ops import saga_multistep_available
    from ciao_tpu_torch.prox import NormL1
    from ciao_tpu_torch.solvers.saga import (
        LAUNCH_STEPS, SAGACfg, saga_init, saga_run,
    )

    F, gamma = lasso(gen, dev, N, n, storage)
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


def run_facade(dev, seed: int, kernel) -> None:
    """The SAGA facade, as a user calls it, on a planted Lasso."""
    import numpy as np

    from ciao_tpu_torch import SAGA, LeastSquaresRows, NormL1
    from ciao_tpu_torch.utils.problems import make_lasso

    Np, batch, maxit = FACADE["N"], FACADE["batch"], FACADE["maxit"]
    prob = make_lasso(N=Np, n=n, p=FACADE["p"], seed=seed,
                      well_conditioned=True)
    F = LeastSquaresRows(
        torch.tensor(prob.A, dtype=torch.float32, device=dev),
        torch.tensor(prob.b, dtype=torch.float32, device=dev), float(Np))
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


def time_per_step(fn, F, gamma, gen, dev, K: int, reps: int) -> float:
    """ms per step of ``fn`` (kernel wrapper or plain version) at the
    headline shape, by CUDA events over ``reps`` calls of K steps after one
    warm-up call."""
    c, z, av, starts, sc, _ = kernel_inputs(F, gamma, gen, dev, B, K, False,
                                            False)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    fn(rows, offs, starts, c, z, av, sc, B, rs=rs)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn(rows, offs, starts, c, z, av, sc, B, rs=rs)
    t1.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("timed run gave non-finite z")
    return t0.elapsed_time(t1) / (reps * K)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port's "
              "kernels on an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ciao_tpu_torch.ops import _build
    from ciao_tpu_torch.ops.fused_block import (
        saga_coeff_multistep, saga_coeff_multistep_ref,
    )
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    log(card)
    log(f"phase 1 device: {kind}, {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {card}")

    # 2. build
    t0 = time.perf_counter()
    _build.load("saga_coeff_multistep")
    report = [l.strip() for l in _build.build_log(
        "saga_coeff_multistep").splitlines() if "Used" in l or "spill" in l]
    log(f"phase 2 build: saga_coeff_multistep.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in report:
        log(f"  ptxas: {line}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. kernel == plain version
    max_err = phase_check(gen, dev)
    log(f"phase 3 kernel == plain version: ok, max |dz| {max_err:.3e}")

    # 4. main path
    saga_coeff_multistep.launches = 0
    int8 = run_headline(gen, dev, "int8", saga_coeff_multistep)
    f32 = run_headline(gen, dev, "f32", saga_coeff_multistep)
    run_facade(dev, args.seed, saga_coeff_multistep)
    launches = saga_coeff_multistep.launches
    log(f"phase 4 main path: ok, {launches} kernel launches")

    # 5. times, in turns: plain, kernel, kernel, plain
    times = {}
    for storage, run in (("int8", int8), ("f32", f32)):
        F, gamma = run["F"], run["gamma"]
        plain = [time_per_step(saga_coeff_multistep_ref, F, gamma, gen, dev,
                               LAUNCH_STEPS, 1)]
        kern = [time_per_step(saga_coeff_multistep, F, gamma, gen, dev,
                              LAUNCH_STEPS, 4) for _ in range(2)]
        plain.append(time_per_step(saga_coeff_multistep_ref, F, gamma, gen,
                                   dev, LAUNCH_STEPS, 1))
        times[storage] = (sum(kern) / 2, sum(plain) / 2)
        log(f"  {storage} rows, N={N} n={n} B={B}: kernel "
            f"{kern[0]:.4f}/{kern[1]:.4f} ms/step, plain version "
            f"{plain[0]:.4f}/{plain[1]:.4f} ms/step [{card}]")
    log(f"phase 5 times: int8 kernel {times['int8'][0]:.4f} ms/step, plain "
        f"{times['int8'][1]:.4f}; f32 kernel {times['f32'][0]:.4f}, plain "
        f"{times['f32'][1]:.4f} [{card}]")

    log(json.dumps({"kernels": [{
        "name": "saga_coeff_multistep",
        "route": "cuda",
        "source": "ciao_tpu_torch/csrc/saga_coeff_multistep.cu",
        "replaces": "ciao_tpu/ops/fused_block.py:371",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["int8"][0],
        "plain_ms": times["int8"][1],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
