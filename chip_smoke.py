#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ciao_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's two main paths through its two hand-written CUDA kernels,
``ciao_tpu_torch/csrc/saga_coeff_multistep.cu`` (kernel #3 of PERF.md) and
``saga_coeff_multistep_streamed.cu`` (kernel #4):

- the SAGA headline of ``bench.py``: a dense Lasso with N = 262,144 rows of
  n = 1,024 columns stored int8 or f32, NormL1(0.1), block-sampled
  coefficient-table SAGA at B = 4,096 through ``saga_init`` and
  ``saga_run`` (kernel #3), and the ``SAGA`` facade;
- the deep target of ``bench.py``: ``deep_solve`` on the planted
  10,485,760 x 128 Lasso (100 live columns) at B = 8,192, whose streamed
  SAGA stage runs kernel #4, then the compensated FISTA polish; and the
  ``SAGA`` facade with importance sampling on the same problem.

Phases, one line each:

  1. device: CUDA present (else exit 2), the card's name and power limit;
  2. build: both kernels compiled by nvcc from this checkout, in parallel;
  3. kernel #3 == plain version: f32/bf16/int8 rows, SAGA and SAG, with and
     without direction weights, at a small shape (and at widths that are not
     whole 16-byte chunks) and at the headline shape;
  3b. kernel #4 == plain version: the same matrix at N = 8,192, n = 128,
     B = 128, K = 64 with clamp counts f = K and f = 23, masked steps bit
     for bit, and K = 8 at the deep target's shape;
  4. headline path: 8 epochs of the headline at int8 and at f32 rows, and
     the ``SAGA`` facade on a planted Lasso, with kernel #3's launch count;
  4b. deep path: ``deep_solve`` to rel <= 1e-6 (f32 cold, f32 warm, and
     int8 -> f32), kernel #4's launch count against the epochs run and
     kernel #3's unmoved;
  4c. importance route: ``SAGA(importance_sampling=True)`` for 32 epochs on
     the streamed route through kernel #4 with weights;
  5. times at the headline shape: ms per step of kernel #3 and of its plain
     version, with the card's name and power limit;
  5b. times at the deep target's shape: the same for kernel #4.

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

# the deep target of bench.py (deep_target_10m): 10,485,760 rows, 128
# columns of which 100 are live, B = 8,192 (d = 1,280 blocks), 8 planted
# nonzeros, λ = 1, ρ = 10, scale N, L_i = ‖a_i‖²·N
DEEP = dict(N=10 * 1024 * 1024, n=128, live=100, B=8_192, p=8, lam=1.0,
            rho=10.0)
DEEP_KW = dict(batch=DEEP["B"], chunk_epochs=16, plateau_rtol=1e-5,
               max_epochs=192, polish_steps=4, polish_max_rounds=8,
               polish_chunk=32_768)
DEEP_REL = 1e-6
IMPORTANCE_EPOCHS = 32
# kernel #4 against its plain version: d = 64 blocks, as tests/test_ops.py
SMALL_STREAM = dict(N=8_192, n=128, B=128, K=64, f=23)
DEEP_K = 8

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


def compare(F, gamma, gen, dev, B_, K, sag, weighted, precision, tag,
            streamed=False, f=None):
    """A kernel and its plain version from one state on one schedule
    (kernel #4 with clamp count ``f`` when ``streamed``, else kernel #3);
    returns the largest absolute error of z and raises past the
    tolerances."""
    from ciao_tpu_torch.ops import fused_block as fb

    c, z, av, starts, sc, wgts = kernel_inputs(F, gamma, gen, dev, B_, K,
                                               sag, weighted)
    rows, offs = F.coeff_rows_data()
    if streamed:
        fns, kw = ((fb.saga_coeff_multistep_streamed,
                    fb.saga_coeff_multistep_streamed_ref), dict(f=f))
    else:
        fns, kw = (fb.saga_coeff_multistep, fb.saga_coeff_multistep_ref), {}
    outs = []
    for fn in fns:
        st = [c.clone(), z.clone(), av.clone()]
        fn(rows, offs, starts, *st, sc, B_, precision=precision,
           rs=F.coeff_rows_scale(), wgts=wgts, **kw)
        outs.append(st)
    torch.cuda.synchronize()
    lowp = fb._lowp(rows, precision)
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


def masked_identity(F, gamma, gen, dev, B_, K, f, tag) -> None:
    """Kernel #4 clamped at f leaves c, z and av bit for bit as the first f
    steps alone leave them (a masked step writes nothing); f = 0 leaves
    the state as it was."""
    from ciao_tpu_torch.ops.fused_block import saga_coeff_multistep_streamed

    c, z, av, starts, sc, wgts = kernel_inputs(F, gamma, gen, dev, B_, K,
                                               False, True)
    rows, offs = F.coeff_rows_data()

    def run(st, wg, fc):
        out = [c.clone(), z.clone(), av.clone()]
        saga_coeff_multistep_streamed(rows, offs, st, *out, sc, B_,
                                      rs=F.coeff_rows_scale(), wgts=wg, f=fc)
        torch.cuda.synchronize()
        return out

    i32 = dict(dtype=torch.int32, device=dev)
    pairs = ((run(starts, wgts, torch.tensor([f], **i32)),
              run(starts[:f], wgts[:f], None)),
             (run(starts, wgts, torch.tensor([0], **i32)), [c, z, av]))
    for got, want in pairs:
        for name, a, b in zip(("c", "z", "av"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: masked steps changed {name}")
    log(f"  {tag}: steps k >= {f} masked: c, z, av bit-identical to the "
        f"state after step {f - 1}; f = 0 leaves the state as it was")


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


def phase_check_streamed(gen, dev) -> float:
    worst = 0.0
    s = SMALL_STREAM
    for storage, precision in (("f32", "highest"), ("f32", "default"),
                               ("bf16", "highest"), ("int8", "highest")):
        F, gamma = lasso(gen, dev, s["N"], s["n"], storage)
        for sag in (False, True):
            for weighted in (False, True):
                for f in (s["K"], s["f"]):
                    tag = (f"N={s['N']} n={s['n']} B={s['B']} K={s['K']} "
                           f"f={f} {storage}/{precision} "
                           f"{'SAG' if sag else 'SAGA'}"
                           f"{' wgts' if weighted else ''}")
                    fc = torch.tensor([f], dtype=torch.int32, device=dev)
                    worst = max(worst, compare(
                        F, gamma, gen, dev, s["B"], s["K"], sag, weighted,
                        precision, tag, streamed=True, f=fc))
        masked_identity(F, gamma, gen, dev, s["B"], s["K"], s["f"],
                        f"N={s['N']} K={s['K']} {storage}")
        del F
    for storage in ("f32", "int8"):
        F, gamma = lasso(gen, dev, DEEP["N"], DEEP["n"], storage)
        tag = (f"N={DEEP['N']} n={DEEP['n']} B={DEEP['B']} K={DEEP_K} "
               f"{storage} SAGA")
        worst = max(worst, compare(F, gamma, gen, dev, DEEP["B"], DEEP_K,
                                   False, False, "highest", tag,
                                   streamed=True))
        del F
        torch.cuda.empty_cache()
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


class DeepProblem:
    """The planted deep-target Lasso of bench.py (``deep_target_10m``),
    built on the card from a seeded ``torch.Generator`` with its recipe:
    a unit dual vector y, random columns of which the first ``live`` are
    kept and capped so that |A_jᵀy| <= λ (= λ on the p largest), x* on
    those p columns with matching signs, b = A x* + y. f* = cost(x*) is
    exact up to the f32 rounding of b, so the gap needs no reference
    solver."""

    def __init__(self, gen, dev):
        Nd, nd, lam = DEEP["N"], DEEP["n"], DEEP["lam"]
        y = torch.rand(Nd, generator=gen, device=dev)
        y /= torch.linalg.vector_norm(y)
        mask = (torch.arange(nd, device=dev) < DEEP["live"]).float()
        A = torch.rand(Nd, nd, generator=gen, device=dev).mul_(2.0).sub_(1.0)
        A.mul_(mask)
        CTy = (y @ A).abs()
        pth = torch.sort(CTy).values[-DEEP["p"]]
        alpha = torch.where(mask > 0, torch.minimum(
            lam / torch.clamp(CTy, min=1e-30), lam / pth), 0.0)
        A.mul_(alpha)
        sgn = torch.sign(y @ A)
        xs = torch.where(CTy >= pth, torch.rand(nd, generator=gen, device=dev)
                         * (DEEP["rho"] / math.sqrt(DEEP["p"])) * sgn, 0.0)
        self.b = A @ xs + y
        # r* = A x* − b as computed: the f32 rounding of b is part of the
        # problem, and the gap's difference form uses this r*
        self.r_star = A @ xs - self.b
        self.A, self.xs, self.dev = A, xs, dev
        self.L = (A * A).sum(dim=1) * Nd
        self.xs64 = xs.double().cpu()
        self.f_star = (0.5 * float(self.r_star.double().square().sum())
                       + lam * float(self.xs64.abs().sum()))
        self.gamma = 1.0 / (3.0 * float(self.L.max()))

    def oracle(self, storage="f32"):
        from ciao_tpu_torch.oracles import LeastSquaresRows

        F = LeastSquaresRows(self.A, self.b, torch.tensor(
            float(DEEP["N"]), dtype=torch.float32, device=self.dev))
        return F if storage == "f32" else F.with_storage(storage)

    def prox(self):
        from ciao_tpu_torch.prox import NormL1

        return NormL1(torch.tensor(DEEP["lam"], dtype=torch.float32,
                                   device=self.dev))

    def gap_rel(self, z) -> float:
        """(cost(z) − f*)/f* in bench.py's difference form,
        ½‖u‖² + ⟨u, r*⟩ + λ(‖z‖₁ − ‖x*‖₁) with u = A(z − x*): b cancels
        exactly, the two sums run over chunks of 32,768 rows with two-sum
        carries on the card, and the L1 difference is f64 on the host."""
        from ciao_tpu_torch.solvers.polish import _two_sum

        C = 32_768
        dz = z - self.xs
        zero = torch.zeros((), device=self.dev)
        qhi = qlo = phi = plo = zero
        for i in range(0, DEEP["N"], C):
            u = self.A[i:i + C] @ dz
            qhi, qlo = _two_sum(qhi, qlo, 0.5 * (u @ u))
            phi, plo = _two_sum(phi, plo, u @ self.r_star[i:i + C])
        quad = float((qhi + qlo) + (phi + plo))
        l1 = DEEP["lam"] * (float(z.double().abs().sum().cpu())
                            - float(self.xs64.abs().sum()))
        return (quad + l1) / abs(self.f_star)

    def objective(self, F, g, z) -> float:
        return float(F.value_sum_all(z) / DEEP["N"] + g.value(z))


def run_deep(prob, storages, tag: str, card: str) -> float:
    """deep_solve on the deep target through the public call, with its
    checks: rel <= DEEP_REL, kernel #4 launched LAUNCH_STEPS-step launches
    over every epoch of the stochastic stage, kernel #3 never (the
    streamed route), a polish that ran, nothing NaN. Returns the rel gap.

    The solve's time is split by ``observe``, which deep_solve calls after
    every stochastic chunk and every polish round, each just after a host
    read of its own (the chunk's objective, the round's fp_res), so the
    sync it adds costs nothing: the stage ends at the last chunk's call,
    and the rest is the power bound and the polish rounds. The power
    bound is timed again alone after the solve."""
    from ciao_tpu_torch import deep_solve, power_lmax
    from ciao_tpu_torch.ops.fused_block import (
        saga_coeff_multistep, saga_coeff_multistep_streamed,
    )
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    F, g = prob.oracle(), prob.prox()
    k3, k4 = saga_coeff_multistep.launches, saga_coeff_multistep_streamed.launches
    marks = []

    def observe(_z):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = deep_solve(torch.zeros(DEEP["n"], device=prob.dev), F, g,
                         L=prob.L, N=DEEP["N"], storages=storages,
                         observe=observe, **DEEP_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    d4 = saga_coeff_multistep_streamed.launches - k4
    want = sum(info.staged.epochs) * (DEEP["N"] // DEEP["B"]) // LAUNCH_STEPS
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{tag}: the solution has non-finite values")
    chunks = sum(info.staged.epochs) // DEEP_KW["chunk_epochs"]
    if len(marks) != chunks + len(info.fp_res):
        raise AssertionError(f"{tag}: {len(marks)} observe calls for "
                             f"{chunks} chunks and {len(info.fp_res)} rounds")
    stage, polish = marks[chunks - 1] - t0, marks[-1] - marks[chunks - 1]
    t1 = time.perf_counter()
    power_lmax(F, x, 1, iters=6)
    torch.cuda.synchronize()
    power = time.perf_counter() - t1
    rel = prob.gap_rel(x)
    log(f"  {tag}: storages {list(storages)}, epochs per stage "
        f"{info.staged.epochs} (plateau {info.staged.switched_early}), "
        f"objectives {['%.9e' % o for o in info.staged.objectives]}, "
        f"lmax {info.lmax:.6e}, eta {info.eta:.6e}, {info.polish_steps} "
        f"polish steps, fp_res {['%.3e' % r for r in info.fp_res]}; "
        f"rel {rel:.3e} in {dt:.3f} s: stochastic stage {stage:.3f} s "
        f"({chunks} chunks), power bound and {len(info.fp_res)} polish "
        f"rounds {polish:.3f} s, return {dt - (marks[-1] - t0):.4f} s; "
        f"power bound alone {power:.4f} s, so "
        f"{(polish - power) / info.polish_steps:.4f} s per polish step; "
        f"kernel #4 launches {d4} [{card}]")
    if not (math.isfinite(rel) and rel <= DEEP_REL):
        raise AssertionError(f"{tag}: rel {rel:.3e} > {DEEP_REL}")
    if d4 != want or saga_coeff_multistep.launches != k3:
        raise AssertionError(
            f"{tag}: kernel #4 launched {d4} times (expected {want}), "
            f"kernel #3 {saga_coeff_multistep.launches - k3} times")
    if info.polish_steps <= 0 or not all(map(math.isfinite, info.fp_res)):
        raise AssertionError(f"{tag}: the polish did not run: {info}")
    return rel


def run_importance(prob, card: str) -> None:
    """The SAGA facade with importance sampling on the deep target: the
    streamed route with the systematic schedule, whole 64-step windows
    through kernel #4 with weights (the wrapper's own counts), and a
    falling objective."""
    from ciao_tpu_torch import SAGA
    from ciao_tpu_torch.ops.fused_block import saga_coeff_multistep_streamed

    F, g = prob.oracle(), prob.prox()
    d = DEEP["N"] // DEEP["B"]
    steps = IMPORTANCE_EPOCHS * d
    solver = SAGA(maxit=steps + 1, block_sampling=True, batch=DEEP["B"],
                  importance_sampling=True)
    x0 = torch.zeros(DEEP["n"], device=prob.dev)
    cfg = solver._setup(x0, F, g, prob.L, DEEP["N"])[3]
    if not (cfg.importance and cfg.istrat and cfg.fused_stream
            and not cfg.fused):
        raise AssertionError(f"importance: not the streamed istrat route: "
                             f"{cfg}")
    kernel = saga_coeff_multistep_streamed
    K = min(cfg.iwin, d)
    windows = (1 + steps - K) // K  # steps before it = K are stepwise
    obj0 = prob.objective(F, g, x0)
    before = kernel.launches, kernel.weighted_launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it = solver(x0, F=F, g=g, L=prob.L)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernel.launches - before[0]
    weighted = kernel.weighted_launches - before[1]
    obj1 = prob.objective(F, g, x)
    log(f"  importance: SAGA(block_sampling=True, batch={DEEP['B']}, "
        f"importance_sampling=True), {steps} steps (iwin {cfg.iwin}): "
        f"{launches} launches of {K} steps, {weighted} of them weighted, "
        f"objective {obj0:.9e} -> {obj1:.9e}, rel {prob.gap_rel(x):.3e}, "
        f"{dt:.3f} s [{card}]")
    if not launches == weighted == windows:
        raise AssertionError(f"importance: {launches} launches, {weighted} "
                             f"weighted (expected {windows}, all weighted)")
    if not (math.isfinite(obj1) and obj1 < obj0):
        raise AssertionError(f"importance: objective {obj0} -> {obj1}")


def time_per_step(fn, F, gamma, gen, dev, B_: int, K: int,
                  reps: int) -> float:
    """ms per step of ``fn`` (kernel wrapper or plain version) at blocks of
    B_ rows of ``F``, by CUDA events over ``reps`` calls of K steps after
    one warm-up call."""
    c, z, av, starts, sc, _ = kernel_inputs(F, gamma, gen, dev, B_, K, False,
                                            False)
    rows, offs = F.coeff_rows_data()
    rs = F.coeff_rows_scale()
    fn(rows, offs, starts, c, z, av, sc, B_, rs=rs)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(reps):
        fn(rows, offs, starts, c, z, av, sc, B_, rs=rs)
    t1.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(z).all()):
        raise AssertionError("timed run gave non-finite z")
    return t0.elapsed_time(t1) / (reps * K)


KERNELS = ("saga_coeff_multistep", "saga_coeff_multistep_streamed")


def build_all() -> None:
    """Both kernels' nvcc runs started together, then loaded."""
    from concurrent.futures import ThreadPoolExecutor

    from ciao_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.build, KERNELS))
    for name in KERNELS:
        _build.load(name)
    log(f"phase 2 build: {', '.join(f'{k}.cu' for k in KERNELS)} built "
        f"and loaded in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def timed_turns(kernel, plain, F, gamma, gen, dev, B_, tag, card):
    """(kernel, plain) ms per step in turns: plain, kernel, kernel, plain."""
    from ciao_tpu_torch.solvers.saga import LAUNCH_STEPS

    pl = [time_per_step(plain, F, gamma, gen, dev, B_, LAUNCH_STEPS, 1)]
    kern = [time_per_step(kernel, F, gamma, gen, dev, B_, LAUNCH_STEPS, 4)
            for _ in range(2)]
    pl.append(time_per_step(plain, F, gamma, gen, dev, B_, LAUNCH_STEPS, 1))
    log(f"  {tag}: kernel {kern[0]:.4f}/{kern[1]:.4f} ms/step, plain version "
        f"{pl[0]:.4f}/{pl[1]:.4f} ms/step [{card}]")
    return sum(kern) / 2, sum(pl) / 2


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
    from ciao_tpu_torch.ops.fused_block import (
        saga_coeff_multistep, saga_coeff_multistep_ref,
        saga_coeff_multistep_streamed, saga_coeff_multistep_streamed_ref,
    )

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    log(card)
    log(f"phase 1 device: {kind}, {torch.cuda.device_count()} visible; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"nvidia-smi: {card}")

    # 2. build
    build_all()

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. kernel #3 == plain version; 3b. kernel #4 == plain version
    max_err = phase_check(gen, dev)
    log(f"phase 3 kernel #3 == plain version: ok, max |dz| {max_err:.3e}")
    max_err4 = phase_check_streamed(gen, dev)
    log(f"phase 3b kernel #4 == plain version: ok, max |dz| {max_err4:.3e}")

    # 4. the headline path, counts from 0
    saga_coeff_multistep.launches = 0
    saga_coeff_multistep_streamed.launches = 0
    int8 = run_headline(gen, dev, "int8", saga_coeff_multistep)
    f32 = run_headline(gen, dev, "f32", saga_coeff_multistep)
    run_facade(dev, args.seed, saga_coeff_multistep)
    launches = saga_coeff_multistep.launches
    if launches == 0 or saga_coeff_multistep_streamed.launches != 0:
        raise AssertionError("the headline path did not run on kernel #3 "
                             "alone")
    log(f"phase 4 headline path: ok, {launches} kernel #3 launches")

    # 4b, 4c. the deep path, counts from 0
    t0 = time.perf_counter()
    prob = DeepProblem(gen, dev)
    torch.cuda.synchronize()
    log(f"  deep target: planted {DEEP['N']} x {DEEP['n']} Lasso "
        f"({DEEP['live']} live columns) built on the card in "
        f"{time.perf_counter() - t0:.2f} s, f* = {prob.f_star:.9f}")
    saga_coeff_multistep.launches = 0
    saga_coeff_multistep_streamed.launches = 0
    rels = [run_deep(prob, ("f32",), "deep_solve f32 (cold)", card),
            run_deep(prob, ("f32",), "deep_solve f32 (warm)", card),
            run_deep(prob, ("int8", "f32"), "deep_solve int8->f32", card)]
    run_importance(prob, card)
    launches4 = saga_coeff_multistep_streamed.launches
    if launches4 == 0 or saga_coeff_multistep.launches != 0:
        raise AssertionError("the deep path did not run on kernel #4 alone")
    log(f"phase 4b/4c deep path: ok, rel {['%.3e' % r for r in rels]}, "
        f"{launches4} kernel #4 launches")

    # 5. times at the headline shape, in turns
    times = {}
    for storage, run in (("int8", int8), ("f32", f32)):
        times[storage] = timed_turns(
            saga_coeff_multistep, saga_coeff_multistep_ref, run["F"],
            run["gamma"], gen, dev, B,
            f"kernel #3, {storage} rows, N={N} n={n} B={B}", card)
    log(f"phase 5 times: int8 kernel {times['int8'][0]:.4f} ms/step, plain "
        f"{times['int8'][1]:.4f}; f32 kernel {times['f32'][0]:.4f}, plain "
        f"{times['f32'][1]:.4f} [{card}]")

    # 5b. times at the deep target's shape, in turns
    times4 = {}
    for storage in ("f32", "int8"):
        times4[storage] = timed_turns(
            saga_coeff_multistep_streamed, saga_coeff_multistep_streamed_ref,
            prob.oracle(storage), prob.gamma, gen, dev, DEEP["B"],
            f"kernel #4, {storage} rows, N={DEEP['N']} n={DEEP['n']} "
            f"B={DEEP['B']}", card)
    log(f"phase 5b times: f32 kernel {times4['f32'][0]:.4f} ms/step, plain "
        f"{times4['f32'][1]:.4f}; int8 kernel {times4['int8'][0]:.4f}, plain "
        f"{times4['int8'][1]:.4f} [{card}]")

    log(json.dumps({"kernels": [{
        "name": "saga_coeff_multistep",
        "route": "cuda",
        "source": "ciao_tpu_torch/csrc/saga_coeff_multistep.cu",
        "replaces": "ciao_tpu/ops/fused_block.py:371",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["int8"][0],
        "plain_ms": times["int8"][1],
    }, {
        "name": "saga_coeff_multistep_streamed",
        "route": "cuda",
        "source": "ciao_tpu_torch/csrc/saga_coeff_multistep_streamed.cu",
        "replaces": "ciao_tpu/ops/fused_block.py:577",
        "launches": launches4,
        "max_abs_err": max_err4,
        "ms": times4["f32"][0],
        "plain_ms": times4["f32"][1],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
