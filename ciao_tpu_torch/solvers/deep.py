"""``deep_solve`` — the deep-accuracy endgame as one call.

Counterpart of ``ciao_tpu/solvers/deep.py``:

1. **Stochastic stage** — (optionally staged-precision) block SAGA via
   :func:`ciao_tpu_torch.solvers.staged_saga`, to the f32 solver floor
   (rel ~√N·eps of the full-gradient reduction). At the 10,485,760-row
   deep target the facade routes it to the streamed kernel.
2. **Polish stage** — compensated-gradient monotone FISTA
   (:func:`ciao_tpu_torch.solvers.fista_polish`) with η =
   ``eta_safety``/λ̂, λ̂ from :func:`ciao_tpu_torch.solvers.power_lmax`,
   until the fixed-point residual stalls.

The accuracy the JAX package reached on the deep target (rel 7.62e-9,
polish floor 2.83e-8) holds on any hardware and is what the port is
held to. Not ported yet: the block-protocol route of the sparse oracles
(ROADMAP.md, queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ciao_tpu_torch.solvers.polish import fista_polish, power_lmax
from ciao_tpu_torch.solvers.staged import StagedInfo, staged_saga


@dataclasses.dataclass
class DeepSolveInfo:
    """What the deep solve did."""

    staged: StagedInfo          # the stochastic stage's per-stage record
    lmax: float                 # curvature bound the polish step used
    eta: float                  # polish stepsize (= eta_safety / lmax)
    polish_steps: int           # FISTA steps actually run
    fp_res: List[float]         # fixed-point residual per polish round


def _largest_divisor_leq(N: int, c: int) -> int:
    c = min(c, N)
    while N % c:
        c -= 1
    return c


def deep_solve(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    storages: Sequence[str] = ("f32",),
    batch: int = 4096,
    chunk_epochs: int = 16,
    plateau_rtol: float = 1e-5,
    max_epochs: int = 4096,
    gamma: Optional[float] = None,
    importance_sampling: bool = False,
    polish_steps: int = 4,
    polish_max_rounds: int = 16,
    polish_chunk: int = 32_768,
    power_iters: int = 6,
    eta_safety: float = 0.9,
    margin_slack: float = 0.0,
    seed: int = 0,
    observe=None,
) -> Tuple[torch.Tensor, DeepSolveInfo]:
    """Solve ``min (1/N) Σ f_i + g`` to deep relative accuracy, past the
    f32 gradient floor: staged block SAGA to its plateau, then
    compensated-gradient FISTA polish with a stepsize from a curvature
    power bound.

    ``F`` is a rank-1 coefficient oracle with dense f32 (or bf16) rows;
    the margin protocol (``coeff_from_margin``,
    ``hess_weight_from_margin``) supplies the loss. For a staged start
    pass e.g. ``storages=("int8", "f32")``: the narrow stages are built
    with ``F.with_storage`` and the polish always runs on ``F`` itself.
    ``g`` needs ``prox_only``. ``importance_sampling=True`` draws the
    stochastic stage's blocks ∝ their Lipschitz constants; the polish
    samples nothing. The polish stops when the fixed-point residual
    decreases less than 1.33× over a round (one host read of it per
    round, none inside the steps). ``observe(z)``, if given, is called
    after every stochastic chunk and every polish round.

    Returns ``(x, DeepSolveInfo)``.
    """
    from ciao_tpu_torch.prox import Zero

    if not hasattr(F, "coeff_rows_data"):
        raise NotImplementedError(
            "deep_solve for oracles without dense rows (the block-protocol "
            "polish of the sparse layouts) is not ported yet: ROADMAP.md, "
            "queue 1 item 16")
    if N is None:
        N = F.num_terms

    z, sinfo = staged_saga(
        x0, F, g, L, N,
        storages=storages, batch=batch, chunk_epochs=chunk_epochs,
        plateau_rtol=plateau_rtol, max_epochs=max_epochs, gamma=gamma,
        importance_sampling=importance_sampling, seed=seed,
        observe=observe,
    )
    if g is None:
        g = Zero()

    lmax = float(power_lmax(F, z, seed + 1, iters=power_iters,
                            margin_slack=margin_slack))
    eta = torch.tensor(eta_safety / lmax, dtype=torch.float32)
    chunk = _largest_divisor_leq(N, polish_chunk)

    fp_hist: List[float] = []
    steps = 0
    for _ in range(polish_max_rounds):
        res = fista_polish(F, g, z, eta, polish_steps, chunk)
        z = res.x
        steps += polish_steps
        fp = float(res.fp_res)
        fp_hist.append(fp)
        if observe is not None:
            observe(z)
        # the compensated-gradient floor: the residual stops contracting
        # (FISTA on a κ ≈ 1 basin contracts far more than 1.33× a round)
        if fp == 0.0 or (len(fp_hist) >= 2 and fp > fp_hist[-2] / 1.33):
            break

    return z, DeepSolveInfo(staged=sinfo, lmax=lmax, eta=float(eta),
                            polish_steps=steps, fp_res=fp_hist)
