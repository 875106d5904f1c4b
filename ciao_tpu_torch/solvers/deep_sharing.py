"""Deep accuracy for the sharing formulation.

Counterpart of ``ciao_tpu/solvers/deep_sharing.py``. ``deep_solve``
covers the finite-sum class; this is the sharing analog, whose f32 floor
is another mechanism: ProShI keeps the coupling sum ``av = Σ_i s_i`` by
increments (``ProShI_basic.jl:113-123``), and a rounding drift δ in it
displaces the fixed point so the coupling sum becomes
``prox_g(av_true + δ) − δ``: the prox's exact zeros off the support are
lost and the objective pays a first-order λ‖δ‖₁. (The f32 table itself
is not the floor: at the optimum the objective is stationary in the full
(N·n) variable, so the table's rounding costs rel ~eps².)

The fix costs one table pass per chunk: ProShI in chunks, the coupling
sum resynced exactly at every chunk boundary by a compensated (two-sum)
chunked reduction (:func:`proshi_resync`), then ``z`` refreshed. The
final resync restores the exact prox structure of the returned blocks.
Reference anchor: ``test/test_sharing.jl:31-32`` reaches 1e-4 in f64;
:func:`ciao_tpu_torch.utils.problems.make_sharing_planted` gives the
any-scale exact optimum this route is measured against.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass
class DeepSharingInfo:
    """What the deep sharing solve did."""

    objs: List[float]     # compensated sharing objective per chunk
    epochs: int           # block-epochs run
    resyncs: int          # exact coupling-sum resyncs performed


def deep_solve_sharing(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    gamma=None,
    sweeping: int = 2,
    batch: int = 1,
    chunk_epochs: int = 16,
    max_epochs: int = 4096,
    plateau_rtol: float = 1e-9,
    resync_chunk: int = 4096,
    seed: int = 0,
    device=None,
) -> Tuple[torch.Tensor, DeepSharingInfo]:
    """Solve ``min (1/N) Σ f_i(x_i) + g(Σ x_i)`` to deep relative
    accuracy in f32: ProShI in ``chunk_epochs``-sized chunks with an
    exact compensated coupling-sum resync at every chunk boundary,
    stopping when the (compensated) sharing objective plateaus.

    Returns ``(blocks, info)``: the (N, n) block solutions
    x_i = s_i + γ_i z after the last resync, so the returned coupling sum
    carries the prox's exact zero structure. Parameters mirror the
    :class:`Proshi` facade (``sweeping``, ``batch``, ``gamma``/``L``,
    ``device``); ``resync_chunk`` is the chunk of the compensated
    reductions (rounded down to a divisor of N)."""
    from ciao_tpu_torch.runtime import expected_fallback
    from ciao_tpu_torch.solvers.proshi import (
        Proshi, proshi_resync, proshi_run, sharing_objective,
    )

    facade = Proshi(gamma=gamma, sweeping=sweeping,
                    minibatch=(batch > 1, batch), seed=seed, device=device)
    # the route is stepwise by design (quadratic blocks are not rank 1: no
    # kernel serves the class), so the facade's fallback warning carries
    # no signal here
    with expected_fallback():
        _, F, g, cfg, init = facade._setup(x0, F, g, L, N)
    state = init()
    steps = chunk_epochs * (cfg.N // cfg.batch)

    objs = [float(sharing_objective(F, g, state, resync_chunk))]
    resyncs = epochs = 0
    for _ in range(max(1, max_epochs // chunk_epochs)):
        state = proshi_run(F, g, state, cfg, steps)
        state = proshi_resync(g, state, resync_chunk)
        resyncs += 1
        epochs += chunk_epochs
        obj = float(sharing_objective(F, g, state, resync_chunk))
        objs.append(obj)
        if abs(objs[-2] - obj) <= plateau_rtol * max(abs(obj), 1e-30):
            break
    return state.solution, DeepSharingInfo(objs=objs, epochs=epochs,
                                           resyncs=resyncs)
