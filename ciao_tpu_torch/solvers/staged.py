"""Staged-precision solving: SAGA on narrow row storage first, then wide.

Counterpart of ``ciao_tpu/solvers/staged.py``. The early epochs run on
int8- (or bf16-) stored rows, which a step reads in a quarter (half) of
the f32 bytes, and the run then switches to f32 rows for the finish,
with a mandatory ``saga_rebase`` at every switch: the running average is
kept by deltas, and without the rebase it keeps the old operator's bias
forever, so the finish floors near the coarse storage's quantization
error (measured in the JAX package: an int8 → f32 switch without the
rebase stalls at rel ~1.2e-3).

:func:`staged_saga` runs block-sampled SAGA in chunks of epochs through
the facade's routing (on the card, the resident or the streamed kernel),
checks the objective at each chunk's end, and moves to the next storage
when a chunk gains less than ``plateau_rtol``. :class:`StagedInfo`
records what each stage did.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class StagedInfo:
    """What the staged run did: one entry per stage."""

    storages: List[str]
    epochs: List[int]          # epochs spent in each stage
    objectives: List[float]    # objective at each stage's end
    switched_early: List[bool]  # True = the plateau fired (vs the budget)


def staged_saga(
    x0,
    F,
    g=None,
    L=None,
    N: Optional[int] = None,
    *,
    storages: Sequence[str] = ("int8", "f32"),
    batch: int = 4096,
    chunk_epochs: int = 64,
    plateau_rtol: float = 1e-3,
    max_epochs: int = 8192,
    gamma: Optional[float] = None,
    importance_sampling: bool = False,
    seed: int = 0,
    observe=None,
) -> Tuple[torch.Tensor, StagedInfo]:
    """Solve ``min (1/N) Σ f_i + g`` by SAGA with a staged row-storage
    schedule.

    ``F`` is the full-precision oracle (its ``with_storage`` makes the
    narrow stages); ``storages`` lists the stages coarsest first
    ("int8"/"bf16"/"f32"). Each stage runs ``chunk_epochs``-epoch chunks
    until the relative objective decrease of a chunk falls under
    ``plateau_rtol``, then the state is rebased under the next stage's
    oracle and the run goes on. The final stage also stops on its
    plateau. ``max_epochs`` bounds all stages together. ``observe(z)``,
    when given, sees the iterate after every chunk.
    ``importance_sampling=True`` (needs ``L``) draws blocks ∝ their
    Lipschitz constants in every stage.

    The objective check is one ``value_sum_all`` margin pass of the f32
    oracle — never the (N, n) gradient, which at the 10,485,760 × 128
    deep target would be a 5.4 GB tensor per check. Returns
    ``(solution, StagedInfo)``.
    """
    from ciao_tpu_torch.solvers.saga import SAGA, saga_rebase, saga_run

    if N is None:
        N = F.num_terms
    if N % batch != 0:
        # the largest divisor of N up to batch: blocks must tile N
        while N % batch:
            batch -= 1

    # one cfg serves every stage (the storage lives in the oracle); the
    # facade derives the routing from the f32 oracle
    solver = SAGA(maxit=1, block_sampling=True, batch=batch, gamma=gamma,
                  seed=seed, importance_sampling=importance_sampling)
    x0, F, g, cfg, init = solver._setup(x0, F, g, L, N)
    oracles = [F if s == "f32" else F.with_storage(s) for s in storages]
    state = init()

    steps_per_epoch = N // batch
    chunk = chunk_epochs * steps_per_epoch
    max_chunks = max(1, max_epochs // chunk_epochs)

    def obj(z):
        return float(F.value_sum_all(z) / F.num_terms + g.value(z))

    info = StagedInfo(storages=list(storages), epochs=[], objectives=[],
                      switched_early=[])
    chunks_used = 0
    for si, F_stage in enumerate(oracles):
        if si:
            # storage switch: the running average again from the table,
            # under the new rows
            state = saga_rebase(F_stage, state, cfg)
        prev = obj(state.z)
        stage_chunks = 0
        plateaued = False
        while chunks_used < max_chunks:
            state = saga_run(F_stage, g, state, cfg, chunk)
            cur = obj(state.z)
            stage_chunks += 1
            chunks_used += 1
            if observe is not None:
                observe(state.z)
            if prev - cur < plateau_rtol * max(abs(prev), 1e-30):
                plateaued = True
                prev = cur
                break
            prev = cur
        info.epochs.append(stage_chunks * chunk_epochs)
        info.objectives.append(prev)
        info.switched_early.append(plateaued)
        if chunks_used >= max_chunks:
            break
    return state.z, info
