"""Solvers of the port (SAGA/SAG so far) and the iteration tools."""

from ciao_tpu_torch.solvers.base import (
    SolverIterable, Status, halt, loop, run_solver_loop, solution, take,
)
from ciao_tpu_torch.solvers.saga import (
    SAG, SAGA, SAGACfg, SAGAState, block_starts, saga_init, saga_rebase,
    saga_run, saga_step,
)

__all__ = [
    "SolverIterable", "Status", "halt", "loop", "run_solver_loop",
    "solution", "take", "SAG", "SAGA", "SAGACfg", "SAGAState",
    "block_starts", "saga_init", "saga_rebase", "saga_run", "saga_step",
]
