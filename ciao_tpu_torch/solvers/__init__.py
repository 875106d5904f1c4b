"""Solvers of the port (SAGA/SAG, the staged schedule, the polish and
``deep_solve``) and the iteration tools."""

from ciao_tpu_torch.solvers.base import (
    SolverIterable, Status, halt, loop, run_solver_loop, solution, take,
)
from ciao_tpu_torch.solvers.deep import DeepSolveInfo, deep_solve
from ciao_tpu_torch.solvers.polish import (
    PolishResult, fista_polish, grad_mean_chunked, grad_sum_chunked,
    lsq_power_lmax, power_lmax,
)
from ciao_tpu_torch.solvers.saga import (
    SAG, SAGA, SAGACfg, SAGAState, block_starts, importance_draws,
    saga_init, saga_rebase, saga_run, saga_step,
)
from ciao_tpu_torch.solvers.staged import StagedInfo, staged_saga

__all__ = [
    "SolverIterable", "Status", "halt", "loop", "run_solver_loop",
    "solution", "take", "SAG", "SAGA", "SAGACfg", "SAGAState",
    "block_starts", "importance_draws", "saga_init", "saga_rebase",
    "saga_run", "saga_step", "DeepSolveInfo", "deep_solve", "StagedInfo",
    "staged_saga", "PolishResult", "fista_polish", "grad_mean_chunked",
    "grad_sum_chunked", "power_lmax", "lsq_power_lmax",
]
