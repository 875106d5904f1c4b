"""Solvers of the port (SAGA/SAG, SVRG/SVRG++, Finito/MISO with LFinito
and adaptive Finito, ProShI, Katyusha, SARAH, L-SVRG and L-Katyusha,
SSNM, Point-SAGA, forward-backward and FISTA, PANOC and ZeroFPR,
Davis-Yin and Douglas-Rachford, Condat-Vũ and Chambolle-Pock, the staged
schedule, the polish, ``deep_solve`` and ``deep_solve_sharing``) and the
iteration tools."""

from ciao_tpu_torch.solvers.base import (
    SolverIterable, Status, halt, loop, run_solver_loop, solution, take,
)
from ciao_tpu_torch.solvers.deep import DeepSolveInfo, deep_solve
from ciao_tpu_torch.solvers.deep_sharing import (
    DeepSharingInfo, deep_solve_sharing,
)
from ciao_tpu_torch.solvers.dys import (
    DavisYin, DouglasRachford, DYSCfg, DYSState, dys_init, dys_run, dys_step,
)
from ciao_tpu_torch.solvers.finito import (
    Finito, FinitoAdaptiveState, FinitoBasicState, FinitoCfg,
    FinitoCoeffState, LFinitoState, finito_adaptive_init, finito_basic_init,
    finito_coeff_init, finito_rebase, finito_run, finito_step, lfinito_init,
)
from ciao_tpu_torch.solvers.fb import (
    FISTA, FBCfg, FBState, ForwardBackward, fb_init, fb_run, fb_step,
    full_gradient,
)
from ciao_tpu_torch.solvers.katyusha import (
    Katyusha, KatyushaCfg, KatyushaState, katyusha_init, katyusha_run,
    katyusha_step,
)
from ciao_tpu_torch.solvers.lsvrg import (
    LKatyusha, LKatyushaCfg, LKatyushaState, LSVRG, LSVRGCfg, LSVRGState,
    lkatyusha_init, lkatyusha_rebase, lkatyusha_run, lkatyusha_step,
    lsvrg_init, lsvrg_rebase, lsvrg_run, lsvrg_step,
)
from ciao_tpu_torch.solvers.panoc import (
    PANOC, THRASH_EVALS, PANOCCfg, PANOCState, ZeroFPR, panoc_init,
    panoc_run, panoc_step, warn_if_thrashing,
)
from ciao_tpu_torch.solvers.point_saga import (
    PointSAGA, PointSAGACfg, PointSAGAState, point_saga_init,
    point_saga_rebase, point_saga_run, point_saga_step,
)
from ciao_tpu_torch.solvers.polish import (
    PolishResult, fista_polish, grad_mean_chunked, grad_sum_chunked,
    lsq_power_lmax, power_lmax,
)
from ciao_tpu_torch.solvers.primal_dual import (
    ChambollePock, CondatVu, PDCfg, PDState, pd_init, pd_run, pd_step,
    prox_conjugate,
)
from ciao_tpu_torch.solvers.proshi import (
    Proshi, ProshiCfg, ProshiState, proshi_init, proshi_resync, proshi_run,
    proshi_step, sharing_objective,
)
from ciao_tpu_torch.solvers.saga import (
    SAG, SAGA, SAGACfg, SAGAState, block_starts, importance_draws,
    saga_init, saga_rebase, saga_run, saga_step,
)
from ciao_tpu_torch.solvers.sarah import (
    SARAH, SARAHCfg, SARAHState, sarah_init, sarah_run, sarah_step,
)
from ciao_tpu_torch.solvers.ssnm import (
    SSNM, SSNMCfg, SSNMState, ssnm_init, ssnm_rebase, ssnm_run, ssnm_step,
)
from ciao_tpu_torch.solvers.staged import StagedInfo, staged_saga
from ciao_tpu_torch.solvers.svrg import (
    SVRG, SVRGCfg, SVRGState, svrg_init, svrg_run, svrg_step,
)


def iterator(solver, x0, **kwargs):
    """Streaming mode (reference ``Finito.jl:186-234``): the solver's
    bare iterable of states; its maxit, verbose and freq are ignored."""
    return solver.iterator(x0, **kwargs)


__all__ = [
    "SolverIterable", "Status", "halt", "loop", "run_solver_loop",
    "solution", "take", "SAG", "SAGA", "SAGACfg", "SAGAState",
    "block_starts", "importance_draws", "saga_init", "saga_rebase",
    "saga_run", "saga_step", "SVRG", "SVRGCfg", "SVRGState", "svrg_init",
    "svrg_run", "svrg_step", "ForwardBackward", "FISTA", "FBCfg", "FBState",
    "fb_init", "fb_run", "fb_step", "full_gradient", "Finito", "FinitoCfg",
    "FinitoBasicState", "FinitoCoeffState", "LFinitoState",
    "FinitoAdaptiveState", "finito_basic_init", "finito_coeff_init",
    "lfinito_init", "finito_adaptive_init", "finito_run", "finito_step",
    "finito_rebase", "DeepSolveInfo",
    "deep_solve", "StagedInfo", "staged_saga", "PolishResult",
    "fista_polish", "grad_mean_chunked", "grad_sum_chunked", "power_lmax",
    "lsq_power_lmax", "Proshi", "ProshiCfg", "ProshiState", "proshi_init",
    "proshi_run", "proshi_step", "proshi_resync", "sharing_objective",
    "DeepSharingInfo", "deep_solve_sharing", "Katyusha", "KatyushaCfg",
    "KatyushaState", "katyusha_init", "katyusha_run", "katyusha_step",
    "SARAH", "SARAHCfg", "SARAHState", "sarah_init", "sarah_run",
    "sarah_step", "LSVRG", "LSVRGCfg", "LSVRGState", "lsvrg_init",
    "lsvrg_run", "lsvrg_step", "lsvrg_rebase", "LKatyusha", "LKatyushaCfg",
    "LKatyushaState", "lkatyusha_init", "lkatyusha_run", "lkatyusha_step",
    "lkatyusha_rebase", "SSNM", "SSNMCfg", "SSNMState", "ssnm_init",
    "ssnm_run", "ssnm_step", "ssnm_rebase", "PointSAGA", "PointSAGACfg",
    "PointSAGAState", "point_saga_init", "point_saga_run", "point_saga_step",
    "point_saga_rebase", "PANOC", "ZeroFPR", "PANOCCfg", "PANOCState",
    "panoc_init", "panoc_run", "panoc_step", "warn_if_thrashing",
    "THRASH_EVALS", "DavisYin", "DouglasRachford", "DYSCfg", "DYSState",
    "dys_init", "dys_run", "dys_step", "CondatVu", "ChambollePock", "PDCfg",
    "PDState", "pd_init", "pd_run", "pd_step", "prox_conjugate", "iterator",
]
