"""ciao_tpu_torch — the PyTorch/CUDA port of ciao_tpu.

Finite-sum composite optimization, minimize (1/N) Σ f_i(x) + g(x), on an
NVIDIA GPU. The JAX package ``ciao_tpu`` stays the reference: this
package mirrors its module paths and names. Oracles and proxes are small
``nn.Module``s holding their data as buffers, solver steps are plain
functions on tensors, entry points take an explicit device, and every
Pallas TPU kernel on a ported path is a hand-written Hopper kernel with
a plain PyTorch version beside it (``ciao_tpu_torch.ops``).

Ported so far: the SAGA headline path — ``LeastSquaresRows`` (f32, bf16
and int8 rows), ``NormL1``/``Zero``, and block-sampled coefficient-table
SAGA/SAG, uniform or importance-sampled, through the
``saga_coeff_multistep`` (N ≤ 1M) and ``saga_coeff_multistep_streamed``
(any N) CUDA kernels; the deep-accuracy path: ``staged_saga``, the
compensated ``fista_polish`` with ``power_lmax``, and ``deep_solve``;
SVRG/SVRG++ (inner steps on ``svrg_coeff_multistep``) and
forward-backward/FISTA, whose full-gradient reads run on the one-pass
``coeff_apply_all`` kernel; the Finito/MISO family: the full table on
``finito_block_update``, the coefficient table on
``finito_coeff_multistep`` and ``finito_coeff_multistep_streamed``,
LFinito on ``coeff_apply_all`` and ``lfinito_sweep_multistep``, and
adaptive Finito. The rest is queued in ROADMAP.md. Imports
torch and numpy, never jax. Entry points run on the card unless the
caller names the CPU (a CPU tensor or ``device="cpu"``).
"""

from ciao_tpu_torch import oracles, prox
from ciao_tpu_torch.oracles import LeastSquaresRows
from ciao_tpu_torch.prox import NormL1, Zero
from ciao_tpu_torch.solvers import (
    FISTA, SAG, SAGA, SVRG, DeepSolveInfo, Finito, ForwardBackward,
    StagedInfo,
    deep_solve, fista_polish, grad_mean_chunked, halt, loop, lsq_power_lmax,
    power_lmax, solution, staged_saga, take,
)
from ciao_tpu_torch.solvers.base import Status

__version__ = "0.1.0"

__all__ = [
    "oracles",
    "prox",
    "LeastSquaresRows",
    "NormL1",
    "Zero",
    "SAGA",
    "SAG",
    "SVRG",
    "Finito",
    "ForwardBackward",
    "FISTA",
    "deep_solve",
    "DeepSolveInfo",
    "staged_saga",
    "StagedInfo",
    "fista_polish",
    "power_lmax",
    "lsq_power_lmax",
    "grad_mean_chunked",
    "Status",
    "solution",
    "take",
    "loop",
    "halt",
]
