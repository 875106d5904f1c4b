"""The prox library of the port: every operator of ``ciao_tpu.prox``
under its name (the closed forms of ``separable`` and ``extended``)."""

from ciao_tpu_torch.prox.base import ProxOperator
from ciao_tpu_torch.prox.extended import (
    MCP, SCAD, HingeLoss, IndAffine, IndBallL1, IndBallLinf, IndHalfspace,
    IndNonnegative, IndNonpositive, IndPoint, IndSphereL2, LogBarrier,
    NormL0, NormL21, NormLinf, SqrDistPoint,
)
from ciao_tpu_torch.prox.separable import (
    ElasticNet, GroupNormL21, IndBallL2, IndBox, IndSimplex, NormL1, NormL2,
    NormNuclear, SqrNormL2, Zero,
)

__all__ = [
    "ProxOperator", "Zero", "NormL1", "GroupNormL21", "NormL2", "SqrNormL2",
    "ElasticNet", "IndBox", "IndBallL2", "IndSimplex", "NormNuclear",
    "NormL0", "NormL21", "SqrDistPoint", "NormLinf", "IndBallL1",
    "IndBallLinf", "IndNonnegative", "IndNonpositive", "IndHalfspace",
    "IndPoint", "IndAffine", "IndSphereL2", "LogBarrier", "HingeLoss", "MCP",
    "SCAD",
]
