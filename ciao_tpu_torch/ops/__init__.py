"""Hand-written GPU kernels of the port, each beside its plain version."""

from ciao_tpu_torch.ops.fused_block import (
    saga_coeff_multistep,
    saga_coeff_multistep_ref,
    saga_multistep_available,
)

__all__ = ["saga_coeff_multistep", "saga_coeff_multistep_ref",
           "saga_multistep_available"]
