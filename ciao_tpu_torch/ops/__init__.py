"""Hand-written GPU kernels of the port, each beside its plain version."""

from ciao_tpu_torch.ops.fused_block import (
    saga_coeff_multistep,
    saga_coeff_multistep_ref,
    saga_coeff_multistep_streamed,
    saga_coeff_multistep_streamed_ref,
    saga_multistep_available,
    saga_multistep_streamed_available,
)

__all__ = ["saga_coeff_multistep", "saga_coeff_multistep_ref",
           "saga_coeff_multistep_streamed",
           "saga_coeff_multistep_streamed_ref", "saga_multistep_available",
           "saga_multistep_streamed_available"]
