"""Hand-written GPU kernels of the port, each beside its plain version."""

from ciao_tpu_torch.ops.fused_block import (
    coeff_apply_all,
    coeff_apply_all_ref,
    full_grad_available,
    saga_coeff_multistep,
    saga_coeff_multistep_ref,
    saga_coeff_multistep_streamed,
    saga_coeff_multistep_streamed_ref,
    saga_multistep_available,
    saga_multistep_streamed_available,
    svrg_coeff_multistep,
    svrg_coeff_multistep_ref,
    svrg_multistep_available,
)

__all__ = ["coeff_apply_all", "coeff_apply_all_ref", "full_grad_available",
           "saga_coeff_multistep", "saga_coeff_multistep_ref",
           "saga_coeff_multistep_streamed",
           "saga_coeff_multistep_streamed_ref", "saga_multistep_available",
           "saga_multistep_streamed_available", "svrg_coeff_multistep",
           "svrg_coeff_multistep_ref", "svrg_multistep_available"]
