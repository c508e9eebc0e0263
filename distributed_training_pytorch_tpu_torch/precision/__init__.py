"""Mixed-precision policies (``policy``); dynamic loss scaling comes with a later slice."""

from distributed_training_pytorch_tpu_torch.precision.policy import (
    Policy,
    compute_dtype,
    get_policy,
    model_dtype_for_entry,
)

__all__ = ["Policy", "compute_dtype", "get_policy", "model_dtype_for_entry"]
