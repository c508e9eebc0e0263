"""Mixed-precision policies (``policy``) and dynamic loss scaling (``loss_scale``)."""

from distributed_training_pytorch_tpu_torch.precision.loss_scale import (
    DynamicScale,
    NoOpScale,
    is_dynamic,
    resolve_loss_scale,
)
from distributed_training_pytorch_tpu_torch.precision.policy import (
    Policy,
    compute_dtype,
    get_policy,
    model_dtype_for_entry,
)

__all__ = [
    "DynamicScale",
    "NoOpScale",
    "Policy",
    "compute_dtype",
    "get_policy",
    "is_dynamic",
    "model_dtype_for_entry",
    "resolve_loss_scale",
]
