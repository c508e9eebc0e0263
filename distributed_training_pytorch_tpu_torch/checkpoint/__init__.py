"""Named checkpoints (best / last / periodic) with atomic commits and integrity checks."""

from distributed_training_pytorch_tpu_torch.checkpoint.manager import (
    BEST,
    LAST,
    CheckpointError,
    CheckpointManager,
    CorruptCheckpointError,
    epoch_checkpoint_name,
)

__all__ = [
    "BEST",
    "LAST",
    "CheckpointError",
    "CheckpointManager",
    "CorruptCheckpointError",
    "epoch_checkpoint_name",
]
