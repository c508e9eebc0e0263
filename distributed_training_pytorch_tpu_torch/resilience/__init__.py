"""Asynchronous and emergency checkpointing: a host snapshot on the hot loop and a
background commit through the crash-consistent ``checkpoint.CheckpointManager``."""

from distributed_training_pytorch_tpu_torch.resilience.async_saver import (
    AsyncCheckpointSaver,
    HostSnapshot,
    SaveRequest,
    measure_save_stall,
    snapshot_state,
)

__all__ = ["AsyncCheckpointSaver", "HostSnapshot", "SaveRequest", "measure_save_stall", "snapshot_state"]
