"""Fault injection and the hung-step watchdog: a deterministic schedule of failures
(``inject.FaultPlan``) that the trainer, the checkpoint manager and data sources query at
their injection points, and a wall-clock monitor (``watchdog.StepWatchdog``) that turns a
hung step into a preemption save."""

from distributed_training_pytorch_tpu_torch.fault.inject import (
    CorruptingSource,
    FaultEvent,
    FaultPlan,
    InjectedFault,
    corrupt_checkpoint,
)
from distributed_training_pytorch_tpu_torch.fault.watchdog import StepWatchdog

__all__ = ["CorruptingSource", "FaultEvent", "FaultPlan", "InjectedFault", "StepWatchdog", "corrupt_checkpoint"]
