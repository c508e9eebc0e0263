"""The train/eval step engine and its state."""

from distributed_training_pytorch_tpu_torch.train.engine import (
    LossFn,
    NonFiniteLossError,
    TrainEngine,
)
from distributed_training_pytorch_tpu_torch.train.state import TrainState, unwrap

__all__ = ["LossFn", "NonFiniteLossError", "TrainEngine", "TrainState", "unwrap"]
