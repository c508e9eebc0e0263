"""Utilities: the rank-aware console + file ``Logger``."""

from distributed_training_pytorch_tpu_torch.utils.logger import Logger

__all__ = ["Logger"]
