"""The epoch-loop ``Trainer`` and its hooks."""

from distributed_training_pytorch_tpu_torch.trainer.trainer import Trainer

__all__ = ["Trainer"]
