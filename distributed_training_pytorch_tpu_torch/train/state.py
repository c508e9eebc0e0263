"""Training state.

Counterpart of ``distributed_training_pytorch_tpu/train/state.py``. The JAX package
threads one immutable pytree (step, params, optax state, rng) through a jitted step; here
the parameters live in the ``nn.Module`` and the moments in the torch optimizer, and the
engine updates both in place. The model takes no random numbers (dropout is off in every
ported model), so there is no rng.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["TrainState", "unwrap"]


def unwrap(model: nn.Module) -> nn.Module:
    """The module under a ``DistributedDataParallel`` wrapper (or the module itself)."""
    return getattr(model, "module", model)


@dataclasses.dataclass
class TrainState:
    """``step`` (optimizer steps taken: the schedule's position), the model (possibly
    wrapped in DDP) and its optimizer."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def params(self) -> "dict[str, torch.Tensor]":
        return unwrap(self.model).state_dict()

    def state_dict(self) -> dict:
        """What a checkpoint holds: params, optimizer state and step."""
        return {
            "params": unwrap(self.model).state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": int(self.step),
        }

    def load_state_dict(self, payload: dict) -> None:
        unwrap(self.model).load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
