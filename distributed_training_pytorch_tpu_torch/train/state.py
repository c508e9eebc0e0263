"""Training state.

Counterpart of ``distributed_training_pytorch_tpu/train/state.py``. The JAX package
threads one immutable pytree (step, params, optax state, rng) through a jitted step; here
the parameters live in the ``nn.Module`` and the moments in the torch optimizer, and the
engine updates both in place. The model takes no random numbers (dropout is off in every
ported model), so there is no rng. ``loss_scale`` is the dynamic loss scale's state
(``precision/loss_scale.py``), or None.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

__all__ = ["TrainState", "unwrap"]


def unwrap(model: nn.Module) -> nn.Module:
    """The module under a ``DistributedDataParallel`` wrapper (or the module itself)."""
    return getattr(model, "module", model)


@dataclasses.dataclass
class TrainState:
    """``step`` (optimizer steps taken: the schedule's position), the model (possibly
    wrapped in DDP), its optimizer and the loss scale (a ``DynamicScale``, a ``NoOpScale``
    or None), which the engine replaces after each step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    loss_scale: Any = None

    @property
    def params(self) -> "dict[str, torch.Tensor]":
        return unwrap(self.model).state_dict()

    def state_dict(self) -> dict:
        """What a checkpoint holds: params, optimizer state and step, and a dynamic loss
        scale's three tensors when there is one (as the JAX manager saves its ``scale``
        item only for a state with leaves)."""
        payload = {
            "params": unwrap(self.model).state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": int(self.step),
        }
        if hasattr(self.loss_scale, "state_dict"):
            payload["loss_scale"] = self.loss_scale.state_dict()
        return payload

    def load_state_dict(self, payload: dict) -> None:
        """Restore a checkpoint's state. A checkpoint without a loss scale (fp32, bf16, or
        saved before loss scaling) keeps this state's fresh scale."""
        unwrap(self.model).load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
        if "loss_scale" in payload and hasattr(self.loss_scale, "load_state_dict"):
            self.loss_scale = self.loss_scale.load_state_dict(payload["loss_scale"])
