"""Training state.

Counterpart of ``distributed_training_pytorch_tpu/train/state.py``. The JAX package
threads one immutable pytree (step, params, optax state, rng) through a jitted step; here
the parameters live in the ``nn.Module`` and the moments in the torch optimizer, and the
engine updates both in place. ``loss_scale`` is the dynamic loss scale's state
(``precision/loss_scale.py``), or None. The random state is torch's own generators (a
model with dropout, VGG16's classifier, draws from the generator of its device): a
checkpoint carries the CPU generator's state and, for a model on the card, the card's,
and a restore sets them, so a resumed run draws what the uninterrupted run would have
(the JAX state threads its ``rng`` the same way).
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
    or None; the engine updates a dynamic scale's tensors in place). ``generation`` counts
    the restores into this state: a restore replaces the optimizer's moment tensors, so
    the engine captures its CUDA graph again when the count moves."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    loss_scale: Any = None
    generation: int = 0

    @property
    def params(self) -> "dict[str, torch.Tensor]":
        return unwrap(self.model).state_dict()

    def state_dict(self) -> dict:
        """What a checkpoint holds: params, optimizer state and step, a dynamic loss
        scale's three tensors when there is one (as the JAX manager saves its ``scale``
        item only for a state with leaves), and the generators' states."""
        payload = {
            "params": unwrap(self.model).state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": int(self.step),
        }
        if hasattr(self.loss_scale, "state_dict"):
            payload["loss_scale"] = self.loss_scale.state_dict()
        payload["rng"] = {"cpu": torch.get_rng_state()}
        device = _device_of(self.model)
        if device.type == "cuda":
            payload["rng"]["cuda"] = torch.cuda.get_rng_state(device)
        return payload

    def load_state_dict(self, payload: dict) -> None:
        """Restore a checkpoint's state. A checkpoint without a loss scale (fp32, bf16, or
        saved before loss scaling) keeps this state's fresh scale, and one without a
        random state leaves the generators as they are."""
        unwrap(self.model).load_state_dict(payload["params"])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.step = int(payload["step"])
        if "loss_scale" in payload and hasattr(self.loss_scale, "load_state_dict"):
            self.loss_scale = self.loss_scale.load_state_dict(payload["loss_scale"])
        rng = payload.get("rng") or {}
        if "cpu" in rng:
            torch.set_rng_state(rng["cpu"].cpu())
        device = _device_of(self.model)
        if "cuda" in rng and device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"].cpu(), device)
        self.generation += 1


def _device_of(model: nn.Module) -> torch.device:
    first = next(unwrap(model).parameters(), None)
    return torch.device("cpu") if first is None else first.device
