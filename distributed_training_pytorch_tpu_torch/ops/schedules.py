"""Learning-rate schedules as plain functions of the optimizer step.

Counterpart of ``distributed_training_pytorch_tpu/ops/schedules.py``, which builds optax
schedules; these compute the same values (optax's ``warmup_cosine_decay_schedule`` and
``piecewise_constant_schedule`` semantics) in Python floats. The engine sets each step's
learning rate on the torch optimizer from them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["Schedule", "multistep_lr", "warmup_cosine_lr"]

Schedule = Callable[[int], float]


def multistep_lr(
    base_lr: float, milestones: Sequence[int], gamma: float = 0.1, steps_per_epoch: int = 1
) -> Schedule:
    """LR = base_lr * gamma^(number of milestones passed), milestones in epochs: a
    milestone at epoch m scales every step ``>= m * steps_per_epoch``."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(1 for b in boundaries if step >= b)

    return schedule


def warmup_cosine_lr(
    base_lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    warmup_epochs: int = 5,
    end_lr: float = 0.0,
) -> Schedule:
    """Linear warmup from 0 to ``base_lr``, then cosine decay to ``end_lr`` at the run's
    last step. Warmup is clamped below the run length so short runs still get a cosine
    phase."""
    total_steps = max(2, total_epochs * steps_per_epoch)
    warmup_steps = max(1, min(warmup_epochs * steps_per_epoch, total_steps - 1))
    decay_steps = total_steps - warmup_steps
    alpha = end_lr / base_lr if base_lr else 0.0

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / warmup_steps
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule
