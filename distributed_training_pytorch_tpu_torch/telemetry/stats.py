"""On-device train-health statistics, computed inside the step.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/stats.py``: the same
:data:`STAT_KEYS` and definitions. ``TrainEngine(stats=True)`` computes them in
``_step_body``, so a chained window's CUDA graph captures them with the step; they ride
the step's metrics as 0-d device tensors and reach the host only at the trainer's
existing sync points. Nothing here reads a value back to the host, and the update
arithmetic is untouched: params are bit-equal to a stats-off run.

The fused optimizers update the params in place, so the update's norm needs the params
from before the step. :class:`HealthStats` keeps one persistent snapshot buffer (one
tensor per param, allocated once, so a graph captures copies into it and allocates
nothing for it), copies the params into it before the optimizer step, and after the step
subtracts the new params from it in place: the buffer then holds minus the update, whose
norm is the update's. The norms are ``torch._foreach_norm`` over the tensor lists (a few
multi-tensor launches, not one per tensor).

Definitions (as in JAX): ``grad_norm`` is the global L2 norm of the gradients the
optimizer sees (under fp16 the unscaled ones; under accumulation their mean);
``param_norm`` the global norm of the params before the update; ``update_ratio``
``||new - old|| / (param_norm + eps)`` (JAX takes the optax update, which ``new - old``
equals up to the rounding of the addition; a step the guard skipped moves nothing, so
its ratio is 0); ``nonfinite`` 1.0 when the loss or the grad norm is not finite (the
engine's guard, when armed, overwrites it with its own per-tensor predicate).
"""

from __future__ import annotations

import torch

__all__ = ["STAT_KEYS", "HealthStats", "global_norm", "train_health_stats"]

STAT_KEYS = ("grad_norm", "param_norm", "update_ratio", "nonfinite")


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together, in f32, as a 0-d tensor on their device."""
    tensors = [t for t in tensors if t is not None]
    norms = torch._foreach_norm(tensors, 2)
    return torch.linalg.vector_norm(torch.stack([n.float() for n in norms]))


def _health(loss, grad_norm, param_norm, update_norm, eps: float) -> dict:
    finite = torch.isfinite(loss.detach().float()) & torch.isfinite(grad_norm)
    return {
        "grad_norm": grad_norm,
        "param_norm": param_norm,
        "update_ratio": update_norm / (param_norm + eps),
        "nonfinite": 1.0 - finite.float(),
    }


def train_health_stats(*, loss, grads, params, updates, eps: float = 1e-12) -> dict:
    """The four scalars from the loss and lists of gradients, pre-update params and
    updates (the JAX function's signature, for callers holding all three)."""
    return _health(loss, global_norm(grads), global_norm(params), global_norm(updates), eps)


class HealthStats:
    """The engine's per-model state for the stats: the snapshot buffer.

    ``before_update(params, loss)`` runs after the backward and before the optimizer
    step; ``after_update()`` after the step returns the four scalars."""

    def __init__(self, eps: float = 1e-12):
        self.eps = eps
        self._snapshot: "list[torch.Tensor] | None" = None
        self._pending = None

    @property
    def snapshot_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._snapshot or [])

    def before_update(self, params, loss) -> None:
        params = [p for p in params if p.grad is not None]
        if self._snapshot is None or len(self._snapshot) != len(params) or any(
            s.shape != p.shape or s.dtype != p.dtype or s.device != p.device
            for s, p in zip(self._snapshot, params)
        ):
            self._snapshot = [torch.empty_like(p, memory_format=torch.preserve_format) for p in params]
        with torch.no_grad():
            torch._foreach_copy_(self._snapshot, [p.detach() for p in params])
            grad_norm = global_norm([p.grad for p in params])
            param_norm = global_norm(self._snapshot)
        self._pending = (params, loss, grad_norm, param_norm)

    def after_update(self) -> dict:
        params, loss, grad_norm, param_norm = self._pending
        self._pending = None
        with torch.no_grad():
            torch._foreach_sub_(self._snapshot, [p.detach() for p in params])  # old - new = -update
            update_norm = global_norm(self._snapshot)
        return _health(loss, grad_norm, param_norm, update_norm, self.eps)
