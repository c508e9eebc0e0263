"""Loss scaling: fp16's countermeasure to gradient underflow, as state on the device.

Counterpart of ``distributed_training_pytorch_tpu/precision/loss_scale.py``. fp16 gradients
underflow to zero below about 6e-5; multiplying the loss by a large scale S lifts the whole
gradient distribution into range, and dividing the gradients by S afterwards recovers them.

* :class:`NoOpScale`: the identity protocol, with no state.
* :class:`DynamicScale`: ``torch.amp.GradScaler``'s protocol, as the JAX package has it. On a
  step whose gradients are not finite the update is skipped (by the engine's non-finite
  guard: one predicate, one skip, counted once in ``metrics["nonfinite"]``) and the scale
  backs off by ``backoff_factor``; after ``growth_interval`` finite steps in a row it grows by
  ``growth_factor``, within ``[min_scale, max_scale]``. The factors are powers of two, so
  scaling and unscaling are exact.

The state is three 0-d tensors on the model's device (the scale in f32, the growth counter
and the skipped-step count in int32). :meth:`DynamicScale.adjust` computes the next state
there, in place: nothing here reads a value back to the host, and a captured CUDA graph
of the step keeps updating the same three tensors. A checkpoint carries the three tensors
(``train/state.py``), so a resumed run goes on with the same scale and counter.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DynamicScale", "NoOpScale", "is_dynamic", "resolve_loss_scale"]


@dataclasses.dataclass(frozen=True)
class NoOpScale:
    """Identity loss scale: no state, no arithmetic."""

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss

    def unscale_grads(self, grads) -> None:
        del grads

    def adjust(self, grads_finite: torch.Tensor) -> "NoOpScale":
        del grads_finite
        return self


@dataclasses.dataclass(frozen=True)
class DynamicScale:
    """Dynamic loss-scale state: ``scale`` (f32), ``growth_counter`` and ``skipped_steps``
    (int32), 0-d tensors, and the protocol's constants. Build it with :meth:`create`;
    ``skipped_steps`` counts the overflow skips of the run."""

    scale: torch.Tensor
    growth_counter: torch.Tensor
    skipped_steps: torch.Tensor
    growth_interval: int = 2000
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = float(2.0**24)

    @classmethod
    def create(
        cls,
        initial_scale: float = 2.0**15,
        *,
        growth_interval: int = 2000,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        min_scale: float = 1.0,
        max_scale: float = 2.0**24,
        device=None,
    ) -> "DynamicScale":
        """torch.amp's defaults: 2^15 to start (the largest power of two below fp16's
        65504, so the first scaled cotangent cannot overflow at the output cast), x2 after
        2000 clean steps, /2 on an overflow."""
        if initial_scale <= 0:
            raise ValueError(f"initial_scale must be > 0, got {initial_scale}")
        return cls(
            scale=torch.tensor(float(initial_scale), dtype=torch.float32, device=device),
            growth_counter=torch.tensor(0, dtype=torch.int32, device=device),
            skipped_steps=torch.tensor(0, dtype=torch.int32, device=device),
            growth_interval=int(growth_interval),
            growth_factor=float(growth_factor),
            backoff_factor=float(backoff_factor),
            min_scale=float(min_scale),
            max_scale=float(max_scale),
        )

    def to(self, device) -> "DynamicScale":
        """The same state on ``device``."""
        return dataclasses.replace(self, **{k: getattr(self, k).to(device) for k in _STATE})

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale.to(loss.dtype)

    def unscale_grads(self, grads) -> None:
        """Multiply each gradient by ``1 / scale`` in place (a power of two: exact)."""
        inv = 1.0 / self.scale
        for g in grads:
            if g is not None:
                g.mul_(inv.to(g.dtype))

    def adjust(self, grads_finite: torch.Tensor) -> "DynamicScale":
        """One step of the protocol, on the device: grow after ``growth_interval`` finite
        steps in a row; on an overflow back off, reset the counter and count the skip. The
        three tensors are updated in place (a captured CUDA graph holds their addresses),
        and the scale itself is returned."""
        finite = grads_finite.to(torch.bool)
        counter = self.growth_counter + 1
        grow = finite & (counter >= self.growth_interval)
        grown = torch.where(grow, torch.clamp(self.scale * self.growth_factor, max=self.max_scale), self.scale)
        backed_off = torch.clamp(self.scale * self.backoff_factor, min=self.min_scale)
        self.scale.copy_(torch.where(finite, grown, backed_off))
        self.growth_counter.copy_(torch.where(grow | ~finite, torch.zeros_like(counter), counter))
        self.skipped_steps.add_((~finite).to(torch.int32))
        return self

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in _STATE}

    def load_state_dict(self, payload: dict) -> "DynamicScale":
        """This scale with the saved tensors, on this scale's device."""
        return dataclasses.replace(self, **{k: payload[k].to(getattr(self, k).device, getattr(self, k).dtype)
                                            for k in _STATE})


_STATE = ("scale", "growth_counter", "skipped_steps")


def is_dynamic(scale_state) -> bool:
    """Whether the engine scales, unscales and adjusts: only a :class:`DynamicScale`."""
    return isinstance(scale_state, DynamicScale)


def resolve_loss_scale(spec, policy):
    """The Trainer's ``loss_scale`` knob: ``None`` is dynamic when the policy computes in
    fp16 and none otherwise, ``"dynamic"``/``"none"`` by name, or an instance."""
    if spec is None:
        return DynamicScale.create() if policy.compute_dtype == torch.float16 else None
    if isinstance(spec, str):
        key = spec.lower()
        if key == "dynamic":
            return DynamicScale.create()
        if key in ("none", "noop", "no_op"):
            return NoOpScale()
        raise ValueError(f"unknown loss_scale {spec!r} (use 'dynamic', 'none', None, or an instance)")
    if isinstance(spec, (NoOpScale, DynamicScale)):
        return spec
    raise TypeError(f"loss_scale must be a str, NoOpScale, DynamicScale, or None, got {type(spec)}")
