"""Mixed-precision dtype policies.

Counterpart of ``distributed_training_pytorch_tpu/precision/policy.py``: a
:class:`Policy` names ``(param_dtype, compute_dtype, output_dtype)``. Master weights and
optimizer state stay in ``param_dtype`` (f32). The JAX engine casts the params and float
inputs to ``compute_dtype`` at the loss-function boundary; the port's models instead keep
f32 params and cast them to their ``dtype`` where they are used (``models/
transformer_lm.py``), so here the policy names the model's dtype
(:func:`model_dtype_for_entry`) and the engine casts the loss to ``output_dtype`` (f32),
as the JAX engine does (``train/engine.py:307-338``). One difference in bf16: the JAX
policy also rounds LayerNorm scales and the tied embedding to bf16 before use; the port
keeps those f32.

``fp16`` (f32 params, fp16 compute, f32 output) needs dynamic loss scaling: the Trainer
turns it on by default and refuses to run fp16 without it (``precision/loss_scale.py``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Policy", "compute_dtype", "get_policy", "model_dtype_for_entry"]


@dataclasses.dataclass(frozen=True)
class Policy:
    """``(param_dtype, compute_dtype, output_dtype)``; see the module docstring."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    name: str = "fp32"

    @property
    def active(self) -> bool:
        """True when the policy computes in anything but f32."""
        return not (self.param_dtype == self.compute_dtype == self.output_dtype == torch.float32)

    def cast_output(self, loss: torch.Tensor) -> torch.Tensor:
        return loss.to(self.output_dtype)


_PRESETS = {
    "fp32": Policy(torch.float32, torch.float32, torch.float32, name="fp32"),
    "bf16": Policy(torch.float32, torch.bfloat16, torch.float32, name="bf16"),
    # fp16's range (about 6e-5 to 65504) needs loss scaling; the Trainer enforces it.
    "fp16": Policy(torch.float32, torch.float16, torch.float32, name="fp16"),
}
_ALIASES = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16", "half": "fp16"}


def get_policy(spec: "str | Policy | None") -> Policy:
    """``None`` | preset name | :class:`Policy` -> :class:`Policy`."""
    if spec is None:
        return _PRESETS["fp32"]
    if isinstance(spec, Policy):
        return spec
    if isinstance(spec, str):
        key = _ALIASES.get(spec.lower(), spec.lower())
        if key in _PRESETS:
            return _PRESETS[key]
        raise ValueError(f"unknown precision {spec!r} (choose from {sorted(_PRESETS)} or pass a Policy)")
    raise TypeError(f"precision must be a str, Policy, or None, got {type(spec)}")


def compute_dtype(spec: "str | Policy | None") -> torch.dtype:
    """The compute dtype a precision spec names: the dtype to build models with."""
    return get_policy(spec).compute_dtype


def model_dtype_for_entry(policy, explicit: bool, legacy_dtype: "torch.dtype | None" = None) -> torch.dtype:
    """Model dtype for an entry with a ``DTYPE`` knob, by the JAX package's rule: an
    active policy wins; under the f32 policy, an explicit request (``explicit``) gives f32
    and an unset knob keeps the entry's ``legacy_dtype`` (bf16 for the LM entry)."""
    policy = get_policy(policy)
    if policy.active:
        return policy.compute_dtype
    if explicit:
        return torch.float32
    return legacy_dtype if legacy_dtype is not None else torch.float32
