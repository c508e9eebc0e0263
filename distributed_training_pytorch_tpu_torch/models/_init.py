"""flax's default initialisers, in distribution, for the port's modules."""

from __future__ import annotations

import torch

__all__ = ["default_generator", "lecun_normal_", "variance_scaling_"]

# The standard deviation of a unit normal truncated to [-2, 2]: flax's ``lecun_normal``
# divides by it, so the truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: "torch.Generator | None" = None) -> torch.Tensor:
    """flax ``nn.initializers.lecun_normal()``: a normal truncated at two standard
    deviations, scaled so that its variance is ``1 / fan_in``."""
    std = fan_in**-0.5 / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                      generator: "torch.Generator | None" = None) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``: a normal truncated at
    two standard deviations with variance ``scale / fan_in``. flax's fan-in of an ``[E,
    in, out]`` kernel is ``in * E`` (the leading axes are its receptive field)."""
    std = (scale / fan_in) ** 0.5 / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def default_generator(device: torch.device) -> torch.Generator:
    """A generator seeded with 0 on ``device`` (the CPU's for anything but a card)."""
    return torch.Generator(device=device if device.type == "cuda" else "cpu").manual_seed(0)
