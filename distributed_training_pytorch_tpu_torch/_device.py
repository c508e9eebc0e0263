"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and there is no card,
    so that a missing card is never hidden behind a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA device; pass device='cpu' to run on the CPU"
        )
    return dev
