"""Model wrappers.

Counterpart of ``distributed_training_pytorch_tpu/models/wrappers.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["InputNormalizer"]


class InputNormalizer(nn.Module):
    """Wraps a classifier so raw uint8 image batches normalise on the device,
    ``(x / 255 - mean) / std`` in f32, and the host-to-device copy carries uint8 (4x fewer
    bytes than normalised f32).

    Input contract, decided per input dtype as in the JAX package: an integer tensor is raw
    0-255 pixels and is normalised here; a float tensor is taken as already normalised
    and passes to the inner model untouched. Images are NCHW, as the port's models take
    them (the JAX wrapper takes NHWC): a uint8 NHWC loader batch permuted to NCHW is
    channels-last in memory, and the normalisation keeps that layout, with no copy of its
    own. ``mean``/``std`` are buffers that are not saved in the ``state_dict``.
    """

    def __init__(self, inner: nn.Module, mean: Sequence[float], std: Sequence[float]):
        super().__init__()
        self.inner = inner
        device = next(inner.parameters()).device
        self.register_buffer("mean", torch.tensor(list(mean), dtype=torch.float32, device=device).view(1, -1, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(list(std), dtype=torch.float32, device=device).view(1, -1, 1, 1),
                             persistent=False)

    def forward(self, x):
        if not x.is_floating_point():
            x = (x.float() / 255.0 - self.mean) / self.std
        return self.inner(x)
