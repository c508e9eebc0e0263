"""VGG16 in PyTorch.

Counterpart of ``distributed_training_pytorch_tpu/models/vgg.py``: five stages of
``stage_features`` (64, 128, 256, 512, 512) channels with ``stage_layers`` (2, 2, 3, 3, 3)
3x3 conv + ReLU layers, each stage ending in a 2x2 max-pool; an adaptive average pool to
7x7; a classifier of ``classifier_widths`` (4096, 4096) dense + ReLU + dropout
(``dropout_rate`` 0.3, active in ``train()`` mode only), then ``num_classes``. Convolutions
start Kaiming fan-out normal, dense layers N(0, 0.01), every bias zero.

The API is NCHW, and activations are kept ``channels_last`` in memory (a uint8 NHWC
loader batch permuted to NCHW already is), the layout cuDNN's bf16 convolutions take.
Params stay f32 whatever ``dtype`` is and are cast to ``dtype`` where they are used; the
logits are f32. The JAX model's adaptive pool is two pooling matrices that implement
``nn.AdaptiveAvgPool2d``'s bins, so here it is that module, but for a 1x1 map (32x32
inputs, after five halvings), which every bin copies: there it is a broadcast, the same
numbers forward, whose backward is a sum (the CUDA adaptive pool's backward adds with
atomics and has no deterministic form, so a run under ``torch.use_deterministic_algorithms``
could not train at 32x32). The JAX model flattens NHWC,
(h, w, c), where this one flattens NCHW, (c, h, w): ``models/convert.py::
vgg_params_from_jax`` permutes the first classifier weight's columns to match.

No kernel of the port runs here: the 3x3 convolutions have no fused-kernel coverage
(``ops/dispatch.py::vgg16_policy``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch._device import resolve_device

__all__ = ["ConvBlock", "VGG16"]


class ConvBlock(nn.Module):
    """``num_layers`` x (3x3 conv + ReLU), then a 2x2 max-pool."""

    def __init__(self, in_features: int, features: int, num_layers: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(
            nn.Conv2d(in_features if i == 0 else features, features, 3, padding=1, device=device)
            for i in range(num_layers)
        )

    def forward(self, x):
        dt = self.dtype
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1))
        return F.max_pool2d(x, 2, 2)


class VGG16(nn.Module):
    """VGG16 classifier on NCHW images at least ``2 ** len(stage_features)`` pixels on a
    side. ``device`` defaults to the card and raises when there is none; ``generator`` (on
    ``device``) seeds the initial weights."""

    def __init__(
        self,
        num_classes: int = 3,
        stage_features: Sequence[int] = (64, 128, 256, 512, 512),
        stage_layers: Sequence[int] = (2, 2, 3, 3, 3),
        classifier_widths: Sequence[int] = (4096, 4096),
        dropout_rate: float = 0.3,
        dtype: torch.dtype = torch.float32,
        *,
        device="cuda",
        generator: "torch.Generator | None" = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.stage_features = tuple(stage_features)
        self.stage_layers = tuple(stage_layers)
        self.classifier_widths = tuple(classifier_widths)
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        blocks, cin = [], 3
        for feats, layers in zip(self.stage_features, self.stage_layers, strict=True):
            blocks.append(ConvBlock(cin, feats, layers, dtype, device))
            cin = feats
        self.blocks = nn.ModuleList(blocks)
        self.pool = nn.AdaptiveAvgPool2d((7, 7))
        dense, width = [], cin * 7 * 7
        for w in self.classifier_widths:
            dense.append(nn.Linear(width, w, device=device))
            width = w
        self.classifier = nn.ModuleList(dense)
        self.dropout = nn.Dropout(dropout_rate)
        self.head = nn.Linear(width, num_classes, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: "torch.Generator | None" = None) -> None:
        """flax's initialisers in distribution: Kaiming fan-out normal convolutions,
        N(0, 0.01) dense layers, zero biases."""
        if generator is None:
            dev = self.head.weight.device
            generator = torch.Generator(device=dev if dev.type == "cuda" else "cpu").manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 0.01, generator=generator)
                mod.bias.zero_()

    def forward(self, x):
        """``x`` ``[B, 3, H, W]`` -> f32 logits ``[B, num_classes]``."""
        min_size = 2 ** len(self.stage_features)
        if x.shape[2] < min_size or x.shape[3] < min_size:
            raise ValueError(
                f"VGG16 input spatial dims must be >= {min_size}x{min_size} "
                f"({len(self.stage_features)} 2x2 max-pools), got {x.shape[2]}x{x.shape[3]}"
            )
        dt = self.dtype
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        for block in self.blocks:
            x = block(x)
        x = (x.expand(-1, -1, 7, 7) if x.shape[2:] == (1, 1) else self.pool(x)).flatten(1)  # (c, h, w) order
        for dense in self.classifier:
            x = self.dropout(F.relu(F.linear(x, dense.weight.to(dt), dense.bias.to(dt))))
        return F.linear(x, self.head.weight.to(dt), self.head.bias.to(dt)).float()
