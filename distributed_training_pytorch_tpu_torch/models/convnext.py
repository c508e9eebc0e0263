"""ConvNeXt in PyTorch: ConvNeXt-L and a small variant for tests.

Counterpart of ``distributed_training_pytorch_tpu/models/convnext.py``. A block is a 7x7
depthwise conv, LayerNorm, a 1x1 expand (4x) with GELU, a 1x1 project, a learnable
per-channel LayerScale and stochastic depth on the residual branch. The API is NCHW;
activations are kept channels-last in memory, so the depthwise conv reads and writes its
natural layout and ``permute(0, 2, 3, 1)`` gives the LayerNorm and the two Dense layers
their rows ``[B, H, W, C]`` as a view, with no copy.

``pallas=True`` sends every block's expand Dense + GELU to the fused 1x1 kernel,
``ops.conv1x1.conv1x1_bn_act_diff(x, w, ones, bias, act="gelu", affine_grads=True)``
(:class:`PallasDenseAct`): the hand-written kernel on the card, its plain version on the
CPU. The policy is ``ops.dispatch.conv1x1_policy(..., op="dense_gelu")``; auto stays off,
as in the JAX package. The knob changes the program, never the ``state_dict``.

Parity with the flax model, where it is not the PyTorch default:

* flax ``LayerNorm(epsilon=1e-6)`` normalises in f32 and returns ``dtype``; ``nn.gelu`` is
  the tanh approximation;
* the stem (4x4, stride 4) and the downsampling convs (2x2, stride 2) take flax's default
  ``"SAME"`` padding: none when the size divides by the stride, else the XLA split (any odd
  pad after);
* every conv and Dense has a bias; kernels start LeCun normal (truncated at two standard
  deviations), biases at 0, LayerScale at 1e-6, the head N(0, 0.02) with a zero bias;
* params stay f32 and are cast to ``dtype`` where they are used; the head reads the pooled
  features in f32 with f32 params.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.models._init import default_generator, lecun_normal_
from distributed_training_pytorch_tpu_torch.models.resnet import _Conv
from distributed_training_pytorch_tpu_torch.models.transformer_lm import _Dense, _LayerNorm
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.conv1x1 import conv1x1_bn_act_diff

__all__ = ["ConvNeXt", "ConvNeXtBlock", "ConvNeXtL", "ConvNeXtTiny", "DropPath", "PallasDenseAct"]

LAYER_SCALE_INIT = 1e-6


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample, with masks drawn from
    ``generator``; the identity in eval and at rate 0."""

    def __init__(self, rate: float, generator: "torch.Generator | None" = None):
        super().__init__()
        self.rate = float(rate)
        self.generator = generator

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device, generator=self.generator) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class PallasDenseAct(_Dense):
    """``Dense(features)`` + GELU through the fused 1x1 kernel (a Dense over the last axis
    is a 1x1 conv): the bias rides the kernel's affine epilogue with a unit scale. Its
    parameters are a ``_Dense``'s, so the knob leaves the ``state_dict`` as it is."""

    def __init__(self, d_in: int, d_out: int, dtype, device, act: "str | None" = "gelu"):
        super().__init__(d_in, d_out, dtype, device)
        self.act = act

    def forward(self, x):
        dt = self.compute_dtype
        ones = torch.ones(self.out_features, device=x.device)
        return conv1x1_bn_act_diff(x.to(dt), self.weight.to(dt), ones, self.bias, act=self.act, affine_grads=True)


def _channels_ln(norm: _LayerNorm, x):
    """LayerNorm over the channels of a channels-last NCHW tensor, through its NHWC view."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv -> LayerNorm -> expand Dense (4x) + GELU -> project Dense ->
    LayerScale -> DropPath, added to the input."""

    def __init__(self, dim: int, drop_path: float, dtype, device, use_kernel: bool = False,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        self.dwconv = _Conv(dim, dim, 7, 1, dtype, device, padding=3, groups=dim, bias=True)
        self.norm = _LayerNorm(dim, dtype, device)
        self.use_kernel = use_kernel
        self.expand = PallasDenseAct(dim, 4 * dim, dtype, device) if use_kernel else _Dense(dim, 4 * dim, dtype, device)
        self.project = _Dense(4 * dim, dim, dtype, device)
        self.layer_scale = nn.Parameter(torch.full((dim,), LAYER_SCALE_INIT, device=device))
        self.drop_path = DropPath(drop_path, generator)

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))  # [B, H, W, C]
        y = self.expand(y)
        if not self.use_kernel:
            y = F.gelu(y, approximate="tanh")  # flax nn.gelu: the tanh approximation
        y = self.project(y)
        y = self.drop_path(y * self.layer_scale.to(y.dtype))
        return x + y.permute(0, 3, 1, 2)


class _Downsample(nn.Module):
    """LayerNorm over channels, then a 2x2 stride-2 conv."""

    def __init__(self, cin: int, cout: int, dtype, device):
        super().__init__()
        self.norm = _LayerNorm(cin, dtype, device)
        self.conv = _Conv(cin, cout, 2, 2, dtype, device, bias=True)

    def forward(self, x):
        return self.conv(_channels_ln(self.norm, x))


class ConvNeXt(nn.Module):
    """ConvNeXt on NCHW images; ``depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)`` is -L.

    ``drop_path_rate`` rises linearly over the blocks from 0. ``device`` defaults to the
    card and raises when there is none; pass ``device="cpu"`` to build on the CPU (or
    ``"meta"`` to count parameters). ``generator`` (on ``device``) seeds the initial weights
    and the stochastic-depth masks."""

    def __init__(
        self,
        num_classes: int = 1000,
        depths: Sequence[int] = (3, 3, 27, 3),
        dims: Sequence[int] = (192, 384, 768, 1536),
        drop_path_rate: float = 0.0,
        *,
        dtype: torch.dtype = torch.float32,
        pallas: Optional[bool] = None,
        device="cuda",
        generator: "torch.Generator | None" = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.depths = tuple(depths)
        self.use_kernel = dispatch.conv1x1_policy(
            "convnext", pallas, op="dense_gelu",
            auto_off_reason="auto: opt-in epilogue fusion; flip with pallas=True/PALLAS=1",
        )
        if generator is None and device.type != "meta":
            generator = default_generator(device)
        self.stem = _Conv(3, dims[0], 4, 4, dtype, device, bias=True)
        self.stem_norm = _LayerNorm(dims[0], dtype, device)
        self.downsample = nn.ModuleList(_Downsample(dims[i - 1], dims[i], dtype, device) for i in range(1, len(dims)))
        rates = np.linspace(0.0, drop_path_rate, sum(self.depths))
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(dim, float(rates[i]), dtype, device, self.use_kernel, generator)
            for i, dim in enumerate(d for depth, d in zip(self.depths, dims, strict=True) for _ in range(depth))
        )
        self.norm = _LayerNorm(dims[-1], dtype, device)
        self.head = nn.Linear(dims[-1], num_classes, device=device)
        self.init_weights(generator)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: "torch.Generator | None" = None) -> None:
        """flax's initialisers in distribution: LeCun-normal conv and Dense kernels with
        zero biases, unit LayerNorm scales, LayerScale 1e-6, an N(0, 0.02) head."""
        if self.head.weight.is_meta:
            return
        generator = generator or default_generator(self.head.weight.device)
        for mod in self.modules():
            if isinstance(mod, _Conv):
                fan_in = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
                lecun_normal_(mod.weight, fan_in, generator)
                mod.bias.zero_()
            elif isinstance(mod, _Dense):
                lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ConvNeXtBlock):
                mod.layer_scale.fill_(LAYER_SCALE_INIT)
        self.head.weight.normal_(0.0, 0.02, generator=generator)
        self.head.bias.zero_()

    def forward(self, x):
        """``x`` ``[B, 3, H, W]`` -> f32 logits ``[B, num_classes]``."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = _channels_ln(self.stem_norm, self.stem(x))
        blocks = iter(self.blocks)
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = self.downsample[stage - 1](x)
            for _ in range(depth):
                x = next(blocks)(x)
        x = self.norm(x.mean(dim=(2, 3)))
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ConvNeXtL(num_classes: int = 21841, dtype: torch.dtype = torch.float32, **kw) -> ConvNeXt:
    """ConvNeXt-Large; the default head is sized for ImageNet-21k."""
    return ConvNeXt(num_classes=num_classes, depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536), dtype=dtype, **kw)


def ConvNeXtTiny(num_classes: int = 10, dtype: torch.dtype = torch.float32, **kw) -> ConvNeXt:
    """Small variant for tests (not the official ConvNeXt-T)."""
    return ConvNeXt(num_classes=num_classes, depths=(1, 1, 2, 1), dims=(16, 32, 64, 128), dtype=dtype, **kw)
