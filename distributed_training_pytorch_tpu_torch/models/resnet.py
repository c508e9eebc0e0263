"""Bottleneck ResNet in PyTorch: ResNet-50 and a slim variant for tests.

Counterpart of ``distributed_training_pytorch_tpu/models/resnet.py``. The API is NCHW, and
activations are kept in the ``channels_last`` memory format, so the rows of a 1x1
convolution (pixels, channels contiguous) are a view: that is what the fused 1x1 kernel
reads in place. Params stay f32 whatever ``dtype`` is and are cast to ``dtype`` where they
are used; the logits are f32.

``pallas=True`` sends the 1x1 convolutions whose input is at least 56 pixels high
(ResNet-50's stage 1 and the first block of stage 2 at 224x224) to
``ops.conv1x1.conv1x1_bn_act_diff`` with an identity epilogue: the hand-written kernel on
the card, its plain version on the CPU. The policy is ``ops.dispatch.conv1x1_policy``
(auto: off). Unlike the flax model, whose param tree renames those convolutions
(``PallasConv1x1_n``), the port's ``state_dict`` is the same with the knob on or off.

Parity with the flax model, where it is not the PyTorch default:

* flax ``nn.Conv``'s default padding is ``"SAME"``: a stride-2 3x3 on an even input pads
  (0, 1), not (1, 1); the stem's 7x7 and the max-pool pad (3, 3) and (1, 1) explicitly;
* flax ``BatchNorm(momentum=0.9)`` is torch's ``momentum=0.1``, and it updates the running
  variance with the *biased* batch variance (torch's ``running_var`` takes the unbiased
  one); statistics are f32 and the output is in ``dtype``;
* the last BN scale of each block starts at 0; convolutions start Kaiming fan-out normal,
  the head N(0, 0.01) with a zero bias.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.conv1x1 import conv1x1_bn_act_diff

__all__ = ["BottleneckBlock", "ResNet", "ResNet18Slim", "ResNet50"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # flax momentum=0.9: running = 0.9 * running + 0.1 * batch
KERNEL_MIN_SPATIAL = 56  # the JAX gate: the 1x1s of inputs this high go to the kernel


def _same_pads(size: int, k: int, s: int) -> "tuple[int, int]":
    """XLA's "SAME" padding of one spatial dim: the output is ceil(size / s), any odd pad
    goes after."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _Conv(nn.Conv2d):
    """flax ``nn.Conv(use_bias=bias, feature_group_count=groups, dtype=...)``: f32 params,
    input and params cast to ``dtype``; ``padding=None`` is "SAME"."""

    def __init__(self, cin, cout, k, stride, dtype, device, padding: "int | None" = None, *, groups: int = 1,
                 bias: bool = False):
        super().__init__(cin, cout, k, stride=stride, padding=0, groups=groups, bias=bias, device=device)
        self.compute_dtype = dtype
        self.same = padding is None
        self.pad = 0 if padding is None else padding

    def forward(self, x):
        dt = self.compute_dtype
        pad = self.pad
        if self.same:
            (top, bottom), (left, right) = (
                _same_pads(x.shape[d], self.kernel_size[i], self.stride[i]) for i, d in enumerate((2, 3))
            )
            if (top, left) == (bottom, right):
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
                pad = 0
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, pad, groups=self.groups)


class _Conv1x1(_Conv):
    """A 1x1 convolution that takes the fused kernel (``PallasConv1x1``'s route: identity
    epilogue, constant scale/bias) when ``use_kernel`` is set and its input is at least
    ``KERNEL_MIN_SPATIAL`` high; a strided one subsamples its input first, as a strided
    1x1 convolution reads only those pixels."""

    def __init__(self, cin, cout, stride, dtype, device, use_kernel: bool):
        super().__init__(cin, cout, 1, stride, dtype, device)
        self.use_kernel = use_kernel

    def forward(self, x):
        if not (self.use_kernel and x.shape[2] >= KERNEL_MIN_SPATIAL):
            return super().forward(x)
        s = self.stride[0]
        if s > 1:
            x = x[:, :, ::s, ::s]
        dt = self.compute_dtype
        cout, cin = self.weight.shape[:2]
        nhwc = x.to(dt).permute(0, 2, 3, 1)  # a view of a channels-last NCHW tensor
        ones = torch.ones(cout, device=x.device)
        zeros = torch.zeros(cout, device=x.device)
        w = self.weight.reshape(cout, cin).to(dt)
        y = conv1x1_bn_act_diff(nhwc, w, ones, zeros, act=None, affine_grads=False)
        return y.permute(0, 3, 1, 2)  # NCHW, channels-last in memory


class _BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=..., param_dtype=f32)``.

    In training the batch statistics are f32, the output is normalised in f32 and cast to
    ``dtype``, and the running variance takes the biased batch variance, recovered from
    the inverse standard deviation the normalisation computed. In eval the running
    statistics normalise."""

    def __init__(self, c: int, dtype, device):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM, device=device)
        self.out_dtype = dtype

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.out_dtype)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(self.eps).clamp_(min=0.0).float()  # biased batch variance
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean.float(), alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y.to(self.out_dtype)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (stride) -> 1x1 expand (x4), residual add, post-add ReLU; a
    projection (1x1 + BN) on the residual when the shapes differ."""

    def __init__(self, cin: int, features: int, stride: int, dtype, device, pallas_1x1: bool):
        super().__init__()
        cout = 4 * features
        self.conv1 = _Conv1x1(cin, features, 1, dtype, device, pallas_1x1)
        self.bn1 = _BatchNorm(features, dtype, device)
        self.conv2 = _Conv(features, features, 3, stride, dtype, device)
        self.bn2 = _BatchNorm(features, dtype, device)
        self.conv3 = _Conv1x1(features, cout, 1, dtype, device, pallas_1x1)
        self.bn3 = _BatchNorm(cout, dtype, device)
        self.proj = None
        if cin != cout or stride != 1:
            self.proj = _Conv1x1(cin, cout, stride, dtype, device, pallas_1x1)
            self.proj_bn = _BatchNorm(cout, dtype, device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Bottleneck ResNet on NCHW images; ``stage_sizes=(3, 4, 6, 3)`` is ResNet-50.

    ``device`` defaults to the card and raises when there is none; pass ``device="cpu"``
    to build on the CPU. ``generator`` (on ``device``) seeds the initial weights. Call
    ``train()``/``eval()`` for BatchNorm's batch or running statistics."""

    def __init__(
        self,
        num_classes: int = 1000,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        width: int = 64,
        *,
        dtype: torch.dtype = torch.float32,
        pallas: "bool | None" = None,
        device="cuda",
        generator: "torch.Generator | None" = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.pallas_1x1 = dispatch.conv1x1_policy("resnet", pallas)
        self.stem = _Conv(3, width, 7, 2, dtype, device, padding=3)
        self.bn_stem = _BatchNorm(width, dtype, device)
        blocks = []
        cin = width
        for stage, num_blocks in enumerate(stage_sizes):
            features = width * 2**stage
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BottleneckBlock(cin, features, stride, dtype, device, self.pallas_1x1))
                cin = 4 * features
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        self.init_weights(generator)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: "torch.Generator | None" = None) -> None:
        """flax's initialisers in distribution: Kaiming fan-out normal convolutions, unit
        BN scales (zero for each block's last), zero BN biases and statistics, an
        N(0, 0.01) head with a zero bias."""
        if generator is None:
            dev = self.head.weight.device
            generator = torch.Generator(device=dev if dev.type == "cuda" else "cpu").manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, _Conv):
                fan_out = mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            elif isinstance(mod, _BatchNorm):
                mod.reset_parameters()
        for block in self.blocks:
            block.bn3.weight.zero_()
        self.head.weight.normal_(0.0, 0.01, generator=generator)
        self.head.bias.zero_()

    def forward(self, x):
        """``x`` ``[B, 3, H, W]`` -> f32 logits ``[B, num_classes]``."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_stem(self.stem(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))  # global average pool
        dt = self.dtype
        return F.linear(x, self.head.weight.to(dt), self.head.bias.to(dt)).float()


def ResNet50(num_classes: int = 1000, dtype: torch.dtype = torch.float32, **kw) -> ResNet:
    return ResNet(num_classes=num_classes, stage_sizes=(3, 4, 6, 3), dtype=dtype, **kw)


def ResNet18Slim(num_classes: int = 10, dtype: torch.dtype = torch.float32, **kw) -> ResNet:
    """Small bottleneck variant for tests and smoke runs (not torch's ResNet-18)."""
    return ResNet(num_classes=num_classes, stage_sizes=(1, 1, 1, 1), width=16, dtype=dtype, **kw)
