"""Vision Transformer in PyTorch: ViT-B/16 and a small variant for tests.

Counterpart of ``distributed_training_pytorch_tpu/models/vit.py``: a strided-conv patch
embedding, a class token and learned positions, pre-LN encoder blocks, and a zero-initialised
head on the class token in f32. The API is NCHW, as the port's other image models take it.

Attention goes through the dispatch policy (``ops.dispatch.attention_fn("vit", ...)``):
``pallas=None`` (defer to ``use_flash``) and ``use_flash=None`` (auto) run the flash kernels
on CUDA tensors and their plain version on CPU tensors; ``True`` forces the flash wrapper;
``False`` takes :func:`dot_product_attention`, the JAX package's plain path. The q, k and v
of the fused qkv projection reach the kernels as views, read in place.

``pad_seq_to`` pads the token stream (197 tokens at 224x224) with zero rows up to that
length after the position embedding; the pad positions are masked as keys (``valid_len``),
the head reads token 0, and the per-token layers never mix the rows, so the logits and the
gradients equal the unpadded model's.

Parity with the flax model, where it is not the PyTorch default:

* flax ``LayerNorm`` has eps 1e-6 and normalises in f32; ``nn.gelu`` is the tanh
  approximation;
* ``qkv`` is a ``DenseGeneral`` to ``(3, H, Dh)``: here one ``Linear(D, 3 D)`` split as
  ``[..., 3, H, Dh]``; ``out`` contracts ``(H, Dh)``: here ``Linear(D, D)`` on the flattened
  heads (``models/convert.py::vit_params_from_jax`` maps the kernels);
* the patch tokens are the conv output's pixels in row-major order, as flax's reshape of
  its NHWC output gives them;
* params stay f32 whatever ``dtype`` is and are cast to ``dtype`` where they are used; the
  head reads the class token in f32 with f32 params;
* initial weights: LeCun normal (truncated at two standard deviations) kernels with zero
  biases, a zero class token, N(0, 0.02) positions and a zero head;
* ``image_size`` sizes ``pos_embed`` here; flax sizes it from the input at init.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.models._init import default_generator, lecun_normal_
from distributed_training_pytorch_tpu_torch.models.transformer_lm import _Dense, _LayerNorm
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.flash_attention import NEG_INF

__all__ = [
    "EncoderBlock",
    "MlpBlock",
    "MultiHeadAttention",
    "ViT",
    "ViTB16",
    "ViTTiny",
    "default_attention_fn",
    "dot_product_attention",
    "dropout",
]


def dropout(x, rate: float, train: bool, generator: "torch.Generator | None"):
    """flax ``nn.Dropout``: the identity in eval or at rate 0; else each element kept with
    probability ``1 - rate`` (from ``generator``) and scaled by its inverse."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def dot_product_attention(q, k, v, *, dtype=torch.float32, valid_len: "int | None" = None):
    """Plain softmax attention on ``[B, T, H, D]`` tensors, the JAX package's: logits in the
    inputs' dtype then f32 and scaled, keys at or past ``valid_len`` set to -1e30, an f32
    softmax, weights cast to ``dtype`` before the product with v."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if valid_len is not None and valid_len < k.shape[1]:
        mask = torch.arange(k.shape[1], device=k.device) < valid_len
        logits = torch.where(mask, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def default_attention_fn(use_flash: Optional[bool] = None, *, model: str = "vit") -> Optional[Callable]:
    """The attention path through the dispatch policy: a ``(q, k, v, valid_len=None) -> o``
    callable (the flash wrapper: the kernels on CUDA tensors, their plain version on CPU
    tensors), or None (use :func:`dot_product_attention`) when ``use_flash`` is False."""
    return dispatch.attention_fn(model, use_flash)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dropout_rate: float, dtype, device, generator=None):
        super().__init__()
        self.dense_in = _Dense(dim, mlp_dim, dtype, device)
        self.dense_out = _Dense(mlp_dim, dim, dtype, device)
        self.dropout_rate = dropout_rate
        self.generator = generator

    def forward(self, x):
        # flax nn.gelu is the tanh approximation, not torch's exact default.
        x = F.gelu(self.dense_in(x), approximate="tanh")
        x = dropout(x, self.dropout_rate, self.training, self.generator)
        return dropout(self.dense_out(x), self.dropout_rate, self.training, self.generator)


class MultiHeadAttention(nn.Module):
    """Fused qkv projection, attention (``attention_fn`` or :func:`dot_product_attention`),
    output projection. ``valid_len`` (given to ``forward``) masks the keys of a padded
    stream."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float, dtype, device,
                 attention_fn: Optional[Callable] = None, generator=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.qkv = _Dense(dim, 3 * dim, dtype, device)
        self.out = _Dense(dim, dim, dtype, device)
        self.attention_fn = attention_fn
        self.dropout_rate = dropout_rate
        self.generator = generator

    def forward(self, x, valid_len: "int | None" = None):
        b, t, d = x.shape
        qkv = self.qkv(x).view(b, t, 3, self.num_heads, self.head_dim)
        # Views, not copies: the flash kernels read q, k, v through their strides.
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.attention_fn is not None:
            out = self.attention_fn(q, k, v, valid_len=valid_len)
        else:
            out = dot_product_attention(q, k, v, dtype=self.dtype, valid_len=valid_len)
        out = self.out(out.reshape(b, t, d))
        return dropout(out, self.dropout_rate, self.training, self.generator)


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln(x))``, then ``x + mlp(ln(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, dropout_rate: float, dtype, device,
                 attention_fn: Optional[Callable] = None, generator=None):
        super().__init__()
        self.ln1 = _LayerNorm(dim, dtype, device)
        self.attn = MultiHeadAttention(dim, num_heads, dropout_rate, dtype, device, attention_fn, generator)
        self.ln2 = _LayerNorm(dim, dtype, device)
        self.mlp = MlpBlock(dim, mlp_dim, dropout_rate, dtype, device, generator)

    def forward(self, x, valid_len: "int | None" = None):
        x = x + self.attn(self.ln1(x), valid_len)
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """ViT with learned position embeddings and a class token, on NCHW images of
    ``image_size`` x ``image_size``.

    ``use_flash`` (True, False, or None = auto) picks the attention path, and ``pallas``
    overrides it when not None.
    ``device`` defaults to the card and raises when there is none; pass ``device="cpu"`` to
    build on the CPU (or ``"meta"`` to count parameters). ``generator`` (on ``device``)
    seeds the initial weights and dropout's masks."""

    def __init__(
        self,
        num_classes: int = 1000,
        patch_size: int = 16,
        hidden_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_dim: int = 3072,
        dropout_rate: float = 0.0,
        *,
        image_size: int = 224,
        dtype: torch.dtype = torch.float32,
        use_flash: Optional[bool] = False,
        pallas: Optional[bool] = None,
        pad_seq_to: Optional[int] = None,
        device="cuda",
        generator: "torch.Generator | None" = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} not divisible by patch size {patch_size}")
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.pad_seq_to = pad_seq_to
        flash = use_flash if pallas is None else pallas
        attention_fn = None if flash is False else default_attention_fn(flash)
        if attention_fn is None:
            dispatch.record("vit", "attention", "plain", reason="pallas/use_flash=False")
        self.attention_fn = attention_fn
        if generator is None and device.type != "meta":
            generator = default_generator(device)
        self.generator = generator
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size, device=device)
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_dim, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden_dim, device=device))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dropout_rate, dtype, device, attention_fn, generator)
            for _ in range(depth)
        )
        self.norm = _LayerNorm(hidden_dim, dtype, device)
        self.head = nn.Linear(hidden_dim, num_classes, device=device)
        self.init_weights(generator)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: "torch.Generator | None" = None) -> None:
        """flax's initialisers in distribution: LeCun-normal kernels with zero biases, unit
        LayerNorm scales, a zero class token, N(0, 0.02) positions, a zero head."""
        if self.head.weight.is_meta:
            return
        generator = generator or default_generator(self.head.weight.device)
        p = self.patch_size
        lecun_normal_(self.patch_embed.weight, 3 * p * p, generator)
        self.patch_embed.bias.zero_()
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, _Dense):
                lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.head.weight.zero_()
        self.head.bias.zero_()

    def forward(self, x):
        """``x`` ``[B, 3, H, W]`` -> f32 logits ``[B, num_classes]``."""
        b, _, h, w = x.shape
        p, d, dt = self.patch_size, self.hidden_dim, self.dtype
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch size {p}")
        if (h // p) * (w // p) + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"input {h}x{w} gives {(h // p) * (w // p) + 1} tokens; the model was built for "
                             f"{self.pos_embed.shape[1]} (image_size)")
        x = F.conv2d(x.to(dt), self.patch_embed.weight.to(dt), self.patch_embed.bias.to(dt), stride=p)
        x = x.flatten(2).transpose(1, 2)  # [B, T - 1, D], pixels in row-major order
        x = torch.cat([self.cls_token.to(dt).expand(b, 1, d), x], dim=1)
        x = x + self.pos_embed.to(dt)
        x = dropout(x, self.dropout_rate, self.training, self.generator)
        valid_len = None
        if self.pad_seq_to is not None and x.shape[1] < self.pad_seq_to:
            valid_len = x.shape[1]
            x = F.pad(x, (0, 0, 0, self.pad_seq_to - valid_len))
        for block in self.blocks:
            x = block(x, valid_len)
        x = self.norm(x)
        return F.linear(x[:, 0].float(), self.head.weight, self.head.bias)  # class token, f32


def ViTB16(num_classes: int = 1000, dtype: torch.dtype = torch.float32, use_flash: Optional[bool] = None,
           **kw) -> ViT:
    """ViT-B/16 (12 x 768, 12 heads, mlp 3072, patch 16). ``use_flash=None`` (auto) runs
    the flash kernels on CUDA tensors at every T, 197 at 224x224; the ``pallas=`` knob (in
    ``kw``) overrides it when set."""
    return ViT(num_classes=num_classes, patch_size=16, hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072,
               dtype=dtype, use_flash=use_flash, **kw)


def ViTTiny(num_classes: int = 10, dtype: torch.dtype = torch.float32, **kw) -> ViT:
    """Small variant for tests (2 x 32, 4 heads, mlp 64, patch 4; 32x32 images unless
    ``image_size`` says otherwise)."""
    kw.setdefault("image_size", 32)
    return ViT(num_classes=num_classes, patch_size=4, hidden_dim=32, depth=2, num_heads=4, mlp_dim=64,
               dtype=dtype, **kw)
