"""Decoder-only transformer LM in PyTorch.

Counterpart of ``distributed_training_pytorch_tpu/models/transformer_lm.py``: pre-LN
blocks, learned positions, causal attention through the kernel dispatch policy
(``ops/dispatch.py``), and logits tied to the token embedding, in f32. This slice ports the
dense, full-sequence forward. MoE blocks, ring attention and the KV-cache decode step raise
``NotImplementedError``: they come with the LM training and decode slices.

Parity with the flax model, where it is not the PyTorch default:

* flax ``LayerNorm`` has eps 1e-6, not torch's 1e-5, and normalises in f32;
* flax ``nn.gelu`` is the tanh approximation: ``F.gelu(approximate="tanh")``;
* ``qkv`` is a ``DenseGeneral`` to ``(3, H, Dh)``: here one ``Linear(d, 3 * d)`` whose
  output splits as ``[..., 3, H, Dh]`` on the ``3`` axis; ``attn_out`` contracts
  ``(H, Dh)``: here ``Linear(H * Dh, d)`` on the flattened heads (``models/convert.py``
  maps the kernels, and flax's ``[in, out]`` onto torch's ``[out, in]``);
* ``pos_embed`` is ``[1, max_len, d]``, sliced to ``T``;
* params stay f32 whatever ``dtype`` is, and are cast to ``dtype`` where they are used;
  the logits are f32 against the f32 embedding;
* token ids reach ``nn.Embedding`` as int64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.flash_attention import causal_attention_plain

__all__ = ["DecoderBlock", "GPTSmall", "LMTiny", "TransformerLM", "make_fused_lm_loss"]

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _causal_attention_fn(attention_impl: str):
    """Resolve ``attention_impl`` to a ``(q, k, v) -> o`` callable through the dispatch
    policy, which records the resolution as a ``kernel_dispatch`` decision."""
    if attention_impl == "ring":
        raise NotImplementedError(
            'attention_impl="ring" (sequence-parallel ring attention) comes with the '
            "ring-attention slice of the port"
        )
    if attention_impl not in ("auto", "flash", "plain"):
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    use_flash = {"auto": None, "flash": True, "plain": False}[attention_impl]
    fn = dispatch.attention_fn("transformer_lm", use_flash, causal=True)
    return fn if fn is not None else causal_attention_plain


class _LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics in f32, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__(dim, eps=LN_EPS, device=device)
        self.out_dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.out_dtype)


class _Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: f32 params, input and params cast to ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device):
        super().__init__(d_in, d_out, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class DecoderBlock(nn.Module):
    """Pre-LN decoder block: ``x + attn(ln(x))``, then ``x + mlp(ln(x))``."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        mlp_dim: int,
        *,
        dtype: torch.dtype = torch.float32,
        attention_impl: str = "auto",
        device="cuda",
    ):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden dim {hidden_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = hidden_dim // num_heads
        self.ln1 = _LayerNorm(hidden_dim, dtype, device)
        self.qkv = _Dense(hidden_dim, 3 * hidden_dim, dtype, device)
        self.attn_out = _Dense(hidden_dim, hidden_dim, dtype, device)
        self.ln2 = _LayerNorm(hidden_dim, dtype, device)
        self.mlp_in = _Dense(hidden_dim, mlp_dim, dtype, device)
        self.mlp_out = _Dense(mlp_dim, hidden_dim, dtype, device)
        self.attn = _causal_attention_fn(attention_impl)

    def forward(self, x):
        b, t, d = x.shape
        # flax's qkv DenseGeneral emits (3, H, Dh) per token; split on the 3 axis.
        qkv = self.qkv(self.ln1(x)).view(b, t, 3, self.num_heads, self.head_dim)
        # Views, not copies: the flash kernel reads q/k/v through their strides.
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        y = self.attn(q, k, v)
        x = x + self.attn_out(y.reshape(b, t, d))
        # flax nn.gelu is the tanh approximation, not torch's exact default.
        y = self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh"))
        return x + y


class TransformerLM(nn.Module):
    """Token-in, next-token-logits-out causal LM (dense; tied f32 logits).

    ``device`` defaults to the card and raises when there is none; pass ``device="cpu"``
    to build on the CPU. ``generator`` (on ``device``) seeds the initial weights.
    """

    def __init__(
        self,
        vocab_size: int,
        hidden_dim: int = 512,
        depth: int = 8,
        num_heads: int = 8,
        mlp_dim: int = 2048,
        max_len: int = 2048,
        *,
        dtype: torch.dtype = torch.float32,
        attention_impl: str = "auto",
        pallas: "bool | None" = None,
        moe_every: int = 0,
        device="cuda",
        generator: "torch.Generator | None" = None,
    ):
        super().__init__()
        if moe_every > 0:
            raise NotImplementedError(
                "moe_every > 0 (Mixture-of-Experts blocks) comes with the expert-parallel slice of the port"
            )
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_dim = hidden_dim
        self.max_len = max_len
        self.dtype = dtype
        impl = dispatch.lm_attention_impl(attention_impl, pallas)
        self.embed = nn.Embedding(vocab_size, hidden_dim, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, max_len, hidden_dim, device=device))
        self.blocks = nn.ModuleList(
            DecoderBlock(hidden_dim, num_heads, mlp_dim, dtype=dtype, attention_impl=impl, device=device)
            for _ in range(depth)
        )
        self.ln_f = _LayerNorm(hidden_dim, dtype, device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: "torch.Generator | None" = None) -> None:
        """flax's initialisers in distribution: N(0, 0.02) embeddings, LeCun-normal dense
        kernels with zero bias, unit LayerNorm scales."""
        if generator is None:
            dev = self.embed.weight.device
            generator = torch.Generator(device=dev if dev.type == "cuda" else "cpu").manual_seed(0)
        self.embed.weight.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, _Dense):
                mod.weight.normal_(0.0, mod.in_features**-0.5, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def forward(self, tokens, *, return_hidden: bool = False, decode: bool = False):
        """``tokens`` ``[B, T]`` -> f32 logits ``[B, T, V]``; ``return_hidden=True`` returns
        the final-LN hidden states ``[B, T, d]`` in ``dtype`` instead."""
        if decode:
            raise NotImplementedError("decode=True (the KV-cache step) comes with the LM decode slice of the port")
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence {t} exceeds max_len {self.max_len}")
        x = self.embed(tokens.long()).to(self.dtype)  # nn.Embedding takes int64 ids
        x = x + self.pos_embed[:, :t].to(self.dtype)  # [1, max_len, d] sliced to T
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.logits(x)

    def logits(self, hidden):
        """Tied f32 logits of hidden states ``[..., d]``."""
        return hidden.float() @ self.embed.weight.float().T  # f32, as the flax model


def GPTSmall(vocab_size: int = 50257, dtype: torch.dtype = torch.float32, **kw) -> TransformerLM:
    """GPT-2-small-shaped config (12 x 768, 12 heads, mlp 3072, max_len 1024)."""
    kw.setdefault("max_len", 1024)
    return TransformerLM(vocab_size, hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072, dtype=dtype, **kw)


def LMTiny(vocab_size: int = 256, dtype: torch.dtype = torch.float32, **kw) -> TransformerLM:
    """Small variant for tests (2 x 32, 4 heads, mlp 64, max_len 128)."""
    kw.setdefault("max_len", 128)
    return TransformerLM(vocab_size, hidden_dim=32, depth=2, num_heads=4, mlp_dim=64, dtype=dtype, **kw)


def make_fused_lm_loss(model: TransformerLM):
    """Engine ``LossFn`` for next-token training through the fused tied-embedding CE
    (``ops.losses.tied_cross_entropy``): the ``[B, T, V]`` f32 logits never materialise.
    Counterpart of ``transformer_lm.py::make_fused_lm_loss`` for dense models. Batch
    contract: ``image`` = input tokens, ``label`` = next tokens, optional ``mask`` ``[B]``
    pad weights. Metrics: ``loss``, ``nll`` (the same value) and ``ppl``.

    The loss function takes the model it is called with, which may be ``model`` wrapped in
    ``DistributedDataParallel``: the hidden states come through the wrapper, and the tied
    embedding from the module under it."""
    from distributed_training_pytorch_tpu_torch.ops.losses import tied_cross_entropy, weighted_mean
    from distributed_training_pytorch_tpu_torch.train.state import unwrap

    def loss_fn(net, batch, train: bool):
        hidden = net(batch["image"], return_hidden=True)
        nll = tied_cross_entropy(hidden, unwrap(net).embed.weight, batch["label"]).mean(dim=-1)
        loss = weighted_mean(nll, batch.get("mask"))
        return loss, {"loss": loss, "nll": loss, "ppl": torch.exp(loss)}

    return loss_fn
