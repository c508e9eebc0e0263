"""Decoder-only transformer LM in PyTorch.

Counterpart of ``distributed_training_pytorch_tpu/models/transformer_lm.py``: pre-LN
blocks, learned positions, causal attention through the kernel dispatch policy
(``ops/dispatch.py``) or, with ``attention_impl="ring"`` and a ``mesh`` with a ``seq``
axis, ring attention over that axis (``parallel/ring_attention.py``), and logits tied to
the token embedding, in f32. MoE blocks raise ``NotImplementedError``: they come with the
expert-parallel slice.

``forward(decode=True, cache=...)`` is the KV-cache step of the JAX model's
``decode=True`` (``[B, 1]`` tokens; a :class:`KVCache` of ``[B, max_len, H, Dh]`` k and v
per block and one position counter on the device, written in place at the position), and
:func:`generate` its autoregressive loop. On the card ``generate`` replays the step as a
captured CUDA graph, the counterpart of the JAX ``_generate_jit`` (one dispatch for the
whole scan); on the CPU it runs the same step eagerly. The decode attention is the JAX
block's ``einsum`` arithmetic (no Pallas kernel there, so no hand kernel here): q k^T in
``dtype`` rounded to ``dtype`` before the f32 cast, the scale after that rounding, -1e30 at
the positions not yet written, the softmax in f32 cast to ``dtype`` before the product
with v.

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

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.flash_attention import causal_attention_plain

__all__ = ["DecoderBlock", "GPTSmall", "KVCache", "LMTiny", "TransformerLM", "generate", "make_fused_lm_loss"]

LN_EPS = 1e-6  # flax nn.LayerNorm's default
MASKED = -1e30  # the JAX decode block's fill for positions not yet written
DECODE_GRAPHS = 4  # captured generate loops kept on a model, the least recently used dropped


def _causal_attention_fn(attention_impl: str, mesh=None):
    """Resolve ``attention_impl`` to a ``(q, k, v) -> o`` callable through the dispatch
    policy, which records the resolution as a ``kernel_dispatch`` decision; ``"ring"`` is
    causal ring attention over ``mesh``'s seq axis."""
    if attention_impl == "ring":
        if mesh is None:
            raise ValueError('attention_impl="ring" needs mesh=')
        from distributed_training_pytorch_tpu_torch.parallel.ring_attention import ring_attention

        dispatch.record("transformer_lm", "attention", "ring", reason="attention_impl=ring")
        return lambda q, k, v: ring_attention(q, k, v, mesh, causal=True)
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
        mesh=None,
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
        self.attn = _causal_attention_fn(attention_impl, mesh)

    def forward(self, x):
        b, t, d = x.shape
        # flax's qkv DenseGeneral emits (3, H, Dh) per token; split on the 3 axis.
        qkv = self.qkv(self.ln1(x)).view(b, t, 3, self.num_heads, self.head_dim)
        # Views, not copies: the flash kernel reads q/k/v through their strides.
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        y = self.attn(q, k, v)
        x = x + self.attn_out(y.reshape(b, t, d))
        return x + self._mlp(x)

    def _mlp(self, x):
        # flax nn.gelu is the tanh approximation, not torch's exact default.
        return self.mlp_out(F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh"))

    def decode(self, x, cache_k, cache_v, position):
        """One token ``x`` ``[B, 1, d]`` against the cache: writes its k and v at
        ``position`` (a device scalar) in place, attends over the written prefix."""
        b, t, d = x.shape
        if t != 1:
            raise ValueError(f"decode mode consumes one token at a time, got T={t}")
        qkv = self.qkv(self.ln1(x)).view(b, 1, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        cache_k.index_copy_(1, position.view(1), k)
        cache_v.index_copy_(1, position.view(1), v)
        y = decode_attention(q, cache_k, cache_v, position)
        x = x + self.attn_out(y.reshape(b, 1, d))
        return x + self._mlp(x)


def decode_attention(q, cache_k, cache_v, position):
    """``q`` ``[B, 1, H, Dh]`` against the cache ``[B, max_len, H, Dh]`` up to ``position``
    -> ``[B, 1, H, Dh]`` in ``q``'s dtype, with the JAX decode block's roundings: q·kᵀ
    rounded to the dtype, then cast to f32 and scaled; -1e30 past ``position``; the f32
    softmax cast to the dtype before the product with v."""
    # The cache is stored head-major ([B, H, max_len, Dh] under the [B, max_len, H, Dh]
    # view), so both products are batched GEMMs over B * H with no copy of the cache.
    keys, values = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    logits = torch.matmul(q.transpose(1, 2), keys.transpose(2, 3)).float()  # [B, H, 1, L]
    valid = torch.arange(keys.shape[2], device=q.device) <= position
    logits = torch.where(valid, logits * q.shape[-1] ** -0.5, MASKED)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(weights, values).transpose(1, 2)


class KVCache:
    """The decode state of a :class:`TransformerLM`, the JAX model's ``'cache'``
    collection: ``k[i]`` and ``v[i]`` of block ``i``, each ``[B, max_len, H, Dh]`` in the
    model's dtype, zeros until written, and ``position``, one int64 counter on the device
    for the whole model. ``steps`` counts the eager steps taken, on the host, so that a
    step past ``max_len`` raises instead of writing outside the cache."""

    def __init__(self, k: "list[torch.Tensor]", v: "list[torch.Tensor]", position: torch.Tensor):
        self.k, self.v, self.position = k, v, position
        self.steps = 0

    def reset(self) -> None:
        for t in (*self.k, *self.v, self.position):
            t.zero_()
        self.steps = 0


class TransformerLM(nn.Module):
    """Token-in, next-token-logits-out causal LM (dense; tied f32 logits).

    ``attention_impl``: ``"auto"``, ``"flash"``, ``"plain"`` or ``"ring"`` (over the seq
    axis of ``mesh``, a ``parallel.mesh.Mesh``); ``pallas=True`` / ``False`` takes
    precedence and turns any of them into ``"flash"`` / ``"plain"``, as in the JAX package.
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
        mesh=None,
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
            DecoderBlock(hidden_dim, num_heads, mlp_dim, dtype=dtype, attention_impl=impl, mesh=mesh, device=device)
            for _ in range(depth)
        )
        self.ln_f = _LayerNorm(hidden_dim, dtype, device)
        self.init_weights(generator)
        self._decode_runs: "OrderedDict[tuple, _DecodeRun]" = OrderedDict()  # generate's graphs

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

    def init_cache(self, batch: int) -> KVCache:
        """A zeroed :class:`KVCache` for ``batch`` sequences, at full ``max_len``."""
        dev = self.embed.weight.device
        k, v = [], []
        for block in self.blocks:
            for store in (k, v):
                # head-major storage under the [B, max_len, H, Dh] view (see DecoderBlock.decode)
                store.append(
                    torch.zeros(batch, block.num_heads, self.max_len, block.head_dim, dtype=self.dtype, device=dev)
                    .transpose(1, 2)
                )
        return KVCache(k, v, torch.zeros((), dtype=torch.long, device=dev))

    def forward(self, tokens, *, return_hidden: bool = False, decode: bool = False, cache: "KVCache | None" = None):
        """``tokens`` ``[B, T]`` -> f32 logits ``[B, T, V]``; ``return_hidden=True`` returns
        the final-LN hidden states ``[B, T, d]`` in ``dtype`` instead. ``decode=True`` takes
        ``[B, 1]`` tokens at ``cache.position``, writes their keys and values into
        ``cache`` and advances the position by one."""
        if decode:
            if cache is None:
                raise ValueError("decode=True needs cache= (TransformerLM.init_cache)")
            if tokens.shape[1] != 1:
                raise ValueError(f"decode mode consumes one token at a time, got T={tokens.shape[1]}")
            if cache.steps >= self.max_len:
                raise ValueError(f"the cache holds max_len {self.max_len} positions, all of them written")
            cache.steps += 1
            x = self._decode_hidden(tokens, cache)
            return x if return_hidden else self.logits(x)
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

    def _decode_hidden(self, tokens, cache: KVCache):
        """The decode step with no host-side check: what a CUDA graph captures."""
        position = cache.position
        x = self.embed(tokens.long()).to(self.dtype)
        x = x + self.pos_embed.index_select(1, position.view(1)).to(self.dtype)  # pos_embed[:, i]
        for block, k, v in zip(self.blocks, cache.k, cache.v):
            x = block.decode(x, k, v, position)
        position.add_(1)
        return self.ln_f(x)

    def logits(self, hidden):
        """Tied f32 logits of hidden states ``[..., d]``."""
        return hidden.float() @ self.embed.weight.float().T  # f32, as the flax model


class _DecodeRun:
    """The static buffers of one ``generate`` shape (batch, prompt length, steps, greedy or
    sampled) and its step: feed a token, take the logits, pick the next token (the prompt's
    while inside it, else argmax, or Gumbel-max over ``logits / temperature`` with noise
    drawn outside the step), write it at its position of ``out``. It holds no reference to
    the model, which keeps it in ``_decode_runs``: so dropping the model frees its graphs and
    caches at once, with no cycle for the garbage collector to find."""

    def __init__(self, model: TransformerLM, prompt_shape: tuple, num_steps: int, sampled: bool):
        b, p = prompt_shape
        dev = model.embed.weight.device
        self.p, self.sampled = p, sampled
        self.cache = model.init_cache(b)
        self.prompt = torch.zeros(b, p, dtype=torch.long, device=dev)
        self.token = torch.zeros(b, 1, dtype=torch.long, device=dev)
        self.out = torch.zeros(b, p + num_steps, dtype=torch.long, device=dev)
        self.noise = torch.zeros(b, model.vocab_size, dtype=torch.float32, device=dev) if sampled else None
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.graph = None

    def load(self, prompt: torch.Tensor, temperature: float) -> None:
        self.cache.reset()
        self.prompt.copy_(prompt)
        self.token.copy_(prompt[:, :1])
        self.out.zero_()
        self.out[:, :1].copy_(prompt[:, :1])
        self.temperature.fill_(temperature if self.sampled else 1.0)

    def step(self, model: TransformerLM) -> None:
        t = self.cache.position.clone()  # the position the fed token takes
        logits = model.logits(model._decode_hidden(self.token, self.cache))[:, 0]  # [B, V] f32
        if self.sampled:
            gumbel = -torch.log(-torch.log(self.noise))
            sampled = torch.argmax(logits / self.temperature + gumbel, dim=-1)
        else:
            sampled = torch.argmax(logits, dim=-1)
        # While still inside the prompt, feed its next token.
        nxt = t + 1
        from_prompt = self.prompt.index_select(1, torch.clamp(nxt, max=self.p - 1).view(1))[:, 0]
        token = torch.where(nxt < self.p, from_prompt, sampled)
        self.out.index_copy_(1, nxt.view(1), token[:, None])
        self.token.copy_(token[:, None])

    def capture(self, model: TransformerLM) -> None:
        """Capture one step as a CUDA graph, after a warm-up on a side stream (``load``
        resets what the warm-up and the capture wrote)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.step(model)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step(model)
        self.graph = graph


@torch.no_grad()
def generate(
    model: TransformerLM,
    prompt,
    num_steps: int,
    generator: "torch.Generator | None" = None,
    *,
    temperature: float = 0.0,
    graph: bool = True,
) -> torch.Tensor:
    """Autoregressive sampling through the KV-cache decode step; counterpart of the JAX
    ``models/transformer_lm.py::generate``.

    ``prompt`` is ``[B, P]`` integer tokens; returns ``[B, P + num_steps]`` int64 on the
    model's device, the prompt first. One loop of ``P - 1 + num_steps`` single-token steps
    covers the prefill and the generation. ``temperature=0`` is greedy; above 0 it samples
    by Gumbel-max from ``generator`` (on the model's device), one ``[B, V]`` draw a step,
    the sampling of ``jax.random.categorical`` but not its bits. On the card each step is
    one replay of a CUDA graph captured for this (B, P, num_steps, greedy or sampled) and
    kept on the model; a failed capture raises. ``graph=False`` runs the same step
    eagerly, op by op (to hold the graph against it), as the CPU always does."""
    prompt = torch.as_tensor(prompt)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be [B, P] with P >= 1, got shape {tuple(prompt.shape)}")
    b, p = prompt.shape
    if p + num_steps > model.max_len:
        raise ValueError(f"prompt {p} + steps {num_steps} exceeds max_len {model.max_len}")
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("temperature > 0 samples: pass generator= (a torch.Generator on the model's device)")
    dev = model.embed.weight.device
    use_graph = graph and dev.type == "cuda"
    if use_graph:
        # The graph reads the weights where they were at capture: their addresses key it too.
        key = (b, p, num_steps, sampled, tuple(t.data_ptr() for t in model.parameters()))
        run = model._decode_runs.pop(key, None)
        if run is None:
            run = _DecodeRun(model, (b, p), num_steps, sampled)
            run.capture(model)
        model._decode_runs[key] = run  # the most recently used last
        while len(model._decode_runs) > DECODE_GRAPHS:
            model._decode_runs.popitem(last=False)
    else:
        run = _DecodeRun(model, (b, p), num_steps, sampled)
    run.load(prompt.to(dev, torch.long), temperature)
    for _ in range(p - 1 + num_steps):
        if sampled:
            run.noise.uniform_(generator=generator)
        if use_graph:
            run.graph.replay()
        else:
            run.step(model)
    return run.out.clone()


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
