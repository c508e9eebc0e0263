"""The port's KV-cache decode step and ``generate`` (``distributed_training_pytorch_tpu_torch/
models/transformer_lm.py``) held against the JAX package's on the same weights.

JAX params carry over through ``params_from_jax``; tokens come from numpy with a seed. The
JAX side steps ``decode=True`` with ``mutable=["cache"]``, as ``tests/test_transformer_lm.py``
does, and runs its jitted ``generate``.

Tolerances: decode logits at every position within 2e-4 of the JAX decode in f32 (the JAX
test's bound between decode and the full forward) and within 8e-3 in bf16 (the dense
layers' bf16 products rounded in other orders by XLA and by PyTorch; the gap measured on
these inputs is 4.5e-3, and 3.7e-3 between the two full forwards); the cache within 2e-4 in
f32, and in bf16 the first block's within one bf16 ulp of the q, k, v products before
their bias (2^-6 at their size of up to 4: XLA rounds the product, then the sum, where
``addmm`` rounds once; the later blocks carry those roundings); the port's decode against
its own full forward within 2e-5 in f32; greedy tokens equal.

The bf16 attention's rounding order cannot be seen in the logits: the dense layers' gaps
hide it (an attention that scales q before rounding q·kᵀ, keeps q·kᵀ in f32, or keeps the
softmax in f32 measured 4.6e-3, 5.6e-3 and 4.6e-3 on these inputs). So
``decode_attention`` is held on its own, on the JAX block's own bf16 q and cache at every
step: bit-equal to the output the JAX block hands to ``attn_out``. Each of those three
wrong orders moves that output by one bf16 ulp, 2^-6 at its size of up to 3 (measured on
these and two other seeds; bit-equal on all three for the right order).
"""

import gc
import weakref

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.models.transformer_lm import _DecodeRun, decode_attention, generate

VOCAB, MAX_LEN = 64, 32
ATOL = {"float32": 2e-4, "bfloat16": 8e-3}


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_lm.LMTiny(vocab_size=VOCAB, max_len=MAX_LEN, attention_impl="plain")
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _models(jax_params, dtype):
    jax_model = jax_lm.LMTiny(vocab_size=VOCAB, max_len=MAX_LEN, attention_impl="plain", dtype=getattr(jnp, dtype))
    port = LMTiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=getattr(torch, dtype), device="cpu")
    port.load_state_dict(params_from_jax(jax_params))
    return jax_model, port.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_logits_and_cache_match_jax_at_every_position(jax_params, dtype):
    jax_model, port = _models(jax_params, dtype)
    toks = _tokens(2, 12, seed=6)
    step = jax.jit(lambda variables, tok: jax_model.apply(variables, tok, decode=True, mutable=["cache"]))
    cache = jax.eval_shape(step, {"params": jax_params}, jnp.zeros((2, 1), jnp.int32))[1]["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cache)  # the JAX cache's initial value
    jax_steps = []
    for t in range(toks.shape[1]):
        logits, state = step({"params": jax_params, "cache": cache}, jnp.asarray(toks[:, t : t + 1]))
        cache = state["cache"]
        jax_steps.append(np.asarray(logits[:, 0]))
    port_cache = port.init_cache(2)
    with torch.no_grad():
        steps = [port(torch.from_numpy(toks[:, t : t + 1]), decode=True, cache=port_cache)[:, 0] for t in range(12)]
    got = torch.stack(steps, 1).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 12, VOCAB)
    np.testing.assert_allclose(got, np.stack(jax_steps, 1), atol=ATOL[dtype], rtol=0)
    assert int(port_cache.position) == int(cache["position"]) == 12
    for i in range(2):
        block = cache[f"DecoderBlock_{i}"]
        for mine, name in ((port_cache.k[i], "cached_key"), (port_cache.v[i], "cached_value")):
            assert tuple(mine.shape) == block[name].shape == (2, MAX_LEN, 4, 8)
            ref = np.asarray(block[name], np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(mine.numpy(), ref, atol=ATOL[dtype], rtol=0)
            elif i == 0:  # one bf16 ulp of the product before the bias (XLA rounds it, addmm not)
                np.testing.assert_allclose(mine.float().numpy(), ref, rtol=2**-7, atol=2**-6)


def test_decode_attention_rounds_as_the_jax_block(jax_params):
    jax_model, _ = _models(jax_params, "bfloat16")
    toks = _tokens(2, 12, seed=6)
    seen = []

    def capture(next_fun, args, kwargs, context):  # the qkv output and attn_out's input
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.name in ("qkv", "attn_out"):
            seen.append(out if context.module.name == "qkv" else args[0])
        return out

    cache = jax.eval_shape(
        lambda variables, tok: jax_model.apply(variables, tok, decode=True, mutable=["cache"]),
        {"params": jax_params}, jnp.zeros((2, 1), jnp.int32),
    )[1]["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cache)

    def port(a):  # bf16 bits carried across through f32, which holds them exactly
        return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()

    for t in range(toks.shape[1]):
        seen.clear()
        with nn.intercept_methods(capture):
            _, state = jax_model.apply(
                {"params": jax_params, "cache": cache}, jnp.asarray(toks[:, t : t + 1]), decode=True, mutable=["cache"]
            )
        cache = state["cache"]
        for i in range(2):
            qkv, y = seen[2 * i], seen[2 * i + 1]
            block = cache[f"DecoderBlock_{i}"]
            got = decode_attention(
                port(qkv[:, :, 0]), port(block["cached_key"]), port(block["cached_value"]), torch.tensor(t)
            )
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == y.shape == (2, 1, 4, 8)
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(y, np.float32))


def test_dropping_the_model_frees_its_decode_runs(jax_params):
    # A run kept in _decode_runs must not refer back to the model: with no cycle, the model,
    # its graphs and their static caches go when its last reference does, not at some later
    # collection.
    _, port = _models(jax_params, "float32")
    port._decode_runs["key"] = _DecodeRun(port, (2, 3), 4, sampled=True)
    alive = weakref.ref(port)
    gc.disable()
    try:
        del port
        assert alive() is None
    finally:
        gc.enable()


def test_decode_matches_its_own_full_forward(jax_params):
    _, port = _models(jax_params, "float32")
    toks = torch.from_numpy(_tokens(3, 20, seed=2))
    cache = port.init_cache(3)
    with torch.no_grad():
        full = port(toks)
        steps = torch.cat([port(toks[:, t : t + 1], decode=True, cache=cache) for t in range(20)], 1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=2e-5, rtol=0)


def test_greedy_generate_equals_jax_generate(jax_params):
    jax_model, port = _models(jax_params, "float32")
    prompt = _tokens(2, 6, seed=7)
    ref = np.asarray(jax_lm.generate(jax_model, {"params": jax_params}, jnp.asarray(prompt), 14, jax.random.key(1)))
    out = generate(port, torch.from_numpy(prompt), 14)
    assert out.dtype == torch.long and out.shape == (2, 20)
    np.testing.assert_array_equal(out.numpy(), ref)
    # The comparison means something only if no step's top two logits are within the
    # tolerance of each other: check the seed's margins on the JAX full forward.
    logits = np.asarray(jax_model.apply({"params": jax_params}, jnp.asarray(ref[:, :-1])))[:, 5:]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > ATOL["float32"]
    np.testing.assert_array_equal(np.argmax(logits, -1), ref[:, 6:])


def test_seeded_sampling_keeps_the_prompt(jax_params):
    _, port = _models(jax_params, "float32")
    prompt = torch.from_numpy(_tokens(2, 4, seed=8))

    def sample(seed, temperature=1.0):
        return generate(port, prompt, 12, torch.Generator().manual_seed(seed), temperature=temperature)

    a, b, c = sample(5), sample(5), sample(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    for out in (a, c):
        assert out.shape == (2, 16)
        torch.testing.assert_close(out[:, :4], prompt.long(), rtol=0, atol=0)
        assert 0 <= int(out.min()) and int(out.max()) < VOCAB
    # At a temperature near 0 the Gumbel-max draw is the argmax.
    torch.testing.assert_close(sample(5, temperature=1e-6), generate(port, prompt, 12), rtol=0, atol=0)


def test_refusals(jax_params):
    _, port = _models(jax_params, "float32")
    with pytest.raises(ValueError, match="one token at a time, got T=2"):
        port(torch.zeros(1, 2, dtype=torch.long), decode=True, cache=port.init_cache(1))
    with pytest.raises(ValueError, match="cache="):
        port(torch.zeros(1, 1, dtype=torch.long), decode=True)
    with pytest.raises(ValueError, match=f"prompt 20 \\+ steps 13 exceeds max_len {MAX_LEN}"):
        generate(port, torch.zeros(1, 20, dtype=torch.long), 13)
    with pytest.raises(ValueError, match="generator="):
        generate(port, torch.zeros(1, 2, dtype=torch.long), 3, temperature=0.5)
    cache = port.init_cache(1)
    with torch.no_grad():
        for _ in range(MAX_LEN):
            port(torch.zeros(1, 1, dtype=torch.long), decode=True, cache=cache)
        with pytest.raises(ValueError, match="all of them written"):
            port(torch.zeros(1, 1, dtype=torch.long), decode=True, cache=cache)
