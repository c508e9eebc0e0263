"""The port's ``TransformerLM`` (``distributed_training_pytorch_tpu_torch/models/``) held
against the JAX package's on the same weights.

JAX params carry over through ``params_from_jax``; tokens come from numpy with a seed.
Tolerance: f32 atol 2e-4 on the logits, as ``tests/test_transformer_lm.py`` holds the
flash path against the plain one (two layers of LayerNorm, GELU and dense products,
summed in other orders by XLA and by PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu_torch.models import GPTSmall, LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

VOCAB = 64
ATOL = 2e-4


def _tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_lm.LMTiny(vocab_size=VOCAB, attention_impl="plain")
    params = model.init(jax.random.key(0), jnp.zeros((1, 16), jnp.int32))["params"]
    return jax.tree.map(np.asarray, params)


def _port(jax_params, **kw):
    model = LMTiny(vocab_size=VOCAB, device="cpu", **kw)
    model.load_state_dict(params_from_jax(jax_params))
    return model.eval()


@pytest.mark.parametrize("t", [16, 37])
@pytest.mark.parametrize("jax_impl", ["plain", "flash"])
@pytest.mark.parametrize("port_impl", ["auto", "flash", "plain"])
def test_logits_match_jax(jax_params, t, jax_impl, port_impl):
    toks = _tokens(2, t, seed=t)
    ref = jax_lm.LMTiny(vocab_size=VOCAB, attention_impl=jax_impl).apply(
        {"params": jax_params}, jnp.asarray(toks)
    )
    with torch.inference_mode():
        out = _port(jax_params, attention_impl=port_impl)(torch.from_numpy(toks))
    assert out.dtype == torch.float32 and out.shape == (2, t, VOCAB)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_return_hidden_matches_jax(jax_params):
    toks = _tokens(3, 21, seed=4)
    ref = jax_lm.LMTiny(vocab_size=VOCAB, attention_impl="plain").apply(
        {"params": jax_params}, jnp.asarray(toks), return_hidden=True
    )
    model = _port(jax_params)
    with torch.inference_mode():
        hidden = model(torch.from_numpy(toks), return_hidden=True)
        logits = model.logits(hidden[:, -1])
        full = model(torch.from_numpy(toks))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(ref), atol=ATOL)
    torch.testing.assert_close(logits, full[:, -1])


def test_pallas_knob_maps_onto_attention_impl(jax_params):
    toks = torch.from_numpy(_tokens(1, 20))
    with torch.inference_mode():
        forced_plain = _port(jax_params, attention_impl="flash", pallas=False)(toks)
        plain = _port(jax_params, attention_impl="plain")(toks)
    torch.testing.assert_close(forced_plain, plain, atol=0, rtol=0)
    assert fa.launches["fwd"] == 0  # CPU tensors never reach the kernel


def test_unported_paths_raise_not_implemented():
    # MoE blocks are ported: every second block's MLP is an MoEMlp; an unknown route raises
    assert [block.use_moe for block in LMTiny(moe_every=2, device="cpu").blocks] == [False, True]
    with pytest.raises(ValueError, match="dispatch_impl must be auto|einsum|sort"):
        LMTiny(moe_every=2, moe_dispatch_impl="scatter", device="cpu")
    with pytest.raises(ValueError, match='attention_impl="ring" needs mesh='):
        LMTiny(attention_impl="ring", device="cpu")  # the ring runs over a mesh's seq axis
    with pytest.raises(ValueError, match="decode=True needs cache="):  # the decode step is ported
        LMTiny(device="cpu")(torch.zeros(1, 1, dtype=torch.long), decode=True)
    with pytest.raises(ValueError, match="max_len"):
        LMTiny(device="cpu", max_len=8)(torch.zeros(1, 9, dtype=torch.long))


def test_gpt_small_param_count_matches_jax():
    shapes = jax.eval_shape(
        lambda: jax_lm.GPTSmall().init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    )["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in GPTSmall(device="meta").parameters())
    assert n_port == n_jax == 124_439_808


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTiny()
