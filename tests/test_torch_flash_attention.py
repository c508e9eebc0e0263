"""The port's flash-attention forward (``distributed_training_pytorch_tpu_torch/ops/
flash_attention.py``) held against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs in the Pallas
interpreter, as ``tests/test_pallas.py`` runs it. Inputs come from numpy with a seed and
cross between the frameworks as numpy arrays. Tolerance: f32 atol 2e-5, as
``tests/test_pallas.py`` holds the kernel against plain attention (the two sum in other
orders; nothing else differs). The kernel itself is held against the plain version on
the card by ``tests/test_torch_flash_kernel.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops import pallas as jax_pallas
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5


def _qkv(b, tq, tk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h, d).astype(np.float32)
    v = rng.randn(b, tk, h, d).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


SQUARE_CASES = [
    # b, t, h, d, causal, valid_len
    (2, 197, 3, 64, False, None),  # ViT-B/16's ragged T
    (2, 100, 2, 16, True, None),  # causal, unaligned T
    (1, 130, 4, 8, True, None),  # LMTiny's head dim, crosses a 64-row tile
    (2, 197, 2, 64, False, 150),  # caller-padded keys
    (1, 37, 2, 8, False, None),
]


@pytest.mark.parametrize("b,t,h,d,causal,valid_len", SQUARE_CASES)
def test_plain_matches_jax_kernel(b, t, h, d, causal, valid_len):
    q, k, v = _qkv(b, t, t, h, d)
    o_jax = jax_pallas.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, valid_len=valid_len, interpret=True,
    )
    _, lse_jax, _ = jax_pallas._fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        jax_pallas._DEFAULT_BLOCK_Q, jax_pallas._DEFAULT_BLOCK_K, True, valid_len,
    )
    o, lse = fa.flash_attention_fwd(*_torch(q, k, v), causal=causal, valid_len=valid_len)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax)[:, :, 0, :], atol=ATOL)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    o_pub = fa.flash_attention(*_torch(q, k, v), causal=causal, valid_len=valid_len)
    assert torch.equal(o_pub, o)


@pytest.mark.parametrize(
    "tq,tk,d,causal",
    [(50, 130, 8, False), (96, 40, 64, True), (130, 70, 16, True)],
)
def test_unequal_tq_tk_matches_jax_block_fwd(tq, tk, d, causal):
    q, k, v = _qkv(2, tq, tk, 2, d, seed=3)
    o_jax, lse_jax = jax_pallas.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True
    )
    o, lse = fa.flash_attention_fwd(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax), atol=ATOL)


def test_causal_plain_matches_jax():
    q, k, v = _qkv(2, 45, 45, 3, 16, seed=5)
    ref = jax_pallas._causal_plain(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = fa.causal_attention_plain(*_torch(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    o, _ = fa.flash_attention_fwd(*_torch(q, k, v), causal=True)
    np.testing.assert_allclose(o.numpy(), out.numpy(), atol=ATOL)


GUARD_CASES = [
    # (q shape, k shape, causal, valid_len): each raises ValueError in both packages
    ((1, 8, 2, 8), (1, 9, 2, 8), False, None),  # k shape differs
    ((8, 2, 8), (8, 2, 8), False, None),  # not 4-D
    ((1, 8, 2, 8), (1, 8, 2, 8), True, 4),  # valid_len with causal
    ((1, 8, 2, 8), (1, 8, 2, 8), False, 0),  # valid_len below range
    ((1, 8, 2, 8), (1, 8, 2, 8), False, 9),  # valid_len above range
]


@pytest.mark.parametrize("q_shape,k_shape,causal,valid_len", GUARD_CASES)
def test_guards_raise_like_jax(q_shape, k_shape, causal, valid_len):
    q = np.zeros(q_shape, np.float32)
    k = np.zeros(k_shape, np.float32)
    with pytest.raises(ValueError):
        jax_pallas.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
            causal=causal, valid_len=valid_len, interpret=True,
        )
    with pytest.raises(ValueError):
        fa.flash_attention(*_torch(q, k, k), causal=causal, valid_len=valid_len)


def test_cpu_never_launches_the_kernel():
    fa.reset_launches()
    q, k, v = _qkv(1, 20, 20, 2, 8)
    fa.flash_attention(*_torch(q, k, v), causal=True)
    fa.flash_attention_fwd(*_torch(q, k, v))
    assert fa.launches == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


def test_auto_dispatch_records_plain_on_cpu():
    dispatch.reset()
    fn = dispatch.attention_fn("transformer_lm", None, causal=True)
    q, k, v = _qkv(1, 12, 12, 2, 8)
    out = fn(*_torch(q, k, v))
    ref = fa.causal_attention_plain(*_torch(q, k, v))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    recs = dispatch.records()
    assert [(r["path"], r["seq_len"]) for r in recs] == [("plain", 12)]
    assert "FLASH_MIN_SEQ_LEN" not in recs[0]["reason"]
    assert dispatch.attention_fn("transformer_lm", False, causal=True) is None
    assert dispatch.records()[-1]["reason"] == "pallas=False"
    sunk = []
    dispatch.set_event_sink(lambda event, **f: sunk.append((event, f["path"])))
    assert sunk == [("kernel_dispatch", "plain"), ("kernel_dispatch", "plain")]
    dispatch.reset()
