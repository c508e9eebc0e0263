"""The port's flash-attention forward (``distributed_training_pytorch_tpu_torch/ops/
flash_attention.py``) held against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the JAX kernel runs in the Pallas
interpreter, as ``tests/test_pallas.py`` runs it. Inputs come from numpy with a seed and
cross between the frameworks as numpy arrays. Tolerance: f32 atol 2e-5, as
``tests/test_pallas.py`` holds the kernel against plain attention (the two sum in other
orders; nothing else differs). The kernel itself is held against the plain version on
the card by ``tests/test_torch_flash_kernel.py``.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops import pallas as jax_pallas
from distributed_training_pytorch_tpu_torch.ops import _build, dispatch
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


BF16_CASES = [
    # b, tq, tk, h, d, causal, block: flash_attention's square T, or one ring block (Tq != Tk)
    (2, 197, 197, 2, 64, False, False),
    (1, 256, 256, 2, 64, True, False),
    (2, 96, 160, 2, 64, True, True),
]


@pytest.mark.parametrize("b,tq,tk,h,d,causal,block", BF16_CASES)
def test_bf16_rounds_p_like_the_jax_kernel(b, tq, tk, h, d, causal, block):
    """On bf16 inputs the JAX kernel rounds p to bf16 before P V (``p.astype(v.dtype)``)
    while l sums the f32 p; the port does the same. Both sides then round o to bf16 once,
    so they may land one bf16 ulp apart on a few elements, never more. Keeping p in f32
    instead moves a third of o's elements."""
    q, k, v = _qkv(b, tq, tk, h, d, seed=7)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    if block:
        o_jax, _ = jax_pallas.flash_block_fwd(jq, jk, jv, causal=causal, interpret=True)
    else:
        o_jax = jax_pallas.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    o, _ = fa.flash_attention_fwd(*(x.to(torch.bfloat16) for x in _torch(q, k, v)), causal=causal)
    assert o.dtype == torch.bfloat16
    got = o.float().numpy()
    ref = np.asarray(o_jax.astype(jnp.float32))
    diff = np.abs(got - ref)
    moved, worst, ulp = float((diff > 0).mean()), float(diff.max()), 2.0**-7 * float(np.abs(ref).max())
    assert moved <= 0.01 and worst <= ulp, f"{moved:.2%} of o differs, by up to {worst:.3g} (one ulp {ulp:.3g})"


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


class _RecordingLibrary:
    """Stands in for the kernel library: records each C entry point called, and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.mark.parametrize(
    "dtype,d,entry,variant",
    [
        (torch.bfloat16, 64, "dtp_flash_fwd_wgmma", "wgmma"),
        (torch.bfloat16, 128, "dtp_flash_fwd_wgmma", "wgmma"),
        (torch.bfloat16, 32, "dtp_flash_fwd", "cuda_core"),
        (torch.float32, 64, "dtp_flash_fwd", "cuda_core"),
    ],
)
def test_fwd_launch_takes_the_entry_point_of_its_variant(monkeypatch, dtype, d, entry, variant):
    """K1's launch goes to the C entry point that ``kernel_variant`` names, with the LM's
    q, k, v views of its fused qkv projection passed in place (their own pointers and
    strides), and counts under ``("fwd", variant)``. The library and the stream are
    stand-ins: nothing is launched."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    qkv = torch.zeros(2, 100, 3, 4, d, dtype=dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    fa.reset_launches()
    o, lse = fa._launch_kernel(q, k, v, True, 100)
    assert [name for name, _ in lib.calls] == [entry]
    args = lib.calls[0][1]
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[11:20] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    assert len(args) == len(_build.ARGTYPES[entry])
    assert o.shape == q.shape and lse.shape == (2, 4, 100)
    assert fa.launches["fwd"] == fa.launches_by_variant[("fwd", variant)] == 1
    fa.reset_launches()


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
