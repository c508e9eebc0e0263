"""The port's flash-attention backward (``distributed_training_pytorch_tpu_torch/ops/
flash_attention.py``: ``flash_attention_bwd``, its plain version, and the autograd path of
``flash_attention``) held against the JAX package's Pallas backward kernels.

On the CPU the port runs its plain version; the JAX kernels run in the Pallas interpreter,
as ``tests/test_pallas.py`` runs them. Inputs and cotangents come from numpy with a seed.
Tolerance: f32 atol 2e-4, the bound ``tests/test_pallas.py`` holds the JAX kernel's
gradients to (the two sum in other orders, over up to 256 keys). The CUDA kernels are held
against the plain version on the card by ``tests/test_torch_flash_backward_kernel.py``.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops import pallas as jax_pallas
from distributed_training_pytorch_tpu_torch.ops import _build
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa

ATOL = 2e-4


def _inputs(b, tq, tk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h, d).astype(np.float32)
    v = rng.randn(b, tk, h, d).astype(np.float32)
    do = (0.1 * rng.randn(b, tq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, valid_len):
    def loss(q, k, v):
        o = jax_pallas.flash_attention(q, k, v, causal=causal, valid_len=valid_len, interpret=True)
        return jnp.sum(o * do)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


CASES = [
    # b, t, h, d, causal, valid_len: tests/test_pallas.py's cases, then valid_len
    (2, 197, 3, 64, False, None),
    (1, 256, 2, 32, False, None),
    (2, 100, 2, 16, True, None),
    (1, 130, 4, 64, True, None),
    (2, 197, 2, 16, False, 150),
    (1, 130, 4, 8, False, 64),
]


@pytest.mark.parametrize("b,t,h,d,causal,valid_len", CASES)
def test_backward_matches_jax_grad(b, t, h, d, causal, valid_len):
    q, k, v, do = _inputs(b, t, t, h, d, seed=1)
    ref = _jax_grads(q, k, v, do, causal, valid_len)

    # The autograd path: flash_attention's backward, driven by torch.
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal, valid_len=valid_len)
    o.backward(torch.from_numpy(do))
    # The lower function, on the forward's own (o, lse).
    o2, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal, valid_len=valid_len)
    lower = fa.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), o2, lse, torch.from_numpy(do),
        causal=causal, valid_len=valid_len,
    )
    for name, r, g_auto, g_low in zip("qkv", ref, (qt.grad, kt.grad, vt.grad), lower, strict=True):
        np.testing.assert_allclose(g_auto.numpy(), np.asarray(r), atol=ATOL, err_msg=f"autograd d{name}")
        np.testing.assert_allclose(g_low.numpy(), np.asarray(r), atol=ATOL, err_msg=f"lower d{name}")


@pytest.mark.parametrize("t,causal,valid_len", [(130, True, None), (197, False, 150), (64, False, None)])
def test_backward_matches_autograd_through_plain(t, causal, valid_len):
    q, k, v, do = _inputs(2, t, t, 2, 16, seed=2)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, _ = fa.flash_attention_plain(*leaves, causal=causal, valid_len=valid_len)
    o.backward(torch.from_numpy(do))
    o2, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal=causal, valid_len=valid_len)
    grads = fa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v)), o2, lse, torch.from_numpy(do),
        causal=causal, valid_len=valid_len,
    )
    for name, leaf, g in zip("qkv", leaves, grads, strict=True):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize(
    "tq,tk,d,causal",
    [(50, 130, 8, False), (96, 40, 16, True), (130, 70, 16, True), (70, 130, 32, True)],
)
def test_unequal_tq_tk_with_external_stats_matches_jax_block_bwd(tq, tk, d, causal):
    q, k, v, do = _inputs(2, tq, tk, 2, d, seed=3)
    _, lse_blk = jax_pallas.flash_block_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True
    )
    # Global statistics of a q shard that saw more keys than this block: a larger lse,
    # and a delta from elsewhere. Both sides take the same arrays.
    rng = np.random.RandomState(4)
    lse = (np.asarray(lse_blk) + 0.5).astype(np.float32)
    delta = (0.1 * rng.randn(2, 2, tq)).astype(np.float32)
    ref = jax_pallas.flash_block_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do), jnp.asarray(lse),
        jnp.asarray(delta), causal=causal, interpret=True,
    )
    o_unused = torch.zeros(2, tq, 2, d)
    grads = fa.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), o_unused, torch.from_numpy(lse), torch.from_numpy(do),
        causal=causal, delta=torch.from_numpy(delta),
    )
    for name, r, g in zip("qkv", ref, grads, strict=True):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, err_msg=f"d{name}")


def test_bf16_rounds_p_and_ds_like_the_jax_kernels():
    """In bf16 the plain backward rounds ds (and p, for dv) to bf16 before its products,
    as the JAX kernels' ``.astype`` does: it agrees with the f32 backward to bf16 accuracy
    and is not the f32 result rounded once."""
    q, k, v, do = _inputs(1, 64, 64, 2, 16, seed=5)
    f32 = [torch.from_numpy(x) for x in (q, k, v, do)]
    bf = [x.to(torch.bfloat16) for x in f32]
    o, lse = fa.flash_attention_fwd(*bf[:3], causal=True)
    g_bf = fa.flash_attention_bwd_plain(*bf[:3], o, lse, bf[3], causal=True)
    o32, lse32 = fa.flash_attention_fwd(*(x.float() for x in bf[:3]), causal=True)
    g_32 = fa.flash_attention_bwd_plain(*(x.float() for x in bf[:3]), o32, lse32, bf[3].float(), causal=True)
    for g, r in zip(g_bf, g_32, strict=True):
        assert g.dtype == torch.bfloat16
        scale = r.abs().max().item()
        assert (g.float() - r).abs().max().item() <= 2e-2 * scale


def test_bwd_guards_raise():
    q = torch.zeros(1, 8, 2, 8)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, q, q, q, lse[:, :, :4], q)
    with pytest.raises(ValueError, match="delta"):
        fa.flash_attention_bwd(q, q, q, q, lse, q, delta=lse.double())
    with pytest.raises(ValueError, match="do"):
        fa.flash_attention_bwd(q, q, q, q, lse, q[:, :4])


def test_cpu_backward_never_launches_a_kernel():
    fa.reset_launches()
    q, k, v, do = _inputs(1, 40, 40, 2, 8, seed=6)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, causal=True).backward(torch.from_numpy(do))
    assert fa.launches == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert all(leaf.grad is not None for leaf in leaves)


@pytest.mark.parametrize(
    "dtype,d,variant",
    [
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 8, "cuda_core"),
        (torch.bfloat16, 16, "cuda_core"),
        (torch.bfloat16, 32, "cuda_core"),
        (torch.float32, 8, "cuda_core"),
        (torch.float32, 64, "cuda_core"),
        (torch.float32, 128, "cuda_core"),
    ],
)
def test_bwd_variant_is_chosen_by_dtype_and_head_dim(dtype, d, variant):
    """One rule for the backward (K2/K3) and the forward (K1): bf16 at D 64/128 takes the
    wgmma kernels; f32 (TF32 would miss its parity bound) and bf16 at D 8/16/32 take the
    CUDA-core kernels. Each kernel's launches are counted under that variant."""
    assert fa.kernel_variant(dtype, d) == variant
    assert all((name, variant) in fa.launches_by_variant for name in ("fwd", "bwd_dq", "bwd_dkv"))


def _unaligned_base():
    return torch.zeros(2, 10, 4, 72, dtype=torch.bfloat16)[..., 1:65]  # base 2 bytes off 16


def _h_stride_68():
    return torch.zeros(2, 10, 3, 68, dtype=torch.bfloat16)[..., :64]  # h stride 68 elements


def _broadcast_t():
    return torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16).expand(2, 10, 4, 64)  # t stride 0


def _qkv_view():
    return torch.zeros(2, 10, 3, 4, 64, dtype=torch.bfloat16)[:, :, 1]  # t stride 3 H D, 768 bytes in


def _odd_stride_on_size_one():
    return torch.zeros(1, 10, 1, 64, dtype=torch.bfloat16).as_strided((1, 10, 1, 64), (3, 64, 5, 1))


@pytest.mark.parametrize(
    "make,in_place",
    [
        (lambda: torch.zeros(2, 10, 4, 64, dtype=torch.bfloat16), True),
        (_qkv_view, True),
        (_odd_stride_on_size_one, True),
        (_unaligned_base, False),
        (_h_stride_68, False),
        (_broadcast_t, False),
    ],
)
def test_tma_operand_reads_aligned_views_in_place_and_copies_the_rest(make, in_place):
    """TMA needs a 16-byte-aligned base and b, t, h strides that are positive multiples of
    8 elements (a size-1 dimension's stride is never used): such a view goes to the wgmma
    kernels as it is, any other as a contiguous copy of the same values."""
    x = make()
    got = fa.tma_operand(x)
    assert (got is x) == in_place
    if not in_place:
        assert got.is_contiguous() and torch.equal(got, x)


_C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
}


def _c_entry_points():
    """Each ``extern "C" int`` function of ``csrc/*.cu`` with its parameter types, parsed
    from the sources (a parameter is its type and then its name)."""
    found = {}
    for src in _build.SOURCES:
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = [" ".join(p.split()[:-1]).replace(" *", "*") for p in params.split(",")]
            found[name] = [_C_TYPES[t] for t in types]
    return found


def test_every_c_entry_point_has_ctypes_argtypes():
    assert sorted(_c_entry_points()) == sorted(_build.ARGTYPES)


@pytest.mark.parametrize("name", sorted(_build.ARGTYPES))
def test_ctypes_argtypes_match_the_c_signature(name):
    """ctypes converts each argument by these types alone: a count or type that differs
    from the C signature would pass wrong values to the card without an error."""
    assert list(_build.ARGTYPES[name]) == _c_entry_points()[name]
