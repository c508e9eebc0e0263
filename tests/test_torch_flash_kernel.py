"""The CUDA flash-attention forward kernels (the tensor-core variant in
``distributed_training_pytorch_tpu_torch/csrc/flash_fwd_wgmma.cu`` for bf16 at D 64/128,
the CUDA-core variant in ``csrc/flash_fwd.cu`` otherwise) against their plain PyTorch
version, on the card.

Every test here carries the ``cuda`` marker and skips without a card: the kernels have no
CPU mode. This file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_flash_kernel.py -m cuda -q
"""

import pytest
import torch

from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CASES = [
    # b, tq, tk, h, d, causal, valid_len, dtype
    (2, 197, 197, 3, 64, False, None, torch.float32),
    (2, 1000, 1000, 2, 128, True, None, torch.float32),
    (1, 130, 130, 4, 8, True, None, torch.bfloat16),
    (2, 197, 197, 2, 32, False, 150, torch.bfloat16),
    (1, 96, 40, 2, 16, True, None, torch.float32),
    (1, 1024, 1024, 12, 64, True, None, torch.bfloat16),
    # the wgmma variant: ragged causal T at D 64 and 128, valid_len at D 128, Tq != Tk
    # causal and not, T below one 64-row TMA box, both below a box with B = H = 1, and the
    # served (B=8) and training (B=64) shapes
    (2, 1000, 1000, 2, 64, True, None, torch.bfloat16),
    (2, 1000, 1000, 2, 128, True, None, torch.bfloat16),
    (2, 197, 197, 2, 128, False, 100, torch.bfloat16),
    (1, 300, 130, 2, 64, True, None, torch.bfloat16),
    (1, 300, 130, 2, 128, False, None, torch.bfloat16),
    (1, 130, 300, 2, 128, True, None, torch.bfloat16),
    (1, 96, 1000, 2, 64, False, None, torch.bfloat16),
    (3, 40, 40, 2, 64, True, None, torch.bfloat16),
    (1, 17, 50, 1, 128, False, None, torch.bfloat16),
    (8, 1024, 1024, 12, 64, True, None, torch.bfloat16),
    (64, 1024, 1024, 12, 64, True, None, torch.bfloat16),
    # ViT-B/16: T=197 (3 tiles and a 5-row tail), and 197 valid of 256 (pad_seq_to=256)
    (16, 197, 197, 12, 64, False, None, torch.bfloat16),
    (16, 256, 256, 12, 64, False, 197, torch.bfloat16),
]


def _close(o, lse, o_ref, lse_ref):
    # f32: both sum in f32, in other orders. bf16: the same f32 softmax statistics on the
    # same bf16 inputs, p rounded to bf16 before P V on each side (against the running max
    # in the kernels, the final one in the plain version, so it may round one ulp apart),
    # then one rounding of o to bf16 each side (2^-7 relative). lse is f32 on both sides.
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    tol = 1e-4 if o.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal,valid_len,dtype", CASES)
def test_kernel_matches_plain(cuda_device, b, tq, tk, h, d, causal, valid_len, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn(b, tq, h, d, device=cuda_device, generator=gen).to(dtype)
    k = torch.randn(b, tk, h, d, device=cuda_device, generator=gen).to(dtype)
    v = torch.randn(b, tk, h, d, device=cuda_device, generator=gen).to(dtype)
    variant = fa.kernel_variant(dtype, d)
    before = fa.launches_by_variant[("fwd", variant)]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)
    torch.cuda.synchronize()
    assert fa.launches_by_variant[("fwd", variant)] == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
    _close(o, lse, o_ref, lse_ref)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(1, 8, 2, 24, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, q, q)
    d = torch.zeros(1, 8, 2, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(d, d, d)
    h = torch.zeros(1, 8, 2, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16 on the flash-attention kernels"):
        fa.flash_attention_fwd(h, h, h)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_fwd_reads_qkv_views_in_place(cuda_device, d):
    """bf16 q/k/v views into one [B, T, 3, H, D] projection, as the LM makes them: TMA
    reads them as they are, and o equals that of contiguous copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    qkv = torch.randn(2, 1000, 3, 4, d, device=cuda_device, generator=gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert all(fa.tma_operand(x) is x for x in (q, k, v))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o_copy, lse_copy = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o_copy) and torch.equal(lse, lse_copy)
    _close(o, lse, *fa.flash_attention_plain(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"), (torch.float32, "cuda_core")])
def test_fwd_variant_counter_shows_the_path_taken(cuda_device, dtype, variant):
    """bf16 at D=64 runs the wgmma forward, f32 the CUDA-core forward; each launch counts
    once under ``fwd`` and once under ``("fwd", variant)``."""
    q = torch.randn(1, 128, 2, 64, device=cuda_device).to(dtype)
    fa.reset_launches()
    fa.flash_attention_fwd(q, q, q, causal=True)
    torch.cuda.synchronize()
    other = "cuda_core" if variant == "wgmma" else "wgmma"
    assert fa.launches == {"fwd": 1, "bwd_dq": 0, "bwd_dkv": 0}
    assert fa.launches_by_variant[("fwd", variant)] == 1
    assert fa.launches_by_variant[("fwd", other)] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid_len", [(197, None), (256, 197)])
def test_wgmma_fwd_reads_vit_qkv_views_in_place(cuda_device, t, valid_len):
    """ViT-B/16's attention as the model makes it: q, k, v views of a fused [B, T, 3, 12, 64]
    projection, non-causal, read in place by TMA."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    qkv = torch.randn(4, t, 3, 12, 64, device=cuda_device, generator=gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert all(fa.tma_operand(x) is x for x in (q, k, v))
    before = fa.launches_by_variant[("fwd", "wgmma")]
    o, lse = fa.flash_attention_fwd(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert fa.launches_by_variant[("fwd", "wgmma")] == before + 1
    _close(o, lse, *fa.flash_attention_plain(q, k, v, valid_len=valid_len))
