"""The CUDA flash-attention backward kernels (dq, and dk/dv: the tensor-core variant in
``distributed_training_pytorch_tpu_torch/csrc/flash_bwd_wgmma.cu`` for bf16 at D 64/128,
the CUDA-core variant in ``csrc/flash_bwd.cu`` otherwise) against their plain PyTorch
version, and the autograd path of the port's LM through them, on the card.

Every test here carries the ``cuda`` marker and skips without a card: the kernels have no
CPU mode. This file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_flash_backward_kernel.py -m cuda -q
"""

import pytest
import torch

from distributed_training_pytorch_tpu_torch.models import LMTiny
from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash backward kernels have no CPU mode")
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
    (1, 50, 130, 2, 64, False, None, torch.float32),
    (1, 1024, 1024, 12, 64, True, None, torch.bfloat16),
    # the wgmma variant: ragged causal T at D 64 and 128, valid_len at D 128
    (2, 1000, 1000, 2, 64, True, None, torch.bfloat16),
    (2, 1000, 1000, 2, 128, True, None, torch.bfloat16),
    (2, 197, 197, 2, 128, False, 100, torch.bfloat16),
    (3, 40, 40, 2, 64, True, None, torch.bfloat16),  # T below one 64-row TMA box
    # ViT-B/16: T=197 (3 tiles and a 5-row tail), and 197 valid of 256 (pad_seq_to=256)
    (16, 197, 197, 12, 64, False, None, torch.bfloat16),
    (16, 256, 256, 12, 64, False, 197, torch.bfloat16),
]


def _close(g, ref, dtype):
    # f32: both sides sum in f32, in other orders. bf16: the same f32 arithmetic on the
    # same bf16 inputs, but ds and p are rounded to bf16 before their products and may
    # round one ulp apart (2^-7 relative), and each grad is rounded to bf16 at the end.
    if dtype == torch.float32:
        torch.testing.assert_close(g, ref, atol=2e-4, rtol=0)
    else:
        bound = 2e-2 * ref.float().abs().max().item()
        assert (g.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal,valid_len,dtype", CASES)
def test_bwd_kernels_match_plain(cuda_device, b, tq, tk, h, d, causal, valid_len, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q = torch.randn(b, tq, h, d, device=cuda_device, generator=gen).to(dtype)
    k = torch.randn(b, tk, h, d, device=cuda_device, generator=gen).to(dtype)
    v = torch.randn(b, tk, h, d, device=cuda_device, generator=gen).to(dtype)
    do = torch.randn(b, tq, h, d, device=cuda_device, generator=gen).to(dtype)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
    before = dict(fa.launches)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, valid_len=valid_len)
    torch.cuda.synchronize()
    assert fa.launches["bwd_dq"] == before["bwd_dq"] + 1
    assert fa.launches["bwd_dkv"] == before["bwd_dkv"] + 1
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, valid_len=valid_len)
    for g, r in zip(grads, refs, strict=True):
        assert g.dtype == dtype and g.shape == r.shape
        assert torch.isfinite(g.float()).all()
        _close(g, r, dtype)
    if valid_len is not None:  # keys past valid_len get no gradient
        assert grads[1][:, valid_len:].abs().max().item() == 0.0
        assert grads[2][:, valid_len:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_bwd_kernels_read_strided_views(cuda_device):
    """q/k/v as views into one [B, T, 3, H, D] projection, as the LM makes them."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    qkv = torch.randn(2, 150, 3, 4, 32, device=cuda_device, generator=gen)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(2, 150, 4, 32, device=cuda_device, generator=gen)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    refs = fa.flash_attention_bwd_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do, causal=True
    )
    for g, r in zip(grads, refs, strict=True):
        _close(g, r, torch.float32)


@pytest.mark.cuda
def test_autograd_through_the_kernels_matches_plain_attention(cuda_device):
    """The LM's gradients through the flash kernels equal those through plain attention.
    Before flash_attention was an autograd.Function, the kernel's output had no grad_fn,
    so qkv and ln1 got no gradient at all: qkv.weight.grad was None."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    flash = LMTiny(device=cuda_device, generator=gen)
    plain = LMTiny(device=cuda_device, attention_impl="plain", generator=gen)
    plain.load_state_dict(flash.state_dict())
    tokens = torch.randint(0, 256, (2, 100), device=cuda_device, generator=gen)
    fa.reset_launches()
    for model in (flash, plain):
        logits = model(tokens)
        torch.nn.functional.cross_entropy(logits.flatten(0, 1), tokens.roll(-1, 1).flatten()).backward()
    torch.cuda.synchronize()
    assert fa.launches == {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}  # 2 layers, flash model only
    grads = dict(plain.named_parameters())
    for name, p in flash.named_parameters():
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, grads[name].grad, atol=1e-5, rtol=1e-4, msg=name)
    assert flash.blocks[0].qkv.weight.grad.abs().max().item() > 0


@pytest.mark.cuda
def test_bwd_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(1, 8, 2, 24, device=cuda_device)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    d = torch.zeros(1, 8, 2, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_bwd(d, d, d, d, lse, d)
    h = torch.zeros(1, 8, 2, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16 on the flash-attention kernels"):
        fa.flash_attention_bwd(h, h, h, h, lse, h)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tq,tk,d,causal", [(300, 130, 64, True), (130, 300, 128, False), (96, 1000, 64, True), (17, 50, 128, False)]
)
def test_wgmma_bwd_with_unequal_tq_tk_and_external_stats(cuda_device, tq, tk, d, causal):
    """Tq != Tk with a q shard's global lse and delta, as ring attention's blocks pass them."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    q, do = (torch.randn(1, tq, 2, d, device=cuda_device, generator=gen).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, tk, 2, d, device=cuda_device, generator=gen).to(torch.bfloat16) for _ in range(2))
    _, lse = fa.flash_attention_plain(q, k, v, causal=causal)
    lse = lse + 0.5
    delta = 0.1 * torch.randn(1, 2, tq, device=cuda_device, generator=gen)
    grads = fa.flash_attention_bwd(q, k, v, None, lse, do, causal=causal, delta=delta)
    refs = fa.flash_attention_bwd_plain(q, k, v, None, lse, do, causal=causal, delta=delta)
    for g, r in zip(grads, refs, strict=True):
        assert torch.isfinite(g.float()).all()
        _close(g, r, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_bwd_reads_qkv_views_in_place(cuda_device, d):
    """bf16 q/k/v views into one [B, T, 3, H, D] projection: TMA reads them as they are."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    qkv = torch.randn(2, 1000, 3, 4, d, device=cuda_device, generator=gen).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert all(fa.tma_operand(x) is x for x in (q, k, v))
    do = torch.randn(2, 1000, 4, d, device=cuda_device, generator=gen).to(torch.bfloat16)
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    for g, r in zip(grads, refs, strict=True):
        _close(g, r, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"), (torch.float32, "cuda_core")])
def test_variant_counter_shows_the_path_taken(cuda_device, dtype, variant):
    """bf16 at D=64 runs the wgmma kernels, f32 the CUDA-core kernels; each launch counts
    once under its kernel's name and once under (name, variant)."""
    q = torch.randn(1, 128, 2, 64, device=cuda_device).to(dtype)
    _, lse = fa.flash_attention_plain(q, q, q, causal=True)
    fa.reset_launches()
    fa.flash_attention_bwd(q, q, q, q, lse, q, causal=True)
    torch.cuda.synchronize()
    other = "cuda_core" if variant == "wgmma" else "wgmma"
    assert fa.launches == {"fwd": 0, "bwd_dq": 1, "bwd_dkv": 1}
    assert fa.launches_by_variant[("bwd_dq", variant)] == fa.launches_by_variant[("bwd_dkv", variant)] == 1
    assert fa.launches_by_variant[("bwd_dq", other)] == fa.launches_by_variant[("bwd_dkv", other)] == 0
