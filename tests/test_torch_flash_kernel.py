"""The CUDA flash-attention kernel (``distributed_training_pytorch_tpu_torch/csrc/
flash_fwd.cu``) against its plain PyTorch version, on the card.

Every test here carries the ``cuda`` marker and skips without a card: the kernel has no
CPU mode. This file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest tests/test_torch_flash_kernel.py -m cuda -q
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
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d,causal,valid_len,dtype", CASES)
def test_kernel_matches_plain(cuda_device, b, tq, tk, h, d, causal, valid_len, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn(b, tq, h, d, device=cuda_device, generator=gen).to(dtype)
    k = torch.randn(b, tk, h, d, device=cuda_device, generator=gen).to(dtype)
    v = torch.randn(b, tk, h, d, device=cuda_device, generator=gen).to(dtype)
    before = fa.launches["fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, valid_len=valid_len)
    torch.cuda.synchronize()
    assert fa.launches["fwd"] == before + 1
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, causal=causal, valid_len=valid_len)
    # f32: both sum in f32, in other orders. bf16: the same f32 arithmetic, then one
    # rounding of o to bf16 each side, which may land one bf16 ulp apart (2^-7 relative).
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.zeros(1, 8, 2, 24, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd(q, q, q)
    h = torch.zeros(1, 8, 2, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(h, h, h)
