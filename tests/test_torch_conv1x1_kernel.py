"""The CUDA fused 1x1-conv kernel (``distributed_training_pytorch_tpu_torch/csrc/
conv1x1_bn_act.cu``) against its plain PyTorch version, on the card, forward and backward.

Every test here carries the ``cuda`` marker and skips without a card: the kernel has no
CPU mode. This file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_conv1x1_kernel.py -m cuda -q

Tolerances: f32 forward atol 1e-5 (f32 sums over at most 768 terms of O(1) products in
another order), f32 gradients atol 2e-4; bf16 within 2e-2 of the largest magnitude (the
same f32 sums, then one rounding to bf16 on each side, which may land one bf16 ulp,
2^-7 relative, apart).
"""

import pytest
import torch

from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv1x1 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(gen, rows, cin, cout, dtype, device, zero_scale=False):
    x = torch.randn(rows, cin, device=device, generator=gen).to(dtype)
    w = (torch.randn(cout, cin, device=device, generator=gen) * cin**-0.5).to(dtype)
    scale = torch.rand(cout, device=device, generator=gen) + 0.5
    if zero_scale:
        scale[::3] = 0.0
    bias = torch.randn(cout, device=device, generator=gen)
    return x, w, scale, bias


def _close(got, ref, dtype, atol):
    err = (got.float() - ref.float()).abs().max().item()
    bound = atol if dtype == torch.float32 else 2e-2 * ref.float().abs().max().item()
    assert err <= bound, (err, bound)


CASES = [
    # rows, cin, cout, act, dtype
    (70, 24, 16, "relu", torch.float32),
    (6275, 64, 256, None, torch.float32),
    (6275, 256, 64, "gelu", torch.float32),
    (70, 24, 16, None, torch.bfloat16),
    (6275, 256, 128, "relu", torch.bfloat16),
    (6275, 768, 3072, "gelu", torch.bfloat16),
    (1001, 20, 10, "relu", torch.bfloat16),  # Cin, Cout not multiples of the tiles or 16 bytes
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cin,cout,act,dtype", CASES)
def test_kernel_matches_plain(cuda_device, rows, cin, cout, act, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x, w, scale, bias = _inputs(gen, rows, cin, cout, dtype, cuda_device, zero_scale=True)
    before = k4.launches["conv1x1_bn_act"]
    y = k4.conv1x1_bn_act(x, w, scale, bias, act=act)
    torch.cuda.synchronize()
    assert k4.launches["conv1x1_bn_act"] == before + 1
    assert y.dtype == dtype and y.shape == (rows, cout)
    _close(y, k4.conv1x1_bn_act_plain(x, w, scale, bias, act=act), dtype, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_channels_last_view_is_read_in_place(cuda_device, dtype):
    """The stride-2 projection's input: ``x[:, :, ::2, ::2]`` of a channels-last NCHW
    tensor, as an NHWC view."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    full = torch.randn(3, 64, 57, 57, device=cuda_device, generator=gen).to(dtype)
    full = full.contiguous(memory_format=torch.channels_last)
    x = full[:, :, ::2, ::2].permute(0, 2, 3, 1)
    assert not x.is_contiguous() and x.stride(-1) == 1
    w = (torch.randn(256, 64, device=cuda_device, generator=gen) / 8).to(dtype)
    ones, zeros = torch.ones(256, device=cuda_device), torch.zeros(256, device=cuda_device)
    y = k4.conv1x1_bn_act(x, w, ones, zeros)
    torch.cuda.synchronize()
    assert y.shape == (3, 29, 29, 256)
    _close(y, k4.conv1x1_bn_act_plain(x, w, ones, zeros), dtype, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "gelu"])
@pytest.mark.parametrize("affine_grads", [False, True])
def test_autograd_matches_autograd_through_plain(cuda_device, act, affine_grads):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x, w, scale, bias = _inputs(gen, 200, 64, 96, torch.float32, cuda_device)
    g = torch.randn(200, 96, device=cuda_device, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (x, w, scale, bias)]
    before = k4.launches["conv1x1_bn_act"]
    k4.conv1x1_bn_act_diff(*leaves, act=act, affine_grads=affine_grads).backward(g)
    assert k4.launches["conv1x1_bn_act"] == before + 1
    refs = [t.clone().requires_grad_() for t in (x, w, scale, bias)]
    k4.conv1x1_bn_act_plain(*refs, act=act).backward(g)
    for name, got, ref in zip(("x", "w", "scale", "bias"), leaves, refs, strict=True):
        if name in ("scale", "bias") and not affine_grads:
            assert torch.count_nonzero(got.grad) == 0, name
            continue
        _close(got.grad, ref.grad, torch.float32, 2e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device, dtype=torch.float16)
    w = torch.zeros(4, 8, device=cuda_device, dtype=torch.float16)
    ones = torch.ones(4, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.conv1x1_bn_act(x, w, ones, ones)
