"""The CUDA fused 1x1-conv kernels (``distributed_training_pytorch_tpu_torch/csrc/
conv1x1_wgmma.cu`` for bf16 with 64-channel multiples, ``csrc/conv1x1_bn_act.cu`` for the
rest) and the backward's one-pass dz (``csrc/conv1x1_bwd_dz.cu``) against their plain
PyTorch versions, on the card, forward and backward.

Every test here carries the ``cuda`` marker and skips without a card: the kernel has no
CPU mode. This file imports neither JAX nor the JAX package, so it runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_conv1x1_kernel.py -m cuda -q

Tolerances: f32 forward atol 1e-5 (f32 sums over at most 768 terms of O(1) products in
another order), f32 gradients atol 2e-4; bf16 within 2e-2 of the largest magnitude (the
same f32 sums, then one rounding to bf16 on each side, which may land one bf16 ulp,
2^-7 relative, apart); the dz pass bit-equal to its plain version (one f32 multiply,
rounded once, on both sides).
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
    """f32 within ``atol``; bf16 within 2e-2 of ref's largest magnitude."""
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
    x = torch.zeros(4, 8, device=cuda_device, dtype=torch.float64)
    w = torch.zeros(4, 8, device=cuda_device, dtype=torch.float64)
    ones = torch.ones(4, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.conv1x1_bn_act(x, w, ones, ones)
    with pytest.raises(NotImplementedError, match="float16 on K4"):  # no fp16 variant: refused by name
        k4.conv1x1_bn_act(x.half(), w.half(), ones, ones)


def _wgmma_count():
    return k4.launches_by_variant[("conv1x1_bn_act", "wgmma")]


# The wgmma variant: ragged N (a prime near 1000, and below one 64-row tile), Cin 64/128/256
# by Cout 64/192/256/512, every epilogue, scales with zeros.
WGMMA_CASES = [
    (997 if i % 2 else 37, cin, cout, (None, "relu", "gelu")[i % 3])
    for i, (cin, cout) in enumerate((cin, cout) for cin in (64, 128, 256) for cout in (64, 192, 256, 512))
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cin,cout,act", WGMMA_CASES)
def test_wgmma_variant_matches_plain(cuda_device, rows, cin, cout, act):
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x, w, scale, bias = _inputs(gen, rows, cin, cout, torch.bfloat16, cuda_device, zero_scale=True)
    assert k4.conv1x1_variant(x, cout) == "wgmma"
    before = _wgmma_count()
    y = k4.conv1x1_bn_act(x, w, scale, bias, act=act)
    torch.cuda.synchronize()
    assert _wgmma_count() == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (rows, cout)
    _close(y, k4.conv1x1_bn_act_plain(x, w, scale, bias, act=act), torch.bfloat16, None)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,size,in_place", [(3, 56, True), (3, 57, False), (2, 140, False)])
def test_wgmma_variant_on_stride2_views(cuda_device, batch, size, in_place):
    """The stride-2 shortcut's ``x[:, :, ::2, ::2]`` of a channels-last activation: read in
    place as whole image rows where its (b, h) flatten (an even H, ResNet-50's case), else
    copied first; the same values either way."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    full = torch.randn(batch, 64, size, size, device=cuda_device, generator=gen).to(torch.bfloat16)
    x = full.contiguous(memory_format=torch.channels_last)[:, :, ::2, ::2].permute(0, 2, 3, 1)
    assert (k4.tma_rows(x) is not None) == in_place
    w = (torch.randn(256, 64, device=cuda_device, generator=gen) / 8).to(torch.bfloat16)
    scale = torch.rand(256, device=cuda_device, generator=gen) + 0.5
    bias = torch.randn(256, device=cuda_device, generator=gen)
    before = _wgmma_count()
    y = k4.conv1x1_bn_act(x, w, scale, bias, act="relu")
    torch.cuda.synchronize()
    assert _wgmma_count() == before + 1 and y.shape == (*x.shape[:3], 256)
    _close(y, k4.conv1x1_bn_act_plain(x, w, scale, bias, act="relu"), torch.bfloat16, None)


@pytest.mark.cuda
def test_bf16_to_f32_takes_the_cuda_core_variant(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x, w, scale, bias = _inputs(gen, 997, 64, 256, torch.bfloat16, cuda_device, zero_scale=True)
    before = k4.launches_by_variant[("conv1x1_bn_act", "cuda_cores")]
    y = k4.conv1x1_bn_act(x, w, scale, bias, act="gelu", out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert k4.launches_by_variant[("conv1x1_bn_act", "cuda_cores")] == before + 1 and y.dtype == torch.float32
    _close(y, k4.conv1x1_bn_act_plain(x, w, scale, bias, act="gelu", out_dtype=torch.float32), torch.float32, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cout,g_dtype,dz_dtype,act", [
    (802816, 256, torch.bfloat16, torch.bfloat16, None),  # a ResNet-50 expand's gradient
    (200704, 512, torch.bfloat16, torch.bfloat16, "relu"),
    (997, 10, torch.bfloat16, torch.bfloat16, "relu"),  # Cout off the 8-element vectors
    (6275, 64, torch.float32, torch.bfloat16, "relu"),
    (6275, 96, torch.float32, torch.float32, None),
])
def test_bwd_dz_is_bit_equal_to_plain(cuda_device, rows, cout, g_dtype, dz_dtype, act):
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    g = torch.randn(rows, cout, device=cuda_device, generator=gen).to(g_dtype)
    y = torch.randn(rows, cout, device=cuda_device, generator=gen).to(g_dtype)
    scale = torch.rand(cout, device=cuda_device, generator=gen) + 0.5
    scale[::3] = 0.0
    before = k4.launches["conv1x1_bwd_dz"]
    dz = k4.conv1x1_bwd_dz(g, y, scale, act=act, out_dtype=dz_dtype)
    torch.cuda.synchronize()
    assert k4.launches["conv1x1_bwd_dz"] == before + 1
    ref = k4.conv1x1_bwd_dz_plain(g, y, scale, act=act, out_dtype=dz_dtype)
    bits = torch.int16 if dz_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(dz.view(bits), ref.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu"])
def test_autograd_on_the_resnet_route_matches_plain(cuda_device, act):
    """bf16, the stride-2 view, 64 -> 128, ``affine_grads=False``: the wgmma forward and the
    one-pass dz, against autograd through the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    full = torch.randn(4, 64, 30, 30, device=cuda_device, generator=gen).to(torch.bfloat16)
    full = full.contiguous(memory_format=torch.channels_last)
    _, w, scale, bias = _inputs(gen, 1, 64, 128, torch.bfloat16, cuda_device, zero_scale=True)
    g = torch.randn(4, 15, 15, 128, device=cuda_device, generator=gen).to(torch.bfloat16)
    grads = []
    before = (_wgmma_count(), k4.launches["conv1x1_bwd_dz"])
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (full, w)]
        x = leaves[0][:, :, ::2, ::2].permute(0, 2, 3, 1)
        if use_kernel:
            y = k4.conv1x1_bn_act_diff(x, leaves[1], scale, bias, act=act, affine_grads=False)
        else:
            y = k4.conv1x1_bn_act_plain(x, leaves[1], scale, bias, act=act)
        y.backward(g)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert (_wgmma_count(), k4.launches["conv1x1_bwd_dz"]) == (before[0] + 1, before[1] + 1)
    for got, ref in zip(*grads, strict=True):
        _close(got, ref, torch.bfloat16, None)


@pytest.mark.cuda
def test_weight_gradient_is_f32_sums_rounded_once(cuda_device):
    """F5: dw = dz^T x over ResNet-50's 802,816 pixels (the 256 -> 64 reduce at batch 256)
    is the reference's f32 sums rounded once to bf16 (``pallas.py::_conv1x1_bwd``'s
    ``preferred_element_type=f32`` dot, then ``astype``). A bf16 ``torch.matmul`` there may
    reduce cuBLAS's split-K partials in bf16, which moved 42 % of dw's elements off. Kernel
    and reference sum in other orders in f32, so an element may round one ulp apart: at most
    5 % may differ."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    rows, cin, cout = 256 * 56 * 56, 256, 64
    x = torch.randn(rows, cin, device=cuda_device, generator=gen).to(torch.bfloat16)
    w = (torch.randn(cout, cin, device=cuda_device, generator=gen) / 16).to(torch.bfloat16).requires_grad_()
    g = (torch.randn(rows, cout, device=cuda_device, generator=gen) * 0.01).to(torch.bfloat16)
    ones, zeros = torch.ones(cout, device=cuda_device), torch.zeros(cout, device=cuda_device)
    k4.conv1x1_bn_act_diff(x, w, ones, zeros, act=None, affine_grads=False).backward(g)
    ref = (g.T.float() @ x.float()).to(torch.bfloat16)  # dz = g * 1: f32 sums, rounded once
    differ = (w.grad != ref).float().mean().item()
    assert differ <= 0.05, f"{differ:.2%} of dw's elements differ from the f32 sums rounded once"


# ConvNeXt-L's four expand Dense + GELU shapes (Cin -> 4 Cin), bf16, scale 1 and an f32
# bias, with row counts off the tiles (a micro-batch of 64 gives 200,704, 50,176, 12,544
# and 3,136 rows): stages 1-2 on the wgmma variant, 3-4 (Cin above WGMMA_MAX_CIN) on the
# CUDA cores.
CONVNEXT_CASES = [(6275, 192, "wgmma"), (3137, 384, "wgmma"), (1569, 768, "cuda_cores"), (997, 1536, "cuda_cores")]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cin,variant", CONVNEXT_CASES)
def test_convnext_expand_shapes_match_plain(cuda_device, rows, cin, variant):
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    x, w, _, bias = _inputs(gen, rows, cin, 4 * cin, torch.bfloat16, cuda_device)
    ones = torch.ones(4 * cin, device=cuda_device)
    assert k4.conv1x1_variant(x, 4 * cin) == variant
    before = k4.launches_by_variant[("conv1x1_bn_act", variant)]
    y = k4.conv1x1_bn_act(x, w, ones, bias, act="gelu")
    torch.cuda.synchronize()
    assert k4.launches_by_variant[("conv1x1_bn_act", variant)] == before + 1
    _close(y, k4.conv1x1_bn_act_plain(x, w, ones, bias, act="gelu"), torch.bfloat16, None)


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [192, 768])
def test_autograd_on_the_convnext_route_matches_plain(cuda_device, cin):
    """PallasDenseAct's route (gelu, ``affine_grads=True``, a constant unit scale) on both
    forward variants: the kernel forward and the plain-op backward against autograd through
    the plain version; bf16 gradients within 2e-2 of their largest magnitude."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x, w, _, bias = _inputs(gen, 997, cin, 4 * cin, torch.bfloat16, cuda_device)
    ones = torch.ones(4 * cin, device=cuda_device)
    g = torch.randn(997, 4 * cin, device=cuda_device, generator=gen).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    dz_before = k4.launches["conv1x1_bwd_dz"]
    k4.conv1x1_bn_act_diff(leaves[0], leaves[1], ones, leaves[2], act="gelu", affine_grads=True).backward(g)
    assert k4.launches["conv1x1_bwd_dz"] == dz_before  # gelu's backward keeps the plain ops
    refs = [t.clone().requires_grad_() for t in (x, w, bias)]
    k4.conv1x1_bn_act_plain(refs[0], refs[1], ones, refs[2], act="gelu").backward(g)
    for got, ref in zip(leaves, refs, strict=True):
        _close(got.grad, ref.grad, torch.bfloat16, None)
