"""The port's fused 1x1-conv function (``distributed_training_pytorch_tpu_torch/ops/
conv1x1.py``) against the JAX package's ``ops/pallas.py::conv1x1_bn_act`` (the Pallas
kernel in interpret mode, the JAX package's CPU mode) and its custom VJP
``conv1x1_bn_act_diff``, on the CPU: the port's wrapper takes its plain version for CPU
tensors. Inputs come from numpy with a seed; the port's ``w`` is the transpose of the JAX
function's (``[Cout, Cin]``, the torch layout).

Tolerances: f32 forward atol 1e-5 (``tests/test_pallas.py``'s bound: f32 sums over 24 to
64 terms in another order); bf16 forward within one bf16 ulp of the output (2^-7
relative; both sides sum the same bf16 products in f32 and round once); gradients atol
2e-4 (``tests/test_pallas.py``'s bound); bf16 gradients within 2e-2 of the largest
magnitude (dz, dx and dw are each rounded to bf16 once on each side, after f32 sums in
another order, so an element may land one bf16 ulp, 2^-7 relative, apart).

The wrapper's dispatch (which kernel, with which arguments) is checked here too, against
a stand-in for the kernel library: nothing is launched.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops.pallas import conv1x1_bn_act as jax_conv1x1
from distributed_training_pytorch_tpu.ops.pallas import conv1x1_bn_act_diff as jax_conv1x1_diff
from chip_smoke import RESNET_K4_SHAPES
from distributed_training_pytorch_tpu_torch.ops import _build
from distributed_training_pytorch_tpu_torch.ops import conv1x1 as k4


def _inputs(seed, lead, cin, cout, zero_scale=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, cin).astype(np.float32)
    w = (rng.randn(cin, cout) * 0.2).astype(np.float32)  # the JAX layout [Cin, Cout]
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    if zero_scale:
        scale[::3] = 0.0  # a zero-init BN gamma folds to a zero scale
    bias = rng.randn(cout).astype(np.float32)
    return x, w, scale, bias


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
@pytest.mark.parametrize("lead", [(2, 7, 5), (67,), (3, 5, 7, 1)])  # 70, 67 and 105 rows
def test_forward_f32_matches_the_pallas_kernel(act, lead):
    x, w, scale, bias = _inputs(0, lead, 24, 16, zero_scale=True)
    want = jax_conv1x1(x, w, scale, bias, act=act, relu=False, interpret=True, block_rows=32)
    got = k4.conv1x1_bn_act(_t(x), _t(w.T), _t(scale), _t(bias), act=act)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
def test_forward_bf16_matches_the_pallas_kernel(act):
    x, w, scale, bias = _inputs(1, (2, 9, 7), 64, 48)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax_conv1x1(xb, wb, scale, bias, act=act, relu=False, interpret=True).astype(jnp.float32))
    xt = _t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    wt = _t(np.asarray(wb.astype(jnp.float32)).T).to(torch.bfloat16)
    got = k4.conv1x1_bn_act(xt, wt, _t(scale), _t(bias), act=act)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=1e-6)
    # out_dtype: the f32 epilogue kept in f32.
    want32 = jax_conv1x1(xb, wb, scale, bias, act=act, relu=False, out_dtype=jnp.float32, interpret=True)
    got32 = k4.conv1x1_bn_act(xt, wt, _t(scale), _t(bias), act=act, out_dtype=torch.float32)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), atol=1e-5)


def test_strided_view_input_matches_the_subsampled_copy():
    """The projection shortcut's ``x[:, ::2, ::2]`` view of an NHWC batch."""
    x, w, scale, bias = _inputs(2, (2, 9, 9), 24, 16)
    want = jax_conv1x1(x[:, ::2, ::2], w, scale, bias, act=None, relu=False, interpret=True, block_rows=32)
    view = _t(x)[:, ::2, ::2]
    assert not view.is_contiguous()
    got = k4.conv1x1_bn_act(view, _t(w.T), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", [None, "relu", "gelu"])
@pytest.mark.parametrize("affine_grads", [True, False])
def test_gradients_match_the_custom_vjp(act, affine_grads):
    x, w, scale, bias = _inputs(3, (48,), 24, 16, zero_scale=True)
    g = np.random.RandomState(4).randn(48, 16).astype(np.float32)

    def f(x, w, scale, bias):
        y = jax_conv1x1_diff(
            x, w, scale, bias, act=act, relu=False, interpret=True, block_rows=16, affine_grads=affine_grads
        )
        return jnp.sum(y * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(x, w, scale, bias)
    leaves = [_t(a).requires_grad_() for a in (x, w.T, scale, bias)]
    y = k4.conv1x1_bn_act_diff(*leaves, act=act, affine_grads=affine_grads)
    y.backward(_t(g))
    for name, leaf, ref in zip(("x", "w", "scale", "bias"), leaves, want, strict=True):
        ref = np.asarray(ref).T if name == "w" else np.asarray(ref)
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=2e-4, err_msg=f"d{name} act={act}")
    if not affine_grads:
        assert not leaves[2].grad.any() and not leaves[3].grad.any()


def test_bad_act_and_layout_raise():
    x, w, scale, bias = _inputs(5, (10,), 8, 4)
    with pytest.raises(ValueError, match="act must be"):
        k4.conv1x1_bn_act(_t(x), _t(w.T), _t(scale), _t(bias), act="swish")
    with pytest.raises(ValueError, match="act must be"):
        k4.conv1x1_bn_act_diff(_t(x), _t(w.T), _t(scale), _t(bias), act="swish")
    with pytest.raises(ValueError, match=r"\[Cout, Cin\]"):
        k4.conv1x1_bn_act(_t(x), _t(w), _t(scale), _t(bias))


@pytest.mark.parametrize("act", [None, "relu"])
def test_gradients_match_the_custom_vjp_bf16_resnet_route(act):
    """ResNet's route in bf16 (``affine_grads=False``, Cin 64 -> Cout 128), whose dz is the
    one-pass :func:`conv1x1_bwd_dz` (its plain version here), against ``jax.grad`` of the
    Pallas kernel's custom VJP in interpret mode: within 2e-2 of each gradient's largest
    magnitude (see the module docstring)."""
    x, w, scale, bias = _inputs(6, (4, 5, 5), 64, 128, zero_scale=True)
    g = np.random.RandomState(7).randn(4, 5, 5, 128).astype(np.float32)
    xb, wb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))

    def f(x, w):
        y = jax_conv1x1_diff(x, w, scale, bias, act=act, relu=False, interpret=True, block_rows=32, affine_grads=False)
        return jnp.sum(y.astype(jnp.float32) * gb.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1))(xb, wb)
    to_t = lambda a: _t(np.asarray(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)  # noqa: E731
    leaves = [to_t(xb).requires_grad_(), to_t(wb).T.contiguous().requires_grad_()]
    y = k4.conv1x1_bn_act_diff(*leaves, _t(scale), _t(bias), act=act, affine_grads=False)
    assert y.dtype == torch.bfloat16
    y.backward(to_t(gb))
    for name, leaf, ref in zip(("x", "w"), leaves, want, strict=True):
        ref = np.asarray(ref.astype(jnp.float32))
        ref = ref.T if name == "w" else ref
        got = leaf.grad.float().numpy()
        assert leaf.grad.dtype == torch.bfloat16
        bound = 2e-2 * np.abs(ref).max()
        assert np.abs(got - ref).max() <= bound, (name, np.abs(got - ref).max(), bound)


@pytest.mark.parametrize("act,affine_grads,one_pass", [
    (None, False, True), ("relu", False, True), ("gelu", False, False), (None, True, False), ("relu", True, False),
])
def test_backward_takes_the_one_pass_dz_on_the_resnet_route_only(monkeypatch, act, affine_grads, one_pass):
    """The backward's elementwise part goes to :func:`conv1x1_bwd_dz` for act None or relu
    with ``affine_grads=False``; gelu and ``affine_grads=True`` keep the plain ops, which
    need the f32 gz. A dispatch by arguments: both give the same gradients here."""
    calls = []
    real = k4.conv1x1_bwd_dz
    monkeypatch.setattr(k4, "conv1x1_bwd_dz", lambda *a, **kw: calls.append(kw["act"]) or real(*a, **kw))
    x, w, scale, bias = _inputs(8, (40,), 24, 16, zero_scale=True)
    leaves = [_t(a).requires_grad_() for a in (x, w.T)]
    k4.conv1x1_bn_act_diff(*leaves, _t(scale), _t(bias), act=act, affine_grads=affine_grads).sum().backward()
    assert calls == ([act] if one_pass else [])


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("g_dtype,dz_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                                              (torch.float32, torch.float32)])
def test_bwd_dz_is_the_plain_three_passes_on_cpu(act, g_dtype, dz_dtype):
    """On CPU tensors :func:`conv1x1_bwd_dz` is its plain version: f32(g), masked by
    y > 0 for relu, times scale in f32, one rounding; what ``_conv1x1_bwd`` computes."""
    rng = np.random.RandomState(9)
    g, y = (torch.from_numpy(rng.randn(37, 12).astype(np.float32)).to(g_dtype) for _ in range(2))
    scale = torch.from_numpy(rng.rand(12).astype(np.float32))
    scale[::3] = 0.0
    got = k4.conv1x1_bwd_dz(g, y, scale, act=act, out_dtype=dz_dtype)
    gz = torch.where(y.float() > 0, g.float(), 0.0) if act == "relu" else g.float()
    assert got.dtype == dz_dtype and torch.equal(got, (gz * scale).to(dz_dtype))
    with pytest.raises(ValueError, match="act None or 'relu'"):
        k4.conv1x1_bwd_dz(g, y, scale, act="gelu")


def _nhwc(b, h, w, c, stride=1, dtype=torch.bfloat16):
    """``x[:, :, ::stride, ::stride]`` of a channels-last NCHW tensor, as the NHWC view that
    ``models/resnet.py`` hands the kernel."""
    full = torch.zeros(b, c, h, w, dtype=dtype).contiguous(memory_format=torch.channels_last)
    return full[:, :, ::stride, ::stride].permute(0, 2, 3, 1)


@pytest.mark.parametrize("name,cin,cout,stride", RESNET_K4_SHAPES)
def test_resnet50_shapes_take_the_wgmma_variant(name, cin, cout, stride):
    """All nine of ResNet-50's K4 launches (batch 2 here: the rule reads dtypes and
    channels only), the stride-2 shortcut's view included."""
    x = _nhwc(2, 56, 56, cin, stride)
    assert k4.conv1x1_variant(x, cout) == "wgmma"
    assert k4.conv1x1_variant(x, cout, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("dtype,out_dtype,cin,cout", [
    (torch.float32, None, 64, 256),  # f32: its bound is below what TF32 products give
    (torch.bfloat16, torch.float32, 64, 256),  # bf16 -> f32
    (torch.bfloat16, None, 24, 64),  # Cin off the 64-channel regions
    (torch.bfloat16, None, 64, 96),  # Cout off the 64-channel regions
    (torch.bfloat16, None, 768, 3072),  # Cin past what shared memory holds beside the ring
])
def test_other_inputs_take_the_cuda_core_variant(dtype, out_dtype, cin, cout):
    assert k4.conv1x1_variant(_nhwc(2, 8, 8, cin, dtype=dtype), cout, out_dtype) == "cuda_cores"


def test_tma_rows_reads_resnet_views_in_place():
    """A channels-last activation is rows one stride apart; the stride-2 shortcut's view of
    a 56 x 56 activation is whole image rows (w, b * h) in boxes of 2 rows of 28; views
    whose (b, h) do not flatten (an odd H before the stride) or whose rows are wider than
    one 64-row box are copied (None)."""
    x = _nhwc(3, 56, 56, 64)
    assert k4.tma_rows(x) == (3 * 56 * 56, 1, 64, 64, 64, 1)
    x = _nhwc(3, 56, 56, 256, 2)
    assert k4.tma_rows(x) == (28, 3 * 28, 2 * 256, 2 * 56 * 256, 28, 2)
    assert k4.tma_rows(_nhwc(3, 57, 57, 64, 2)) is None
    assert k4.tma_rows(_nhwc(2, 140, 140, 64, 2)) is None
    assert k4.tma_rows(_nhwc(1, 1, 1, 64)) == (1, 1, 64, 64, 64, 1)


class _RecordingLibrary:
    """Stands in for the kernel library: records each C entry point called, and returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


@pytest.fixture()
def stand_in_library(monkeypatch):
    lib = _RecordingLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    k4.reset_launches()
    yield lib
    k4.reset_launches()


@pytest.mark.parametrize("cin,cout,stride,out_dtype,entry,variant", [
    (64, 256, 1, torch.bfloat16, "dtp_conv1x1_bn_act_wgmma", "wgmma"),
    (256, 512, 2, torch.bfloat16, "dtp_conv1x1_bn_act_wgmma", "wgmma"),
    (64, 256, 1, torch.float32, "dtp_conv1x1_bn_act", "cuda_cores"),
])
def test_launch_takes_the_entry_point_of_its_variant(stand_in_library, cin, cout, stride, out_dtype, entry, variant):
    """The forward goes to the C entry point that ``conv1x1_variant`` names, with the view's
    own pointer (the stride-2 shortcut is read in place, through its TMA geometry), and
    counts under ``("conv1x1_bn_act", variant)``."""
    x = _nhwc(2, 56, 56, cin, stride)
    w = torch.zeros(cout, cin, dtype=torch.bfloat16)
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    y = k4._launch_kernel(x, w, ones, zeros, None, out_dtype)
    assert [name for name, _ in stand_in_library.calls] == [entry]
    args = stand_in_library.calls[0][1]
    assert args[0] == x.data_ptr() and len(args) == len(_build.ARGTYPES[entry])
    if variant == "wgmma":
        assert args[5:13] == (cin, cout, *k4.tma_rows(x))
    assert y.shape == (*x.shape[:3], cout) and y.dtype == out_dtype
    assert k4.launches["conv1x1_bn_act"] == k4.launches_by_variant[("conv1x1_bn_act", variant)] == 1


def test_wgmma_launch_copies_a_view_tma_cannot_read(stand_in_library):
    x = _nhwc(3, 57, 57, 64, 2)
    k4._launch_kernel(x, torch.zeros(64, 64, dtype=torch.bfloat16), torch.ones(64), torch.zeros(64), "relu", torch.bfloat16)
    (name, args), = stand_in_library.calls
    assert name == "dtp_conv1x1_bn_act_wgmma" and args[0] != x.data_ptr()
    assert args[7:13] == (3 * 29 * 29, 1, 64, 64, 64, 1)  # the contiguous copy's rows


@pytest.mark.parametrize("act", [None, "relu"])
def test_bwd_dz_launch_passes_g_y_and_the_dtypes(stand_in_library, act):
    g = torch.zeros(100, 64, dtype=torch.bfloat16)
    y = torch.zeros(100, 64, dtype=torch.bfloat16)
    dz = k4._launch_bwd_dz(g, y, torch.ones(64), act, torch.bfloat16)
    (name, args), = stand_in_library.calls
    assert name == "dtp_conv1x1_bwd_dz" and len(args) == len(_build.ARGTYPES[name])
    assert args[0] == g.data_ptr() and args[1] == (y.data_ptr() if act == "relu" else None)
    assert args[4:9] == (1, 1, 100, 64, 0 if act is None else 1)
    assert dz.shape == g.shape and dz.dtype == torch.bfloat16
    assert k4.launches["conv1x1_bwd_dz"] == 1
