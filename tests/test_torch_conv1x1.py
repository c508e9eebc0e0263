"""The port's fused 1x1-conv function (``distributed_training_pytorch_tpu_torch/ops/
conv1x1.py``) against the JAX package's ``ops/pallas.py::conv1x1_bn_act`` (the Pallas
kernel in interpret mode, the JAX package's CPU mode) and its custom VJP
``conv1x1_bn_act_diff``, on the CPU: the port's wrapper takes its plain version for CPU
tensors. Inputs come from numpy with a seed; the port's ``w`` is the transpose of the JAX
function's (``[Cout, Cin]``, the torch layout).

Tolerances: f32 forward atol 1e-5 (``tests/test_pallas.py``'s bound: f32 sums over 24 to
64 terms in another order); bf16 forward within one bf16 ulp of the output (2^-7
relative; both sides sum the same bf16 products in f32 and round once); gradients atol
2e-4 (``tests/test_pallas.py``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.ops.pallas import conv1x1_bn_act as jax_conv1x1
from distributed_training_pytorch_tpu.ops.pallas import conv1x1_bn_act_diff as jax_conv1x1_diff
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
