"""The port's ConvNeXt (``distributed_training_pytorch_tpu_torch/models/convnext.py``) and its
converter (``models/convert.py::convnext_params_from_jax``) held against the JAX package's
flax ConvNeXt on the CPU, on the same weights and inputs.

Weights: the flax init of ``ConvNeXtTiny`` (depths 1, 1, 2, 1; dims 16 to 128) with every
leaf replaced by seeded numpy draws (LayerScale at 1e-6 would hide each block's branch);
images from numpy with a seed. Routes: ``pallas=None`` (the plain expand Dense + GELU on
both sides) and ``pallas=True``: each block's expand Dense + GELU through the fused 1x1
kernel's route, the JAX Pallas kernel in interpret mode (the JAX package's CPU mode) with
its custom VJP, against the port's ``conv1x1_bn_act_diff``, which runs its plain version
on CPU tensors.

Tolerances, f32: logits within atol 1e-5 (the same arithmetic in other summation orders;
logits of magnitude ~1). Parameter gradients of the mean cross-entropy within 1e-5 of each
gradient's largest magnitude plus atol 1e-7 (sums of up to 2 x 64 x 8 x 8 products in
other orders; measured up to 1.9e-6 of the largest magnitude, logits up to 1.2e-6). The
converter, the parameter counts and the state_dict keys are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.models import convnext as jax_convnext
from distributed_training_pytorch_tpu.models import create_model as jax_create_model
from distributed_training_pytorch_tpu_torch.models import (
    ConvNeXt,
    ConvNeXtL,
    ConvNeXtTiny,
    convnext_params_from_jax,
    create_model,
)
from distributed_training_pytorch_tpu_torch.models import convnext as port_convnext
from distributed_training_pytorch_tpu_torch.models.transformer_lm import _LayerNorm
from distributed_training_pytorch_tpu_torch.ops import conv1x1 as port_conv1x1
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss

ATOL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-5, 1e-7
LABELS = np.array([3, 7], np.int32)


def _random_params(params, seed=0):
    """Every leaf drawn from numpy: kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.1^2), LayerNorm
    scales ~ 1 + N(0, 0.1^2), LayerScale ~ U(0.5, 1)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = getattr(path[-1], "key", str(path[-1])), leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) * int(np.prod(shape[:-1])) ** -0.5).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "layer_scale":
            return rng.uniform(0.5, 1.0, shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _params(size):
    init = jax_convnext.ConvNeXtTiny(num_classes=10).init(jax.random.key(0), jnp.zeros((1, size, size, 3)))
    return _random_params(init["params"])


def _images(size, b=2, seed=1):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(np.float32)


def _jax_logits_and_grads(params, x, pallas):
    model = jax_convnext.ConvNeXtTiny(num_classes=10, pallas=pallas)

    def loss(p):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, LABELS).mean(), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(logits), grads


def _port_logits_and_grads(params, x, pallas):
    port = ConvNeXtTiny(num_classes=10, pallas=pallas, device="cpu")
    port.load_state_dict(convnext_params_from_jax(params))
    logits = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    cross_entropy_loss(logits, torch.from_numpy(LABELS).long()).backward()
    return logits.detach().numpy(), {k: p.grad for k, p in port.named_parameters()}


@pytest.mark.parametrize("size", [32, 36])
@pytest.mark.parametrize("pallas", [None, True])
def test_logits_and_gradients_match_jax(pallas, size):
    """Both routes, at 32x32 and at 36x36, where flax's "SAME" padding pads the 2x2 stride-2
    downsampling of the 9x9 map after it (a symmetric or zero pad would differ)."""
    params = _params(size)
    x = _images(size)
    dispatch.reset()
    before = port_conv1x1.launches["conv1x1_bn_act"]
    ref, ref_grads = _jax_logits_and_grads(params, x, pallas)
    got, grads = _port_logits_and_grads(params, x, pallas)
    assert port_conv1x1.launches["conv1x1_bn_act"] == before  # CPU tensors: the plain version, no launch
    path = "pallas" if pallas else "plain"
    assert [r["path"] for r in dispatch.records() if r["op"] == "dense_gelu"] == [path]
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    converted = {k: v.numpy() for k, v in convnext_params_from_jax(jax.tree.map(np.asarray, ref_grads)).items()}
    assert set(converted) == set(grads)
    for name, g in grads.items():
        want = converted[name]
        bound = GRAD_REL * float(np.abs(want).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - want).max())
        assert err <= bound, f"{name}: gradient off by {err:.3g} (bound {bound:.3g})"
    dispatch.reset()


def test_pallas_route_calls_the_fused_op(monkeypatch):
    """With ``pallas=True`` every block's expand goes through ``conv1x1_bn_act_diff`` with the
    gelu epilogue and trainable bias (``affine_grads=True``), once per block."""
    calls = []
    real = port_convnext.conv1x1_bn_act_diff

    def recorded(x, w, scale, bias, **kw):
        calls.append((tuple(x.shape), tuple(w.shape), float(scale.min()), float(scale.max()), kw))
        return real(x, w, scale, bias, **kw)

    monkeypatch.setattr(port_convnext, "conv1x1_bn_act_diff", recorded)
    model = ConvNeXtTiny(num_classes=10, pallas=True, device="cpu")
    model.eval()(torch.zeros(2, 3, 32, 32))
    assert [c[1] for c in calls] == [(64, 16), (128, 32), (256, 64), (256, 64), (512, 128)]
    assert all(c[2] == c[3] == 1.0 and c[4] == {"act": "gelu", "affine_grads": True} for c in calls)
    assert calls[0][0] == (2, 8, 8, 16)  # the LayerNorm's NHWC rows


def test_convnext_l_param_count_matches_jax():
    """ConvNeXt-L at 1000 classes, built on the meta device: the JAX tests' 197,767,336."""
    model = ConvNeXtL(1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 197_767_336
    assert len(model.blocks) == 36 and model.head.in_features == 1536


def test_state_dict_keys_do_not_depend_on_the_knob():
    keys = {k: list(ConvNeXtTiny(pallas=k, device="cpu").state_dict()) for k in (None, False, True)}
    assert keys[None] == keys[False] == keys[True]
    shapes = {k: ConvNeXtTiny(pallas=k, device="cpu").state_dict() for k in (None, True)}
    assert all(shapes[None][k].shape == shapes[True][k].shape for k in shapes[None])


def test_drop_path():
    """The identity in eval and at rate 0; in training, whole samples dropped or scaled by
    1 / keep, from the explicit generator (the same generator state, the same mask)."""
    x = torch.randn(64, 4, 3, 3)
    for rate, train in ((0.0, True), (0.3, False)):
        layer = port_convnext.DropPath(rate, torch.Generator().manual_seed(0)).train(train)
        assert layer(x) is x
    a = port_convnext.DropPath(0.25, torch.Generator().manual_seed(5)).train()(x)
    b = port_convnext.DropPath(0.25, torch.Generator().manual_seed(5)).train()(x)
    assert torch.equal(a, b)
    kept = (a != 0).flatten(1).all(dim=1)
    dropped = (a == 0).flatten(1).all(dim=1)
    assert bool((kept | dropped).all()) and 0 < int(dropped.sum()) < 64
    torch.testing.assert_close(a[kept], x[kept] / 0.75)
    model = ConvNeXtTiny(drop_path_rate=0.2, device="cpu")
    assert [b.drop_path.rate for b in model.blocks] == pytest.approx(list(np.linspace(0.0, 0.2, 5)))


def test_fresh_init_distributions_match_jax():
    """The initialisers, in distribution: LeCun normal truncated at two standard deviations
    (convs and Dense), zeros (biases), ones (LayerNorm scales), 1e-6 (LayerScale), N(0, 0.02)
    (the head). Constants equal; draws of 1,000 or more within 5% in standard deviation and
    10% in their largest magnitude over it, and a mean within a tenth of it."""
    model = jax_convnext.ConvNeXtTiny(num_classes=100)
    jax_params = jax.tree.map(np.asarray, model.init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"])
    jax_sd = {k: v.numpy() for k, v in convnext_params_from_jax(jax_params).items()}
    port = ConvNeXtTiny(num_classes=100, device="cpu", generator=torch.Generator().manual_seed(3))
    checked = 0
    for name, value in port.state_dict().items():
        got, ref = value.numpy(), jax_sd[name]
        if ref.std() == 0:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        elif ref.size >= 1000:
            assert abs(got.std() / ref.std() - 1) < 0.05, name
            assert abs(np.abs(got).max() / got.std() / (np.abs(ref).max() / ref.std()) - 1) < 0.1, name
            assert abs(got.mean()) < 0.1 * ref.std(), name
            checked += 1
    assert checked >= 10 and "head.weight" in jax_sd


def test_bf16_model_keeps_f32_params_stats_and_head():
    """A bf16 model: f32 params, LayerNorm epsilon 1e-6 with f32 statistics, f32 logits."""
    model = ConvNeXtTiny(dtype=torch.bfloat16, pallas=True, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    norms = [m for m in model.modules() if isinstance(m, _LayerNorm)]
    assert len(norms) == 2 + 3 + 5 and all(m.eps == 1e-6 for m in norms)
    out = model.eval()(torch.randn(2, 3, 32, 32))
    assert out.dtype == torch.float32 and out.shape == (2, 10)


@pytest.mark.parametrize("name", ["convnext", "convnext-l", "convnext_l", "convnextl", "convnext-tiny",
                                  "convnext_tiny"])
def test_create_model_builds_every_jax_name(name):
    """Each of the JAX zoo's ConvNeXt names builds the model of the same depths and widths."""
    jax_model = jax_create_model(name, num_classes=7)
    port = create_model(name, num_classes=7, device="meta")
    assert isinstance(port, ConvNeXt)
    assert port.depths == tuple(jax_model.depths) and port.head.in_features == jax_model.dims[-1]
    assert port.head.out_features == 7
