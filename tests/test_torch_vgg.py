"""The port's VGG16 (``distributed_training_pytorch_tpu_torch/models/vgg.py``), its
converter (``models/convert.py::vgg_params_from_jax``) and its ``create_model`` entry, held
against the JAX package's flax ``VGG16`` on the CPU.

Tolerances: f32 eval logits within atol 1e-4 (the same arithmetic in other summation
orders, convolutions over up to 4,608 terms); bf16 logits within 3e-2 of the largest
logit's magnitude (each layer rounded to bf16 on both sides, in other orders); the
parameter count exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.models import create_model as jax_create_model
from distributed_training_pytorch_tpu.models import vgg as jax_vgg
from distributed_training_pytorch_tpu.models.wrappers import InputNormalizer as JaxInputNormalizer
from distributed_training_pytorch_tpu.ops import dispatch as jax_dispatch
from distributed_training_pytorch_tpu_torch.models import VGG16, InputNormalizer, create_model, vgg_params_from_jax
from distributed_training_pytorch_tpu_torch.models import convert
from distributed_training_pytorch_tpu_torch.ops import dispatch

NARROW = dict(stage_features=(4, 8, 8, 16, 16), classifier_widths=(32, 24), dropout_rate=0.0)
MEAN, STD = (0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_init(model, x, seed=0):
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = _numpy(variables["params"])
    # random biases, so that their placement is checked too (the init zeroes them)
    rng = np.random.RandomState(seed + 1)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "bias":
                tree[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)

    walk(params)
    return params


def _inputs(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("hw", [(32, 32), (64, 96), (40, 33)])
def test_eval_logits_match_jax_on_converted_weights(hw):
    h, w = hw
    x = _inputs((3, h, w, 3))
    jax_model = jax_vgg.VGG16(num_classes=7, **NARROW)
    params = _jax_init(jax_model, x)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    model = VGG16(num_classes=7, **NARROW, device="cpu").eval()
    model.load_state_dict(vgg_params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_uint8_input_through_input_normalizer_matches_jax():
    x = np.random.RandomState(4).randint(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)
    jax_model = JaxInputNormalizer(jax_vgg.VGG16(num_classes=5, **NARROW), mean=MEAN, std=STD)
    params = _jax_init(jax_model, x)
    assert "inner" in params
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    model = InputNormalizer(VGG16(num_classes=5, **NARROW, device="cpu"), mean=MEAN, std=STD).eval()
    model.load_state_dict(vgg_params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_the_first_classifier_weight_is_permuted_to_the_nchw_flatten():
    """Without the (h, w, c) -> (c, h, w) permute of the first dense kernel the logits
    miss the JAX model's by far more than the tolerance."""
    x = _inputs((2, 64, 96, 3), seed=2)
    jax_model = jax_vgg.VGG16(num_classes=6, **NARROW)
    params = _jax_init(jax_model, x, seed=3)
    rng = np.random.RandomState(4)
    for name in ("Dense_0", "Dense_1", "Dense_2"):  # logits of order 1, not the init's 0.01
        shape = params[name]["kernel"].shape
        params[name]["kernel"] = (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    right = VGG16(num_classes=6, **NARROW, device="cpu").eval()
    right.load_state_dict(vgg_params_from_jax(params))
    with torch.no_grad():
        np.testing.assert_allclose(right(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(), want, atol=1e-4, rtol=0)
    unpermuted = vgg_params_from_jax(params)
    kernel = np.asarray(params["Dense_0"]["kernel"])
    unpermuted["classifier.0.weight"] = torch.tensor(kernel.T)
    model = VGG16(num_classes=6, **NARROW, device="cpu").eval()
    model.load_state_dict(unpermuted)
    with torch.no_grad():
        wrong = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(wrong - want).max() > 0.1
    permuted = vgg_params_from_jax(params)["classifier.0.weight"]
    assert permuted.shape == (32, 16 * 49) and not torch.equal(permuted, torch.tensor(kernel.T))


def test_full_width_parameter_count_equals_jax():
    shapes = jax.eval_shape(jax_vgg.VGG16(num_classes=10).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    model = VGG16(num_classes=10, device="cpu")
    count = sum(p.numel() for p in model.parameters())
    assert count == jax_count == 134_301_514
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert (model.stage_features, model.stage_layers, model.classifier_widths, model.dropout_rate) == (
        (64, 128, 256, 512, 512), (2, 2, 3, 3, 3), (4096, 4096), 0.3)


def test_init_is_kaiming_fan_out_and_dense_normal():
    model = VGG16(num_classes=10, stage_features=(16, 32, 32, 64, 64), classifier_widths=(256, 256), device="cpu")
    for block in model.blocks:
        for conv in block.convs:
            fan_out = conv.out_channels * 9
            std = conv.weight.std().item()
            assert abs(std - (2.0 / fan_out) ** 0.5) < 0.15 * (2.0 / fan_out) ** 0.5
            assert torch.count_nonzero(conv.bias) == 0
    for dense in [*model.classifier, model.head]:
        assert abs(dense.weight.std().item() - 0.01) < 0.002 and torch.count_nonzero(dense.bias) == 0


def test_bf16_compute_keeps_f32_params_and_tracks_jax():
    x = _inputs((2, 32, 32, 3), seed=5)
    jax_model = jax_vgg.VGG16(num_classes=7, **NARROW, dtype=jnp.bfloat16)
    params = _jax_init(jax_model, x, seed=6)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    assert want.dtype == np.float32
    model = VGG16(num_classes=7, **NARROW, dtype=torch.bfloat16, device="cpu").eval()
    model.load_state_dict(vgg_params_from_jax(params))
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    got.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())
    scale = float(np.abs(want).max())
    assert np.abs(got.detach().numpy() - want).max() <= 3e-2 * scale


def test_dropout_is_active_only_in_train_mode():
    x = torch.from_numpy(_inputs((4, 32, 32, 3), seed=7)).permute(0, 3, 1, 2)
    model = VGG16(num_classes=5, **{**NARROW, "dropout_rate": 0.5}, device="cpu")
    no_dropout = VGG16(num_classes=5, **NARROW, device="cpu").eval()
    no_dropout.load_state_dict(model.state_dict())
    model.train()
    torch.manual_seed(0)
    a, b = model(x), model(x)
    assert not torch.equal(a, b)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), model(x))
        assert torch.equal(model(x), no_dropout(x))


def test_inputs_below_the_minimum_size_raise():
    model = VGG16(num_classes=3, **NARROW, device="cpu")
    with pytest.raises(ValueError, match="must be >= 32x32"):
        model(torch.zeros(1, 3, 31, 64))
    with pytest.raises(ValueError, match="must be >= 32x32"):
        jax_vgg.VGG16(num_classes=3, **NARROW).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 31, 3)))


@pytest.mark.parametrize("pallas", [True, False, None])
def test_create_model_builds_the_plain_program_for_any_pallas_knob(pallas):
    dispatch.reset()
    jax_dispatch.reset()
    ref = VGG16(num_classes=10, **NARROW, device="cpu").eval()
    model = create_model("vgg", 10, pallas=pallas, device="cpu", **NARROW).eval()
    assert isinstance(model, VGG16)
    state = model.state_dict()
    assert state.keys() == ref.state_dict().keys()
    assert all(torch.equal(state[k], v) for k, v in ref.state_dict().items())
    x = torch.from_numpy(_inputs((2, 32, 32, 3), seed=8)).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(model(x), ref(x))
    jax_create_model("vgg16", num_classes=10, pallas=pallas, **NARROW)
    assert dispatch.records() == jax_dispatch.records()
    assert [r["path"] for r in dispatch.records()] == (["plain"] if pallas is not None else [])
    dispatch.reset()
    jax_dispatch.reset()


def test_converter_maps_every_key():
    x = _inputs((1, 32, 32, 3))
    params = _jax_init(jax_vgg.VGG16(num_classes=4, **NARROW), x)
    state = vgg_params_from_jax(params)
    model = VGG16(num_classes=4, **NARROW, device="cpu")
    assert set(state) == set(model.state_dict())
    assert state["blocks.0.convs.0.weight"].shape == (4, 3, 3, 3)
    assert "vgg_params_from_jax" in convert.__all__
