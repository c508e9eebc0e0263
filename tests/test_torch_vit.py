"""The port's ViT (``distributed_training_pytorch_tpu_torch/models/vit.py``) and its converter
(``models/convert.py::vit_params_from_jax``) held against the JAX package's flax ViT on the
CPU, on the same weights and inputs.

Weights: the flax init with every leaf replaced by seeded numpy draws (the head is
zero-initialised, and would hide everything below it); images from numpy with a seed.
Models: ``ViTTiny`` (head dim 8) and ``ViT`` at head dim 64 (D=128, 2 heads, depth 2,
patch 4 at 32x32: T=65 tokens, one 64-row tile and a 1-row tail).

Routes: the plain path (``pallas``/``use_flash`` False; ``dot_product_attention`` on both
sides), and the forced flash path (``pallas=True``): the JAX Pallas kernel in interpret
mode, as the JAX package's tests run it on the CPU, against the port's flash wrapper,
which runs its plain version on CPU tensors.

Tolerances: f32 logits within atol 1e-5 (the same arithmetic in other summation orders,
two layers deep, logits of magnitude ~1). bf16 (a bf16 model with f32 params): each side
rounds every layer's output to bf16, and p before P V (F4), at the same places, but from
f32 sums in other orders, and flax's tanh GELU rounds each of its steps to bf16 where
torch rounds once; the f32 head reads the bf16 class token, so every logit moves. Each
side lands 1.4 to 2.3 ulps of the largest logit from the f32 model, and they land 2.0 to
2.6 ulps apart (measured): held to 4 ulps (2^-5 of the largest logit). The padded model
against the unpadded one, f32: logits within 1e-5 and every parameter gradient within
1e-5 of its largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.models import create_model as jax_create_model
from distributed_training_pytorch_tpu.models import vit as jax_vit
from distributed_training_pytorch_tpu.models.wrappers import InputNormalizer as JaxInputNormalizer
from distributed_training_pytorch_tpu_torch.models import (
    InputNormalizer,
    ViT,
    ViTB16,
    ViTTiny,
    create_model,
    vit_params_from_jax,
)
from distributed_training_pytorch_tpu_torch.models import vit as port_vit
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss

ATOL = 1e-5
BF16_ULPS = 4
WIDE = dict(patch_size=4, hidden_dim=128, depth=2, num_heads=2, mlp_dim=256)  # head dim 64, T = 65


def _jax_model(kind, **kw):
    if kind == "tiny":
        return jax_vit.ViTTiny(num_classes=10, **kw)
    return jax_vit.ViT(num_classes=10, **WIDE, **kw)


def _port_model(kind, **kw):
    if kind == "tiny":
        return ViTTiny(num_classes=10, device="cpu", **kw)
    return ViT(num_classes=10, image_size=32, **WIDE, device="cpu", **kw)


def _random_params(params, seed=0):
    """Every leaf of a flax ViT tree drawn from numpy: kernels ~ N(0, 1/fan_in), biases and
    the class token ~ N(0, 0.1^2), LayerNorm scales ~ 1 + N(0, 0.1^2), positions ~ N(0, 0.02^2)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            fan_in = shape[0] if len(shape) < 4 or "qkv" in names else int(np.prod(shape[:3]))
            if names[-2] == "out":
                fan_in = shape[0] * shape[1]
            return (rng.randn(*shape) * fan_in**-0.5).astype(np.float32)
        if names[-1] == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if names[-1] == "pos_embed":
            return (0.02 * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree.map(np.asarray, params))


def _images(b=2, size=32, seed=1):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _weights(kind):
    params = _jax_model(kind).init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return kind, _random_params(params)


@pytest.fixture(params=["tiny", "wide"])
def weights(request):
    return _weights(request.param)


@pytest.fixture()
def wide():
    """The model at head dim 64, ViT-B/16's and the wgmma kernels' head dim: where the
    kernel routes are held."""
    return _weights("wide")


def test_plain_route_matches_jax(weights):
    kind, params = weights
    x = _images()
    ref = np.asarray(_jax_model(kind).apply({"params": params}, x))
    port = _port_model(kind)
    assert port.attention_fn is None  # ViTTiny and ViT default to the plain path, as in flax
    port.load_state_dict(vit_params_from_jax(params))
    got = port.eval()(_nchw(x)).detach().numpy()
    assert got.dtype == np.float32 and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_forced_flash_route_matches_jax_kernel_f32(wide):
    kind, params = wide
    x = _images()
    ref = np.asarray(_jax_model(kind, pallas=True).apply({"params": params}, x))  # Pallas in interpret mode
    port = _port_model(kind, pallas=True)
    assert port.attention_fn is not None
    port.load_state_dict(vit_params_from_jax(params))
    got = port.eval()(_nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind,pallas", [("tiny", False), ("wide", False), ("wide", True)])
def test_bf16_matches_jax_within_ulps(kind, pallas):
    kind, params = _weights(kind)
    x = _images()
    ref = np.asarray(_jax_model(kind, pallas=pallas, dtype=jnp.bfloat16).apply({"params": params}, x))
    port = _port_model(kind, pallas=pallas, dtype=torch.bfloat16)
    port.load_state_dict(vit_params_from_jax(params))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = port.eval()(_nchw(x))
    assert got.dtype == torch.float32  # the head reads the class token in f32, with f32 params
    diff = np.abs(got.detach().numpy() - ref)
    ulp = 2.0**-7 * float(np.abs(ref).max())
    assert diff.max() <= BF16_ULPS * ulp, f"logits {diff.max() / ulp:.2f} ulps apart (bound {BF16_ULPS})"


@pytest.mark.parametrize("pallas", [False, True])
def test_pad_seq_to_equals_the_unpadded_model(wide, pallas):
    """``pad_seq_to=128`` (65 tokens padded with 63 zero rows, masked as keys): the JAX padded
    model's logits, and the unpadded port model's logits and parameter gradients."""
    kind, params = wide
    x = _images()
    labels = torch.tensor([3, 7])
    ref = np.asarray(_jax_model(kind, pallas=pallas, pad_seq_to=128).apply({"params": params}, x))
    grads, logits = [], []
    for pad in (None, 128):
        port = _port_model(kind, pallas=pallas, pad_seq_to=pad)
        port.load_state_dict(vit_params_from_jax(params))
        out = port.eval()(_nchw(x))
        cross_entropy_loss(out, labels).backward()
        logits.append(out.detach().numpy())
        grads.append({k: p.grad.clone() for k, p in port.named_parameters()})
    np.testing.assert_allclose(logits[1], ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits[1], logits[0], atol=ATOL, rtol=0)
    for name, g in grads[0].items():
        bound = 1e-5 * float(g.abs().max()) + 1e-12
        err = float((grads[1][name] - g).abs().max())
        assert err <= bound, f"{name}: padded gradient off by {err:.3g} (bound {bound:.3g})"


def test_input_normalizer_and_uint8_match_jax(weights):
    """The entry's wrapping: uint8 NHWC images, normalised on the device; the converter takes
    the tree nested under ``inner``."""
    kind, params = weights
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    x = np.random.RandomState(4).randint(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)
    wrapped = JaxInputNormalizer(inner=_jax_model(kind), mean=mean, std=std)
    ref = np.asarray(wrapped.apply({"params": {"inner": params}}, x))
    port = InputNormalizer(_port_model(kind), mean=mean, std=std)
    port.load_state_dict(vit_params_from_jax({"params": {"inner": params}}))
    got = port.eval()(_nchw(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_fresh_init_distributions_match_jax():
    """The initialisers, in distribution: LeCun normal truncated at two standard deviations
    (kernels), zeros (biases, class token, head), ones (LayerNorm scales), N(0, 0.02)
    (positions). Constants equal; draws of 1,000 or more within 5% in standard deviation
    and 10% in their largest magnitude over it (a plain normal's reaches 4 standard
    deviations at this size, the truncated one 2.3), and a mean within a tenth of it."""
    jax_params = jax.tree.map(np.asarray, _jax_model("wide").init(jax.random.key(3), jnp.zeros((1, 32, 32, 3)))["params"])
    jax_sd = {k: v.numpy() for k, v in vit_params_from_jax(jax_params).items()}
    port = _port_model("wide", generator=torch.Generator().manual_seed(3))
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
    assert checked >= 10


def test_vit_b16_param_count_matches_jax():
    """ViT-B/16 at 1000 classes, built on the meta device: the JAX tests' 86,567,656."""
    model = ViTB16(1000, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 86_567_656
    assert model.pos_embed.shape == (1, 197, 768)


def test_state_dict_keys_do_not_depend_on_the_knob():
    keys = {str(k): list(_port_model("wide", pallas=k).state_dict()) for k in (None, False, True)}
    assert keys["None"] == keys["False"] == keys["True"]


def test_dispatch_records_each_resolution():
    dispatch.reset()
    _port_model("wide", pallas=False)
    assert {"model": "vit", "op": "attention", "path": "plain", "reason": "pallas/use_flash=False"} in dispatch.records()
    model = _port_model("wide", pallas=True)
    model.eval()(torch.zeros(1, 3, 32, 32))
    assert any(r["model"] == "vit" and r["path"] == "flash" and r["reason"] == "pallas=True (forced)"
               for r in dispatch.records())
    dispatch.reset()
    auto = ViT(num_classes=10, image_size=32, **WIDE, use_flash=None, device="cpu")
    auto.eval()(torch.zeros(1, 3, 32, 32))
    assert [r["path"] for r in dispatch.records()] == ["plain"]  # auto on CPU tensors: the kernel's plain version
    dispatch.reset()


def test_dot_product_attention_matches_jax_with_valid_len():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 40, 3, 16).astype(np.float32) for _ in range(3))
    for valid_len in (None, 33):
        ref = np.asarray(jax_vit.dot_product_attention(q, k, v, valid_len=valid_len))
        got = port_vit.dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)), valid_len=valid_len)
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["vit", "vit-b/16", "vit_b16", "vitb16", "vit_tiny", "vit-tiny"])
def test_create_model_builds_every_jax_name(name):
    """Each of the JAX zoo's ViT names builds the model of the same width here."""
    jax_model = jax_create_model(name, num_classes=7)
    port = create_model(name, num_classes=7, device="meta")
    assert isinstance(port, ViT)
    assert (port.hidden_dim, len(port.blocks), port.patch_size) == (jax_model.hidden_dim, jax_model.depth,
                                                                   jax_model.patch_size)
    assert port.head.out_features == 7
    assert all(b.ln1.eps == 1e-6 for b in port.blocks) and port.norm.eps == 1e-6  # flax's LayerNorm epsilon


def test_head_and_dropout_and_guards():
    model = _port_model("wide", dropout_rate=0.5)
    x = torch.from_numpy(_images()).permute(0, 3, 1, 2)
    model.eval()
    assert torch.equal(model(x), model(x))  # dropout is the identity in eval
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 3, 30, 30))
    with pytest.raises(ValueError, match="built for"):
        model(torch.zeros(1, 3, 64, 64))
    torch.manual_seed(0)
    a = port_vit.dropout(torch.ones(1000), 0.25, True, torch.Generator().manual_seed(1))
    b = port_vit.dropout(torch.ones(1000), 0.25, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.equal(a.unique(), torch.tensor([0.0, 1 / 0.75]))
