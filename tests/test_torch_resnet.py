"""The port's ResNet (``distributed_training_pytorch_tpu_torch/models/resnet.py``), its
converter (``models/convert.py::resnet_params_from_jax``) and ``InputNormalizer``, held
against the JAX package's flax models on the CPU.

``ResNet18Slim(pallas=True)`` at 224x224 puts the 1x1 convolutions of stage 1 and the
first block of stage 2 through the fused 1x1 kernel's route on both sides: the Pallas
kernel in interpret mode (the JAX package's CPU mode), and the port's kernel wrapper,
which runs its plain version for CPU tensors. The JAX init zeroes each block's last BN
scale, which would cut the gradient of every convolution in a block; the tests set the BN
scales, biases and running statistics to seeded random values on both sides.

Tolerances, f32: logits and running statistics within atol 2e-5 + rtol 2e-5 (the same
arithmetic in other summation orders: convolutions over up to 2,304 terms, BN means over
6,272 pixels). The params after one SGD step (lr 0.05) within atol 1e-4: the early
layers' weight gradients sum up to 25,088 pixels with heavy cancellation (each BN's
backward removes the mean), and each framework's f32 gradient there is off a float64
computation of the same step by up to 2e-3 (measured on this input: stem 2.0e-3 for both),
so the two sides may sit 2e-3 x 0.05 apart. The converter and the param count are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.models import resnet as jax_resnet
from distributed_training_pytorch_tpu.models.wrappers import InputNormalizer as JaxInputNormalizer
from distributed_training_pytorch_tpu_torch.models import (
    InputNormalizer,
    ResNet18Slim,
    ResNet50,
    create_model,
    resnet_params_from_jax,
)
from distributed_training_pytorch_tpu_torch.ops import conv1x1 as port_conv1x1
from distributed_training_pytorch_tpu_torch.ops import dispatch
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss

TOL = dict(atol=2e-5, rtol=2e-5)
LR = 0.05
STEP_ATOL = 1e-4


def _randomize_bn(variables, seed=0):
    """BN scale/bias/mean/var set to seeded random values (numpy trees)."""
    rng = np.random.RandomState(seed)

    def walk(params, stats):
        for k in params:
            if k.startswith("BatchNorm_"):
                c = params[k]["scale"].shape[0]
                params[k]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                params[k]["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                stats[k]["mean"] = (0.1 * rng.randn(c)).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(params[k], dict) and k in stats:
                walk(params[k], stats[k])

    walk(variables["params"], variables["batch_stats"])
    return variables


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def slim_224():
    """JAX ResNet18Slim(pallas=True) at 224x224, batch 2, with randomised BN: its init,
    eval logits, train logits and updated stats, and the params after one SGD step."""
    model = jax_resnet.ResNet18Slim(num_classes=10, pallas=True)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 224, 224, 3).astype(np.float32)
    labels = np.array([3, 7], np.int32)
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 224, 224, 3)), train=False))
    variables = _randomize_bn(_numpy_tree(init(jax.random.key(0))))
    eval_logits = jax.jit(lambda v: model.apply(v, x, train=False))(variables)

    def loss(params):
        logits, new_state = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x, train=True, mutable=["batch_stats"]
        )
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), (logits, new_state)

    grads, (train_logits, new_state) = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    stepped = jax.tree.map(lambda p, g: p - LR * g, variables["params"], grads)
    return {
        "x": x,
        "labels": labels,
        "variables": variables,
        "eval_logits": np.asarray(eval_logits),
        "train_logits": np.asarray(train_logits),
        "stats": _numpy_tree(new_state["batch_stats"]),
        "stepped": _numpy_tree(stepped),
    }


def _port(variables, **kw):
    model = ResNet18Slim(num_classes=10, device="cpu", **kw)
    model.load_state_dict(resnet_params_from_jax(variables))
    return model


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)  # channels-last NCHW view of NHWC


def test_slim_224_kernel_route_matches_jax(slim_224):
    port_conv1x1.reset_launches()
    model = _port(slim_224["variables"], pallas=True)
    x = _nchw(slim_224["x"])
    with torch.no_grad():
        got = model.eval()(x)
    np.testing.assert_allclose(got.numpy(), slim_224["eval_logits"], **TOL)
    got = model.train()(x)
    np.testing.assert_allclose(got.detach().numpy(), slim_224["train_logits"], **TOL)
    # Running stats after one train-mode forward: flax's momentum 0.9 and biased variance.
    want = resnet_params_from_jax({"params": slim_224["variables"]["params"], "batch_stats": slim_224["stats"]})
    state = model.state_dict()
    for name, value in want.items():
        if "running_" in name:
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), **TOL, err_msg=name)
    assert port_conv1x1.launches["conv1x1_bn_act"] == 0  # CPU tensors: the plain version


def test_slim_224_one_sgd_step_matches_jax(slim_224):
    model = _port(slim_224["variables"], pallas=True).train()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    logits = model(_nchw(slim_224["x"]))
    cross_entropy_loss(logits, torch.from_numpy(slim_224["labels"])).backward()
    # The kernel route carries gradient into every 1x1 it takes, the projection included.
    assert float(model.blocks[0].conv1.weight.grad.abs().sum()) > 0
    assert float(model.blocks[1].proj.weight.grad.abs().sum()) > 0
    opt.step()
    want = resnet_params_from_jax({"params": slim_224["stepped"], "batch_stats": slim_224["stats"]})
    state = model.state_dict()
    for name, param in model.named_parameters():
        np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(), atol=STEP_ATOL, err_msg=name)
    assert set(state) == set(want)


def test_kernel_route_and_plain_route_agree(slim_224):
    """The same weights with the knob on (fused 1x1 route) and off (``F.conv2d``)."""
    x = _nchw(slim_224["x"])
    on = _port(slim_224["variables"], pallas=True).eval()
    off = _port(slim_224["variables"], pallas=False).eval()
    with torch.no_grad():
        np.testing.assert_allclose(on(x).numpy(), off(x).numpy(), **TOL)
    assert ("resnet", "conv1x1_bn_act", "pallas", "pallas=True") in {
        (r["model"], r["op"], r["path"], r["reason"]) for r in dispatch.records()
    }


@pytest.mark.parametrize("pallas", [False, True])
def test_converter_takes_both_jax_trees(pallas):
    """flax renames the gated 1x1s to ``PallasConv1x1_n`` when the knob is on; the port's
    ``state_dict`` has one set of names either way, and every value lands where its shape
    says."""
    model = jax_resnet.ResNet18Slim(num_classes=10, pallas=pallas)
    init = jax.jit(lambda key: model.init(key, jnp.zeros((1, 224, 224, 3)), train=False))
    variables = _numpy_tree(init(jax.random.key(1)))
    names = set(variables["params"]["BottleneckBlock_0"])
    assert ("PallasConv1x1_0" in names) == pallas
    converted = resnet_params_from_jax(variables)
    port = ResNet18Slim(num_classes=10, device="cpu", pallas=pallas)
    assert set(converted) == set(port.state_dict())
    for name, value in port.state_dict().items():
        assert converted[name].shape == value.shape, name
    port.load_state_dict(converted)
    block0 = variables["params"]["BottleneckBlock_0"]
    reduce_name = "PallasConv1x1_0" if pallas else "Conv_0"
    np.testing.assert_array_equal(
        port.blocks[0].conv1.weight.detach().numpy()[:, :, 0, 0], block0[reduce_name]["kernel"][0, 0].T
    )
    np.testing.assert_array_equal(
        port.blocks[0].conv2.weight.detach().numpy(), np.transpose(block0["Conv_0" if pallas else "Conv_1"]["kernel"], (3, 2, 0, 1))
    )


def test_resnet50_param_count_and_factory():
    model = ResNet50(1000, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert isinstance(create_model("resnet18_slim", num_classes=5, device="cpu"), type(model))
    vgg = create_model("vgg16", num_classes=5, device="cpu", stage_features=(4, 4, 4, 4, 4), classifier_widths=(8, 8))
    assert type(vgg).__name__ == "VGG16"  # ported since the VGG16 slice
    for name, cls in (("vit_b16", "ViT"), ("convnext_l", "ConvNeXt")):  # ported since the ViT/ConvNeXt slice
        assert type(create_model(name, num_classes=5, device="meta")).__name__ == cls


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_input_normalizer_matches_jax(dtype):
    """uint8 input is normalised on the device; float input passes through untouched."""
    inner = jax_resnet.ResNet18Slim(num_classes=10)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    wrapped = JaxInputNormalizer(inner=inner, mean=mean, std=std)
    rng = np.random.RandomState(3)
    if dtype == "uint8":
        x = rng.randint(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)
    else:
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
    variables = _numpy_tree(jax.jit(lambda key: wrapped.init(key, x, train=False))(jax.random.key(2)))
    variables = _randomize_bn(variables, seed=4)
    want = np.asarray(jax.jit(lambda v: wrapped.apply(v, x, train=False))(variables))
    port = InputNormalizer(ResNet18Slim(num_classes=10, device="cpu"), mean, std)
    port.load_state_dict(resnet_params_from_jax(variables))
    with torch.no_grad():
        got = port.eval()(_nchw(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert set(port.state_dict()) == {"inner." + k for k in port.inner.state_dict()}
