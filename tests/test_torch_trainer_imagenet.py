"""The port's ImageNet entry (``distributed_training_pytorch_tpu_torch/examples/
train_imagenet.py``) through its ``Trainer``, held against the JAX package's
``ImageNetTrainer`` (``examples/train_imagenet.py``), and the engine's non-finite guard on
a model with buffers (F3).

Both entries train the ``resnet50`` recipe (SGD momentum 0.9, weight decay 1e-4,
``lr = 0.1 * batch / 256``, 5 warmup epochs then cosine, masked CE and accuracy, uint8
images normalised on the device) on ``ResNet18Slim``, registered under the recipe in each
process, at ``IMAGE_SIZE=32``, f32, 2 epochs of 2 steps of 32 images
(``STEPS_PER_EPOCH=2``), validating on the entry's 1,024 synthetic val images before each
epoch. The JAX side runs in a subprocess with a stand-in ``data.streaming`` module, as
``tests/test_torch_trainer_lm.py`` does; the port starts from its initial weights
(``models/convert.py::resnet_params_from_jax``).

The random-resized-crop resizes in f32 here and in OpenCV's fixed point there, and pixels
may land 1 apart (``tests/test_torch_image_data.py``), so the run is made twice:

* ``opencv``: the port's resize swapped for OpenCV's (the test machine has OpenCV; the card's
  machine does not), so both sides see the same bytes: per-epoch train and val CE within
  1e-5 (f32 in other summation orders; measured 3e-7) and accuracies equal;
* ``port``: the entry as it is. A pixel 1 apart moves a normalised input by up to 0.0175,
  which moved the train CE by up to 4.5e-4 and flipped 2 of an epoch's 64 train
  predictions in the measured run: CE within 5e-3, train accuracy within 1/16 (4 of an
  epoch's 64 images), val accuracy within 8/1024.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.examples import train_imagenet
from distributed_training_pytorch_tpu_torch.models import ResNet18Slim, resnet_params_from_jax
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"IMAGE_SIZE": "32", "NUM_CLASSES": "5", "STEPS_PER_EPOCH": "2", "DTYPE": "fp32", "SHIP_UINT8": "1"}
BATCH, EPOCHS = 32, 2

_JAX_SIDE = textwrap.dedent(
    """
    import json, os, sys, types
    import numpy as np

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    out, batch, epochs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    model_name, base_recipe, base_lr = sys.argv[4], sys.argv[5], float(sys.argv[6])
    from collections.abc import Mapping
    import examples.train_imagenet as entry

    def flatten(tree, prefix=""):
        if isinstance(tree, Mapping):
            return {k: v for name, sub in tree.items() for k, v in flatten(sub, f"{prefix}{name}/").items()}
        return {prefix[:-1]: np.asarray(tree)}

    entry.RECIPES[model_name] = dict(entry.RECIPES[base_recipe])
    record = {"train": [], "val": []}

    class Recorded(entry.ImageNetTrainer):
        def train_epoch(self, epoch):
            record["train"].append({k: float(v) for k, v in super().train_epoch(epoch).items()})
            return record["train"][-1]

        def validate(self):
            record["val"].append({k: float(v) for k, v in super().validate().items()})
            return record["val"][-1]

    trainer = Recorded(model_name=model_name, image_size=32, base_lr=base_lr, max_epoch=epochs, batch_size=batch,
                       have_validate=True, save_best_for=("accuracy", "geq"), save_period=1,
                       save_folder=os.path.join(os.path.dirname(out), "jax_run"), progress=False, num_workers=0,
                       async_checkpoint=False, accum_steps=entry.RECIPES[model_name]["accum"])
    variables = flatten({"params": trainer.state.params, **trainer.state.model_state})
    trainer.train()
    np.savez(out, **variables)
    with open(out + ".json", "w") as f:
        json.dump(record, f)
    """
)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _run_jax_side(tmp_path_factory, model_name, base_recipe, base_lr):
    """The JAX entry's trainer on ``model_name`` under ``base_recipe``'s recipe, in a
    subprocess: its initial variables and per-epoch metrics."""
    out = str(tmp_path_factory.mktemp("jax_side") / "init.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1", **ENV)
    for knob in ("PYTHONPATH", "PALLAS", "IMAGENET_RECORDS", "VAL_RECORDS", "MODEL", "ACCUM"):
        env.pop(knob, None)
    subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, out, str(BATCH), str(EPOCHS), model_name, base_recipe, str(base_lr)],
        cwd=REPO, env=env, check=True, capture_output=True, text=True, timeout=600,
    )
    with open(out + ".json") as f:
        record = json.load(f)
    return _unflatten(dict(np.load(out))), record


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return _run_jax_side(tmp_path_factory, "resnet18_slim", "resnet50", 0.1)


class _Recorded(train_imagenet.ImageNetTrainer):
    def __init__(self, **kw):
        self.record = {"train": [], "val": []}
        super().__init__(**kw)

    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


TOLERANCES = {
    "opencv": {"ce": 1e-5, "train_acc": 1e-6, "val_acc": 1e-6},
    "port": {"ce": 5e-3, "train_acc": 1 / 16 + 1e-6, "val_acc": 8 / 1024 + 1e-6},
}


@pytest.mark.parametrize("resize", ["opencv", "port"])
def test_imagenet_entry_tracks_the_jax_imagenet_trainer(jax_side, monkeypatch, tmp_path, resize):
    variables, ref = jax_side
    tol = TOLERANCES[resize]
    if resize == "opencv":
        cv2 = pytest.importorskip("cv2")
        from distributed_training_pytorch_tpu_torch.data import transforms

        monkeypatch.setattr(
            transforms, "_resize_image",
            lambda img, h, w: cv2.resize(np.ascontiguousarray(img), (w, h), interpolation=cv2.INTER_LINEAR),
        )
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    for knob in ("PALLAS", "IMAGENET_RECORDS", "VAL_RECORDS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setitem(train_imagenet.RECIPES, "resnet18_slim", dict(train_imagenet.RECIPES["resnet50"]))
    trainer = _Recorded(
        model_name="resnet18_slim", image_size=32, base_lr=0.1, max_epoch=EPOCHS, batch_size=BATCH,
        have_validate=True, save_best_for=("accuracy", "geq"), save_period=1, save_folder=str(tmp_path),
        device="cpu",
    )
    trainer.model.load_state_dict(resnet_params_from_jax(variables))
    assert len(trainer.train_dataloader) == 2 and len(trainer.val_dataloader) == 1024 // BATCH
    trainer.train()
    got = trainer.record
    assert len(got["train"]) == len(ref["train"]) == EPOCHS == len(got["val"]) == len(ref["val"])
    for epoch in range(EPOCHS):
        g, r = got["train"][epoch], ref["train"][epoch]
        np.testing.assert_allclose(g["ce_loss"], r["ce_loss"], atol=tol["ce"])
        np.testing.assert_allclose(g["accuracy"], r["accuracy"], atol=tol["train_acc"])
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-6)
        gv, rv = got["val"][epoch], ref["val"][epoch]
        np.testing.assert_allclose(gv["ce_loss"], rv["ce_loss"], atol=tol["ce"])
        np.testing.assert_allclose(gv["accuracy"], rv["accuracy"], atol=tol["val_acc"])
    assert trainer.state.step == EPOCHS * 2
    assert trainer.checkpoints.read_meta("last")["epoch"] == EPOCHS


# The AdamW recipes: (model, the recipe it trains under, BASE_LR). ViTTiny is registered
# under the vit_b16 recipe in both processes; convnext_tiny is the JAX entry's own stand-in
# for convnext_l (AdamW, ACCUM=4: micro-batches of 8).
ADAMW_CASES = {"vit_tiny": ("vit_b16", 1e-3), "convnext_tiny": ("convnext_tiny", 1e-3)}


@pytest.fixture(scope="module", params=sorted(ADAMW_CASES))
def adamw_side(request, tmp_path_factory):
    base_recipe, base_lr = ADAMW_CASES[request.param]
    return request.param, _run_jax_side(tmp_path_factory, request.param, base_recipe, base_lr)


def test_imagenet_entry_tracks_the_jax_entry_on_the_adamw_recipes(adamw_side, monkeypatch, tmp_path):
    """The vit_b16 and convnext_l recipes (AdamW (0.9, 0.999) with wd 0.05 on every param,
    ``lr = 1e-3 * batch / 4096``, 5 warmup epochs then cosine; the convnext recipe in 4
    micro-batches a step) against the JAX entry, with the OpenCV resize swapped in: per-epoch
    train and val CE within 1e-5 and accuracies equal, as the ResNet recipe's ``opencv`` case."""
    cv2 = pytest.importorskip("cv2")
    from distributed_training_pytorch_tpu_torch.data import transforms
    from distributed_training_pytorch_tpu_torch.models import convnext_params_from_jax, vit_params_from_jax

    model_name, (variables, ref) = adamw_side
    base_recipe, base_lr = ADAMW_CASES[model_name]
    monkeypatch.setattr(
        transforms, "_resize_image",
        lambda img, h, w: cv2.resize(np.ascontiguousarray(img), (w, h), interpolation=cv2.INTER_LINEAR),
    )
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    for knob in ("PALLAS", "IMAGENET_RECORDS", "VAL_RECORDS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setitem(train_imagenet.RECIPES, model_name, dict(train_imagenet.RECIPES[base_recipe]))
    accum = train_imagenet.RECIPES[model_name]["accum"]
    trainer = _Recorded(
        model_name=model_name, image_size=32, base_lr=base_lr, max_epoch=EPOCHS, batch_size=BATCH,
        have_validate=True, save_best_for=("accuracy", "geq"), save_period=1, save_folder=str(tmp_path),
        device="cpu", accum_steps=accum,
    )
    assert isinstance(trainer.state.optimizer, torch.optim.AdamW) and trainer.engine.accum_steps == accum
    group = trainer.state.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 0.05)
    convert = vit_params_from_jax if model_name.startswith("vit") else convnext_params_from_jax
    trainer.model.load_state_dict(convert(variables["params"]))
    trainer.train()
    got = trainer.record
    assert len(got["train"]) == len(ref["train"]) == EPOCHS == len(got["val"]) == len(ref["val"])
    for epoch in range(EPOCHS):
        g, r = got["train"][epoch], ref["train"][epoch]
        np.testing.assert_allclose(g["ce_loss"], r["ce_loss"], atol=1e-5)
        np.testing.assert_allclose(g["accuracy"], r["accuracy"], atol=1e-6)
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-6)
        gv, rv = got["val"][epoch], ref["val"][epoch]
        np.testing.assert_allclose(gv["ce_loss"], rv["ce_loss"], atol=1e-5)
        np.testing.assert_allclose(gv["accuracy"], rv["accuracy"], atol=1e-6)
    assert trainer.state.step == EPOCHS * 2


@pytest.mark.parametrize("knob", ["IMAGENET_RECORDS", "VAL_RECORDS"])
def test_unported_models_and_records_raise(monkeypatch, tmp_path, knob):
    """Every model of the zoo is ported, and so are record files (``tests/
    test_torch_records.py``): for every recipe a record knob is read, and a pattern that
    matches no shard raises, naming it."""
    kw = dict(image_size=32, base_lr=0.1, max_epoch=1, batch_size=8, save_folder=str(tmp_path), device="cpu",
              have_validate=True)
    monkeypatch.setenv(knob, "/nowhere/*.rec")
    for model_name in train_imagenet.RECIPES:
        with pytest.raises(FileNotFoundError, match=r"no record shards match /nowhere/\*\.rec"):
            train_imagenet.ImageNetTrainer(model_name=model_name, **kw)


def test_nan_guard_keeps_batchnorm_buffers(tmp_path):
    """F3: under ``nan_guard``, a step on a NaN batch leaves params, optimizer state and
    every buffer (BN running mean/var and ``num_batches_tracked``) bit-equal, and reports
    ``nonfinite == 1``; the next finite step updates them again."""
    model = ResNet18Slim(num_classes=5, device="cpu")

    def loss_fn(net, batch, train):
        loss = cross_entropy_loss(net(batch["image"]), batch["label"])
        return loss, {"loss": loss}

    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    engine = TrainEngine(loss_fn, nan_guard=True)
    state = TrainState(model=model, optimizer=opt)
    rng = np.random.RandomState(0)
    good = {"image": torch.from_numpy(rng.randn(4, 3, 32, 32).astype(np.float32)),
            "label": torch.from_numpy(rng.randint(0, 5, size=(4,)))}
    state, _ = engine.train_step(state, good)  # momentum buffers exist from here on
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {i: {k: v.clone() for k, v in s.items()} for i, s in opt.state_dict()["state"].items()}
    bad = {"image": torch.full((4, 3, 32, 32), float("nan")), "label": good["label"]}
    state, metrics = engine.train_step(state, bad)
    assert float(metrics["nonfinite"]) == 1.0 and state.step == 2
    after = model.state_dict()
    for name, value in before.items():
        assert torch.equal(after[name], value), name
    assert any("running_var" in k for k in before) and any("num_batches_tracked" in k for k in before)
    for i, slots in opt.state_dict()["state"].items():
        for k, v in slots.items():
            assert torch.equal(v, opt_before[i][k]), (i, k)
    state, metrics = engine.train_step(state, good)
    assert float(metrics["nonfinite"]) == 0.0
    assert not torch.equal(model.state_dict()["bn_stem.running_mean"], before["bn_stem.running_mean"])
