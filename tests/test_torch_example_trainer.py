"""The port's image-folder entry (``distributed_training_pytorch_tpu_torch/examples/
example_trainer.py``, ``main.py``, ``eval.py``) held against the JAX package's
(``examples/example_trainer.py``, ``examples/eval.py``) on the CPU.

Both trainers read the same folder tree written here (``train``/``val``/``test`` x 3
labels, PNG and BMP files, class-separable colours), at 32x32, global batch 8 (3 steps an
epoch; the val set of 9 padded to 2 batches), validation before every epoch
(``save_period=1``), 2 epochs and then a third resumed from ``last``. Both sides'
``build_model`` is overridden alike: VGG16 at narrow widths with dropout 0 (threefry and
Philox masks can never match); the port starts from the JAX run's initial weights
(``models/convert.py::vgg_params_from_jax``). The JAX side runs in a subprocess with a
stand-in ``data.streaming`` module, as ``tests/test_torch_trainer_cifar10.py`` does.

Cases, and their tolerances:

* ``eval_transform``: ``build_train_dataset`` overridden to the eval transform on both
  sides: per-epoch train CE and accuracy and val CE and accuracy within 1e-4 relative (f32
  in other summation orders), the resume's step and epoch exact;
* ``train_transform``: the shipped ten-step chain, on a tree of 32x32 images, where the
  resize is the identity and every other step is bit-equal to the JAX one
  (``tests/test_torch_folder_transforms.py``): the same 1e-4;
* ``train_transform_resized``: the shipped chain on a tree of 24x40, 45x30 and 33x33
  images, where the port's resize may land a pixel 1 level away from OpenCV's (the one
  transform that is not bit-equal): every per-epoch metric within ``RESIZED_BAND``
  absolute: 1e-4 on the CE (3.9e-6 measured on this test's data, on a CE near 1.1) and one
  row of accuracy (1/24 train, 1/9 val; one train row of epoch 0 flipped on it);
* ``eval.evaluate`` on a port checkpoint of the JAX run's final weights gives the JAX
  ``evaluate``'s top-1 and top-2 on the test folder (rows whose top-2 margin is under 1e-4
  may differ; the test counts them).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.checkpoint import LAST, CheckpointManager
from distributed_training_pytorch_tpu_torch.data import ImageFolderDataSource, eval_transform
from distributed_training_pytorch_tpu_torch.examples import eval as port_eval
from distributed_training_pytorch_tpu_torch.examples import main as port_main
from distributed_training_pytorch_tpu_torch.examples.example_trainer import ExampleTrainer
from distributed_training_pytorch_tpu_torch.models import InputNormalizer, create_model, vgg_params_from_jax
from distributed_training_pytorch_tpu_torch.ops.schedules import multistep_lr
from distributed_training_pytorch_tpu_torch.train import TrainState

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["cat", "dog", "snake"]
SIZE, BATCH, EPOCHS = 32, 8, 2
NARROW = dict(stage_features=[8, 8, 16, 16, 16], classifier_widths=[32, 32], dropout_rate=0.0)
RTOL = 1e-4
# Both sides' build_scheduler takes this lr, halved after the first epoch, so that a
# milestone falls inside the 3 epochs (the recipe's lr 0.1 first changes at epoch 50; its
# schedule is held in test_main_entry_has_the_reference_configuration).
LR = 0.01
RESIZED_BAND = {"ce_loss": 1e-4, "train_accuracy": 1 / 24 + 1e-6, "val_accuracy": 1 / 9 + 1e-6}
COUNTS = {"train": 8, "val": 3, "test": 5}

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

    out, root, mode, size, batch, epochs, narrow, lr = sys.argv[1:9]
    size, batch, epochs, narrow, lr = int(size), int(batch), int(epochs), json.loads(narrow), float(lr)
    import jax.numpy as jnp
    from distributed_training_pytorch_tpu.data import ImageFolderDataSource, eval_transform
    from distributed_training_pytorch_tpu.models import VGG16
    from distributed_training_pytorch_tpu.ops import multistep_lr
    from examples.example_trainer import ExampleTrainer
    from examples import eval as jax_eval

    labels = ["cat", "dog", "snake"]
    record = {"train": [], "val": []}

    class Recorded(ExampleTrainer):
        def build_model(self):
            return VGG16(num_classes=len(self.labels), dtype=jnp.float32, **narrow)

        def build_scheduler(self):
            return multistep_lr(lr, [1], gamma=0.5, steps_per_epoch=len(self.train_dataset) // self.batch_size)

        def build_train_dataset(self):
            if mode == "eval_transform":
                return ImageFolderDataSource(self.train_path, self.labels, transform=eval_transform(size, size))
            return super().build_train_dataset()

        def train_epoch(self, epoch):
            record["train"].append({k: float(v) for k, v in super().train_epoch(epoch).items()})
            return record["train"][-1]

        def validate(self):
            record["val"].append({k: float(v) for k, v in super().validate().items()})
            return record["val"][-1]

    save = os.path.join(os.path.dirname(out), "jax_run")

    def build(max_epoch, snapshot):
        return Recorded(train_path=os.path.join(root, "train"), val_path=os.path.join(root, "val"), labels=labels,
                        height=size, width=size, max_epoch=max_epoch, batch_size=batch, have_validate=True,
                        save_best_for=("accuracy", "geq"), save_period=1, save_folder=save, snapshot_path=snapshot,
                        progress=False, async_checkpoint=False)

    def flatten(tree, flat, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, flat, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
        return flat

    first = build(epochs, None)
    np.savez(out, **flatten(first.state.params, {}))
    first.train()
    resumed = build(epochs + 1, "last")
    record["resumed_at"] = [int(resumed.state.step), int(resumed.cur_epoch)]
    resumed.train()
    record["final_step"] = int(resumed.state.step)
    np.savez(out + ".final.npz", **flatten(resumed.state.params, {}))
    record["eval"] = jax_eval.evaluate(os.path.join(save, "weights", "last"), os.path.join(root, "test"), labels,
                                       batch=4, model=VGG16(num_classes=3, dtype=jnp.float32, **narrow),
                                       height=size, width=size)
    with open(out + ".json", "w") as f:
        json.dump(record, f)
    """
)


def _write_tree(root, sizes):
    """``train``/``val``/``test`` x 3 labels; one label's base colour apart, with noise;
    each label folder holds PNG files and one 24-bit BMP."""
    rng = np.random.RandomState(17)
    for split, n in COUNTS.items():
        for li, label in enumerate(LABELS):
            folder = os.path.join(root, split, label)
            os.makedirs(folder)
            for i in range(n):
                h, w = sizes[i % len(sizes)]
                base = np.array([60 + 70 * li, 200 - 60 * li, 90 + 30 * li], np.float32)
                img = np.clip(base + rng.randn(h, w, 3) * 35, 0, 255).astype(np.uint8)
                ext = ".bmp" if i == 0 else ".png"
                assert cv2.imwrite(os.path.join(folder, f"{i:02d}{ext}"), img[:, :, ::-1])


TREES = {"square": [(SIZE, SIZE)], "sizes": [(24, 40), (45, 30), (33, 33)]}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    for name, sizes in TREES.items():
        root = str(tmp_path_factory.mktemp(f"folder_{name}"))
        _write_tree(root, sizes)
        out[name] = root
    return out


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


_JAX_RUNS = {}


def _jax_run(root, mode, tmp_path_factory):
    key = (root, mode)
    if key not in _JAX_RUNS:
        out = str(tmp_path_factory.mktemp(f"jax_folder_{mode}") / "init.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
        for knob in ("PYTHONPATH", "PALLAS", "TUNED", "TELEMETRY", "MESH", "CHAIN_STEPS", "DTYPE"):
            env.pop(knob, None)
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_SIDE, out, root, mode, str(SIZE), str(BATCH), str(EPOCHS), json.dumps(NARROW),
             str(LR)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
        )
        assert proc.returncode == 0, proc.stderr[-4000:]
        with open(out + ".json") as f:
            record = json.load(f)
        _JAX_RUNS[key] = (_unflatten(dict(np.load(out))), _unflatten(dict(np.load(out + ".final.npz"))), record)
    return _JAX_RUNS[key]


def _narrow_vgg(device="cpu"):
    return create_model("vgg16", num_classes=3, dtype=torch.float32, device=device, **NARROW)


class _Recorded(ExampleTrainer):
    def __init__(self, record, mode, **kw):
        self.record, self.mode = record, mode
        super().__init__(**kw)

    def build_model(self):
        return _narrow_vgg(self.device)

    def build_scheduler(self):
        return multistep_lr(LR, [1], gamma=0.5, steps_per_epoch=len(self.train_dataset) // self.batch_size)

    def build_train_dataset(self):
        if self.mode == "eval_transform":
            return ImageFolderDataSource(self.train_path, self.labels, transform=eval_transform(SIZE, SIZE))
        return super().build_train_dataset()

    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


def _port_run(root, mode, params, save_folder):
    record = {"train": [], "val": []}

    def build(max_epoch, snapshot):
        return _Recorded(record, mode, train_path=os.path.join(root, "train"), val_path=os.path.join(root, "val"),
                         labels=LABELS, height=SIZE, width=SIZE, max_epoch=max_epoch, batch_size=BATCH,
                         have_validate=True, save_best_for=("accuracy", "geq"), save_period=1,
                         save_folder=save_folder, snapshot_path=snapshot, device="cpu")

    first = build(EPOCHS, None)
    first.model.load_state_dict(vgg_params_from_jax(params))
    first.train()
    resumed = build(EPOCHS + 1, "last")
    resumed_at = [resumed.state.step, resumed.cur_epoch]
    resumed.train()
    return record, resumed_at, resumed.state.step


@pytest.mark.parametrize(
    "mode, tree",
    [("eval_transform", "square"), ("train_transform", "square"), ("train_transform_resized", "sizes")],
)
def test_example_trainer_tracks_the_jax_trainer(trees, tmp_path, tmp_path_factory, mode, tree):
    jax_mode = "train_transform" if mode == "train_transform_resized" else mode
    params, _, ref = _jax_run(trees[tree], jax_mode, tmp_path_factory)
    record, resumed_at, final_step = _port_run(trees[tree], jax_mode, params, str(tmp_path))
    steps = len(LABELS) * COUNTS["train"] // BATCH
    assert resumed_at == ref["resumed_at"] == [EPOCHS * steps, EPOCHS]
    assert final_step == ref["final_step"] == (EPOCHS + 1) * steps
    assert len(record["train"]) == len(ref["train"]) == EPOCHS + 1 == len(record["val"]) == len(ref["val"])
    for epoch in range(EPOCHS + 1):
        for split in ("train", "val"):
            got, want = record[split][epoch], ref[split][epoch]
            for k in ("ce_loss", "accuracy"):
                msg = f"{split} {k}, epoch {epoch}"
                if mode == "train_transform_resized":
                    band = RESIZED_BAND["ce_loss" if k == "ce_loss" else f"{split}_accuracy"]
                    assert abs(got[k] - want[k]) <= band, msg
                else:
                    np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=msg)
        np.testing.assert_allclose(record["train"][epoch]["lr"], ref["train"][epoch]["lr"], rtol=1e-6)


def test_eval_matches_the_jax_eval_on_the_same_weights(trees, tmp_path, tmp_path_factory):
    root = trees["square"]
    _, final, ref = _jax_run(root, "eval_transform", tmp_path_factory)
    model = _narrow_vgg()
    model.load_state_dict(vgg_params_from_jax(final))
    manager = CheckpointManager(str(tmp_path / "weights"))
    manager.save(LAST, TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1)), EPOCHS + 1)
    got = port_eval.evaluate(str(tmp_path / "weights" / LAST), os.path.join(root, "test"), LABELS, batch=4,
                             model=_narrow_vgg(), height=SIZE, width=SIZE, device="cpu")
    # Rows whose top-2 margin (2nd minus 3rd logit, or 1st minus 2nd) is under 1e-4 may
    # rank differently in other summation orders; count them.
    source = ImageFolderDataSource(os.path.join(root, "test"), LABELS, transform=eval_transform(SIZE, SIZE))
    images = torch.from_numpy(np.stack([source.transform(source[i]["image"]) for i in range(len(source))]))
    with torch.no_grad():
        logits = torch.sort(model.eval()(images.permute(0, 3, 1, 2)), dim=-1, descending=True).values
    near = int(((logits[:, 0] - logits[:, 1]) < 1e-4).sum() + ((logits[:, 1] - logits[:, 2]) < 1e-4).sum())
    for k in ("top1", "top2"):
        assert abs(got[k] - ref["eval"][k]) <= near / len(source) + 1e-9, (k, got, ref["eval"])
    assert 0.0 <= got["top1"] <= got["top2"] <= 1.0


def test_restore_params_only_keeps_the_optimizer_and_step(tmp_path):
    torch.manual_seed(0)
    model = _narrow_vgg()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(2, 3, SIZE, SIZE)).sum().backward()
    opt.step()
    manager = CheckpointManager(str(tmp_path))
    manager.save(LAST, TrainState(model=model, optimizer=opt, step=7), 3)

    fresh = _narrow_vgg()
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    fresh_opt = torch.optim.SGD(fresh.parameters(), lr=0.0)
    state, epoch = manager.restore(LAST, TrainState(model=fresh, optimizer=fresh_opt, step=2), params_only=True)
    assert epoch == 3 and state.step == 2 and state.optimizer is fresh_opt and not fresh_opt.state
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    target = _narrow_vgg()
    state, _ = manager.restore(LAST, TrainState(model=target, optimizer=torch.optim.SGD(target.parameters(), lr=0.1,
                                                                                         momentum=0.9)))
    assert state.step == 7 and state.optimizer.state  # the momentum buffers came back


@pytest.mark.parametrize("wrapped", [True, False])
def test_params_top_level_picks_the_eval_wrapper(tmp_path, monkeypatch, wrapped):
    inner = create_model("resnet18_slim", num_classes=3, device="cpu")
    model = InputNormalizer(inner, mean=[0.5] * 3, std=[0.25] * 3) if wrapped else inner
    manager = CheckpointManager(str(tmp_path / "weights"))
    manager.save(LAST, TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1)), 1)
    top = manager.read_meta(LAST)["params_top_level"]
    assert (top == ["inner"]) == wrapped
    monkeypatch.setenv("EVAL_MODEL", "resnet18_slim")
    monkeypatch.setenv("SHIP_UINT8", "0" if wrapped else "1")  # the meta wins over the knob
    built = port_eval.model_from_env(str(tmp_path / "weights" / LAST), LABELS, torch.device("cpu"))
    assert isinstance(built, InputNormalizer) == wrapped
    # a checkpoint without the meta key falls back to the knob (the ImageNet family)
    meta_path = tmp_path / "weights" / LAST / "meta.json"
    meta = json.loads(meta_path.read_text())
    del meta["params_top_level"]
    meta_path.write_text(json.dumps(meta))
    built = port_eval.model_from_env(str(tmp_path / "weights" / LAST), LABELS, torch.device("cpu"))
    assert isinstance(built, InputNormalizer) == (not wrapped)


def test_main_entry_has_the_reference_configuration(tmp_path, trees):
    root = trees["square"]
    trainer = port_main.build_trainer("cpu", train_path=os.path.join(root, "train"),
                                      val_path=os.path.join(root, "val"), save_folder=str(tmp_path), height=SIZE,
                                      width=SIZE)
    assert trainer.labels == LABELS and trainer.max_epoch == 300 and trainer.batch_size == 16
    assert trainer.save_period == 5 and trainer.checkpoints.save_best_for == ("accuracy", "geq")
    assert trainer.criterion_uses_mask is True and trainer.pallas is None
    assert trainer.val_dataset.data_path == os.path.join(root, "val")  # not the train folder
    assert sum(p.numel() for p in trainer.model.parameters()) == 134_272_835  # VGG16, 3 classes, 7x7 pool
    group = trainer.optimizer.param_groups[0]
    assert (group["momentum"], group["weight_decay"]) == (0.9, 1e-4)
    steps = len(trainer.train_dataset) // 16
    assert [trainer.schedule(s * max(1, steps)) for s in (49, 50, 100, 200)] == pytest.approx([0.1, 0.01, 1e-3, 1e-4])


def test_the_first_float_batch_out_of_range_warns_once(tmp_path, trees):
    lines = []

    class _Log:
        def log(self, msg, log_type="info"):
            lines.append((log_type, msg))

    trainer = port_main.build_trainer("cpu", train_path=os.path.join(trees["square"], "train"),
                                      val_path=os.path.join(trees["square"], "val"), save_folder=str(tmp_path),
                                      logger=_Log(), height=SIZE, width=SIZE)
    batch = {"image": np.zeros((4, 2, 2, 3), np.float32), "label": np.zeros(4, np.int32)}
    batch["image"][3, 0, 0, 0] = 255.0  # the last image: the JAX Trainer looks at img[:1] only (R3)
    trainer._check_image_range(batch)
    trainer._check_image_range(batch)
    warnings = [m for kind, m in lines if kind == "warning"]
    assert len(warnings) == 1 and "255" in warnings[0]
    quiet = port_main.build_trainer("cpu", train_path=os.path.join(trees["square"], "train"),
                                    val_path=os.path.join(trees["square"], "val"), save_folder=str(tmp_path / "q"),
                                    logger=_Log(), height=SIZE, width=SIZE)
    n = len(lines)
    quiet._check_image_range({"image": np.full((2, 2, 2, 3), 2.5, np.float32)})  # normalised: in range
    assert len(lines) == n
