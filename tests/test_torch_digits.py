"""The port's digits corpus and entry (``distributed_training_pytorch_tpu_torch/examples/
digits_data.py``, ``train_digits.py``) held against the JAX package's
(``examples/digits_data.py`` over scikit-learn and OpenCV, ``examples/train_digits.py``)
on the CPU.

The JAX side runs once for the module, in a subprocess with a stand-in ``data.streaming``
module (as ``tests/test_torch_example_trainer.py`` runs it): it materialises its own tree
and trains its ``DigitsTrainer`` on a subset of the port's tree.

* The tree: the same file names in the same split (1,438 train and 359 test images), and
  every file's decoded pixels (``cv2.imread``) bit-equal, though the PNG bytes differ
  (another encoder).
* The entry: ``DigitsTrainer`` on 8 train and 3 test images a digit (batch 16, 5 steps an
  epoch, the test set padded to 2 batches), VGG16 at narrow widths with dropout 0, f32,
  the port starting from the JAX run's initial weights (``models/convert.py``), the
  digits train chain (resize, CLAHE, brightness/contrast, gamma, normalise: each bit-equal
  to the JAX transform): per-epoch train and val CE and accuracy within 1e-4 relative (f32
  in other summation orders), the lr equal.
* The ``Trainer``'s ``loss_scale`` refusals: fp16 without a dynamic scale, a dynamic scale
  under ``nan_policy`` ``"raise"`` or ``"restore_last_good"``, and a bad ``loss_scale`` raise
  the same exception type with the same message as the JAX ``Trainer``'s, both built as
  ``DigitsTrainer`` (the digits entry takes ``DTYPE=fp16``).
* ``main``'s flow on a small tree: materialise (a no-op on a finished tree), train,
  ``eval.evaluate`` of ``best`` and ``last``, ``summary.json`` with the curve; a resume
  from ``last`` continues the step and the epoch.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.examples import digits_data, train_digits
from distributed_training_pytorch_tpu_torch.models import create_model, vgg_params_from_jax

cv2 = pytest.importorskip("cv2")
pytest.importorskip("sklearn")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(stage_features=[8, 8, 16, 16, 16], classifier_widths=[32, 32], dropout_rate=0.0)
SUBSET = {"train": 8, "test": 3}  # images a digit
BATCH, EPOCHS, RTOL = 16, 2, 1e-4
REFUSALS = [
    {"precision": "fp16", "loss_scale": "none"},
    {"precision": "fp16", "loss_scale": "noop_instance"},
    {"precision": "fp32", "loss_scale": "dynamic", "nan_policy": "raise"},
    {"precision": "fp16", "nan_policy": "restore_last_good"},
    {"loss_scale": "bogus"},
    {"loss_scale": 3},
]

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

    out, tree, subset, batch, epochs, narrow, refusals = sys.argv[1:8]
    batch, epochs, narrow = int(batch), int(epochs), json.loads(narrow)
    import jax.numpy as jnp
    from distributed_training_pytorch_tpu.models import VGG16
    from examples import digits_data
    from examples.train_digits import DigitsTrainer

    counts = digits_data.materialize(tree)
    record = {"counts": counts, "train": [], "val": []}

    class Recorded(DigitsTrainer):
        def build_model(self):
            return VGG16(num_classes=len(self.labels), dtype=jnp.float32, **narrow)

        def train_epoch(self, epoch):
            record["train"].append({k: float(v) for k, v in super().train_epoch(epoch).items()})
            return record["train"][-1]

        def validate(self):
            record["val"].append({k: float(v) for k, v in super().validate().items()})
            return record["val"][-1]

    def flatten(tree, flat, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, flat, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
        return flat

    trainer = Recorded(train_path=os.path.join(subset, "train"), val_path=os.path.join(subset, "test"),
                       labels=digits_data.LABELS, height=digits_data.SIZE, width=digits_data.SIZE, max_epoch=epochs,
                       batch_size=batch, have_validate=True, save_period=1, last_save_period=epochs,
                       save_folder=os.path.join(os.path.dirname(out), "jax_run"), progress=False,
                       async_checkpoint=False)
    np.savez(out, **flatten(trainer.state.params, {}))
    trainer.train()
    record["final_step"] = int(trainer.state.step)

    from distributed_training_pytorch_tpu.precision.loss_scale import NoOpScale
    record["refusals"] = []
    for case in json.loads(refusals):
        if case.get("loss_scale") == "noop_instance":
            case["loss_scale"] = NoOpScale()
        try:
            DigitsTrainer(train_path=os.path.join(subset, "train"), val_path=os.path.join(subset, "test"),
                          labels=digits_data.LABELS, height=32, width=32, max_epoch=1, batch_size=batch,
                          save_folder=os.path.join(os.path.dirname(out), "refused"), progress=False, **case)
            record["refusals"].append(None)
        except Exception as e:
            record["refusals"].append([type(e).__name__, str(e)])
    with open(out + ".json", "w") as f:
        json.dump(record, f)
    """
)


def _subset(tree, root):
    """The first ``SUBSET`` files of each digit of ``tree``, in a tree of the same form."""
    for split, n in SUBSET.items():
        for label in digits_data.LABELS:
            os.makedirs(os.path.join(root, split, label))
            for f in sorted(os.listdir(os.path.join(tree, split, label)))[:n]:
                shutil.copy(os.path.join(tree, split, label, f), os.path.join(root, split, label, f))
    with open(os.path.join(root, ".complete"), "w") as f:
        f.write("ok\n")


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    base = tmp_path_factory.mktemp("digits")
    port_tree, subset = str(base / "port"), str(base / "subset")
    counts = digits_data.materialize(port_tree)
    _subset(port_tree, subset)
    out = str(base / "jax" / "init.npz")
    os.makedirs(os.path.dirname(out))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    for knob in ("PYTHONPATH", "PALLAS", "DTYPE", "MESH", "TELEMETRY", "CHAIN_STEPS", "DIGITS_LR"):
        env.pop(knob, None)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, out, str(base / "jax_tree"), subset, str(BATCH), str(EPOCHS),
         json.dumps(NARROW), json.dumps(REFUSALS)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out + ".json") as f:
        record = json.load(f)
    return {"counts": counts, "port_tree": port_tree, "jax_tree": str(base / "jax_tree"), "subset": subset,
            "params": _unflatten(dict(np.load(out))), "record": record}


def test_the_tree_is_the_jax_tree(sides):
    assert sides["counts"] == sides["record"]["counts"] == {"train": 1438, "test": 359}
    for split in ("train", "test"):
        for label in digits_data.LABELS:
            mine = sorted(os.listdir(os.path.join(sides["port_tree"], split, label)))
            theirs = sorted(os.listdir(os.path.join(sides["jax_tree"], split, label)))
            assert mine == theirs, (split, label)
            for f in mine:
                a = cv2.imread(os.path.join(sides["port_tree"], split, label, f))
                b = cv2.imread(os.path.join(sides["jax_tree"], split, label, f))
                assert a.shape == (32, 32, 3) and np.array_equal(a, b), (split, label, f)
    assert digits_data.materialize(sides["port_tree"]) == sides["counts"]  # the marker: a no-op


def test_the_corpus_is_the_sklearn_digits():
    from sklearn.datasets import load_digits

    images, targets = digits_data.load_digits()
    ref = load_digits()
    assert images.dtype == np.float64 and np.array_equal(images, ref.images)
    assert np.array_equal(targets, ref.target)


class _Recorded(train_digits.DigitsTrainer):
    record = None

    def build_model(self):
        return create_model("vgg16", num_classes=len(self.labels), dtype=self.precision.compute_dtype,
                            device=self.device, **NARROW)

    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


def test_digits_trainer_tracks_the_jax_trainer(sides, tmp_path, monkeypatch):
    for knob in ("DTYPE", "MESH", "TELEMETRY", "SNAPSHOT", "SAVE_PERIOD"):
        monkeypatch.delenv(knob, raising=False)
    record = {"train": [], "val": []}
    monkeypatch.setattr(_Recorded, "record", record)
    monkeypatch.setattr(train_digits, "DigitsTrainer", _Recorded)
    trainer = train_digits.build_trainer(sides["subset"], str(tmp_path), "cpu", max_epoch=EPOCHS, batch_size=BATCH,
                                         save_period=1, last_save_period=EPOCHS, save_best_for=None, logger=None)
    trainer.model.load_state_dict(vgg_params_from_jax(sides["params"]))
    assert len(trainer.train_dataloader) == 10 * SUBSET["train"] // BATCH
    trainer.train()
    ref = sides["record"]
    assert trainer.state.step == ref["final_step"] == EPOCHS * len(trainer.train_dataloader)
    assert len(record["train"]) == len(ref["train"]) == EPOCHS == len(record["val"]) == len(ref["val"])
    for epoch in range(EPOCHS):
        for split in ("train", "val"):
            for k in ("ce_loss", "accuracy"):
                np.testing.assert_allclose(record[split][epoch][k], ref[split][epoch][k], rtol=RTOL,
                                           err_msg=f"{split} {k}, epoch {epoch}")
        np.testing.assert_allclose(record["train"][epoch]["lr"], ref["train"][epoch]["lr"], rtol=1e-6)
    assert record["train"][0]["lr"] == pytest.approx(0.02)


def test_main_trains_evaluates_and_resumes(sides, tmp_path, monkeypatch):
    tree = str(tmp_path / "tree")
    shutil.copytree(sides["subset"], tree)
    save = str(tmp_path / "run")
    for knob in ("DTYPE", "MESH", "TELEMETRY", "SNAPSHOT", "PALLAS"):
        monkeypatch.delenv(knob, raising=False)
    for key, value in {"DIGITS_DIR": tree, "SAVE_DIR": save, "EPOCHS": "2", "BATCH": "16", "SAVE_PERIOD": "1",
                       "DEVICE": "cpu"}.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(train_digits.DigitsTrainer, "build_model", _Recorded.build_model)
    trainer, summary = train_digits.main()
    with open(os.path.join(save, "summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert summary["train_images"] == 80 and summary["test_images"] == 30 and summary["epochs"] == 2
    assert set(summary["results"]) == {"best", "last"}
    for scores in summary["results"].values():
        assert 0.0 <= scores["top1"] <= scores["top2"] <= 1.0
    assert [c["epoch"] for c in summary["curve"]] == [1, 2] and "val_acc" in summary["curve"][0]
    assert all(np.isfinite(c["train_ce"]) for c in summary["curve"])
    steps = trainer.state.step
    monkeypatch.setenv("EPOCHS", "3")
    monkeypatch.setenv("SNAPSHOT", "last")
    resumed, _ = train_digits.main()
    assert (resumed.state.step, resumed.cur_epoch) == (steps * 3 // 2, 2)


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_loss_scale_refusals_match_the_jax_trainer(sides, tmp_path, i):
    from distributed_training_pytorch_tpu_torch.precision import NoOpScale

    case = dict(REFUSALS[i])
    if case.get("loss_scale") == "noop_instance":
        case["loss_scale"] = NoOpScale()
    with pytest.raises(Exception) as err:
        train_digits.DigitsTrainer(train_path=os.path.join(sides["subset"], "train"),
                                   val_path=os.path.join(sides["subset"], "test"), labels=digits_data.LABELS,
                                   height=32, width=32, max_epoch=1, batch_size=BATCH, save_folder=str(tmp_path),
                                   device="cpu", **case)
    want = sides["record"]["refusals"][i]
    assert want is not None and [type(err.value).__name__, str(err.value)] == want


def test_the_entry_refuses_what_is_not_ported(sides, monkeypatch, tmp_path):
    # TELEMETRY=1 is ported: the entry's trainer runs with telemetry on
    monkeypatch.setenv("TELEMETRY", "1")
    telemetered = train_digits.build_trainer(sides["subset"], str(tmp_path), "cpu")
    assert telemetered.telemetry is not None and telemetered.engine.stats
    monkeypatch.delenv("TELEMETRY")
    monkeypatch.setenv("MESH", "fsdp2x1")  # ported: two ranks, which a world of one is not
    with pytest.raises(ValueError, match="does not fit a world of 1 ranks"):
        train_digits.build_trainer(str(tmp_path), str(tmp_path), "cpu")
    monkeypatch.setenv("MESH", "ep2x1")  # ported too: two ranks of an expert group
    with pytest.raises(ValueError, match="does not fit a world of 1 ranks"):
        train_digits.build_trainer(str(tmp_path), str(tmp_path), "cpu")
