"""The port's CIFAR-10 entry (``distributed_training_pytorch_tpu_torch/examples/
train_cifar10.py``) through its ``Trainer``, its loader workers and ``device_prefetch``,
held against the JAX package's entry (``examples/train_cifar10.py``) on the CPU.

Both entries read the same tiny canonical pickle set written here (5 train batches of 64
images and a test batch of 100, class-separable), with ``DTYPE=fp32``, global batch 32
(10 steps an epoch; the val set padded to 4 batches), validation before every epoch
(``save_period=1``), 2 epochs and then a third resumed from ``last``. Both entries'
``build_model`` is overridden in the same way: VGG16 at narrow widths with dropout 0
(threefry and Philox masks can never match); the port starts from the JAX run's initial
weights (``models/convert.py::vgg_params_from_jax``). The JAX side runs in a subprocess
with a stand-in ``data.streaming`` module, as ``tests/test_torch_trainer_lm.py`` does.

Two host paths: ``native`` (the native crop/flip, uint8 batches normalised on the device
by ``InputNormalizer``) and ``python`` (the library reported unavailable on both sides:
the per-record ``Cifar10Transform``, normalised on the host). Tolerance: per-epoch train
CE, train accuracy, val CE and val accuracy within 1e-4 relative (f32 in other summation
orders), the lr within 1e-6 relative, and the resume's step and epoch exact.

The entry's default recipe (``BASE_LR`` 0.1 at batch 1024, an lr of 0.4) is held too:
``BASE_LR`` 3.2 at batch 32 gives the same lr. At the narrow widths both entries stay
finite and track each other within 1e-4 through the lr's rise to 0.4; at wider ones
(``WIDE``: convolutions up to 256 channels, a 1024-wide classifier; 3 epochs, then a
resumed fourth) both lose the loss to a non-finite value in the same epoch, after the
first epoch agreed within 1e-4 (the epochs between grow f32 rounding differences without
bound, so they are not compared).
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.data import native
from distributed_training_pytorch_tpu_torch.examples import train_cifar10
from distributed_training_pytorch_tpu_torch.models import InputNormalizer, create_model, vgg_params_from_jax
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, EPOCHS, PER_FILE, N_TEST = 32, 2, 64, 100
NARROW = dict(stage_features=[8, 8, 16, 16, 16], classifier_widths=[32, 32], dropout_rate=0.0)
WIDE = dict(stage_features=[32, 64, 128, 256, 256], classifier_widths=[1024, 1024], dropout_rate=0.0)
DEFAULT_LR = 0.1 * 1024 / 256  # the entry's lr at its defaults, BASE_LR 0.1 and BATCH 1024
WIDE_EPOCHS = 3  # then one resumed epoch: the wide model diverges within the run
RTOL = 1e-4

_JAX_SIDE = textwrap.dedent(
    """
    import fcntl, json, os, sys, types
    import numpy as np

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    out, data_dir, mode, batch, epochs, narrow, base_lr = sys.argv[1:8]
    batch, epochs, narrow, base_lr = int(batch), int(epochs), json.loads(narrow), float(base_lr)
    from distributed_training_pytorch_tpu.data import native
    os.makedirs("build", exist_ok=True)
    with open("build/.jax_native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one make at a time across test processes
        assert native.available(), "the JAX package's native library did not build"
    if mode == "python":
        native.available = lambda: False
    import jax.numpy as jnp
    import examples.train_cifar10 as entry
    from distributed_training_pytorch_tpu.models import InputNormalizer, create_model

    record = {"train": [], "val": []}

    class Recorded(entry.Cifar10Trainer):
        def build_model(self):
            model = create_model("vgg16", num_classes=10, dtype=jnp.float32, pallas=entry.PALLAS, **narrow)
            if self._device_normalize:
                model = InputNormalizer(model, mean=tuple(entry.CIFAR_MEAN), std=tuple(entry.CIFAR_STD))
            return model

        def train_epoch(self, epoch):
            record["train"].append({k: float(v) for k, v in super().train_epoch(epoch).items()})
            return record["train"][-1]

        def validate(self):
            record["val"].append({k: float(v) for k, v in super().validate().items()})
            return record["val"][-1]

    def build(max_epoch, snapshot):
        return Recorded(data_dir=data_dir, base_lr=base_lr, max_epoch=max_epoch, batch_size=batch, have_validate=True,
                        save_best_for=("accuracy", "geq"), save_period=1, snapshot_path=snapshot,
                        save_folder=os.path.join(os.path.dirname(out), "jax_run"), progress=False,
                        async_checkpoint=False)

    first = build(epochs, None)
    flat = {}
    def flatten(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                flatten(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)
    flatten(first.state.params)
    np.savez(out, **flat)
    first.train()
    resumed = build(epochs + 1, "last")
    record["resumed_at"] = [int(resumed.state.step), int(resumed.cur_epoch)]
    resumed.train()
    record["final_step"] = int(resumed.state.step)
    with open(out + ".json", "w") as f:
        json.dump(record, f)
    """
)


def _write_pickles(data_dir):
    """A class-separable CIFAR-shaped set in the canonical pickle layout (rows of 3072
    bytes, channel-major)."""
    os.makedirs(data_dir)
    rng = np.random.RandomState(21)

    def batch(n):
        y = rng.randint(0, 10, size=(n,))
        x = (rng.randn(n, 32, 32, 3) * 40 + 80 + y[:, None, None, None] * 12).clip(0, 255).astype(np.uint8)
        return {b"data": x.transpose(0, 3, 1, 2).reshape(n, 3072), b"labels": [int(v) for v in y]}

    for i in range(1, 6):
        with open(os.path.join(data_dir, f"data_batch_{i}"), "wb") as f:
            pickle.dump(batch(PER_FILE), f)
    with open(os.path.join(data_dir, "test_batch"), "wb") as f:
        pickle.dump(batch(N_TEST), f)


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
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cifar") / "cifar-10-batches-py")
    _write_pickles(path)
    return path


_JAX_RUNS = {}


def _jax_run(data_dir, mode, tmp_path_factory, base_lr=0.1, widths=NARROW, epochs=EPOCHS):
    key = (mode, base_lr, json.dumps(widths), epochs)
    if key not in _JAX_RUNS:
        out = str(tmp_path_factory.mktemp(f"jax_cifar_{mode}") / "init.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
                   DTYPE="fp32")
        for knob in ("PYTHONPATH", "PALLAS", "TUNED", "TELEMETRY", "MESH", "CHAIN_STEPS"):
            env.pop(knob, None)
        proc = subprocess.run(
            [sys.executable, "-c", _JAX_SIDE, out, data_dir, mode, str(BATCH), str(epochs), json.dumps(widths),
             str(base_lr)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
        )
        assert proc.returncode == 0, proc.stderr[-4000:]
        with open(out + ".json") as f:
            _JAX_RUNS[key] = (_unflatten(dict(np.load(out))), json.load(f))
    return _JAX_RUNS[key]


class _Recorded(train_cifar10.Cifar10Trainer):
    """The entry's trainer with the test's narrow VGG16 (the JAX side's override) and
    each epoch's metrics and train batches' image dtype recorded."""

    def __init__(self, record, widths=NARROW, **kw):
        self.record, self.widths = record, widths
        super().__init__(**kw)

    def build_model(self):
        model = create_model("vgg16", num_classes=10, dtype=torch.float32, pallas=self.pallas, device=self.device,
                             **self.widths)
        if self.native_augment:
            model = InputNormalizer(model, mean=list(train_cifar10.CIFAR_MEAN), std=list(train_cifar10.CIFAR_STD))
        return model

    def train_step(self, state, batch):
        self.record["image_dtypes"].add(batch["image"].dtype)
        return super().train_step(state, batch)

    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


def _port_run(data_dir, tmp_path, monkeypatch, mode, params, base_lr=0.1, widths=NARROW, epochs=EPOCHS):
    """The port's entry from the JAX run's initial weights: ``epochs`` epochs, then one
    resumed from ``last``; returns the record and the resume's (step, epoch) at its start
    and its final step."""
    monkeypatch.setenv("DTYPE", "fp32")
    for knob in ("PALLAS", "TUNED", "TELEMETRY", "MESH", "CHAIN_STEPS"):
        monkeypatch.delenv(knob, raising=False)
    if mode == "python":
        monkeypatch.setattr(native, "available", lambda: False)
    record = {"train": [], "val": [], "image_dtypes": set()}

    def build(max_epoch, snapshot):
        return _Recorded(record, widths, data_dir=data_dir, base_lr=base_lr, max_epoch=max_epoch, batch_size=BATCH,
                         have_validate=True, save_best_for=("accuracy", "geq"), save_period=1,
                         snapshot_path=snapshot, save_folder=str(tmp_path), device="cpu")

    first = build(epochs, None)
    assert first.num_workers == 8 and first.train_dataloader.num_workers == 8
    assert first.train_dataloader._batch_fast_path() == ("arrays" if mode == "native" else None)
    first.model.load_state_dict(vgg_params_from_jax(params))
    first.train()
    resumed = build(epochs + 1, "last")
    resumed_at = [resumed.state.step, resumed.cur_epoch]
    resumed.train()
    assert len(record["train"]) == epochs + 1 == len(record["val"])
    return record, resumed_at, resumed.state.step


def _assert_epochs_agree(record, ref, epochs):
    for epoch in epochs:
        g, r = record["train"][epoch], ref["train"][epoch]
        for k in ("ce_loss", "accuracy"):
            np.testing.assert_allclose(g[k], r[k], rtol=RTOL, err_msg=f"train {k}, epoch {epoch}")
        gv, rv = record["val"][epoch], ref["val"][epoch]
        for k in ("ce_loss", "accuracy"):
            np.testing.assert_allclose(gv[k], rv[k], rtol=RTOL, err_msg=f"val {k}, epoch {epoch}")


@pytest.mark.parametrize("mode", ["native", "python"])
def test_cifar10_entry_tracks_the_jax_entry(data_dir, tmp_path, tmp_path_factory, monkeypatch, mode):
    params, ref = _jax_run(data_dir, mode, tmp_path_factory)
    record, resumed_at, final_step = _port_run(data_dir, tmp_path, monkeypatch, mode, params)
    assert resumed_at == ref["resumed_at"] == [EPOCHS * 10, EPOCHS]
    assert final_step == ref["final_step"] == (EPOCHS + 1) * 10
    assert record["image_dtypes"] == ({torch.uint8} if mode == "native" else {torch.float32})
    assert len(ref["train"]) == EPOCHS + 1 == len(ref["val"])
    _assert_epochs_agree(record, ref, range(EPOCHS + 1))
    for g, r in zip(record["train"], ref["train"], strict=True):
        np.testing.assert_allclose(g["lr"], r["lr"], rtol=1e-6)
    assert record["train"][-1]["ce_loss"] < record["train"][0]["ce_loss"]


@pytest.mark.parametrize("widths", ["narrow", "wide"])
def test_cifar10_entry_at_the_default_lr_matches_the_jax_entry(data_dir, tmp_path, tmp_path_factory, monkeypatch,
                                                               widths):
    """The default recipe's lr of 0.4: the narrow model stays finite on both sides and the
    epochs agree; the wide one turns non-finite on both sides in the same epoch."""
    base_lr = DEFAULT_LR * 256 / BATCH
    shape, epochs = (NARROW, EPOCHS) if widths == "narrow" else (WIDE, WIDE_EPOCHS)
    params, ref = _jax_run(data_dir, "native", tmp_path_factory, base_lr, shape, epochs)
    record, resumed_at, final_step = _port_run(data_dir, tmp_path, monkeypatch, "native", params, base_lr, shape,
                                               epochs)
    assert resumed_at == ref["resumed_at"] and final_step == ref["final_step"]
    lrs = [g["lr"] for g in record["train"]]
    np.testing.assert_allclose(lrs, [r["lr"] for r in ref["train"]], rtol=1e-6)
    assert max(lrs) > 0.3  # the epochs' mean lr: the schedule reaches 0.4 in the last epoch
    finite = [bool(np.isfinite(g["ce_loss"])) for g in record["train"]]
    assert finite == [bool(np.isfinite(r["ce_loss"])) for r in ref["train"]]
    if widths == "narrow":
        assert all(finite)
        _assert_epochs_agree(record, ref, range(epochs + 1))
    else:
        assert finite[0] and not finite[-1]
        _assert_epochs_agree(record, ref, [0])


def test_unported_knobs_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("SAVE_DIR", str(tmp_path))
    monkeypatch.setenv("CIFAR10_DIR", str(tmp_path / "absent"))
    monkeypatch.setenv("TUNED", "1")
    with pytest.raises(NotImplementedError, match="P17"):
        train_cifar10.build_trainer("cpu")
    monkeypatch.delenv("TUNED")
    # TELEMETRY=1 is ported: the entry's trainer is built with telemetry on (a small
    # stand-in data set: the synthetic one holds 60,000 images)
    monkeypatch.setenv("TELEMETRY", "1")
    rng = np.random.RandomState(0)
    small = (rng.randint(0, 256, (16, 32, 32, 3)).astype(np.uint8), rng.randint(0, 10, 16).astype(np.int32),
             rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8), rng.randint(0, 10, 8).astype(np.int32))
    monkeypatch.setattr(train_cifar10, "load_cifar10", lambda data_dir: small)
    trainer = train_cifar10.build_trainer("cpu")
    assert trainer.telemetry is not None and trainer.engine.stats

