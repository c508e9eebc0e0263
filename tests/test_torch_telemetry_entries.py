"""``TELEMETRY=1`` through the port's five training entries on the CPU, and ``PROFILE_DIR``
through the LM and ImageNet entries (as the JAX entries honour both), each at the
smallest size that trains one epoch: the event log opens with ``run_start`` and closes
with ``run_end``, the epoch's record carries the health stats and the step time, and
``PROFILE_DIR`` holds a trace of the first epoch's steps."""

import os
import shutil

import numpy as np
import pytest

from distributed_training_pytorch_tpu_torch.examples import (
    digits_data,
    example_trainer,
    train_cifar10,
    train_digits,
    train_imagenet,
    train_lm,
    train_records,
)
from distributed_training_pytorch_tpu_torch.profiling import latest_trace_file
from distributed_training_pytorch_tpu_torch.telemetry import load_run_events

KNOBS = ("TELEMETRY", "PROFILE_DIR", "SAVE_DIR", "EPOCHS", "BATCH", "DTYPE", "MESH", "SNAPSHOT", "CHAIN_STEPS",
         "LM_SIZE", "SEQ_LEN", "LM_CORPUS", "MODEL", "IMAGE_SIZE", "STEPS_PER_EPOCH", "NUM_CLASSES", "PALLAS",
         "CIFAR10_DIR", "TUNED", "IMAGENET_RECORDS", "VAL_RECORDS", "SAVE_PERIOD")
# VGG16 at a narrow width for the CIFAR and digits entries (their path is the same).
NARROW = dict(stage_features=(4, 8, 8, 16, 16), classifier_widths=(32, 24), dropout_rate=0.0)


def _narrow_vgg(module, monkeypatch):
    real = module.create_model
    monkeypatch.setattr(module, "create_model", lambda name, **kw: real(name, **{**kw, **NARROW}))


@pytest.fixture(scope="module")
def digits_subset(tmp_path_factory):
    base = tmp_path_factory.mktemp("entries")
    tree, subset = str(base / "tree"), str(base / "subset")
    digits_data.materialize(tree)
    for split in ("train", "test"):
        for label in digits_data.LABELS:
            os.makedirs(os.path.join(subset, split, label))
            for f in sorted(os.listdir(os.path.join(tree, split, label)))[:2]:
                shutil.copy(os.path.join(tree, split, label, f), os.path.join(subset, split, label, f))
    return subset


def _build(entry, tmp_path, monkeypatch, subset):
    save = str(tmp_path / "run")
    monkeypatch.setenv("SAVE_DIR", save)
    monkeypatch.setenv("EPOCHS", "1")
    if entry == "lm":
        rng = np.random.RandomState(0)
        monkeypatch.setattr(train_lm, "load_windows",
                            lambda seq_len, path=None: rng.randint(0, 256, size=(40, seq_len + 1)).astype(np.int32))
        monkeypatch.setenv("LM_SIZE", "tiny")
        monkeypatch.setenv("SEQ_LEN", "16")
        monkeypatch.setenv("BATCH", "8")
        return train_lm.build_trainer("cpu"), save
    if entry == "imagenet":
        for k, v in (("MODEL", "resnet50"), ("IMAGE_SIZE", "32"), ("BATCH", "4"), ("STEPS_PER_EPOCH", "2"),
                     ("NUM_CLASSES", "5")):
            monkeypatch.setenv(k, v)
        return train_imagenet.build_trainer("cpu", synthetic_records=8, synthetic_val_records=4), save
    if entry == "cifar10":
        rng = np.random.RandomState(0)
        data = (rng.randint(0, 256, (16, 32, 32, 3)).astype(np.uint8), rng.randint(0, 10, 16).astype(np.int32),
                rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8), rng.randint(0, 10, 8).astype(np.int32))
        monkeypatch.setattr(train_cifar10, "load_cifar10", lambda data_dir: data)
        _narrow_vgg(train_cifar10, monkeypatch)
        monkeypatch.setenv("BATCH", "8")
        return train_cifar10.build_trainer("cpu"), save
    if entry == "digits":
        real = example_trainer.VGG16
        monkeypatch.setattr(example_trainer, "VGG16", lambda **kw: real(**{**kw, **NARROW}))
        return train_digits.build_trainer(subset, save, "cpu", max_epoch=1, batch_size=16), save
    patterns = train_records.pack_digits(subset, str(tmp_path / "records"))
    return train_records.build_trainer(patterns, save, "cpu", max_epoch=1, batch_size=16), save


@pytest.mark.parametrize("entry", ["lm", "imagenet", "cifar10", "digits", "records"])
def test_telemetry_trains_through_the_entry(entry, digits_subset, tmp_path, monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("TELEMETRY", "1")
    profiled = entry in ("lm", "imagenet")
    if profiled:
        monkeypatch.setenv("PROFILE_DIR", str(tmp_path / "profile"))
    trainer, save = _build(entry, tmp_path, monkeypatch, digits_subset)
    trainer.train()
    evs = load_run_events(save)
    kinds = [e["event"] for e in evs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end", kinds
    epoch = next(e for e in evs if e["event"] == "epoch_end")
    assert {"grad_norm", "update_ratio", "step_ms", "steps"} <= set(epoch)
    assert all(np.isfinite(epoch[k]) for k in ("grad_norm", "step_ms"))
    if profiled:
        assert latest_trace_file(str(tmp_path / "profile")) is not None
