"""ResNet18Slim trained to accuracy through record files: the at-scale input path on real data.

Counterpart of the repository's ``examples/train_records.py``. The digits tree
(``digits_data.py``) is packed once into 4 train and 2 test record shards
(``data.records.pack_image_folder``); ``NativeRecordTrainSource`` decodes, resizes and
crops them (crop only: ``hflip=False``, a mirrored digit is not a digit) into uint8
batches, which ``InputNormalizer`` normalises on the device; ``NativeRecordFileSource``
decodes, resizes and normalises the test shards for validation. ``ResNet18Slim`` trains
with SGD (momentum 0.9, weight decay 1e-4) at ``lr = RECORDS_LR * batch / 256``, 5 warmup
epochs then a cosine. Each saved checkpoint is then scored with ``eval.evaluate`` through
the independent image-folder path, on the loose test files, so a fault anywhere in the
packing, decoding or augmentation shows as a gap in top-1. Run:

    python -m distributed_training_pytorch_tpu_torch.examples.train_records

Env knobs, as the JAX entry reads them: ``DIGITS_DIR`` (``./data/digits``), ``RECORDS_DIR``
(``<DIGITS_DIR>/records``), ``EPOCHS`` (60), ``BATCH`` (128, global), ``RECORDS_LR`` (0.1),
``SAVE_DIR`` (``./runs/records_digits``), ``SAVE_PERIOD`` (10), ``SNAPSHOT``, ``DTYPE``
(``fp32`` | ``bf16`` | ``fp16``; unset keeps a bf16 model under the f32 policy), ``PALLAS``
(the 1x1 kernel for ResNet's stage-1 1x1s with 1; at 32x32 no 1x1 reaches the kernel's
56-pixel minimum), ``CHAIN_STEPS`` (1) and ``MESH`` (``dpN``). ``TELEMETRY=1`` raises until
the observability slice. The port adds ``DEVICE`` (``cuda`` unless set to ``cpu``).
"""

from __future__ import annotations

import json
import os

import torch

from distributed_training_pytorch_tpu_torch.data import (
    NativeRecordFileSource,
    NativeRecordTrainSource,
    pack_image_folder,
)
from distributed_training_pytorch_tpu_torch.data import transforms as T
from distributed_training_pytorch_tpu_torch.examples.digits_data import LABELS, SIZE, materialize
from distributed_training_pytorch_tpu_torch.examples.train_digits import evaluate_saved, parse_curve
from distributed_training_pytorch_tpu_torch.models import InputNormalizer, ResNet18Slim
from distributed_training_pytorch_tpu_torch.ops.dispatch import pallas_from_env
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.ops.metrics import accuracy
from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_from_env
from distributed_training_pytorch_tpu_torch.precision import model_dtype_for_entry
from distributed_training_pytorch_tpu_torch.trainer import Trainer
from distributed_training_pytorch_tpu_torch.utils import Logger

__all__ = ["RecordsDigitsTrainer", "build_trainer", "main", "pack_digits"]


def pack_digits(digits_dir: str, records_dir: str) -> dict:
    """The digits tree as record shards (4 train, 2 test), once (a ``.complete`` marker);
    returns each split's glob."""
    marker = os.path.join(records_dir, ".complete")
    if not os.path.exists(marker):
        for split, shards in (("train", 4), ("test", 2)):
            pack_image_folder(os.path.join(digits_dir, split), LABELS, os.path.join(records_dir, split),
                              num_shards=shards)
        with open(marker, "w") as f:
            f.write("ok\n")
    return {split: os.path.join(records_dir, f"{split}-*.rec") for split in ("train", "test")}


class RecordsDigitsTrainer(Trainer):
    """ResNet18Slim on the digits record shards; ``precision`` defaults to ``DTYPE``."""

    # the masked metrics weight padded validation rows out
    criterion_uses_mask = True

    def __init__(self, train_pattern: str, val_pattern: str, base_lr: float, **kw):
        self.train_pattern = train_pattern
        self.val_pattern = val_pattern
        self.base_lr = base_lr
        self.dtype_env = os.environ.get("DTYPE") or None
        self.pallas = pallas_from_env()
        kw.setdefault("precision", self.dtype_env)
        super().__init__(**kw)

    def build_train_dataset(self):
        return NativeRecordTrainSource(self.train_pattern, SIZE, SIZE, pad=4, seed=self.seed, hflip=False)

    def build_val_dataset(self):
        # float32, normalised on the host in the same native call; InputNormalizer passes
        # float batches through
        return NativeRecordFileSource(self.val_pattern, height=SIZE, width=SIZE)

    def build_model(self):
        explicit = self.dtype_env is not None or self.precision_requested
        inner = ResNet18Slim(
            num_classes=len(LABELS),
            dtype=model_dtype_for_entry(self.precision, explicit, torch.bfloat16),
            pallas=self.pallas,
            device=self.device,
        )
        return InputNormalizer(inner, mean=list(T.IMAGENET_MEAN), std=list(T.IMAGENET_STD))

    def build_criterion(self):
        def criterion(logits, batch):
            mask = batch.get("mask")
            loss = cross_entropy_loss(logits, batch["label"], weights=mask)
            return loss, {"ce_loss": loss, "accuracy": accuracy(logits, batch["label"], weights=mask)}

        return criterion

    def build_loss_fn(self):
        """The loader's NHWC images as the NCHW view the model takes, then the criterion."""
        criterion = self.criterion

        def loss_fn(model, batch, train):
            return criterion(model(batch["image"].permute(0, 3, 1, 2)), batch)

        return loss_fn

    def build_scheduler(self):
        steps_per_epoch = max(1, len(self.train_dataset) // self.batch_size)
        lr = self.base_lr * self.batch_size / 256.0  # Goyal et al. scaling
        return warmup_cosine_lr(lr, self.max_epoch, steps_per_epoch, warmup_epochs=5)

    def build_optimizer(self, schedule):
        """``optax.chain(add_decayed_weights(1e-4), sgd(schedule, momentum=0.9))``, which is
        torch's SGD; the engine sets the lr from the schedule."""
        return torch.optim.SGD(self.model.parameters(), lr=float(schedule(0)), momentum=0.9, weight_decay=1e-4)


def build_trainer(patterns: dict, save_dir: str, device: "str | None" = None, **overrides) -> RecordsDigitsTrainer:
    """The entry's trainer over ``patterns`` (``pack_digits``'s), from the env knobs;
    ``overrides`` replace any of its arguments."""
    if os.environ.get("TELEMETRY") == "1":
        raise NotImplementedError("TELEMETRY comes with the observability slice of the port")
    save_period = int(os.environ.get("SAVE_PERIOD", "10"))
    kwargs = dict(
        train_pattern=patterns["train"],
        val_pattern=patterns["test"],
        base_lr=float(os.environ.get("RECORDS_LR", "0.1")),
        max_epoch=int(os.environ.get("EPOCHS", "60")),
        batch_size=int(os.environ.get("BATCH", "128")),
        chain_steps=int(os.environ.get("CHAIN_STEPS", "1")),
        mesh=mesh_from_env(),
        have_validate=True,
        save_best_for=("accuracy", "geq"),
        save_period=save_period,
        last_save_period=save_period,
        save_folder=save_dir,
        snapshot_path=os.environ.get("SNAPSHOT") or None,
        device=device or os.environ.get("DEVICE", "cuda"),
    )
    kwargs.update(overrides)
    if "logger" not in kwargs:
        kwargs["logger"] = Logger("records-digits", os.path.join(save_dir, "logfile.log"))
    return RecordsDigitsTrainer(**kwargs)


def main(device: "str | None" = None) -> "tuple[RecordsDigitsTrainer, dict]":
    """Materialise and pack the corpus, train, evaluate the saved checkpoints through the
    image-folder path, write ``summary.json``; returns the trainer and the summary."""
    digits_dir = os.environ.get("DIGITS_DIR", "./data/digits")
    records_dir = os.environ.get("RECORDS_DIR", os.path.join(digits_dir, "records"))
    save_dir = os.environ.get("SAVE_DIR", "./runs/records_digits")
    counts = materialize(digits_dir)
    patterns = pack_digits(digits_dir, records_dir)
    print(f"digits corpus: {counts}; records under {records_dir}")
    Trainer.distributed_setup()
    trainer = build_trainer(patterns, save_dir, device)
    trainer.train()
    results = evaluate_saved(trainer, save_dir, os.path.join(digits_dir, "test"), LABELS, SIZE)
    summary = {
        "pipeline": "pack_image_folder -> NativeRecordTrainSource (decode, resize, crop; uint8) -> InputNormalizer "
                    "-> Trainer -> checkpoint -> examples/eval.py (the image-folder path)",
        "model": "ResNet18Slim",
        "corpus": "UCI handwritten digits as scikit-learn ships them, packed into 4 train + 2 test record shards",
        "train_images": counts["train"],
        "test_images": counts["test"],
        "epochs": trainer.max_epoch,
        "batch": trainer.batch_size,
        "base_lr": trainer.base_lr,
        "precision": trainer.precision.name,
        "results": results,
        "curve": parse_curve(os.path.join(save_dir, "logfile.log")),
    }
    if trainer.rank == 0:
        with open(os.path.join(save_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print("summary ->", os.path.join(save_dir, "summary.json"))
    Trainer.destroy_process()
    return trainer, summary


if __name__ == "__main__":
    main()
