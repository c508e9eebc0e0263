"""VGG16 trained to accuracy on real data: the digits corpus, end to end.

Counterpart of the repository's ``examples/train_digits.py``: materialise the digits tree
(``digits_data.py``: 1,438 train and 359 test images, 32x32 PNG), train the
``ExampleTrainer`` stack on it (VGG16, SGD with momentum 0.9 and weight decay 1e-4,
MultiStepLR at epochs 50, 100 and 200), save ``best`` and ``last``, evaluate each saved
checkpoint with ``eval.evaluate`` (top-1 and top-2 on the test folder), and write
``summary.json`` with the results and the training curve. Run:

    python -m distributed_training_pytorch_tpu_torch.examples.train_digits

The recipe's two departures from the reference's, as the JAX entry has them: the train
chain keeps the photometric steps and drops rotate90 and the flips (a mirrored 2 or a
rotated 6 is not a digit), and the base lr is 0.02 (``DIGITS_LR``; VGG16 has no
BatchNorm).

Env knobs, as the JAX entry reads them: ``DIGITS_DIR`` (``./data/digits``), ``EPOCHS``
(150), ``BATCH`` (128, global), ``DIGITS_LR`` (0.02), ``SAVE_DIR`` (``./runs/digits``),
``SAVE_PERIOD`` (25: validation and ``last``), ``SNAPSHOT``, ``DTYPE`` (``fp32`` | ``bf16``
| ``fp16``, default fp32; fp16 trains with dynamic loss scaling), ``PALLAS`` (consumed:
VGG16 runs no kernel), ``CHAIN_STEPS`` (1) and ``MESH`` (``dpN``). ``TELEMETRY=1`` raises
until the observability slice. The port adds ``DEVICE`` (``cuda`` unless set to ``cpu``).
"""

from __future__ import annotations

import json
import os
import re

from distributed_training_pytorch_tpu_torch.data import ImageFolderDataSource
from distributed_training_pytorch_tpu_torch.data.transforms import (
    Compose,
    clahe,
    normalize,
    random_brightness_contrast,
    random_gamma,
    resize,
)
from distributed_training_pytorch_tpu_torch.examples.digits_data import LABELS, SIZE, materialize
from distributed_training_pytorch_tpu_torch.examples.example_trainer import ExampleTrainer
from distributed_training_pytorch_tpu_torch.ops.dispatch import pallas_from_env
from distributed_training_pytorch_tpu_torch.ops.schedules import multistep_lr
from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_from_env
from distributed_training_pytorch_tpu_torch.train import unwrap
from distributed_training_pytorch_tpu_torch.trainer import Trainer
from distributed_training_pytorch_tpu_torch.utils import Logger

__all__ = ["DigitsTrainer", "build_trainer", "digits_train_transform", "evaluate_saved", "main", "parse_curve"]


def digits_train_transform(height: int, width: int, *, seed: int = 0, p: float = 0.5) -> Compose:
    """The reference's train chain without its orientation steps: resize, CLAHE,
    brightness/contrast, gamma, normalise."""
    return Compose(
        [resize(height, width), clahe(p), random_brightness_contrast(p), random_gamma(p), normalize()],
        seed=seed,
    )


class DigitsTrainer(ExampleTrainer):
    base_lr = float(os.environ.get("DIGITS_LR", "0.02"))
    # the kernel-policy knob, resolved at the entry (VGG16 consumes it as a no-op)
    pallas = pallas_from_env()

    def build_train_dataset(self):
        return ImageFolderDataSource(
            self.train_path, self.labels, transform=digits_train_transform(self.height, self.width, seed=self.seed)
        )

    def build_scheduler(self):
        steps_per_epoch = max(1, len(self.train_dataset) // self.batch_size)
        return multistep_lr(self.base_lr, [50, 100, 200], gamma=0.1, steps_per_epoch=steps_per_epoch)


def parse_curve(logfile: str) -> "list[dict]":
    """Per-epoch train CE and val accuracy from the run's logfile."""
    curve: "dict[int, dict]" = {}
    epoch = None
    with open(logfile) as f:
        for line in f:
            m = re.search(r"Epoch (\d+)/", line)
            if m:
                epoch = int(m.group(1))
            if "TOTAL GLOBAL TRAINING LOSS" in line and epoch is not None:
                lm = re.search(r"ce_loss = ([0-9.eE+-]+)", line)
                if lm:
                    curve.setdefault(epoch, {"epoch": epoch})["train_ce"] = float(lm.group(1))
            if "VALIDATE RESULTS" in line and epoch is not None:
                am = re.search(r"accuracy = ([0-9.eE+-]+)", line)
                if am:
                    curve.setdefault(epoch, {"epoch": epoch})["val_acc"] = float(am.group(1))
    return [curve[k] for k in sorted(curve)]


def build_trainer(data_dir: str, save_dir: str, device: "str | None" = None, **overrides) -> DigitsTrainer:
    """``DigitsTrainer`` on ``data_dir``'s tree with the entry's configuration from the env
    knobs; ``overrides`` replace any of its arguments."""
    if os.environ.get("TELEMETRY") == "1":
        raise NotImplementedError("TELEMETRY comes with the observability slice of the port")
    save_period = int(os.environ.get("SAVE_PERIOD", "25"))
    kwargs = dict(
        train_path=os.path.join(data_dir, "train"),
        val_path=os.path.join(data_dir, "test"),
        labels=LABELS,
        height=SIZE,
        width=SIZE,
        max_epoch=int(os.environ.get("EPOCHS", "150")),
        batch_size=int(os.environ.get("BATCH", "128")),
        chain_steps=int(os.environ.get("CHAIN_STEPS", "1")),
        mesh=mesh_from_env(),
        precision=os.environ.get("DTYPE") or None,
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
        kwargs["logger"] = Logger("digits-vgg16", os.path.join(save_dir, "logfile.log"))
    return DigitsTrainer(**kwargs)


def evaluate_saved(trainer, save_dir: str, test_path: str, labels, size: int) -> dict:
    """``eval.evaluate`` of the run's saved ``best`` and ``last`` on the test folder (the
    checkpoints that exist), each into the trainer's model; prints top-1 and top-2."""
    from distributed_training_pytorch_tpu_torch.examples.eval import evaluate

    results = {}
    for name in ("best", "last"):
        ckpt = os.path.join(save_dir, "weights", name)
        if os.path.isdir(ckpt):
            results[name] = evaluate(ckpt, test_path, labels=labels, model=unwrap(trainer.model), height=size,
                                     width=size, device=trainer.device)
            print(f"[{name}] ACCURACY TOP-1: {results[name]['top1']:.4f}  TOP-2: {results[name]['top2']:.4f}")
    return results


def main(device: "str | None" = None) -> "tuple[DigitsTrainer, dict]":
    """Materialise, train, evaluate the saved checkpoints, write ``summary.json``; returns
    the trainer and the summary."""
    data_dir = os.environ.get("DIGITS_DIR", "./data/digits")
    save_dir = os.environ.get("SAVE_DIR", "./runs/digits")
    counts = materialize(data_dir)
    print(f"digits corpus: {counts}")
    Trainer.distributed_setup()
    trainer = build_trainer(data_dir, save_dir, device)
    trainer.train()
    results = evaluate_saved(trainer, save_dir, os.path.join(data_dir, "test"), LABELS, SIZE)
    summary = {
        "corpus": "UCI handwritten digits as scikit-learn ships them (digits_8x8.npz), 8x8 upscaled to 32x32",
        "train_images": counts["train"],
        "test_images": counts["test"],
        "epochs": trainer.max_epoch,
        "batch": trainer.batch_size,
        "base_lr": DigitsTrainer.base_lr,
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
