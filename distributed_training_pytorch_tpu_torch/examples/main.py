"""The image-folder training entry: VGG16 on ``./data/train`` and ``./data/val``.

Counterpart of the repository's ``examples/main.py`` (the PyTorch reference's ``main.py``):
the logger, the process group, ``ExampleTrainer`` with the reference's configuration
(labels [cat, dog, snake], 224x224, 300 epochs, global batch 16, validation every 5
epochs keeping the best by ``("accuracy", "geq")``, ``./runs``, no snapshot), training,
and teardown. Run from the directory that holds ``data/``:

    python -m distributed_training_pytorch_tpu_torch.examples.main

The port adds ``DEVICE`` (``cuda`` unless set to ``cpu``); there is no fallback to the
CPU when the card is missing. Under ``torchrun`` each process is one data-parallel rank.
Folders may hold JPEG, PNG and BMP files on any machine: JPEG is decoded by the port's own
native decoder (no libjpeg), a JPEG turned by its EXIF orientation as ``cv2.imread`` turns it.
"""

from __future__ import annotations

import os

from distributed_training_pytorch_tpu_torch.examples.example_trainer import ExampleTrainer
from distributed_training_pytorch_tpu_torch.utils import Logger

__all__ = ["build_trainer", "main"]


def build_trainer(device: "str | None" = None, **overrides) -> ExampleTrainer:
    """``ExampleTrainer`` with the entry's configuration; ``overrides`` replace any of its
    arguments."""
    kwargs = dict(
        train_path="./data/train",
        val_path="./data/val",
        labels=["cat", "dog", "snake"],
        height=224,
        width=224,
        max_epoch=300,
        batch_size=16,
        pin_memory=True,
        have_validate=True,
        save_best_for=("accuracy", "geq"),
        save_period=5,
        save_folder="./runs",
        snapshot_path=None,
        device=device or os.environ.get("DEVICE", "cuda"),
    )
    kwargs.update(overrides)
    if "logger" not in kwargs:
        kwargs["logger"] = Logger("VGG16", os.path.join(kwargs["save_folder"], "logfile.log"))
    return ExampleTrainer(**kwargs)


def main(device: "str | None" = None, **overrides) -> ExampleTrainer:
    """Join the process group (under torchrun), train, leave it."""
    ExampleTrainer.distributed_setup()
    trainer = build_trainer(device, **overrides)
    trainer.train()
    ExampleTrainer.destroy_process()
    return trainer


if __name__ == "__main__":
    main()
