"""VGG16 on CIFAR-10, the repository's default training entry, in the port.

Counterpart of the repository's ``examples/train_cifar10.py`` (what ``./run.sh`` runs with
``MODEL`` unset; ``run_torch.sh`` runs this one): VGG16 on CIFAR-10 with SGD, momentum 0.9
and weight decay 5e-4 added to the gradient before the momentum (optax's
``add_decayed_weights`` then ``sgd``), ``lr = BASE_LR * batch / 256`` with 5 warmup
epochs then cosine, the pad-masked cross-entropy and accuracy, and the best checkpoint by
val accuracy. Run:

    python -m distributed_training_pytorch_tpu_torch.examples.train_cifar10

It reads the canonical ``cifar-10-batches-py`` pickles (numpy only); without them it
trains on a synthetic CIFAR-shaped set (the JAX entry's bytes, ``RandomState(0)``) and
says so on a ``WARNING`` line. The host augmentation is the native library's crop/flip
(``data/native.py``: one call a batch, on a loader worker) with uint8 batches normalised
on the device by ``InputNormalizer``; when the library cannot be built the entry logs the
compiler's message and takes the per-record Python transform, which normalises on the
host. Both are keyed by ``(seed, epoch, index)``.

Env knobs, as the JAX entry reads them: ``CIFAR10_DIR`` (``./data/cifar-10-batches-py``),
``EPOCHS`` (100), ``BATCH`` (1024, global), ``BASE_LR`` (0.1), ``SAVE_DIR``
(``./runs/cifar10``), ``SNAPSHOT``, ``DTYPE`` (``fp32`` | ``bf16``; unset keeps the entry's
historical program, a bf16 model under the f32 policy), ``PALLAS`` (consumed; VGG16 runs
no kernel of the port), ``CHAIN_STEPS`` (1) and ``MESH`` (``dpN``). ``TUNED=1`` and
``TELEMETRY=1`` raise until their slices. The port adds ``DEVICE`` (``cuda`` unless set to
``cpu``). Under ``torchrun`` each process is one data-parallel rank.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource, native
from distributed_training_pytorch_tpu_torch.data.transforms import philox_key
from distributed_training_pytorch_tpu_torch.models import InputNormalizer, create_model
from distributed_training_pytorch_tpu_torch.ops.dispatch import pallas_from_env
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.ops.metrics import accuracy
from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_from_env
from distributed_training_pytorch_tpu_torch.precision import model_dtype_for_entry
from distributed_training_pytorch_tpu_torch.trainer import Trainer
from distributed_training_pytorch_tpu_torch.utils import Logger

__all__ = ["CIFAR_MEAN", "CIFAR_STD", "Cifar10Trainer", "Cifar10Transform", "build_trainer", "load_cifar10", "main"]

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def load_cifar10(data_dir: str):
    """The canonical CIFAR-10 pickles -> ``(train_x, train_y, test_x, test_y)``, uint8
    NHWC and int32; a synthetic set of 50,000 + 10,000 when ``data_dir`` is absent."""
    if os.path.isdir(data_dir):
        def read(name):
            with open(os.path.join(data_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x, np.asarray(d[b"labels"], np.int32)

        xs, ys = zip(*(read(f"data_batch_{i}") for i in range(1, 6)), strict=True)
        test_x, test_y = read("test_batch")
        return np.concatenate(xs), np.concatenate(ys), test_x, test_y
    print(f"WARNING: {data_dir} not found — using synthetic CIFAR-shaped data")
    rng = np.random.RandomState(0)
    y = rng.randint(0, 10, size=(50000,)).astype(np.int32)
    x = (rng.randn(50000, 32, 32, 3) * 40 + 120 + y[:, None, None, None] * 8).clip(0, 255)
    ty = rng.randint(0, 10, size=(10000,)).astype(np.int32)
    tx = (rng.randn(10000, 32, 32, 3) * 40 + 120 + ty[:, None, None, None] * 8).clip(0, 255)
    return x.astype(np.uint8), y, tx.astype(np.uint8), ty


class Cifar10Transform:
    """The per-record CIFAR recipe: reflect-pad-4 random crop, horizontal flip and
    normalise, Philox-keyed per ``(seed, epoch, index)``; ``train=False`` normalises
    only."""

    def __init__(self, seed: int = 0, train: bool = True):
        self.seed = seed
        self.train = train

    def __call__(self, img: np.ndarray, *, epoch: int = 0, index: int = 0) -> np.ndarray:
        out = img.astype(np.float32) / 255.0
        if self.train:
            rng = np.random.Generator(np.random.Philox(key=philox_key(self.seed, epoch, index)))
            padded = np.pad(out, ((4, 4), (4, 4), (0, 0)), mode="reflect")
            dy, dx = rng.integers(0, 9, size=2)
            out = padded[dy : dy + 32, dx : dx + 32]
            if rng.random() < 0.5:
                out = out[:, ::-1]
        return np.ascontiguousarray((out - CIFAR_MEAN) / CIFAR_STD)


class Cifar10Trainer(Trainer):
    """The CIFAR-10 recipe on the port's ``Trainer``."""

    # the masked metrics below weight padded validation rows out
    criterion_uses_mask = True

    def __init__(self, data_dir: str, base_lr: float, **kw):
        self.train_x, self.train_y, self.test_x, self.test_y = load_cifar10(data_dir)
        self.base_lr = base_lr
        self.dtype_env = os.environ.get("DTYPE") or None
        self.pallas = pallas_from_env()
        kw.setdefault("precision", self.dtype_env)
        super().__init__(**kw)

    @property
    def native_augment(self) -> bool:
        """Whether the native crop/flip (and normalisation on the device) is the path."""
        return native.available()

    def _transform(self, train: bool):
        if self.native_augment:
            return native.NativeCropFlipU8(pad=4, seed=self.seed, train=train)
        self.log(f"the native data runtime did not build, taking the per-record Python transform: "
                 f"{native.build_error()}", "warning")
        return Cifar10Transform(seed=self.seed, train=train)

    def build_train_dataset(self):
        return ArrayDataSource(transform=self._transform(train=True), image=self.train_x, label=self.train_y)

    def build_val_dataset(self):
        return ArrayDataSource(transform=self._transform(train=False), image=self.test_x, label=self.test_y)

    def build_model(self):
        explicit = self.dtype_env is not None or self.precision_requested
        model = create_model(
            "vgg16",
            num_classes=10,
            dtype=model_dtype_for_entry(self.precision, explicit, torch.bfloat16),
            pallas=self.pallas,
            device=self.device,
        )
        if self.native_augment:
            model = InputNormalizer(model, mean=list(CIFAR_MEAN), std=list(CIFAR_STD))
        return model

    def build_criterion(self):
        def criterion(logits, batch):
            mask = batch.get("mask")
            loss = cross_entropy_loss(logits, batch["label"], weights=mask)
            return loss, {"ce_loss": loss, "accuracy": accuracy(logits, batch["label"], weights=mask)}

        return criterion

    def build_loss_fn(self):
        """The loader's NHWC images as the NCHW view the model takes (channels-last in
        memory: no copy), then the criterion."""
        criterion = self.criterion

        def loss_fn(model, batch, train):
            return criterion(model(batch["image"].permute(0, 3, 1, 2)), batch)

        return loss_fn

    def build_optimizer(self, schedule):
        """``optax.chain(add_decayed_weights(5e-4), sgd(schedule, momentum=0.9))``: torch's
        SGD adds ``wd * p`` to the gradient before the momentum trace, as that chain does;
        the engine sets the lr from the schedule."""
        return torch.optim.SGD(self.model.parameters(), lr=float(schedule(0)), momentum=0.9, weight_decay=5e-4)

    def build_scheduler(self):
        steps_per_epoch = max(1, len(self.train_y) // self.batch_size)
        lr = self.base_lr * self.batch_size / 256.0  # linear scaling with the global batch
        return warmup_cosine_lr(lr, self.max_epoch, steps_per_epoch, warmup_epochs=5)


def build_trainer(device: "str | None" = None) -> Cifar10Trainer:
    """The entry's trainer, configured from the env knobs."""
    if os.environ.get("TUNED") == "1":
        raise NotImplementedError("TUNED=1 (the TUNED.json autotuner's knobs) comes with the tooling slice (P17)")
    if os.environ.get("TELEMETRY") == "1":
        raise NotImplementedError("TELEMETRY comes with the observability slice of the port")
    save_dir = os.environ.get("SAVE_DIR", "./runs/cifar10")
    return Cifar10Trainer(
        data_dir=os.environ.get("CIFAR10_DIR", "./data/cifar-10-batches-py"),
        base_lr=float(os.environ.get("BASE_LR", "0.1")),
        max_epoch=int(os.environ.get("EPOCHS", "100")),
        batch_size=int(os.environ.get("BATCH", "1024")),
        chain_steps=int(os.environ.get("CHAIN_STEPS") or 1),
        mesh=mesh_from_env(),
        have_validate=True,
        save_best_for=("accuracy", "geq"),
        save_period=5,
        save_folder=save_dir,
        snapshot_path=os.environ.get("SNAPSHOT") or None,
        logger=Logger("cifar10-vgg16", os.path.join(save_dir, "logfile.log")),
        device=device or os.environ.get("DEVICE", "cuda"),
    )


def main(device: "str | None" = None) -> Cifar10Trainer:
    """Join the process group (under torchrun), train, leave it."""
    Trainer.distributed_setup()
    trainer = build_trainer(device)
    trainer.train()
    Trainer.destroy_process()
    return trainer


if __name__ == "__main__":
    main()
