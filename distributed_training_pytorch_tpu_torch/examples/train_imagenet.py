"""ImageNet-scale training entry of the port: ResNet-50, ViT-B/16 and ConvNeXt-L (the JAX
package's BASELINE configs 3 to 5).

Counterpart of the repository's ``examples/train_imagenet.py``, with its recipes:

=================  ==========================================================================
``MODEL=``         recipe
``resnet50``       SGD momentum 0.9, wd 1e-4, ``lr = BASE_LR * batch / 256``, 1000 classes
``vit_b16``        AdamW (0.9, 0.999), wd 0.05, ``lr = BASE_LR * batch / 4096``, 1000 classes
``convnext_l``     AdamW as ViT, ``ACCUM=4`` micro-batches a step, 21841 classes
``convnext_tiny``  the ``convnext_l`` recipe on a small ConvNeXt, for the CPU
=================  ==========================================================================

Every recipe warms up for 5 epochs, then follows a cosine; ``BASE_LR`` defaults to 0.1
(SGD) or 1e-3 (AdamW). The entry trains on the pad-masked cross-entropy and accuracy,
keeps the best checkpoint by val accuracy, runs random-resized-crop + flip on the host
keyed by ``(seed, epoch, index)``, and normalises uint8 images on the device
(``SHIP_UINT8=1``, ``InputNormalizer``). Run:

    python -m distributed_training_pytorch_tpu_torch.examples.train_imagenet

``IMAGENET_RECORDS`` (a glob or a directory of record shards, ``data/records.py``) trains on
real images: ``NativeRecordTrainSource(aug="rrc")`` decodes each payload and draws its
random-resized crop and flip in one native batch call when the entry ships uint8 and
``RECORDS_NATIVE`` is not ``0``, else ``RecordFileSource`` with the per-record transform;
``VAL_RECORDS`` validates through ``NativeRecordFileSource`` (decode, resize, normalise).
Without them a synthetic ImageNet-shaped set (the JAX entry's bytes) trains and validates
instead. ``STEPS_PER_EPOCH`` caps an epoch of either. Env knobs, as the JAX entry reads them:
``MODEL`` (``resnet50``), ``EPOCHS`` (90), ``BATCH`` (1024, global), ``ACCUM`` (the recipe's),
``BASE_LR`` (the recipe's), ``IMAGE_SIZE`` (224), ``NUM_CLASSES`` (the recipe's),
``SAVE_DIR`` (``./runs/<model>``), ``SNAPSHOT``, ``STEPS_PER_EPOCH``, ``SHIP_UINT8`` (1),
``DTYPE`` (``fp32`` | ``bf16``; unset keeps a bf16 model under the f32 policy), ``PALLAS``
(per model: ResNet's stage-1 1x1s and ConvNeXt's expand Dense + GELU take the fused 1x1
kernel with 1, cuDNN/cuBLAS with 0 or unset; ViT's attention takes the flash kernels
unset or with 1, the plain softmax with 0), ``CHAIN_STEPS`` (1), ``MESH`` (the grammar of
``parallel/mesh.py``: ``dpN``; ``fsdpN`` and ``dpNfsdpM`` shard the state of any of these
models; ``tpN`` splits ViT's blocks by heads and features; ``ppN`` builds the pipe axis,
module-managed as in the JAX entry: the model trains unpipelined over it).
``IMAGENET_RECORDS``, ``VAL_RECORDS``, ``RECORDS_NATIVE`` (1), ``TELEMETRY`` (1: the
telemetry of ``telemetry/``) and ``PROFILE_DIR`` (a raw trace of the first epoch's steps 1
to 5). The port adds ``DEVICE`` (``cuda`` unless set to
``cpu``). Under ``torchrun`` each process is one data-parallel rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch.data import (
    ArrayDataSource,
    NativeRecordFileSource,
    NativeRecordTrainSource,
    RecordFileSource,
)
from distributed_training_pytorch_tpu_torch.data import transforms as T
from distributed_training_pytorch_tpu_torch.data.records import shard_paths
from distributed_training_pytorch_tpu_torch.models import VIT_NAMES, InputNormalizer, create_model
from distributed_training_pytorch_tpu_torch.ops.dispatch import pallas_from_env
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.ops.metrics import accuracy
from distributed_training_pytorch_tpu_torch.ops.schedules import warmup_cosine_lr
from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_from_env
from distributed_training_pytorch_tpu_torch.precision import model_dtype_for_entry
from distributed_training_pytorch_tpu_torch.trainer import Trainer
from distributed_training_pytorch_tpu_torch.utils import Logger

__all__ = ["ImageNetTrainer", "RECIPES", "build_trainer", "main", "synthetic_source"]

RECIPES = {
    "resnet50": dict(num_classes=1000, optimizer="sgd", base_lr=0.1, accum=1, wd=1e-4),
    "vit_b16": dict(num_classes=1000, optimizer="adamw", base_lr=1e-3, accum=1, wd=0.05),
    "convnext_l": dict(num_classes=21841, optimizer="adamw", base_lr=1e-3, accum=4, wd=0.05),
    # The convnext_l recipe (optimizer, accumulation) on a model small enough for the CPU.
    "convnext_tiny": dict(num_classes=21841, optimizer="adamw", base_lr=1e-3, accum=4, wd=0.05),
}
SYNTHETIC_CHUNK = 64  # images drawn at a time: one draw of 8192 x 224^2 x 3 normals is 9.9 GB


def _ship_uint8() -> bool:
    """``SHIP_UINT8=1`` (default): the host keeps uint8 images and ``InputNormalizer``
    normalises on the device; ``0`` normalises on the host."""
    return os.environ.get("SHIP_UINT8", "1") != "0"


def train_transform(image_size: int, seed: int, ship_uint8: bool = True) -> T.Compose:
    """Random-resized-crop + flip (+ normalise unless shipping uint8), Philox-keyed per
    ``(epoch, index)``."""
    ops = [T.random_resized_crop(image_size, image_size), T.horizontal_flip()]
    if not ship_uint8:
        ops.append(T.normalize())
    return T.Compose(ops, seed=seed)


def eval_transform(image_size: int) -> T.Compose:
    return T.eval_transform(image_size, image_size)


def synthetic_source(n: int, image_size: int, num_classes: int, transform, seed: int) -> ArrayDataSource:
    """Class-separable synthetic uint8 images, the JAX entry's bytes: the same labels and
    normals from ``RandomState(seed)``, drawn ``SYNTHETIC_CHUNK`` images at a time (the
    legacy generator's normals continue across draws, so the chunks equal one draw)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, num_classes, size=(n,)).astype(np.int32)
    x = np.empty((n, image_size, image_size, 3), np.uint8)
    for i in range(0, n, SYNTHETIC_CHUNK):
        m = min(SYNTHETIC_CHUNK, n - i)
        part = rng.randn(m, image_size, image_size, 3) * 40 + 110 + (y[i : i + m] % 13)[:, None, None, None] * 9
        x[i : i + m] = part.clip(0, 255).astype(np.uint8)
    return ArrayDataSource(transform=transform, image=x, label=y)


class _LimitedSource:
    """Length-capping view over a source: ``STEPS_PER_EPOCH`` for timed runs without
    touching the underlying set. The source's whole-batch ``load_batch`` (the native record
    path) is forwarded, so the loader keeps its fast path (the capped rows index the
    source unchanged)."""

    def __init__(self, source, max_records: int):
        self.source = source
        self.transform = getattr(source, "transform", None)
        self._len = min(len(source), max_records)
        if hasattr(source, "load_batch"):
            self.load_batch = source.load_batch

    @property
    def skip_corrupt(self) -> bool:
        return getattr(self.source, "skip_corrupt", False)

    @skip_corrupt.setter
    def skip_corrupt(self, value: bool) -> None:  # the loader's skip_corrupt=True reaches the source
        self.source.skip_corrupt = value

    @property
    def corrupt_skipped(self) -> int:
        return int(getattr(self.source, "corrupt_skipped", 0))

    def __len__(self):
        return self._len

    def __getitem__(self, index):
        return self.source[index]


class ImageNetTrainer(Trainer):
    """The ImageNet recipe on the port's ``Trainer``; ``synthetic_records`` /
    ``synthetic_val_records`` size the synthetic sets (the JAX entry's 8192 and 1024)."""

    # the masked metrics weight padded validation rows out
    criterion_uses_mask = True

    def __init__(
        self, model_name: str, image_size: int, base_lr: float, *, synthetic_records: int = 8192,
        synthetic_val_records: int = 1024, **kw,
    ):
        self.model_name = model_name
        self.image_size = image_size
        self.base_lr = base_lr
        self.recipe = RECIPES[model_name]
        self.num_classes = int(os.environ.get("NUM_CLASSES", self.recipe["num_classes"]))
        self.synthetic_records = synthetic_records
        self.synthetic_val_records = synthetic_val_records
        self.train_records = os.environ.get("IMAGENET_RECORDS") or None
        self.val_records = os.environ.get("VAL_RECORDS") or None
        for pattern in (self.train_records, self.val_records):
            if pattern:
                shard_paths(pattern)  # a pattern that matches no shard fails before the model is built
        self.dtype_env = os.environ.get("DTYPE") or None
        self.pallas = pallas_from_env()
        kw.setdefault("precision", self.dtype_env)
        super().__init__(**kw)

    def build_train_dataset(self):
        tfm = train_transform(self.image_size, seed=self.seed, ship_uint8=_ship_uint8())
        if self.train_records:
            if _ship_uint8() and os.environ.get("RECORDS_NATIVE", "1") != "0":
                # decode + random-resized crop + flip in one native call a batch, uint8 out
                source = NativeRecordTrainSource(self.train_records, self.image_size, self.image_size, aug="rrc",
                                                 seed=self.seed)
            else:
                source = RecordFileSource(self.train_records, transform=tfm)
        else:
            self.log("IMAGENET_RECORDS unset — synthetic ImageNet-shaped data", "warning")
            source = synthetic_source(self.synthetic_records, self.image_size, self.num_classes, tfm, seed=0)
        cap = os.environ.get("STEPS_PER_EPOCH")
        if cap:
            source = _LimitedSource(source, int(cap) * self.batch_size)
        return source

    def build_val_dataset(self):
        if self.val_records:
            return NativeRecordFileSource(self.val_records, height=self.image_size, width=self.image_size)
        tfm = eval_transform(self.image_size)
        return synthetic_source(self.synthetic_val_records, self.image_size, self.num_classes, tfm, seed=1)

    def build_model(self):
        explicit = self.dtype_env is not None or self.precision_requested
        model = create_model(
            self.model_name,
            num_classes=self.num_classes,
            dtype=model_dtype_for_entry(self.precision, explicit, torch.bfloat16),
            pallas=self.pallas,
            device=self.device,
            **({"image_size": self.image_size} if self.model_name in VIT_NAMES else {}),
        )
        if _ship_uint8():
            model = InputNormalizer(model, mean=list(T.IMAGENET_MEAN), std=list(T.IMAGENET_STD))
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

    def build_scheduler(self):
        steps_per_epoch = max(1, len(self.train_dataset) // self.batch_size)
        if self.recipe["optimizer"] == "sgd":
            lr = self.base_lr * self.batch_size / 256.0  # Goyal et al. scaling
        else:
            lr = self.base_lr * self.batch_size / 4096.0  # the AdamW convention
        return warmup_cosine_lr(lr, self.max_epoch, steps_per_epoch, warmup_epochs=5)

    def build_optimizer(self, schedule):
        """SGD: ``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum=0.9))``, as
        torch's SGD adds ``wd * p`` to the gradient before the momentum trace. AdamW:
        ``optax.adamw(schedule, weight_decay=wd, b1=0.9, b2=0.999)``, one parameter group,
        decay on every parameter, eps 1e-8. The engine sets the lr from the schedule."""
        lr, wd = float(schedule(0)), self.recipe["wd"]
        if self.recipe["optimizer"] == "sgd":
            return torch.optim.SGD(self.model.parameters(), lr=lr, momentum=0.9, weight_decay=wd)
        return torch.optim.AdamW(self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)


def build_trainer(
    device: "str | None" = None, *, synthetic_records: int = 8192, synthetic_val_records: int = 1024
) -> ImageNetTrainer:
    """The entry's trainer, configured from the env knobs."""
    model_name = os.environ.get("MODEL", "resnet50").lower()
    if model_name not in RECIPES:
        raise SystemExit(f"MODEL={model_name!r}: choose from {sorted(RECIPES)}")
    recipe = RECIPES[model_name]
    save_dir = os.environ.get("SAVE_DIR", f"./runs/{model_name}")
    return ImageNetTrainer(
        model_name=model_name,
        image_size=int(os.environ.get("IMAGE_SIZE", "224")),
        base_lr=float(os.environ.get("BASE_LR", str(recipe["base_lr"]))),
        synthetic_records=synthetic_records,
        synthetic_val_records=synthetic_val_records,
        max_epoch=int(os.environ.get("EPOCHS", "90")),
        batch_size=int(os.environ.get("BATCH", "1024")),
        chain_steps=int(os.environ.get("CHAIN_STEPS", "1")),
        mesh=mesh_from_env(),
        accum_steps=int(os.environ.get("ACCUM", str(recipe["accum"]))),
        have_validate=True,
        save_best_for=("accuracy", "geq"),
        save_period=1,
        save_folder=save_dir,
        snapshot_path=os.environ.get("SNAPSHOT") or None,
        logger=Logger(f"imagenet-{model_name}", os.path.join(save_dir, "logfile.log")),
        device=device or os.environ.get("DEVICE", "cuda"),
        telemetry=os.environ.get("TELEMETRY") == "1" or None,
        profile_dir=os.environ.get("PROFILE_DIR") or None,
    )


def main(device: "str | None" = None) -> ImageNetTrainer:
    """Join the process group (under torchrun), train, leave it."""
    Trainer.distributed_setup()
    trainer = build_trainer(device)
    trainer.train()
    Trainer.destroy_process()
    return trainer


if __name__ == "__main__":
    main()
