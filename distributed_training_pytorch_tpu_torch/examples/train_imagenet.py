"""ImageNet-scale training entry of the port: ResNet-50 (the JAX package's BASELINE config
3).

Counterpart of the repository's ``examples/train_imagenet.py`` for ``MODEL=resnet50``: SGD
with momentum 0.9 and weight decay 1e-4 on every param, ``lr = BASE_LR * batch / 256``
with 5 warmup epochs then cosine, the pad-masked cross-entropy and accuracy, the best
checkpoint by val accuracy, random-resized-crop + flip on the host keyed by
``(seed, epoch, index)``, and uint8 images normalised on the device (``SHIP_UINT8=1``,
``InputNormalizer``). Run:

    python -m distributed_training_pytorch_tpu_torch.examples.train_imagenet

Without ``IMAGENET_RECORDS`` a synthetic ImageNet-shaped set (the JAX entry's bytes) trains
instead; ``STEPS_PER_EPOCH`` caps an epoch. Env knobs, as the JAX entry reads them:
``MODEL`` (``resnet50``; ``vit_b16``, ``convnext_l`` and ``convnext_tiny`` raise until their
slices), ``EPOCHS`` (90), ``BATCH`` (1024, global), ``ACCUM`` (1), ``BASE_LR`` (0.1),
``IMAGE_SIZE`` (224), ``NUM_CLASSES`` (1000), ``SAVE_DIR`` (``./runs/<model>``),
``SNAPSHOT``, ``STEPS_PER_EPOCH``, ``SHIP_UINT8`` (1), ``DTYPE`` (``fp32`` | ``bf16``; unset
keeps a bf16 model under the f32 policy), ``PALLAS`` (1: the fused 1x1 kernel for
ResNet's stage-1 1x1s; 0 or unset: cuDNN convolutions), ``CHAIN_STEPS`` (1), ``MESH``
(the grammar of ``parallel/mesh.py``; ``dpN`` for this model).
``IMAGENET_RECORDS``/``VAL_RECORDS`` (record files), ``TELEMETRY`` and ``PROFILE_DIR``
raise until their slices. The port adds ``DEVICE`` (``cuda`` unless set to
``cpu``). Under ``torchrun`` each process is one data-parallel rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.data import transforms as T
from distributed_training_pytorch_tpu_torch.models import InputNormalizer, create_model
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
}
_LATER = {
    "vit_b16": "ViT-B/16 comes with the ViT slice of the port",
    "convnext_l": "ConvNeXt-L comes with the ConvNeXt slice of the port",
    "convnext_tiny": "ConvNeXt comes with the ConvNeXt slice of the port",
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
    touching the underlying set."""

    def __init__(self, source, max_records: int):
        self.source = source
        self.transform = getattr(source, "transform", None)
        self._len = min(len(source), max_records)

    def __len__(self):
        return self._len

    def __getitem__(self, index):
        return self.source[index]


class ImageNetTrainer(Trainer):
    """The ImageNet recipe on the port's ``Trainer``; ``synthetic_records`` /
    ``synthetic_val_records`` size the synthetic sets (the JAX entry's 8192 and 1024)."""

    def __init__(
        self, model_name: str, image_size: int, base_lr: float, *, synthetic_records: int = 8192,
        synthetic_val_records: int = 1024, **kw,
    ):
        if model_name in _LATER:
            raise NotImplementedError(f"MODEL={model_name}: {_LATER[model_name]}")
        for knob in ("IMAGENET_RECORDS", "VAL_RECORDS"):
            if os.environ.get(knob):
                raise NotImplementedError(f"{knob} (record files) comes with the image data slice of the port")
        self.model_name = model_name
        self.image_size = image_size
        self.base_lr = base_lr
        self.recipe = RECIPES[model_name]
        self.num_classes = int(os.environ.get("NUM_CLASSES", self.recipe["num_classes"]))
        self.synthetic_records = synthetic_records
        self.synthetic_val_records = synthetic_val_records
        self.dtype_env = os.environ.get("DTYPE") or None
        self.pallas = pallas_from_env()
        kw.setdefault("precision", self.dtype_env)
        super().__init__(**kw)

    def build_train_dataset(self):
        self.log("IMAGENET_RECORDS unset — synthetic ImageNet-shaped data", "warning")
        tfm = train_transform(self.image_size, seed=self.seed, ship_uint8=_ship_uint8())
        source = synthetic_source(self.synthetic_records, self.image_size, self.num_classes, tfm, seed=0)
        cap = os.environ.get("STEPS_PER_EPOCH")
        if cap:
            source = _LimitedSource(source, int(cap) * self.batch_size)
        return source

    def build_val_dataset(self):
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
        lr = self.base_lr * self.batch_size / 256.0  # Goyal et al. scaling
        return warmup_cosine_lr(lr, self.max_epoch, steps_per_epoch, warmup_epochs=5)

    def build_optimizer(self, schedule):
        """``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum=0.9))``: torch's
        SGD adds ``wd * p`` to the gradient before the momentum trace, as that chain does;
        the engine sets the lr from the schedule."""
        return torch.optim.SGD(
            self.model.parameters(), lr=float(schedule(0)), momentum=0.9, weight_decay=self.recipe["wd"]
        )


def build_trainer(
    device: "str | None" = None, *, synthetic_records: int = 8192, synthetic_val_records: int = 1024
) -> ImageNetTrainer:
    """The entry's trainer, configured from the env knobs."""
    for knob in ("TELEMETRY", "PROFILE_DIR"):
        if os.environ.get(knob):
            raise NotImplementedError(f"{knob} comes with the observability slice of the port")
    model_name = os.environ.get("MODEL", "resnet50").lower()
    if model_name not in RECIPES and model_name not in _LATER:
        raise SystemExit(f"MODEL={model_name!r}: choose from {sorted(RECIPES)}")
    recipe = RECIPES.get(model_name, {})
    save_dir = os.environ.get("SAVE_DIR", f"./runs/{model_name}")
    return ImageNetTrainer(
        model_name=model_name,
        image_size=int(os.environ.get("IMAGE_SIZE", "224")),
        base_lr=float(os.environ.get("BASE_LR", str(recipe.get("base_lr", 0.1)))),
        synthetic_records=synthetic_records,
        synthetic_val_records=synthetic_val_records,
        max_epoch=int(os.environ.get("EPOCHS", "90")),
        batch_size=int(os.environ.get("BATCH", "1024")),
        chain_steps=int(os.environ.get("CHAIN_STEPS", "1")),
        mesh=mesh_from_env(),
        accum_steps=int(os.environ.get("ACCUM", str(recipe.get("accum", 1)))),
        have_validate=True,
        save_best_for=("accuracy", "geq"),
        save_period=1,
        save_folder=save_dir,
        snapshot_path=os.environ.get("SNAPSHOT") or None,
        logger=Logger(f"imagenet-{model_name}", os.path.join(save_dir, "logfile.log")),
        device=device or os.environ.get("DEVICE", "cuda"),
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
