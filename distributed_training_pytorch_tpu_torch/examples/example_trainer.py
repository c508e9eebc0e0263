"""The image-folder example trainer: VGG16 classification on ``<root>/<label>/`` folders.

Counterpart of the repository's ``examples/example_trainer.py`` (itself the twin of the
PyTorch reference's ``example_trainer.py``): the nine hooks with the reference's
hyperparameters. VGG16 with one output per label; the pad-masked cross-entropy and
accuracy; SGD at lr 0.1, momentum 0.9 and weight decay 1e-4 added to the gradient before
the momentum (optax's ``add_decayed_weights`` then ``sgd``, which torch's SGD is); a
MultiStepLR of milestones [50, 100, 200] epochs and gamma 0.1 in per-step boundaries. The
train set takes the ten-step train chain (``data.transforms.train_transform``: resize,
rotate90, flips, blur, median blur, CLAHE, brightness/contrast, gamma, JPEG re-encoding,
normalise), the val set resize and normalise.

Kept from the JAX twin: ``build_val_dataset`` reads ``val_path`` (the reference validates
on its training folder, a deliberate fix), ``criterion_uses_mask = True``, and the
``pallas`` knob, which VGG16 consumes as a no-op (``ops.dispatch.vgg16_policy``).
"""

from __future__ import annotations

import torch

from distributed_training_pytorch_tpu_torch.data import ImageFolderDataSource, eval_transform, train_transform
from distributed_training_pytorch_tpu_torch.models import VGG16, create_model
from distributed_training_pytorch_tpu_torch.ops.losses import cross_entropy_loss
from distributed_training_pytorch_tpu_torch.ops.metrics import accuracy
from distributed_training_pytorch_tpu_torch.ops.schedules import multistep_lr
from distributed_training_pytorch_tpu_torch.trainer import Trainer

__all__ = ["ExampleTrainer"]


class ExampleTrainer(Trainer):
    # kernel-policy knob (ops/dispatch.py); None keeps the plain constructor
    pallas = None
    # the masked metrics below weight padded validation rows out
    criterion_uses_mask = True

    def __init__(self, train_path: str, val_path: str, labels: "list[str]", height: int, width: int, **trainer_kwargs):
        self.train_path = train_path
        self.val_path = val_path
        self.labels = labels
        self.height = height
        self.width = width
        super().__init__(**trainer_kwargs)

    # -- data ---------------------------------------------------------------

    def build_train_dataset(self):
        return ImageFolderDataSource(
            self.train_path, self.labels, transform=train_transform(self.height, self.width, seed=self.seed)
        )

    def build_val_dataset(self):
        return ImageFolderDataSource(self.val_path, self.labels, transform=eval_transform(self.height, self.width))

    # -- model / objective --------------------------------------------------

    def build_model(self):
        """VGG16 with one output per label, its activations in the precision policy's
        compute dtype (f32 under the default policy)."""
        dtype = self.precision.compute_dtype
        if self.pallas is not None:
            return create_model("vgg16", num_classes=len(self.labels), dtype=dtype, pallas=self.pallas,
                                device=self.device)
        return VGG16(num_classes=len(self.labels), dtype=dtype, device=self.device)

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

    def build_optimizer(self, schedule):
        """SGD, momentum 0.9, weight decay 1e-4 added to the gradient before the momentum;
        the engine sets the lr from the schedule before every step."""
        return torch.optim.SGD(self.model.parameters(), lr=float(schedule(0)), momentum=0.9, weight_decay=1e-4)

    def build_scheduler(self):
        """MultiStepLR: lr 0.1, times 0.1 at epochs 50, 100 and 200, as step boundaries
        (the datasets are built before this hook)."""
        steps_per_epoch = max(1, len(self.train_dataset) // self.batch_size)
        return multistep_lr(0.1, [50, 100, 200], gamma=0.1, steps_per_epoch=steps_per_epoch)
