"""The port's ``Trainer.validate`` against the JAX Trainer's padded-validation contract
(``distributed_training_pytorch_tpu/trainer/trainer.py:2396-2410``): a padded val batch
warns once, unless the trainer declares ``criterion_uses_mask = True``.

F6 (``ROADMAP.md`` queue 3): the port's ``validate`` gave no warning, so a criterion that
ignores ``batch["mask"]`` had its padded rows counted in silence. The JAX Trainer cannot
be imported in this tree (its ``data/streaming/`` is missing), so the contract is held
here as the JAX code states it. The port tells a padded batch by its global real-row
count (no read of the mask back from the card).
"""

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.ops.metrics import accuracy
from distributed_training_pytorch_tpu_torch.trainer import Trainer


class _Logger:
    def __init__(self):
        self.lines = []

    def log(self, msg, log_type="info"):
        self.lines.append((log_type, msg))


class _Tiny(Trainer):
    def __init__(self, n_val, uses_mask, **kw):
        self.n_val = n_val
        if uses_mask is not None:
            self.criterion_uses_mask = uses_mask
        super().__init__(**kw)

    def _source(self, n):
        rng = np.random.RandomState(n)
        return ArrayDataSource(image=rng.randn(n, 4).astype(np.float32), label=rng.randint(0, 3, n).astype(np.int32))

    def build_train_dataset(self):
        return self._source(16)

    def build_val_dataset(self):
        return self._source(self.n_val)

    def build_model(self):
        return torch.nn.Linear(4, 3)

    def build_criterion(self):
        def criterion(logits, batch):
            loss = torch.nn.functional.cross_entropy(logits, batch["label"].long())
            return loss, {"ce_loss": loss, "accuracy": accuracy(logits, batch["label"])}

        return criterion

    def build_optimizer(self, schedule):
        return torch.optim.SGD(self.model.parameters(), lr=0.1)

    def build_scheduler(self):
        return 0.1


@pytest.mark.parametrize(
    "n_val, uses_mask, warns",
    [(10, None, True), (10, False, True), (10, True, False), (8, None, False)],
    ids=["padded-undeclared", "padded-false", "padded-declared", "unpadded"],
)
def test_padded_validation_warns_unless_the_criterion_uses_the_mask(tmp_path, n_val, uses_mask, warns):
    logger = _Logger()
    trainer = _Tiny(n_val, uses_mask, max_epoch=1, batch_size=4, have_validate=True, save_folder=str(tmp_path),
                    logger=logger, num_workers=0, device="cpu")
    for _ in range(2):
        trainer.validate()
    warnings = [m for kind, m in logger.lines if kind == "warning" and "criterion_uses_mask" in m]
    assert len(warnings) == (2 if warns else 0)  # once a validation


@pytest.mark.parametrize(
    "module, cls",
    [("train_lm", "LMTrainer"), ("train_imagenet", "ImageNetTrainer"), ("train_cifar10", "Cifar10Trainer"),
     ("example_trainer", "ExampleTrainer")],
)
def test_the_entries_declare_that_their_criteria_use_the_mask(module, cls):
    """Each entry's criterion weights padded rows out, and declares it, as its JAX twin
    does (``examples/train_lm.py:119``, ``train_imagenet.py:141``, ``train_cifar10.py:175``,
    ``example_trainer.py:88``), so that validation does not warn."""
    import importlib

    trainer = getattr(importlib.import_module(f"distributed_training_pytorch_tpu_torch.examples.{module}"), cls)
    assert trainer.criterion_uses_mask is True
