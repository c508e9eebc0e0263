"""Offline evaluation of a saved checkpoint on an image folder: top-1 and top-2.

Counterpart of the repository's ``examples/eval.py`` (the PyTorch reference's ``eval.py``):
a fresh VGG16 (or ``EVAL_MODEL``), its weights restored from the checkpoint
(``params_only``: the run's optimizer is not needed), every image under
``<test>/<label>/`` resized and normalised, batched (the last batch padded, its padded
rows masked out), and top-1 and top-2 accuracy, each batch weighted by its global
real-row count. Run:

    python -m distributed_training_pytorch_tpu_torch.examples.eval [checkpoint_dir] [test_dir]

Defaults ``./runs/weights/last`` and ``./data/test``. Env knobs, as the JAX twin reads
them: ``EVAL_MODEL`` (a zoo name; unset is VGG16), ``EVAL_LABELS`` (a comma list; unset is
cat,dog,snake), ``EVAL_SIZE`` (the square input side; unset is 224) and ``SHIP_UINT8``;
the port adds ``DEVICE`` (``cuda`` unless set to ``cpu``). Whether the model is wrapped in
``InputNormalizer`` is read from the checkpoint's ``params_top_level``; a checkpoint
without it falls back to ``SHIP_UINT8`` (default on) for the ImageNet family.
"""

from __future__ import annotations

import os
import sys

import torch

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
from distributed_training_pytorch_tpu_torch.data import ImageFolderDataSource, ShardedLoader, eval_transform
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch
from distributed_training_pytorch_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from distributed_training_pytorch_tpu_torch.models import VGG16, InputNormalizer, create_model
from distributed_training_pytorch_tpu_torch.ops.metrics import top_k_accuracy
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState

__all__ = ["BATCH", "HEIGHT", "LABELS", "WIDTH", "evaluate", "main", "model_from_env"]

LABELS = ["cat", "dog", "snake"]
HEIGHT = WIDTH = 224
BATCH = 64
IMAGENET_FAMILY = ("resnet50", "vit_b16", "convnext_l", "convnext_tiny", "resnet18_slim", "vit_tiny")


def _manager(checkpoint_dir: str) -> CheckpointManager:
    return CheckpointManager(os.path.dirname(os.path.abspath(checkpoint_dir.rstrip("/"))))


def evaluate(checkpoint_dir: str, test_path: str, labels=None, batch: int = BATCH, *, model=None, height=None,
             width=None, device="cuda", num_workers: int = 8) -> dict:
    """``{"top1": ..., "top2": ...}`` of the checkpoint's weights on ``test_path``."""
    labels = labels or LABELS
    height = height or HEIGHT
    width = width or WIDTH
    device = resolve_device(device)
    model = (model or VGG16(num_classes=len(labels), device=device)).to(device)

    def loss_fn(m, b, train):
        logits = m(b["image"].permute(0, 3, 1, 2))
        mask = b.get("mask")
        return torch.zeros((), device=logits.device), {
            "top1": top_k_accuracy(logits, b["label"], k=1, weights=mask),
            "top2": top_k_accuracy(logits, b["label"], k=2, weights=mask),
        }

    engine = TrainEngine(loss_fn)
    state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.0))
    state, _ = _manager(checkpoint_dir).restore(checkpoint_dir, state, params_only=True)

    source = ImageFolderDataSource(test_path, labels, transform=eval_transform(height, width))
    loader = ShardedLoader(source, batch, shuffle=False, drop_last=False, pad_final=True, num_workers=num_workers)
    sums: "dict[str, torch.Tensor]" = {}
    total = 0.0
    with torch.no_grad():
        for b, device_batch in enumerate(device_prefetch(iter(loader), device)):
            weight = float(loader.global_real_count(b))  # the same on every rank
            for k, v in engine.eval_step(state, device_batch).items():
                sums[k] = sums.get(k, 0.0) + v.float() * weight
            total += weight
    return {k: float(v) / max(total, 1.0) for k, v in sums.items()}


def model_from_env(checkpoint_dir: str, labels, device):
    """The model ``EVAL_MODEL`` names (None: ``evaluate``'s VGG16), wrapped in
    ``InputNormalizer`` when the checkpoint's ``params_top_level`` is ``["inner"]``, or,
    for a checkpoint without it, when the model is of the ImageNet family and
    ``SHIP_UINT8`` is not ``0``."""
    name = os.environ.get("EVAL_MODEL")
    if not name:
        return None
    model = create_model(name, num_classes=len(labels), device=device)
    try:
        top = _manager(checkpoint_dir).read_meta(checkpoint_dir).get("params_top_level")
    except (FileNotFoundError, ValueError):
        top = None
    wrapped = top == ["inner"] if top is not None else (
        name in IMAGENET_FAMILY and os.environ.get("SHIP_UINT8", "1") != "0")
    if wrapped:
        model = InputNormalizer(model, mean=list(IMAGENET_MEAN), std=list(IMAGENET_STD))
    return model


def main(argv=None, device: "str | None" = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    checkpoint_dir = argv[0] if len(argv) > 0 else "./runs/weights/last"
    test_path = argv[1] if len(argv) > 1 else "./data/test"
    labels = [s.strip() for s in os.environ.get("EVAL_LABELS", "").split(",") if s.strip()] or None
    device = resolve_device(device or os.environ.get("DEVICE", "cuda"))
    model = model_from_env(checkpoint_dir, labels or LABELS, device)
    size = int(os.environ.get("EVAL_SIZE", "0")) or None
    results = evaluate(checkpoint_dir, test_path, labels=labels, model=model, height=size, width=size, device=device)
    print(f"ACCURACY TOP-1: {results['top1']:.4f}")
    print(f"ACCURACY TOP-2: {results['top2']:.4f}")
    return results


if __name__ == "__main__":
    main()
