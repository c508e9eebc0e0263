"""Evaluation metrics on logits and integer labels.

Counterpart of ``distributed_training_pytorch_tpu/ops/metrics.py``: batch top-1 accuracy,
top-k accuracy and the correct count, each optionally weighted (the loader's pad
``mask``), as 0-d tensors that stay on the device.
"""

from __future__ import annotations

import torch

from distributed_training_pytorch_tpu_torch.ops.losses import weighted_mean

__all__ = ["accuracy", "correct_count", "top_k_accuracy"]


def accuracy(logits: torch.Tensor, labels: torch.Tensor, weights: "torch.Tensor | None" = None) -> torch.Tensor:
    """Top-1 accuracy over the batch, in [0, 1]; ``weights`` makes it a weighted mean over
    the real rows only."""
    return weighted_mean(torch.argmax(logits, dim=-1) == labels.long(), weights)


def top_k_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, k: int = 1, weights: "torch.Tensor | None" = None
) -> torch.Tensor:
    """The share of rows whose label is among the ``k`` highest-scoring classes."""
    top_idx = torch.topk(logits, k, dim=-1).indices
    hit = (top_idx == labels.long()[..., None]).any(dim=-1)
    return weighted_mean(hit, weights)


def correct_count(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The number of correct top-1 predictions."""
    return (torch.argmax(logits, dim=-1) == labels.long()).sum()
