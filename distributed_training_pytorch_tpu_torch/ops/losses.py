"""Loss functions in f32, whatever the activations' dtype.

Counterpart of ``distributed_training_pytorch_tpu/ops/losses.py``: the per-example
softmax cross-entropy, its (pad-mask weighted) mean, and the tied-embedding LM loss that
never materialises the ``[B, T, V]`` logits.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = [
    "cross_entropy_loss",
    "softmax_cross_entropy_with_integer_labels",
    "tied_cross_entropy",
    "weighted_mean",
]


def softmax_cross_entropy_with_integer_labels(
    logits: torch.Tensor, labels: torch.Tensor, *, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-example stable softmax CE from integer labels, in f32; shape ``labels.shape``."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(log_probs, -1, labels.long()[..., None])[..., 0]
    if label_smoothing:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def weighted_mean(values: torch.Tensor, weights: "torch.Tensor | None" = None) -> torch.Tensor:
    """Mean of per-example values, optionally weighted (pad-mask aware). An all-zero
    weight vector gives 0, not NaN; fractional weights divide by their true sum."""
    values = values.float()
    if weights is None:
        return values.mean()
    weights = weights.float()
    total = weights.sum()
    return torch.where(
        total > 0, (values * weights).sum() / torch.clamp(total, min=1e-8), torch.zeros_like(total)
    )


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    label_smoothing: float = 0.0,
    weights: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Mean CE over the batch; ``weights`` (e.g. the loader's pad ``mask``) makes it a
    weighted mean, so padded rows contribute nothing."""
    nll = softmax_cross_entropy_with_integer_labels(logits, labels, label_smoothing=label_smoothing)
    return weighted_mean(nll, weights)


def _chunk_step(x, emb_c, m, l, tgt_logit, tgt, base: int):
    """One vocab slice of the online logsumexp: ``[N, C]`` f32 logits, the running max
    ``m`` and sum ``l``, and the target's logit where it falls in this slice."""
    logits = x @ emb_c.float().T
    m_new = torch.maximum(m, logits.amax(dim=1))
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
    width = emb_c.shape[0]
    in_chunk = (tgt >= base) & (tgt < base + width)
    local = torch.clamp(tgt - base, 0, width - 1)
    picked = torch.gather(logits, 1, local[:, None])[:, 0]
    return m_new, l, torch.where(in_chunk, picked, tgt_logit)


def tied_cross_entropy(
    hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor, *, chunk_size: int = 8192
) -> torch.Tensor:
    """Per-token NLL for a tied-embedding LM head without the full logits tensor.

    ``hidden`` ``[..., d]``, ``embedding`` ``[V, d]``, integer ``targets`` of ``hidden``'s
    leading shape; returns the per-token NLL of that shape. Both operands are upcast to
    f32, as the model's own head does. The vocabulary is scanned in ``chunk_size`` slices
    (clamped to the 128-rounded vocab, so a small vocab is one slice) with an online
    logsumexp; each slice runs under ``torch.utils.checkpoint``, so the backward pass
    recomputes its logits instead of storing them. The JAX package pads the last slice
    with zero rows masked to ``-1e30``; here it is cut short, which is the same function.
    """
    lead = hidden.shape[:-1]
    d = hidden.shape[-1]
    v = embedding.shape[0]
    if tuple(targets.shape) != tuple(lead):
        raise ValueError(f"targets {tuple(targets.shape)} must match hidden leading {tuple(lead)}")
    x = hidden.reshape(-1, d).float()
    tgt = targets.reshape(-1).long()
    n = x.shape[0]
    chunk_size = min(chunk_size, -(-v // 128) * 128)
    m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tgt_logit = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for base in range(0, v, chunk_size):
        emb_c = embedding[base : base + chunk_size]
        # The chunk draws no random numbers: no RNG state to keep (reading it is not
        # allowed while a CUDA graph is being captured).
        m, l, tgt_logit = checkpoint(
            _chunk_step, x, emb_c, m, l, tgt_logit, tgt, base, use_reentrant=False, preserve_rng_state=False
        )
    nll = m + torch.log(torch.clamp(l, min=1e-30)) - tgt_logit
    return nll.reshape(lead)
