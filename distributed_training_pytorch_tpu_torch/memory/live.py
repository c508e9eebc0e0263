"""Live device memory: the one read of the CUDA caching allocator's counters.

Counterpart of ``distributed_training_pytorch_tpu/memory/live.py``. ``live_bytes`` is
``torch.cuda.memory_allocated`` (the bytes held by tensors) and ``peak_bytes``
``torch.cuda.max_memory_allocated`` (the high-water mark since the process started or the
last ``torch.cuda.reset_peak_memory_stats``). Both are host-side reads of the allocator's
counters: no device sync, so the trainer reads them at its existing ``log_every`` syncs
and feeds ``live_bytes`` to the anomaly detector's ``memory_growth`` check.

The CPU has no such counters: the fields are absent there, as the JAX package leaves them
out on its CPU backend. A process drives one card, so the JAX module's per-chip skew fields
(``live_bytes_min/max/skew``) do not arise.
"""

from __future__ import annotations

__all__ = ["window_memory_fields"]


def window_memory_fields(device, *, include_peak: bool = True) -> dict:
    """``{"live_bytes", "peak_bytes"}`` of ``device``, or ``{}`` off the card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    out = {"live_bytes": int(torch.cuda.memory_allocated(dev))}
    if include_peak:
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    return out
