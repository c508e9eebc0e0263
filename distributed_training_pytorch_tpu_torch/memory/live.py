"""Live device memory: the one read of the CUDA caching allocator's counters.

Counterpart of ``distributed_training_pytorch_tpu/memory/live.py``. ``live_bytes`` is
``torch.cuda.memory_allocated`` (the bytes held by tensors) and ``peak_bytes``
``torch.cuda.max_memory_allocated`` (the high-water mark since the process started or the
last ``torch.cuda.reset_peak_memory_stats``). Both are host-side reads of the allocator's
counters: no device sync, so the trainer reads them at its existing ``log_every`` syncs
and feeds ``live_bytes`` to the anomaly detector's ``memory_growth`` check.
:func:`device_capacity_bytes` is the card's total memory (``torch.cuda.mem_get_info``'s
second value), the preflight's denominator; :func:`device_free_bytes` its first value,
what is free now (less when another process shares the card).

Off the card (the CPU, a meta device) there are no such counters: every helper gives
absent fields or None, as the JAX package's do on its CPU backend. A process drives one
card, so :func:`memory_skew` has something to say only for a list of cards.
"""

from __future__ import annotations

__all__ = [
    "device_capacity_bytes",
    "device_free_bytes",
    "device_memory_stats",
    "is_oom_error",
    "live_memory_fields",
    "memory_skew",
    "window_memory_fields",
]


def _card(device):
    """``device`` as a CUDA ``torch.device``, or None off the card (None: the current
    card when there is one)."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def device_memory_stats(device=None) -> "dict | None":
    """``torch.cuda.memory_stats`` of the card, or None off the card."""
    import torch

    dev = _card(device)
    if dev is None:
        return None
    stats = torch.cuda.memory_stats(dev)
    return dict(stats) if stats else None


def device_capacity_bytes(device=None) -> "int | None":
    """The card's total memory, or None off the card."""
    import torch

    dev = _card(device)
    return None if dev is None else int(torch.cuda.mem_get_info(dev)[1])


def device_free_bytes(device=None) -> "int | None":
    """The card's free memory now (``cudaMemGetInfo``'s count, every process's), or None off it."""
    import torch

    dev = _card(device)
    return None if dev is None else int(torch.cuda.mem_get_info(dev)[0])


def window_memory_fields(device, *, include_peak: bool = True) -> dict:
    """``{"live_bytes", "peak_bytes"}`` of ``device``, or ``{}`` off the card."""
    import torch

    dev = _card(device)
    if dev is None:
        return {}
    out = {"live_bytes": int(torch.cuda.memory_allocated(dev))}
    if include_peak:
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    return out


def live_memory_fields(device=None, *, include_peak: bool = True) -> dict:
    """:func:`window_memory_fields` of ``device`` (None: the current card); ``{}`` off the
    card. ``include_peak=False`` leaves out the high-water mark, which covers everything
    since the last reset, not only the caller's run."""
    dev = _card(device)
    return {} if dev is None else window_memory_fields(dev, include_peak=include_peak)


def memory_skew(devices=None) -> dict:
    """``{"live_bytes_min", "live_bytes_max", "live_bytes_skew"}`` over ``devices`` (two
    or more cards), or ``{}``: one card (a process's own), or none."""
    import torch

    cards = [d for d in (_card(d) for d in (devices or [])) if d is not None]
    if len(cards) < 2:
        return {}
    live = [int(torch.cuda.memory_allocated(d)) for d in cards]
    return {"live_bytes_min": min(live), "live_bytes_max": max(live), "live_bytes_skew": max(live) - min(live)}


def is_oom_error(err: BaseException) -> bool:
    """Whether ``err`` is the card running out of memory: ``torch.OutOfMemoryError``, or
    an error whose text is the CUDA allocator's ("CUDA out of memory"). The host's
    ``MemoryError`` is not one."""
    import torch

    if isinstance(err, torch.OutOfMemoryError):
        return True
    return isinstance(err, RuntimeError) and "CUDA out of memory" in str(err)
