"""Kernel dispatch policy: the one place that decides kernel or plain path, and records it.

Counterpart of ``distributed_training_pytorch_tpu/ops/dispatch.py`` (its recording half
and the attention policy). Each resolution is recorded once per process as a
``kernel_dispatch`` decision ``(model, op, path, reason)`` and handed to an installed event
sink (normally ``EventLog.emit``); decisions made before a sink exists are buffered and
flushed on install.

The attention policy differs from the JAX package's on purpose. There, "auto" runs the
Pallas kernel on a TPU only, and only for ``T >= FLASH_MIN_SEQ_LEN`` (512), with 1024-row
blocks, all tuned on a TPU. Here "auto" resolves per call from the tensors' device: the
CUDA kernel for CUDA tensors at every ``T``, and the kernel's plain version for CPU
tensors. Nothing TPU-tuned carries over; a crossover, if the card shows one, comes from
measurements on the card.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "attention_fn",
    "lm_attention_impl",
    "record",
    "records",
    "reset",
    "set_event_sink",
]

_EVENT = "kernel_dispatch"

_lock = threading.Lock()
_seen: Dict[Tuple[str, str, str, str], Dict[str, Any]] = {}
_pending: List[Dict[str, Any]] = []
_sink: Optional[Callable[..., Any]] = None


def record(model: str, op: str, path: str, *, reason: str = "", **detail) -> bool:
    """Record one dispatch decision; dedup on ``(model, op, path, reason)``.
    Returns True the first time a decision is seen, False for a dedup hit."""
    key = (model, op, path, reason)
    fields = {"model": model, "op": op, "path": path, "reason": reason}
    fields.update(detail)
    with _lock:
        if key in _seen:
            return False
        _seen[key] = fields
        sink = _sink
        if sink is None:
            _pending.append(fields)
            return True
    # Emit outside the lock: the sink (EventLog.emit) takes its own lock.
    sink(_EVENT, **fields)
    return True


def records() -> List[Dict[str, Any]]:
    """Snapshot of every decision recorded so far."""
    with _lock:
        return [dict(f) for f in _seen.values()]


def set_event_sink(emit: Callable[..., Any]) -> None:
    """Install ``emit(event, **fields)`` and flush the decisions buffered before it."""
    global _sink
    with _lock:
        _sink = emit
        pending, _pending[:] = list(_pending), []
    for fields in pending:
        emit(_EVENT, **fields)


def reset() -> None:
    """Testing hook: forget all decisions, buffers, and the sink."""
    global _sink
    with _lock:
        _seen.clear()
        _pending[:] = []
        _sink = None


def attention_fn(model: str, use_flash: Optional[bool], *, causal: bool = False):
    """Resolve the attention path for ``model``: a ``(q, k, v, valid_len=None) -> o``
    callable, or ``None`` meaning *use the caller's plain path*.

    ``use_flash``: ``False`` -> plain; ``True`` -> the flash wrapper for every call;
    ``None`` (auto) -> the flash wrapper too, which runs the CUDA kernel on CUDA tensors
    and its plain version on CPU tensors. The callable records the path each call took.
    """
    if use_flash is False:
        record(model, "attention", "plain", reason="pallas=False")
        return None
    from distributed_training_pytorch_tpu_torch.ops.flash_attention import flash_attention

    def dispatching_attention(q, k, v, valid_len=None):
        seq = q.shape[1]
        if use_flash is True:
            path, reason = "flash", "pallas=True (forced)"
        elif q.device.type == "cuda":
            path = "flash"
            reason = "auto: cuda tensors -> CUDA kernel at every T (no TPU-tuned FLASH_MIN_SEQ_LEN)"
        else:
            path = "plain"
            reason = f"auto: {q.device.type} tensors -> the kernel's plain version"
        record(model, "attention", path, reason=reason, seq_len=seq)
        return flash_attention(q, k, v, causal=causal, valid_len=valid_len)

    return dispatching_attention


def lm_attention_impl(attention_impl: str, pallas: Optional[bool]) -> str:
    """Map TransformerLM's ``pallas`` knob onto its ``attention_impl`` string:
    True -> "flash", False -> "plain", None -> keep ``attention_impl``."""
    if pallas is True:
        return "flash"
    if pallas is False:
        return "plain"
    return attention_impl
