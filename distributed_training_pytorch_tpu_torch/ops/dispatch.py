"""Kernel dispatch policy: the one place that decides kernel or plain path, and records it.

Counterpart of ``distributed_training_pytorch_tpu/ops/dispatch.py`` (its recording half,
the attention policy and the fused 1x1-conv policy). Each resolution is recorded once per process as a
``kernel_dispatch`` decision ``(model, op, path, reason)`` and handed to an installed event
sink (normally ``EventLog.emit``); decisions made before a sink exists are buffered and
flushed on install.

The attention policy differs from the JAX package's on purpose. There, "auto" runs the
Pallas kernel on a TPU only, and only for ``T >= FLASH_MIN_SEQ_LEN`` (512), with 1024-row
blocks, all tuned on a TPU. Here "auto" resolves per call from the tensors' device: the
CUDA kernel for CUDA tensors at every ``T``, and the kernel's plain version for CPU
tensors. Nothing TPU-tuned carries over; a crossover, if the card shows one, comes from
measurements on the card.

VGG16 (:func:`vgg16_policy`) has no fused-kernel coverage (its convolutions are 3x3), so
every resolution is plain, and an explicit knob is recorded as the JAX package records it.

The fused 1x1-conv policy (:func:`conv1x1_policy`: ResNet's 1x1s, ConvNeXt's expand Dense +
GELU as ``op="dense_gelu"``) is the JAX package's: auto is off, and ``pallas=True`` /
``PALLAS=1`` turns it on. The TPU's verdict behind that default does not carry over; the
card's own evidence is each model's step with and without the kernel (``PERF.md``).

ViT records its plain resolution itself when ``pallas``/``use_flash`` is False, with the JAX
model's reason, and otherwise takes :func:`attention_fn`.

**Meta tensors** run no kernel. By default the hand kernels' wrappers (K1 to K4 and the
tied cross-entropy's checkpoint) take their plain versions on them, which is what the FLOP
count (``utils/flops.py``) needs: the products those kernels compute, without
recomputation. Under :func:`allocation_route` they take an allocation twin of the CUDA
route instead: the same wrapper code up to the launch, so the same outputs, copies and
saved tensors are allocated as on the card and no kernel runs (the memory trace of
``memory/analysis.py``). :func:`plain_route` is the one test of which a tensor's device
takes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "allocation_route",
    "allocation_route_active",
    "attention_fn",
    "clear_event_sink",
    "conv1x1_policy",
    "lm_attention_impl",
    "pallas_from_env",
    "plain_route",
    "record",
    "records",
    "reset",
    "resolve",
    "set_event_sink",
    "vgg16_policy",
]

_EVENT = "kernel_dispatch"

_lock = threading.Lock()
_seen: Dict[Tuple[str, str, str, str], Dict[str, Any]] = {}
_pending: List[Dict[str, Any]] = []
_sink: Optional[Callable[..., Any]] = None
_allocation_depth = 0  # open allocation_route() contexts, in any thread


@contextlib.contextmanager
def allocation_route():
    """While open, meta tensors take the kernels' allocation twins, not their plain
    versions (see the module docstring)."""
    global _allocation_depth
    with _lock:
        _allocation_depth += 1
    try:
        yield
    finally:
        with _lock:
            _allocation_depth -= 1


def allocation_route_active() -> bool:
    return _allocation_depth > 0


def plain_route(device) -> bool:
    """Whether a hand kernel's wrapper takes its plain version for tensors on ``device``:
    on the CPU, and on the meta device outside :func:`allocation_route`."""
    return device.type == "cpu" or (device.type == "meta" and not allocation_route_active())


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


def clear_event_sink() -> None:
    """Uninstall the sink (later decisions buffer again until the next sink)."""
    global _sink
    with _lock:
        _sink = None


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
        if q.device.type != "meta":  # a FLOP count (utils/flops.py) runs no path
            record(model, "attention", path, reason=reason, seq_len=seq)
        return flash_attention(q, k, v, causal=causal, valid_len=valid_len)

    return dispatching_attention


def pallas_from_env(env: Optional[dict] = None, *, default: Optional[bool] = None):
    """The entries' ``PALLAS`` knob: ``"1"`` -> True (the flash path for every call),
    ``"0"`` -> False (plain attention), unset or empty -> ``default`` (auto)."""
    if env is None:
        import os

        env = os.environ
    raw = env.get("PALLAS", "")
    if raw == "":
        return default
    if raw not in ("0", "1"):
        raise ValueError(f"PALLAS must be '0' or '1' (got {raw!r})")
    return raw == "1"


def lm_attention_impl(attention_impl: str, pallas: Optional[bool]) -> str:
    """Map TransformerLM's ``pallas`` knob onto its ``attention_impl`` string:
    True -> "flash", False -> "plain", None -> keep ``attention_impl``."""
    if pallas is True:
        return "flash"
    if pallas is False:
        return "plain"
    return attention_impl


def resolve(knob: Optional[bool], fallback):
    """Three-state resolution: an explicit ``pallas=`` knob wins; ``None`` defers to the
    model's own control (``fallback``)."""
    return fallback if knob is None else knob


def conv1x1_policy(
    model: str,
    pallas: Optional[bool],
    *,
    op: str = "conv1x1_bn_act",
    auto_off_reason: str = "auto: off, the JAX package's default; opt in with pallas=True",
) -> bool:
    """Resolve and record the fused GEMM-epilogue policy for ``model`` (``op``:
    ``"conv1x1_bn_act"`` for ResNet's 1x1s, ``"dense_gelu"`` for ConvNeXt's expand Dense +
    GELU): ``pallas`` wins, and auto (``None``) stays off."""
    on = resolve(pallas, False)
    if on:
        record(model, op, "pallas", reason="pallas=True")
    else:
        record(model, op, "plain", reason="pallas=False" if pallas is False else auto_off_reason)
    return bool(on)


def vgg16_policy(pallas: Optional[bool]) -> bool:
    """VGG16's policy: always plain (no fused-kernel coverage for 3x3 convolutions). An
    explicit ``pallas`` knob is consumed and the plain resolution recorded, as the JAX
    package's ``create_model`` records it; auto records nothing."""
    if pallas is not None:
        record("vgg16", "conv", "plain", reason="no fused-kernel coverage (3x3 convs) — pallas knob is a no-op")
    return False
