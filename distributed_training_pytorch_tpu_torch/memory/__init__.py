"""Device memory: where a step's memory goes, and whether it fits, before it runs.

Counterpart of ``distributed_training_pytorch_tpu/memory/``, on the CUDA caching
allocator's terms:

* :mod:`~.analysis`: the predicted peak of the engine's own step (a trace on meta
  tensors through the kernels' allocation twins), split over params / optimizer state /
  gradients / activations / input batch / executable, summing to the peak;
* :mod:`~.preflight`: that prediction against the card's capacity before the first
  dispatch, and on a predicted OOM the largest batch and the smallest accumulation factor
  that fit (``Trainer(preflight="on")``; ``None`` runs nothing of it);
* :mod:`~.live`: the allocator's live and peak bytes, the card's capacity, and the OOM
  test, each absent off the card.

The JAX module's HLO readers (``top_buffers_from_hlo``, ``memory_stats_dict``,
``predicted_peak_bytes`` of a compiled object, ``attribute_memory`` over XLA's totals) have
no counterpart: the port has no compiled program to read.
"""

from distributed_training_pytorch_tpu_torch.memory.analysis import (
    BUFFER_CLASSES,
    MemoryProfile,
    analyze_step_memory,
    batch_class_bytes,
    state_class_bytes,
)
from distributed_training_pytorch_tpu_torch.memory.live import (
    device_capacity_bytes,
    device_free_bytes,
    device_memory_stats,
    is_oom_error,
    live_memory_fields,
    memory_skew,
    window_memory_fields,
)
from distributed_training_pytorch_tpu_torch.memory.preflight import (
    Preflight,
    PreflightOOMError,
    PreflightReport,
    resolve_preflight,
    run_preflight,
)

__all__ = [
    "BUFFER_CLASSES",
    "MemoryProfile",
    "Preflight",
    "PreflightOOMError",
    "PreflightReport",
    "analyze_step_memory",
    "batch_class_bytes",
    "device_capacity_bytes",
    "device_free_bytes",
    "device_memory_stats",
    "is_oom_error",
    "live_memory_fields",
    "memory_skew",
    "resolve_preflight",
    "run_preflight",
    "state_class_bytes",
    "window_memory_fields",
]
