"""Profiling: where the device's time goes, in the port.

Counterpart of ``distributed_training_pytorch_tpu/profiling/``:

* :mod:`~.trace`: ``trace``/``annotate`` over ``torch.profiler`` (Kineto's Chrome-trace
  JSON, CUDA activity on the card);
* :mod:`~.categories`: the one categorizer of CUDA kernel and Kineto event names, onto
  the JAX package's categories;
* :mod:`~.report`: ``analyze_trace``/``analyze_events`` -> :class:`StepProfile` (device
  wall across categories plus ``idle``, summing to 1; the top ops);
* :mod:`~.capture`: ``Trainer(profile=ProfileConfig(...))``, a traced window of real
  steps and its ``profile_capture`` event;
* :mod:`~.diff`: two step profiles' per-category and per-op deltas, the one delta
  attribution of ``scripts/torch_run_compare.py`` and ``scripts/torch_perf_gate.py``;
* :mod:`~.gate`: the perf gate's rule against ``TORCH_PERF_BASELINE.json``.

The JAX package's ``xplane`` codec has no counterpart (the traces are JSON).
"""

from distributed_training_pytorch_tpu_torch.profiling.capture import ProfileConfig, StepTraceCapture, resolve_profile
from distributed_training_pytorch_tpu_torch.profiling.categories import CATEGORIES, IDLE, categorize
from distributed_training_pytorch_tpu_torch.profiling.report import (
    REPORT_FIELDS,
    OpRow,
    StepProfile,
    analyze_events,
    analyze_trace,
    busy_us,
    profile_events,
)
from distributed_training_pytorch_tpu_torch.profiling.trace import annotate, latest_trace_file, trace

__all__ = [
    "CATEGORIES",
    "IDLE",
    "OpRow",
    "ProfileConfig",
    "REPORT_FIELDS",
    "StepProfile",
    "StepTraceCapture",
    "analyze_events",
    "analyze_trace",
    "annotate",
    "busy_us",
    "categorize",
    "latest_trace_file",
    "profile_events",
    "resolve_profile",
    "trace",
]
