"""Trace analysis: device-time attribution and the dispatch-gap audit.

Counterpart of ``distributed_training_pytorch_tpu/profiling/report.py``: a trace becomes
a :class:`StepProfile` with the same fields. ``busy_us`` is the union of the device's
kernel, copy and set intervals (a copy on a side stream under a kernel counts once),
``idle`` the rest of the traced span, and ``categories`` the span shared out over
``profiling.categories`` in proportion to each category's own time, plus ``idle``: the
fractions sum to 1 by construction. ``source`` is ``"device"``, or ``"host"`` for a trace
without device activity (a CPU run), whose operators overlap (nested and on several
threads), so their union is the busy time there too.

An :class:`OpRow`'s ``flops``, ``bytes`` and ``arith_intensity`` are None: the JAX
package joins them from the compiled HLO's per-instruction itemisation, and a CUDA
kernel's name carries nothing to join on (``utils/flops.py`` counts a whole step). They
stay in the schema so a consumer of either package reads the same keys.

The sources of events: :func:`analyze_trace` reads a Kineto trace file
(``profiling/trace.py``); :func:`profile_events` takes the device events of a live
``torch.profiler.profile`` (how ``chip_smoke.py`` and the ``scripts/torch_*_profile.py``
use it); :func:`analyze_events` is the one analysis behind both.
"""

from __future__ import annotations

import dataclasses
import os

from distributed_training_pytorch_tpu_torch.profiling.categories import IDLE, categorize
from distributed_training_pytorch_tpu_torch.profiling.trace import TRACE_SUFFIX, latest_trace_file, load_device_events

__all__ = ["OpRow", "REPORT_FIELDS", "StepProfile", "analyze_events", "analyze_trace", "busy_us", "profile_events"]


@dataclasses.dataclass
class OpRow:
    """One per-op line of the attribution table."""

    name: str
    category: str
    total_us: float
    count: int
    frac_busy: float  # share of summed op time
    flops: "float | None" = None
    bytes: "float | None" = None
    arith_intensity: "float | None" = None

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "category": self.category,
            "total_us": round(self.total_us, 1),
            "count": self.count,
            "frac_busy": round(self.frac_busy, 4),
        }
        if self.flops is not None:
            out["flops"] = self.flops
        if self.bytes is not None:
            out["bytes"] = self.bytes
        if self.arith_intensity is not None:
            out["arith_intensity"] = round(self.arith_intensity, 2)
        return out


REPORT_FIELDS = (
    "trace_path",
    "source",
    "steps",
    "span_us",
    "busy_us",
    "idle_us",
    "step_us",
    "device_busy_frac",
    "dispatch_gap_frac",
    "categories",
    "category_us",
    "top_ops",
)


@dataclasses.dataclass
class StepProfile:
    """Device-time attribution for one traced window of steps (see the module
    docstring); ``to_dict`` carries exactly :data:`REPORT_FIELDS`."""

    trace_path: str
    source: str  # "device" | "host"
    steps: "int | None"
    span_us: float
    busy_us: float
    idle_us: float
    categories: "dict[str, float]"
    category_us: "dict[str, float]"
    top_ops: "list[OpRow]"
    step_us: "float | None" = None
    device_busy_frac: float = 0.0
    dispatch_gap_frac: float = 0.0

    def to_dict(self) -> dict:
        return {
            "trace_path": self.trace_path,
            "source": self.source,
            "steps": self.steps,
            "span_us": round(self.span_us, 1),
            "busy_us": round(self.busy_us, 1),
            "idle_us": round(self.idle_us, 1),
            "step_us": round(self.step_us, 1) if self.step_us is not None else None,
            "device_busy_frac": round(self.device_busy_frac, 4),
            "dispatch_gap_frac": round(self.dispatch_gap_frac, 4),
            "categories": {k: round(v, 4) for k, v in self.categories.items()},
            "category_us": {k: round(v, 1) for k, v in self.category_us.items()},
            "top_ops": [row.to_dict() for row in self.top_ops],
        }

    def summary(self) -> str:
        """One log line: the busy/idle split and the two hottest categories."""
        hot = sorted(((k, v) for k, v in self.categories.items() if k != IDLE), key=lambda kv: -kv[1])[:2]
        hot_txt = ", ".join(f"{k} {100 * v:.0f}%" for k, v in hot)
        return (
            f"device busy {100 * self.device_busy_frac:.0f}% / gap {100 * self.dispatch_gap_frac:.0f}% over "
            f"{self.span_us / 1e3:.2f} ms"
            + (f" ({self.steps} steps)" if self.steps else "")
            + (f"; hottest: {hot_txt}" if hot_txt else "")
        )


def busy_us(events) -> float:
    """The length (us) of the union of ``[start, start + dur)`` over ``events``, rows of
    ``(name, start_us, dur_us)``."""
    spans = sorted((start, start + dur) for _, start, dur in events)
    total, covered = 0.0, None
    for start, end in spans:
        if covered is None or start > covered:
            total += end - start
            covered = end
        elif end > covered:
            total += end - covered
            covered = end
    return total


def profile_events(prof) -> "list[tuple[str, float, float]]":
    """The device events (kernels, copies, sets) of a live ``torch.profiler.profile``
    as ``(name, start_us, dur_us)`` rows."""
    from torch.autograd import DeviceType

    return [(e.name, float(e.time_range.start), float(e.time_range.end - e.time_range.start))
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def analyze_events(events, *, source: str = "device", trace_path: str = "", steps: "int | None" = None,
                   top_k: int = 20) -> StepProfile:
    """The :class:`StepProfile` of ``(name, start_us, dur_us)`` rows. Raises
    ``ValueError`` with no events."""
    events = list(events)
    if not events:
        raise ValueError(f"{trace_path or 'trace'}: no device or host events — was anything run while tracing?")
    span_us = max(max(s + d for _, s, d in events) - min(s for _, s, _ in events), 1e-9)
    busy = min(busy_us(events), span_us)
    idle = max(span_us - busy, 0.0)
    totals: "dict[str, list]" = {}
    for name, _, dur in events:
        acc = totals.setdefault(name, [0.0, 0])
        acc[0] += dur
        acc[1] += 1
    op_total_us = sum(t for t, _ in totals.values()) or 1e-9
    category_us: "dict[str, float]" = {}
    for name, (total, _) in totals.items():
        cat = categorize(name)
        category_us[cat] = category_us.get(cat, 0.0) + total
    busy_frac = busy / span_us
    categories = {cat: (total / op_total_us) * busy_frac for cat, total in category_us.items()}
    categories[IDLE] = idle / span_us
    rows = [
        OpRow(name=name, category=categorize(name), total_us=total, count=count, frac_busy=total / op_total_us)
        for name, (total, count) in sorted(totals.items(), key=lambda kv: -kv[1][0])[:top_k]
    ]
    return StepProfile(
        trace_path=trace_path,
        source=source,
        steps=steps,
        span_us=span_us,
        busy_us=busy,
        idle_us=idle,
        step_us=span_us / steps if steps else None,
        device_busy_frac=busy_frac,
        dispatch_gap_frac=idle / span_us,
        categories=categories,
        category_us=category_us,
        top_ops=rows,
    )


def analyze_trace(log_dir_or_file: str, *, steps: "int | None" = None, top_k: int = 20) -> StepProfile:
    """The newest trace under ``log_dir_or_file`` (or that file) as a
    :class:`StepProfile`. Raises ``FileNotFoundError`` without a trace and ``ValueError``
    when it holds no events."""
    path = log_dir_or_file
    if not path.endswith(TRACE_SUFFIX) and not os.path.isfile(path):
        found = latest_trace_file(path)
        if found is None:
            raise FileNotFoundError(f"no *{TRACE_SUFFIX} under {log_dir_or_file}")
        path = found
    source, events = load_device_events(path)
    return analyze_events(events, source=source, trace_path=os.path.abspath(path), steps=steps, top_k=top_k)
