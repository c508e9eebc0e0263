"""Trace capture over ``torch.profiler``, and headless per-op summaries.

Counterpart of ``distributed_training_pytorch_tpu/profiling/trace.py``. A trace is
Kineto's Chrome-trace JSON (``<host>_<pid>.<ms>.pt.trace.json`` in the log directory),
with CUDA activity on the card: kernels, memcpys and memsets on the device's streams, and
the host's operators. It opens in Perfetto or ``chrome://tracing``;
``report.analyze_trace`` reads it here. The port has no counterpart of the JAX package's
``xplane.py`` (the XSpace codec): the reader parses this JSON.

Every session starts with one warm-up cycle of the profiler's schedule: the profiler is
prepared, a tiny operation runs and the device is synchronised, and only then does the
recorded cycle begin. A trace started in the middle of a long program otherwise missed its
first kernels (about 31 of them in one run on the card). The card's profiler still drops
the kernel records of the first launches of a recorded cycle, more of them as the process
ages (none in a young process, 20 to 24 after five minutes of GPT-2-small steps; waiting
before the traced work does not help). So on the card the session launches
``LEAD_KERNELS`` tiny kernels once the recorded cycle has begun, waits for them, then
marks the start of the traced work with the host annotation ``TRACE_START``;
:func:`load_device_events` keeps the device events launched after it (by CUPTI's
correlation id), so the lead kernels absorb the drop and are left out of the analysis.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import time
from contextlib import contextmanager
from typing import Iterator

import torch

__all__ = ["annotate", "latest_trace_file", "load_device_events", "start_session", "stop_session", "trace"]

TRACE_SUFFIX = ".pt.trace.json"
LEAD_KERNELS = 512
TRACE_START = "dtp_trace_start"


def _activities(device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def start_session(log_dir: str, device="cpu"):
    """Start a profiler session writing one trace into ``log_dir`` when stopped: the
    warm-up cycle first (see the module docstring), then recording. Returns the session
    for :func:`stop_session`."""
    from torch.profiler import profile, schedule

    os.makedirs(log_dir, exist_ok=True)

    def export(prof) -> None:
        name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1e3)}{TRACE_SUFFIX}"
        prof.export_chrome_trace(os.path.join(log_dir, name))

    prof = profile(activities=_activities(device), schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=export)
    prof.start()
    torch.ones(1, device=device).add_(1)
    _sync(device)
    prof.step()  # the warm-up cycle ends: record from here
    if torch.device(device).type == "cuda":
        lead = torch.zeros(1, device=device)
        for _ in range(LEAD_KERNELS):
            lead.add_(1)
        _sync(device)
    with torch.profiler.record_function(TRACE_START):
        pass
    return prof


def stop_session(prof, device="cpu") -> None:
    """Wait for the device's work (not with ``device`` None), stop the session and write
    its trace."""
    _sync(device)
    prof.stop()


@contextmanager
def trace(log_dir: str, device="cpu") -> Iterator[str]:
    """Trace the enclosed block into ``log_dir`` (CUDA activity when ``device`` is the
    card); yields the directory."""
    prof = start_session(log_dir, device)
    try:
        yield log_dir
    finally:
        stop_session(prof, device)


def annotate(name: str):
    """A named range in the trace: ``with annotate("train_step"):``."""
    return torch.profiler.record_function(name)


def latest_trace_file(log_dir: str) -> "str | None":
    """The newest ``*.pt.trace.json`` under ``log_dir``, or None."""
    paths = glob.glob(os.path.join(log_dir, "**", "*" + TRACE_SUFFIX), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_device_events(path: str) -> "tuple[str, list[tuple[str, float, float]]]":
    """``(source, [(name, start_us, dur_us), ...])`` of one trace: the device's kernels,
    copies and sets (``"device"``; with events on several cards, those of the busiest),
    or, in a trace without device activity, the host's operators (``"host"``). In a trace
    of :func:`start_session`, the device events launched before its ``TRACE_START`` mark
    (the lead kernels) are left out."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    marks = [float(e["ts"]) for e in events if e.get("name") == TRACE_START and "ts" in e]
    launched = [((e.get("args") or {}).get("correlation"), float(e["ts"])) for e in events
                if str(e.get("cat", "")).lower() == "cuda_runtime" and "ts" in e]
    after = [c for c, ts in launched if c is not None and marks and ts >= marks[0]]
    first = min(after) if after else None  # correlation ids grow with every launch
    by_device: "dict[object, list]" = {}
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        row = (str(e.get("name", "")), float(e["ts"]), float(e["dur"]))
        if cat in _DEVICE_CATS:
            correlation = (e.get("args") or {}).get("correlation")
            if first is not None and correlation is not None and correlation < first:
                continue
            by_device.setdefault((e.get("args") or {}).get("device", e.get("pid")), []).append(row)
        elif cat == "cpu_op":
            host.append(row)
    if by_device:
        busiest = max(by_device.items(), key=lambda kv: (sum(d for _, _, d in kv[1]), str(kv[0])))
        return "device", busiest[1]
    return "host", host
