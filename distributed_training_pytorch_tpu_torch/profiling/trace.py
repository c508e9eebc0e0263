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
first kernels (about 31 of them in one run on the card).
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
    or, in a trace without device activity, the host's operators (``"host"``)."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    by_device: "dict[object, list]" = {}
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        row = (str(e.get("name", "")), float(e["ts"]), float(e["dur"]))
        if cat in _DEVICE_CATS:
            by_device.setdefault((e.get("args") or {}).get("device", e.get("pid")), []).append(row)
        elif cat == "cpu_op":
            host.append(row)
    if by_device:
        busiest = max(by_device.items(), key=lambda kv: (sum(d for _, _, d in kv[1]), str(kv[0])))
        return "device", busiest[1]
    return "host", host
