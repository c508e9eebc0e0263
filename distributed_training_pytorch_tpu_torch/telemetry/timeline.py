"""One Chrome/Perfetto trace from a run's event log.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/timeline.py``, with the same
tracks, the same rules and the same output on the same log (the CPU tests hold the two
byte-equal): the records are laid on the monotonic clock the event log stamps (``t_mono``
seconds become the trace's ``ts`` microseconds) as trace-event JSON, which
``ui.perfetto.dev`` and ``chrome://tracing`` open.

========================  ==================================================
track                     contents
========================  ==================================================
``steps``                 one span per ``window`` record: steps x ``step_ms``
``epochs``                one span per ``epoch_end`` (``wall_s``)
``goodput``               each bucket's growth between consecutive cumulative
                          ``goodput_seconds`` snapshots, as spans laid end to
                          end: the spans summed per bucket are the meter's
                          seconds, so :func:`span_bucket_seconds` re-derives
                          its fractions
``goodput async``         ``checkpoint_async`` growth (background commits,
                          overlapped with training)
``checkpoint``            the loop's save stalls (``snapshot_ms``, ``save_ms``)
``committer``             the background committer: ``queued:<name>`` and
                          ``commit:<name>`` spans
``profile``               the ``profile_capture`` window (``span_us``)
``markers``               an instant for every other record (compile,
                          preemption, anomaly, memory_preflight, ...)
counters                  ``live_bytes`` and ``chip_skew_ms``
========================  ==================================================

A span that would start before its track's previous span ended is trimmed at its start
(the end is the record's timestamp), so every track's spans are monotone and do not
overlap. Heartbeats add their goodput snapshot to the goodput chain and no marker.
"""

from __future__ import annotations

import json
import os

from distributed_training_pytorch_tpu_torch.telemetry.events import load_run_events
from distributed_training_pytorch_tpu_torch.telemetry.goodput import BUCKETS

__all__ = ["TRACKS", "build_timeline", "export_timeline", "load_run_events", "span_bucket_seconds"]

# The trace-event thread id of each track; one pid per writing process, so each attempt of
# a resumed run lays out as its own process group.
TRACKS = {
    "steps": 1,
    "epochs": 2,
    "goodput": 3,
    "goodput async": 4,
    "checkpoint": 5,
    "committer": 6,
    "profile": 7,
    "markers": 8,
}

_COMMON_FIELDS = ("event", "t_wall", "t_mono", "process", "host", "pid", "chips", "schema")


class _Track:
    """One (pid, tid) lane whose spans never overlap."""

    def __init__(self, out: list, pid, tid: int):
        self._out = out
        self._pid = pid
        self._tid = tid
        self._cursor = None  # end (us) of the last span laid

    def span(self, name: str, end_us: float, dur_us: float, args: "dict | None" = None):
        dur_us = max(float(dur_us), 0.0)
        ts = end_us - dur_us
        if self._cursor is not None and ts < self._cursor:
            ts = min(self._cursor, end_us)  # keep the end (the timestamped fact), shorten
            dur_us = end_us - ts
        self._cursor = ts + dur_us
        ev = {"name": name, "ph": "X", "ts": ts, "dur": dur_us, "pid": self._pid, "tid": self._tid}
        if args:
            ev["args"] = args
        self._out.append(ev)


def _args(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _COMMON_FIELDS and not k.startswith("_")}


def build_timeline(events: "list[dict]") -> dict:
    """The trace-event dict of parsed event records (see the module docstring)."""
    out: "list[dict]" = []
    pids = []
    tracks: "dict[tuple, _Track]" = {}

    def track(pid, name: str) -> _Track:
        key = (pid, name)
        if key not in tracks:
            tracks[key] = _Track(out, pid, TRACKS[name])
        return tracks[key]

    def counter(pid, t_us, name, value):
        out.append({"name": name, "ph": "C", "ts": t_us, "pid": pid, "args": {name: float(value)}})

    # The goodput lanes advance on their own cursors from the first snapshot on: the meter's
    # ticks and a record's timestamp are different clock reads, and anchoring each span to
    # its record would trim microseconds off the exact per-bucket sums.
    last_goodput: dict = {}
    goodput_cursor: dict = {}
    async_cursor: dict = {}
    pending_snapshot: dict = {}

    for rec in sorted(events, key=lambda r: (r.get("pid", 0), r.get("t_mono", 0.0))):
        kind = rec.get("event")
        t = rec.get("t_mono")
        if kind is None or t is None:
            continue
        pid = rec.get("pid", 0)
        if pid not in pids:
            pids.append(pid)
        t_us = float(t) * 1e6
        args = _args(rec)
        args["line"] = rec.get("_line")

        snap = rec.get("goodput_seconds")
        if isinstance(snap, dict):
            prev = last_goodput.get(pid)
            if prev is None:
                goodput_cursor[pid] = async_cursor[pid] = t_us
            else:
                for bucket in BUCKETS:
                    delta = float(snap.get(bucket, 0.0)) - float(prev.get(bucket, 0.0))
                    if delta <= 0.0:
                        continue
                    dur = delta * 1e6
                    if bucket == "checkpoint_async":
                        track(pid, "goodput async").span(bucket, async_cursor[pid] + dur, dur,
                                                         {"line": rec.get("_line")})
                        async_cursor[pid] += dur
                    else:
                        track(pid, "goodput").span(bucket, goodput_cursor[pid] + dur, dur)
                        goodput_cursor[pid] += dur
            last_goodput[pid] = dict(snap)

        if kind == "heartbeat":
            continue

        if kind == "window":
            steps = float(rec.get("steps", 0) or 0)
            step_ms = float(rec.get("step_ms", 0.0) or 0.0)
            track(pid, "steps").span(f"window@{rec.get('step_in_epoch')}", t_us, steps * step_ms * 1e3, args)
            if rec.get("live_bytes") is not None:
                counter(pid, t_us, "live_bytes", rec["live_bytes"])
            if rec.get("chip_skew_ms") is not None:
                counter(pid, t_us, "chip_skew_ms", rec["chip_skew_ms"])
            continue
        if kind == "epoch_end":
            track(pid, "epochs").span(f"epoch {rec.get('epoch')}", t_us, float(rec.get("wall_s", 0.0)) * 1e6, args)
            if rec.get("live_bytes") is not None:
                counter(pid, t_us, "live_bytes", rec["live_bytes"])
            continue
        if kind == "checkpoint_save":
            name = str(rec.get("name", "ckpt"))
            if rec.get("snapshot_ms") is not None:
                track(pid, "checkpoint").span(f"snapshot:{name}", t_us, float(rec["snapshot_ms"]) * 1e3, args)
                pending_snapshot[(pid, name)] = t_us
            elif rec.get("save_ms") is not None:
                track(pid, "checkpoint").span(f"save:{name}", t_us, float(rec["save_ms"]) * 1e3, args)
            else:
                out.append({"name": f"save:{name}", "ph": "i", "ts": t_us, "s": "t", "pid": pid,
                            "tid": TRACKS["checkpoint"], "args": args})
            continue
        if kind == "checkpoint_commit":
            name = str(rec.get("name", "ckpt"))
            commit_us = float(rec.get("commit_ms", 0.0) or 0.0) * 1e3
            queued_from = pending_snapshot.pop((pid, name), None)
            commit_start = t_us - commit_us
            if queued_from is not None and commit_start > queued_from:
                track(pid, "committer").span(f"queued:{name}", commit_start, commit_start - queued_from)
            track(pid, "committer").span(f"commit:{name}", t_us, commit_us, args)
            continue
        if kind == "profile_capture" and rec.get("span_us") is not None:
            track(pid, "profile").span("profile_capture", t_us, float(rec["span_us"]), args)
            continue

        out.append({"name": str(kind), "ph": "i", "ts": t_us, "s": "t", "pid": pid, "tid": TRACKS["markers"],
                    "args": args})

    meta = []
    for pid in pids:
        host = next((r.get("host") for r in events if r.get("pid") == pid), None)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"pid {pid}" + (f" @ {host}" if host else "")}})
        for name, tid in TRACKS.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": name}})
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def span_bucket_seconds(trace: dict) -> dict:
    """Seconds per goodput bucket, summed over the ``goodput`` and ``goodput async``
    lanes' spans: the meter's own seconds, re-derived from the trace."""
    lanes = {TRACKS["goodput"], TRACKS["goodput async"]}
    totals = {b: 0.0 for b in BUCKETS}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("tid") in lanes and ev.get("name") in totals:
            totals[ev["name"]] += float(ev.get("dur", 0.0)) / 1e6
    return totals


def export_timeline(run_dir: str, out_path: "str | None" = None) -> "tuple[dict, str]":
    """Build the trace of a run directory's event log (or of an ``events.jsonl`` path) and
    write it as JSON; ``(trace, path)``. The default path is
    ``<run_dir>/telemetry/timeline.json`` (``<stem>.timeline.json`` for a log file)."""
    trace = build_timeline(load_run_events(run_dir))
    if out_path is None:
        if os.path.isdir(run_dir):
            out_path = os.path.join(run_dir, "telemetry", "timeline.json")
        else:
            out_path = os.path.splitext(run_dir)[0] + ".timeline.json"
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace, out_path
