"""The port's readers held byte-equal to the JAX package's on the same inputs.

``telemetry/timeline.py``, ``telemetry/monitor.py``, ``telemetry/history.py``,
``profiling/diff.py`` and ``profiling/gate.py`` of the port against their JAX counterparts,
compared as ``json.dumps(..., sort_keys=True)``:

* the timeline of a synthetic two-process log that lays every track (windows and their
  counters, epochs, the goodput chain with async commits, the three save kinds, the
  committer's queued and commit spans, a profile capture, markers, a span trimmed at its
  start, a record without ``t_mono``), and ``span_bucket_seconds`` of it;
* the monitor's status at every poll of one scripted log under one fake clock (waiting,
  training with a debounced data_bound alert and an anomaly, stale_heartbeat from the
  watchdog's heartbeats, dead, finished, a new attempt), and a server's log (serving,
  an SLO breach, draining); ``worst_exit_code`` and the fleet rows;
* ``diff_profiles`` over report dicts with and without step counts, intensities and a
  ridge, and ``attribute_entry_delta``/``describe_rows``;
* the gate's verdict on every metric and tolerance path, its errors, and the file
  ``update_baseline`` writes;
* ``analyze_history`` of the committed ``BENCH_r*.json``/``MULTICHIP_r*.json`` rounds, and
  its detectors' boundaries; ``scripts/torch_bench_history.py --self-test`` on them.

The real port run of ``tests/test_torch_telemetry_run.py`` is held the same way there.
"""

import dataclasses
import json
import os
import runpy
import sys

import pytest

from distributed_training_pytorch_tpu.profiling import diff as jax_diff
from distributed_training_pytorch_tpu.profiling import gate as jax_gate
from distributed_training_pytorch_tpu.telemetry import history as jax_history
from distributed_training_pytorch_tpu.telemetry import monitor as jax_monitor
from distributed_training_pytorch_tpu.telemetry import timeline as jax_timeline
from distributed_training_pytorch_tpu.telemetry.events import load_run_events as jax_load_run_events
from distributed_training_pytorch_tpu_torch.profiling import diff as port_diff
from distributed_training_pytorch_tpu_torch.profiling import gate as port_gate
from distributed_training_pytorch_tpu_torch.telemetry import history as port_history
from distributed_training_pytorch_tpu_torch.telemetry import monitor as port_monitor
from distributed_training_pytorch_tpu_torch.telemetry import timeline as port_timeline
from distributed_training_pytorch_tpu_torch.telemetry.events import load_run_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def _goodput(**seconds):
    out = {b: 0.0 for b in ("productive_step", "compile", "data_wait", "checkpoint", "checkpoint_async",
                            "restart_rollback", "other")}
    out.update(seconds)
    return out


class _Log:
    """A hand-written event log: each record gets the common fields the EventLog writes."""

    def __init__(self, path, pid=100, t0=1000.0, wall0=None):
        self.path, self.pid, self.t, self.wall = path, pid, t0, wall0
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def emit(self, event, dt=1.0, **fields):
        import time

        self.t += dt
        rec = {"event": event, "t_wall": (self.wall if self.wall is not None else time.time()) + self.t,
               "t_mono": self.t, "process": 0, "host": "h", "pid": self.pid, "chips": "", "schema": 8, **fields}
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


@pytest.fixture(scope="module")
def timeline_log(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("timeline") / "telemetry" / "events.jsonl")
    a, b = _Log(path, pid=100, wall0=0.0), _Log(path, pid=200, t0=5000.0, wall0=0.0)
    a.emit("run_start", goodput_seconds=_goodput(), attempt=1, provenance={"torch": "x"})
    a.emit("window", steps=4, step_ms=120.0, step_in_epoch=4, live_bytes=1000, chip_skew_ms=2.5, mfu=0.3)
    a.emit("window", dt=0.1, steps=4, step_ms=150.0, step_in_epoch=8, live_bytes=1200)  # overlaps: trimmed
    a.emit("heartbeat", source="loop", goodput_seconds=_goodput(productive_step=0.9, compile=0.3, data_wait=0.05))
    a.emit("checkpoint_save", name="last", snapshot_ms=40.0)
    a.emit("checkpoint_commit", dt=2.0, name="last", commit_ms=500.0)
    a.emit("checkpoint_save", name="best", save_ms=900.0)
    a.emit("checkpoint_save", name="epoch_1")
    a.emit("profile_capture", span_us=4e5, categories={"matmul": 0.5, "idle": 0.5}, steps=4)
    a.emit("compile", kind="cuda_graph", executables=1)
    a.emit("anomaly", kind="loss_spike", value=9.0)
    a.emit("memory_preflight", fits=True, predicted_peak_bytes=123)
    a.emit("epoch_end", epoch=0, wall_s=6.5, live_bytes=1300,
           goodput_seconds=_goodput(productive_step=3.0, compile=0.3, data_wait=0.2, checkpoint=0.9,
                                    checkpoint_async=0.5, other=0.1))
    a.emit("run_end", goodput_seconds=_goodput(productive_step=3.5, compile=0.3, data_wait=0.25, checkpoint=0.95,
                                               checkpoint_async=0.5, other=0.2), goodput_fractions={})
    b.emit("run_start", goodput_seconds=_goodput(restart_rollback=1.5), attempt=2)
    b.emit("window", steps=2, step_ms=80.0, step_in_epoch=2)
    b.emit("preemption", epoch=0)
    b.emit("run_end", goodput_seconds=_goodput(restart_rollback=1.5, productive_step=0.4, other=0.01))
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps({"event": "note", "pid": 100}) + "\n")  # no t_mono: skipped
    return os.path.dirname(os.path.dirname(path))


def test_timeline_is_the_jax_timeline(timeline_log):
    ours = port_timeline.build_timeline(load_run_events(timeline_log))
    theirs = jax_timeline.build_timeline(jax_load_run_events(timeline_log))
    assert dumps(ours) == dumps(theirs)
    names = {(ev.get("tid"), ev["name"].split(":")[0]) for ev in ours["traceEvents"] if ev["ph"] == "X"}
    for tid, name in ((1, "window@4"), (2, "epoch 0"), (3, "productive_step"), (4, "checkpoint_async"),
                      (5, "snapshot"), (5, "save"), (6, "queued"), (6, "commit"), (7, "profile_capture")):
        assert (tid, name) in names, (tid, name)
    assert {ev["name"] for ev in ours["traceEvents"] if ev["ph"] == "C"} == {"live_bytes", "chip_skew_ms"}
    assert dumps(port_timeline.span_bucket_seconds(ours)) == dumps(jax_timeline.span_bucket_seconds(theirs))
    trace, path = port_timeline.export_timeline(timeline_log)
    with open(path) as f:
        assert dumps(json.load(f)) == dumps(theirs) == dumps(trace)


def _poll_both(monitors, clock, now):
    clock[0] = now
    a, b = (m.poll() for m in monitors)
    assert dumps(a.to_dict()) == dumps(b.to_dict())
    assert a.describe() == b.describe() and dumps(a.fleet_row()) == dumps(b.fleet_row())
    assert a.exit_code == b.exit_code
    return a


def test_monitor_statuses_and_alerts_are_the_jax_monitor(tmp_path):
    import time

    run = str(tmp_path / "run")
    path = os.path.join(run, "telemetry", "events.jsonl")
    clock = [0.0]
    config = dict(stale_after_s=30.0, dead_after_s=90.0, min_steady_s=1.0)
    monitors = [mod.RunMonitor(run, mod.AlertConfig(**config), clock=lambda: clock[0])
                for mod in (port_monitor, jax_monitor)]
    seen, fired = [], []

    def poll(offset):
        st = _poll_both(monitors, clock, time.time() + offset)
        seen.append(st.status)
        fired.extend(a["rule"] for a in st.alerts)
        return st

    poll(0.0)  # no log yet
    log = _Log(path, t0=0.0)
    log.emit("run_start", dt=0.0, attempt=1, epoch=0, goodput_seconds=_goodput())
    log.emit("heartbeat", dt=0.0, source="loop", epoch=0, step_in_epoch=0, units=0)
    poll(1.0)
    for i in range(3):
        log.emit("window", dt=0.0, epoch=0, step_in_epoch=4 * (i + 1), steps=4, step_ms=100.0,
                 goodput_seconds=_goodput(productive_step=2.0 * (i + 1), data_wait=1.5 * (i + 1)))
        poll(1.0)  # data_bound fires once, at the first poll over its line
    log.emit("anomaly", dt=0.0, kind="loss_spike", value=10.0)
    log.emit("compile", dt=0.0, kind="cuda_graph", epoch=1, executables=1)
    poll(1.0)
    log.emit("heartbeat", dt=0.0, source="watchdog", since_progress_s=45.0, epoch=0, step_in_epoch=12, units=3)
    poll(45.0)  # records still come, no unit for 45 s
    poll(200.0)  # silent
    log.emit("run_end", dt=0.0, goodput_seconds=_goodput(productive_step=6.0, data_wait=4.5))
    poll(201.0)
    log.t = 201.5  # the restarted attempt writes now
    log.emit("run_start", dt=0.0, attempt=2, epoch=1, goodput_seconds=_goodput(productive_step=6.0, data_wait=4.5))
    log.emit("window", dt=0.0, epoch=1, step_in_epoch=4, steps=4, step_ms=90.0,
             goodput_seconds=_goodput(productive_step=8.0, data_wait=4.6))
    poll(202.0)
    assert [s for i, s in enumerate(seen) if i == 0 or s != seen[i - 1]] == [
        "waiting", "training", "stale_heartbeat", "dead", "finished", "training"]
    assert fired.count("data_bound") == 1 and "anomaly:loss_spike" in fired and "dead" in fired
    assert "stale_heartbeat" in fired

    serve = str(tmp_path / "serve")
    slog = _Log(os.path.join(serve, "telemetry", "events.jsonl"), t0=0.0)
    servers = [mod.RunMonitor(serve, mod.AlertConfig(**config), clock=lambda: clock[0])
               for mod in (port_monitor, jax_monitor)]
    slog.emit("serve_start", dt=0.0, attempt=1)
    slog.emit("request_batch", dt=0.0, qps=50.0, p50_ms=8.0, p99_ms=40.0, slo_ok=False, slo_p99_ms=30.0,
              params_version="best@e1", state="serving")
    a = _poll_both(servers, clock, time.time() + 1.0)
    assert (a.status, a.verdict, a.kind) == ("serving", "slo_breach", "serve")
    slog.emit("drain_start", dt=0.0)
    b = _poll_both(servers, clock, time.time() + 1.0)
    assert b.status == "draining"
    trainer_status = monitors[0].poll()
    rows = [trainer_status, b]
    assert port_monitor.worst_exit_code(rows) == jax_monitor.worst_exit_code(rows)
    assert port_monitor.worst_exit_code([]) == jax_monitor.worst_exit_code([]) == 3


def _profile(step_us, categories, ops, steps=4, trace="a.json"):
    return {"trace_path": trace, "source": "device", "steps": steps, "span_us": step_us * (steps or 1),
            "step_us": step_us if steps else None, "categories": categories, "top_ops": ops}


@pytest.mark.parametrize("ridge", [None, 200.0])
def test_diff_profiles_is_the_jax_diff(ridge):
    before = _profile(1000.0, {"matmul": 0.5, "fusion(elementwise)": 0.3, "idle": 0.2}, [
        {"name": "gemm_a", "category": "matmul", "total_us": 1600.0, "arith_intensity": 150.0},
        {"name": "add", "category": "fusion(elementwise)", "total_us": 1200.0},
        {"name": "old_copy", "category": "copy/transpose", "total_us": 40.0}])
    after = _profile(1300.0, {"matmul": 0.45, "fusion(elementwise)": 0.35, "collective": 0.05, "idle": 0.15}, [
        {"name": "gemm_a", "category": "matmul", "total_us": 2340.0, "arith_intensity": 260.0},
        {"name": "add", "category": "fusion(elementwise)", "total_us": 1820.0},
        {"name": "nccl_all_reduce", "category": "collective", "total_us": 260.0}], trace="b.json")
    for a, b in ((before, after), (after, before), (before, dict(after, steps=None, step_us=None, span_us=5000.0))):
        ours = port_diff.diff_profiles(a, b, ridge_intensity=ridge, top_k=5)
        theirs = jax_diff.diff_profiles(a, b, ridge_intensity=ridge, top_k=5)
        assert dumps(ours.to_dict()) == dumps(theirs.to_dict())
        assert ours.describe() == theirs.describe()
        assert ours.max_category_delta_frac() == theirs.max_category_delta_frac()
        assert sum(r.delta for r in ours.categories) == pytest.approx(ours.step_delta_us, rel=1e-12)
    entry_a, entry_b = {"step_ms": 10.0, "categories": before["categories"]}, {"step_ms": 13.0,
                                                                              "categories": after["categories"]}
    ours = port_diff.attribute_entry_delta(entry_a, entry_b)
    theirs = jax_diff.attribute_entry_delta(entry_a, entry_b)
    assert dumps([r.to_dict() for r in ours]) == dumps([r.to_dict() for r in theirs])
    assert port_diff.describe_rows(ours, top=2) == jax_diff.describe_rows(theirs, top=2)
    assert port_diff.attribute_entry_delta({"step_ms": 1.0}, entry_b) is None is jax_diff.attribute_entry_delta(
        {"step_ms": 1.0}, entry_b)


def test_the_gate_is_the_jax_gate(tmp_path):
    baseline = {"entries": {
        "quick-cuda": {"step_per_calib": 2.0, "step_ms": 0.2, "categories": {"matmul": 0.6, "idle": 0.4}},
        "data-wait-cuda": {"data_wait_frac": 0.1},
        "full-cuda": {"step_ms": 10.0},
        "ratio-only": {"step_per_calib": 1.0},
    }, "tolerance": {"quick-cuda": 0.5, "data-wait-cuda": 0.25}, "schema": 1}
    cases = [
        ("quick-cuda", {"step_per_calib": 2.5, "step_ms": 0.25}, {}),
        ("quick-cuda", {"step_per_calib": 6.0, "step_ms": 0.6}, {}),
        ("quick-cuda", {"step_per_calib": 0.5, "step_ms": 0.05}, {}),
        ("quick-cuda", {"step_per_calib": 2.5}, {"tolerance": 0.1}),
        ("data-wait-cuda", {"data_wait_frac": 0.01}, {}),
        ("data-wait-cuda", {"data_wait_frac": 0.2}, {}),
        ("full-cuda", {"step_ms": 10.5}, {"default_tolerance": 0.08}),
        ("full-cuda", {"step_ms": 9.0}, {"default_tolerance": 0.08}),
    ]
    for key, measurement, kw in cases:
        ours = port_gate.evaluate(baseline, key, measurement, **kw)
        theirs = jax_gate.evaluate(baseline, key, measurement, **kw)
        assert dumps(dataclasses.asdict(ours)) == dumps(dataclasses.asdict(theirs))
        assert ours.describe() == theirs.describe().replace("scripts/perf_gate.py", "scripts/torch_perf_gate.py")
    for key, measurement, kw, err in (("missing", {"step_ms": 1.0}, {}, KeyError),
                                      ("full-cuda", {"step_ms": 1.0}, {}, ValueError),
                                      ("ratio-only", {"step_ms": 1.0}, {"default_tolerance": 0.1}, ValueError)):
        for mod in (port_gate, jax_gate):
            with pytest.raises(err):
                mod.evaluate(baseline, key, measurement, **kw)
    for bad in ((0.0, 1.0, 0.1), (1.0, 0.0, 0.1), (1.0, 1.0, 0.0)):
        for mod in (port_gate, jax_gate):
            with pytest.raises(ValueError):
                mod.check(*bad, key="k", metric="step_ms")
    written = []
    for mod, name in ((port_gate, "ours.json"), (jax_gate, "theirs.json")):
        path = str(tmp_path / name)
        with open(path, "w") as f:
            f.write("<<<<<<< a torn merge\n")  # --update recovers a malformed file
        mod.update_baseline(path, "quick-cuda", {"step_per_calib": 1.5, "card": "H100"}, tolerance=0.5)
        mod.update_baseline(path, "data-wait-cuda", {"data_wait_frac": 0.2})
        with open(path, "rb") as f:
            written.append(f.read())
        assert mod.load_baseline(path)["entries"]["quick-cuda"]["step_per_calib"] == 1.5
    assert written[0] == written[1]
    assert port_gate.DEFAULT_BASELINE_PATH.endswith("TORCH_PERF_BASELINE.json")


def test_history_of_the_committed_rounds_is_the_jax_history():
    ours = port_history.analyze_history(REPO)
    theirs = jax_history.analyze_history(REPO)
    assert ours.entries and dumps(ours.to_dict()) == dumps(theirs.to_dict())
    assert ours.describe() == theirs.describe()
    points = [(1, 100.0), (2, 100.5), (3, 101.0), (4, 99.8), (5, 120.0), (6, 90.0)]
    for field in ("step_ms", "value", "other"):
        for tol in (0.01, 0.3):
            a = port_history.detect_regressions(points, field, series="s", rel_tol=tol)
            b = jax_history.detect_regressions(points, field, series="s", rel_tol=tol)
            assert dumps([r.to_dict() for r in a]) == dumps([r.to_dict() for r in b])
    for n in (2, 3, 4, 5):
        a = port_history.detect_flat_streaks(points, series="s", min_rounds=n)
        b = jax_history.detect_flat_streaks(points, series="s", min_rounds=n)
        assert dumps([s.to_dict() for s in a]) == dumps([s.to_dict() for s in b])
    assert len(port_history.detect_flat_streaks(points, min_rounds=4)) == 1  # r01-r04, exactly four rounds
    assert not port_history.detect_flat_streaks(points, min_rounds=5)


def test_bench_history_self_test_on_the_committed_rounds(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["torch_bench_history.py", "--self-test", "--json"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(REPO, "scripts", "torch_bench_history.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert done.value.code == 0, out
    ledger = json.loads(out[: out.index("\n}\n") + 2])
    assert dumps(ledger) == dumps(jax_history.analyze_history(REPO).to_dict())


def test_a_trace_leaves_out_the_lead_kernels_before_its_start_mark(tmp_path):
    """The card's profiler drops the first kernel records of a recorded cycle: the session
    launches lead kernels, marks the traced work's start, and the reader keeps what was
    launched after the mark (by correlation id)."""
    from distributed_training_pytorch_tpu_torch.profiling.report import analyze_trace
    from distributed_training_pytorch_tpu_torch.profiling.trace import TRACE_START, load_device_events

    events = [{"ph": "X", "cat": "user_annotation", "name": TRACE_START, "ts": 100.0, "dur": 1.0}]
    for i, (ts, name) in enumerate([(10.0, "lead_add"), (20.0, "lead_add"), (110.0, "gemm"), (130.0, "add"),
                                    (150.0, "gemm")]):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2.0,
                       "args": {"correlation": 7 + i}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts + 500.0, "dur": 5.0,
                       "args": {"correlation": 7 + i, "device": 0}})
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 700.0, "dur": 3.0,
                   "args": {"device": 0}})
    path = tmp_path / "h_1.1.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    source, rows = load_device_events(str(path))
    assert source == "device" and [r[0] for r in rows] == ["gemm", "add", "gemm", "Memcpy HtoD"]
    report = analyze_trace(str(path), steps=1)
    assert {row.name for row in report.top_ops} == {"gemm", "add", "Memcpy HtoD"}
    unmarked = tmp_path / "u_1.1.pt.trace.json"
    unmarked.write_text(json.dumps({"traceEvents": events[1:]}))
    assert len(load_device_events(str(unmarked))[1]) == 6  # no mark: every device event
