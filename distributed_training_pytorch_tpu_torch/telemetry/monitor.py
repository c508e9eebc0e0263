"""The run doctor, live: tail a run's event log and keep its diagnosis and liveness.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/monitor.py``, with the same
statuses, alert rules and record fields, and the same answers on the same log and clock
(the CPU tests hold the two byte-equal). Records come in through the port's
:class:`~.events.EventFollower` and fold into :class:`~.doctor.Signals` through
:func:`~.doctor.update_signals`, the loop of the post-hoc doctor, so the two cannot
disagree about a log they both read.

===================  ===================================================
status               rule
===================  ===================================================
``training``         fresh records, and an execution unit completed
                     within ``stale_after_s``
``stale_heartbeat``  records still arrive (heartbeats from the watchdog's
                     thread) but no unit completed for ``stale_after_s``
``dead``             the log silent past ``dead_after_s`` (the newest of
                     the last record's ``t_wall`` and the file's mtime)
``finished``         a ``run_end`` record closed the attempt
``waiting``          no event log, or no record yet
===================  ===================================================

A server's log (``serve_start``) reads ``serving`` (or its ``draining``/``replanning``
state) while alive, with ``healthy``/``slo_breach`` from its ``request_batch`` pulse.
Every alert rule is debounced: it fires once when its condition turns true and re-arms
when it clears; a firing is a ``monitor_alert`` record when an ``alert_log`` is given.

Liveness compares the writer's ``t_wall`` and the file's mtime with ``clock()``
(``time.time`` unless a test injects one): across hosts it inherits their clock skew.
"""

from __future__ import annotations

import dataclasses
import os
import time

from distributed_training_pytorch_tpu_torch.telemetry import doctor as doctor_lib
from distributed_training_pytorch_tpu_torch.telemetry.events import EventFollower, resolve_events_path

__all__ = ["AlertConfig", "MonitorStatus", "RunMonitor", "worst_exit_code"]

# Records that prove the main thread completed (or is completing) an execution unit; a
# worker thread's records (commits, the watchdog's heartbeats, hung_step) are not here. The
# serving records are a server's pulse, as ``window`` is a trainer's.
_PROGRESS_KINDS = (
    "run_start",
    "checkpoint_restore",
    "window",
    "epoch_end",
    "compile",
    "checkpoint_save",
    "preemption",
    "run_end",
    "serve_start",
    "request_batch",
    "hot_swap",
    "drain_start",
    "replan_done",
    "offer_accept",
    "offer_decline",
)

# Verdicts alerted when their score crosses 1.0 (data_bound and checkpoint_stall have
# their own fraction ceilings, so one disease pages once).
_VERDICT_RULES = ("compile_bound", "straggler", "comm_heavy")


@dataclasses.dataclass
class AlertConfig:
    """The rule thresholds: ``stale_after_s`` (no completed unit while records arrive),
    ``dead_after_s`` (the log silent; None: 3 x ``stale_after_s``), the steady-state
    ``data_wait``/``checkpoint`` fraction ceilings (the doctor's thresholds by default),
    the anomaly kinds that page, and ``min_steady_s`` of steady-state wall before the
    fraction rules arm."""

    stale_after_s: float = 120.0
    dead_after_s: "float | None" = None
    data_wait_frac: float = doctor_lib.THRESHOLDS["data_wait_frac"]
    checkpoint_frac: float = doctor_lib.THRESHOLDS["checkpoint_frac"]
    anomaly_kinds: tuple = (
        "loss_spike",
        "grad_explosion",
        "step_time_regression",
        "memory_growth",
        "straggler",
    )
    min_steady_s: float = 1.0

    def resolved_dead_after(self) -> float:
        return float(self.dead_after_s) if self.dead_after_s is not None else 3.0 * float(self.stale_after_s)


@dataclasses.dataclass
class MonitorStatus:
    """One poll's answer: liveness and the doctor's diagnosis."""

    run_dir: str
    status: str  # waiting | training | serving | draining | replanning | stale_heartbeat | dead | finished
    verdict: str  # the liveness kind when stale/dead; the doctor's top verdict; healthy|slo_breach for a server
    diagnosis: "doctor_lib.Diagnosis | None"
    steady_fractions: dict
    last_event_age_s: "float | None"
    progress_age_s: "float | None"
    headline: dict  # epoch / step_in_epoch / units / step_ms of the last pulse
    alerts: list  # the rules that fired at this poll
    active_alerts: tuple  # every rule over its line now
    attempt: "int | None" = None
    kind: str = "train"  # "train" | "serve"
    serve: dict = dataclasses.field(default_factory=dict)  # the last request_batch pulse

    @property
    def exit_code(self) -> int:
        """0 alive (or finished) and clean; 1 degraded (stale, a verdict other than
        healthy, or an alert over its line); 2 dead; 3 nothing to monitor."""
        if self.status == "dead":
            return 2
        if self.status == "waiting":
            return 3
        if self.status == "stale_heartbeat" or self.verdict != "healthy" or self.active_alerts:
            return 1
        return 0

    def to_dict(self) -> dict:
        out = {
            "run_dir": self.run_dir,
            "status": self.status,
            "verdict": self.verdict,
            "attempt": self.attempt,
            "steady_fractions": self.steady_fractions,
            "last_event_age_s": self.last_event_age_s,
            "progress_age_s": self.progress_age_s,
            "headline": self.headline,
            "alerts": self.alerts,
            "active_alerts": list(self.active_alerts),
            "exit_code": self.exit_code,
            "kind": self.kind,
        }
        if self.serve:
            out["serve"] = self.serve
        if self.diagnosis is not None:
            out["diagnosis"] = self.diagnosis.to_dict()
        return out

    def describe(self) -> str:
        """The single-run console view."""
        ages = []
        if self.last_event_age_s is not None:
            ages.append(f"last event {self.last_event_age_s:.1f}s ago")
        if self.progress_age_s is not None:
            ages.append(f"progress {self.progress_age_s:.1f}s ago")
        if self.kind == "serve":
            hl = ", ".join(f"{k} {self.serve[k]}" for k in ("qps", "p50_ms", "p99_ms", "params_version")
                           if self.serve.get(k) is not None)
        else:
            hl = ", ".join(f"{k} {self.headline[k]}" for k in ("epoch", "step_in_epoch", "units", "step_ms")
                           if self.headline.get(k) is not None)
        lines = [f"{self.run_dir}: {self.status.upper()} [{self.verdict}]" + (f" ({'; '.join(ages)})" if ages else "")]
        if hl:
            lines.append(f"  {hl}")
        fr = self.steady_fractions
        if any(fr.values()):
            lines.append("  steady: productive {:.0%} data_wait {:.0%} checkpoint {:.0%}".format(
                fr.get("productive_step", 0.0), fr.get("data_wait", 0.0), fr.get("checkpoint", 0.0)))
        if self.diagnosis is not None and self.status not in ("waiting",):
            lines.append(self.diagnosis.describe())
        for a in self.alerts:
            lines.append(f"  ALERT [{a['rule']}]: {a.get('message', '')}")
        return "\n".join(lines)

    def fleet_row(self) -> dict:
        """The fleet table's row: trainers fill the step and goodput columns, servers
        ``qps``/``p99``."""
        fr = self.steady_fractions
        age = self.last_event_age_s
        serving = self.kind == "serve"

        def _num(v, fmt="{:.1f}"):
            return fmt.format(v) if isinstance(v, (int, float)) else "-"

        return {
            "run": os.path.basename(os.path.normpath(self.run_dir)) or self.run_dir,
            "status": self.status,
            "verdict": self.verdict,
            "att": self.attempt if self.attempt is not None else "-",
            "epoch": "-" if serving else self.headline.get("epoch", "-"),
            "step": "-" if serving else self.headline.get("step_in_epoch", "-"),
            "step_ms": "-" if serving else _num(self.headline.get("step_ms")),
            "qps": _num(self.serve.get("qps"), "{:.2f}") if serving else "-",
            "p99": _num(self.serve.get("p99_ms")) if serving else "-",
            "good%": "-" if serving else f"{100 * fr.get('productive_step', 0.0):.0f}",
            "data%": "-" if serving else f"{100 * fr.get('data_wait', 0.0):.0f}",
            "ckpt%": "-" if serving else f"{100 * fr.get('checkpoint', 0.0):.0f}",
            "age_s": f"{age:.1f}" if age is not None else "-",
            "alerts": ",".join(self.active_alerts) or "-",
        }


def worst_exit_code(statuses) -> int:
    """A fleet's exit code: a finding (dead 2 over degraded 1) first, then ``waiting``'s
    3 over clean 0."""
    codes = [s.exit_code for s in statuses]
    real = [c for c in codes if c in (1, 2)]
    if real:
        return max(real)
    return 3 if (3 in codes or not codes) else 0


class RunMonitor:
    """Incremental monitor of one run directory (see the module docstring):
    ``alert_log`` (an :class:`~.events.EventLog` or None) takes one ``monitor_alert``
    record per firing; ``clock`` defaults to ``time.time``, the clock of ``t_wall``."""

    def __init__(self, run_dir: str, config: "AlertConfig | None" = None, *, alert_log=None, clock=time.time):
        self.run_dir = str(run_dir)
        self.path = resolve_events_path(self.run_dir)
        self.config = config if config is not None else AlertConfig()
        self._follower = EventFollower(self.path)
        self.event_log = alert_log
        self._clock = clock
        self._generation = self._follower.generation
        self._reset_state()

    def _reset_state(self) -> None:
        """Fresh state: at start, when the log shrank under the follower, and when the
        records' ``attempt`` changes (a restarted run appends to the same file); the
        debounce state resets with it."""
        self.signals = doctor_lib.Signals()
        self._seen_any = False
        self._run_ended = False
        self._drained_tail = False
        self._last_wall: "float | None" = None
        self._progress_wall: "float | None" = None
        self._active: "dict[str, bool]" = {}
        self.headline: dict = {}
        self._attempt: "int | None" = None
        self._kind = "train"
        self._serve: dict = {}
        # The goodput snapshot at the newest attempt's start: the counters ride checkpoint
        # meta across restarts, and verdicts describe this attempt's own accrual.
        self._goodput_base: "dict | None" = None

    # -- ingestion ---------------------------------------------------------

    def _ingest(self, rec: dict) -> None:
        attempt = rec.get("attempt")
        if isinstance(attempt, int):
            if self._attempt is not None and attempt != self._attempt:
                self._reset_state()
                if isinstance(rec.get("goodput_seconds"), dict):
                    self._goodput_base = dict(rec["goodput_seconds"])
            self._attempt = attempt
        doctor_lib.update_signals(self.signals, rec)
        self._seen_any = True
        kind = rec.get("event")
        t_wall = rec.get("t_wall")
        t_wall = float(t_wall) if isinstance(t_wall, (int, float)) else None
        if t_wall is not None and (self._last_wall is None or t_wall > self._last_wall):
            self._last_wall = t_wall
        if kind == "heartbeat":
            for key in ("epoch", "step_in_epoch", "units", "step_ms"):
                if rec.get(key) is not None:
                    self.headline[key] = rec[key]
            if t_wall is not None:
                if rec.get("source") == "watchdog":
                    # The main thread's last progress: the record's time less its lag.
                    prog = t_wall - float(rec.get("since_progress_s") or 0.0)
                else:
                    prog = t_wall
                if self._progress_wall is None or prog > self._progress_wall:
                    self._progress_wall = prog
        elif kind in _PROGRESS_KINDS:
            if kind == "run_start":
                self._run_ended = False
            elif kind == "run_end":
                self._run_ended = True
            elif kind == "serve_start":
                self._kind = "serve"
                self._run_ended = False
            elif kind == "request_batch":
                for key in ("qps", "p50_ms", "p99_ms", "slo_ok", "slo_p99_ms", "params_version", "rejected_total",
                            "state", "qps_per_chip", "mesh_chips", "shed_total"):
                    if key in rec:
                        self._serve[key] = rec[key]
            elif kind == "hot_swap" and rec.get("to_version") is not None:
                self._serve["params_version"] = rec["to_version"]
            elif kind == "drain_start":
                self._serve["state"] = "draining"
            elif kind == "replan_done":
                self._serve["state"] = "serving"
                if rec.get("device_ids"):
                    self._serve["mesh_chips"] = len(rec["device_ids"])
            for key in ("epoch", "step_in_epoch"):
                if rec.get(key) is not None:
                    self.headline[key] = rec[key]
            if rec.get("step_ms") is not None:
                self.headline["step_ms"] = rec["step_ms"]
            if t_wall is not None and (self._progress_wall is None or t_wall > self._progress_wall):
                self._progress_wall = t_wall

    def _scoped_signals(self) -> "doctor_lib.Signals":
        """The accumulated signals, with goodput rebased to this attempt's accrual after a
        restart; without one, the post-hoc doctor's view of the same log."""
        base = self._goodput_base
        cum = self.signals.goodput_seconds
        if not base or not cum:
            return self.signals
        rebased = {k: max(0.0, float(v) - float(base.get(k, 0.0))) for k, v in cum.items()}
        return dataclasses.replace(self.signals, goodput_seconds=rebased)

    # -- liveness ----------------------------------------------------------

    def _freshness(self) -> "float | None":
        """The newer of the last record's ``t_wall`` and the log file's mtime (bytes that
        landed without a complete record yet)."""
        last = self._last_wall
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            mtime = None
        if mtime is not None and (last is None or mtime > last):
            last = mtime
        return last

    def _liveness(self, now: float) -> str:
        if not self._seen_any:
            return "waiting"
        if self._run_ended:
            return "finished"
        fresh = self._freshness()
        if fresh is None:
            return "waiting"
        if now - fresh >= self.config.resolved_dead_after():
            return "dead"
        progress = self._progress_wall if self._progress_wall is not None else fresh
        if now - progress >= self.config.stale_after_s:
            return "stale_heartbeat"
        return "training"

    # -- alert rules (debounced) -------------------------------------------

    def _evaluate_alerts(self, status: str, diagnosis, fractions, now, sig) -> list:
        cfg = self.config
        fired: "list[dict]" = []

        def rule(key: str, firing: bool, value=None, threshold=None, message=""):
            was = self._active.get(key, False)
            self._active[key] = bool(firing)
            if firing and not was:
                fired.append({"rule": key, "value": value, "threshold": threshold, "message": message})

        fresh = self._freshness()
        age = None if fresh is None else now - fresh
        prog_age = None if self._progress_wall is None else now - self._progress_wall
        rule("dead", status == "dead", value=None if age is None else round(age, 1),
             threshold=cfg.resolved_dead_after(), message="event log silent — process killed or host lost")
        rule("stale_heartbeat", status == "stale_heartbeat", value=None if prog_age is None else round(prog_age, 1),
             threshold=cfg.stale_after_s, message="heartbeats arrive but no execution unit completes — hung")
        steady = sum(float(v) for b, v in (sig.goodput_seconds or {}).items() if b not in doctor_lib._EXCLUDED)
        fractions_armed = steady >= cfg.min_steady_s
        rule("data_bound", fractions_armed and fractions.get("data_wait", 0.0) > cfg.data_wait_frac,
             value=round(fractions.get("data_wait", 0.0), 4), threshold=cfg.data_wait_frac,
             message="steady-state data_wait fraction over the alert ceiling")
        rule("checkpoint_stall", fractions_armed and fractions.get("checkpoint", 0.0) > cfg.checkpoint_frac,
             value=round(fractions.get("checkpoint", 0.0), 4), threshold=cfg.checkpoint_frac,
             message="steady-state checkpoint fraction over the alert ceiling")
        for kind in cfg.anomaly_kinds:
            n = int(sig.anomaly_counts.get(kind, 0))
            rule(f"anomaly:{kind}", n > 0, value=n, threshold=1, message=f"{n} {kind} anomaly record(s) in the log")
        if self._kind == "serve":
            p99 = self._serve.get("p99_ms")
            rule("slo_breach", self._serve.get("slo_ok") is False,
                 value=None if not isinstance(p99, (int, float)) else round(p99, 1),
                 threshold=self._serve.get("slo_p99_ms"),
                 message="server p99 latency over its SLO (last request_batch pulse)")
        scores = {v.kind: v for v in (diagnosis.verdicts if diagnosis else [])}
        for kind in _VERDICT_RULES:
            v = scores.get(kind)
            rule(kind, v is not None and v.score >= 1.0, value=None if v is None else round(v.score, 3),
                 threshold=1.0, message=v.summary if v is not None else "")
        if fired and self.event_log is not None:
            for a in fired:
                self.event_log.emit("monitor_alert", run_dir=self.run_dir, status=status, **a)
        return fired

    # -- the poll ----------------------------------------------------------

    def poll(self) -> MonitorStatus:
        """Take the newly completed records, derive liveness and the diagnosis, and
        evaluate the alert rules: one stat and one incremental read."""
        now = self._clock()
        recs = self._follower.poll()
        if self._follower.generation != self._generation:
            self._generation = self._follower.generation  # the log shrank: recs is the new file
            self._reset_state()
        for rec in recs:
            self._ingest(rec)
        status = self._liveness(now)
        if status in ("dead", "finished") and not self._drained_tail:
            # No more bytes are coming: a torn tail is data now.
            self._drained_tail = True
            for rec in self._follower.poll(final=True):
                self._ingest(rec)
        sig = self._scoped_signals()
        if self._kind == "serve":
            diagnosis = None  # the trainer's goodput heuristics do not apply to a server
            if status == "training":
                state = self._serve.get("state")
                status = state if state in ("draining", "replanning") else "serving"
        else:
            diagnosis = doctor_lib.diagnose(sig) if self._seen_any else None
        fractions = doctor_lib.steady_fractions(sig.goodput_seconds or {})
        if status in ("stale_heartbeat", "dead"):
            verdict = status
        elif self._kind == "serve":
            verdict = "slo_breach" if self._serve.get("slo_ok") is False else "healthy"
        elif diagnosis is not None:
            verdict = diagnosis.verdict
        else:
            verdict = "healthy"
        fresh = self._freshness()
        alerts = self._evaluate_alerts(status, diagnosis, fractions, now, sig)
        return MonitorStatus(
            run_dir=self.run_dir,
            status=status,
            verdict=verdict,
            diagnosis=diagnosis,
            steady_fractions=fractions,
            last_event_age_s=None if fresh is None else max(0.0, now - fresh),
            progress_age_s=None if self._progress_wall is None else max(0.0, now - self._progress_wall),
            headline=dict(self.headline),
            alerts=alerts,
            active_alerts=tuple(k for k, on in self._active.items() if on),
            attempt=self._attempt,
            kind=self._kind,
            serve=dict(self._serve),
        )
