"""The run doctor: a ranked, machine-checkable diagnosis of a training run.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/doctor.py``, with the same
verdicts, thresholds and evidence rows, so the JAX package's ``scripts/run_doctor.py`` and
this module give the same verdict on the same event log:

=====================  ====================================================
verdict                signature
=====================  ====================================================
``compile_bound``      ``compile`` events (other than the FLOP probe's) past the
                       attempt's starting epoch: in the port a kernel build or a CUDA
                       graph captured again in the steady state
``data_bound``         steady-state ``data_wait`` fraction over 20 %
``checkpoint_stall``   steady-state ``checkpoint`` fraction over 20 %
``straggler``          a ``straggler``/``step_time_regression`` anomaly or a
                       ``hung_step``, or the worst window's slowest-rank ratio over 1.5
``comm_heavy``         the profile capture puts over 25 % of device wall in
                       ``collective`` kernels (NCCL)
``healthy``            none of the above
=====================  ====================================================

``stale_heartbeat`` and ``dead`` belong to the vocabulary but only a live monitor, which
holds a wall clock, produces them. Steady-state fractions divide by ``total - compile -
restart_rollback - checkpoint_async``. The same rules run offline over an event log
(:func:`extract_signals` + :func:`diagnose`) and live at the epoch's end from the
trainer's counters (:func:`scalar_fields`, the ``doctor/*`` TensorBoard scalars).
"""

from __future__ import annotations

import dataclasses

from distributed_training_pytorch_tpu_torch.telemetry.goodput import BUCKETS

__all__ = [
    "Diagnosis",
    "Signals",
    "THRESHOLDS",
    "VERDICTS",
    "Verdict",
    "diagnose",
    "extract_signals",
    "scalar_fields",
    "steady_fractions",
    "update_signals",
]

VERDICTS = (
    "compile_bound",
    "data_bound",
    "checkpoint_stall",
    "straggler",
    "comm_heavy",
    # Liveness verdicts: produced by the streaming monitor
    # (``telemetry/monitor.py``), which alone can compare the log's last
    # pulse against a wall clock — a finished log read post-hoc is neither
    # stale nor dead. Named here so the vocabulary has ONE home.
    "stale_heartbeat",
    "dead",
    "healthy",
)

# Firing ceilings. A verdict's score is measured/threshold (>= 1.0 fires);
# the thresholds are deliberately generous — the doctor names what
# DOMINATES a run, not every inefficiency.
THRESHOLDS = {
    "data_wait_frac": 0.20,
    "checkpoint_frac": 0.20,
    "straggler_ratio": 1.5,
    "comm_frac": 0.25,
}

# Buckets excluded from the steady-state denominator (see module doc).
_EXCLUDED = ("compile", "restart_rollback", "checkpoint_async")


def steady_fractions(seconds: dict) -> dict:
    """Bucket fractions of the steady-state wall (warmup/resume/overlapped
    buckets excluded from the denominator; their own fractions report 0).
    All zeros when nothing steady-state was accounted."""
    steady = {b: float(seconds.get(b, 0.0)) for b in BUCKETS}
    denom = sum(v for b, v in steady.items() if b not in _EXCLUDED)
    if denom <= 0.0:
        return {b: 0.0 for b in BUCKETS}
    return {b: (0.0 if b in _EXCLUDED else v / denom) for b, v in steady.items()}


@dataclasses.dataclass
class Signals:
    """The doctor's inputs, source-agnostic: :func:`extract_signals` fills
    them from an event log; the trainer fills them from live counters."""

    goodput_seconds: dict | None = None
    anomaly_counts: dict = dataclasses.field(default_factory=dict)
    hung_steps: int = 0
    max_straggler_ratio: float | None = None
    # Global device id of the chip the worst window blocked on (rides the
    # same `window` record as the ratio) — the fleet controller's
    # exclude-and-replan leg needs a NAMED chip, not just a ratio.
    slowest_chip: int | None = None
    # Epoch the newest attempt started at (run_start's `epoch` field): a
    # resumed attempt's first-epoch compiles are warmup exactly like a cold
    # start's epoch-0 compiles — without this, every controller-restarted
    # run mid-training would read as compile_bound.
    start_epoch: int = 0
    late_compiles: int = 0
    comm_frac: float | None = None
    # Evidence rows keyed by verdict kind: lists of {"metric"/"value"/
    # "line"/"timeline"} dicts accumulated during extraction.
    evidence: dict = dataclasses.field(default_factory=dict)

    def note(self, kind: str, **row) -> None:
        self.evidence.setdefault(kind, []).append(row)


@dataclasses.dataclass
class Verdict:
    kind: str
    score: float
    summary: str
    evidence: list = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Diagnosis:
    verdicts: list  # ranked, most severe first; never empty
    signals: Signals

    @property
    def verdict(self) -> str:
        return self.verdicts[0].kind

    @property
    def healthy(self) -> bool:
        return self.verdict == "healthy"

    def to_dict(self) -> dict:
        return {
            "verdict": self.verdict,
            "healthy": self.healthy,
            "verdicts": [v.to_dict() for v in self.verdicts],
            "steady_fractions": steady_fractions(self.signals.goodput_seconds or {}),
        }

    def describe(self) -> str:
        lines = []
        for i, v in enumerate(self.verdicts, 1):
            lines.append(f"  {i}. [{v.kind}] score {v.score:.2f} — {v.summary}")
            for row in v.evidence:
                cite = ", ".join(
                    f"{k}={row[k]}"
                    for k in ("metric", "value", "threshold", "chip", "line", "timeline")
                    if row.get(k) is not None
                )
                lines.append(f"       evidence: {cite}")
        return "\n".join(lines)


def update_signals(sig: Signals, rec: dict) -> None:
    """Fold ONE event record into :class:`Signals` — the incremental unit
    behind both read paths: :func:`extract_signals` loops it
    over a complete log (``scripts/run_doctor.py``), and the streaming
    monitor (``telemetry/monitor.py``) calls it per record as its tail
    follower yields them — so the post-hoc doctor and the live monitor
    derive their verdicts from literally the same accumulation (the
    same-log => byte-identical-verdicts regression test pins it)."""
    kind = rec.get("event")
    line = rec.get("_line")
    if isinstance(rec.get("goodput_seconds"), dict):
        # Cumulative counters: the LAST snapshot wins (append-across-
        # restarts keeps them cumulative over the whole job). ONE evidence
        # row, REPLACED rather than appended: heartbeats carry a snapshot
        # every pulse, and an append here would grow every
        # fraction verdict's evidence — and a long-lived monitor's memory
        # — by one identical row per heartbeat.
        sig.goodput_seconds = dict(rec["goodput_seconds"])
        sig.evidence["goodput"] = [
            dict(metric="goodput_seconds", line=line, timeline="goodput")
        ]
    if kind == "anomaly":
        akind = str(rec.get("kind"))
        sig.anomaly_counts[akind] = sig.anomaly_counts.get(akind, 0) + 1
        if akind in ("straggler", "step_time_regression"):
            sig.note("straggler", metric=f"anomaly:{akind}",
                     value=rec.get("value"), line=line, timeline="markers")
    elif kind == "hung_step":
        sig.hung_steps += 1
        sig.note("straggler", metric="hung_step",
                 value=rec.get("timeout_s"), line=line, timeline="markers")
    elif kind == "window" and rec.get("straggler_ratio") is not None:
        r = float(rec["straggler_ratio"])
        if sig.max_straggler_ratio is None or r > sig.max_straggler_ratio:
            sig.max_straggler_ratio = r
            chip = rec.get("slowest_chip")
            sig.slowest_chip = int(chip) if chip is not None else None
            sig.note("straggler_ratio", metric="straggler_ratio", value=round(r, 4),
                     chip=sig.slowest_chip, line=line, timeline="steps")
    elif kind == "run_start":
        # Where THIS attempt began: compiles in its starting epoch are
        # warmup (a resume recompiles its executables mid-run), not the
        # retrace signature. Fresh runs start at 0 — identical behavior.
        sig.start_epoch = int(rec.get("epoch") or 0)
    elif kind == "compile" and rec.get("kind") != "mfu_probe":
        if int(rec.get("epoch", 0) or 0) > sig.start_epoch:
            sig.late_compiles += 1
            sig.note("compile_bound", metric="late_compile",
                     value=rec.get("executables"), line=line, timeline="markers")
    elif kind == "profile_capture" and isinstance(rec.get("categories"), dict):
        sig.comm_frac = float(rec["categories"].get("collective", 0.0))
        sig.note("comm_heavy", metric="collective_frac",
                 value=round(sig.comm_frac, 4), line=line, timeline="profile")


def extract_signals(events: list[dict]) -> Signals:
    """Distill an event log (``events.load_run_events`` output — records
    carry ``_line``) into :class:`Signals`, citing line numbers and the
    timeline track each piece of evidence lands on. A loop over
    :func:`update_signals` and nothing more — the streaming monitor's
    incremental path IS this path."""
    sig = Signals()
    for rec in events:
        update_signals(sig, rec)
    return sig


def _verdicts(sig: Signals) -> list[Verdict]:
    found = []
    fr = steady_fractions(sig.goodput_seconds or {})

    def frac_verdict(kind, bucket, threshold_key, what):
        f = fr.get(bucket, 0.0)
        threshold = THRESHOLDS[threshold_key]
        score = f / threshold
        if score >= 1.0:
            ev = [dict(metric=f"{bucket}_frac_steady", value=round(f, 4),
                       threshold=threshold, timeline="goodput")]
            ev += sig.evidence.get("goodput", [])
            found.append(Verdict(
                kind, score,
                f"{what}: {bucket} is {100 * f:.0f}% of steady-state wall "
                f"(ceiling {100 * threshold:.0f}%)", ev))
        return score

    frac_verdict("data_bound", "data_wait", "data_wait_frac",
                 "the input pipeline starves the chips")
    frac_verdict("checkpoint_stall", "checkpoint", "checkpoint_frac",
                 "checkpoint saves stall the hot loop")

    if sig.late_compiles > 0:
        found.append(Verdict(
            "compile_bound", 1.0 + float(sig.late_compiles),
            f"{sig.late_compiles} executable(s) compiled past the attempt's "
            "warmup epoch — the "
            "steady state is retracing (a shape leak or a lost executable "
            "cache), not warmup",
            sig.evidence.get("compile_bound", [])))

    strag_score = 0.0
    if sig.max_straggler_ratio is not None:
        strag_score = sig.max_straggler_ratio / THRESHOLDS["straggler_ratio"]
    n_anom = sig.anomaly_counts.get("straggler", 0)
    n_regress = sig.anomaly_counts.get("step_time_regression", 0)
    if n_anom:
        strag_score = max(strag_score, 1.0 + float(n_anom))
    if n_regress:
        strag_score = max(strag_score, 1.0 + 0.5 * n_regress)
    if sig.hung_steps:
        strag_score = max(strag_score, 2.0 + float(sig.hung_steps))
    if strag_score >= 1.0:
        parts = []
        if n_anom:
            parts.append(f"{n_anom} straggler anomaly(ies)")
        if n_regress:
            parts.append(f"{n_regress} step-time regression(s)")
        if sig.hung_steps:
            parts.append(f"{sig.hung_steps} hung step(s)")
        if sig.max_straggler_ratio is not None and (
            sig.max_straggler_ratio >= THRESHOLDS["straggler_ratio"]
        ):
            chip = "" if sig.slowest_chip is None else f" (chip {sig.slowest_chip})"
            parts.append(
                f"worst slowest-chip ratio {sig.max_straggler_ratio:.2f}{chip}"
            )
        found.append(Verdict(
            "straggler", strag_score,
            "one chip (or a host-side hang) is pacing the job: " + ", ".join(parts),
            sig.evidence.get("straggler", []) + sig.evidence.get("straggler_ratio", [])))

    if sig.comm_frac is not None:
        score = sig.comm_frac / THRESHOLDS["comm_frac"]
        if score >= 1.0:
            found.append(Verdict(
                "comm_heavy", score,
                f"collectives take {100 * sig.comm_frac:.0f}% of traced device "
                f"wall (ceiling {100 * THRESHOLDS['comm_frac']:.0f}%) — the "
                "sharding plan spends the chips on the wire",
                sig.evidence.get("comm_heavy", [])))
    return found


def diagnose(signals_or_events) -> Diagnosis:
    """Rank the verdicts for a run. Accepts :class:`Signals` (the trainer's
    live path) or a parsed event list (the offline path). Always returns
    at least one verdict — ``healthy`` with the goodput headline as its
    evidence when nothing fires."""
    sig = (signals_or_events if isinstance(signals_or_events, Signals)
           else extract_signals(list(signals_or_events)))
    found = sorted(_verdicts(sig), key=lambda v: -v.score)
    if not found:
        fr = steady_fractions(sig.goodput_seconds or {})
        found = [Verdict(
            "healthy", 0.0,
            f"no bottleneck over threshold (steady-state productive fraction "
            f"{100 * fr.get('productive_step', 0.0):.0f}%)",
            [dict(metric="productive_frac_steady",
                  value=round(fr.get("productive_step", 0.0), 4), timeline="goodput")])]
    return Diagnosis(found, sig)


def scalar_fields(sig: Signals) -> dict:
    """The live-dashboard projection: per-verdict severity scores (0.0 when
    the rule is quiet) + ``healthy`` as 1.0/0.0 — written at epoch end
    under the ``doctor/`` TensorBoard prefix so dashboards see what the
    offline doctor would say. Floats only (the MetricsWriter contract)."""
    scores = {k: 0.0 for k in VERDICTS if k != "healthy"}
    for v in _verdicts(sig):
        scores[v.kind] = max(scores[v.kind], float(v.score))
    scores["healthy"] = 0.0 if any(s >= 1.0 for s in scores.values()) else 1.0
    return scores
