"""The bench-round ledger: committed benchmark rounds as per-metric trajectories.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/history.py``, reading the same
round-file format (``BENCH_r<NN>.json`` / ``MULTICHIP_r<NN>.json``: the harness's record
of one round, whose ``tail`` holds the bench's JSON lines and whose ``parsed`` holds one
line already parsed), with the same detectors and the same report on the same files (the
CPU tests hold the two byte-equal on the repo's committed rounds, which it only reads).
The port's own benchmark writes its rounds in this format.

* **flat streak**: ``min_rounds`` consecutive rounds whose values sit within a relative
  band (spread / mean <= ``rel_tol``); ``min_rounds - 1`` stay quiet.
* **regression**: a round-over-round move past the tolerance in the bad direction, for
  the metrics whose direction is known (``step_ms`` up, ``value``/``mfu*`` down); other
  fields are tracked and never accused.

Consecutive entries of one series whose provenance disagrees on a configuration key
(``telemetry.provenance.differing_keys``) are listed as breaks: not one trajectory.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re

from distributed_training_pytorch_tpu_torch.telemetry.provenance import differing_keys

__all__ = [
    "BenchEntry",
    "FLAT_MIN_ROUNDS",
    "FLAT_REL_TOL",
    "HIGHER_IS_BETTER",
    "HistoryReport",
    "LOWER_IS_BETTER",
    "Regression",
    "Streak",
    "analyze_history",
    "detect_flat_streaks",
    "detect_regressions",
    "load_bench_rounds",
    "load_round_file",
    "trajectories",
]

_ROUND_RE = re.compile(r"(BENCH|MULTICHIP)_r(\d+)\.json$")

FLAT_REL_TOL = 0.02
FLAT_MIN_ROUNDS = 4
REGRESSION_REL_TOL = 0.05

LOWER_IS_BETTER = frozenset({
    "step_ms", "trainer_step_ms", "dispatch_gap_ms", "step_ms_dispatch",
    "comm_bytes_per_step", "chip_skew_ms", "save_stall_ms",
    "predicted_peak_bytes", "live_bytes", "peak_bytes",
    "goodput.data_wait", "goodput.checkpoint", "goodput.other",
})
HIGHER_IS_BETTER = frozenset({
    "value", "vs_baseline", "mfu", "mfu_exec", "mfu_xla",
    "device_busy_frac", "goodput.productive_step",
    "e2e_images_per_sec", "items_per_sec_per_replica",
})

# Identity and configuration fields, not measurements.
_NON_METRIC_FIELDS = frozenset({"batch", "n", "rc", "steps", "oom", "trainer_chain_steps", "schema"})


@dataclasses.dataclass
class BenchEntry:
    """One bench JSON line of one round."""

    kind: str  # "bench" | "multichip"
    round: int
    source: str
    fields: dict

    @property
    def series_label(self) -> str:
        """The trajectory this entry belongs to: the metric name and the facets a sweep
        varies (dtype, mesh), a facet left out where the metric name already says it."""
        parts = [str(self.fields.get("metric", "?"))]
        for facet in ("dtype", "mesh"):
            value = self.fields.get(facet)
            if value and str(value) not in parts[0]:
                parts.append(f"{facet}={value}")
        return " | ".join(parts)

    @property
    def provenance(self) -> "dict | None":
        prov = self.fields.get("provenance")
        return prov if isinstance(prov, dict) else None

    def numeric_fields(self) -> "dict[str, float]":
        """The measurements: numeric top-level fields (identity keys excluded), and the
        goodput fractions as ``goodput.<bucket>``."""
        out: "dict[str, float]" = {}
        for key, value in self.fields.items():
            if key in _NON_METRIC_FIELDS or key == "provenance":
                continue
            if isinstance(value, bool):
                continue
            if isinstance(value, (int, float)):
                out[key] = float(value)
            elif key == "goodput" and isinstance(value, dict):
                for bucket, frac in value.items():
                    if isinstance(frac, (int, float)) and not isinstance(frac, bool):
                        out[f"goodput.{bucket}"] = float(frac)
        return out


def load_round_file(path: str) -> "list[BenchEntry]":
    """The bench entries of one round file: every JSON line of its ``tail`` that carries
    a ``metric``, else its ``parsed`` record."""
    m = _ROUND_RE.search(os.path.basename(path))
    if m is None:
        raise ValueError(f"{path}: not a BENCH_r*/MULTICHIP_r* round file")
    kind = "bench" if m.group(1) == "BENCH" else "multichip"
    rnd = int(m.group(2))
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries: "list[BenchEntry]" = []
    for line in str(data.get("tail") or "").splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and "metric" in rec:
            entries.append(BenchEntry(kind=kind, round=rnd, source=path, fields=rec))
    if not entries and isinstance(data.get("parsed"), dict):
        entries.append(BenchEntry(kind=kind, round=rnd, source=path, fields=data["parsed"]))
    return entries


def load_bench_rounds(root: str) -> "list[BenchEntry]":
    """Every entry of every round file under ``root``, in series and round order."""
    entries: "list[BenchEntry]" = []
    for pattern in ("BENCH_r*.json", "MULTICHIP_r*.json"):
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            entries.extend(load_round_file(path))
    entries.sort(key=lambda e: (e.kind, e.series_label, e.round))
    return entries


def trajectories(entries: "list[BenchEntry]") -> "dict[str, list[tuple[int, float]]]":
    """``"<series label> :: <field>" -> [(round, value), ...]``, round-ordered."""
    out: "dict[str, list[tuple[int, float]]]" = {}
    for entry in entries:
        for field, value in entry.numeric_fields().items():
            out.setdefault(f"{entry.series_label} :: {field}", []).append((entry.round, value))
    for points in out.values():
        points.sort(key=lambda p: p[0])
    return out


@dataclasses.dataclass
class Streak:
    """A plateau: consecutive rounds within one band."""

    series: str
    rounds: list
    values: list
    spread: float  # (max - min) / mean

    def to_dict(self) -> dict:
        return {
            "series": self.series,
            "rounds": list(self.rounds),
            "values": [round(v, 4) for v in self.values],
            "spread": round(self.spread, 4),
        }

    def describe(self) -> str:
        return (f"FLAT r{self.rounds[0]:02d}->r{self.rounds[-1]:02d} ({len(self.rounds)} rounds, spread "
                f"{100 * self.spread:.1f}%): {self.series} ~ {sum(self.values) / len(self.values):.4g}")


@dataclasses.dataclass
class Regression:
    """One bad-direction round-over-round move past the tolerance."""

    series: str
    round_before: int
    round_after: int
    before: float
    after: float
    change: float  # after / before - 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        return (f"REGRESSION r{self.round_before:02d}->r{self.round_after:02d}: {self.series} {self.before:.4g} -> "
                f"{self.after:.4g} ({100 * self.change:+.1f}%)")


def _spread(values: "list[float]") -> float:
    mean = sum(values) / len(values)
    if mean == 0:
        return 0.0 if max(values) == min(values) else float("inf")
    return (max(values) - min(values)) / abs(mean)


def detect_flat_streaks(points: "list[tuple[int, float]]", *, series: str = "", rel_tol: float = FLAT_REL_TOL,
                        min_rounds: int = FLAT_MIN_ROUNDS) -> "list[Streak]":
    """The maximal flat windows of one trajectory with at least ``min_rounds`` points
    (a two-pointer sweep: overlapping flat windows collapse to the maximal ones)."""
    if min_rounds < 2:
        raise ValueError(f"min_rounds must be >= 2, got {min_rounds}")

    def _streak(window):
        return Streak(series=series, rounds=[r for r, _ in window], values=[v for _, v in window],
                      spread=_spread([v for _, v in window]))

    out: "list[Streak]" = []
    start = 0
    for end in range(len(points)):
        if _spread([v for _, v in points[start:end + 1]]) <= rel_tol:
            continue
        # `end` broke the band: the window ending at end - 1 was maximal.
        if end - start >= min_rounds:
            out.append(_streak(points[start:end]))
        while start < end and _spread([v for _, v in points[start:end + 1]]) > rel_tol:
            start += 1
    if len(points) - start >= min_rounds:
        out.append(_streak(points[start:]))
    return out


def detect_regressions(points: "list[tuple[int, float]]", field: str, *, series: str = "",
                       rel_tol: float = REGRESSION_REL_TOL) -> "list[Regression]":
    """Round-over-round bad-direction moves past ``rel_tol`` for the fields of
    :data:`LOWER_IS_BETTER` and :data:`HIGHER_IS_BETTER`; none for any other field."""
    if field in LOWER_IS_BETTER:
        def bad(change):
            return change > rel_tol
    elif field in HIGHER_IS_BETTER:
        def bad(change):
            return change < -rel_tol
    else:
        return []
    out = []
    for (r0, v0), (r1, v1) in zip(points, points[1:], strict=False):
        if v0 == 0:
            continue
        change = v1 / v0 - 1.0
        if bad(change):
            out.append(Regression(series=series, round_before=r0, round_after=r1, before=v0, after=v1, change=change))
    return out


@dataclasses.dataclass
class HistoryReport:
    """Every trajectory and every finding over one root's rounds."""

    entries: list
    series: dict
    streaks: list
    regressions: list
    provenance_breaks: list  # [(series label, round a, round b, keys)]

    def to_dict(self) -> dict:
        return {
            "rounds": sorted({e.round for e in self.entries}),
            "entries": len(self.entries),
            "series": {k: [[r, v] for r, v in pts] for k, pts in sorted(self.series.items())},
            "streaks": [s.to_dict() for s in self.streaks],
            "regressions": [r.to_dict() for r in self.regressions],
            "provenance_breaks": [{"series": s, "round_before": a, "round_after": b, "keys": keys}
                                  for s, a, b, keys in self.provenance_breaks],
        }

    def describe(self) -> str:
        lines = [f"bench history: {len(self.entries)} entries across {len({e.round for e in self.entries})} round(s), "
                 f"{len(self.series)} tracked series"]
        for finding in self.streaks:
            lines.append("  " + finding.describe())
        for finding in self.regressions:
            lines.append("  " + finding.describe())
        for series, a, b, keys in self.provenance_breaks:
            lines.append(f"  PROVENANCE r{a:02d}->r{b:02d}: {series} changed {', '.join(keys)} — not one trajectory "
                         "across that edge")
        if len(lines) == 1:
            lines.append("  no flat streaks or regressions detected")
        return "\n".join(lines)


def analyze_history(root: str, *, flat_tol: float = FLAT_REL_TOL, flat_min_rounds: int = FLAT_MIN_ROUNDS,
                    regression_tol: float = REGRESSION_REL_TOL) -> HistoryReport:
    """Load the rounds under ``root`` and run both detectors and the provenance check."""
    entries = load_bench_rounds(root)
    series = trajectories(entries)
    streaks: "list[Streak]" = []
    regressions: "list[Regression]" = []
    for key, points in sorted(series.items()):
        field = key.rsplit(" :: ", 1)[-1]
        streaks.extend(detect_flat_streaks(points, series=key, rel_tol=flat_tol, min_rounds=flat_min_rounds))
        regressions.extend(detect_regressions(points, field, series=key, rel_tol=regression_tol))
    by_label: "dict[str, list[BenchEntry]]" = {}
    for entry in entries:
        by_label.setdefault(entry.series_label, []).append(entry)
    breaks = []
    for label, group in sorted(by_label.items()):
        group.sort(key=lambda e: e.round)
        for a, b in zip(group, group[1:], strict=False):
            keys = differing_keys(a.provenance, b.provenance)
            if keys:
                breaks.append((label, a.round, b.round, keys))
    return HistoryReport(entries=entries, series=series, streaks=streaks, regressions=regressions,
                         provenance_breaks=breaks)
