"""The perf gate's rule: a measurement against a committed baseline entry.

Counterpart of ``distributed_training_pytorch_tpu/profiling/gate.py``, with the same rule
and the same verdicts on the same inputs (the CPU tests hold the two byte-equal). One rule,
``measured <= baseline * (1 + tolerance)``, over whichever metric both sides carry, in this
order:

* ``step_per_calib``: the workload's step time over a fixed calibration matmul's on the
  same machine, which cancels the machine's speed to first order;
* ``data_wait_frac``: a ceiling on the steady-state ``data_wait`` goodput fraction;
* ``step_ms``: absolute milliseconds, for one pinned kind of card.

The port's baseline is its own file, ``TORCH_PERF_BASELINE.json`` at the repo's root
(:data:`DEFAULT_BASELINE_PATH`); ``scripts/torch_perf_gate.py`` measures and calls
:func:`evaluate`, and ``--update`` records an entry. This module times nothing and reads
or writes nothing but that file.
"""

from __future__ import annotations

import dataclasses
import json
import os

__all__ = [
    "DEFAULT_BASELINE_PATH",
    "GateResult",
    "check",
    "evaluate",
    "load_baseline",
    "update_baseline",
]

DEFAULT_BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "TORCH_PERF_BASELINE.json",
)


@dataclasses.dataclass
class GateResult:
    """One metric's verdict. ``ratio`` is measured/baseline: 1.0 = parity,
    above ``1 + tolerance`` = fail. ``stale`` flags a measurement so much
    *faster* than baseline (beyond the tolerance on the good side) that the
    committed baseline undersells the current code — a pass, with a nudge to
    re-record so the gate keeps protecting the new level."""

    key: str
    metric: str
    measured: float
    baseline: float
    tolerance: float
    ratio: float
    passed: bool
    stale: bool = False

    def describe(self) -> str:
        verdict = "PASS" if self.passed else "FAIL"
        line = (
            f"[{verdict}] {self.key}/{self.metric}: measured {self.measured:.4g} "
            f"vs baseline {self.baseline:.4g} (x{self.ratio:.3f}, "
            f"tolerance +{100 * self.tolerance:.0f}%)"
        )
        if not self.passed:
            line += f" — {self.metric} REGRESSION past tolerance"
        elif self.stale:
            line += (
                " — faster than baseline beyond tolerance; re-record it "
                "(scripts/torch_perf_gate.py --update) so the gate protects the new level"
            )
        return line


def check(
    measured: float, baseline: float, tolerance: float, *, key: str, metric: str
) -> GateResult:
    """The one comparison rule: fail iff measured > baseline*(1+tolerance)."""
    if baseline <= 0:
        raise ValueError(f"{key}: baseline {metric} must be > 0, got {baseline}")
    if measured <= 0:
        raise ValueError(f"{key}: measured {metric} must be > 0, got {measured}")
    if tolerance <= 0:
        raise ValueError(f"{key}: tolerance must be > 0, got {tolerance}")
    ratio = measured / baseline
    return GateResult(
        key=key,
        metric=metric,
        measured=measured,
        baseline=baseline,
        tolerance=tolerance,
        ratio=ratio,
        passed=ratio <= 1.0 + tolerance,
        stale=ratio < 1.0 - tolerance,
    )


def load_baseline(path: str = DEFAULT_BASELINE_PATH) -> dict:
    with open(path, encoding="utf-8") as f:
        baseline = json.load(f)
    if "entries" not in baseline:
        raise ValueError(f"{path}: not a perf baseline (no 'entries' key)")
    return baseline


def evaluate(
    baseline: dict,
    key: str,
    measurement: dict,
    *,
    tolerance: float | None = None,
    default_tolerance: float | None = None,
) -> GateResult:
    """Gate ``measurement`` against ``baseline['entries'][key]``.

    Prefers the machine-portable ``step_per_calib`` ratio when both sides
    carry it, else absolute ``step_ms``. ``tolerance`` resolution order:
    explicit arg > ``baseline['tolerance'][key]`` > ``default_tolerance``
    (the CALLER's mode default — quick and full mode gate at very different
    tightness, so a constant here could only match one of them and would
    silently loosen or tighten the other). All three absent is an error, not
    a guess: a tolerance table lost in a merge must not soften the gate."""
    entries = baseline.get("entries", {})
    if key not in entries:
        raise KeyError(
            f"no baseline entry {key!r} (have {sorted(entries)}); record one "
            "with scripts/torch_perf_gate.py --update"
        )
    entry = entries[key]
    if tolerance is None:
        tolerance = baseline.get("tolerance", {}).get(key, default_tolerance)
    if tolerance is None:
        raise ValueError(
            f"no tolerance for baseline entry {key!r} (no --tolerance arg, no "
            f"tolerance[{key!r}] record in the file, no caller default); "
            "re-record with scripts/torch_perf_gate.py --update"
        )
    # Metric preference: the machine-portable calibrated ratio, then the
    # goodput-fraction ceiling (the --data-wait mode: the entry records a
    # CEILING, same fail-iff-measured-exceeds rule), then absolute
    # milliseconds.
    for candidate in ("step_per_calib", "data_wait_frac"):
        if candidate in entry and candidate in measurement:
            metric = candidate
            break
    else:
        metric = "step_ms"
    if metric not in entry:
        # Not a missing baseline — the entry EXISTS but cannot gate this
        # measurement (e.g. a ratio-only entry against a full-mode step_ms
        # measurement). A KeyError here would be misreported as NO BASELINE.
        raise ValueError(
            f"baseline entry {key!r} has no {metric!r} (keys: {sorted(entry)}) "
            f"— it cannot gate this measurement; re-record it with "
            "scripts/torch_perf_gate.py --update"
        )
    result = check(
        float(measurement[metric]), float(entry[metric]), float(tolerance),
        key=key, metric=metric,
    )
    if metric == "data_wait_frac":
        # The entry is a CEILING recorded with deliberate headroom
        # (perf_gate --data-wait --update): sitting well under it is the
        # healthy state, not a stale baseline to re-record.
        result.stale = False
    return result


def update_baseline(
    path: str, key: str, measurement: dict, *, tolerance: float | None = None
) -> dict:
    """Record/overwrite one entry, preserving every other entry and the
    file's tolerance table. Returns the written baseline dict."""
    try:
        baseline = load_baseline(path)
    except (FileNotFoundError, ValueError):
        # ValueError covers a malformed file (torn write, merge-conflict
        # markers, missing "entries"): --update is the documented recovery
        # for exactly that state, so it must rewrite, not crash. Other
        # entries in a malformed file are unrecoverable either way.
        baseline = {"schema": 1, "entries": {}, "tolerance": {}}
    baseline["entries"][key] = dict(measurement)
    if tolerance is not None:
        baseline.setdefault("tolerance", {})[key] = float(tolerance)
    tmp = path + ".staging"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(baseline, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return baseline
