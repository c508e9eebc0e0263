"""Across-runs attribution: where a step time's change between two runs came from.

Counterpart of ``distributed_training_pytorch_tpu/profiling/diff.py``, over the port's
:class:`~.report.StepProfile` (or its ``to_dict()``, the ``profile_capture`` event's
payload), with the same rows and the same ``to_dict`` on the same inputs (the CPU tests
hold the two byte-equal).

* Each side's per-category wall is ``fraction x step_us`` (``idle`` included); the
  fractions sum to 1, so the per-category deltas sum to the step-time delta and each
  row's signed ``frac_of_delta`` sums to 1 over the rows. Rows are ranked by |delta|.
* The top-op tables are joined by name: matched ops carry before/after/delta, an op on
  one side only is ``new`` or ``removed``.

:func:`attribute_delta` (over two ``{key: value}`` maps) and :func:`describe_rows` are the
port's one delta attribution: ``scripts/torch_run_compare.py`` uses them for profile
categories and goodput buckets, and ``scripts/torch_perf_gate.py`` for its failure's
diagnosis.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from distributed_training_pytorch_tpu_torch.profiling.categories import IDLE
from distributed_training_pytorch_tpu_torch.profiling.report import StepProfile

__all__ = [
    "DeltaRow",
    "OpDelta",
    "ProfileDiff",
    "attribute_delta",
    "attribute_entry_delta",
    "describe_rows",
    "diff_profiles",
    "roofline_bound",
]


@dataclasses.dataclass
class DeltaRow:
    """One key's contribution to a total delta. ``frac_of_delta`` is signed
    and the rows of one :func:`attribute_delta` call sum to 1 by
    construction (0 everywhere when the totals are identical)."""

    key: str
    before: float
    after: float
    delta: float
    frac_of_delta: float

    def to_dict(self) -> dict:
        return {
            "key": self.key,
            "before": round(self.before, 4),
            "after": round(self.after, 4),
            "delta": round(self.delta, 4),
            "frac_of_delta": round(self.frac_of_delta, 4),
        }


def attribute_delta(
    before: Mapping[str, float], after: Mapping[str, float]
) -> list[DeltaRow]:
    """THE delta-attribution rule: per-key ``after - before`` over the union
    of keys (absent = 0), each with its signed share of the total delta,
    ranked by |delta| so the keys explaining the change come first.

    ``sum(row.delta) == sum(after.values()) - sum(before.values())`` exactly
    (same float additions), and ``sum(row.frac_of_delta) == 1`` whenever the
    total delta is nonzero — the attribution is exhaustive by construction,
    the StepProfile convention carried across runs."""
    keys = sorted(set(before) | set(after))
    total = sum(after.values()) - sum(before.values())
    rows = []
    for key in keys:
        b = float(before.get(key, 0.0))
        a = float(after.get(key, 0.0))
        delta = a - b
        rows.append(
            DeltaRow(
                key=key,
                before=b,
                after=a,
                delta=delta,
                frac_of_delta=(delta / total) if total else 0.0,
            )
        )
    rows.sort(key=lambda r: (-abs(r.delta), r.key))
    return rows


def attribute_entry_delta(
    before: Mapping, after: Mapping, *, metric: str = "step_ms"
) -> "list[DeltaRow] | None":
    """Category attribution of a ``step_ms`` delta between two measurement
    dicts (a ``TORCH_PERF_BASELINE.json`` entry, a bench JSON line, a perf
    gate measurement), each carrying ``metric`` plus ``categories`` — the
    StepProfile fraction dict (``idle`` included, summing to 1). Returns
    ranked per-category millisecond rows whose deltas sum to the step_ms
    delta exactly, or None when either side lacks the ingredients (the
    caller degrades to an unattributed verdict)."""
    try:
        b_ms = float(before[metric])
        a_ms = float(after[metric])
        b_cats = dict(before["categories"])
        a_cats = dict(after["categories"])
    except (KeyError, TypeError, ValueError):
        return None
    if not b_cats or not a_cats:
        return None
    return attribute_delta(
        {str(k): float(v) * b_ms for k, v in b_cats.items()},
        {str(k): float(v) * a_ms for k, v in a_cats.items()},
    )


def describe_rows(
    rows: list[DeltaRow], *, unit: str = "ms", top: int = 6, digits: int = 2
) -> str:
    """The doctor-style one-line attribution: ``conv +3.10 ms (74%), idle
    +0.90 ms (21%), …`` — shared by the compare script's verdict rows and
    the perf gate's FAIL diagnosis so the two can never phrase the same
    delta differently."""
    parts = []
    for row in rows[:top]:
        pct = f" ({100 * row.frac_of_delta:.0f}%)" if row.frac_of_delta else ""
        parts.append(f"{row.key} {row.delta:+.{digits}f} {unit}{pct}")
    dropped = len(rows) - top
    if dropped > 0:
        parts.append(f"… {dropped} smaller")
    return ", ".join(parts)


def roofline_bound(intensity: "float | None", ridge: "float | None") -> "str | None":
    """Classify an op's roofline position: ``compute``-bound at or above the
    ridge intensity (FLOPs/byte), ``memory``-bound below, None when either
    figure is unknown."""
    if intensity is None or ridge is None:
        return None
    return "compute" if intensity >= ridge else "memory"


@dataclasses.dataclass
class OpDelta:
    """One op's before/after line. ``status`` is ``matched`` / ``new`` /
    ``removed``; per-step microseconds on both sides (0 for the absent
    side). ``bound_shift`` names a ridge crossing (``memory->compute``
    or the reverse) when both sides carry
    roofline intensity and a ridge was given."""

    name: str
    category: str
    before_us: float
    after_us: float
    delta_us: float
    status: str
    intensity_before: "float | None" = None
    intensity_after: "float | None" = None
    bound_shift: "str | None" = None

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "category": self.category,
            "before_us": round(self.before_us, 1),
            "after_us": round(self.after_us, 1),
            "delta_us": round(self.delta_us, 1),
            "status": self.status,
        }
        if self.intensity_before is not None:
            out["intensity_before"] = round(self.intensity_before, 2)
        if self.intensity_after is not None:
            out["intensity_after"] = round(self.intensity_after, 2)
        if self.bound_shift is not None:
            out["bound_shift"] = self.bound_shift
        return out

    def describe(self) -> str:
        line = f"{self.name} [{self.category}] "
        if self.status == "new":
            line += f"NEW {self.after_us:.1f} us/step"
        elif self.status == "removed":
            line += f"REMOVED (was {self.before_us:.1f} us/step)"
        else:
            line += (
                f"{self.before_us:.1f} -> {self.after_us:.1f} us/step "
                f"({self.delta_us:+.1f})"
            )
        if self.bound_shift:
            line += (
                f"; roofline {self.bound_shift} "
                f"(intensity {self.intensity_before:.0f} -> {self.intensity_after:.0f})"
            )
        return line


@dataclasses.dataclass
class ProfileDiff:
    """The A/B report over two StepProfiles. ``categories`` are per-step
    microsecond rows (``idle`` included) whose deltas sum to
    ``step_delta_us`` exactly and whose ``frac_of_delta`` sum to 1;
    ``ops`` is the joined top-op table ranked by |delta|."""

    before_path: str
    after_path: str
    step_before_us: float
    step_after_us: float
    categories: list[DeltaRow]
    ops: list[OpDelta]

    @property
    def step_delta_us(self) -> float:
        return self.step_after_us - self.step_before_us

    @property
    def new_ops(self) -> list[OpDelta]:
        return [o for o in self.ops if o.status == "new"]

    @property
    def removed_ops(self) -> list[OpDelta]:
        return [o for o in self.ops if o.status == "removed"]

    @property
    def roofline_shifts(self) -> list[OpDelta]:
        return [o for o in self.ops if o.bound_shift is not None]

    def max_category_delta_frac(self) -> float:
        """Largest |category delta| relative to the larger step time — the
        identical-twins noise-floor figure (no category of a twin pair may
        exceed the compare script's floor)."""
        denom = max(self.step_before_us, self.step_after_us, 1e-9)
        return max((abs(r.delta) / denom for r in self.categories), default=0.0)

    def to_dict(self) -> dict:
        return {
            "before": self.before_path,
            "after": self.after_path,
            "step_before_us": round(self.step_before_us, 1),
            "step_after_us": round(self.step_after_us, 1),
            "step_delta_us": round(self.step_delta_us, 1),
            "categories": [r.to_dict() for r in self.categories],
            "ops": [o.to_dict() for o in self.ops],
            "new_ops": [o.name for o in self.new_ops],
            "removed_ops": [o.name for o in self.removed_ops],
            "roofline_shifts": [o.to_dict() for o in self.roofline_shifts],
        }

    def describe(self, *, top: int = 6) -> str:
        ms = self.step_delta_us / 1e3
        pct = (
            f" ({100 * self.step_delta_us / self.step_before_us:+.1f}%)"
            if self.step_before_us
            else ""
        )
        lines = [
            f"step {self.step_before_us / 1e3:.2f} -> {self.step_after_us / 1e3:.2f} ms"
            f" ({ms:+.2f} ms{pct}): "
            + describe_rows(
                [
                    DeltaRow(r.key, r.before / 1e3, r.after / 1e3, r.delta / 1e3,
                             r.frac_of_delta)
                    for r in self.categories
                ],
                top=top,
            )
        ]
        for op in self.ops[:top]:
            if op.status != "matched" or abs(op.delta_us) > 0:
                lines.append("  op: " + op.describe())
        for op in self.roofline_shifts:
            if op not in self.ops[:top]:
                lines.append("  op: " + op.describe())
        lines.append(f"  evidence: before={self.before_path} after={self.after_path}")
        return "\n".join(lines)


def _as_report(profile) -> dict:
    """Accept a StepProfile or its ``to_dict()`` (the ``profile_capture``
    event payload / bench JSON fields carry the dict form). A live
    StepProfile is read at FULL precision — ``to_dict()`` rounds fractions
    to 4 digits for JSON, and the diff must not manufacture a few-ppm
    category delta out of display rounding."""
    if isinstance(profile, StepProfile):
        return {
            "trace_path": profile.trace_path,
            "source": profile.source,
            "steps": profile.steps,
            "span_us": profile.span_us,
            "step_us": profile.step_us,
            "categories": profile.categories,
            "top_ops": [row.to_dict() | {"total_us": row.total_us}
                        for row in profile.top_ops],
        }
    if isinstance(profile, dict):
        return profile
    raise TypeError(
        f"expected StepProfile or its to_dict() mapping, got {type(profile)}"
    )


def _per_step_us(report: dict) -> float:
    """One side's per-step span: ``step_us`` when the trace knew its step
    count, else the whole span as one unit (both sides then compare
    span-to-span — still exhaustive, just coarser)."""
    step = report.get("step_us")
    if step is None:
        step = report["span_us"]
    return float(step)


def _op_rows(report: dict) -> dict[str, dict]:
    steps = report.get("steps") or 1
    out = {}
    for row in report.get("top_ops", ()):  # OpRow dicts (REPORT_FIELDS schema)
        out[str(row["name"])] = {
            "category": row.get("category", "other"),
            "us": float(row["total_us"]) / steps,
            "intensity": row.get("arith_intensity"),
        }
    return out


def diff_profiles(
    before,
    after,
    *,
    ridge_intensity: "float | None" = None,
    top_k: int = 20,
) -> ProfileDiff:
    """Diff two step profiles (:class:`~.report.StepProfile` objects or
    their ``to_dict()`` forms) into a ranked :class:`ProfileDiff`.

    ``ridge_intensity`` (FLOPs/byte: the card's peak FLOP/s over its memory
    rate) arms the roofline-shift detector: a matched op whose arithmetic
    intensity crossed the ridge is flagged ``memory->compute`` or the
    reverse. The port's ``OpRow`` carries no intensity (``profiling/report.py``),
    so on its own captures no shift is classified; a report dict that has
    intensities is read as the JAX module reads it."""
    b = _as_report(before)
    a = _as_report(after)
    step_b = _per_step_us(b)
    step_a = _per_step_us(a)

    # Per-category per-step us: fraction x step — the fractions include
    # `idle` and sum to 1, so each side's rows sum to its step time and the
    # deltas sum to the step delta, exactly.
    cat_rows = attribute_delta(
        {str(k): float(v) * step_b for k, v in b.get("categories", {}).items()},
        {str(k): float(v) * step_a for k, v in a.get("categories", {}).items()},
    )

    ops_b = _op_rows(b)
    ops_a = _op_rows(a)
    op_deltas = []
    for name in sorted(set(ops_b) | set(ops_a)):
        rb, ra = ops_b.get(name), ops_a.get(name)
        status = "matched" if rb and ra else ("removed" if rb else "new")
        ib = rb.get("intensity") if rb else None
        ia = ra.get("intensity") if ra else None
        shift = None
        if status == "matched":
            bound_b = roofline_bound(ib, ridge_intensity)
            bound_a = roofline_bound(ia, ridge_intensity)
            if bound_b and bound_a and bound_b != bound_a:
                shift = f"{bound_b}->{bound_a}"
        op_deltas.append(
            OpDelta(
                name=name,
                category=(ra or rb)["category"],
                before_us=rb["us"] if rb else 0.0,
                after_us=ra["us"] if ra else 0.0,
                delta_us=(ra["us"] if ra else 0.0) - (rb["us"] if rb else 0.0),
                status=status,
                intensity_before=ib,
                intensity_after=ia,
                bound_shift=shift,
            )
        )
    op_deltas.sort(key=lambda o: (-abs(o.delta_us), o.name))

    return ProfileDiff(
        before_path=str(b.get("trace_path", "")),
        after_path=str(a.get("trace_path", "")),
        step_before_us=step_b,
        step_after_us=step_a,
        categories=cat_rows,
        ops=op_deltas[:top_k],
    )


# The idle bucket's name, for callers that phrase verdicts about it.
IDLE_CATEGORY = IDLE
