#!/usr/bin/env python
"""Compare two runs of the PyTorch port: where a step time's change came from.

Takes two artifacts of one kind, found from what each path holds, and prints a ranked
attribution through the port's one delta attribution (``profiling/diff.py``). It imports
the port alone, so it runs on the card's machine.

Inputs (``--kind`` overrides the detection)::

    python scripts/torch_run_compare.py A/profile B/profile --steps 4  # profile captures
    python scripts/torch_run_compare.py run_a/ run_b/                  # Trainer run dirs
    python scripts/torch_run_compare.py BENCH_r02.json BENCH_r05.json  # bench entries

* **profile**: a Kineto trace (``*.pt.trace.json``, or a directory holding one, as a
  ``ProfileConfig`` capture writes) each side, analysed into a ``StepProfile``
  (``--steps``: the steps each trace holds, for per-step figures), diffed by
  ``diff_profiles``: per-category rows whose deltas sum to the step's delta, and the
  top ops matched, new or removed;
* **run**: per-step goodput-bucket wall from the last ``goodput_seconds`` snapshot of each
  event log, the steady-state fractions' diff (the clean check), and the profile
  categories when both runs captured one;
* **bench**: the headline fields of two bench JSON lines (a round file's first entry),
  with category attribution when both carry ``categories``.

Two sides whose provenance disagrees on a configuration key
(``telemetry.provenance.COMPARE_KEYS``) are refused, naming the keys; ``--force``
compares them anyway. ``--json`` prints the result as one object; its
``rows_delta_sum_ms`` is the unrounded sum of the category rows' deltas, equal to
``step_delta_ms`` but for float rounding. ``--events E`` appends a ``run_compare`` record.

Exit codes: 0 a report, 2 provenance refusal, 3 unusable input.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from distributed_training_pytorch_tpu_torch.profiling import diff as diff_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.profiling.trace import TRACE_SUFFIX, latest_trace_file  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry import history as history_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry import provenance as prov_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry.events import load_run_events  # noqa: E402

DEFAULT_NOISE_FLOOR = 0.10


def detect_kind(path: str) -> str:
    """profile | run | bench, by what the path holds."""
    if path.endswith(TRACE_SUFFIX):
        return "profile"
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "telemetry", "events.jsonl")):
            return "run"
        if latest_trace_file(path) is not None:
            return "profile"
        raise ValueError(f"{path}: holds neither telemetry/events.jsonl (a run) nor a *{TRACE_SUFFIX} (a capture)")
    if os.path.basename(path) == "events.jsonl":
        return "run"
    if path.endswith((".json", ".jsonl")):
        return "bench"
    raise ValueError(f"{path}: cannot tell its kind (a *{TRACE_SUFFIX} trace, a run dir, or a bench *.json) — "
                     "pass --kind")


def load_bench_entry(path: str) -> dict:
    """One bench measurement: a round file's first entry, or the first JSON line with a
    ``metric`` or ``step_ms``."""
    if history_lib._ROUND_RE.search(os.path.basename(path)):
        entries = history_lib.load_round_file(path)
        if not entries:
            raise ValueError(f"{path}: the round file has no bench entries")
        if len(entries) > 1:
            print(f"torch_run_compare: {path} holds {len(entries)} entries — comparing its first", file=sys.stderr)
        return entries[0].fields
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if isinstance(rec, dict) and ("metric" in rec or "step_ms" in rec):
                return rec
    raise ValueError(f"{path}: no bench JSON line")


def load_run_summary(path: str) -> dict:
    """A run's last cumulative goodput snapshot with the step count at that record, its
    provenance, its last profile capture's categories, and the log lines they came from."""
    run_dir = os.path.dirname(os.path.dirname(path)) if path.endswith("events.jsonl") else path
    out = {"run_dir": os.path.abspath(run_dir), "goodput_seconds": None, "goodput_line": None, "steps": None,
           "provenance": None, "profile": None, "profile_line": None}
    max_step = 0
    for rec in load_run_events(run_dir):
        if rec.get("step") is not None:
            max_step = max(max_step, int(rec["step"]))
        if isinstance(rec.get("goodput_seconds"), dict):
            out["goodput_seconds"] = dict(rec["goodput_seconds"])
            out["goodput_line"] = rec.get("_line")
            out["steps"] = int(rec["step"]) if rec.get("step") is not None else max_step
        if rec.get("event") == "run_start" and isinstance(rec.get("provenance"), dict):
            out["provenance"] = rec["provenance"]
        if rec.get("event") == "profile_capture" and isinstance(rec.get("categories"), dict):
            out["profile"] = {"categories": rec["categories"], "step_us": rec.get("step_us")}
            out["profile_line"] = rec.get("_line")
    if out["goodput_seconds"] is None:
        raise ValueError(f"{run_dir}: the event log has no goodput_seconds snapshot — was telemetry on?")
    if not out["steps"]:
        raise ValueError(f"{run_dir}: no goodput snapshot after a completed step")
    return out


def check_provenance(before, after, force: bool) -> "tuple[bool, list, str]":
    """(ok, differing keys, note); ok is False for a refusal."""
    if not before or not after:
        return True, [], "one side or both carry no provenance — compared unverified"
    keys = prov_lib.differing_keys(before, after)
    if not keys:
        return True, [], f"provenance OK (git {before.get('git_sha')} -> {after.get('git_sha')})"
    if force:
        return True, keys, f"provenance DIFFERS on {', '.join(keys)} — compared anyway (--force)"
    return False, keys, (f"provenance DIFFERS on {', '.join(keys)} — these measure different programs; "
                         "--force compares them anyway")


def compare_profiles(path_a: str, path_b: str, *, steps=None, ridge=None, top=6,
                     noise_floor=DEFAULT_NOISE_FLOOR) -> dict:
    from distributed_training_pytorch_tpu_torch.profiling import analyze_trace

    diff = diff_lib.diff_profiles(analyze_trace(path_a, steps=steps), analyze_trace(path_b, steps=steps),
                                  ridge_intensity=ridge)
    clean = diff.max_category_delta_frac() <= noise_floor
    return {
        "kind": "profile",
        "clean": clean,
        "step_before_ms": diff.step_before_us / 1e3,
        "step_after_ms": diff.step_after_us / 1e3,
        "step_delta_ms": diff.step_delta_us / 1e3,
        "rows_delta_sum_ms": sum(r.delta for r in diff.categories) / 1e3,
        "top_rows": [r.to_dict() for r in diff.categories[:top]],
        "new_ops": [o.name for o in diff.new_ops],
        "removed_ops": [o.name for o in diff.removed_ops],
        "report": (f"CLEAN — no category moved more than the {100 * noise_floor:.0f}% noise floor\n" if clean else "")
        + diff.describe(top=top),
        "provenance": (None, None),
    }


def steady_diff(seconds_a: dict, seconds_b: dict, *, noise_floor=DEFAULT_NOISE_FLOOR) -> dict:
    """The steady-state goodput fractions' diff (the doctor's: compile, restart and
    overlapped commits out of the denominator); ``clean`` when no bucket moved more than
    ``noise_floor``."""
    from distributed_training_pytorch_tpu_torch.telemetry import doctor as doctor_lib

    steady_a = doctor_lib.steady_fractions(dict(seconds_a))
    steady_b = doctor_lib.steady_fractions(dict(seconds_b))
    rows = diff_lib.attribute_delta(steady_a, steady_b)
    max_delta = max((abs(r.delta) for r in rows), default=0.0)
    return {"rows": rows, "max_delta": max_delta, "clean": max_delta <= noise_floor, "fractions": (steady_a, steady_b)}


def compare_runs(path_a: str, path_b: str, *, top=6, noise_floor=DEFAULT_NOISE_FLOOR) -> dict:
    a, b = load_run_summary(path_a), load_run_summary(path_b)
    per_step_a = {k: v / a["steps"] * 1e3 for k, v in a["goodput_seconds"].items()}
    per_step_b = {k: v / b["steps"] * 1e3 for k, v in b["goodput_seconds"].items()}
    rows = diff_lib.attribute_delta(per_step_a, per_step_b)
    sd = steady_diff(a["goodput_seconds"], b["goodput_seconds"], noise_floor=noise_floor)
    total_delta = sum(r.delta for r in rows)
    lines = []
    if sd["clean"]:
        lines.append(f"CLEAN — no steady-state bucket fraction moved more than the {100 * noise_floor:.0f}% noise "
                     f"floor (max |delta| {100 * sd['max_delta']:.1f}%)")
    lines.append(f"per-step wall {sum(per_step_a.values()):.2f} -> {sum(per_step_b.values()):.2f} ms "
                 f"({total_delta:+.2f} ms): " + diff_lib.describe_rows(rows, top=top))
    lines.append(f"  evidence: goodput snapshots {a['run_dir']}/telemetry/events.jsonl:{a['goodput_line']} vs "
                 f"{b['run_dir']}/telemetry/events.jsonl:{b['goodput_line']} ({a['steps']} vs {b['steps']} steps)")
    profile_rows = None
    if a["profile"] and b["profile"]:
        profile_rows = diff_lib.attribute_entry_delta(
            {"step_ms": (a["profile"]["step_us"] or 0) / 1e3, "categories": a["profile"]["categories"]},
            {"step_ms": (b["profile"]["step_us"] or 0) / 1e3, "categories": b["profile"]["categories"]})
        if profile_rows:
            lines.append("profile categories: " + diff_lib.describe_rows(profile_rows, top=top))
            lines.append(f"  evidence: profile_capture records at lines {a['profile_line']} vs {b['profile_line']}")
    return {
        "kind": "run",
        "clean": sd["clean"],
        "step_delta_ms": total_delta,
        "rows_delta_sum_ms": total_delta,
        "top_rows": [r.to_dict() for r in rows[:top]],
        "steady_rows": [r.to_dict() for r in sd["rows"][:top]],
        "profile_rows": [r.to_dict() for r in profile_rows[:top]] if profile_rows else None,
        "report": "\n".join(lines),
        "provenance": (a["provenance"], b["provenance"]),
    }


def compare_bench(path_a: str, path_b: str, *, top=6, noise_floor=DEFAULT_NOISE_FLOOR) -> dict:
    a, b = load_bench_entry(path_a), load_bench_entry(path_b)
    lines, headline = [], []
    for field in ("step_ms", "value", "mfu", "mfu_exec", "comm_bytes_per_step"):
        va, vb = a.get(field), b.get(field)
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            change = (vb / va - 1.0) if va else 0.0
            headline.append({"field": field, "before": va, "after": vb, "change": change})
            lines.append(f"{field}: {va:.4g} -> {vb:.4g} ({100 * change:+.2f}%)")
    if not headline:
        raise ValueError("the two bench entries share no numeric headline field")
    step_fields = {h["field"]: h for h in headline}
    clean = all(abs(h["change"]) <= noise_floor for h in headline)
    rows = diff_lib.attribute_entry_delta(a, b)
    if rows:
        lines.append("step_ms attribution (categories): " + diff_lib.describe_rows(rows, top=top))
    elif "step_ms" in step_fields:
        lines.append("  (no category attribution: one entry or both carry no `categories`)")
    step_delta = step_fields["step_ms"]["after"] - step_fields["step_ms"]["before"] if "step_ms" in step_fields else 0.0
    return {
        "kind": "bench",
        "clean": clean,
        "step_delta_ms": step_delta,
        "rows_delta_sum_ms": sum(r.delta for r in rows) if rows else None,
        "headline": headline,
        "top_rows": [r.to_dict() for r in rows[:top]] if rows else None,
        "report": "\n".join(lines),
        "provenance": (a.get("provenance"), b.get("provenance")),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("before", help="the A side (the baseline)")
    parser.add_argument("after", help="the B side (the candidate)")
    parser.add_argument("--kind", default="auto", choices=("auto", "bench", "profile", "run"),
                        help="the artifacts' kind (default: found from each path)")
    parser.add_argument("--steps", type=int, default=None, help="profile: the steps each trace holds")
    parser.add_argument("--force", action="store_true", help="compare despite differing provenance")
    parser.add_argument("--ridge", type=float, default=None,
                        help="profile: the ridge intensity (FLOPs/byte) for roofline shifts")
    parser.add_argument("--top", type=int, default=6, help="rows a section (default %(default)s)")
    parser.add_argument("--noise-floor", type=float, default=DEFAULT_NOISE_FLOOR,
                        help="the clean verdict's largest move, a fraction (default %(default)s)")
    parser.add_argument("--json", action="store_true", help="print the comparison as one JSON object")
    parser.add_argument("--events", default=None, help="append a run_compare record to this JSONL event log")
    args = parser.parse_args()
    try:
        if args.kind == "auto":
            kind_a, kind_b = detect_kind(args.before), detect_kind(args.after)
            if kind_a != kind_b:
                print(f"torch_run_compare: {args.before} is a {kind_a}, {args.after} a {kind_b} — one kind needed",
                      file=sys.stderr)
                return 3
            kind = kind_a
        else:
            kind = args.kind
        if kind == "profile":
            result = compare_profiles(args.before, args.after, steps=args.steps, ridge=args.ridge, top=args.top,
                                      noise_floor=args.noise_floor)
        elif kind == "run":
            result = compare_runs(args.before, args.after, top=args.top, noise_floor=args.noise_floor)
        else:
            result = compare_bench(args.before, args.after, top=args.top, noise_floor=args.noise_floor)
    except (FileNotFoundError, ValueError) as e:
        print(f"torch_run_compare: {e}", file=sys.stderr)
        return 3
    ok, keys, note = check_provenance(*result["provenance"], args.force)
    print(f"torch_run_compare [{result['kind']}]: {args.before} -> {args.after}")
    print(f"  {note}")
    if not ok:
        return 2
    if args.json:
        out = {k: v for k, v in result.items() if k not in ("report", "provenance")}
        out["provenance_differs"] = keys
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        print(result["report"])
    if args.events:
        from distributed_training_pytorch_tpu_torch.telemetry import EventLog

        log = EventLog(args.events, process_index=0)
        log.emit("run_compare", kind=result["kind"], before=str(args.before), after=str(args.after),
                 clean=result["clean"], step_delta_ms=result["step_delta_ms"], top_rows=result.get("top_rows"),
                 provenance_differs=keys, forced=bool(keys and args.force))
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
