#!/usr/bin/env python
"""The bench-round ledger of the PyTorch port: committed rounds as trajectories.

Reads ``BENCH_r*.json`` / ``MULTICHIP_r*.json`` round files under ``--root`` (the repo's
root by default) through ``distributed_training_pytorch_tpu_torch.telemetry.history`` and
prints the ledger with its flat streaks, regressions and provenance breaks. It imports
the port alone, so it runs where JAX is not installed; the port's own benchmark writes
its rounds in this format.

Usage::

    python scripts/torch_bench_history.py                 # ledger and findings
    python scripts/torch_bench_history.py --json          # the ledger as one JSON object
    python scripts/torch_bench_history.py --events E      # + a bench_history record
    python scripts/torch_bench_history.py --self-test     # the check below

``--self-test`` checks the detector on the committed rounds: the r02->r05 plateau of the
headline series (``step_ms`` and ``value``) is found as a flat streak of at least four
rounds, and it has ended (a later round lies outside its band).

Exit codes: 0 ok, 1 self-test failure, 2 no round files under ``--root``.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from distributed_training_pytorch_tpu_torch.telemetry import history as history_lib  # noqa: E402

REPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def self_test(report) -> int:
    """The r02->r05 plateau is in the ledger, on both headline fields, and no flat streak
    of its series reaches the newest round."""
    failures = []
    for field in ("step_ms", "value"):
        hits = [s for s in report.streaks
                if s.series.endswith(f":: {field}") and len(s.rounds) >= 4 and s.rounds[0] <= 2 and s.rounds[-1] >= 5]
        if not hits:
            failures.append(f"{field}: no flat streak of 4 rounds or more over r02->r05 "
                            f"(streaks: {[s.describe() for s in report.streaks]})")
            continue
        streak = hits[0]
        last_round = max(r for r, _ in report.series[streak.series])
        live = [s for s in report.streaks if s.series == streak.series and s.rounds[-1] >= last_round]
        if last_round <= streak.rounds[-1]:
            failures.append(f"{field}: no round after r{streak.rounds[-1]:02d} on {streak.series}: the streak never ended")
        elif live:
            failures.append(f"{field}: a flat streak reaches the newest round r{last_round:02d} ({live[0].describe()})")
        else:
            print(f"torch_bench_history self-test [{field}]: {streak.describe()} — found, and ended "
                  f"(r{last_round:02d} is outside its band)")
    if failures:
        print("TORCH BENCH HISTORY SELF-TEST FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("torch_bench_history self-test OK: the r02->r05 plateau is found on both series and ends before the "
          "newest round")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO_ROOT, help="directory of the round files (default: the repo's root)")
    parser.add_argument("--flat-tol", type=float, default=history_lib.FLAT_REL_TOL,
                        help="a flat streak's relative band (default %(default)s)")
    parser.add_argument("--flat-rounds", type=int, default=history_lib.FLAT_MIN_ROUNDS,
                        help="rounds a flat streak needs (default %(default)s)")
    parser.add_argument("--regression-tol", type=float, default=history_lib.REGRESSION_REL_TOL,
                        help="round-over-round tolerance in the bad direction (default %(default)s)")
    parser.add_argument("--json", action="store_true", help="print the ledger as one JSON object")
    parser.add_argument("--events", default=None, help="append a bench_history record to this JSONL event log")
    parser.add_argument("--self-test", action="store_true", help="check the detector on the committed rounds")
    args = parser.parse_args()

    report = history_lib.analyze_history(args.root, flat_tol=args.flat_tol, flat_min_rounds=args.flat_rounds,
                                         regression_tol=args.regression_tol)
    if not report.entries:
        print(f"torch_bench_history: no BENCH_r*/MULTICHIP_r* round files under {args.root}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
    else:
        print(report.describe())
    if args.events:
        from distributed_training_pytorch_tpu_torch.telemetry import EventLog

        log = EventLog(args.events, process_index=0)
        log.emit("bench_history", root=os.path.abspath(args.root), entries=len(report.entries),
                 series=len(report.series), streaks=[s.to_dict() for s in report.streaks],
                 regressions=[r.to_dict() for r in report.regressions])
        log.close()
    if args.self_test:
        return self_test(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
