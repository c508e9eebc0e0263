#!/usr/bin/env python
"""The live run monitor for the PyTorch port: tail run directories while they train.

Polls each run's ``telemetry/events.jsonl`` through ``telemetry/monitor.py`` and prints
its liveness (``training``, ``stale_heartbeat``, ``dead``, ``finished``, ``waiting``; a
server's ``serving``) and the doctor's diagnosis; several directories print as a fleet
table. It imports the port alone, so it runs on the card's machine beside a run.

Usage::

    python scripts/torch_run_monitor.py RUN_DIR                 # follow one run
    python scripts/torch_run_monitor.py DIR1 DIR2 ...           # the fleet table
    python scripts/torch_run_monitor.py RUN_DIR --once --json   # one poll, its exit code
    python scripts/torch_run_monitor.py RUN_DIR --exit-on-end   # follow until finished or dead
    python scripts/torch_run_monitor.py RUN_DIR --events E      # monitor_alert records into E

With ``--json`` in follow mode each poll prints one compact JSON line (a list for a
fleet). The alert rules (``AlertConfig``; each fires once when its condition turns true):
``--stale-after``/``--dead-after``, the steady-state ``--data-wait-ceiling`` and
``--checkpoint-ceiling``, the anomaly kinds, and the compile_bound/straggler/comm_heavy
verdicts.

Exit codes (``--once``, and follow mode with ``--exit-on-end``): 0 alive or finished and
clean, 1 degraded (stale, a verdict other than healthy, an alert over its line), 2 dead,
3 nothing to monitor yet.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from distributed_training_pytorch_tpu_torch.telemetry import doctor as doctor_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry import monitor as monitor_lib  # noqa: E402

_FLEET_COLUMNS = ("run", "status", "verdict", "att", "epoch", "step", "step_ms", "qps", "p99", "good%", "data%",
                  "ckpt%", "age_s", "alerts")


def render_fleet(statuses) -> str:
    rows = [s.fleet_row() for s in statuses]
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in _FLEET_COLUMNS}
    lines = ["  ".join(c.ljust(widths[c]) for c in _FLEET_COLUMNS)]
    for r in rows:
        lines.append("  ".join(str(r[c]).ljust(widths[c]) for c in _FLEET_COLUMNS))
    return "\n".join(lines)


def render(statuses, as_json: bool, *, compact: bool = False) -> str:
    if as_json:
        payload = [s.to_dict() for s in statuses]
        payload = payload[0] if len(payload) == 1 else payload
        return json.dumps(payload, sort_keys=True) if compact else json.dumps(payload, indent=2, sort_keys=True)
    if len(statuses) == 1:
        return statuses[0].describe()
    return render_fleet(statuses)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("run_dir", nargs="+", help="run directories (the Trainer's save_folder) or events.jsonl paths")
    parser.add_argument("--once", action="store_true", help="one poll, printed, then exit with its code")
    parser.add_argument("--interval", type=float, default=2.0, help="seconds between polls (default 2)")
    parser.add_argument("--json", action="store_true", help="JSON instead of the console view")
    parser.add_argument("--events", default=None, help="append monitor_alert records to this JSONL event log")
    parser.add_argument("--stale-after", type=float, default=120.0,
                        help="no completed unit for this long: stale_heartbeat")
    parser.add_argument("--dead-after", type=float, default=None, help="the log silent this long: dead (3x stale)")
    parser.add_argument("--data-wait-ceiling", type=float, default=doctor_lib.THRESHOLDS["data_wait_frac"],
                        help="the steady-state data_wait fraction's alert ceiling")
    parser.add_argument("--checkpoint-ceiling", type=float, default=doctor_lib.THRESHOLDS["checkpoint_frac"],
                        help="the steady-state checkpoint fraction's alert ceiling")
    parser.add_argument("--exit-on-end", action="store_true",
                        help="follow mode: exit with the code once every run is finished or dead")
    args = parser.parse_args()
    config = monitor_lib.AlertConfig(stale_after_s=args.stale_after, dead_after_s=args.dead_after,
                                     data_wait_frac=args.data_wait_ceiling, checkpoint_frac=args.checkpoint_ceiling)
    alert_log = None
    if args.events:
        from distributed_training_pytorch_tpu_torch.telemetry import EventLog

        alert_log = EventLog(args.events, process_index=0)
    monitors = [monitor_lib.RunMonitor(d, config, alert_log=alert_log) for d in args.run_dir]
    try:
        while True:
            statuses = [m.poll() for m in monitors]
            print(render(statuses, args.json, compact=not args.once), flush=True)
            for s in statuses:
                for a in s.alerts:
                    print(f"torch_run_monitor ALERT [{a['rule']}] {s.run_dir}: value={a.get('value')} "
                          f"threshold={a.get('threshold')} — {a.get('message', '')}", file=sys.stderr)
            code = monitor_lib.worst_exit_code(statuses)
            if args.once:
                return code
            if args.exit_on_end and all(s.status in ("finished", "dead") for s in statuses):
                return code
            time.sleep(args.interval)
    finally:
        if alert_log is not None:
            alert_log.close()


if __name__ == "__main__":
    sys.exit(main())
