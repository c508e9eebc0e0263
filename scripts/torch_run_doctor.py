#!/usr/bin/env python
"""The run doctor for the PyTorch port: a ranked diagnosis of a run's event log.

Reads ``<run_dir>/telemetry/events.jsonl`` (a ``Trainer(telemetry="on")`` run, or a direct
``.jsonl`` path) and prints the verdict of ``telemetry/doctor.py``: ``compile_bound``,
``data_bound``, ``checkpoint_stall``, ``straggler``, ``comm_heavy`` or ``healthy``, each
with its evidence rows. It imports the port alone, so it runs on the card's machine.

Usage::

    python scripts/torch_run_doctor.py RUN_DIR             # the diagnosis
    python scripts/torch_run_doctor.py RUN_DIR --json      # as one JSON object
    python scripts/torch_run_doctor.py RUN_DIR --timeline  # + RUN_DIR/telemetry/timeline.json
    python scripts/torch_run_doctor.py RUN_DIR --events E  # + a run_doctor record in E

The timeline is trace-event JSON (``telemetry/timeline.py``): open it in
``ui.perfetto.dev`` or ``chrome://tracing``.

Exit codes: 0 a diagnosis, 2 no event log at the path.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from distributed_training_pytorch_tpu_torch.telemetry import doctor as doctor_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry import timeline as timeline_lib  # noqa: E402
from distributed_training_pytorch_tpu_torch.telemetry.events import load_run_events  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("run_dir", help="the run directory (the Trainer's save_folder) or an events.jsonl path")
    parser.add_argument("--json", action="store_true", help="print the diagnosis as one JSON object")
    parser.add_argument("--timeline", action="store_true", help="also write <run_dir>/telemetry/timeline.json")
    parser.add_argument("--events", default=None, help="append a run_doctor record to this JSONL event log")
    args = parser.parse_args()
    try:
        diagnosis = doctor_lib.diagnose(load_run_events(args.run_dir))
    except FileNotFoundError as e:
        print(f"torch_run_doctor: {e}", file=sys.stderr)
        return 2
    if args.timeline:
        _, path = timeline_lib.export_timeline(args.run_dir)
        print(f"torch_run_doctor: timeline written to {path} (open it in ui.perfetto.dev or chrome://tracing)")
    if args.json:
        print(json.dumps(diagnosis.to_dict(), indent=2, sort_keys=True))
    else:
        print(f"torch_run_doctor: {args.run_dir}")
        print(diagnosis.describe())
        print(f"verdict: {diagnosis.verdict}")
    if args.events:
        from distributed_training_pytorch_tpu_torch.telemetry import EventLog

        log = EventLog(args.events, process_index=0)
        log.emit("run_doctor", run_dir=str(args.run_dir), verdict=diagnosis.verdict, healthy=diagnosis.healthy,
                 scores=doctor_lib.scalar_fields(diagnosis.signals),
                 steady_fractions=doctor_lib.steady_fractions(diagnosis.signals.goodput_seconds or {}))
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
