"""Run observability: the port of ``distributed_training_pytorch_tpu/telemetry/``.

* :mod:`~.events`: the JSONL flight recorder and its readers (the JAX vocabulary and
  schema version, so the JAX package's readers read a port run directory);
* :mod:`~.goodput`: wall time in buckets, carried across restarts in checkpoint meta;
* :mod:`~.stats`: grad/param norms, update ratio and the non-finite flag, computed in
  the step (a chained window's CUDA graph captures them);
* :mod:`~.mfu`: the H100 peak table and the per-window MFU;
* :mod:`~.anomaly`: host-side detectors at the existing sync points;
* :mod:`~.straggler`: per-rank window walls riding the metrics all-reduce;
* :mod:`~.provenance`: git SHA, torch/CUDA/nvcc versions, the card's name and power limit;
* :mod:`~.doctor`: the ranked diagnosis and the epoch-end ``doctor/*`` scalars;
* :mod:`~.exporter`: ``/status`` and ``/metrics`` on rank 0;
* the readers, which import the port alone: :mod:`~.timeline` (a run's trace-event
  timeline), :mod:`~.monitor` (the doctor live, with liveness and alert rules) and
  :mod:`~.history` (the bench rounds' trajectories).

``Trainer(telemetry="on")`` (or a :class:`Telemetry`) wires them; the entries honour
``TELEMETRY=1``. Off (the default) is the program without telemetry: no work is added to
the step and no sync to the loop. :mod:`~.controller` is the fleet controller's policy
(pure, clock-injected); ``scripts/torch_fleet_controller.py`` is its mechanism.
"""

from __future__ import annotations

import dataclasses

from distributed_training_pytorch_tpu_torch.telemetry.anomaly import Anomaly, AnomalyDetector, AnomalyError
from distributed_training_pytorch_tpu_torch.telemetry.events import (
    SCHEMA_VERSION,
    EventFollower,
    EventLog,
    load_run_events,
    read_events,
)
from distributed_training_pytorch_tpu_torch.telemetry.goodput import BUCKETS, GoodputMeter
from distributed_training_pytorch_tpu_torch.telemetry.mfu import PEAK_FLOPS, device_peak_flops, mfu_value, window_report
from distributed_training_pytorch_tpu_torch.telemetry.stats import STAT_KEYS, train_health_stats

__all__ = [
    "Anomaly",
    "AnomalyDetector",
    "AnomalyError",
    "BUCKETS",
    "EventFollower",
    "EventLog",
    "GoodputMeter",
    "PEAK_FLOPS",
    "SCHEMA_VERSION",
    "STAT_KEYS",
    "Telemetry",
    "device_peak_flops",
    "load_run_events",
    "mfu_value",
    "read_events",
    "resolve_telemetry",
    "train_health_stats",
    "window_report",
]


@dataclasses.dataclass
class Telemetry:
    """The ``Trainer(telemetry=...)`` knobs, with the JAX package's defaults.

    * ``events_path``: the event log (None: ``<save_folder>/telemetry/events.jsonl``);
    * ``stats``: the on-device health stats in every step's metrics;
    * ``goodput``: the wall-time buckets, carried in checkpoint meta;
    * ``mfu``: per-window MFU; with ``flops_per_step`` None the trainer counts one step's
      FLOPs once, at the end of the first trained epoch (``utils/flops.py``, on the meta
      device, off the hot path);
    * ``flops_per_step``: a FLOP count that skips the probe;
    * ``anomaly``: ``"warn"`` | ``"raise"`` | None | an :class:`AnomalyDetector`;
    * ``memory``: ``live_bytes``/``peak_bytes`` on the window records (absent on the CPU);
    * ``straggler``: per-rank window walls on the window records (absent with one rank);
    * ``heartbeat_every_s``: the liveness pulse's least interval, at the ``log_every``
      syncs and from the ``step_timeout`` watchdog's thread (0: no heartbeats);
    * ``export_port``: rank 0's ``/status`` + ``/metrics`` server (None: none; 0: a free
      port, read back from ``trainer.exporter.port``).
    """

    events_path: "str | None" = None
    stats: bool = True
    goodput: bool = True
    mfu: bool = True
    flops_per_step: "float | None" = None
    anomaly: "AnomalyDetector | str | None" = "warn"
    memory: bool = True
    straggler: bool = True
    heartbeat_every_s: float = 30.0
    export_port: "int | None" = None

    def resolve_anomaly(self) -> "AnomalyDetector | None":
        if self.anomaly is None:
            return None
        if isinstance(self.anomaly, AnomalyDetector):
            return self.anomaly
        return AnomalyDetector(action=str(self.anomaly))


def resolve_telemetry(spec) -> "Telemetry | None":
    """``None``/``False`` off; ``True``/``"on"``/``"1"`` the defaults; a :class:`Telemetry`
    as it is."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return Telemetry()
    if isinstance(spec, str):
        key = spec.lower()
        if key in ("on", "1", "true", "default"):
            return Telemetry()
        if key in ("off", "0", "false", "none"):
            return None
        raise ValueError(f"unknown telemetry spec {spec!r} (use 'on', 'off', or a Telemetry)")
    if isinstance(spec, Telemetry):
        return spec
    raise TypeError(f"telemetry must be None, bool, str, or Telemetry, got {type(spec)}")
