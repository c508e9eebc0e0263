"""Deterministic fault injection: recovery paths as test targets.

Counterpart of ``distributed_training_pytorch_tpu/fault/inject.py``, kept as its own copy
(the port imports nothing of the JAX package). A :class:`FaultPlan` is a schedule of
:class:`FaultEvent`\\ s, each naming an injection point (``kind``), optional match criteria
(epoch, step) and a firing budget (``count``). A component that owns a recovery path asks
the plan at its injection point and acts only when an event matches; with no plan (the
production default) every query is a ``None`` check.

Injection points:

* ``"sigterm"``: ``Trainer.train_epoch`` sends the process a real SIGTERM at (epoch, step),
  which runs the preemption handler, the collective flag and the resumable mid-epoch save;
* ``"nan_loss"``: ``Trainer.train_epoch`` fills the batch's floating tensors with NaN before
  the step (the engine's non-finite guard and the trainer's ``nan_policy``);
* ``"hang"``: ``Trainer.train_epoch`` sleeps ``payload`` seconds at the step (the
  :class:`~.watchdog.StepWatchdog`'s hung-step path);
* ``"checkpoint_write"``: ``CheckpointManager`` raises :class:`InjectedFault` (an
  ``OSError``) when a save starts (the bounded retry with backoff); ``count=N`` fails the
  first N attempts;
* ``"corrupt_checkpoint"``: ``CheckpointManager`` damages the checkpoint it has just
  committed (:func:`corrupt_checkpoint`; integrity validation and the newest-valid
  fallback);
* ``"corrupt_record"``: :class:`CorruptingSource` raises ``data.records.CorruptRecordError``
  for matching record indices (the loader's skip-and-count);
* ``"slow_chip"``: :meth:`FaultPlan.slow_chip`, a query at a sync point, not a step kind
  (it must not send chained windows to single steps). The trainer asks it at each
  ``log_every`` sync with telemetry's straggler fields on and more than one batch rank:
  the rank named by ``payload["device"]`` (a batch rank's index, ``mesh.batch_index``,
  since a port rank drives one device) sleeps ``payload["delay_ms"]`` before it stamps
  its arrival, so the straggler fields name it; timing only, the numbers are untouched.

Events match on exact (epoch, step) when given, fire at most ``count`` times, and the plan
records every firing in ``fired``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any

__all__ = ["CorruptingSource", "FaultEvent", "FaultPlan", "InjectedFault", "corrupt_checkpoint"]

MANIFEST_NAME = "manifest.dtp.json"


class InjectedFault(OSError):
    """A simulated transient I/O failure (retryable, like ENOSPC or a blip on a network
    filesystem)."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled failure. ``epoch``/``step`` of ``None`` match anything; ``count`` is
    the firing budget left."""

    kind: str
    epoch: "int | None" = None
    step: "int | None" = None
    count: int = 1
    payload: Any = None


class FaultPlan:
    """A deterministic schedule of failures, queried at injection points. Build it with
    :meth:`add`, which chains::

        plan = FaultPlan().add("sigterm", epoch=0, step=3).add("checkpoint_write", count=2)
    """

    # The kinds Trainer.train_epoch asks about at each step.
    STEP_KINDS = ("sigterm", "hang", "nan_loss")

    def __init__(self, events: "tuple[FaultEvent, ...] | list | None" = None):
        self.events: "list[FaultEvent]" = list(events or [])
        self.fired: "list[tuple[str, dict]]" = []

    def add(self, kind: str, *, epoch: "int | None" = None, step: "int | None" = None, count: int = 1,
            payload: Any = None) -> "FaultPlan":
        self.events.append(FaultEvent(kind, epoch=epoch, step=step, count=count, payload=payload))
        return self

    def fires(self, kind: str, *, epoch: "int | None" = None, step: "int | None" = None) -> "FaultEvent | None":
        """Consume and return the first matching event with budget left, else ``None``. A
        criterion set on the event must equal the queried value; unset criteria match
        anything."""
        for ev in self.events:
            if ev.kind != kind or ev.count <= 0:
                continue
            if ev.epoch is not None and ev.epoch != epoch:
                continue
            if ev.step is not None and ev.step != step:
                continue
            ev.count -= 1
            self.fired.append((kind, {"epoch": epoch, "step": step}))
            return ev
        return None

    def count_fired(self, kind: str) -> int:
        return sum(1 for k, _ in self.fired if k == kind)

    def active_in_window(self, epoch: int, start: int, stop: int) -> bool:
        """Whether a step-loop event with budget left could fire at a step in
        ``[start, stop)`` of ``epoch``. It consumes nothing: the trainer asks it before a
        chained window, which then runs as single steps so that the per-step injection
        points run (a captured window has no per-step host hook)."""
        for ev in self.events:
            if ev.kind not in self.STEP_KINDS or ev.count <= 0:
                continue
            if ev.epoch is not None and ev.epoch != epoch:
                continue
            if ev.step is None or start <= ev.step < stop:
                return True
        return False

    def maybe_raise(self, kind: str, **ctx) -> None:
        """Raise :class:`InjectedFault` when an event matches (the checkpoint write)."""
        ev = self.fires(kind, **ctx)
        if ev is not None:
            raise InjectedFault(
                f"injected {kind} fault" + (f" (payload={ev.payload!r})" if ev.payload is not None else "")
            )

    def slow_chip(self, device_ids, *, epoch: "int | None" = None) -> "tuple[int, float] | None":
        """``(device_id, delay_s)`` for the first matching ``slow_chip`` event whose named
        device is among ``device_ids``, else ``None``. Membership is checked before the
        budget is consumed: a plan naming a device that is not there stays inert."""
        ids = {int(d) for d in device_ids}
        for ev in self.events:
            if ev.kind != "slow_chip" or ev.count <= 0:
                continue
            if ev.epoch is not None and ev.epoch != epoch:
                continue
            payload = ev.payload if isinstance(ev.payload, dict) else {}
            dev = int(payload.get("device", -1))
            if dev not in ids:
                continue
            ev.count -= 1
            self.fired.append(("slow_chip", {"epoch": epoch, "device": dev}))
            return dev, float(payload.get("delay_ms", 0.0)) / 1e3
        return None

    def maybe_sigterm(self, *, epoch: int, step: int) -> bool:
        """Send this process a real SIGTERM when scheduled, the signal a cloud scheduler
        sends ahead of eviction."""
        if self.fires("sigterm", epoch=epoch, step=step) is None:
            return False
        os.kill(os.getpid(), signal.SIGTERM)
        return True


def corrupt_checkpoint(path: str, *, mode: str = "truncate") -> str:
    """Damage a committed checkpoint directory in place; returns the file hit, the largest
    one that is not the manifest. ``"truncate"`` halves it (a torn write), ``"flip"``
    inverts one byte in its middle (silent corruption), ``"delete"`` removes it."""
    if mode not in ("truncate", "flip", "delete"):
        raise ValueError(f"mode must be truncate|flip|delete, got {mode!r}")
    victim, size = None, -1
    for dirpath, _, files in os.walk(path):
        for f in files:
            if f == MANIFEST_NAME:
                continue  # the payload is what a torn write damages
            fp = os.path.join(dirpath, f)
            s = os.path.getsize(fp)
            if s > size:
                victim, size = fp, s
    if victim is None:
        raise FileNotFoundError(f"no files to corrupt under {path}")
    if mode == "truncate":
        with open(victim, "rb+") as f:
            f.truncate(max(0, size // 2))
    elif mode == "flip":
        with open(victim, "rb+") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
    else:
        os.remove(victim)
    return victim


class CorruptingSource:
    """A data source whose scheduled records read as corrupt: the plan's ``step``
    criterion is the record index, and the error is ``data.records.CorruptRecordError``,
    what a damaged record raises, so the loader's skip-and-count sees the real type."""

    def __init__(self, source, plan: FaultPlan):
        self.source = source
        self.plan = plan
        self.transform = getattr(source, "transform", None)

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, index: int):
        from distributed_training_pytorch_tpu_torch.data.records import CorruptRecordError

        if self.plan.fires("corrupt_record", step=int(index)) is not None:
            raise CorruptRecordError(f"injected corrupt record at index {int(index)}")
        return self.source[index]
