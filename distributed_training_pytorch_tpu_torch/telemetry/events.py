"""Structured JSONL event log: the run's flight recorder, and its readers.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/events.py``: the same record
layout, field names and :data:`SCHEMA_VERSION`, so the JAX package's readers
(``load_run_events``, the run doctor, the timeline, the run monitor) read a port run
directory as they read their own, and this module's readers read either.
Each record carries ``event``, ``t_wall``, ``t_mono``, ``process``, ``host``, ``pid``,
``chips`` and ``schema``, then the event's own fields, one JSON object per line.

Conventions kept from the JAX package:

* only process 0 writes (other processes get a disabled no-op writer);
* ``t_mono`` is nondecreasing within a process: timestamp and write share one lock;
* the file is appended to, and a torn last line from a hard kill is newline-terminated
  on reopen so records never merge;
* a failed write disables the log with one warning, never raises into the caller.

The process index comes from ``torch.distributed`` (0 when no process group is up), and
``chips`` lists the CUDA device indices this process sees.

The vocabulary the port's trainer writes (``trainer/trainer.py``) is the JAX Trainer's:
``run_start`` (with ``attempt`` and ``provenance``), ``compile`` (a unit that paid the
port's stand-ins for an XLA compile: the first-use ``nvcc`` build of the kernels, a CUDA
graph's warm-up window and capture, each with its ``kind``, and the FLOP probe,
``kind="mfu_probe"``), ``window``, ``epoch_end``, ``heartbeat``, ``checkpoint_save``,
``checkpoint_commit``, ``checkpoint_restore``, ``preemption``, ``hung_step``,
``fault_injection``, ``anomaly``, ``loss_scale_backoff``, ``profile_capture`` and
``run_end``, and on an elastic resume ``elastic_restore`` (a resume across a change of
device count: ``from_mesh``, ``to_mesh``, ``from_devices``, ``to_devices``,
``old_accum_steps``, ``accum_steps``, ``reason``, ``name``, ``replanned``) and, from the
checkpoint manager, ``checkpoint_reshard`` (a restore whose sharding record differs from
the target's: ``name``, ``from_mesh``, ``to_mesh``, ``from_sharded_leaves``,
``to_sharded_leaves``), with the JAX package's fields (JAX ``events.py:21-25``); serving
writes its own (``serving/server.py``).

The ``fault_injection`` kinds include ``slow_chip``: the trainer's degraded-chip seam
(``fault.FaultPlan.slow_chip``) fired at a ``log_every`` sync, with ``epoch``,
``step_in_epoch``, ``device`` (the slowed batch rank's index) and ``delay_ms``.

The fleet controller (``scripts/torch_fleet_controller.py`` over
``telemetry/controller.py``) writes its own log, beside the runs it supervises: one
``controller_action`` record per remediation, with the JAX fields (JAX ``events.py:51-60``):
``run``, ``run_dir``, ``attempt`` and ``status``/``verdict`` of the run acted on,
``action`` (one of ``controller.ACTION_KINDS``: ``restart``, ``restart_excluding``,
``tune``, ``keep``, ``revert``, ``give_up``, ``refuse``, ``offer_chip``), ``reason`` (the
triggering verdict or rule), ``message``, ``params`` (the mechanism's input and what it
did: the knob's ``from``/``to``, the excluded chip and the re-plan, the checkpoints valid
at a restart), ``evidence`` (the verdict or alert rows that justified it) and the budget
state ``restarts_used``/``max_restarts``; and the ``monitor_alert`` records of the
monitors it polls.

Readers: :class:`EventFollower` (incremental, torn-line tolerant: the one parser),
:func:`load_run_events` (the follower run to the end, for post-mortems) and
:func:`read_events` (strict by default, for tests and gates).
"""

from __future__ import annotations

import json
import math
import os
import socket
import threading
import time
from typing import Any, Iterator

__all__ = [
    "EventFollower",
    "EventLog",
    "SCHEMA_VERSION",
    "claim_attempt",
    "load_run_events",
    "peek_attempt",
    "read_events",
    "resolve_events_path",
]

# The JAX package's record-schema version (its history is in that module); the port
# writes the same vocabulary and stamps the same number.
SCHEMA_VERSION = 8


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _local_chips() -> str:
    import torch

    return ",".join(str(i) for i in range(torch.cuda.device_count()))


def _jsonable(value: Any) -> Any:
    """Best-effort scalar coercion: numpy/torch scalars -> python, everything
    non-serializable -> repr (an event must never fail to serialize).

    Non-finite floats become their repr strings ("nan"/"inf"/"-inf"), so the
    line stays strict JSON."""
    if isinstance(value, float):
        return value if math.isfinite(value) else repr(value)
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:
        value = float(value)  # numpy / torch 0-d scalars
    except (TypeError, ValueError):
        return repr(value)
    return value if math.isfinite(value) else repr(value)


class EventLog:
    """``EventLog(path).emit("serve_start", port=8080)``.

    ``path=None`` (or a non-zero process index) constructs a disabled no-op writer.
    """

    def __init__(self, path: "str | None", *, process_index: "int | None" = None):
        self._path = path
        self._file = None
        self._dead = False  # a failed write disables the log permanently
        proc = _process_index() if process_index is None else process_index
        self.process = proc
        self.enabled = path is not None and proc == 0
        self._host = socket.gethostname()
        self._chips: "str | None" = None  # resolved at the first enabled emit
        self._emit_lock = threading.Lock()

    def _open(self):
        if self._file is None:
            os.makedirs(os.path.dirname(os.path.abspath(self._path)), exist_ok=True)
            # Torn-last-line repair: terminate a partial record left by a hard kill
            # before appending, so two records never merge into one line.
            try:
                with open(self._path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    torn = f.read(1) != b"\n"
            except (OSError, ValueError):  # missing or empty file
                torn = False
            self._file = open(self._path, "a", encoding="utf-8")
            if torn:
                self._file.write("\n")
        return self._file

    def emit(self, event: str, **fields) -> "dict | None":
        """Append one event record; returns the record dict (or None when
        disabled). Field values are coerced to JSON-safe scalars."""
        if not self.enabled or self._dead:
            return None
        if self._chips is None:
            self._chips = _local_chips()
        with self._emit_lock:
            record = {
                "event": str(event),
                "t_wall": time.time(),
                "t_mono": time.monotonic(),
                "process": self.process,
                "host": self._host,
                "pid": os.getpid(),
                "chips": self._chips,
                "schema": SCHEMA_VERSION,
            }
            for key, value in fields.items():
                record[str(key)] = _jsonable(value)
            try:
                f = self._open()
                f.write(json.dumps(record) + "\n")
                f.flush()
            except OSError as e:
                self._dead = True
                import warnings

                warnings.warn(f"EventLog disabled — write to {self._path!r} failed: {e}")
                return None
        return record

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None  # a later emit() lazily reopens (append mode)


def resolve_events_path(run_dir: str) -> str:
    """Map a run directory to its event-log path (``<run_dir>/telemetry/events.jsonl``),
    or pass a direct ``.jsonl``/existing-file path through."""
    if run_dir.endswith(".jsonl") or os.path.isfile(run_dir):
        return run_dir
    return os.path.join(run_dir, "telemetry", "events.jsonl")


def _attempt_path(run_dir: str) -> str:
    return os.path.join(run_dir, "telemetry", "attempt")


def peek_attempt(run_dir: str) -> int:
    """The last attempt id claimed for ``run_dir`` (0 when none yet)."""
    try:
        with open(_attempt_path(run_dir), encoding="utf-8") as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def claim_attempt(run_dir: str) -> int:
    """Claim the next monotonic attempt id for ``run_dir`` (1, 2, 3, ...). The write is
    tmp + ``os.replace``, so a crash mid-claim never leaves a torn counter."""
    sidecar = _attempt_path(run_dir)
    os.makedirs(os.path.dirname(sidecar), exist_ok=True)
    attempt = peek_attempt(run_dir) + 1
    tmp = sidecar + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(f"{attempt}\n")
    os.replace(tmp, sidecar)
    return attempt


def _parse_tolerant(raw: "bytes | str", lineno: int, path: str) -> "dict | None":
    """One event-log line, the tolerant way: a blank line is skipped silently, malformed
    JSON (a torn fragment from a hard kill) and a non-object line with a warning naming the
    file line; only dict records come back."""
    import warnings

    if isinstance(raw, bytes):
        try:
            raw = raw.decode("utf-8")
        except UnicodeDecodeError as e:
            warnings.warn(f"{path}:{lineno}: skipping undecodable event line: {e}")
            return None
    line = raw.strip()
    if not line:
        return None
    try:
        record = json.loads(line)
    except json.JSONDecodeError as e:
        warnings.warn(f"{path}:{lineno}: skipping malformed event line: {e}")
        return None
    if not isinstance(record, dict):
        warnings.warn(f"{path}:{lineno}: skipping non-object event line ({type(record).__name__})")
        return None
    return record


class EventFollower:
    """Incremental, torn-line tolerant reader over one events.jsonl file.

    Each :meth:`poll` returns the records whose lines became complete (newline-terminated)
    since the last poll, each stamped with ``_line`` (the 1-based file line; blank and
    malformed lines still advance it). A trailing fragment without a newline is withheld:
    a live writer may still be writing it. ``poll(final=True)`` also parses that tail
    without consuming it, and remembers it so that its newline's later arrival does not
    yield it twice. A file that does not exist yet yields ``[]``; a file that shrank
    resets the cursor (``generation`` counts the resets)."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._lineno = 0
        self._partial = b""
        self._tail_emitted: "bytes | None" = None
        self.generation = 0

    def poll(self, *, final: bool = False) -> "list[dict]":
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._offset:
            self._offset = self._lineno = 0
            self._partial = b""
            self._tail_emitted = None
            self.generation += 1
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return []
        self._offset += len(data)
        chunks = (self._partial + data).split(b"\n")
        self._partial = chunks.pop()
        records = []
        for raw in chunks:
            self._lineno += 1
            if self._tail_emitted is not None:
                already, self._tail_emitted = raw == self._tail_emitted, None
                if already:
                    continue
            rec = _parse_tolerant(raw, self._lineno, self.path)
            if rec is not None:
                rec["_line"] = self._lineno
                records.append(rec)
        if final and self._partial.strip() and self._partial != self._tail_emitted:
            rec = _parse_tolerant(self._partial, self._lineno + 1, self.path)
            if rec is not None:
                rec["_line"] = self._lineno + 1
                records.append(rec)
                self._tail_emitted = self._partial
        return records


def load_run_events(run_dir: str) -> "list[dict]":
    """A run directory's (or a ``.jsonl`` path's) records, each with ``_line``, through
    one final poll of :class:`EventFollower`; raises ``FileNotFoundError`` without a log."""
    path = resolve_events_path(run_dir)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no event log at {path} — was the run telemetry-off? "
            "(Trainer(telemetry='on') writes <save_folder>/telemetry/events.jsonl)"
        )
    return EventFollower(path).poll(final=True)


def read_events(path: str, *, strict: bool = True, with_lineno: bool = False) -> Iterator:
    """Parse an event log back into dicts. ``strict`` raises ``ValueError`` naming the
    line on malformed JSON; ``strict=False`` skips it with a warning. ``with_lineno``
    yields ``(lineno, record)`` with the 1-based file line."""
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            if not strict:
                record = _parse_tolerant(line, lineno, path)
                if record is not None:
                    yield (lineno, record) if with_lineno else record
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: malformed event line: {e}") from e
            yield (lineno, record) if with_lineno else record
