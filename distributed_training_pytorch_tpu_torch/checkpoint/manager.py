"""Named-checkpoint store with best / last / periodic policies and resume.

Counterpart of the core of ``distributed_training_pytorch_tpu/checkpoint/manager.py::
CheckpointManager``, on ``torch.save`` instead of Orbax:

* three named policies: ``best`` (on a validation-metric improvement by a
  ``(metric, "geq"|"leq")`` rule), ``last``, and ``checkpoint_epoch_N``
  (:func:`epoch_checkpoint_name`), the periodic saves, of which ``max_to_keep`` are kept;
* a checkpoint is a directory: ``state.pt`` (params, optimizer state, step, and a dynamic
  loss scale's tensors when the state has one, as the JAX manager's ``scale`` item,
  ``checkpoint/manager.py:317-330``: a resume carries on with the same scale and counter), ``meta.json``
  (resume epoch, best value, metrics) and ``manifest.dtp.json`` (size and SHA-256 of every
  other file);
* atomic commits: every save is written under ``.staging/<name>.<n>`` and renamed onto
  ``<name>`` only when complete (an existing ``<name>`` is first moved to ``<name>.old``,
  removed after the swap); leftovers of a crash are repaired when a manager opens the
  directory;
* ``restore`` validates the manifest first, and ``restore_latest_valid`` walks the
  committed checkpoints newest first and restores the first that validates;
  ``restore(..., params_only=True)`` loads the model's weights and buffers only and keeps
  the target's optimizer and step (offline evaluation, whose optimizer is not the run's);
* ``meta.json`` records ``params_top_level``, the sorted first names of the saved weights:
  ``["inner"]`` for a model wrapped in ``InputNormalizer``, as the JAX manager records its
  param tree's top level (``checkpoint/manager.py:271``), so an evaluator can rebuild
  the wrapper the run trained.

* a transient write failure (an ``OSError``, the ``checkpoint_write`` fault of
  ``fault.FaultPlan`` included) is retried ``save_retries`` times with exponential backoff
  from ``retry_backoff`` seconds before the save raises :class:`CheckpointError`
  (``checkpoint/manager.py:100-124``, ``:345-380``); a plan's ``corrupt_checkpoint`` event
  damages the checkpoint just committed (``:435-442``);
* ``loop_state`` (a mid-epoch save's ``step_in_epoch``) rides in ``meta.json`` under
  ``loop``, and ``data_state`` in ``data.json``; :meth:`read_meta` and
  :meth:`read_data_state` read them back (``:849-880``). A checkpoint without
  ``data.json`` has no data state (None).

* **Sharded state** (JAX ``checkpoint/manager.py:215-295``, ``:555-670``, ``:725-752``): a
  state laid out over an ``fsdp`` or ``tensor`` axis is saved as global tensors (its
  ``state_dict`` gathers the shards) with its sharding record in ``meta.json`` under
  ``sharding`` (``parallel.sharding.sharding_record``; none for a replicated state). A
  restore first checks the record's device count against this world and raises
  ``parallel.elastic.TopologyMismatchError`` naming both topologies unless
  ``allow_topology_change=True``; the global tensors are then cut into the target's
  layout, whatever the writer's, and a restore whose record differs from the target's
  emits ``checkpoint_reshard`` on ``event_log`` (an ``EventLog``, or None).

Saves here are synchronous: each is committed when ``save`` returns. The trainer's
background saver (``resilience/async_saver.py``) commits through this manager from its
worker thread. ``save`` also takes that saver's host snapshot in place of a ``TrainState``
(anything with ``state_dict()``). Only rank 0 writes; with a process group, every rank
waits at a barrier until the commit is done.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Mapping

import torch
import torch.distributed as dist

from distributed_training_pytorch_tpu_torch.parallel.mesh import process_count, process_index
from distributed_training_pytorch_tpu_torch.train.state import unwrap

__all__ = [
    "BEST",
    "LAST",
    "MANIFEST_NAME",
    "CheckpointError",
    "CheckpointManager",
    "CorruptCheckpointError",
    "epoch_checkpoint_name",
]

BEST = "best"
LAST = "last"
MANIFEST_NAME = "manifest.dtp.json"
STATE_NAME = "state.pt"
META_NAME = "meta.json"
DATA_NAME = "data.json"
_STAGING_DIR = ".staging"
_OLD_SUFFIX = ".old"
_PERIODIC_PREFIX = "checkpoint_epoch_"


class CheckpointError(RuntimeError):
    """No checkpoint could be saved (every retry exhausted) or restored."""


class CorruptCheckpointError(CheckpointError):
    """A checkpoint on disk fails integrity validation."""


def epoch_checkpoint_name(epoch: int) -> str:
    """``checkpoint_epoch_{N}``: the periodic-save name."""
    return f"{_PERIODIC_PREFIX}{epoch}"


def _model_device(model) -> torch.device:
    first = next(unwrap(model).parameters(), None)
    return torch.device("cpu") if first is None else first.device


def _barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _fsync_write_json(path: str, payload: Mapping) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Save and restore named checkpoints of a ``TrainState`` under ``directory``.

    ``save_best_for=(metric, mode)``: ``geq`` saves ``best`` when the new value is >= the
    best seen, ``leq`` when <=. ``max_to_keep`` bounds the periodic checkpoints only.
    ``save_retries``/``retry_backoff`` bound the recovery from transient write failures;
    ``fault_plan`` (a ``fault.FaultPlan``, for tests; None in production) is queried at the
    write and at the commit."""

    def __init__(
        self,
        directory: "str | os.PathLike",
        *,
        save_best_for: "tuple[str, str] | None" = None,
        max_to_keep: "int | None" = None,
        save_retries: int = 2,
        retry_backoff: float = 0.25,
        fault_plan=None,
        event_log=None,
    ):
        self.directory = os.path.abspath(os.fspath(directory))
        if save_best_for is not None and save_best_for[1] not in ("geq", "leq"):
            raise ValueError(f"save_best_for mode must be 'geq' or 'leq', got {save_best_for[1]!r}")
        self.save_best_for = save_best_for
        self.max_to_keep = max_to_keep
        self.save_retries = int(save_retries)
        self.retry_backoff = float(retry_backoff)
        self.fault_plan = fault_plan
        self.event_log = event_log
        self._best_value: "float | None" = None
        self._staging_seq = 0
        if process_index() == 0:
            os.makedirs(self.directory, exist_ok=True)
            self._recover_crash_leftovers()
        _barrier()

    # -- names ------------------------------------------------------------

    def path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def exists(self, name: str) -> bool:
        """Whether ``name`` is committed: a save is visible under its name only once its
        staging directory has been renamed onto it."""
        return os.path.isdir(self.path(name))

    def checkpoint_names(self) -> "list[str]":
        """Committed checkpoint names, newest first (by directory mtime)."""
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        found = [
            (os.path.getmtime(self.path(e)), e)
            for e in entries
            if not e.startswith(".") and not e.endswith(_OLD_SUFFIX) and os.path.isdir(self.path(e))
        ]
        return [name for _, name in sorted(found, reverse=True)]

    def _recover_crash_leftovers(self) -> None:
        """Finish a half-done swap (``<name>.old`` left behind) and drop staging dirs of
        saves that never committed (a staging dir holds a whole write only once its
        manifest is in it; one that has it is promoted)."""
        for entry in os.listdir(self.directory):
            if not entry.endswith(_OLD_SUFFIX) or not os.path.isdir(self.path(entry)):
                continue
            final = self.path(entry[: -len(_OLD_SUFFIX)])
            if os.path.isdir(final):
                shutil.rmtree(self.path(entry), ignore_errors=True)
            else:
                os.rename(self.path(entry), final)
        staging_root = os.path.join(self.directory, _STAGING_DIR)
        if os.path.isdir(staging_root):
            for entry in sorted(os.listdir(staging_root)):
                path = os.path.join(staging_root, entry)
                final = self.path(entry.rsplit(".", 1)[0])
                if os.path.isfile(os.path.join(path, MANIFEST_NAME)) and not os.path.isdir(final):
                    os.rename(path, final)
            shutil.rmtree(staging_root, ignore_errors=True)

    # -- save -------------------------------------------------------------

    def save(
        self,
        name: str,
        state,
        epoch: int,
        metrics: "Mapping | None" = None,
        *,
        loop_state: "Mapping | None" = None,
        data_state: "Mapping | None" = None,
        telemetry: "Mapping | None" = None,
        sharding: "Mapping | None" = None,
    ) -> None:
        """Save ``state`` (a ``TrainState``, or the async saver's host snapshot) under
        ``name`` with the *resume* epoch ``epoch`` (the caller's policy: ``epoch + 1`` for
        ``last``, ``epoch`` for ``best``). ``loop_state`` (``{"step_in_epoch": k}`` for a
        mid-epoch save) goes into ``meta.json`` under ``loop``; ``data_state`` into
        ``data.json``; ``telemetry`` (the trainer's cumulative goodput counters and the
        attempt id) into ``meta.json`` under ``telemetry``, the attempt also as
        ``meta["attempt"]``, as the JAX manager writes it; ``sharding`` the state's sharding
        record (None: the state's own, ``state.sharding``, which the async saver's snapshot
        took from the live state). A write that raises ``OSError`` is retried ``save_retries`` times,
        ``retry_backoff`` seconds apart and doubling; then :class:`CheckpointError`."""
        payload = state.state_dict()  # every rank takes part (the shards of a sharded state are gathered)
        if sharding is None:
            sharding = getattr(state, "sharding", None)
        failed = None
        if process_index() == 0:
            meta = {"epoch": int(epoch), "step": int(payload["step"]), "best_value": self._best_value,
                    "params_top_level": sorted({k.split(".", 1)[0] for k in payload["params"]})}
            if metrics is not None:
                meta["metrics"] = {k: float(v) for k, v in metrics.items()}
            if loop_state is not None:
                meta["loop"] = {k: int(v) for k, v in loop_state.items()}
            if telemetry is not None:
                meta["telemetry"] = dict(telemetry)
                if "attempt" in meta["telemetry"]:
                    meta["attempt"] = int(meta["telemetry"].pop("attempt"))
            if sharding is not None:
                meta["sharding"] = dict(sharding)
            if "loss_scale" in payload:  # the JAX manager's meta names the scale's type (:330)
                meta["loss_scale"] = getattr(state, "loss_scale_name", None) or type(state.loss_scale).__name__
            failed = self._write_with_retries(name, payload, meta, data_state)
        _barrier()
        if failed is not None:
            raise CheckpointError(
                f"checkpoint save of {name!r} failed after {self.save_retries + 1} attempts"
            ) from failed

    def _write_with_retries(self, name, payload, meta, data_state) -> "BaseException | None":
        """Write, manifest and commit ``name``; on an ``OSError`` drop the staging dir and
        try again after the backoff. Returns the last error when every attempt failed."""
        err: "BaseException | None" = None
        delay = self.retry_backoff
        for attempt in range(self.save_retries + 1):
            if attempt:
                time.sleep(delay)
                delay *= 2
            self._staging_seq += 1
            staging = os.path.join(self.directory, _STAGING_DIR, f"{name}.{self._staging_seq}")
            try:
                if self.fault_plan is not None:
                    self.fault_plan.maybe_raise("checkpoint_write")
                os.makedirs(staging)
                torch.save(payload, os.path.join(staging, STATE_NAME))
                _fsync_write_json(os.path.join(staging, META_NAME), meta)
                if data_state:
                    _fsync_write_json(os.path.join(staging, DATA_NAME), dict(data_state))
                self._write_manifest(staging)
            except OSError as e:
                shutil.rmtree(staging, ignore_errors=True)
                err = e
                continue
            self._commit(staging, name)
            self._gc_periodic()
            return None
        return err

    def _write_manifest(self, staging: str) -> None:
        files = {
            f: {"size": os.path.getsize(os.path.join(staging, f)), "sha256": _sha256(os.path.join(staging, f))}
            for f in sorted(os.listdir(staging))
        }
        _fsync_write_json(os.path.join(staging, MANIFEST_NAME), {"version": 1, "files": files})

    def _commit(self, staging: str, name: str) -> None:
        """The final name flips from the old checkpoint (or none) to the new one in one
        rename."""
        final = self.path(name)
        old = final + _OLD_SUFFIX
        if os.path.isdir(final):
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.rename(final, old)
        os.rename(staging, final)
        dirfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        shutil.rmtree(old, ignore_errors=True)
        if self.fault_plan is not None:
            ev = self.fault_plan.fires("corrupt_checkpoint")
            if ev is not None:
                from distributed_training_pytorch_tpu_torch.fault.inject import corrupt_checkpoint

                corrupt_checkpoint(final, mode=ev.payload or "truncate")

    def _gc_periodic(self) -> None:
        if self.max_to_keep is None:
            return
        periodic = [n for n in self.checkpoint_names() if n.startswith(_PERIODIC_PREFIX)]
        for name in periodic[self.max_to_keep :]:
            shutil.rmtree(self.path(name), ignore_errors=True)

    def best_improved(self, metrics: Mapping) -> bool:
        """Apply the best-fitness rule and record a new best value, without saving."""
        if self.save_best_for is None:
            return False
        metric, mode = self.save_best_for
        if metric not in metrics:
            raise KeyError(f"save_best_for metric {metric!r} not in validation metrics {list(metrics)}")
        value = float(metrics[metric])
        improved = (
            self._best_value is None
            or (mode == "geq" and value >= self._best_value)
            or (mode == "leq" and value <= self._best_value)
        )
        if improved:
            self._best_value = value
        return improved

    def maybe_save_best(self, metrics: Mapping, state, epoch: int) -> bool:
        """Save ``best`` when ``metrics`` improve on the best seen; returns whether it did."""
        if not self.best_improved(metrics):
            return False
        self.save(BEST, state, epoch, metrics=metrics)
        return True

    @property
    def best_value(self) -> "float | None":
        return self._best_value

    # -- validate / restore -----------------------------------------------

    def _resolve(self, name_or_path: str) -> str:
        path = self.path(name_or_path) if os.sep not in name_or_path else name_or_path
        path = os.path.abspath(path)
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return path

    def validate(self, name_or_path: str) -> None:
        """Check every file against the manifest; raises :class:`CorruptCheckpointError`
        on a missing manifest or file, a size mismatch or a hash mismatch."""
        path = self._resolve(name_or_path)
        manifest_path = os.path.join(path, MANIFEST_NAME)
        try:
            with open(manifest_path, encoding="utf-8") as f:
                manifest = json.load(f)
        except FileNotFoundError as e:
            raise CorruptCheckpointError(f"{path}: no integrity manifest ({MANIFEST_NAME})") from e
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptCheckpointError(f"{path}: unreadable manifest: {e}") from e
        for rel, want in manifest.get("files", {}).items():
            fp = os.path.join(path, rel)
            if not os.path.isfile(fp):
                raise CorruptCheckpointError(f"{path}: missing file {rel}")
            if os.path.getsize(fp) != want["size"]:
                raise CorruptCheckpointError(f"{path}: {rel} size differs from the manifest (torn write)")
            if _sha256(fp) != want["sha256"]:
                raise CorruptCheckpointError(f"{path}: {rel} content hash mismatch")

    def is_valid(self, name_or_path: str) -> bool:
        try:
            self.validate(name_or_path)
            return True
        except (CorruptCheckpointError, FileNotFoundError):
            return False

    def read_meta(self, name_or_path: str) -> dict:
        """The checkpoint's ``meta.json`` alone (epoch, step, best value, metrics,
        ``params_top_level``, the ``loop`` state), read before any restore target exists."""
        with open(os.path.join(self._resolve(name_or_path), META_NAME), encoding="utf-8") as f:
            return json.load(f)

    def read_data_state(self, name_or_path: str) -> "dict | None":
        """The checkpoint's data state (``data.json``), or None when it has none: a missing
        item means a fresh cursor."""
        path = os.path.join(self._resolve(name_or_path), DATA_NAME)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            return dict(json.load(f))

    def restore(
        self, name_or_path: str, state, *, params_only: bool = False, validate: bool = True,
        allow_topology_change: bool = False,
    ) -> "tuple[Any, int]":
        """Load a checkpoint into ``state`` (its model and optimizer, in place) and return
        ``(state, resume_epoch)``. The best value seen so far comes back with it.
        ``params_only=True`` loads the model's weights and buffers alone, keeping the
        target's optimizer state and step. A checkpoint whose sharding record covers
        another device count than this world's ranks raises ``TopologyMismatchError``
        before anything is read, unless ``allow_topology_change``."""
        path = self._resolve(name_or_path)
        if validate:
            self.validate(path)
        meta = self.read_meta(path)
        record = meta.get("sharding")
        if record and not allow_topology_change:
            from distributed_training_pytorch_tpu_torch.parallel.elastic import validate_topology

            validate_topology(record, process_count(), name=f"checkpoint {os.path.basename(path)!r}")
        self._note_reshard(path, meta, state)
        device = _model_device(state.model)
        payload = torch.load(os.path.join(path, STATE_NAME), map_location=device, weights_only=True)
        if params_only:
            state.load_params(payload["params"])
        else:
            state.load_state_dict(payload)
        if meta.get("best_value") is not None:
            self._best_value = float(meta["best_value"])
        return state, int(meta.get("epoch", 0))

    def _note_reshard(self, path: str, meta: Mapping, state) -> None:
        """A restore whose recorded layout differs from the target's (a missing record is
        a replicated state) emits ``checkpoint_reshard``, with the JAX manager's fields."""
        if self.event_log is None:
            return
        stored = meta.get("sharding")
        target = getattr(state, "sharding", None)
        if stored == target:
            return
        self.event_log.emit(
            "checkpoint_reshard",
            name=os.path.basename(str(path)),
            from_mesh=(stored or {}).get("mesh"),
            to_mesh=(target or {}).get("mesh"),
            from_sharded_leaves=len((stored or {}).get("specs", {})),
            to_sharded_leaves=len((target or {}).get("specs", {})),
        )

    def latest_valid_name(self) -> "str | None":
        """The newest committed checkpoint that passes validation, or None."""
        for name in self.checkpoint_names():
            if self.is_valid(name):
                return name
        return None

    def restore_latest_valid(
        self, state, *, params_only: bool = False, allow_topology_change: bool = False
    ) -> "tuple[Any, int, str]":
        """Restore the newest checkpoint that validates (a torn ``last`` falls back to the
        one before it); ``(state, epoch, name)``. ``params_only`` and
        ``allow_topology_change`` as in :meth:`restore`."""
        name = self.latest_valid_name()
        if name is None:
            raise CheckpointError(f"no valid checkpoint under {self.directory}")
        state, epoch = self.restore(name, state, params_only=params_only, validate=False,
                                    allow_topology_change=allow_topology_change)
        return state, epoch, name
