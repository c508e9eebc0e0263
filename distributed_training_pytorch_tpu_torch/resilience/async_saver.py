"""Asynchronous checkpointing: a short snapshot on the hot loop, the commit on a thread.

Counterpart of ``distributed_training_pytorch_tpu/resilience/async_saver.py``. Every save
through ``checkpoint.CheckpointManager`` is durable (staging dir, SHA-256 manifest, atomic
rename) and synchronous: the step loop waits for the whole serialise, hash, fsync and
rename. :class:`AsyncCheckpointSaver` splits a save in two:

1. **Snapshot**, on the calling thread: the state's tensors copied into host memory.
2. **Commit**, on one background thread: the host copy through the manager's save.

**Where the port differs from JAX: the snapshot.** A JAX state is immutable, so
``jax.device_get`` of it is consistent by construction. Here the optimizer writes params
and moments in place, and so does a CUDA graph replay, so the copy must be complete before
the next step writes. On the card every tensor is copied into a fresh pinned host tensor
with ``non_blocking=True`` on the current stream: after the step's writes, which were
issued on that stream, and before the next step's, which will be. An event recorded after
the copies marks the snapshot complete, and the commit thread waits on it before it reads
a byte (a pinned buffer read before its copy lands would be torn, the hazard of F9). Off
the card each tensor is cloned: a copy, never a reference. The snapshot keeps the live
state's sharding record (``TrainState.sharding``) for the checkpoint's meta, as the JAX
saver takes it from the live arrays.

The contract, as in JAX:

* **One committer.** One daemon thread makes every manager call the saver issues.
* **Newest wins per name, FIFO across names.** At most one snapshot is queued per name; a
  newer one of the same name takes the older one's place in the queue (the older was
  never on disk). Distinct names (``best`` then ``last``) queue in order, so commits land
  in save order and ``restore_latest_valid``'s newest-first order is the save order.
* **``flush()`` is a barrier**: it returns when every queued save is committed, and raises
  (or returns) the first background commit error, so a failed save surfaces on the
  training thread; ``save_async`` raises a pending error too.
* **Emergency saves**: :meth:`save_sync` (SIGTERM and watchdog saves) flushes the queue,
  then commits on the calling thread.
* ``commit_delay_s`` is a seam for the chaos soak: the worker sleeps that long in the
  committing state before it touches the filesystem, so a kill can land there.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping

import torch

from distributed_training_pytorch_tpu_torch.checkpoint import BEST

__all__ = ["AsyncCheckpointSaver", "HostSnapshot", "SaveRequest", "measure_save_stall", "snapshot_state"]

SNAPSHOT = "snapshot"
QUEUED = "queued"
COMMITTING = "committing"
COMMITTED = "committed"
SUPERSEDED = "superseded"
FAILED = "failed"


class HostSnapshot:
    """A ``TrainState``'s checkpoint payload with every tensor copied to host memory.
    ``state_dict()`` returns it, so the manager saves it as it saves a state; ``ready`` is
    the CUDA event after the device copies (None off the card), :meth:`wait` waits for
    it."""

    def __init__(self, payload: dict, loss_scale_name: "str | None", ready, sharding: "dict | None" = None):
        self.payload = payload
        self.loss_scale_name = loss_scale_name
        self.ready = ready
        self.sharding = sharding  # the live state's sharding record (JAX async_saver.py:317-343)

    def state_dict(self) -> dict:
        return self.payload

    def wait(self) -> None:
        if self.ready is not None:
            self.ready.synchronize()


def _host_copy(value, copied: list):
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.device.type == "cuda":
            host = torch.empty_like(t, device="cpu", pin_memory=True)
            with torch.cuda.device(t.device):
                host.copy_(t, non_blocking=True)  # on the current stream: after the step's writes
            copied.append(t.device)
            return host
        return t.clone()
    if isinstance(value, dict):
        return type(value)((k, _host_copy(v, copied)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return type(value)(_host_copy(v, copied) for v in value)
    return value


def snapshot_state(state) -> HostSnapshot:
    """``state.state_dict()`` with every tensor copied to the host (see the module
    docstring): pinned and ``non_blocking`` on the current stream on the card, cloned off
    it."""
    copied: list = []
    payload = _host_copy(state.state_dict(), copied)
    ready = None
    if copied:
        ready = torch.cuda.Event()
        with torch.cuda.device(copied[0]):
            ready.record()
    scale = getattr(state, "loss_scale", None)
    name = type(scale).__name__ if "loss_scale" in payload else None
    return HostSnapshot(payload, name, ready, sharding=getattr(state, "sharding", None))


class SaveRequest:
    """One snapshot moving through the states snapshot, queued, committing, committed (or
    superseded, or failed)."""

    __slots__ = ("name", "state", "epoch", "kwargs", "status", "snapshot_s", "commit_s")

    def __init__(self, name: str, state: HostSnapshot, epoch: int, kwargs: dict):
        self.name = name
        self.state = state
        self.epoch = epoch
        self.kwargs = kwargs
        self.status = SNAPSHOT
        self.snapshot_s = 0.0
        self.commit_s = 0.0


def measure_save_stall(manager, state, *, repeats: int = 1) -> dict:
    """The hot loop's stall for one save of ``state``, synchronous against asynchronous;
    best of ``repeats``: ``{"sync_ms", "stall_ms", "commit_ms", "stall_ratio"}``.

    ``sync_ms`` is the wall of ``manager.save`` (names ``stall_sync``/``stall_async``).
    ``stall_ms`` is the async save's snapshot, counted until its device-to-host copies are
    complete (a synchronise on the card): the host returns from ``save_async`` before that,
    but the next step's kernels queue behind the copies on the stream, so the device stalls
    that long. The first async save pays the pinned buffers' allocation; later ones reuse
    the cached buffers of the ones before."""
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    best = {"sync_ms": float("inf"), "stall_ms": float("inf"), "commit_ms": None}
    for _ in range(repeats):
        t0 = time.perf_counter()
        manager.save("stall_sync", state, epoch=0)
        best["sync_ms"] = min(best["sync_ms"], (time.perf_counter() - t0) * 1e3)
    with AsyncCheckpointSaver(manager) as saver:
        for _ in range(repeats):
            t0 = time.perf_counter()
            saver.save_async("stall_async", state, epoch=0)
            if on_card:
                torch.cuda.synchronize()
            stall_s = time.perf_counter() - t0
            saver.flush()
            best["stall_ms"] = min(best["stall_ms"], stall_s * 1e3)
            best["commit_ms"] = saver.last_commit_s * 1e3
    best["stall_ratio"] = best["stall_ms"] / max(best["sync_ms"], 1e-9)
    return best


class AsyncCheckpointSaver:
    """Decouple checkpoint saves from the training hot loop, around a synchronous
    ``CheckpointManager`` (see the module docstring). ``on_commit(name, seconds)`` is
    called on the committer's thread after each background commit (the trainer books it
    to the ``checkpoint_async`` goodput bucket and emits ``checkpoint_commit``); an
    exception in it is swallowed."""

    def __init__(self, manager, on_commit=None):
        self._manager = manager
        self.on_commit = on_commit
        self.commit_delay_s = 0.0
        self._cond = threading.Condition()  # guards every field below
        self._queue: "list[SaveRequest]" = []
        self._current: "SaveRequest | None" = None
        self._error: "BaseException | None" = None
        self._stop = False
        self._thread: "threading.Thread | None" = None
        self.committed = 0
        self.superseded = 0
        self.last_commit_s: "float | None" = None

    def save_async(
        self,
        name: str,
        state: Any,
        epoch: int,
        *,
        metrics: "Mapping | None" = None,
        loop_state: "Mapping | None" = None,
        data_state: "Mapping | None" = None,
        telemetry: "Mapping | None" = None,
    ) -> float:
        """Snapshot ``state`` and queue its commit; returns the snapshot's host wall in
        seconds. A prior background commit's error is raised first."""
        self._raise_pending_error()
        t0 = time.perf_counter()
        snap = snapshot_state(state)
        req = SaveRequest(name, snap, int(epoch), dict(metrics=metrics, loop_state=loop_state,
                                                       data_state=data_state, telemetry=telemetry))
        req.snapshot_s = time.perf_counter() - t0
        with self._cond:
            self._ensure_worker()
            for i, queued in enumerate(self._queue):
                if queued.name == name:  # newest wins, in the older one's place
                    queued.status = SUPERSEDED
                    self.superseded += 1
                    self._queue[i] = req
                    break
            else:
                self._queue.append(req)
            req.status = QUEUED
            self._cond.notify_all()
        return req.snapshot_s

    def save_sync(
        self,
        name: str,
        state: Any,
        epoch: int,
        *,
        metrics: "Mapping | None" = None,
        loop_state: "Mapping | None" = None,
        data_state: "Mapping | None" = None,
        telemetry: "Mapping | None" = None,
    ) -> float:
        """The emergency save: complete (never abandon) the queued saves, then commit
        ``state`` on this thread; returns the wall seconds. A prior background error is
        kept for the next ``flush``/``save_async``, not raised here; this save's own
        failure raises."""
        t0 = time.perf_counter()
        prior_err = self.flush(raise_errors=False)
        try:
            self._manager.save(name, state, epoch, metrics=metrics, loop_state=loop_state, data_state=data_state,
                               telemetry=telemetry)
        finally:
            if prior_err is not None:
                with self._cond:
                    if self._error is None:
                        self._error = prior_err
        return time.perf_counter() - t0

    def maybe_save_best(self, metrics: Mapping, state: Any, epoch: int, *, loop_state: "Mapping | None" = None,
                        telemetry: "Mapping | None" = None) -> "tuple[bool, float]":
        """The manager's best-value rule on this thread, and on an improvement an async
        save of ``best``; ``(saved, snapshot_seconds)``."""
        if not self._manager.best_improved(metrics):
            return False, 0.0
        return True, self.save_async(BEST, state, epoch, metrics=metrics, loop_state=loop_state, telemetry=telemetry)

    def flush(self, raise_errors: bool = True) -> "BaseException | None":
        """Block until every queued save is committed; raise (or return, with
        ``raise_errors=False``) and clear the first background error."""
        with self._cond:
            while self._queue or self._current is not None:
                self._cond.wait(timeout=0.1)
            err, self._error = self._error, None
        if err is not None and raise_errors:
            raise err
        return err

    @property
    def in_flight(self) -> bool:
        with self._cond:
            return bool(self._queue) or self._current is not None

    def close(self) -> None:
        """Flush (errors returned, not raised) and stop the worker."""
        self.flush(raise_errors=False)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "AsyncCheckpointSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _raise_pending_error(self) -> None:
        with self._cond:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _ensure_worker(self) -> None:  # with _cond held
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._worker, name="async-checkpoint-commit", daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait()
                if self._stop and not self._queue:
                    return
                req = self._queue.pop(0)
                req.status = COMMITTING
                self._current = req
            try:
                req.state.wait()  # the device-to-host copies have landed
                if self.commit_delay_s:
                    time.sleep(self.commit_delay_s)  # the chaos seam
                t0 = time.perf_counter()
                self._manager.save(req.name, req.state, req.epoch, **req.kwargs)
                req.commit_s = time.perf_counter() - t0
                with self._cond:
                    req.status = COMMITTED
                    self.committed += 1
                    self.last_commit_s = req.commit_s
                if self.on_commit is not None:
                    try:
                        self.on_commit(req.name, req.commit_s)
                    except Exception:  # noqa: BLE001 — telemetry must never fail a commit
                        pass
            except BaseException as e:  # noqa: BLE001 — surfaced on the training thread
                req.status = FAILED
                with self._cond:
                    if self._error is None:  # the first error is the root cause
                        self._error = e
            finally:
                with self._cond:
                    self._current = None
                    self._cond.notify_all()
                req = None  # the snapshot's host buffers go now, not when the next save comes
