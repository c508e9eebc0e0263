"""Forward-only inference engine on one card.

Counterpart of ``distributed_training_pytorch_tpu/serving/engine.py::InferEngine``, without
the mesh: the port serves from one device.

* **Per-bucket entries + count.** Requests pad up to a bucket
  (``serving.batcher.pick_bucket``) so a traffic mix meets a handful of
  (bucket, row-signature) entries. ``trace_counts["infer_step"]`` counts the entries
  first seen, the JAX engine's retrace guard: steady-state serving adds none. (PyTorch
  runs eagerly, so an entry holds nothing yet; a captured CUDA graph per entry is the
  later step.)
* **Hot-swap by atomic reference flip.** ``swap_params`` copies the new tensors onto the
  device (a snapshot: the caller's buffers stay its own), waits for the copies, then
  installs ``(version, params)`` with one assignment;
  ``predict`` reads the pair once per call, so in-flight batches finish on the params
  they started with.

* **Params from a checkpoint.** ``restore_params`` reads a named checkpoint (``best`` /
  ``last``) or the newest valid one through the port's ``CheckpointManager``
  (``restore(..., params_only=True)`` / ``restore_latest_valid``), which validates the
  manifest first, so a torn commit is never served; then it swaps them in.

``params`` is a mapping of parameter names to tensors (or numpy arrays), and ``apply_fn``
runs the forward with them, e.g. ``lambda p, x: torch.func.functional_call(model, p, (x,))``.
Re-planning onto other devices (``replan_onto``) comes with the elastic slice of the port.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Any, Callable, Mapping

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.serving.batcher import pick_bucket

__all__ = ["InferEngine", "REPLAN_DEFERRED"]

REPLAN_DEFERRED = (
    "re-planning a served model onto another device set comes with the elastic slice of the port "
    "(Queue 1 item 8, P12: parallel/sharding.py and parallel/elastic.py)"
)


def _snapshot(value, device: torch.device) -> torch.Tensor:
    """A copy of ``value`` (a tensor or an array) on ``device`` that shares no memory with it."""
    t = value.detach() if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return t.to(device, copy=True)


def _signature(params: Mapping) -> tuple:
    return tuple(sorted((str(k), tuple(v.shape), str(v.dtype)) for k, v in params.items()))


class InferEngine:
    """Forward-only serving engine (see module doc).

    ``device`` defaults to the card and raises when there is none; pass ``device="cpu"``
    to serve from the CPU.
    """

    def __init__(
        self,
        apply_fn: Callable[[Any, Any], Any],
        *,
        device="cuda",
        buckets: tuple = (1, 2, 4, 8),
    ):
        self.apply_fn = apply_fn
        self.device = resolve_device(device)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.chips = 1
        # Current params: ONE tuple (version, device params), swapped by a single
        # reference assignment, which the GIL makes atomic against the read in predict().
        self._current: "tuple[str, Any] | None" = None
        self._params_signature = None
        self._entries: set = set()  # (bucket, row signature) pairs seen
        self.trace_counts: Counter = Counter()
        self.swap_count = 0
        self.replan_count = 0
        self._swap_lock = threading.Lock()  # one restore-and-flip at a time

    @property
    def params_version(self) -> "str | None":
        cur = self._current
        return cur[0] if cur is not None else None

    def swap_params(self, params: Mapping, *, version: str) -> None:
        """Install ``params`` as the serving set: copy them onto the device, wait until
        the copies are resident, then flip the current reference. One engine serves one model:
        a tree of other names, shapes or dtypes raises."""
        # A snapshot the caller cannot reach: ``torch.as_tensor(v).to(device)`` would be
        # the caller's own buffer for a tensor already on the device (or an array served
        # from the CPU), and a later write to it would change the served version's answers.
        placed = {k: _snapshot(v, self.device) for k, v in params.items()}
        sig = _signature(placed)
        if self._params_signature is None:
            self._params_signature = sig
        elif sig != self._params_signature:
            raise ValueError(
                "this InferEngine is already bound to params with a different structure "
                "or shapes/dtypes (one engine serves one model); build a new engine for "
                "the new model."
            )
        if self.device.type == "cuda":
            # The first request after a swap must not wait on a host-to-device copy.
            torch.cuda.synchronize(self.device)
        self._current = (str(version), placed)
        self.swap_count += 1

    def restore_params(self, manager, target_state, *, name: "str | None" = None) -> str:
        """Load serving params from ``manager`` (the port's ``CheckpointManager``): the named
        checkpoint when given, else the newest valid one. Only the params are restored,
        into ``target_state`` (a ``TrainState`` whose model has the served structure), then
        swapped in: the engine serves its own copy, so the next restore into the same
        target cannot reach it. Returns the installed version ``"<name>@e<epoch>"``."""
        with self._swap_lock:
            if name is None:
                state, epoch, used = manager.restore_latest_valid(target_state, params_only=True)
            else:
                state, epoch = manager.restore(name, target_state, params_only=True)
                used = name
            version = f"{used}@e{epoch}"
            self.swap_params(state.params, version=version)
            return version

    def replan_onto(self, mesh) -> None:
        """Rebind the engine to another device set: not in the port yet, so it raises and
        leaves the engine serving as it was."""
        raise NotImplementedError(REPLAN_DEFERRED)

    def predict(self, inputs: np.ndarray) -> "tuple[np.ndarray, str]":
        """Run the forward on ``inputs`` (``[n, ...]`` host array): pads ``n`` up to the
        covering bucket (repeating the last row, so padded lanes stay numerically tame),
        runs it, slices the pad back off. Returns ``(outputs[:n], params_version)``: the
        version the batch actually ran on."""
        cur = self._current
        if cur is None:
            raise RuntimeError("InferEngine has no params: call swap_params first")
        version, params = cur
        inputs = np.asarray(inputs)
        n = int(inputs.shape[0])
        bucket = pick_bucket(n, self.buckets)
        if bucket != n:
            pad = np.broadcast_to(inputs[-1:], (bucket - n,) + inputs.shape[1:])
            inputs = np.concatenate([inputs, pad], axis=0)
        key = (bucket, inputs.shape[1:], str(inputs.dtype))
        if key not in self._entries:
            self._entries.add(key)
            self.trace_counts["infer_step"] += 1
        batch = torch.tensor(inputs, device=self.device)
        with torch.inference_mode():
            out = self.apply_fn(params, batch)
        return out.cpu().numpy()[:n], version

    def warmup(self, example_row: np.ndarray) -> float:
        """Run every bucket once for one row signature before taking traffic (the
        first request must not pay the kernels' build or first launch). Returns the
        wall seconds spent."""
        t0 = time.perf_counter()
        row = np.asarray(example_row)
        for b in self.buckets:
            self.predict(np.ascontiguousarray(np.broadcast_to(row[None], (b,) + row.shape)))
        return time.perf_counter() - t0
