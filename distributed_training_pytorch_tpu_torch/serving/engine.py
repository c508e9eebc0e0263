"""Forward-only inference engine on one card.

Counterpart of ``distributed_training_pytorch_tpu/serving/engine.py::InferEngine``, without
the mesh: the port serves from one device.

* **Per-bucket entries + count.** Requests pad up to a bucket
  (``serving.batcher.pick_bucket``) so a traffic mix meets a handful of
  (bucket, row-signature) entries. ``trace_counts["infer_step"]`` counts the entries
  first seen, the JAX engine's retrace guard: steady-state serving adds none. (PyTorch
  runs eagerly, so an entry holds nothing yet; a captured CUDA graph per entry is the
  later step.)
* **Hot-swap by atomic reference flip.** ``swap_params`` places the new tensors on the
  device, waits for the copies, then installs ``(version, params)`` with one assignment;
  ``predict`` reads the pair once per call, so in-flight batches finish on the params
  they started with.

``params`` is a mapping of parameter names to tensors (or numpy arrays), and ``apply_fn``
runs the forward with them, e.g. ``lambda p, x: torch.func.functional_call(model, p, (x,))``.
Loading params from a checkpoint (``restore_params``) and re-planning onto other devices
(``replan_onto``) come with later slices of the port.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Mapping

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.serving.batcher import pick_bucket

__all__ = ["InferEngine"]


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

    @property
    def params_version(self) -> "str | None":
        cur = self._current
        return cur[0] if cur is not None else None

    def swap_params(self, params: Mapping, *, version: str) -> None:
        """Install ``params`` as the serving set: place them on the device, wait until
        they are resident, then flip the current reference. One engine serves one model:
        a tree of other names, shapes or dtypes raises."""
        placed = {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}
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
