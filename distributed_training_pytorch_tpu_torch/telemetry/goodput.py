"""Goodput accounting: wall time partitioned into named buckets.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/goodput.py``, with the same
:data:`BUCKETS` and the same meter. The time between consecutive :meth:`GoodputMeter.tick`
calls goes to exactly one bucket, so the fractions always sum to 1:

* ``productive_step``: executing train steps (a CUDA graph replay included);
* ``compile``: the port has no XLA compile; what stands in for one goes here: the
  first-use ``nvcc`` build of the kernels (``ops/_build.py``), a CUDA graph's warm-up
  window and capture (``train/engine.py``), and the FLOP probe (``telemetry/mfu.py``);
* ``data_wait``: the loop blocked on the input pipeline;
* ``checkpoint``: save time the loop waited on (under background saves, the snapshot);
* ``checkpoint_async``: the background commits' wall, booked from the saver's thread
  with :meth:`GoodputMeter.account` (overlapped with training, so extra accounted time);
* ``restart_rollback``: resume overhead (the restore, the loader's skip past the trained
  batches of a mid-epoch resume);
* ``other``: everything else (validation, logging, epoch glue).

The counters are cumulative across restarts: the trainer puts :meth:`to_state` in every
checkpoint's meta and seeds a resumed run's meter from it; JSON round-trips Python
floats exactly, so the restored counters are bit-identical to the saved ones.
"""

from __future__ import annotations

import time

__all__ = ["BUCKETS", "GoodputMeter"]

# Canonical bucket names, in reporting order. The meter accepts only these —
# a typo'd bucket must fail loudly, not silently open a seventh bucket that
# drains the fractions the smoke gate checks.
BUCKETS = (
    "productive_step",
    "compile",
    "data_wait",
    "checkpoint",
    "checkpoint_async",
    "restart_rollback",
    "other",
)


class GoodputMeter:
    """Tick-based wall-time partitioner.

    ``tick(bucket)`` attributes the time since the previous tick to
    ``bucket`` and restarts the clock; the first tick (or the first after
    :meth:`stop`) only starts the clock. ``account(bucket, seconds)`` adds
    an externally measured duration (e.g. a checkpoint restore timed before
    the loop starts).
    """

    def __init__(self, state: dict | None = None):
        self.buckets: dict[str, float] = {b: 0.0 for b in BUCKETS}
        if state:
            self.load_state(state)
        self._last: float | None = None

    # -- time attribution --------------------------------------------------

    def tick(self, bucket: str) -> float:
        """Attribute elapsed-since-last-tick to ``bucket``; returns the
        seconds attributed (0.0 on the starting tick)."""
        if bucket not in self.buckets:
            raise KeyError(f"unknown goodput bucket {bucket!r} (one of {BUCKETS})")
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        self.buckets[bucket] += dt
        return dt

    def account(self, bucket: str, seconds: float) -> None:
        """Add an externally measured duration without touching the clock.

        Safe to call from a non-main thread for a bucket the main thread's
        ``tick`` stream never writes (the async-commit worker books
        ``checkpoint_async`` this way): distinct dict keys, so the += races
        nothing."""
        if bucket not in self.buckets:
            raise KeyError(f"unknown goodput bucket {bucket!r} (one of {BUCKETS})")
        self.buckets[bucket] += float(seconds)

    def start(self) -> None:
        """Start (or restart) the clock without attributing anything."""
        self._last = time.perf_counter()

    def stop(self, bucket: str = "other") -> None:
        """Close the open interval into ``bucket`` and stop the clock; the
        next tick starts a fresh interval (a re-entered ``train()`` does not
        absorb the idle gap between runs)."""
        if self._last is not None:
            self.tick(bucket)
        self._last = None

    # -- reporting ---------------------------------------------------------

    def total(self) -> float:
        return sum(self.buckets.values())

    def fractions(self) -> dict[str, float]:
        """Bucket fractions of total accounted wall time. Computed from the
        same dict they partition, so they sum to 1 up to float rounding
        (empty meter: all zeros)."""
        total = self.total()
        if total <= 0.0:
            return {b: 0.0 for b in BUCKETS}
        return {b: v / total for b, v in self.buckets.items()}

    @property
    def goodput(self) -> float:
        """The headline: productive-step fraction of accounted wall time."""
        return self.fractions()["productive_step"]

    # -- checkpoint round trip ---------------------------------------------

    def to_state(self) -> dict[str, float]:
        """Plain-float snapshot for checkpoint meta (json-safe)."""
        return {b: float(v) for b, v in self.buckets.items()}

    def load_state(self, state: dict) -> None:
        """Seed cumulative counters from a checkpoint snapshot. Unknown keys
        (a future bucket rename) fold into ``other`` rather than being
        dropped — the partition property must survive schema drift."""
        for key, value in dict(state).items():
            if key in self.buckets:
                self.buckets[key] = float(value)
            else:
                self.buckets["other"] += float(value)
