"""Continuous micro-batching request admission.

A copy of ``distributed_training_pytorch_tpu/serving/batcher.py`` (the port imports
nothing of the JAX package), with the same policy and boundaries.

The serving analog of the training loader's batching policy, inverted:
training pulls fixed-size batches from an unbounded corpus; serving is
handed an unpredictable request stream and must *form* batches under a
latency budget. The policy here is the standard continuous-batching
compromise, stated precisely so the tests can pin its boundaries:

* **Bucketized batch sizes.** Batches flush at one of a fixed ascending
  tuple of sizes (``buckets``), padding the tail — so the engine compiles
  ``len(buckets)`` executables per input signature instead of one per
  observed batch size (the ``TrainEngine`` per-shape cache contract,
  shared by :class:`~.engine.InferEngine`).
* **Admit-until-bucket-deadline.** A request waits at most
  ``max_delay_s`` in the queue before its batch flushes: the queue keeps
  admitting until either the largest bucket fills (flush immediately —
  more waiting cannot improve occupancy) or the *oldest* pending
  request's deadline arrives (flush whatever is queued, padded to the
  smallest covering bucket). Latency cost of batching is therefore
  bounded by ``max_delay_s`` exactly, not amortized.
* **Per-tenant fair admission.** Pending requests queue per tenant
  (FIFO within a tenant); a flushing batch drafts round-robin *across*
  tenants, so a greedy tenant with a deep queue cannot starve a quiet
  one out of a bucket.
* **Bounded depth, typed rejection.** Each tenant holds at most
  ``max_queue_depth`` undispatched requests; the next submit raises
  :class:`OverloadRejected` (typed, counted per tenant) instead of
  queueing unboundedly. ``max_queue_depth=0`` refuses every request
  immediately — a zero-capacity config must refuse, not hang
  (test-enforced).

Pure Python + threading primitives: no torch import, injectable clock,
unit-testable without devices (tests/test_torch_serving.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import Counter, OrderedDict, deque
from typing import Any

__all__ = [
    "MicroBatch",
    "MicroBatcher",
    "OverloadRejected",
    "Request",
    "pick_bucket",
]


class OverloadRejected(RuntimeError):
    """A tenant's bounded queue is full (or capacity is zero): the request
    was refused at admission, never queued. Carries the facts a caller
    needs to shape the HTTP 429 / backpressure decision."""

    def __init__(self, tenant: str, depth: int, bound: int):
        super().__init__(
            f"tenant {tenant!r} queue at depth {depth} >= bound {bound}: "
            "request rejected at admission"
        )
        self.tenant = tenant
        self.depth = depth
        self.bound = bound


def pick_bucket(n: int, buckets: tuple) -> int:
    """The smallest bucket >= ``n`` (boundary-exact: ``n`` equal to a
    bucket size picks that bucket, one over picks the next). Raises
    ``ValueError`` when ``n`` exceeds the largest bucket — the caller
    split the work wrong, and padding cannot fix it."""
    if n <= 0:
        raise ValueError(f"batch of {n} requests has no bucket")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} requests exceed the largest bucket {buckets[-1]}")


@dataclasses.dataclass
class Request:
    """One admitted request: payload plus its completion rendezvous.
    The dispatcher fills ``result``/``error`` and sets ``done``; the
    submitting thread blocks in :meth:`wait`."""

    id: int
    tenant: str
    payload: Any
    arrival: float  # batcher-clock admission time (latency accounting)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Any = None
    error: "str | None" = None
    # HTTP status an errored request maps to: 500 for an inference failure,
    # 503 when a drain's bounded deadline shed the request before dispatch
    # (typed, with Retry-After — never a hang or a dropped row).
    error_code: int = 500
    params_version: "str | None" = None
    completed: float = 0.0

    def wait(self, timeout: "float | None" = None) -> bool:
        return self.done.wait(timeout)


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One flushed batch: the drafted requests, the bucket they pad to,
    and why the flush fired (``"full"`` — largest bucket occupied;
    ``"deadline"`` — oldest request's wait hit ``max_delay_s``;
    ``"drain"`` — caller-forced shutdown flush)."""

    requests: tuple
    bucket: int
    flushed_by: str

    @property
    def pad(self) -> int:
        return self.bucket - len(self.requests)

    def payloads(self) -> list:
        return [r.payload for r in self.requests]


class MicroBatcher:
    """The admission queue + flush policy (see module doc). Thread-safe:
    ``submit`` is called from request threads, ``next_batch`` from the
    dispatch loop. ``clock`` is injectable so the deadline policy is
    testable without sleeping."""

    def __init__(
        self,
        *,
        buckets: tuple = (1, 2, 4, 8),
        max_delay_s: float = 0.02,
        max_queue_depth: int = 64,
        clock=time.monotonic,
    ):
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        if len(set(buckets)) != len(buckets):
            raise ValueError(f"duplicate buckets: {buckets!r}")
        self.buckets = buckets
        self.max_delay_s = float(max_delay_s)
        self.max_queue_depth = int(max_queue_depth)
        self._clock = clock
        self._lock = threading.Lock()
        # Tenant order is admission order of first appearance; the draft
        # rotation walks it round-robin starting past the last tenant
        # drafted first, so no tenant owns the front of every batch.
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rr_next = 0  # rotation offset into the tenant order
        self._ids = itertools.count()
        # -- counters (exported via stats(); the server's /status) --------
        self.submitted = 0
        self.rejected: Counter = Counter()  # per tenant
        self.batches = 0
        self.padded_slots = 0
        self.flushes: Counter = Counter()  # by flushed_by reason

    # -- admission ---------------------------------------------------------

    def submit(self, tenant: str, payload: Any, *, now: "float | None" = None) -> Request:
        """Admit one request, or raise :class:`OverloadRejected` when the
        tenant's bounded queue is full. Never blocks."""
        return self.submit_many(tenant, (payload,), now=now)[0]

    def submit_many(
        self, tenant: str, payloads, *, now: "float | None" = None
    ) -> "list[Request]":
        """Admit every payload or none: capacity for the whole list is
        reserved atomically under the lock. A multi-row request that would
        overflow the tenant's bound is rejected wholesale — rejection can
        never leave already-admitted orphan rows behind it, still queued
        and burning compute after the caller was told 429."""
        payloads = list(payloads)
        if not payloads:
            return []
        now = self._clock() if now is None else now
        with self._lock:
            q = self._queues.get(tenant)
            depth = len(q) if q is not None else 0
            if depth + len(payloads) > self.max_queue_depth:
                self.rejected[tenant] += 1
                raise OverloadRejected(tenant, depth, self.max_queue_depth)
            if q is None:
                q = deque()
                self._queues[tenant] = q
            reqs = [
                Request(id=next(self._ids), tenant=tenant, payload=p, arrival=now)
                for p in payloads
            ]
            q.extend(reqs)
            self.submitted += len(reqs)
            return reqs

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def next_deadline(self) -> "float | None":
        """Clock time at which the oldest pending request forces a flush
        (the dispatch loop's sleep bound), or None when idle."""
        with self._lock:
            oldest = self._oldest_arrival()
        return None if oldest is None else oldest + self.max_delay_s

    def _oldest_arrival(self) -> "float | None":
        arrivals = [q[0].arrival for q in self._queues.values() if q]
        return min(arrivals) if arrivals else None

    # -- the flush policy --------------------------------------------------

    def next_batch(
        self, *, now: "float | None" = None, drain: bool = False
    ) -> "MicroBatch | None":
        """One dispatch-loop poll: a flushed :class:`MicroBatch` when the
        policy says go, else None (keep admitting). ``drain=True`` flushes
        whatever is pending regardless of deadline (shutdown path)."""
        now = self._clock() if now is None else now
        with self._lock:
            total = sum(len(q) for q in self._queues.values())
            if total == 0:
                return None
            full = total >= self.buckets[-1]
            oldest = self._oldest_arrival()
            deadline_hit = oldest is not None and (now - oldest) >= self.max_delay_s
            if not (full or deadline_hit or drain):
                return None
            take = min(total, self.buckets[-1])
            bucket = pick_bucket(take, self.buckets)
            drafted = self._draft(take)
            reason = "full" if full else ("deadline" if deadline_hit else "drain")
            self.batches += 1
            self.padded_slots += bucket - len(drafted)
            self.flushes[reason] += 1
            return MicroBatch(requests=tuple(drafted), bucket=bucket, flushed_by=reason)

    def _draft(self, take: int) -> list:
        """Draft ``take`` requests round-robin across tenant queues (FIFO
        within each): one per tenant per rotation sweep, so bucket slots
        split evenly among whoever is waiting. The rotation start advances
        each batch — no tenant is structurally first."""
        tenants = list(self._queues.keys())
        drafted: list = []
        if tenants:
            start = self._rr_next % len(tenants)
            order = tenants[start:] + tenants[:start]
            self._rr_next += 1
            while len(drafted) < take:
                progressed = False
                for t in order:
                    if len(drafted) >= take:
                        break
                    q = self._queues[t]
                    if q:
                        drafted.append(q.popleft())
                        progressed = True
                if not progressed:
                    break
        # Empty tenant queues are dropped so a long-gone tenant does not
        # hold a rotation slot (and the dict does not grow unboundedly).
        for t in [t for t, q in self._queues.items() if not q]:
            del self._queues[t]
        return drafted

    # -- export ------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            dispatched = self.batches and (
                self.submitted - sum(len(q) for q in self._queues.values())
            )
            return {
                "submitted": self.submitted,
                "rejected": dict(self.rejected),
                "rejected_total": sum(self.rejected.values()),
                "batches": self.batches,
                "padded_slots": self.padded_slots,
                "pad_frac": (
                    self.padded_slots / (self.padded_slots + dispatched)
                    if dispatched
                    else 0.0
                ),
                "flushes": dict(self.flushes),
                "pending": sum(len(q) for q in self._queues.values()),
                "buckets": list(self.buckets),
                "max_delay_s": self.max_delay_s,
                "max_queue_depth": self.max_queue_depth,
            }
