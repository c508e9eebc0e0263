"""Wall-clock hung-step watchdog.

Counterpart of ``distributed_training_pytorch_tpu/fault/watchdog.py``. A job can stall
without dying: a wedged storage mount blocks the input pipeline, a peer leaves a
collective and the others spin in it. Nothing raises; the job stops making progress until
the scheduler's much longer job timeout reaps it.

:class:`StepWatchdog` bounds that loss: the step loop calls ``pat()`` once per step; a
daemon thread checks the time since the last pat and, past ``timeout`` seconds, calls
``on_timeout``, by default a SIGTERM to this process, which the ``Trainer``'s preemption
handler turns into a resumable mid-epoch save at the next safe point. The watchdog never
acts from signal context and never touches torch state from its thread.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional

__all__ = ["StepWatchdog"]


def _default_on_timeout() -> None:
    os.kill(os.getpid(), signal.SIGTERM)


class StepWatchdog:
    """Call ``on_timeout`` when no ``pat()`` arrives for ``timeout`` seconds, on the
    watchdog thread, at most ``max_fires`` times. After a fire the next window is
    ``timeout * escalation_factor``: the recovery the first fire starts needs the step in
    flight to finish. A context manager around a step loop::

        with StepWatchdog(timeout=300) as dog:
            for batch in batches:
                step(batch)
                dog.pat()

    The JAX watchdog's ``on_patrol`` hook (the telemetry heartbeat) comes with the
    observability slice.
    """

    def __init__(
        self,
        timeout: float,
        on_timeout: Optional[Callable[[], None]] = None,
        *,
        poll_interval: "float | None" = None,
        max_fires: int = 1,
        escalation_factor: float = 5.0,
    ):
        if timeout <= 0:
            raise ValueError(f"timeout must be positive, got {timeout}")
        self.timeout = float(timeout)
        self.on_timeout = on_timeout if on_timeout is not None else _default_on_timeout
        self.poll_interval = poll_interval if poll_interval is not None else min(1.0, self.timeout / 4)
        self.max_fires = max_fires
        self.escalation_factor = float(escalation_factor)
        self.fired = 0
        self._pats = 0
        # _last_pat is re-armed by a fire (the escalated window starts then);
        # _last_progress moves only with pat(), the true no-progress clock.
        self._last_pat = time.monotonic()
        self._last_progress = time.monotonic()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._lock = threading.Lock()  # pat() and the patrol thread share the fields above

    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self._last_pat = self._last_progress = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="step-watchdog", daemon=True)
        self._thread.start()
        return self

    def pat(self) -> None:
        """Mark progress (once per completed step or window)."""
        with self._lock:
            self._pats += 1
            self._last_pat = self._last_progress = time.monotonic()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def elapsed(self) -> float:
        """Seconds since the last pat or fire."""
        with self._lock:
            return time.monotonic() - self._last_pat

    @property
    def progress_elapsed(self) -> float:
        """Seconds since the last ``pat()``; a fire does not reset it."""
        with self._lock:
            return time.monotonic() - self._last_progress

    def _run(self) -> None:
        window = self.timeout
        pats_at_fire = -1
        while not self._stop.wait(self.poll_interval):
            fire = False
            with self._lock:
                if self.fired >= self.max_fires:
                    return
                if pats_at_fire >= 0 and self._pats > pats_at_fire:
                    window = self.timeout  # a real pat since the fire
                    pats_at_fire = -1
                if time.monotonic() - self._last_pat > window:
                    fire = True
                    self.fired += 1
                    pats_at_fire = self._pats
            if fire:
                try:
                    self.on_timeout()  # outside the lock: it may log or save
                except Exception:  # noqa: BLE001 — the watchdog must never take the process down
                    pass
                with self._lock:
                    self._last_pat = time.monotonic()
                window = self.timeout * self.escalation_factor

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
