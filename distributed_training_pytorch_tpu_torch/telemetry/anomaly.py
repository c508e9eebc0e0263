"""Host-side anomaly detectors: loss spikes, grad explosions, step-time
regressions, live-memory growth and stragglers.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/anomaly.py``: the same kinds,
default thresholds, EWMA and floor rules, and ``warn``/``raise`` actions. They run only
at the trainer's existing host sync points (``log_every`` and the epoch's end), on values
the sync already read back, so detection adds no device sync. The detector only detects;
the trainer emits an ``anomaly`` event and a warning per finding, and raises
:class:`AnomalyError` when the detector was built with ``action="raise"``.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Anomaly", "AnomalyError", "AnomalyDetector"]


class AnomalyError(RuntimeError):
    """Raised by the trainer (``action="raise"``) when a detector fires."""


@dataclasses.dataclass
class Anomaly:
    """One finding: ``kind`` is ``loss_spike`` | ``grad_explosion`` |
    ``step_time_regression`` | ``memory_growth`` | ``straggler``; ``value``
    tripped at ``factor`` x ``baseline`` (the EWMA at detection time — or,
    for the floor-baselined kinds ``memory_growth``/``straggler``, the
    post-warmup steady-state floor) at global step ``step``."""

    kind: str
    step: int
    value: float
    baseline: float
    factor: float

    def describe(self) -> str:
        return (
            f"{self.kind} at step {self.step}: {self.value:.4g} vs "
            f"baseline {self.baseline:.4g} (threshold x{self.factor:g})"
        )


class AnomalyDetector:
    """EWMA-baselined detectors over the trainer's host-synced metrics.

    ``loss_spike`` / ``grad_explosion`` / ``step_time_regression`` are the
    trip factors (None disables that signal's threshold comparison — a
    non-finite value still fires); ``ewma_alpha`` the baseline's
    smoothing; ``warmup`` the observations per signal before it can fire
    (compile-skewed first windows and init-transient losses are normal).

    ``memory_growth`` watches the trainer's per-window ``live_bytes``
    (``memory.live``) differently: steady-state live bytes must be FLAT
    across windows — every step's buffers are freed or reused by the next —
    so its baseline is the post-warmup **minimum** (the steady-state floor),
    not an EWMA. An EWMA would *track* a slow leak and never alarm; a floor
    cannot be dragged upward, so a host-side buffer leak (a prefetch queue
    that stops draining — the exact bug class of the PR-2 shutdown race — a
    metrics list pinning device arrays) eventually crosses
    ``factor x floor`` no matter how gradual the slope. Signals whose value
    is absent (statless backends pass ``live_bytes=None``) never fire.

    ``straggler`` uses the same floor rule on the per-window
    slowest-chip ratio (``telemetry.straggler.ratio`` — 1.0 = chips in
    lockstep): a healthy mesh's ratio floor sits near 1, and a chip that
    degrades *gradually* (thermals, a failing link) would drag an EWMA
    with it exactly like a slow leak — the post-warmup floor cannot be
    dragged, so the ratio eventually crosses ``factor x floor``. Absent on
    single-chip hosts (the sampler returns no ratio): never fires.
    """

    def __init__(
        self,
        *,
        action: str = "warn",
        loss_spike: float | None = 3.0,
        grad_explosion: float | None = 10.0,
        step_time_regression: float | None = 2.5,
        memory_growth: float | None = 1.5,
        straggler: float | None = 1.5,
        ewma_alpha: float = 0.1,
        warmup: int = 5,
    ):
        if action not in ("warn", "raise"):
            raise ValueError(f"action must be 'warn' or 'raise', got {action!r}")
        self.action = action
        self._factors = {
            "loss_spike": loss_spike,
            "grad_explosion": grad_explosion,
            "step_time_regression": step_time_regression,
        }
        self.memory_growth = memory_growth
        self.straggler = straggler
        self.ewma_alpha = float(ewma_alpha)
        self.warmup = int(warmup)
        self._ewma: dict[str, float] = {}
        self._seen: dict[str, int] = {}
        self._floors: dict[str, float] = {}
        self.total_fired = 0

    def _check(self, kind: str, value: float | None, step: int) -> Anomaly | None:
        factor = self._factors[kind]
        if value is None:
            return None
        value = float(value)
        baseline = self._ewma.get(kind)
        seen = self._seen.get(kind, 0)
        anomaly = None
        if not math.isfinite(value):
            # Non-finite is anomalous unconditionally — even for a signal
            # whose threshold factor is disabled (None turns off the EWMA
            # comparison, not NaN detection) — and must NOT be folded into
            # the baseline (one NaN would poison the EWMA for the rest of
            # the run).
            return Anomaly(kind, step, value, baseline or 0.0, factor or 0.0)
        if factor is None:
            return None
        if baseline is not None and seen >= self.warmup and value > factor * abs(baseline):
            anomaly = Anomaly(kind, step, value, baseline, factor)
        # Baseline update AFTER the check; a detected spike still feeds in
        # with bounded (alpha) weight, so a persistent regime shift re-bases
        # instead of alarming forever.
        a = self.ewma_alpha
        self._ewma[kind] = value if baseline is None else (1 - a) * baseline + a * value
        self._seen[kind] = seen + 1
        return anomaly

    def _check_floor(
        self, kind: str, factor: float | None, value: float | None, step: int
    ) -> Anomaly | None:
        """Floor-baselined detection (see class docstring; shared by
        ``memory_growth`` and ``straggler``): warmup observations pass
        untracked (allocator ramp / compile-skewed first windows are
        normal), then the running minimum is the steady-state floor and a
        value above ``factor x floor`` fires. The floor only ever moves
        DOWN, so it never absorbs the drift it is there to catch."""
        if value is None or factor is None:
            return None
        value = float(value)
        seen = self._seen.get(kind, 0)
        self._seen[kind] = seen + 1
        if seen < self.warmup or not math.isfinite(value):
            return None
        floor = self._floors.get(kind)
        if floor is None:
            self._floors[kind] = value
            return None
        self._floors[kind] = min(floor, value)
        if value > factor * floor:
            return Anomaly(kind, step, value, floor, factor)
        return None

    def observe(
        self,
        step: int,
        *,
        loss: float | None = None,
        grad_norm: float | None = None,
        step_time: float | None = None,
        live_bytes: float | None = None,
        straggler_ratio: float | None = None,
    ) -> list[Anomaly]:
        """Feed one sync point's values; returns the anomalies fired (empty
        list almost always). ``step`` labels findings only."""
        found = []
        for kind, value in (
            ("loss_spike", loss),
            ("grad_explosion", grad_norm),
            ("step_time_regression", step_time),
        ):
            a = self._check(kind, value, int(step))
            if a is not None:
                found.append(a)
        for kind, factor, value in (
            ("memory_growth", self.memory_growth, live_bytes),
            ("straggler", self.straggler, straggler_ratio),
        ):
            a = self._check_floor(kind, factor, value, int(step))
            if a is not None:
                found.append(a)
        self.total_fired += len(found)
        return found
