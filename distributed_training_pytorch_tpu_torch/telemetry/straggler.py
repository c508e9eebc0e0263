"""Per-rank straggler attribution at the trainer's existing sync points.

Counterpart of ``distributed_training_pytorch_tpu/telemetry/straggler.py``, with the same
record fields (:data:`FIELDS`) and :func:`ratio`. The JAX package samples one process's
chips by blocking on each device's shard in turn. A port process drives one card, so the
unit of attribution is the rank: each rank's host wall from the end of its previous
``log_every`` sync to its arrival at the next one (the time it took to issue and feed its
window). The slowest rank is the one the others wait for at the step's collectives.

Nothing adds a sync or a collective: each rank's figure rides the metrics all-reduce
the engine already does every step (``TrainEngine._reduce``: one slot per data rank,
each rank writing its own, summed). A sync point hands its figure to the engine, the
steps after it carry it, and the next sync point reads every rank's figure off the last
step's metrics. So a window's record attributes the window before it.

With one data rank there is nothing to compare: the fields are absent, as on a JAX host
with one chip, and the ``straggler`` anomaly never fires on an absent value.
"""

from __future__ import annotations

__all__ = ["FIELDS", "arrival_fields", "ratio"]

FIELDS = ("chip_wall_ms_min", "chip_wall_ms_max", "chip_skew_ms", "slowest_chip", "chips_sampled")


def arrival_fields(walls_ms) -> dict:
    """The :data:`FIELDS` from each rank's window wall (index = data rank; a rank that has
    not reported yet holds 0), or ``{}`` with fewer than two ranks reporting."""
    walls = [float(w) for w in walls_ms]
    if len(walls) < 2 or min(walls) <= 0.0:
        return {}
    lo = min(walls)
    hi = max(walls)
    return {
        "chip_wall_ms_min": lo,
        "chip_wall_ms_max": hi,
        "chip_skew_ms": hi - lo,
        "slowest_chip": int(walls.index(hi)),
        "chips_sampled": len(walls),
    }


def ratio(skew_ms: float, step_ms: float) -> float:
    """Slowest-rank ratio ``1 + skew / step``: 1.0 when the ranks keep pace, 2.0 when
    the slowest cost the window one whole extra step time."""
    step_ms = max(float(step_ms), 1e-9)
    return 1.0 + max(float(skew_ms), 0.0) / step_ms
