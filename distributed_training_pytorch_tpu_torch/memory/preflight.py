"""The memory preflight: predict a step's peak before the first dispatch, and when it does
not fit, say what would.

Counterpart of ``distributed_training_pytorch_tpu/memory/preflight.py``, with its surface,
names and report fields:

* predict the configured program's peak (the chained window when the trainer runs
  windows) with :func:`memory.analysis.analyze_step_memory`, a trace on meta tensors that
  allocates nothing on the card;
* compare it with the card's capacity (``torch.cuda.mem_get_info``'s total, or
  ``Preflight.capacity_bytes``) less a ``headroom`` fraction;
* on a predicted OOM, search for the largest batch that fits (a bisection over multiples
  of the data shards) and the smallest accumulation factor that fits the full batch
  (doubling), within ``max_trials`` traces, then raise :class:`PreflightOOMError` with
  both in its message (``action="raise"``) or warn (``action="warn"``).

``recommended_fsdp`` stays None: the port has no ``fsdp`` axis yet (``ROADMAP.md`` Queue 1
item 4). Where the JAX package would try one (a pure data mesh of more than one rank), the
message names that item instead.

``Trainer(preflight=...)`` runs it once, before the first dispatch; ``preflight=None`` (the
default) runs nothing of it. A trial is a trace of the step on the CPU (no compile): the
trainer books the time to the goodput ``compile`` bucket.
"""

from __future__ import annotations

import dataclasses
import time

from distributed_training_pytorch_tpu_torch.memory import analysis as mem_analysis
from distributed_training_pytorch_tpu_torch.memory import live as mem_live
from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

__all__ = ["Preflight", "PreflightOOMError", "PreflightReport", "resolve_preflight", "run_preflight"]


class PreflightOOMError(RuntimeError):
    """A predicted OOM (``action="raise"``); ``.report`` is the :class:`PreflightReport`
    with the recommendations."""

    def __init__(self, message: str, report: "PreflightReport | None" = None):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass
class Preflight:
    """``Trainer(preflight=...)``'s knobs: ``capacity_bytes`` (None: the card's total
    memory; off the card the check is skipped and the prediction recorded), ``headroom``
    (the fraction of capacity held back), ``action`` (``"raise"`` or ``"warn"``),
    ``recommend`` (search on a predicted OOM), ``top_k`` (largest-buffer rows) and
    ``max_trials`` (traces the search may run)."""

    capacity_bytes: "int | None" = None
    headroom: float = 0.1
    action: str = "raise"
    recommend: bool = True
    top_k: int = 8
    max_trials: int = 12

    def __post_init__(self):
        if self.action not in ("raise", "warn"):
            raise ValueError(f"action must be 'raise' or 'warn', got {self.action!r}")
        if not 0.0 <= float(self.headroom) < 1.0:
            raise ValueError(f"headroom must be in [0, 1), got {self.headroom!r}")


def resolve_preflight(spec) -> "Preflight | None":
    """``None``/``False`` off; ``True``/``"on"``/``"check"`` the defaults; a
    :class:`Preflight` as it is."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return Preflight()
    if isinstance(spec, str):
        key = spec.lower()
        if key in ("on", "1", "true", "check", "default"):
            return Preflight()
        if key in ("off", "0", "false", "none"):
            return None
        raise ValueError(f"unknown preflight spec {spec!r} (use 'on', 'off', or a Preflight)")
    if isinstance(spec, Preflight):
        return spec
    raise TypeError(f"preflight must be None, bool, str, or Preflight, got {type(spec)}")


@dataclasses.dataclass
class PreflightReport:
    """The verdict: ``fits`` is None without a capacity; ``recommended_batch`` (the
    largest global batch, a multiple of the data shards, predicted to fit) and
    ``recommended_accum`` (the smallest accumulation factor that fits the full batch) are
    set on a predicted OOM when found."""

    predicted_peak_bytes: int
    batch_size: int
    profile: mem_analysis.MemoryProfile
    capacity_bytes: "int | None" = None
    usable_bytes: "int | None" = None
    headroom: float = 0.0
    fits: "bool | None" = None
    chain_length: "int | None" = None
    recommended_batch: "int | None" = None
    recommended_accum: "int | None" = None
    recommended_fsdp: "int | None" = None
    trials: int = 0
    seconds: float = 0.0
    free_bytes: "int | None" = None  # the card's free memory when the preflight ran

    def to_fields(self) -> dict:
        """The ``memory_preflight`` event's payload (the JAX fields, and ``free_bytes``)."""
        return {
            "fits": self.fits,
            "batch_size": self.batch_size,
            "capacity_bytes": self.capacity_bytes,
            "usable_bytes": self.usable_bytes,
            "headroom": self.headroom,
            "recommended_batch": self.recommended_batch,
            "recommended_accum": self.recommended_accum,
            "recommended_fsdp": self.recommended_fsdp,
            "trials": self.trials,
            "seconds": round(self.seconds, 3),
            "top_buffers": self.profile.top_buffers[:5],
            **self.profile.to_fields(),
            **({"free_bytes": self.free_bytes} if self.free_bytes is not None else {}),
        }


def _leading_dim(batch) -> int:
    if not batch:
        raise ValueError("preflight: the batch has no tensors")
    return int(next(iter(batch.values())).shape[0])


def _batch_shard(engine) -> int:
    """The global batch's granularity: the data shards (the Trainer's divisibility rule)."""
    return 1 if engine.mesh is None else int(engine.mesh.shape[mesh_lib.DATA_AXIS])


def _resize_batch(batch, new_leading: int) -> dict:
    import torch

    return {k: torch.empty((int(new_leading), *v.shape[1:]), dtype=v.dtype, device="meta") for k, v in batch.items()}


def _format_bytes(n) -> str:
    if n is None:
        return "unknown"
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(value) < 1024.0 or unit == "GiB":
            return f"{value:.2f} {unit}" if unit != "B" else f"{int(value)} B"
        value /= 1024.0
    return f"{value:.2f} GiB"


def run_preflight(engine, state, batch, config: Preflight, *, chain_length: "int | None" = None, log=None,
                  events=None, device=None, staged_units: int = 0) -> "PreflightReport | None":
    """Predict, check, recommend. ``batch`` is this rank's per-step batch (tensors or
    meta tensors), ``chain_length`` the window when the trainer runs windows, ``device``
    the card whose capacity counts (None: the current card, if any), ``staged_units`` the
    prefetcher's units in flight. ``events`` takes one ``memory_preflight`` record,
    ``log`` the trainer's ``log(msg, log_type)``. Raises :class:`PreflightOOMError` on a
    predicted OOM under ``action="raise"``; returns None (with a warning and a ``skipped``
    record) when the trace fails, as an observability knob must not stop training."""
    say = log if log is not None else (lambda msg, log_type="info": None)
    t0 = time.perf_counter()
    try:
        profile = mem_analysis.analyze_step_memory(engine, state, batch, chain_length=chain_length,
                                                   top_k=config.top_k, staged_units=staged_units)
    except (RuntimeError, NotImplementedError, ValueError, TypeError) as e:
        say(f"memory preflight skipped: the trace of the step failed ({type(e).__name__}: {e})", "warning")
        if events is not None:
            events.emit("memory_preflight", skipped=True, reason=f"{type(e).__name__}: {e}")
        return None
    report = PreflightReport(predicted_peak_bytes=profile.peak_bytes, batch_size=_leading_dim(batch),
                             profile=profile, headroom=float(config.headroom), chain_length=chain_length)
    capacity = config.capacity_bytes
    if capacity is None:
        capacity = mem_live.device_capacity_bytes(device)
    report.free_bytes = mem_live.device_free_bytes(device)
    if capacity is None:
        say(f"memory preflight: no card to read a capacity from — predicted peak {_format_bytes(profile.peak_bytes)} "
            "recorded, fit check skipped", "warning")
    else:
        report.capacity_bytes = int(capacity)
        report.usable_bytes = int(capacity * (1.0 - config.headroom))
        report.fits = profile.peak_bytes <= report.usable_bytes
        if not report.fits and config.recommend:
            _recommend(engine, state, batch, config, report, chain_length, staged_units)
    report.seconds = time.perf_counter() - t0
    if events is not None:
        events.emit("memory_preflight", **report.to_fields())
    if report.fits is False:
        message = _failure_message(report, engine)
        if config.action == "raise":
            raise PreflightOOMError(message, report=report)
        say(message, "warning")
    elif report.fits:
        free = f", {_format_bytes(report.free_bytes)} free now" if report.free_bytes is not None else ""
        say(f"memory preflight: predicted peak {_format_bytes(profile.peak_bytes)} fits "
            f"{_format_bytes(report.usable_bytes)} usable ({_format_bytes(report.capacity_bytes)} capacity, "
            f"{config.headroom:.0%} headroom{free})")
    return report


def _predict(engine, state, batch, chain_length, report, staged_units) -> int:
    """One recommendation trial: one trace (top table skipped)."""
    report.trials += 1
    return mem_analysis.analyze_step_memory(engine, state, batch, chain_length=chain_length, top_k=0,
                                            staged_units=staged_units).peak_bytes


def _recommend(engine, state, batch, config, report, chain_length, staged_units) -> None:
    """Fill ``recommended_batch`` and ``recommended_accum``. The peak grows with the batch
    (activations and the batch itself; the rest is constant), so a bisection over the
    shard multiples finds the boundary in log2 trials."""
    usable = report.usable_bytes
    shard = _batch_shard(engine)
    full = report.batch_size
    if full > shard and report.trials < config.max_trials:
        if _predict(engine, state, _resize_batch(batch, shard), chain_length, report, staged_units) <= usable:
            lo, hi = 1, full // shard  # lo * shard fits, hi * shard does not
            while hi - lo > 1 and report.trials < config.max_trials:
                mid = (lo + hi) // 2
                peak = _predict(engine, state, _resize_batch(batch, mid * shard), chain_length, report, staged_units)
                if peak <= usable:
                    lo = mid
                else:
                    hi = mid
            report.recommended_batch = lo * shard
    factor = 2
    base_accum = max(1, int(engine.accum_steps))
    while report.trials < config.max_trials:
        accum = base_accum * factor
        micro = full // accum
        if micro < 1 or full % accum or micro % shard:
            break
        if _predict(engine.with_accum(accum), state, batch, chain_length, report, staged_units) <= usable:
            report.recommended_accum = accum
            break
        factor *= 2


def _pure_data_mesh(engine) -> bool:
    mesh = engine.mesh
    if mesh is None:
        return False
    return int(mesh.shape.get(mesh_lib.DATA_AXIS, 1)) > 1 and all(
        int(extent) == 1 for axis, extent in mesh.shape.items() if axis != mesh_lib.DATA_AXIS)


def _failure_message(report: PreflightReport, engine=None) -> str:
    lines = [
        "memory preflight: predicted OOM — "
        f"peak {_format_bytes(report.predicted_peak_bytes)} exceeds "
        f"{_format_bytes(report.usable_bytes)} usable "
        f"({_format_bytes(report.capacity_bytes)} capacity - "
        f"{report.headroom:.0%} headroom) "
        f"at global batch {report.batch_size}"
        + (f", chained x{report.chain_length}" if report.chain_length else ""),
    ]
    fractions = report.profile.fractions()
    split = ", ".join(
        f"{cls} {_format_bytes(report.profile.bytes_by_class[cls])} ({fractions[cls]:.0%})"
        for cls in mem_analysis.BUFFER_CLASSES
        if report.profile.bytes_by_class.get(cls)
    )
    lines.append(f"  attribution: {split}")
    if report.recommended_batch is not None:
        lines.append(f"  recommendation: batch {report.recommended_batch} fits (largest shard-aligned batch under the "
                     f"limit, {report.trials} traces)")
    if report.recommended_accum is not None:
        lines.append(f"  recommendation: accum_steps={report.recommended_accum} fits the full batch "
                     f"{report.batch_size} (microbatch {report.batch_size // report.recommended_accum})")
    if engine is not None and _pure_data_mesh(engine):
        lines.append("  sharding params and optimizer state over the data ranks (fsdp) is not in the port yet "
                     "(ROADMAP.md Queue 1 item 4), so no fsdp split was tried")
    if report.recommended_batch is None and report.recommended_accum is None:
        lines.append("  no fitting configuration found (params + optimizer state may exceed the card outright)")
    return "\n".join(lines)
