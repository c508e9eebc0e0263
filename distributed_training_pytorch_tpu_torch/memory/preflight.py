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
  of the batch shards) and the smallest accumulation factor that fits the full batch
  (doubling), within ``max_trials`` traces, and on a pure data mesh of more than one rank
  the smallest fsdp split of the data extent that fits (JAX ``preflight.py:332-362``), then
  raise :class:`PreflightOOMError` with them in its message (``action="raise"``) or warn
  (``action="warn"``).

The fsdp search takes no trace: a split leaves the batch and the activations as they are
and shards the state, so each divisor ``f`` of the data extent is tried as the predicted
peak less the state the split takes off each device: the traced params, gradients and
optimizer state times ``1 - shard/whole``, the parameters' per-device bytes under
``fsdp=f`` (``parallel.sharding.tree_shard_bytes`` from axis sizes alone, with the
engine's rules and ``fsdp_min_size``) over their whole bytes.

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
    """The global batch's granularity: the batch shards (the Trainer's divisibility rule)."""
    return 1 if engine.mesh is None else mesh_lib.batch_shard_extent(engine.mesh)


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
        message = _failure_message(report)
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
    if _pure_data_mesh(engine):
        report.recommended_fsdp = _smallest_fitting_fsdp(engine, state, report)


def _smallest_fitting_fsdp(engine, state, report) -> "int | None":
    """The smallest divisor ``f`` of the data extent whose split ``data // f x fsdp f``
    (the same batch extent) brings the per-device state under the usable bytes (see the
    module docstring)."""
    from distributed_training_pytorch_tpu_torch.parallel import sharding
    from distributed_training_pytorch_tpu_torch.train.state import unwrap

    model = unwrap(state.model)
    whole = sharding.tree_shard_bytes(model)
    classes = report.profile.bytes_by_class if report.profile is not None else {}
    state_bytes = sum(classes.get(c, 0) for c in ("params", "gradients", "optimizer_state"))
    data = int(engine.mesh.shape[mesh_lib.DATA_AXIS])
    for fsdp in sorted(f for f in range(2, data + 1) if data % f == 0):
        axes = {mesh_lib.DATA_AXIS: data // fsdp, mesh_lib.FSDP_AXIS: fsdp}
        specs = sharding.state_shardings(model, axes, engine.sharding_rules or (),
                                         fsdp_min_size=engine.fsdp_min_size)
        kept = sharding.tree_shard_bytes(model, specs, axes) / whole if whole else 1.0
        if report.predicted_peak_bytes - state_bytes * (1.0 - kept) <= report.usable_bytes:
            return fsdp
    return None


def _pure_data_mesh(engine) -> bool:
    mesh = engine.mesh
    if mesh is None:
        return False
    return int(mesh.shape.get(mesh_lib.DATA_AXIS, 1)) > 1 and all(
        int(extent) == 1 for axis, extent in mesh.shape.items() if axis != mesh_lib.DATA_AXIS)


def _failure_message(report: PreflightReport) -> str:
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
    if report.recommended_fsdp is not None:
        lines.append(f"  recommendation: enable fsdp={report.recommended_fsdp} — "
                     f"Trainer(mesh=MeshConfig(fsdp={report.recommended_fsdp}).build()) shards params + optimizer "
                     "state per-device at the same global batch (predicted to fit)")
    if report.recommended_batch is None and report.recommended_accum is None and report.recommended_fsdp is None:
        lines.append("  no fitting configuration found (params + optimizer state may exceed the card outright — "
                     "shard the model over more cards: MeshConfig(fsdp=...))")
    return "\n".join(lines)
