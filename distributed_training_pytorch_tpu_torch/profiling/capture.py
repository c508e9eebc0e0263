"""Trace capture of real training steps: ``Trainer(profile=ProfileConfig(...))``.

Counterpart of ``distributed_training_pytorch_tpu/profiling/capture.py``: the same
:class:`ProfileConfig` knobs and state machine, driven by the trainer at its unit
boundaries (a unit is one step or one chained window):

* tracing starts at the first boundary after this process has run ``skip_steps`` steps
  (default 1: the first unit, which pays the kernels' build and a CUDA graph's warm-up
  and capture, stays out of the trace);
* start and stop land on unit boundaries, so a chained window is traced whole, as the
  replay of its graph (its steps count as steps); the steps traced are rounded up to
  whole windows;
* rank 0 captures; the capture is one-shot.

On stop the trace is analysed into a ``report.StepProfile`` and emitted as a
``profile_capture`` event with the JAX fields (``trace_dir``, ``start_step``, ``steps``,
``source``, ``span_us``, ``step_us``, ``device_busy_frac``, ``dispatch_gap_frac``,
``categories``) and the rest of ``StepProfile.to_dict()`` (``busy_us``, ``idle_us``,
``category_us``, ``top_ops``). A profiler that fails to start or stop, or a trace the
analysis cannot read, is a warning, never the reason training dies.
"""

from __future__ import annotations

import dataclasses

from distributed_training_pytorch_tpu_torch.profiling.trace import start_session, stop_session

__all__ = ["ProfileConfig", "StepTraceCapture", "resolve_profile"]


@dataclasses.dataclass
class ProfileConfig:
    """``dir`` (None: ``<save_folder>/profile``), ``steps`` to trace, ``skip_steps``
    before tracing, ``analyze`` (the report and the event), ``top_k`` op rows."""

    dir: "str | None" = None
    steps: int = 5
    skip_steps: int = 1
    analyze: bool = True
    top_k: int = 10

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError(f"ProfileConfig.steps must be >= 1, got {self.steps}")
        if self.skip_steps < 0:
            raise ValueError(f"ProfileConfig.skip_steps must be >= 0, got {self.skip_steps}")


def resolve_profile(spec) -> "ProfileConfig | None":
    """``None``/``False`` off; a string is the trace directory with the defaults; a
    :class:`ProfileConfig` as it is."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, str):
        return ProfileConfig(dir=spec)
    if isinstance(spec, ProfileConfig):
        return spec
    raise TypeError(f"profile must be None, a trace-dir string, or a ProfileConfig, got {type(spec)}")


class StepTraceCapture:
    """One traced window of real steps, driven at unit boundaries."""

    def __init__(self, config: ProfileConfig, *, device="cpu", log=None, events=None,
                 process_index: "int | None" = None):
        if config.dir is None:
            raise ValueError("StepTraceCapture needs a resolved ProfileConfig.dir")
        if process_index is None:
            from distributed_training_pytorch_tpu_torch.parallel.mesh import process_index as _pi

            process_index = _pi()
        self.config = config
        self.device = device
        self._log = log or (lambda msg, log_type="info": print(f"{log_type.upper()}: {msg}"))
        self._events = events
        self.active = process_index == 0
        self.state = "waiting" if self.active else "done"
        self.start_step: "int | None" = None
        self.steps_traced = 0
        self.report = None
        self._session = None
        self._steps_seen = 0
        self._unit_start: "int | None" = None

    def _note_boundary(self, step_in_epoch: int) -> None:
        if self._unit_start is not None:
            self._steps_seen += max(0, step_in_epoch - self._unit_start)
            self._unit_start = None

    def _fail(self, what: str, e: BaseException) -> None:
        self.state = "done"
        self._session = None
        self._log(f"profile: {what} failed ({e}) — capture disabled", "warning")
        if self._events is not None:
            self._events.emit("profile_capture", trace_dir=self.config.dir, error=repr(e))

    def maybe_start(self, step_in_epoch: int) -> None:
        """Before the unit whose first step is ``step_in_epoch``: start once this process
        has run ``skip_steps`` steps (the device's earlier work is waited for first)."""
        if self.state != "waiting":
            return
        self._note_boundary(step_in_epoch)
        if self._steps_seen < self.config.skip_steps:
            self._unit_start = step_in_epoch
            return
        try:
            self._session = start_session(self.config.dir, self.device)
        except (OSError, RuntimeError) as e:
            self._fail("trace start", e)
            return
        self.state = "tracing"
        self.start_step = step_in_epoch

    def maybe_stop(self, step_in_epoch: int, *, force: bool = False, abort: bool = False) -> None:
        """After a unit, with the next step's index: stop once ``config.steps`` steps are
        covered (``force`` at the epoch's end). ``abort`` (a teardown) stops without the
        analysis; the trace stays on disk."""
        if self.state == "waiting":
            self._note_boundary(step_in_epoch)
            return
        if self.state != "tracing":
            return
        covered = step_in_epoch - self.start_step
        if covered < self.config.steps and not force:
            return
        try:
            stop_session(self._session, None if abort else self.device)
        except (OSError, RuntimeError) as e:
            self._fail("trace stop", e)
            return
        self._session = None
        self.state = "done"
        self.steps_traced = covered
        self._log(f"profile: traced steps [{self.start_step}, {step_in_epoch}) -> {self.config.dir}")
        fields = {"trace_dir": self.config.dir, "start_step": self.start_step, "steps": self.steps_traced}
        if not self.config.analyze or abort:
            if self._events is not None:
                self._events.emit("profile_capture", **fields)
            return
        from distributed_training_pytorch_tpu_torch.profiling.report import analyze_trace

        try:
            self.report = analyze_trace(self.config.dir, steps=self.steps_traced or None, top_k=self.config.top_k)
        except (FileNotFoundError, ValueError, OSError) as e:
            self._log(f"profile: trace analysis failed ({e})", "warning")
            if self._events is not None:
                self._events.emit("profile_capture", **fields, error=repr(e))
            return
        summary = self.report.to_dict()
        self._log(f"profile: {self.report.summary()}")
        if self._events is not None:
            self._events.emit(
                "profile_capture", **fields,
                **{k: summary[k] for k in ("source", "span_us", "step_us", "device_busy_frac", "dispatch_gap_frac",
                                           "categories", "busy_us", "idle_us", "category_us", "top_ops",
                                           "trace_path")},
            )
