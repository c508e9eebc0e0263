"""The epoch-loop orchestrator: the user-facing core.

Counterpart of the core of ``distributed_training_pytorch_tpu/trainer/trainer.py::
Trainer``: the same hooks with the same names (``build_train_dataset``,
``build_val_dataset``, ``build_model``, ``build_criterion``, ``build_optimizer``,
``build_scheduler``, ``preprocess_batch``, ``train_step``, ``validate_step``, plus
``build_loss_fn``, ``distributed_setup`` and ``destroy_process``), the same constructor
contract for the arguments the entries pass, and the same epoch loop:

* validation with best-model tracking at the top of every ``save_period``-th epoch,
  weighted by each batch's global real-row count (``trainer.py:2375-2424``);
* the epoch's train metrics, each the mean over its steps (a step the non-finite guard
  skipped is left out of the means and counted in ``nonfinite``);
* ``last`` every ``last_save_period`` epochs when validating, else
  ``checkpoint_epoch_N`` every ``save_period`` epochs; a resume from ``snapshot_path`` (a
  name, a path, or ``"latest_valid"``) restores params, optimizer state, step and epoch;
* ``nan_policy``: ``None`` trains on, ``"skip"`` drops the update of a non-finite step
  (the engine's guard), ``"raise"`` stops at the next sync point;
* ``precision`` names the dtype policy (``"fp32"``, ``"bf16"``, ``"fp16"``) and
  ``loss_scale`` the loss scaling (``None``: dynamic under fp16, none otherwise;
  ``"dynamic"``, ``"none"`` or an instance), resolved and refused as the JAX Trainer does
  (``trainer.py:248-280``): fp16 without a dynamic scale, and a dynamic scale under
  ``nan_policy`` ``"raise"`` or ``"restore_last_good"``, raise ``ValueError``. The scale's
  state rides in ``state.loss_scale`` and in every checkpoint;
* ``skip_corrupt_records`` is forwarded to both loaders (``skip_corrupt``): a record that
  cannot be read or decoded is replaced by the next readable one and counted;
* the host data path: each loader has ``num_workers`` thread workers (8) and
  ``prefetch_batches`` batches in flight (2), and ``train_epoch`` and ``validate`` take
  their batches through ``data.prefetch.device_prefetch``, which runs ``preprocess_batch``
  and the copy to the device on a background thread, two batches ahead (on the card:
  pinned memory, a side stream, an event the compute stream waits on). ``pin_memory`` is
  accepted, as in the JAX package; on the card the prefetcher always pins, since a
  ``non_blocking`` copy needs pinned memory.

In the port the model runs on ``device`` (the card unless the caller passes
``device="cpu"``). ``mesh`` is the world's layout: ``None`` (every rank a data shard), an
integer (the same, checked against the world size), or a built ``parallel.mesh.Mesh``
(``data``, ``fsdp``, ``pipe``, ``expert``, ``tensor`` and ``seq`` axes), as the JAX
``Trainer(mesh=MeshConfig(...).build())`` takes it. The global batch divides by the
batch-shard extent (``data x fsdp``); each batch shard feeds its rows of it (its seq,
pipe, expert and tensor ranks see the same rows: the loader shards by the batch-shard index, not
the rank). Without an ``fsdp``, ``expert`` or ``tensor`` axis, a data axis of more than one
rank wraps the model in ``DistributedDataParallel`` over the data group. With one, ``sharding_rules`` (``"auto"``: the ``build_sharding_rules`` hook, JAX ``trainer.py:
126``, ``:470-483``, ``:2450-2468``) and ``fsdp_min_size`` lay the parameters and the
optimizer state out in shards (``parallel/sharding.py``, ``parallel/layout.py``), and the
construction logs what was sharded. With one
sequence shard (or pipeline stage) per rank, every seq (or pipe) rank holds the whole
model: its copies are broadcast from the group's first rank at build, and the engine
broadcasts the gradients each step, so they stay bit-equal
(``parallel.mesh.broadcast_over_copies``). A model reaches the seq axis through
``self.mesh`` in ``build_model``, for example ``GPTSmall(..., attention_impl="ring",
mesh=self.mesh)``; the pipe axis through a loss that runs ``parallel.pipeline_apply``
over ``self.mesh``. Rank 0 saves.

Resilience (``trainer.py:2197-2345``, the JAX Trainer's, with its defaults):

* ``save_on_preemption`` (True): a SIGTERM sets a flag; the loop stops at the next step or
  window boundary and saves ``last`` synchronously, labelled as JAX labels it (an
  interrupted epoch is saved as ``epoch`` with ``{"step_in_epoch": k}`` in its meta, a
  finished one as ``epoch + 1``), then ``train`` returns (``preempted`` is True). With more
  than one rank the flag is an all-reduce over the world every ``preemption_check_every``
  steps (20), so every rank stops at the same step. A resume from such a snapshot skips
  the epoch's first k batches at the loader's index level (``ShardedLoader.iter_batches``)
  and continues bit-exact;
* ``step_timeout``: a ``fault.StepWatchdog`` armed after the first completed step; past
  ``step_timeout`` (times ``chain_steps``) with no step done it sends the process a
  SIGTERM, so a hang becomes a preemption save; a second fire exits with code 75;
* ``nan_policy="restore_last_good"``: like ``"skip"``, and at the next host sync point
  (``log_every``, the epoch's end) after a skipped step the background saves are flushed
  and the newest valid checkpoint restored; with none it warns and goes on as ``"skip"``;
* ``async_checkpoint`` (True): ``best``, ``last`` and the periodic saves take a host
  snapshot on the loop and commit on the background saver's thread
  (``resilience.AsyncCheckpointSaver``); preemption and watchdog saves flush it and commit
  on the loop. With more than one process the saves stay synchronous (each commit ends at
  a barrier that every rank must reach on the loop);
* ``fault_plan`` (a ``fault.FaultPlan``; tests): the step seams ``sigterm``, ``hang`` and
  ``nan_loss``, and the manager's ``checkpoint_write`` and ``corrupt_checkpoint``.

``chain_steps`` > 1 (``trainer.py:1495-1622``): the epoch runs in windows of
``chain_steps`` steps at absolute ``step_in_epoch`` multiples, each one call of
``TrainEngine.train_steps_chained`` (a CUDA graph replay on the card), fed by
``data.prefetch.device_prefetch_chained``; the steps before the first boundary (after a
mid-epoch resume) and the tail shorter than a window run singly, as does a window in
which a ``fault_plan`` step event could fire. ``log_every`` must be a multiple of
``chain_steps``, ``preemption_check_every`` is rounded up to one (with JAX's warning), and a
``train_step`` override refuses ``chain_steps > 1``.

Observability (``trainer.py:333-515``, ``:750-800``, ``:1139-1460``, ``:1755-1930``, the
JAX Trainer's wiring, with its knobs and record vocabulary):

* ``telemetry`` (``None``/``"on"``/a ``telemetry.Telemetry``): the event log
  (``<save_folder>/telemetry/events.jsonl``), goodput buckets carried in checkpoint meta,
  the on-device health stats in every step's metrics (``TrainEngine(stats=True)``),
  per-window ``step_ms`` and MFU (one FLOP probe on the meta device at the end of the
  first trained epoch), live memory and per-rank straggler fields, anomaly detection,
  heartbeats (also from the watchdog's thread), the ``doctor/*`` scalars and a status
  exporter. Everything reads values at the loop's existing sync points (``log_every``,
  the epoch's end); off, the loop and the step are as without it;
* ``profile`` (a ``profiling.ProfileConfig`` or a trace directory): one traced window of
  real steps (chained windows whole), analysed into a ``profile_capture`` event;
  ``profile_dir``/``profile_steps``: a raw trace of the first epoch's steps
  ``[1, 1 + profile_steps)`` on the single-step path. Passing both raises;
* ``tensorboard_dir``: the ``train/*``, ``precision/*``, ``goodput/*``, ``telemetry/*``,
  ``straggler/*`` and ``doctor/*`` scalars at each epoch's end
  (``utils/tensorboard.py``, which writes the event files itself).

The memory preflight (``trainer.py:493-500``, ``:1461-1500``, ``:1941-1960`` of the JAX
Trainer): ``preflight`` (``None``/``"on"``/a ``memory.Preflight``) predicts the peak device
memory of the first execution unit's program before its dispatch (``memory/preflight.py``:
a trace on meta tensors, nothing allocated on the card), the chained window when a full one
can still run this epoch, else the single step, against the card's capacity less its
headroom; it emits one ``memory_preflight`` event, keeps the report in
``memory_report``, books its time to the goodput ``compile`` bucket, and on a predicted
OOM raises ``memory.PreflightOOMError`` with the largest batch and the smallest
accumulation factor that fit, before any step. A ``train_step`` override skips it with a
warning (the engine's step is not the one dispatched). ``None`` (the default) runs none of
it.

Elastic resume (JAX ``trainer.py:995-1090``): before the mesh is built, the resume
checkpoint's meta is read; a sharding record written on another device count re-plans the
mesh and ``accum_steps`` for this world when ``mesh=None`` (``parallel.elastic.replan``: the
same global batch), an explicit mesh is honoured, and the restore emits one
``elastic_restore`` record (and the manager a ``checkpoint_reshard``). A tensor-sharded
checkpoint that this world cannot hold raises ``ElasticReplanError`` before any restore.

What the JAX Trainer has and this one does not yet: ``TUNED``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.checkpoint import (
    BEST,
    LAST,
    CheckpointError,
    CheckpointManager,
    epoch_checkpoint_name,
)
from distributed_training_pytorch_tpu_torch.data import ShardedLoader
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch, device_prefetch_chained
from distributed_training_pytorch_tpu_torch.fault import StepWatchdog
from distributed_training_pytorch_tpu_torch.memory import resolve_preflight, run_preflight, window_memory_fields
from distributed_training_pytorch_tpu_torch.ops import _build
from distributed_training_pytorch_tpu_torch.parallel import elastic as elastic_lib
from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib
from distributed_training_pytorch_tpu_torch.precision import get_policy, is_dynamic, resolve_loss_scale
from distributed_training_pytorch_tpu_torch.profiling import StepTraceCapture, resolve_profile
from distributed_training_pytorch_tpu_torch.profiling.trace import start_session, stop_session
from distributed_training_pytorch_tpu_torch.resilience import AsyncCheckpointSaver
from distributed_training_pytorch_tpu_torch.telemetry import EventLog, GoodputMeter, resolve_telemetry
from distributed_training_pytorch_tpu_torch.telemetry import doctor as telemetry_doctor
from distributed_training_pytorch_tpu_torch.telemetry import mfu as telemetry_mfu
from distributed_training_pytorch_tpu_torch.telemetry import straggler as straggler_lib
from distributed_training_pytorch_tpu_torch.telemetry.events import claim_attempt
from distributed_training_pytorch_tpu_torch.train import NonFiniteLossError, TrainEngine, TrainState
from distributed_training_pytorch_tpu_torch.utils.tensorboard import MetricsWriter

__all__ = ["Trainer"]

# The device prefetcher's units in flight beside the one a step runs: its queue's depth (2)
# and the one its producer has copied and waits to queue.
_STAGED_UNITS = 3


class Trainer:
    """Subclass, implement the hooks, call :meth:`train`."""

    def __init__(
        self,
        max_epoch: int,
        batch_size: int,
        pin_memory: bool = False,
        have_validate: bool = False,
        save_best_for: "tuple[str, str] | None" = None,
        save_period: "int | None" = None,
        save_folder: str = ".",
        snapshot_path: "str | None" = None,
        logger=None,
        *,
        mesh: "mesh_lib.Mesh | int | None" = None,
        sharding_rules="auto",
        fsdp_min_size: int = 2**18,
        seed: int = 0,
        accum_steps: int = 1,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        log_every: int = 50,
        chain_steps: int = 1,
        last_save_period: int = 1,
        async_checkpoint: bool = True,
        save_on_preemption: bool = True,
        preemption_check_every: int = 20,
        max_checkpoints_to_keep: "int | None" = None,
        nan_policy: "str | None" = None,
        skip_corrupt_records: bool = False,
        step_timeout: "float | None" = None,
        fault_plan=None,
        precision=None,
        loss_scale=None,
        device="cuda",
        profile_dir: "str | None" = None,
        profile_steps: int = 5,
        tensorboard_dir: "str | None" = None,
        telemetry=None,
        profile=None,
        preflight=None,
    ):
        self.log = (
            (lambda msg, log_type="info": logger.log(msg, log_type))
            if logger is not None
            else (lambda msg, log_type="info": print(f"{log_type.upper()}: {msg}"))
        )
        if nan_policy not in (None, "raise", "skip", "restore_last_good"):
            raise ValueError(f"nan_policy must be None|raise|skip|restore_last_good, got {nan_policy!r}")
        self.precision_requested = precision is not None
        self.precision = get_policy(precision)
        self._initial_loss_scale = resolve_loss_scale(loss_scale, self.precision)
        if self.precision.compute_dtype == torch.float16 and not is_dynamic(self._initial_loss_scale):
            raise ValueError(
                "precision='fp16' requires dynamic loss scaling (fp16 grads underflow below ~6e-5 without it): "
                "leave loss_scale unset or pass loss_scale='dynamic'. Use precision='bf16' for scale-free low "
                "precision — bf16 keeps fp32's exponent range."
            )
        if is_dynamic(self._initial_loss_scale) and nan_policy in ("raise", "restore_last_good"):
            raise ValueError(
                f"nan_policy={nan_policy!r} is incompatible with dynamic loss scaling: overflow-skip + backoff IS "
                "the scale calibration mechanism — 'raise' would abort normal fp16 training on the first benign "
                "overflow, and 'restore_last_good' would roll the whole state back to an old checkpoint (undoing "
                "the backoff, so the overflow repeats) every time the scale probes too high. Use nan_policy=None "
                "or 'skip' (skipped steps are still counted once in nonfinite_steps and "
                "state.loss_scale.skipped_steps)."
            )
        self.skip_corrupt_records = bool(skip_corrupt_records)
        self.max_epoch = max_epoch
        self.batch_size = batch_size
        self.have_validate = have_validate
        self.save_period = save_period
        self.seed = seed
        self.accum_steps = accum_steps
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.log_every = log_every
        self.last_save_period = max(1, int(last_save_period))
        self.nan_policy = nan_policy
        self.nonfinite_steps = 0
        self.nonfinite_rollbacks = 0
        self.cur_epoch = 0
        self.device = resolve_device(device)
        # Preemption: the SIGTERM handler only sets the flag; the loop saves.
        self.save_on_preemption = save_on_preemption
        self.preemption_check_every = preemption_check_every
        self._preempted = False
        self._epoch_interrupted = False
        self._interrupted_at_step = 0
        self._resume_step_in_epoch = 0
        self._prev_sigterm = None
        self._sigterm_installed = False
        self.step_timeout = step_timeout
        self._watchdog_timeout = step_timeout
        self._hung_once = False
        self.fault_plan = fault_plan
        # Tracing: `profile=` is the analysed capture, `profile_dir=` the raw trace of the
        # first epoch's steps; both would drive the one profiler session.
        self.profile = resolve_profile(profile)
        if self.profile is not None and profile_dir is not None:
            raise ValueError(
                "pass either profile= (ProfileConfig; analyzed capture) or profile_dir= (legacy raw trace), not "
                "both — they would race the one profiler session"
            )
        if self.profile is not None and self.profile.dir is None:
            self.profile = dataclasses.replace(self.profile, dir=os.path.join(save_folder, "profile"))
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiled = False
        self.metrics_writer = MetricsWriter(tensorboard_dir)
        self.chain_steps = int(chain_steps)
        self._validate_chain_config()

        self.rank = mesh_lib.process_index()
        self.world_size = mesh_lib.process_count()
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh) and int(mesh) != self.world_size:
            raise ValueError(f"mesh asks for {mesh} data-parallel ranks, the process group has {self.world_size}")
        # Sharding rules (parallel.sharding): "auto" resolves through build_sharding_rules
        # after build_model; a list or None passes through; any other string is refused.
        if isinstance(sharding_rules, str) and sharding_rules != "auto":
            raise ValueError(
                f"sharding_rules={sharding_rules!r}: the only string value is 'auto' (resolve via "
                "build_sharding_rules). Pass None for the replicated/FSDP-fallback default, or an explicit list of "
                "(name_regex, PartitionSpec) rules."
            )
        self._sharding_rules_requested = sharding_rules
        self.fsdp_min_size = int(fsdp_min_size)
        self.save_folder = save_folder
        self.save_weight_folder = os.path.join(save_folder, "weights")
        self.checkpoints = CheckpointManager(
            self.save_weight_folder, save_best_for=save_best_for, max_to_keep=max_checkpoints_to_keep,
            fault_plan=fault_plan,
        )
        # Elastic resume: a checkpoint written on another device count re-plans the mesh
        # and accum_steps for this world when mesh=None (read from its meta alone).
        snapshot_path = self._peek_resume_checkpoint(
            snapshot_path, mesh if isinstance(mesh, mesh_lib.Mesh) else None, batch_size)
        if self._elastic_plan is not None:
            mesh = self._elastic_plan.mesh_config.build()
        self.mesh = mesh if isinstance(mesh, mesh_lib.Mesh) else mesh_lib.MeshConfig().build()
        # The batch divisor is the batch-shard extent (data x fsdp, the JAX Trainer's
        # batch_shard_extent), not the world: the seq and tensor ranks of one batch shard
        # share its rows.
        self.batch_replicas = self.mesh.batch_extent
        if batch_size % self.batch_replicas:
            raise ValueError(
                f"global batch_size {batch_size} is not divisible by the mesh's batch-shard extent "
                f"{self.batch_replicas} (= product of the data and fsdp axes): every batch shard must hold the same "
                "number of rows. Round batch_size or re-plan the mesh."
            )
        if self._topology_changed and batch_size % (self.batch_replicas * self.accum_steps):
            suggestion = elastic_lib.nearest_divisible_accum(batch_size, self.batch_replicas, self.accum_steps)
            raise ValueError(
                f"global batch_size {batch_size} does not tile into accum_steps={self.accum_steps} microbatches over "
                f"the resumed mesh's batch-shard extent {self.batch_replicas}: every microbatch shard must hold the "
                f"same number of rows (batch % (extent x accum) != 0). Nearest divisible accum_steps: {suggestion}."
            )
        if self.chain_steps > 1 and self.device.type == "cuda" and (self.batch_replicas > 1 or self.mesh.sharded):
            raise NotImplementedError(
                "chained steps with more than one data rank or a sharded state on the card (DDP or the layout's "
                "collectives inside a CUDA graph) are not checked yet: ROADMAP.md Queue 1 item 7, 'chained steps "
                "with DDP on 4 cards'"
            )
        self._async_saves = bool(async_checkpoint) and self.world_size == 1
        if async_checkpoint and self.world_size > 1:
            self.log(f"async_checkpoint with {self.world_size} processes: saves commit synchronously (each ends at "
                     "a barrier every rank reaches on the loop)")
        self.saver = AsyncCheckpointSaver(self.checkpoints, on_commit=self._on_async_commit)
        self._init_telemetry(telemetry, save_folder)

        torch.manual_seed(seed)
        self.model = self.build_model().to(self.device)
        # One sequence shard (pipeline stage) per rank: the copies start from the first one's.
        mesh_lib.broadcast_over_copies([*self.model.parameters(), *self.model.buffers()], self.mesh)
        self.criterion = self.build_criterion()
        self.train_dataset = self.build_train_dataset()
        self.train_dataloader = self.build_dataloader(self.train_dataset, phase="train")
        self.val_dataloader = None
        if have_validate:
            self.val_dataset = self.build_val_dataset()
            self.val_dataloader = self.build_dataloader(self.val_dataset, phase="val")

        schedule = self.build_scheduler()
        if schedule is None:
            schedule = 0.0
        self.schedule = schedule if callable(schedule) else (lambda step, lr=float(schedule): lr)
        self.sharding_rules = (self.build_sharding_rules() if isinstance(self._sharding_rules_requested, str)
                               else self._sharding_rules_requested)
        self.engine = TrainEngine(
            self.build_loss_fn(),
            # self.accum_steps: an elastic re-plan may have re-solved it for this world
            accum_steps=self.accum_steps,
            schedule=self.schedule,
            nan_guard=nan_policy in ("skip", "restore_last_good"),
            precision=self.precision,
            mesh=self.mesh,
            stats=self.telemetry.stats if self.telemetry is not None else False,
            sharding_rules=self.sharding_rules,
            fsdp_min_size=self.fsdp_min_size,
        )
        # An fsdp, expert or tensor axis lays the model out in shards (the optimizer is built over
        # them); without one, a data axis of more than one rank is DDP, as before.
        layout = self.engine.shard_model(self.model)
        if layout is None and self.batch_replicas > 1:
            device_ids = None
            if self.device.type == "cuda":
                device_ids = [self.device.index if self.device.index is not None else torch.cuda.current_device()]
            self.model = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=device_ids, process_group=self.mesh.data_group
            )
        self.optimizer = self.build_optimizer(self.schedule)
        self._profile_capture = (
            StepTraceCapture(self.profile, device=self.device, log=self.log, events=self.events)
            if self.profile is not None else None
        )
        self.preflight = resolve_preflight(preflight)
        self._preflight_done = False
        self.memory_report = None  # the last PreflightReport
        scale = self._initial_loss_scale
        self.state = TrainState(model=self.model, optimizer=self.optimizer,
                                loss_scale=scale.to(self.device) if is_dynamic(scale) else scale, layout=layout)
        self._log_sharded_layout()
        self.checkpoints.event_log = self.events

        t_restore = time.perf_counter()
        if snapshot_path is not None:
            self.state, self.cur_epoch = self.checkpoints.restore(
                snapshot_path, self.state, validate=not self._resume_prevalidated,
                allow_topology_change=self._topology_changed)
        if snapshot_path is not None:
            meta = self.checkpoints.read_meta(snapshot_path)
            self._resume_step_in_epoch = int((meta.get("loop") or {}).get("step_in_epoch", 0))
            if self.goodput is not None:
                # The interrupted run's counters go on (JSON round-trips floats exactly); the
                # restore itself is resume overhead.
                saved = (meta.get("telemetry") or {}).get("goodput")
                if saved:
                    self.goodput.load_state(saved)
                self.goodput.account("restart_rollback", time.perf_counter() - t_restore)
            self.events.emit("checkpoint_restore", name=os.path.basename(str(snapshot_path)), epoch=self.cur_epoch,
                             step_in_epoch=self._resume_step_in_epoch)
            self._emit_elastic_restore(snapshot_path)
            self.log(
                f"Resumed from {snapshot_path} at epoch {self.cur_epoch}, step {self.state.step}"
                + (f", step {self._resume_step_in_epoch} of the epoch (mid-epoch)" if self._resume_step_in_epoch else "")
            )

    # ------------------------------------------------------------------
    # Framework-provided machinery (overridable).
    # ------------------------------------------------------------------

    def build_dataloader(self, dataset, phase: str = "train") -> ShardedLoader:
        """Deterministic global shuffle for train (trailing partial batch dropped);
        padded final batch with a ``mask`` for val. Rows are keyed by this process's data
        shard, so the seq ranks of one data shard see the same rows."""
        train = phase == "train"
        return ShardedLoader(
            dataset, self.batch_size, shuffle=train, seed=self.seed, num_workers=self.num_workers,
            prefetch_batches=self.prefetch_batches, drop_last=train, pad_final=not train,
            process_index=self.mesh.batch_index, process_count=self.batch_replicas,
            skip_corrupt=self.skip_corrupt_records,
        )

    def device_batches(self, loader) -> "Iterator[dict]":
        """The loader's batches through ``preprocess_batch``, as tensors on the device,
        copied ahead by ``device_prefetch``; the first train batch also through
        ``_check_image_range``."""
        batches = (self.preprocess_batch(b) for b in loader)
        if loader is self.train_dataloader and not self._image_range_checked:
            batches = (self._check_image_range(b) for b in batches)
        return device_prefetch(batches, self.device)

    _image_range_checked = False

    def _check_image_range(self, batch: Mapping) -> Mapping:
        """One-time guard on the first train batch: a float image batch whose values reach
        past 16 in magnitude almost certainly missed its normalisation
        (``InputNormalizer`` passes floats through as already normalised), so the model
        would train on input some 100 times too large with no error anywhere else. The
        JAX Trainer (``trainer.py:2486``) looks at the batch's first image only; this one
        looks at the whole batch, so a raw image later in the first batch is caught too."""
        if not self._image_range_checked:
            self._image_range_checked = True
            img = batch.get("image") if hasattr(batch, "get") else None
            if img is not None:
                img = np.asarray(img)
                if np.issubdtype(img.dtype, np.floating) and img.size:
                    hi = float(np.max(np.abs(img)))
                    if hi > 16.0:  # normalised images sit within a few sigma of 0
                        self.log(
                            f"float image batch spans |x| up to {hi:.0f} — looks like raw 0-255 pixels. Float "
                            "inputs bypass on-device normalization (InputNormalizer passes them through); ship "
                            "uint8 or normalize on host.",
                            "warning",
                        )
        return batch

    def to_device(self, batch: Mapping) -> dict:
        """A host batch as tensors on the trainer's device, copied on the calling
        thread (the epoch loops use ``device_batches``)."""
        return {
            k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True) for k, v in batch.items()
        }

    # ------------------------------------------------------------------
    # Train / validate loops
    # ------------------------------------------------------------------

    def train(self) -> None:
        """The epoch loop; the SIGTERM handler is installed for its duration, and every
        background save is committed (or its error logged) before it returns. With
        telemetry, ``run_start`` opens the attempt and ``run_end`` closes it."""
        self._install_sigterm()
        self.metrics_writer.reopen()
        self._start_epoch = self.cur_epoch
        if self.goodput is not None:
            self.goodput.start()
        if self.events.enabled:
            self._emit_run_start()
        if self.telemetry is not None and self.telemetry.export_port is not None and self.rank == 0:
            from distributed_training_pytorch_tpu_torch.telemetry.exporter import StatusExporter

            self.exporter = StatusExporter(lambda: self._status, self.telemetry.export_port,
                                           log=lambda msg: self.log(msg, "warning"))
        self._attempt_units = 0
        self._note_heartbeat_progress(epoch=self.cur_epoch, step_in_epoch=self._resume_step_in_epoch, units=0)
        self._emit_heartbeat("loop")
        self._update_status(step_in_epoch=self._resume_step_in_epoch, units=0)
        try:
            self._train_loop()
        finally:
            self._restore_sigterm()
            self._flush_saver_logged()
            self.saver.close()
            if self.goodput is not None:
                self.goodput.stop()
            if self.events.enabled:
                from distributed_training_pytorch_tpu_torch.ops import dispatch

                dispatch.clear_event_sink()
                fields = {"step": int(self.state.step), "epoch": self.cur_epoch, "preempted": self._preempted,
                          "nonfinite_steps": self.nonfinite_steps}
                if self.goodput is not None:
                    fields.update(goodput=self.goodput.goodput, goodput_seconds=self.goodput.to_state(),
                                  goodput_fractions=self.goodput.fractions())
                if self.anomaly_detector is not None:
                    fields["anomalies"] = self.anomaly_detector.total_fired
                self.events.emit("run_end", **fields)
            self._update_status(phase="finished")
            if self.exporter is not None:
                self.exporter.close()
                self.exporter = None
            self.events.close()
            self.metrics_writer.close()

    def _train_loop(self) -> None:
        best_banner = None
        for epoch in range(self.cur_epoch, self.max_epoch):
            self.cur_epoch = epoch
            if self.have_validate and self.save_period and epoch % self.save_period == 0:
                metrics = self.validate()
                # At the top of an epoch resumed mid-way the state has its first steps in
                # it: `best` records them, or a resume from it would train them twice
                # (the JAX Trainer labels this save as the epoch's start).
                skip = self._resume_step_in_epoch
                if self._save_checkpoint(BEST, epoch, metrics=metrics, best=True, reason="best",
                                         loop_state={"step_in_epoch": skip} if skip else None):
                    best_banner = {"epoch": epoch, "metrics": dict(metrics)}
                if best_banner is not None:
                    self.log(100 * "=")
                    msg = f"The BEST model is at EPOCH {best_banner['epoch']} and has "
                    for k, v in best_banner["metrics"].items():
                        msg += f" | {k.upper()} = {v} | "
                    self.log(msg)

            self.train_dataloader.set_epoch(epoch)
            self.log(100 * "=")
            self.log(f"[process {self.rank}] Epoch {epoch + 1}/{self.max_epoch}")
            epoch_metrics = self.train_epoch(epoch)

            # Preemption (collective): an interrupted epoch is saved as `epoch` with its
            # step, so the resume retrains the rest of it; a finished one as `epoch + 1`.
            if self._collective_preempt_flag():
                self._preempted = True
                resume_epoch = epoch if self._epoch_interrupted else epoch + 1
                loop_state = {"step_in_epoch": self._interrupted_at_step} if self._epoch_interrupted else None
                self.events.emit("preemption", epoch=epoch, resume_epoch=resume_epoch,
                                 step_in_epoch=self._interrupted_at_step if self._epoch_interrupted else 0)
                self._save_checkpoint(LAST, resume_epoch, loop_state=loop_state, wait=True, reason="preemption")
                self.log(
                    f"SIGTERM received — saved resumable snapshot (epoch {resume_epoch}"
                    + (f", step {self._interrupted_at_step}" if self._epoch_interrupted else "")
                    + f") to {self.checkpoints.path(LAST)}; exiting",
                    "warning",
                )
                return

            self.log(f"THE NEXT LEARNING RATE VALUE IS {float(self.schedule(self.state.step))}")
            if self.have_validate:
                if (epoch + 1) % self.last_save_period == 0 or epoch + 1 == self.max_epoch:
                    self._save_checkpoint(LAST, epoch + 1)
                    self.log(f"Saved model at epoch {epoch + 1}!")
            elif self.save_period and epoch % self.save_period == 0:
                self._save_checkpoint(epoch_checkpoint_name(epoch + 1), epoch + 1)
                self.log(f"Saved model at epoch {epoch + 1}!")
            msg = "TOTAL GLOBAL TRAINING LOSS: "
            for k, v in epoch_metrics.items():
                msg += f" | {k} = {v} | "
            self.log(msg)
            self.metrics_writer.write(int(self.state.step), epoch_metrics, prefix="train")
            self._write_precision_scalars()
            self._write_telemetry_scalars()
        # Every background commit on disk, its error raised, before "Finished"; the wait is
        # checkpoint stall.
        if self.goodput is not None:
            self.goodput.tick("other")
        self.saver.flush()
        if self.goodput is not None:
            self.goodput.tick("checkpoint")
        self.log("Finished!")

    @property
    def preempted(self) -> bool:
        """Whether the last ``train`` stopped for a SIGTERM (after its resumable save)."""
        return self._preempted

    # ------------------------------------------------------------------
    # Saves.
    # ------------------------------------------------------------------

    def _flush_saver_logged(self) -> None:
        """Flush the background saver, logging (not raising) a commit failure: for
        teardown, the emergency save's exit and the rollback, where raising would defeat
        the path's purpose."""
        err = self.saver.flush(raise_errors=False)
        if err is not None:
            self.log(f"background checkpoint commit failed: {err}", "error")

    def _save_checkpoint(self, name: str, epoch: int, *, loop_state: "Mapping | None" = None, wait: bool = False,
                         metrics: "Mapping | None" = None, best: bool = False, reason: str = "epoch") -> bool:
        """Every save site's one implementation: with ``async_checkpoint`` and not
        ``wait``, a snapshot here and the commit on the saver's thread; else (the
        preemption and watchdog saves) a flush of the saver and a commit here.
        ``best=True`` applies the manager's best-value rule; returns whether it saved.
        With telemetry: the goodput counters and the attempt ride the meta, the loop's
        stall goes to the ``checkpoint`` bucket, and a ``checkpoint_save`` is emitted."""
        if self.goodput is not None:
            self.goodput.tick("other")  # close the epoch glue
        meta = self._telemetry_meta()
        mode = "async" if (self._async_saves and not wait) else "sync"
        snapshot_s = save_s = None
        if mode == "async":
            if best:
                saved, snapshot_s = self.saver.maybe_save_best(metrics, self.state, epoch, loop_state=loop_state,
                                                               telemetry=meta)
            else:
                snapshot_s = self.saver.save_async(name, self.state, epoch, metrics=metrics, loop_state=loop_state,
                                                   telemetry=meta)
                saved = True
        else:
            saved = not best or self.checkpoints.best_improved(metrics)
            if saved:
                name = BEST if best else name
                save_s = self.saver.save_sync(name, self.state, epoch, metrics=metrics, loop_state=loop_state,
                                              telemetry=meta)
            if wait:
                self._flush_saver_logged()  # a prior background failure is reported, not raised
        if self.goodput is not None:
            self.goodput.tick("checkpoint" if saved else "other")
        if saved:
            fields = {"name": name, "epoch": epoch, "reason": reason, "mode": mode}
            if snapshot_s is not None:
                fields["snapshot_ms"] = snapshot_s * 1e3
            elif save_s is not None:
                fields["save_ms"] = save_s * 1e3
            if loop_state:
                fields["step_in_epoch"] = int(loop_state.get("step_in_epoch", 0))
            self.events.emit("checkpoint_save", **fields)
        return saved

    # ------------------------------------------------------------------
    # Chained windows, faults, the watchdog and preemption.
    # ------------------------------------------------------------------

    def _validate_chain_config(self) -> None:
        """Refuse or round the knobs that would drift from window boundaries
        (``trainer.py:1560-1600``)."""
        if self.chain_steps < 1:
            raise ValueError(f"chain_steps must be >= 1, got {self.chain_steps}")
        if self.chain_steps == 1:
            return
        if type(self).train_step is not Trainer.train_step:
            raise ValueError(
                "chain_steps > 1 requires the engine-backed default train_step: "
                f"{type(self).__name__} overrides train_step, which executes per-step Python the chained "
                "device program cannot call. Keep chain_steps=1, or move the customization into build_loss_fn "
                "(traced into the compiled step, chains fine)."
            )
        if self.log_every and self.log_every % self.chain_steps:
            raise ValueError(
                f"log_every ({self.log_every}) must be a multiple of chain_steps ({self.chain_steps}): intra-epoch "
                "loss syncs happen at window boundaries, so a non-multiple would silently drift the log cadence. "
                "Round log_every or chain_steps."
            )
        if self.preemption_check_every and self.preemption_check_every % self.chain_steps:
            rounded = -(-self.preemption_check_every // self.chain_steps) * self.chain_steps
            self.log(
                f"preemption_check_every={self.preemption_check_every} is not a multiple of "
                f"chain_steps={self.chain_steps} — rounded up to {rounded} so multi-host preemption votes land on "
                "window boundaries (they cannot fire mid-window).",
                "warning",
            )
            self.preemption_check_every = rounded
        if self.step_timeout:
            self.log(
                f"chain_steps={self.chain_steps}: the hung-step watchdog pats once per window, so its effective "
                f"timeout scales to step_timeout x chain_steps = {self.step_timeout * self.chain_steps}s."
            )

    def _chain_lead_singles(self, skip_steps: int) -> int:
        """Single steps before an epoch's first window: a mid-epoch resume at step k runs
        up to the next multiple of ``chain_steps`` singly, so windows sit where an
        uninterrupted run has them; with ``profile_dir`` the first epoch's traced steps
        ``[1, 1 + profile_steps)`` run singly too."""
        first_window_step = skip_steps
        if self.profile_dir is not None and not self._profiled and skip_steps <= 1:
            first_window_step = max(first_window_step, 2 + self.profile_steps)
        return -(-first_window_step // self.chain_steps) * self.chain_steps - skip_steps

    def _fault_active_in_window(self, epoch: int, start: int, stop: int) -> bool:
        return self.fault_plan is not None and self.fault_plan.active_in_window(epoch, start, stop)

    def _pat_watchdog(self, watchdog, timeout):
        """Arm the watchdog after the first completed step (the first includes warm-up and
        capture) and pat it after each step or window."""
        if not timeout:
            return watchdog
        if watchdog is None:
            # Fire 1: a SIGTERM and a preemption save; fire 2: the thread is wedged. The
            # patrol keeps heartbeats coming while the loop is stuck in a step.
            patrol = self._heartbeat_patrol if self._heartbeat_every_s and self.events.enabled else None
            watchdog = StepWatchdog(timeout, self._on_hung_step, max_fires=2, on_patrol=patrol).start()
        watchdog.pat()
        return watchdog

    def _inject_step_faults(self, batch, epoch: int, step: int):
        """The step seams of ``fault_plan``: a real SIGTERM, a hung step (a sleep of
        ``payload`` seconds), or a batch whose floating tensors are NaN; each firing is a
        ``fault_injection`` event."""
        fired_before = len(self.fault_plan.fired)
        self.fault_plan.maybe_sigterm(epoch=epoch, step=step)
        hang = self.fault_plan.fires("hang", epoch=epoch, step=step)
        if hang is not None:
            time.sleep(float(hang.payload or 0.0))
        if self.fault_plan.fires("nan_loss", epoch=epoch, step=step) is not None:
            batch = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v for k, v in batch.items()}
        if self.events.enabled:
            for kind, ctx in self.fault_plan.fired[fired_before:]:
                self.events.emit("fault_injection", kind=kind, **ctx)
        return batch

    def _slow_chip_seam(self, epoch: int, step_in_epoch: int) -> float:
        """The degraded-chip seam (JAX ``trainer.py:1755-1770``): a scheduled ``slow_chip``
        fault names a "chip", which in the port is a batch rank's index (``mesh.batch_index``;
        a rank drives one device), not a CUDA ordinal. Every rank asks the plan with every
        batch rank's index, so the plans' budgets stay equal; the named rank sleeps the delay
        before it stamps its arrival, and rank 0 writes the ``fault_injection`` record
        (``kind="slow_chip"``). Timing only: the numbers are untouched. Returns the seconds
        this rank slept."""
        slow = self.fault_plan.slow_chip(range(self.mesh.batch_extent), epoch=epoch)
        if slow is None:
            return 0.0
        chip, delay_s = slow
        self.events.emit("fault_injection", kind="slow_chip", epoch=epoch, step_in_epoch=step_in_epoch, device=chip,
                         delay_ms=delay_s * 1e3)
        if chip != self.mesh.batch_index or delay_s <= 0.0:
            return 0.0
        time.sleep(delay_s)
        return delay_s

    def _on_hung_step(self) -> None:
        """The watchdog's callback, on its thread: first a SIGTERM (the preemption save at
        the next boundary), then, if the loop is still stuck, exit 75 for a restart from
        the last checkpoint."""
        timeout = self._watchdog_timeout or self.step_timeout
        if self._hung_once:
            self.log(f"watchdog: still no progress {timeout}s after SIGTERM — main thread is wedged; "
                     "hard-exiting for scheduler restart (resume from the last checkpoint)", "error")
            os._exit(75)  # EX_TEMPFAIL
        self._hung_once = True
        self._hung_steps += 1
        self.log(f"watchdog: no step completed in {timeout}s — forcing a preemption-style resumable save",
                 "warning")
        self.events.emit("hung_step", timeout_s=timeout)
        os.kill(os.getpid(), signal.SIGTERM)

    def _on_preemption_signal(self, signum, frame) -> None:
        self._preempted = True  # the flag only: the save runs on the loop
        if callable(self._prev_sigterm):
            self._prev_sigterm(signum, frame)

    def _install_sigterm(self) -> None:
        if not self.save_on_preemption or self._sigterm_installed:
            return
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_preemption_signal)
            self._sigterm_installed = True
        except ValueError:
            pass  # not the main thread

    def _restore_sigterm(self) -> None:
        if self._sigterm_installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm or signal.SIG_DFL)
            except ValueError:
                pass
            self._sigterm_installed = False

    def _preemption_requested(self, step_in_epoch: int) -> bool:
        """One process reads its flag every step; with more, every rank takes part in the
        vote every ``preemption_check_every`` steps, so all stop at the same step."""
        if self.world_size == 1:
            return self._preempted
        cadence = self.preemption_check_every
        if not cadence or step_in_epoch % cadence != 0:
            return False
        return self._collective_preempt_flag()

    def _collective_preempt_flag(self) -> bool:
        """The OR of every rank's flag (an all-reduce over the world), the same on all."""
        if self.world_size == 1:
            return self._preempted
        on_card = torch.distributed.get_backend() == "nccl"
        flag = torch.tensor([1.0 if self._preempted else 0.0], device=self.device if on_card else "cpu")
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item())

    # ------------------------------------------------------------------
    # The epoch.
    # ------------------------------------------------------------------

    def _train_host_batches(self, skip: int):
        """The train loader's batches from ``skip`` on, through ``preprocess_batch`` (the
        first through ``_check_image_range`` too)."""
        loader = self.train_dataloader
        if skip and hasattr(loader, "iter_batches"):
            source = loader.iter_batches(skip)
        elif skip:
            import itertools

            source = itertools.islice(iter(loader), skip, None)
        else:
            source = iter(loader)
        batches = (self.preprocess_batch(b) for b in source)
        if not self._image_range_checked:
            batches = (self._check_image_range(b) for b in batches)
        return batches

    def train_epoch(self, epoch: int) -> dict:
        """One pass over the train loader (from a mid-epoch resume's step on); metrics stay
        on the device until the epoch's end (and each ``log_every``-th step), where they
        are read back at once. With ``chain_steps`` > 1 the steps run in windows (see the
        module docstring). With telemetry, the goodput meter attributes each unit's wall
        at the unit's boundary, and the window records ride the ``log_every`` syncs."""
        collected: "list[tuple[int, dict]]" = []
        skip = self._resume_step_in_epoch
        self._resume_step_in_epoch = 0
        step_in_epoch = skip
        executed = 0
        synced_entries, synced_steps = 0, 0
        t0 = time.perf_counter()
        num_batches = len(self.train_dataloader)
        chain = self.chain_steps
        tm = self.goodput
        if tm is not None:
            tm.tick("other")  # the epoch's preamble (validation, logging)
        rollback_fetch = skip > 0  # the first fetch after a mid-epoch resume skips trained batches
        tele_sync = [t0, 0]  # (perf_counter, executed) at the last sync point
        arrival_start = [t0]  # where this rank's next window wall starts (telemetry/straggler.py)
        sync_compiles = [self._compile_count()]
        epoch_compiles = sync_compiles[0]
        arrivals = [None]  # the last step's per-rank window walls (telemetry/straggler.py)
        if chain > 1:
            units = device_prefetch_chained(self._train_host_batches(skip), self.device, chain,
                                            lead_singles=self._chain_lead_singles(skip))
        elif skip:
            units = ((1, b) for b in device_prefetch(self._train_host_batches(skip), self.device))
        else:
            units = ((1, b) for b in self.device_batches(self.train_dataloader))
        self._epoch_interrupted = False
        cap = self._profile_capture
        watchdog = None
        watchdog_timeout = self.step_timeout * chain if self.step_timeout else None
        self._watchdog_timeout = watchdog_timeout

        def keep(n, metrics):
            arr = metrics.pop("_arrivals", None)
            if arr is not None:
                arrivals[0] = arr[-1] if n > 1 else arr
            collected.append((n, metrics))

        def sync_log_point():
            nonlocal synced_entries, synced_steps
            straggler = self._straggler_on and self.world_size > 1
            slept = self._slow_chip_seam(epoch, step_in_epoch) if straggler and self.fault_plan is not None else 0.0
            arrive = time.perf_counter()  # this rank reaches the sync: its window's host wall ends
            n_last, last = collected[-1]
            m = {k: float(v[-1]) if n_last > 1 else float(v) for k, v in last.items()}
            check = dict(m)
            if "nonfinite" in m:  # every step since the last sync, not only the latest
                check["nonfinite"] = float(sum(float(x["nonfinite"].sum()) for _, x in collected[synced_entries:]))
                synced_entries, synced_steps = len(collected), executed
            self._apply_nan_policy(check)
            rate = executed * self.batch_size / (time.perf_counter() - t0)
            self.log(f"  step {step_in_epoch}/{num_batches} {m} ({rate:.1f} rows/s)")
            if self.telemetry is None:
                return
            now = time.perf_counter()
            window_steps, window_s = executed - tele_sync[1], now - tele_sync[0]
            strag = {}
            if straggler:
                if arrivals[0] is not None:
                    strag = straggler_lib.arrival_fields(arrivals[0].tolist())
                self.engine.arrival_ms = (arrive - arrival_start[0]) * 1e3  # rides the next steps' all-reduce
                # An injected delay stays the slowed rank's own in the next window too: the
                # other ranks wait it out at that window's first collective.
                arrival_start[0] = now - slept
            tele_sync[0], tele_sync[1] = now, executed
            compiles = self._compile_count()
            compiled, sync_compiles[0] = compiles > sync_compiles[0], compiles
            if window_steps > 0:
                self._window_telemetry(epoch, step_in_epoch, executed, m, window_steps, window_s, compiled, strag)

        def tick_unit(builds_before: int, captures_before: int):
            # A unit that built the kernels or captured a graph paid the port's stand-in
            # for a compile; every other unit is productive step time.
            if self.telemetry is None:
                return
            builds = len(_build.builds) - builds_before
            captures = self.engine.captures - captures_before
            if tm is not None:
                tm.tick("compile" if builds or captures else "productive_step")
            if builds or captures:
                if epoch > self._start_epoch:
                    self._late_compiles += 1  # the steady state built or captured again
                if builds:
                    self.events.emit("compile", kind="nvcc_build", epoch=epoch, step_in_epoch=step_in_epoch,
                                     executables=builds, seconds=sum(_build.builds[builds_before:]))
                if captures:
                    self.events.emit("compile", kind="cuda_graph", epoch=epoch, step_in_epoch=step_in_epoch,
                                     executables=captures)

        try:
            interrupted = False
            for n, batch in units:
                if tm is not None:
                    tm.tick("restart_rollback" if rollback_fetch else "data_wait")
                rollback_fetch = False
                if self.preflight is not None and not self._preflight_done:
                    # Before the first dispatch, on the unit's exact shapes: the window when a
                    # full one can still run this epoch (an epoch shorter than one runs singles
                    # only). A predicted OOM raises out of the loop.
                    self._run_memory_preflight(n, batch, can_chain=chain > 1 and num_batches - step_in_epoch >= chain)
                    if tm is not None:
                        tm.tick("compile")
                builds_before, captures_before = len(_build.builds), self.engine.captures
                if self._probe_batch is None and self.telemetry is not None:
                    # Shapes only (meta tensors): the one-time FLOP probe's input.
                    self._probe_batch = {k: torch.empty(v.shape if n == 1 else v.shape[1:], dtype=v.dtype,
                                                        device="meta") for k, v in batch.items()}
                if n > 1 and not self._fault_active_in_window(epoch, step_in_epoch, step_in_epoch + n):
                    if self._preemption_requested(step_in_epoch):
                        interrupted = True
                        break
                    if cap is not None:
                        cap.maybe_start(step_in_epoch)
                    self.state, window_metrics = self.engine.train_steps_chained(self.state, batch, n)
                    keep(n, window_metrics)
                    step_in_epoch += n
                    executed += n
                    if cap is not None:
                        cap.maybe_stop(step_in_epoch)
                    watchdog = self._pat_watchdog(watchdog, watchdog_timeout)
                    if self.log_every and step_in_epoch % self.log_every == 0:
                        sync_log_point()
                    tick_unit(builds_before, captures_before)
                    continue
                singles = (batch,) if n == 1 else (self.engine.unstack_window(batch, i) for i in range(n))
                for b in singles:
                    if self.fault_plan is not None:
                        b = self._inject_step_faults(b, epoch, step_in_epoch)
                    if self._preemption_requested(step_in_epoch):
                        interrupted = True
                        break
                    self._maybe_profile(step_in_epoch)
                    if cap is not None:
                        cap.maybe_start(step_in_epoch)
                    self.state, metrics = self.train_step(self.state, b)
                    keep(1, metrics)
                    step_in_epoch += 1
                    executed += 1
                    if cap is not None:
                        cap.maybe_stop(step_in_epoch)
                    watchdog = self._pat_watchdog(watchdog, watchdog_timeout)
                    if self.log_every and step_in_epoch % self.log_every == 0:
                        sync_log_point()
                tick_unit(builds_before, captures_before)
                if interrupted:
                    break
            if interrupted:
                self._preempted = True
                self._epoch_interrupted = True
                self._interrupted_at_step = step_in_epoch
        except BaseException:
            # An open trace must be stopped (one profiler session a process), without its
            # analysis and without waiting on possibly hung device work.
            if cap is not None and cap.state == "tracing":
                cap.maybe_stop(step_in_epoch, force=True, abort=True)
            if self._profiled == "tracing":
                try:
                    stop_session(self._profile_session, None)
                except (OSError, RuntimeError):
                    pass
                self._profiled = True
            raise
        finally:
            if watchdog is not None:
                watchdog.stop()
            # On a break or an exception too: the prefetch thread stops now and drops the
            # batches it holds, not when the traceback that holds this frame goes (F10).
            units.close()
        self._maybe_profile(step_in_epoch, end_of_epoch=True)
        if cap is not None:  # close a capture still open (a short epoch); an interrupted
            cap.maybe_stop(step_in_epoch, force=True, abort=self._epoch_interrupted)  # one skips the analysis
        if not collected:
            return {}
        keys = list(collected[0][1])
        host: "list[dict]" = []
        for n, m in collected:
            cols = [m[k].reshape(-1).float().cpu().tolist() for k in keys]
            host.extend(dict(zip(keys, row)) for row in zip(*cols))
        if tm is not None:
            tm.tick("productive_step")  # the read-back waited for the steps in flight
        epoch_wall = time.perf_counter() - t0
        self._maybe_probe_mfu()  # once; books itself to `compile`
        out = self._aggregate_epoch_metrics(host, synced_steps)
        if self.telemetry is not None and executed:
            self._epoch_telemetry(epoch, step_in_epoch, executed, epoch_wall, out,
                                  compiled=self._compile_count() > epoch_compiles)
        return out

    # ------------------------------------------------------------------
    # Telemetry (``trainer.py:1139-1560`` of the JAX Trainer). Off, none of it runs;
    # on, it reads values at the existing sync points and never kills the run.
    # ------------------------------------------------------------------

    def _init_telemetry(self, telemetry, save_folder: str) -> None:
        self.telemetry = resolve_telemetry(telemetry)
        if self.telemetry is not None:
            self.events = EventLog(self.telemetry.events_path or os.path.join(save_folder, "telemetry", "events.jsonl"),
                                   process_index=self.rank)
            self.goodput = GoodputMeter() if self.telemetry.goodput else None
            self.anomaly_detector = self.telemetry.resolve_anomaly()
            self._flops_per_step = self.telemetry.flops_per_step
            self._peak_flops = telemetry_mfu.device_peak_flops(self.device)
        else:
            self.events = EventLog(None)
            self.goodput = None
            self.anomaly_detector = None
            self._flops_per_step = None
            self._peak_flops = None
        self._straggler_on = self.telemetry is not None and self.telemetry.straggler
        self._attempt = 0
        self._last_straggler: "dict | None" = None
        self._max_straggler_ratio: "float | None" = None
        self._anomaly_counts: "dict[str, int]" = {}
        self._hung_steps = 0
        self._late_compiles = 0
        self._start_epoch = 0
        self._heartbeat_every_s = float(self.telemetry.heartbeat_every_s or 0.0) if self.telemetry is not None else 0.0
        self._hb_lock = threading.Lock()
        self._hb_last_emit = 0.0
        self._hb_fields: dict = {}
        self.exporter = None
        self._status: dict = {}
        self._mfu_probed = False
        self._probe_batch = None
        self._last_step_ms = None
        self._last_scale_seen = None
        self._attempt_units = 0
        self._profile_session = None

    def _log_sharded_layout(self) -> None:
        """One line at construction on what the mesh did to the state: the parameters
        sharded and the per-device against the global param bytes (JAX ``trainer.py:
        969-993``). Silent without a sharded layout."""
        layout = self.state.layout
        if layout is not None and layout.record() is not None:
            self.log(layout.describe())

    # -- elastic resume (JAX trainer.py:995-1090) --------------------------

    def _peek_resume_checkpoint(self, snapshot_path, mesh, batch_size):
        """Resolve the resume checkpoint before the mesh is built: ``"latest_valid"`` to
        the newest checkpoint that validates (None on a first launch), and read its meta.
        When its sharding record covers another device count than this world: with
        ``mesh=None`` re-plan (``parallel.elastic.replan``: the mesh and ``accum_steps``
        for this world, the global batch unchanged); an explicit ``mesh`` is honoured and
        only the topology change is noted. Same-topology resumes and cold starts set
        nothing."""
        self._elastic_plan = None
        self._resume_meta = None
        self._resume_prevalidated = False
        self._topology_changed = False
        if snapshot_path is None:
            return None
        if snapshot_path == "latest_valid":
            if not self.checkpoints.checkpoint_names():
                self.log("no checkpoint to resume (latest_valid) — starting fresh")
                return None
            name = self.checkpoints.latest_valid_name()
            if name is None:
                raise CheckpointError(
                    f"no valid checkpoint under {self.checkpoints.directory} "
                    f"(invalid/corrupt: {self.checkpoints.checkpoint_names()})"
                )
            self._resume_prevalidated = True
            snapshot_path = name
        try:
            self._resume_meta = self.checkpoints.read_meta(snapshot_path)
        except (OSError, ValueError):  # the restore raises the canonical missing/corrupt error
            return snapshot_path
        record = self._resume_meta.get("sharding")
        if not record:
            return snapshot_path  # a replicated state: nothing to re-plan
        saved_axes = elastic_lib.record_axes(record)
        saved_devices = elastic_lib.axes_device_product(saved_axes)
        devices = self.world_size
        if saved_devices == devices:
            return snapshot_path
        self._topology_changed = True
        ckpt = os.path.basename(str(snapshot_path))
        if mesh is not None:
            self.log(f"resume checkpoint {ckpt!r} was written on {saved_devices} devices (mesh {saved_axes}); this "
                     f"world has {devices} — honoring the explicitly passed mesh (no re-plan; accumulation unchanged).")
            return snapshot_path
        self._elastic_plan = elastic_lib.replan(saved_axes, devices, batch_size=batch_size,
                                                accum_steps=self.accum_steps)
        self.accum_steps = self._elastic_plan.accum_steps
        self.log(f"elastic restore: checkpoint {ckpt!r} was written on {saved_devices} devices (mesh {saved_axes}); "
                 f"re-planned for {devices} devices as mesh {self._elastic_plan.new_axes} with "
                 f"accum_steps={self.accum_steps} (was {self._elastic_plan.old_accum_steps}) — same effective global "
                 "batch.")
        return snapshot_path

    def _emit_elastic_restore(self, snapshot_path) -> None:
        """One ``elastic_restore`` record per topology-changed resume, with the JAX
        Trainer's fields: the old and new mesh axes and device counts, the old and new
        accumulation factors, the reason, and whether the mesh was re-planned."""
        if not self._topology_changed:
            return
        plan = self._elastic_plan
        if plan is not None:
            fields = plan.event_fields()
        else:
            old_axes = elastic_lib.record_axes((self._resume_meta or {}).get("sharding") or {})
            fields = {
                "from_mesh": old_axes,
                "to_mesh": mesh_lib.mesh_axes(self.mesh),
                "from_devices": elastic_lib.axes_device_product(old_axes),
                "to_devices": self.world_size,
                "old_accum_steps": self.accum_steps,
                "accum_steps": self.accum_steps,
                "reason": "explicit mesh (no re-plan)",
            }
        self.events.emit("elastic_restore", name=os.path.basename(str(snapshot_path)), replanned=plan is not None,
                         **fields)

    def _emit_run_start(self) -> None:
        self._attempt = claim_attempt(self.save_folder)
        fields = dict(
            attempt=self._attempt,
            epoch=self.cur_epoch,
            max_epoch=self.max_epoch,
            step=int(self.state.step),
            resumed_step_in_epoch=self._resume_step_in_epoch,
            processes=self.world_size,
            devices=self.world_size,
            mesh={str(k): int(v) for k, v in self.mesh.shape.items()},
            batch_replicas=self.batch_replicas,
            chain_steps=self.chain_steps,
            compute_dtype=str(self.precision.compute_dtype).replace("torch.", ""),
        )
        if self.goodput is not None:
            fields["goodput_seconds"] = self.goodput.to_state()
        from distributed_training_pytorch_tpu_torch.telemetry.provenance import provenance_fields

        fields["provenance"] = provenance_fields(mesh=fields["mesh"], dtype=fields["compute_dtype"],
                                                 chain_steps=self.chain_steps, batch=self.batch_size)
        self.events.emit("run_start", **fields)
        from distributed_training_pytorch_tpu_torch.ops import dispatch

        dispatch.set_event_sink(self.events.emit)  # the kernel_dispatch decisions, buffered until now

    def _compile_count(self) -> int:
        """Builds of the kernels plus graph captures so far: what stands in for compiles."""
        return len(_build.builds) + self.engine.captures

    def _telemetry_meta(self) -> "dict | None":
        """The cumulative counters a checkpoint's meta carries: goodput and the attempt."""
        meta = {}
        if self.goodput is not None:
            meta["goodput"] = self.goodput.to_state()
        if self._attempt:
            meta["attempt"] = self._attempt
        return meta or None

    def _on_async_commit(self, name: str, seconds: float) -> None:
        """The saver's thread, after a background commit: ``checkpoint_async`` and a
        ``checkpoint_commit`` record."""
        if self.goodput is not None:
            self.goodput.account("checkpoint_async", seconds)
        self.events.emit("checkpoint_commit", name=name, commit_ms=seconds * 1e3)

    def _run_memory_preflight(self, n: int, batch, *, can_chain: bool) -> None:
        """The one-shot preflight on the first unit's shapes (``memory.run_preflight``),
        skipped with a warning under a ``train_step`` override."""
        self._preflight_done = True
        if type(self).train_step is not Trainer.train_step:
            self.log("memory preflight skipped: custom train_step override — the engine program the preflight "
                     "would trace is not the one this trainer dispatches", "warning")
            return
        per_step = {k: torch.empty(v.shape if n == 1 else v.shape[1:], dtype=v.dtype, device="meta")
                    for k, v in batch.items()}
        self.memory_report = run_preflight(
            self.engine, self.state, per_step, self.preflight, chain_length=self.chain_steps if can_chain else None,
            log=self.log, events=self.events, device=self.device,
            staged_units=_STAGED_UNITS if self.device.type == "cuda" else 0,
        )

    def _live_memory_fields(self) -> dict:
        if self.telemetry is None or not self.telemetry.memory:
            return {}
        return window_memory_fields(self.device)

    def _window_telemetry(self, epoch, step_in_epoch, executed, m, window_steps, window_s, compiled, strag) -> None:
        """A ``log_every`` sync's records: ``window`` (step time, MFU, memory, straggler),
        the heartbeat, the status snapshot, a loss-scale backoff, the anomaly checks."""
        report = telemetry_mfu.window_report(window_steps, window_s, flops_per_step=self._flops_per_step,
                                             peak_flops=self._peak_flops)
        self._last_step_ms = report["step_ms"]
        mem = self._live_memory_fields()
        if strag:
            strag["straggler_ratio"] = straggler_lib.ratio(strag["chip_skew_ms"], report["step_ms"])
            self._last_straggler = strag
            if self._max_straggler_ratio is None or strag["straggler_ratio"] > self._max_straggler_ratio:
                self._max_straggler_ratio = strag["straggler_ratio"]
        self.events.emit("window", epoch=epoch, step_in_epoch=step_in_epoch, **report, **mem, **strag)
        hb = {"epoch": epoch, "step_in_epoch": step_in_epoch, "units": self._attempt_units + executed,
              "step_ms": report["step_ms"]}
        if mem.get("live_bytes") is not None:
            hb["live_bytes"] = mem["live_bytes"]
        self._note_heartbeat_progress(**hb)
        self._emit_heartbeat("loop")
        extra = dict(step_in_epoch=step_in_epoch, units=hb["units"], **mem)
        for key, value in (("straggler_ratio", strag.get("straggler_ratio")), ("loss_scale", m.get("loss_scale")),
                           ("loss", m.get("loss"))):
            if value is not None:
                extra[key] = value
        self._update_status(**extra)
        scale = m.get("loss_scale")
        if scale is not None:
            if self._last_scale_seen is not None and scale < self._last_scale_seen:
                self.events.emit("loss_scale_backoff", epoch=epoch, step_in_epoch=step_in_epoch,
                                 from_scale=self._last_scale_seen, to_scale=scale)
            self._last_scale_seen = scale
        if self.anomaly_detector is not None:
            self._report_anomalies(
                self.anomaly_detector.observe(
                    step_in_epoch, loss=m.get("loss", m.get("ce_loss")), grad_norm=m.get("grad_norm"),
                    step_time=None if compiled else report["step_ms"] / 1e3,  # a build or capture skews it
                    live_bytes=mem.get("live_bytes"), straggler_ratio=strag.get("straggler_ratio"),
                ),
                epoch=epoch, step_in_epoch=step_in_epoch,
            )

    def _epoch_telemetry(self, epoch, step_in_epoch, executed, epoch_wall, out, *, compiled) -> None:
        """The epoch's end: ``epoch_end``, the heartbeat, the status, the anomaly checks."""
        report = telemetry_mfu.window_report(executed, epoch_wall, flops_per_step=self._flops_per_step,
                                             peak_flops=self._peak_flops)
        self._last_step_ms = report["step_ms"]
        health = {k: out[k] for k in ("loss", "ce_loss", "grad_norm", "update_ratio", "nonfinite", "moe_load_balance",
                                      "moe_router_z") if k in out}  # the routers' losses of an MoE LM
        mem = self._live_memory_fields()
        fields = {}
        if self.goodput is not None:
            fields["goodput_seconds"] = self.goodput.to_state()
        if self._last_straggler:
            fields["chip_skew_ms"] = self._last_straggler["chip_skew_ms"]
            fields["straggler_ratio"] = self._last_straggler["straggler_ratio"]
        self.events.emit("epoch_end", epoch=epoch, wall_s=epoch_wall, interrupted=self._epoch_interrupted, **report,
                         **health, **mem, **fields)
        self._attempt_units += executed
        self._note_heartbeat_progress(epoch=epoch, step_in_epoch=step_in_epoch, units=self._attempt_units,
                                      step_ms=report["step_ms"])
        self._emit_heartbeat("loop")
        self._update_status(step_in_epoch=step_in_epoch, units=self._attempt_units, **mem)
        if self.anomaly_detector is not None:
            self._report_anomalies(
                self.anomaly_detector.observe(
                    step_in_epoch, loss=out.get("loss", out.get("ce_loss")), grad_norm=out.get("grad_norm"),
                    step_time=None if compiled else report["step_ms"] / 1e3, live_bytes=mem.get("live_bytes"),
                ),
                epoch=epoch, step_in_epoch=step_in_epoch,
            )

    def _maybe_probe_mfu(self) -> None:
        """Count one step's FLOPs once, at the end of the first trained epoch
        (``utils/flops.py`` on the meta device: no work on the card, the same count on
        the CPU); skipped with an explicit ``flops_per_step``, with MFU off, or under a
        ``train_step`` override (the engine's step is then not what runs)."""
        if (self.telemetry is None or not self.telemetry.mfu or self._mfu_probed or self._flops_per_step is not None
                or self._probe_batch is None or type(self).train_step is not Trainer.train_step):
            return
        self._mfu_probed = True
        t0 = time.perf_counter()
        try:
            from distributed_training_pytorch_tpu_torch.utils.flops import step_flops

            flops = step_flops(self.state.model, self.engine.loss_fn, self._probe_batch)
        except Exception as e:  # noqa: BLE001 - telemetry must never kill a run
            self.log(f"telemetry: MFU probe failed ({e}) — per-window MFU disabled", "warning")
            return
        if self.goodput is not None:
            self.goodput.tick("compile")
        self._flops_per_step = flops or None
        self.events.emit("compile", kind="mfu_probe", seconds=time.perf_counter() - t0,
                         flops_per_step=self._flops_per_step)

    def _report_anomalies(self, anomalies, *, epoch=None, step_in_epoch=None) -> None:
        """Emit and log each finding; raise ``AnomalyError`` under ``action="raise"``."""
        if not anomalies:
            return
        for a in anomalies:
            self._anomaly_counts[a.kind] = self._anomaly_counts.get(a.kind, 0) + 1
            self.events.emit("anomaly", kind=a.kind, value=a.value, baseline=a.baseline, factor=a.factor, epoch=epoch,
                             step_in_epoch=step_in_epoch)
            self.log(f"telemetry anomaly: {a.describe()}", "warning")
        if self.anomaly_detector.action == "raise":
            from distributed_training_pytorch_tpu_torch.telemetry import AnomalyError

            raise AnomalyError("; ".join(a.describe() for a in anomalies))

    def _write_precision_scalars(self) -> None:
        """TensorBoard: a dynamic loss scale's scale and skipped steps."""
        scale = getattr(self.state, "loss_scale", None)
        if is_dynamic(scale):
            self.metrics_writer.write(int(self.state.step), {"loss_scale": float(scale.scale),
                                                             "skipped_steps": float(scale.skipped_steps)},
                                      prefix="precision")

    def _write_telemetry_scalars(self) -> None:
        """TensorBoard: goodput fractions, step time and MFU, straggler, the live doctor."""
        if self.telemetry is None:
            return
        step = int(self.state.step)
        if self.goodput is not None:
            self.metrics_writer.write(step, self.goodput.fractions(), prefix="goodput")
        if self._last_step_ms is not None:
            scalars = {"step_ms": self._last_step_ms}
            mfu = telemetry_mfu.mfu_value(self._flops_per_step, self._last_step_ms / 1e3, self._peak_flops)
            if mfu is not None:
                scalars["mfu"] = mfu
            self.metrics_writer.write(step, scalars, prefix="telemetry")
        if self._last_straggler:
            self.metrics_writer.write(step, {"skew_ms": self._last_straggler["chip_skew_ms"],
                                             "ratio": self._last_straggler["straggler_ratio"]}, prefix="straggler")
        self.metrics_writer.write(step, telemetry_doctor.scalar_fields(self._doctor_signals()), prefix="doctor")

    def _doctor_signals(self) -> "telemetry_doctor.Signals":
        """The doctor's inputs from this run's counters (what the event log would give)."""
        return telemetry_doctor.Signals(
            goodput_seconds=self.goodput.to_state() if self.goodput else None,
            anomaly_counts=dict(self._anomaly_counts),
            hung_steps=self._hung_steps,
            max_straggler_ratio=self._max_straggler_ratio,
            late_compiles=self._late_compiles,
        )

    def _emit_heartbeat(self, source: str, **extra) -> None:
        """The liveness pulse, at most once a ``heartbeat_every_s`` across the loop and
        the watchdog's thread: the last sync's progress and the goodput counters."""
        if not self._heartbeat_every_s or not self.events.enabled:
            return
        now = time.monotonic()
        with self._hb_lock:
            if now - self._hb_last_emit < self._heartbeat_every_s:
                return
            self._hb_last_emit = now
            fields = dict(self._hb_fields)
        fields.update(extra)
        if self._attempt:
            fields["attempt"] = self._attempt
        if self.goodput is not None:
            fields["goodput_seconds"] = self.goodput.to_state()
        self.events.emit("heartbeat", source=source, **fields)

    def _note_heartbeat_progress(self, **fields) -> None:
        with self._hb_lock:
            self._hb_fields = dict(fields)

    def _heartbeat_patrol(self, since_progress_s: float) -> None:
        """The watchdog thread's hook: heartbeats while the loop is stuck in a step."""
        self._emit_heartbeat("watchdog", since_progress_s=since_progress_s)

    def _update_status(self, **extra) -> None:
        """A fresh status snapshot for the exporter, swapped in by one assignment."""
        if self.exporter is None or not self.exporter.enabled:
            return
        scores = telemetry_doctor.scalar_fields(self._doctor_signals())
        verdict, worst = "healthy", 0.0
        for kind, score in scores.items():
            if kind != "healthy" and score >= 1.0 and score > worst:
                verdict, worst = kind, score
        snap = {"run_dir": self.save_folder, "pid": os.getpid(), "t_wall": time.time(), "phase": "training",
                "epoch": self.cur_epoch, "nonfinite_steps": self.nonfinite_steps, "hung_steps": self._hung_steps,
                "late_compiles": self._late_compiles, "anomaly_counts": dict(self._anomaly_counts),
                "doctor_scores": scores, "verdict": verdict}
        if self.goodput is not None:
            snap["goodput_seconds"] = self.goodput.to_state()
            snap["goodput_fractions"] = self.goodput.fractions()
            snap["steady_fractions"] = telemetry_doctor.steady_fractions(snap["goodput_seconds"])
        if self._last_step_ms is not None:
            snap["step_ms"] = self._last_step_ms
            mfu = telemetry_mfu.mfu_value(self._flops_per_step, self._last_step_ms / 1e3, self._peak_flops)
            if mfu is not None:
                snap["mfu"] = mfu
        snap.update(extra)
        self._status = snap

    def _maybe_profile(self, step_in_epoch: int, end_of_epoch: bool = False) -> None:
        """``profile_dir``: a raw trace of the first trained epoch's steps
        ``[1, 1 + profile_steps)`` (step 0 builds and warms up, and stays out)."""
        if self.profile_dir is None or self._profiled is True:
            return
        if self._profiled == "tracing" and (end_of_epoch or step_in_epoch >= 1 + self.profile_steps):
            stop_session(self._profile_session, self.device)
            self._profile_session = None
            self._profiled = True
            self.log(f"Profiler trace written to {self.profile_dir}")
        elif self._profiled is False and not end_of_epoch and step_in_epoch == 1 and self.rank == 0:
            self._profile_session = start_session(self.profile_dir, self.device)
            self._profiled = "tracing"

    def _aggregate_epoch_metrics(self, host: "list[dict]", synced: int = 0) -> dict:
        """Per-epoch means; under the non-finite guard the skipped steps are left out and
        ``nonfinite`` counts them. The policy check covers the steps after the last
        intra-epoch sync (``synced``): a poison handled there does not fire again."""
        if "nonfinite" not in host[0]:
            out = {k: float(np.mean([m[k] for m in host])) for k in host[0]}
            self._apply_nan_policy(out)
            return out
        bad = int(sum(m["nonfinite"] for m in host))
        self.nonfinite_steps += bad
        good = [m for m in host if not m["nonfinite"]]
        out = {
            k: float(np.mean([m[k] for m in good])) if good else float("nan")
            for k in host[0]
            if k != "nonfinite"
        }
        out["nonfinite"] = float(bad)
        check = dict(out)
        check["nonfinite"] = float(sum(m["nonfinite"] for m in host[synced:]))
        self._apply_nan_policy(check)
        return out

    def _apply_nan_policy(self, host_metrics: dict) -> None:
        """At host sync points only (``log_every``, the epoch's end): ``"raise"`` raises
        ``NonFiniteLossError``; ``"restore_last_good"`` flushes the background saves and
        restores the newest valid checkpoint (with none, it warns and goes on as
        ``"skip"``, whose guard already dropped the update)."""
        if self.nan_policy is None:
            return
        poisoned = host_metrics.get("nonfinite", 0.0) > 0 or any(not np.isfinite(v) for v in host_metrics.values())
        if not poisoned:
            return
        if self.nan_policy == "raise":
            raise NonFiniteLossError(
                f"non-finite training metrics: {host_metrics} (nan_policy='raise'; use 'skip' or "
                "'restore_last_good' to degrade gracefully)"
            )
        if self.nan_policy == "restore_last_good":
            self._flush_saver_logged()
            try:
                self.state, epoch, name = self.checkpoints.restore_latest_valid(self.state)
            except CheckpointError:
                self.log("non-finite step detected but no valid checkpoint exists yet — update was skipped, "
                         "training continues", "warning")
                return
            self.engine.drop_graphs()
            self.nonfinite_rollbacks += 1
            self.log(f"non-finite step detected — rolled state back to checkpoint {name!r} (epoch {epoch})",
                     "warning")

    def validate(self) -> dict:
        """Validation over the val loader: the mean of each metric over the real rows,
        each batch weighted by its global real-row count. A padded batch (fewer real rows
        than the global batch) warns once unless the trainer declares
        ``criterion_uses_mask = True``: metrics that ignore ``batch["mask"]`` count the
        padded rows (the JAX Trainer's warning, ``trainer.py:2396-2410``)."""
        sums: "dict[str, Any]" = {}
        weight_total = 0.0
        mask_contract_checked = False
        for b, batch in enumerate(self.device_batches(self.val_dataloader)):
            weight = float(self.val_dataloader.global_real_count(b))
            if not mask_contract_checked and "mask" in batch and weight < self.batch_size:
                mask_contract_checked = True
                if getattr(self, "criterion_uses_mask", None) is not True:
                    self.log(
                        "this validation batch is padded (batch['mask']): metrics must down-weight padded "
                        "rows (ops.metrics' weights=) or they are diluted. Set self.criterion_uses_mask = True "
                        "once your build_criterion handles the mask to silence this.",
                        "warning",
                    )
            metrics = self.validate_step(self.state, batch)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v.float() * weight
            weight_total += weight
        avg = {k: float(v) / max(weight_total, 1.0) for k, v in sums.items()}
        msg = "VALIDATE RESULTS: "
        for k, v in avg.items():
            msg += f" | {k} = {v} | "
        self.log(msg)
        return avg

    # ------------------------------------------------------------------
    # The hooks.
    # ------------------------------------------------------------------

    def build_train_dataset(self):
        raise NotImplementedError("Please implement the build_train_dataset method")

    def build_val_dataset(self):
        raise NotImplementedError("Please implement the build_val_dataset method")

    def build_model(self):
        raise NotImplementedError("Please implement the build_model method")

    def build_criterion(self):
        raise NotImplementedError("Please implement the build_criterion method")

    def build_optimizer(self, schedule):
        """A torch optimizer over ``self.model.parameters()``; the engine sets its
        learning rate from ``schedule`` before every step."""
        raise NotImplementedError("Please implement the build_optimizer method")

    def build_scheduler(self):
        """A ``schedule(step) -> lr`` function, or a constant lr."""
        raise NotImplementedError("Please implement the build_scheduler method")

    def build_sharding_rules(self):
        """The ``(name_regex, PartitionSpec)`` rules of ``parallel.sharding`` used when the
        constructor's ``sharding_rules="auto"`` (the default): ``parallel.sharding.
        default_sharding_rules(mesh)``, i.e. ``transformer_tp_rules()`` on a mesh with a
        ``tensor`` axis, else None (the FSDP fallback, or replicated). Override to place
        a custom model's parameters."""
        from distributed_training_pytorch_tpu_torch.parallel.sharding import default_sharding_rules

        return default_sharding_rules(self.mesh)

    def build_loss_fn(self):
        """The engine's ``LossFn``: by default the model, then ``build_criterion``'s
        ``(outputs, batch) -> (loss, metrics)``."""
        criterion = self.criterion

        def loss_fn(model, batch, train):
            return criterion(model(batch["image"]), batch)

        return loss_fn

    def preprocess_batch(self, batch: Mapping) -> Mapping:
        """Host-side batch hook, before the copy to the device; identity by default."""
        return batch

    def train_step(self, state, batch):
        """Default: the engine's step (forward, backward, all-reduce, update)."""
        return self.engine.train_step(state, batch)

    def validate_step(self, state, batch):
        """Default: the engine's eval step."""
        return self.engine.eval_step(state, batch)

    @staticmethod
    def distributed_setup(**kwargs) -> None:
        mesh_lib.setup_distributed(**kwargs)

    @staticmethod
    def destroy_process() -> None:
        mesh_lib.shutdown_distributed()
