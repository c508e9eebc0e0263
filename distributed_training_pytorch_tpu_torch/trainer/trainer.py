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
integer (the same, checked against the world size), or a built ``parallel.mesh.Mesh`` with
``data`` and ``seq`` axes, as the JAX ``Trainer(mesh=MeshConfig(...).build())`` takes it.
The global batch divides by the data extent; each data shard feeds its rows of it (the
ranks of one data shard, its seq shards, see the same rows), and a data axis of more than
one rank wraps the model in ``DistributedDataParallel`` over the data group. With one
sequence shard per rank, every seq rank holds the whole model: its copies are broadcast
from the seq group's first rank at build, and the engine broadcasts the gradients each
step, so they stay bit-equal (``parallel.mesh.broadcast_over_seq``). A model
reaches the seq axis through ``self.mesh`` in ``build_model``, for example
``GPTSmall(..., attention_impl="ring", mesh=self.mesh)``. Rank 0 saves.

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

What the JAX Trainer has and this one does not yet (each raises when asked for):
telemetry, the profiler, the memory preflight, elastic resume and ``TUNED``.
"""

from __future__ import annotations

import os
import signal
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
from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib
from distributed_training_pytorch_tpu_torch.precision import get_policy, is_dynamic, resolve_loss_scale
from distributed_training_pytorch_tpu_torch.resilience import AsyncCheckpointSaver
from distributed_training_pytorch_tpu_torch.train import NonFiniteLossError, TrainEngine, TrainState

__all__ = ["Trainer"]

_UNPORTED = {
    "telemetry": "telemetry (the observability slice)",
    "profile": "the profiling capture (the observability slice)",
    "profile_dir": "the profiler trace (the observability slice)",
    "preflight": "the memory preflight (the observability slice)",
}


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
        **unported,
    ):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(f"Trainer() got an unexpected keyword argument {name!r}")
            if value:
                raise NotImplementedError(f"{name}={value!r}: {_UNPORTED[name]} comes with a later slice of the port")
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
        self.chain_steps = int(chain_steps)
        self._validate_chain_config()

        self.rank = mesh_lib.process_index()
        self.world_size = mesh_lib.process_count()
        if mesh is not None and not isinstance(mesh, mesh_lib.Mesh) and int(mesh) != self.world_size:
            raise ValueError(f"mesh asks for {mesh} data-parallel ranks, the process group has {self.world_size}")
        self.mesh = mesh if isinstance(mesh, mesh_lib.Mesh) else mesh_lib.MeshConfig().build()
        # The batch divisor is the data extent (the JAX Trainer's batch_shard_extent), not
        # the world: the seq ranks of one data shard share its rows.
        self.batch_replicas = self.mesh.shape[mesh_lib.DATA_AXIS]
        if batch_size % self.batch_replicas:
            raise ValueError(
                f"global batch_size {batch_size} is not divisible by the mesh's {self.batch_replicas} data shards"
            )
        if self.chain_steps > 1 and self.device.type == "cuda" and self.batch_replicas > 1:
            raise NotImplementedError(
                "chained steps with more than one data rank on the card (DDP inside a CUDA graph) are not checked "
                "yet: ROADMAP.md Queue 1, 'chained steps with DDP on 4 cards'"
            )
        self.save_folder = save_folder
        self.save_weight_folder = os.path.join(save_folder, "weights")
        self.checkpoints = CheckpointManager(
            self.save_weight_folder, save_best_for=save_best_for, max_to_keep=max_checkpoints_to_keep,
            fault_plan=fault_plan,
        )
        self._async_saves = bool(async_checkpoint) and self.world_size == 1
        if async_checkpoint and self.world_size > 1:
            self.log(f"async_checkpoint with {self.world_size} processes: saves commit synchronously (each ends at "
                     "a barrier every rank reaches on the loop)")
        self.saver = AsyncCheckpointSaver(self.checkpoints)

        torch.manual_seed(seed)
        self.model = self.build_model().to(self.device)
        # One sequence shard per rank: the seq ranks' copies start from the first one's.
        mesh_lib.broadcast_over_seq([*self.model.parameters(), *self.model.buffers()], self.mesh)
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
        if self.batch_replicas > 1:
            device_ids = None
            if self.device.type == "cuda":
                device_ids = [self.device.index if self.device.index is not None else torch.cuda.current_device()]
            self.model = torch.nn.parallel.DistributedDataParallel(
                self.model, device_ids=device_ids, process_group=self.mesh.data_group
            )
        self.optimizer = self.build_optimizer(self.schedule)
        self.engine = TrainEngine(
            self.build_loss_fn(),
            accum_steps=accum_steps,
            schedule=self.schedule,
            nan_guard=nan_policy in ("skip", "restore_last_good"),
            precision=self.precision,
            mesh=self.mesh,
        )
        scale = self._initial_loss_scale
        self.state = TrainState(model=self.model, optimizer=self.optimizer,
                                loss_scale=scale.to(self.device) if is_dynamic(scale) else scale)

        if snapshot_path is not None:
            if snapshot_path == "latest_valid" and not self.checkpoints.checkpoint_names():
                snapshot_path = None  # the first launch of an automatic restart: nothing to resume
                self.log("no checkpoint to resume (latest_valid) — starting fresh")
            elif snapshot_path == "latest_valid":
                self.state, self.cur_epoch, snapshot_path = self.checkpoints.restore_latest_valid(self.state)
            else:
                self.state, self.cur_epoch = self.checkpoints.restore(snapshot_path, self.state)
        if snapshot_path is not None:
            meta = self.checkpoints.read_meta(snapshot_path)
            self._resume_step_in_epoch = int((meta.get("loop") or {}).get("step_in_epoch", 0))
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
            process_index=self.mesh.data_index, process_count=self.batch_replicas,
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
        background save is committed (or its error logged) before it returns."""
        self._install_sigterm()
        try:
            self._train_loop()
        finally:
            self._restore_sigterm()
            self._flush_saver_logged()
            self.saver.close()

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
                if self._save_checkpoint(BEST, epoch, metrics=metrics, best=True,
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
                self._save_checkpoint(LAST, resume_epoch, loop_state=loop_state, wait=True)
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
        self.saver.flush()  # every background commit on disk, its error raised, before "Finished"
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
                         metrics: "Mapping | None" = None, best: bool = False) -> bool:
        """Every save site's one implementation: with ``async_checkpoint`` and not
        ``wait``, a snapshot here and the commit on the saver's thread; else (the
        preemption and watchdog saves) a flush of the saver and a commit here.
        ``best=True`` applies the manager's best-value rule; returns whether it saved."""
        if self._async_saves and not wait:
            if best:
                return self.saver.maybe_save_best(metrics, self.state, epoch, loop_state=loop_state)[0]
            self.saver.save_async(name, self.state, epoch, metrics=metrics, loop_state=loop_state)
            return True
        if best:
            if not self.checkpoints.best_improved(metrics):
                return False
            name = BEST
        self.saver.save_sync(name, self.state, epoch, metrics=metrics, loop_state=loop_state)
        if wait:
            self._flush_saver_logged()  # a prior background failure is reported, not raised
        return True

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
        uninterrupted run has them."""
        return -(-skip_steps // self.chain_steps) * self.chain_steps - skip_steps

    def _fault_active_in_window(self, epoch: int, start: int, stop: int) -> bool:
        return self.fault_plan is not None and self.fault_plan.active_in_window(epoch, start, stop)

    def _pat_watchdog(self, watchdog, timeout):
        """Arm the watchdog after the first completed step (the first includes warm-up and
        capture) and pat it after each step or window."""
        if not timeout:
            return watchdog
        if watchdog is None:
            # Fire 1: a SIGTERM and a preemption save; fire 2: the thread is wedged.
            watchdog = StepWatchdog(timeout, self._on_hung_step, max_fires=2).start()
        watchdog.pat()
        return watchdog

    def _inject_step_faults(self, batch, epoch: int, step: int):
        """The step seams of ``fault_plan``: a real SIGTERM, a hung step (a sleep of
        ``payload`` seconds), or a batch whose floating tensors are NaN."""
        self.fault_plan.maybe_sigterm(epoch=epoch, step=step)
        hang = self.fault_plan.fires("hang", epoch=epoch, step=step)
        if hang is not None:
            time.sleep(float(hang.payload or 0.0))
        if self.fault_plan.fires("nan_loss", epoch=epoch, step=step) is not None:
            batch = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v for k, v in batch.items()}
        return batch

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
        self.log(f"watchdog: no step completed in {timeout}s — forcing a preemption-style resumable save",
                 "warning")
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
        module docstring)."""
        collected: "list[tuple[int, dict]]" = []
        skip = self._resume_step_in_epoch
        self._resume_step_in_epoch = 0
        step_in_epoch = skip
        executed = 0
        synced_entries, synced_steps = 0, 0
        t0 = time.perf_counter()
        num_batches = len(self.train_dataloader)
        chain = self.chain_steps
        if chain > 1:
            units = device_prefetch_chained(self._train_host_batches(skip), self.device, chain,
                                            lead_singles=self._chain_lead_singles(skip))
        elif skip:
            units = ((1, b) for b in device_prefetch(self._train_host_batches(skip), self.device))
        else:
            units = ((1, b) for b in self.device_batches(self.train_dataloader))
        self._epoch_interrupted = False
        watchdog = None
        watchdog_timeout = self.step_timeout * chain if self.step_timeout else None
        self._watchdog_timeout = watchdog_timeout

        def sync_log_point():
            nonlocal synced_entries, synced_steps
            n_last, last = collected[-1]
            m = {k: float(v[-1]) if n_last > 1 else float(v) for k, v in last.items()}
            check = dict(m)
            if "nonfinite" in m:  # every step since the last sync, not only the latest
                check["nonfinite"] = float(sum(float(x["nonfinite"].sum()) for _, x in collected[synced_entries:]))
                synced_entries, synced_steps = len(collected), executed
            self._apply_nan_policy(check)
            rate = executed * self.batch_size / (time.perf_counter() - t0)
            self.log(f"  step {step_in_epoch}/{num_batches} {m} ({rate:.1f} rows/s)")

        try:
            interrupted = False
            for n, batch in units:
                if n > 1 and not self._fault_active_in_window(epoch, step_in_epoch, step_in_epoch + n):
                    if self._preemption_requested(step_in_epoch):
                        interrupted = True
                        break
                    self.state, window_metrics = self.engine.train_steps_chained(self.state, batch, n)
                    collected.append((n, window_metrics))
                    step_in_epoch += n
                    executed += n
                    watchdog = self._pat_watchdog(watchdog, watchdog_timeout)
                    if self.log_every and step_in_epoch % self.log_every == 0:
                        sync_log_point()
                    continue
                singles = (batch,) if n == 1 else (self.engine.unstack_window(batch, i) for i in range(n))
                for b in singles:
                    if self.fault_plan is not None:
                        b = self._inject_step_faults(b, epoch, step_in_epoch)
                    if self._preemption_requested(step_in_epoch):
                        interrupted = True
                        break
                    self.state, metrics = self.train_step(self.state, b)
                    collected.append((1, metrics))
                    step_in_epoch += 1
                    executed += 1
                    watchdog = self._pat_watchdog(watchdog, watchdog_timeout)
                    if self.log_every and step_in_epoch % self.log_every == 0:
                        sync_log_point()
                if interrupted:
                    break
            if interrupted:
                self._preempted = True
                self._epoch_interrupted = True
                self._interrupted_at_step = step_in_epoch
        finally:
            if watchdog is not None:
                watchdog.stop()
        if not collected:
            return {}
        keys = list(collected[0][1])
        host: "list[dict]" = []
        for n, m in collected:
            cols = [m[k].reshape(-1).float().cpu().tolist() for k in keys]
            host.extend(dict(zip(keys, row)) for row in zip(*cols))
        return self._aggregate_epoch_metrics(host, synced_steps)

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
