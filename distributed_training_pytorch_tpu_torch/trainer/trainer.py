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
  (the engine's guard), ``"raise"`` stops at the next sync point.

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

What the JAX Trainer has and this one does not yet (each raises when asked for): chained
steps, telemetry, the profiler, the memory preflight, the hung-step watchdog, the
``restore_last_good`` policy, and the background saver; SIGTERM preemption saves and
elastic resume come with the resilience slice.
"""

from __future__ import annotations

import os
import time
from typing import Any, Mapping

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch._device import resolve_device
from distributed_training_pytorch_tpu_torch.checkpoint import (
    LAST,
    CheckpointManager,
    epoch_checkpoint_name,
)
from distributed_training_pytorch_tpu_torch.data import ShardedLoader
from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib
from distributed_training_pytorch_tpu_torch.precision import get_policy
from distributed_training_pytorch_tpu_torch.train import NonFiniteLossError, TrainEngine, TrainState

__all__ = ["Trainer"]

_UNPORTED = {
    "telemetry": "telemetry (the observability slice)",
    "profile": "the profiling capture (the observability slice)",
    "profile_dir": "the profiler trace (the observability slice)",
    "preflight": "the memory preflight (the observability slice)",
    "step_timeout": "the hung-step watchdog (the resilience slice)",
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
        log_every: int = 50,
        chain_steps: int = 1,
        last_save_period: int = 1,
        max_checkpoints_to_keep: "int | None" = None,
        nan_policy: "str | None" = None,
        precision=None,
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
        if int(chain_steps) > 1:
            raise NotImplementedError(
                "chain_steps > 1 (chained steps; a captured CUDA graph in the port) comes with a "
                "later slice of the port"
            )
        if nan_policy not in (None, "skip", "raise"):
            raise NotImplementedError(
                f"nan_policy={nan_policy!r}: the port has None, 'skip' and 'raise'; "
                "'restore_last_good' comes with the resilience slice"
            )
        self.max_epoch = max_epoch
        self.batch_size = batch_size
        self.have_validate = have_validate
        self.save_period = save_period
        self.seed = seed
        self.accum_steps = accum_steps
        self.log_every = log_every
        self.last_save_period = max(1, int(last_save_period))
        self.nan_policy = nan_policy
        self.nonfinite_steps = 0
        self.cur_epoch = 0
        self.device = resolve_device(device)

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
        self.precision_requested = precision is not None
        self.precision = get_policy(precision)

        self.save_folder = save_folder
        self.save_weight_folder = os.path.join(save_folder, "weights")
        self.checkpoints = CheckpointManager(
            self.save_weight_folder, save_best_for=save_best_for, max_to_keep=max_checkpoints_to_keep
        )

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
            nan_guard=nan_policy == "skip",
            precision=self.precision,
            mesh=self.mesh,
        )
        self.state = TrainState(model=self.model, optimizer=self.optimizer)

        if snapshot_path is not None:
            if snapshot_path == "latest_valid":
                self.state, self.cur_epoch, snapshot_path = self.checkpoints.restore_latest_valid(self.state)
            else:
                self.state, self.cur_epoch = self.checkpoints.restore(snapshot_path, self.state)
            self.log(f"Resumed from {snapshot_path} at epoch {self.cur_epoch}, step {self.state.step}")

    # ------------------------------------------------------------------
    # Framework-provided machinery (overridable).
    # ------------------------------------------------------------------

    def build_dataloader(self, dataset, phase: str = "train") -> ShardedLoader:
        """Deterministic global shuffle for train (trailing partial batch dropped);
        padded final batch with a ``mask`` for val. Rows are keyed by this process's data
        shard, so the seq ranks of one data shard see the same rows."""
        train = phase == "train"
        return ShardedLoader(
            dataset, self.batch_size, shuffle=train, seed=self.seed, drop_last=train, pad_final=not train,
            process_index=self.mesh.data_index, process_count=self.batch_replicas,
        )

    def to_device(self, batch: Mapping) -> dict:
        """A host batch as tensors on the trainer's device."""
        return {
            k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True) for k, v in batch.items()
        }

    # ------------------------------------------------------------------
    # Train / validate loops
    # ------------------------------------------------------------------

    def train(self) -> None:
        """The epoch loop."""
        best_banner = None
        for epoch in range(self.cur_epoch, self.max_epoch):
            self.cur_epoch = epoch
            if self.have_validate and self.save_period and epoch % self.save_period == 0:
                metrics = self.validate()
                if self.checkpoints.maybe_save_best(metrics, self.state, epoch):
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

            self.log(f"THE NEXT LEARNING RATE VALUE IS {float(self.schedule(self.state.step))}")
            if self.have_validate:
                if (epoch + 1) % self.last_save_period == 0 or epoch + 1 == self.max_epoch:
                    self.checkpoints.save(LAST, self.state, epoch + 1)
                    self.log(f"Saved model at epoch {epoch + 1}!")
            elif self.save_period and epoch % self.save_period == 0:
                self.checkpoints.save(epoch_checkpoint_name(epoch + 1), self.state, epoch + 1)
                self.log(f"Saved model at epoch {epoch + 1}!")
            msg = "TOTAL GLOBAL TRAINING LOSS: "
            for k, v in epoch_metrics.items():
                msg += f" | {k} = {v} | "
            self.log(msg)
        self.log("Finished!")

    def train_epoch(self, epoch: int) -> dict:
        """One pass over the train loader; metrics stay on the device until the epoch's
        end (and each ``log_every``-th step), where they are read back at once."""
        collected: "list[dict]" = []
        t0 = time.perf_counter()
        num_batches = len(self.train_dataloader)
        for step_in_epoch, host_batch in enumerate(self.train_dataloader, start=1):
            batch = self.to_device(self.preprocess_batch(host_batch))
            self.state, metrics = self.train_step(self.state, batch)
            collected.append(metrics)
            if self.log_every and step_in_epoch % self.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self._apply_nan_policy(m)
                rate = step_in_epoch * self.batch_size / (time.perf_counter() - t0)
                self.log(f"  step {step_in_epoch}/{num_batches} {m} ({rate:.1f} rows/s)")
        if not collected:
            return {}
        keys = list(collected[0])
        values = torch.stack([torch.stack([m[k].float().cpu() for k in keys]) for m in collected]).tolist()
        return self._aggregate_epoch_metrics([dict(zip(keys, row)) for row in values])

    def _aggregate_epoch_metrics(self, host: "list[dict]") -> dict:
        """Per-epoch means; under the non-finite guard the skipped steps are left out and
        ``nonfinite`` counts them."""
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
        return out

    def _apply_nan_policy(self, host_metrics: dict) -> None:
        if self.nan_policy != "raise":
            return
        if any(not np.isfinite(v) for v in host_metrics.values()):
            raise NonFiniteLossError(
                f"non-finite training metrics: {host_metrics} (nan_policy='raise'; use 'skip' to drop "
                "such steps)"
            )

    def validate(self) -> dict:
        """Validation over the val loader: the mean of each metric over the real rows,
        each batch weighted by its global real-row count."""
        sums: "dict[str, Any]" = {}
        weight_total = 0.0
        for b, host_batch in enumerate(self.val_dataloader):
            weight = float(self.val_dataloader.global_real_count(b))
            batch = self.to_device(self.preprocess_batch(host_batch))
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
