"""Train and eval steps.

Counterpart of ``distributed_training_pytorch_tpu/train/engine.py``. The JAX engine
compiles loss, ``jax.grad``, the gradient reduction and the optax update into one XLA
program over a mesh; here each step runs eagerly: forward and backward through the
model (whose attention is the flash kernels on the card), the gradient all-reduce of
``DistributedDataParallel`` when the world has more than one rank, and the torch
optimizer's update. What carries over exactly:

* the ``LossFn`` contract, ``(model, batch, train) -> (loss, metrics)``; the loss is cast
  to the precision policy's f32 output dtype at the boundary (``engine.py:307-338``);
* ``accum_steps`` micro-batch accumulation, equal to the full-batch step: the batch is
  split into ``accum_steps`` equal slices, each slice's loss is scaled by
  ``1 / accum_steps`` before its backward, and metrics are the slices' mean
  (``engine.py:340-387``);
* the ``nan_guard``: a step whose loss or gradients are not finite leaves params,
  optimizer state and the model's buffers (BatchNorm's running statistics, which the
  forward has already updated; the JAX engine keeps ``model_state``, ``engine.py:418-424``)
  as they were, still advances ``step``, and reports ``metrics["nonfinite"] = 1``
  (``engine.py:411-433``). Unlike the compiled guard it reads one flag back to the host
  per step;
* ``metrics["lr"]`` is the schedule at the pre-update step (``engine.py:440-441``), and
  that is the learning rate set on the optimizer for the update.

Metrics stay on the device as 0-d tensors; with more than one data shard they are averaged
over the mesh's data group, weighted by each shard's real rows (the seq ranks of one data
shard hold the same metrics, and take no part). With one sequence shard per rank, the
gradients and the loss are broadcast from the first rank of the seq group before the
update (``parallel.mesh.broadcast_over_seq``), so every seq rank takes the same step. The
JAX engine's ``train_steps_chained`` (several steps as one compiled program; a CUDA graph
in the port) comes with a later slice.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from distributed_training_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, broadcast_over_seq, process_count
from distributed_training_pytorch_tpu_torch.precision import get_policy
from distributed_training_pytorch_tpu_torch.train.state import TrainState, unwrap

__all__ = ["LossFn", "NonFiniteLossError", "TrainEngine"]

LossFn = Callable[[torch.nn.Module, Mapping[str, torch.Tensor], bool], "tuple[torch.Tensor, dict]"]


class NonFiniteLossError(FloatingPointError):
    """Raised by the trainer's ``nan_policy="raise"`` when a step's loss is not finite."""


class TrainEngine:
    """Owns the train/eval step of one model: a ``LossFn``, a torch optimizer over the
    model's parameters and an optional ``schedule(step) -> lr``. ``mesh`` (a
    ``parallel.mesh.Mesh``) names the data group metrics are averaged over; without one,
    every rank is a data shard."""

    def __init__(
        self,
        loss_fn: LossFn,
        *,
        accum_steps: int = 1,
        schedule: "Callable[[int], float] | None" = None,
        nan_guard: bool = False,
        precision=None,
        mesh=None,
    ):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.loss_fn = loss_fn
        self.accum_steps = int(accum_steps)
        self.schedule = schedule
        self.nan_guard = bool(nan_guard)
        self.precision = get_policy(precision)
        self.mesh = mesh

    # -- metrics ----------------------------------------------------------

    @staticmethod
    def _rows(batch) -> torch.Tensor:
        """This rank's real rows: the pad mask's sum, or the batch size."""
        if "mask" in batch:
            return batch["mask"].float().sum()
        first = next(iter(batch.values()))
        return torch.tensor(float(first.shape[0]), device=first.device)

    def _reduce(self, metrics: dict, batch) -> dict:
        """Across data shards: each metric's mean weighted by the shards' real rows (a no-op
        with one data shard)."""
        shards = process_count() if self.mesh is None else self.mesh.shape[DATA_AXIS]
        if shards == 1:
            return metrics
        keys = sorted(metrics)
        rows = self._rows(batch)
        packed = torch.stack([metrics[k].detach().float() * rows for k in keys] + [rows])
        dist.all_reduce(packed, group=None if self.mesh is None else self.mesh.data_group)
        total = torch.clamp(packed[-1], min=1.0)
        return {k: packed[i] / total for i, k in enumerate(keys)}

    # -- steps ------------------------------------------------------------

    def _loss(self, model, batch, train: bool):
        loss, metrics = self.loss_fn(model, batch, train)
        return self.precision.cast_output(loss), dict(metrics)

    def _grads_and_metrics(self, model, batch):
        if self.accum_steps == 1:
            loss, metrics = self._loss(model, batch, True)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}
        n = next(iter(batch.values())).shape[0]
        if n % self.accum_steps:
            raise ValueError(f"batch of {n} rows does not split into {self.accum_steps} micro-batches")
        size = n // self.accum_steps
        loss_sum, metric_sums = None, {}
        for i in range(self.accum_steps):
            micro = {k: v[i * size : (i + 1) * size] for k, v in batch.items()}
            last = i == self.accum_steps - 1
            sync = getattr(model, "no_sync", None)
            ctx = sync() if (sync is not None and not last) else contextlib.nullcontext()
            with ctx:
                loss, metrics = self._loss(model, micro, True)
                (loss / self.accum_steps).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            for k, v in metrics.items():
                metric_sums[k] = v.detach() + metric_sums.get(k, 0.0)
        inv = 1.0 / self.accum_steps
        return loss_sum * inv, {k: v * inv for k, v in metric_sums.items()}

    def train_step(self, state: TrainState, batch) -> "tuple[TrainState, dict]":
        """One optimizer step on this rank's rows of a global batch; updates ``state`` in
        place and returns it with the step's metrics (0-d tensors on the device)."""
        model, opt = state.model, state.optimizer
        model.train()
        lr = None
        if self.schedule is not None:
            lr = float(self.schedule(state.step))
            for group in opt.param_groups:
                group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        buffers = list(unwrap(model).buffers()) if self.nan_guard else []
        saved = [b.detach().clone() for b in buffers]  # the forward updates BN statistics
        loss, metrics = self._grads_and_metrics(model, batch)
        # The seq ranks of a data shard step with the gradients (and the guard with the
        # loss) of the first of them, so their model copies stay bit-equal.
        broadcast_over_seq([p.grad for p in unwrap(model).parameters()] + [loss], self.mesh)
        metrics.setdefault("loss", loss)
        metrics = self._reduce({**metrics, "_objective": loss}, batch)
        loss = metrics.pop("_objective")  # the differentiated loss, as the guard reads it
        if self.nan_guard:
            ok = torch.isfinite(loss)
            for p in unwrap(model).parameters():
                if p.grad is not None:
                    ok = ok & torch.isfinite(p.grad).all()
            if bool(ok):  # the guard's one host read per step
                opt.step()
            else:
                with torch.no_grad():
                    for b, before in zip(buffers, saved, strict=True):
                        b.copy_(before)
            metrics["nonfinite"] = (~ok).float()
        else:
            opt.step()
        state.step += 1
        if lr is not None:
            metrics["lr"] = torch.tensor(lr)
        return state, metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> dict:
        """Metrics of the model on this rank's rows, averaged across ranks by real rows."""
        model = unwrap(state.model)
        model.eval()
        _, metrics = self._loss(model, batch, False)
        return self._reduce(metrics, batch)
