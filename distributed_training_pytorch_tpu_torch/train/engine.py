"""Train and eval steps, single and chained.

Counterpart of ``distributed_training_pytorch_tpu/train/engine.py``. The JAX engine
compiles loss, ``jax.grad``, the gradient reduction and the optax update into one XLA
program over a mesh; here a step runs forward and backward through the model (whose
attention and 1x1 convolutions are the hand kernels on the card), the gradient all-reduce
of ``DistributedDataParallel`` when the data axis has more than one rank, and the torch
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
  (``engine.py:411-433``);
* dynamic loss scaling (``state.loss_scale`` a ``DynamicScale``; ``engine.py:310-330``,
  ``:404-431``): the loss is multiplied by the scale before ``backward`` and the gradients
  divided by it after (the accumulated micro-batch gradients once); the guard runs whether
  or not ``nan_guard`` is set, its flag is the protocol's ``grads_finite``, and the scale's
  next state is computed on the device, in place; ``metrics["loss_scale"]`` is the scale
  this step used;
* ``metrics["lr"]`` is the schedule at the pre-update step (``engine.py:440-441``), and
  that is the learning rate of the update;
* ``train_steps_chained`` (``engine.py:485-550``): one call runs a window of ``length``
  steps on a batch whose tensors carry a leading step axis, returns per-step metrics with
  that leading axis, and is bit-identical to ``length`` calls of ``train_step``.

**One step body.** ``train_step`` and every step of a chained window run
``_step_body`` with the same optimizer implementation, so that a window can be one CUDA
graph: nothing in the body reads a value back to the host. An optimizer with a fused
form (``torch.optim.SGD``, ``Adam``, ``AdamW``) runs it, with its learning rate a 0-d f32
tensor on the device, written by the host before each step or window; the guard's skip is
the fused kernels' ``found_inf`` (params, moments and Adam's step count stay as they
were) and a select for the model's buffers. SGD's momentum buffers are made zeros before
the first step when ``dampening`` is 0: the fused kernel's first step, which copies the
gradient, would otherwise leave a skipped first step's buffers unwritten; a zero buffer
gives the same first step. Another optimizer keeps a float learning rate and the guard's
one host read per step, and can be chained off the card only.

**The chained window on the card** is one captured CUDA graph of ``length`` step bodies,
replayed once a window on the current stream. Its inputs are static: the window's batches
are copied into the graph's ``[length, ...]`` buffers on the current stream (ordered after
the replay that last read them) and its learning rates into a static ``[length]`` tensor.
A capture needs a real window first: the first window of a shape (and the first after a
restore) runs its steps eagerly on the capture stream, and they count; the graph is
captured after them and replayed from the next window on. A restore replaces the
optimizer's moment tensors, so the graph is keyed by ``TrainState.generation`` and
captured again after one. A failed capture raises; there is no fallback to eager. With
more than one data rank on the card chaining raises ``NotImplementedError`` (DDP inside a
graph is not checked yet); off the card a window runs its steps as a loop.

Metrics stay on the device as tensors; with more than one data shard they are averaged
over the mesh's data group, weighted by each shard's real rows (the seq ranks of one data
shard hold the same metrics, and take no part). With one sequence shard per rank, the
gradients and the loss are broadcast from the first rank of the seq group before the
update (``parallel.mesh.broadcast_over_seq``), so every seq rank takes the same step.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from distributed_training_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, broadcast_over_seq, process_count
from distributed_training_pytorch_tpu_torch.precision import get_policy, is_dynamic
from distributed_training_pytorch_tpu_torch.train.state import TrainState, unwrap

__all__ = ["LossFn", "NonFiniteLossError", "TrainEngine"]

LossFn = Callable[[torch.nn.Module, Mapping[str, torch.Tensor], bool], "tuple[torch.Tensor, dict]"]

_FUSED_FORM = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW)


class NonFiniteLossError(FloatingPointError):
    """Raised by the trainer's ``nan_policy="raise"`` when a step's loss is not finite."""


@contextlib.contextmanager
def _capturable(opt):
    """Adam's ``capturable`` flag for the capture (its graph check reads it; the fused
    kernels ignore it)."""
    saved = [g.get("capturable") for g in opt.param_groups]
    for g in opt.param_groups:
        if "capturable" in g:
            g["capturable"] = True
    try:
        yield
    finally:
        for g, c in zip(opt.param_groups, saved, strict=True):
            if c is not None:
                g["capturable"] = c


class _Window:
    """One captured window: the graph, its static batch and learning rates, its metrics."""

    def __init__(self, key, graph, batch, lrs, metrics):
        self.key, self.graph, self.batch, self.lrs, self.metrics = key, graph, batch, lrs, metrics


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
        self._prepared = None  # (optimizer, generation) the fused form was set up for
        self._fused = False
        self._lr = None  # the single step's device learning rate
        self._window: "_Window | None" = None
        self._stream = None  # the capture stream
        self.captures = 0

    # -- metrics ----------------------------------------------------------

    @staticmethod
    def _rows(batch) -> torch.Tensor:
        """This rank's real rows: the pad mask's sum, or the batch size."""
        if "mask" in batch:
            return batch["mask"].float().sum()
        first = next(iter(batch.values()))
        return torch.tensor(float(first.shape[0]), device=first.device)

    def _data_shards(self) -> int:
        return process_count() if self.mesh is None else self.mesh.shape[DATA_AXIS]

    def _reduce(self, metrics: dict, batch) -> dict:
        """Across data shards: each metric's mean weighted by the shards' real rows (a no-op
        with one data shard)."""
        if self._data_shards() == 1:
            return metrics
        keys = sorted(metrics)
        rows = self._rows(batch)
        packed = torch.stack([metrics[k].detach().float() * rows for k in keys] + [rows])
        dist.all_reduce(packed, group=None if self.mesh is None else self.mesh.data_group)
        total = torch.clamp(packed[-1], min=1.0)
        return {k: packed[i] / total for i, k in enumerate(keys)}

    # -- the optimizer's form -----------------------------------------------

    def _prepare(self, state: TrainState) -> None:
        """Once per optimizer and restore: the fused form (see the module docstring), Adam's
        step counts on the params' device, SGD's zero momentum buffers."""
        opt = state.optimizer
        if self._prepared == (opt, state.generation):
            return
        self._prepared = (opt, state.generation)
        self._fused = type(opt) in _FUSED_FORM and not any(g.get("differentiable") for g in opt.param_groups)
        if not self._fused:
            return
        for group in opt.param_groups:
            if group.get("fused") is not True and (group.get("foreach") is not None or group.get("fused") is not None):
                warnings.warn(f"{type(opt).__name__}(foreach={group.get('foreach')}, fused={group.get('fused')}): "
                              "the engine runs the fused form (fused=True, foreach=False), so that the single step "
                              "and the chained window run one implementation", stacklevel=3)
            group["fused"], group["foreach"] = True, False
            for p in group["params"]:
                st = opt.state[p]
                if "step" in st and torch.is_tensor(st["step"]):
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
                if isinstance(opt, torch.optim.SGD) and group["momentum"] and not group["dampening"]:
                    if st.get("momentum_buffer") is None:
                        st["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        device = next(p.device for g in opt.param_groups for p in g["params"])
        if self._lr is None or self._lr.device != device:
            self._lr = torch.zeros((), dtype=torch.float32, device=device)

    def _set_lr(self, opt, lr) -> None:
        for group in opt.param_groups:
            group["lr"] = lr

    # -- steps ------------------------------------------------------------

    def _loss(self, model, batch, train: bool):
        loss, metrics = self.loss_fn(model, batch, train)
        return self.precision.cast_output(loss), dict(metrics)

    def _grads_and_metrics(self, model, batch, scale=None):
        """Forward and backward; with a dynamic ``scale`` the differentiated loss is
        scaled, the gradients unscaled, and the returned loss is the unscaled one."""
        objective = (lambda loss: loss) if scale is None else scale.scale_loss
        if self.accum_steps == 1:
            loss, metrics = self._loss(model, batch, True)
            objective(loss).backward()
            if scale is not None:
                scale.unscale_grads([p.grad for p in unwrap(model).parameters()])
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
                (objective(loss) / self.accum_steps).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            for k, v in metrics.items():
                metric_sums[k] = v.detach() + metric_sums.get(k, 0.0)
        if scale is not None:
            scale.unscale_grads([p.grad for p in unwrap(model).parameters()])
        inv = 1.0 / self.accum_steps
        return loss_sum * inv, {k: v * inv for k, v in metric_sums.items()}

    def _step_body(self, state: TrainState, batch, lr) -> dict:
        """One optimizer step at learning rate ``lr`` (a 0-d device tensor for a fused
        optimizer, else a float, or None without a schedule); the metrics. It does not
        advance ``state.step``. With a fused optimizer it reads nothing back to the host."""
        model, opt = state.model, state.optimizer
        model.train()
        if lr is not None:
            self._set_lr(opt, lr)
        opt.zero_grad(set_to_none=True)
        dynamic = is_dynamic(state.loss_scale)
        guard = self.nan_guard or dynamic  # one guard: an overflow and a NaN are one skip
        buffers = list(unwrap(model).buffers()) if guard else []
        saved = [b.detach().clone() for b in buffers]  # the forward updates BN statistics
        loss, metrics = self._grads_and_metrics(model, batch, state.loss_scale if dynamic else None)
        # The seq ranks of a data shard step with the gradients (and the guard with the
        # loss) of the first of them, so their model copies stay bit-equal.
        broadcast_over_seq([p.grad for p in unwrap(model).parameters()] + [loss], self.mesh)
        metrics.setdefault("loss", loss)
        metrics = self._reduce({**metrics, "_objective": loss}, batch)
        loss = metrics.pop("_objective")  # the differentiated loss, as the guard reads it
        if guard:
            ok = torch.isfinite(loss)
            for p in unwrap(model).parameters():
                if p.grad is not None:
                    ok = ok & torch.isfinite(p.grad).all()
            if self._fused:
                opt.found_inf = (~ok).float()  # the fused kernels skip on it
                try:
                    opt.step()
                finally:
                    opt.found_inf = None
                with torch.no_grad():
                    for b, before in zip(buffers, saved, strict=True):
                        b.copy_(torch.where(ok, b, before))
            elif bool(ok):  # an optimizer without a fused form: one host read
                opt.step()
            else:
                with torch.no_grad():
                    for b, before in zip(buffers, saved, strict=True):
                        b.copy_(before)
            metrics["nonfinite"] = (~ok).float()
            if dynamic:
                metrics["loss_scale"] = state.loss_scale.scale.clone()  # the scale this step used
                state.loss_scale.adjust(ok)
        else:
            opt.step()
        if lr is not None:
            metrics["lr"] = lr.clone() if torch.is_tensor(lr) else torch.tensor(lr)
        return metrics

    def _host_lr(self, step: int) -> "float | None":
        return None if self.schedule is None else float(self.schedule(step))

    def train_step(self, state: TrainState, batch) -> "tuple[TrainState, dict]":
        """One optimizer step on this rank's rows of a global batch; updates ``state`` in
        place and returns it with the step's metrics (0-d tensors on the device)."""
        self._prepare(state)
        lr = self._host_lr(state.step)
        if lr is not None and self._fused:
            self._lr.fill_(lr)
            lr = self._lr
        metrics = self._step_body(state, batch, lr)
        state.step += 1
        return state, metrics

    def unstack_window(self, stacked_batch, index: int) -> dict:
        """Step ``index``'s batch of a window (views of the stacked tensors)."""
        return {k: v[index] for k, v in stacked_batch.items()}

    def train_steps_chained(self, state: TrainState, stacked_batch, length: int) -> "tuple[TrainState, dict]":
        """``length`` train steps on ``stacked_batch`` (each tensor ``[length, ...]``) in
        one call: per-step metrics with a leading axis ``length``, bit-identical to
        ``length`` calls of :meth:`train_step`. On the card: one replay of a captured CUDA
        graph (see the module docstring); off it, a loop."""
        length = int(length)
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        first = next(iter(stacked_batch.values()))
        if first.shape[0] != length:
            raise ValueError(f"the window's batch has {first.shape[0]} steps, not {length}")
        if first.device.type != "cuda":
            return self._loop(state, stacked_batch, length)
        if self._data_shards() > 1:
            raise NotImplementedError(
                "chained steps with more than one data rank on the card (DDP inside a CUDA graph) are not "
                "checked yet: ROADMAP.md Queue 1, 'chained steps with DDP on 4 cards'"
            )
        self._prepare(state)
        if not self._fused:
            raise NotImplementedError(
                f"chained steps on the card need an optimizer with a fused form (SGD, Adam, AdamW), not "
                f"{type(state.optimizer).__name__}: its learning rate must be a device tensor inside the graph"
            )
        key = (length, tuple((k, tuple(v.shape), v.dtype) for k, v in stacked_batch.items()), id(state.model),
               id(state.optimizer), state.generation, id(state.loss_scale), torch.is_grad_enabled())
        lrs = [self._host_lr(state.step + i) for i in range(length)]
        if self._window is None or self._window.key != key:
            self._window = None  # the old graph's pool goes with it
            metrics = self._warm_window_and_capture(state, stacked_batch, length, lrs, key)
        else:
            w = self._window
            for k, v in stacked_batch.items():
                w.batch[k].copy_(v)  # after the replay that last read it: the same stream
            if lrs[0] is not None:
                w.lrs.copy_(torch.tensor(lrs, dtype=torch.float32).pin_memory(), non_blocking=True)
            w.graph.replay()
            metrics = {k: v.clone() for k, v in w.metrics.items()}
        state.step += length
        return state, metrics

    def _loop(self, state, stacked_batch, length):
        per_step = []
        for i in range(length):
            state, m = self.train_step(state, self.unstack_window(stacked_batch, i))
            per_step.append(m)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    def _warm_window_and_capture(self, state, stacked_batch, length, lrs, key) -> dict:
        """The window's steps run for real on the capture stream (lazy initialisations
        happen there), then the graph is captured; returns the real steps' metrics."""
        device = next(iter(stacked_batch.values())).device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            for v in stacked_batch.values():
                v.record_stream(self._stream)
            per_step = []
            for i in range(length):
                lr = lrs[i]
                if lr is not None:
                    self._lr.fill_(lr)
                    lr = self._lr
                per_step.append(self._step_body(state, self.unstack_window(stacked_batch, i), lr))
                state.step += 1
            metrics = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
        current.wait_stream(self._stream)
        for v in metrics.values():
            v.record_stream(current)
        state.step -= length  # the caller advances it

        static = {k: torch.empty_like(v) for k, v in stacked_batch.items()}
        static_lrs = torch.zeros(length, dtype=torch.float32, device=device)
        graph = torch.cuda.CUDAGraph()
        with _capturable(state.optimizer):
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                body = [
                    self._step_body(state, self.unstack_window(static, i), static_lrs[i] if lrs[0] is not None else None)
                    for i in range(length)
                ]
                out = {k: torch.stack([m[k] for m in body]) for k in body[0]}
        self._window = _Window(key, graph, static, static_lrs, out)
        self.captures += 1
        return metrics

    def drop_graphs(self) -> None:
        """Forget the captured window (the next window is warmed and captured again)."""
        self._window = None
        self._prepared = None

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> dict:
        """Metrics of the model on this rank's rows, averaged across ranks by real rows."""
        model = unwrap(state.model)
        model.eval()
        _, metrics = self._loss(model, batch, False)
        return self._reduce(metrics, batch)
