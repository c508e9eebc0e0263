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

**On meta tensors** (the memory trace of ``memory/analysis.py``, under
``ops.dispatch.allocation_route``) a step runs the same body, with what the card's route
allocates and nothing it computes: a fused optimizer's step is its allocation twin (the
state the fused kernel creates at its first step, nothing else), the collectives are
skipped, and a chained window runs as the card runs it: the warm window's steps, the
graph's static inputs, then the captured bodies once more, eagerly.

``stats=True`` (telemetry) adds the health statistics of ``telemetry/stats.py`` to every
train step's metrics (``grad_norm``, ``param_norm``, ``update_ratio``, ``nonfinite``; the
guard's ``nonfinite`` wins), computed in ``_step_body``, so a window's graph captures them;
they read no value back to the host and leave the params bit-equal to a stats-off run.
The update's norm comes from one persistent snapshot of the params (``HealthStats``), as
many bytes as the params.

Metrics stay on the device as tensors; with more than one batch shard they are averaged
over the mesh's batch group (``data x fsdp``), weighted by each shard's real rows (the seq
and tensor ranks of one batch shard hold the same metrics, and take no part).

**Sharded state** (JAX ``engine.py:138-171``, ``:216-225``): ``sharding_rules`` and
``fsdp_min_size`` are the ``parallel.sharding`` rules and the FSDP cutoff, and
:meth:`TrainEngine.shard_model` lays a model out on a mesh with an ``fsdp`` or ``tensor``
axis (``parallel.layout.ShardedLayout``; the trainer builds the optimizer over its
shards). A step on such a state averages the gradients over the batch shards with the
layout's reduction in place of DDP's, and the guard's finite flag is and-ed over the world,
so every rank takes or skips the same step. Without an ``fsdp`` or ``tensor`` axis nothing
of this runs: the step is DDP's, as before. The health stats and chained steps on the card
refuse a sharded state. With one sequence shard (or pipeline stage) per rank, the
gradients and the loss are broadcast from the first rank of the seq (or pipe) group before
the update (``parallel.mesh.broadcast_over_copies``), so every rank of it takes the same
step.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Mapping

import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

from distributed_training_pytorch_tpu_torch.ops.dispatch import allocation_route_active
from distributed_training_pytorch_tpu_torch.parallel.mesh import broadcast_over_copies, process_count
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
        stats: bool = False,
        sharding_rules=None,
        fsdp_min_size: int = 2**18,
    ):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.loss_fn = loss_fn
        self.accum_steps = int(accum_steps)
        self.schedule = schedule
        self.nan_guard = bool(nan_guard)
        self.precision = get_policy(precision)
        self.mesh = mesh
        self.sharding_rules = sharding_rules
        self.fsdp_min_size = int(fsdp_min_size)
        self._prepared = None  # (optimizer, generation) the fused form was set up for
        self._fused = False
        self._meta = False  # the params are meta tensors: the memory trace
        self._lr = None  # the single step's device learning rate
        self._window: "_Window | None" = None
        self._stream = None  # the capture stream
        self.captures = 0
        self.stats = bool(stats)
        self._health = None
        if self.stats:
            from distributed_training_pytorch_tpu_torch.telemetry.stats import HealthStats

            self._health = HealthStats()
        # This rank's last window wall (ms) for the straggler fields: set by the trainer at
        # a sync point, carried by every train step's metrics all-reduce until the next.
        self.arrival_ms: "float | None" = None

    # -- metrics ----------------------------------------------------------

    @staticmethod
    def _rows(batch) -> torch.Tensor:
        """This rank's real rows: the pad mask's sum, or the batch size."""
        if "mask" in batch:
            return batch["mask"].float().sum()
        first = next(iter(batch.values()))
        return torch.tensor(float(first.shape[0]), device=first.device)

    def _data_shards(self) -> int:
        return process_count() if self.mesh is None else self.mesh.batch_extent

    def shard_model(self, model: torch.nn.Module):
        """Lay ``model`` out on the engine's mesh by its rules (``parallel.layout.
        ShardedLayout.apply``, in place) and return the layout; None, and the model as it
        was, on a mesh without an ``fsdp`` or ``tensor`` axis."""
        if self.mesh is None or not self.mesh.sharded:
            return None
        from distributed_training_pytorch_tpu_torch.parallel.layout import ShardedLayout

        if self.stats:
            raise NotImplementedError(
                "the health stats (telemetry) on a sharded state are not ported: their norms would need a reduction "
                "over the shards (ROADMAP.md Queue 1 item 6)"
            )
        return ShardedLayout.apply(model, self.mesh, self.sharding_rules, fsdp_min_size=self.fsdp_min_size)

    def _reduce(self, metrics: dict, batch, *, arrivals: bool = False) -> dict:
        """Across data shards: each metric's mean weighted by the shards' real rows (a no-op
        with one data shard). ``arrivals`` (train steps) also sums one slot a data rank,
        each rank writing its ``arrival_ms``, into ``metrics["_arrivals"]``: every rank's
        figure, on the same all-reduce (``telemetry/straggler.py``)."""
        shards = self._data_shards()
        if shards == 1:
            return metrics
        keys = sorted(metrics)
        rows = self._rows(batch)
        packed = torch.stack([metrics[k].detach().float() * rows for k in keys] + [rows])
        slots = arrivals and self.arrival_ms is not None
        if slots:
            own = torch.zeros(shards, dtype=packed.dtype, device=packed.device)
            own[dist.get_rank() if self.mesh is None else self.mesh.batch_index] = float(self.arrival_ms)
            packed = torch.cat([packed, own])
        if packed.device.type != "meta":  # the memory trace allocates, it sends nothing
            dist.all_reduce(packed, group=None if self.mesh is None else self.mesh.batch_group)
        total = torch.clamp(packed[len(keys)], min=1.0)
        out = {k: packed[i] / total for i, k in enumerate(keys)}
        if slots:
            out["_arrivals"] = packed[len(keys) + 1:]
        return out

    # -- the optimizer's form -----------------------------------------------

    def _prepare(self, state: TrainState) -> None:
        """Once per optimizer and restore: the fused form (see the module docstring), Adam's
        step counts on the params' device, SGD's zero momentum buffers."""
        opt = state.optimizer
        if self._prepared == (opt, state.generation):
            return
        self._prepared = (opt, state.generation)
        self._meta = any(p.device.type == "meta" for g in opt.param_groups for p in g["params"])
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

    def _optimizer_step(self, opt) -> None:
        """``opt.step()``; on meta params, a fused optimizer's allocation twin: the state
        its first fused step creates (Adam's f32 step count and moments, SGD's momentum
        buffer), and nothing else, as the fused kernels allocate no temporaries."""
        if not (self._meta and self._fused):
            opt.step()
            return
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = opt.state[p]
                if isinstance(opt, torch.optim.SGD):
                    if group["momentum"] and st.get("momentum_buffer") is None:
                        st["momentum_buffer"] = torch.empty_like(p, memory_format=torch.preserve_format)
                elif not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    if group.get("amsgrad"):
                        st["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _set_lr(self, opt, lr) -> None:
        for group in opt.param_groups:
            group["lr"] = lr

    # -- steps ------------------------------------------------------------

    def _loss(self, model, batch, train: bool, laid_out: bool = False):
        # A laid-out leaf (parallel.layout) is gathered once a forward, however often it is read.
        with parametrize.cached() if laid_out else contextlib.nullcontext():
            loss, metrics = self.loss_fn(model, batch, train)
        return self.precision.cast_output(loss), dict(metrics)

    def _grads_and_metrics(self, model, batch, scale=None, laid_out: bool = False):
        """Forward and backward; with a dynamic ``scale`` the differentiated loss is
        scaled, the gradients unscaled, and the returned loss is the unscaled one.
        ``laid_out``: the model is on a ``parallel.layout.ShardedLayout``."""
        objective = (lambda loss: loss) if scale is None else scale.scale_loss
        if self.accum_steps == 1:
            loss, metrics = self._loss(model, batch, True, laid_out)
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
                loss, metrics = self._loss(model, micro, True, laid_out)
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
        loss, metrics = self._grads_and_metrics(model, batch, state.loss_scale if dynamic else None,
                                                state.layout is not None)
        # The seq (or pipe) ranks of a data shard step with the gradients (and the guard
        # with the loss) of the first of them, so their model copies stay bit-equal.
        broadcast_over_copies([p.grad for p in unwrap(model).parameters()] + [loss], self.mesh)
        if state.layout is not None:
            state.layout.reduce_gradients(unwrap(model))
            state.layout.broadcast_buffers(unwrap(model))
        metrics.setdefault("loss", loss)
        metrics = self._reduce({**metrics, "_objective": loss}, batch, arrivals=True)
        loss = metrics.pop("_objective")  # the differentiated loss, as the guard reads it
        if self._health is not None:
            self._health.before_update(unwrap(model).parameters(), loss)
        if guard:
            ok = torch.isfinite(loss)
            for p in unwrap(model).parameters():
                if p.grad is not None:
                    ok = ok & torch.isfinite(p.grad).all()
            if state.layout is not None:  # each rank saw its shards of the gradients
                ok = state.layout.all_finite(ok)
            if self._fused:
                opt.found_inf = (~ok).float()  # the fused kernels skip on it
                try:
                    self._optimizer_step(opt)
                finally:
                    opt.found_inf = None
                with torch.no_grad():
                    for b, before in zip(buffers, saved, strict=True):
                        b.copy_(torch.where(ok, b, before))
            elif self._meta or bool(ok):  # an optimizer without a fused form: one host read
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
            self._optimizer_step(opt)
        if self._health is not None:
            for k, v in self._health.after_update().items():
                metrics.setdefault(k, v)  # the guard's nonfinite wins, as JAX's setdefault gives
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
        if first.device.type == "meta" and allocation_route_active():
            return self._trace_window(state, stacked_batch, length)
        if first.device.type != "cuda":
            return self._loop(state, stacked_batch, length)
        if self._data_shards() > 1 or state.layout is not None:
            raise NotImplementedError(
                "chained steps with more than one data rank or a sharded state on the card (DDP or the layout's "
                "collectives inside a CUDA graph) are not checked yet: ROADMAP.md Queue 1 item 7, 'chained steps "
                "with DDP on 4 cards'"
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

    def _trace_window(self, state, stacked_batch, length):
        """The card's first window of a shape on meta tensors (the memory trace): the warm
        window's steps, the static inputs, then the captured bodies run once more, eagerly;
        what the graph keeps (its static inputs and outputs) stays alive as the graph
        would keep it."""
        self._prepare(state)
        lrs = [self._host_lr(state.step + i) for i in range(length)]
        per_step = [self._step_body(state, self.unstack_window(stacked_batch, i),
                                    self._lr if lr is not None and self._fused else lr) for i, lr in enumerate(lrs)]
        metrics = {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
        static = {k: torch.empty_like(v) for k, v in stacked_batch.items()}
        static_lrs = torch.zeros(length, dtype=torch.float32, device=next(iter(stacked_batch.values())).device)
        body = [self._step_body(state, self.unstack_window(static, i), static_lrs[i] if lrs[0] is not None else None)
                for i in range(length)]
        out = {k: torch.stack([m[k] for m in body]) for k in body[0]}
        self._window = _Window(None, None, static, static_lrs, out)
        state.step += length
        return state, metrics

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

    def with_accum(self, accum_steps: int) -> "TrainEngine":
        """A twin of this engine at another ``accum_steps``: the same loss function,
        schedule, guard, precision, mesh and stats, and none of this engine's state (no
        captured window, no prepared optimizer, its own health snapshot), so a trace of
        the twin leaves this engine's dispatch path as it was. The memory preflight's
        trials run these."""
        return TrainEngine(self.loss_fn, accum_steps=accum_steps, schedule=self.schedule, nan_guard=self.nan_guard,
                           precision=self.precision, mesh=self.mesh, stats=self.stats,
                           sharding_rules=self.sharding_rules, fsdp_min_size=self.fsdp_min_size)

    def drop_graphs(self) -> None:
        """Forget the captured window (the next window is warmed and captured again)."""
        self._window = None
        self._prepared = None

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> dict:
        """Metrics of the model on this rank's rows, averaged across ranks by real rows."""
        model = unwrap(state.model)
        model.eval()
        _, metrics = self._loss(model, batch, False, state.layout is not None)
        return self._reduce(metrics, batch)
