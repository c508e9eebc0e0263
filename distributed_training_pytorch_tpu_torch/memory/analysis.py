"""Where a step's peak device memory goes, predicted before the step runs.

Counterpart of ``distributed_training_pytorch_tpu/memory/analysis.py``. The JAX package
reads XLA's buffer assignment (``compiled.memory_analysis()``) of the lowered step; the
port has no compiled program to ask, so the prediction is a trace of the engine's own step
(``TrainEngine.train_step``, or ``train_steps_chained`` for a window) on meta tensors:

* the model's parameters and buffers are swapped for meta tensors of the same shapes
  (``torch.func.functional_call``), the optimizer is a twin of the same class over them,
  the batch is made of meta tensors; nothing is computed and nothing on the card is
  touched, so the prediction is the same on the CPU and on the card;
* the hand kernels' wrappers take their allocation twins (``ops.dispatch.allocation_route``):
  what the card's route allocates (K1's ``o`` and ``lse``, K2/K3's ``dq``/``dk``/``dv`` and
  δ, K4's output and ``dz``, the tied cross-entropy under its checkpoint, a fused
  optimizer's state), not the plain versions' f32 scores;
* a ``TorchDispatchMode`` counts the bytes of every live storage, each rounded up to the
  CUDA caching allocator's 512-byte block, adds a storage when an operator returns it and
  drops it when it is freed (a weakref finaliser on the storage), and keeps the live set at
  the peak.

The state is the steady state's: an optimizer whose state is made lazily at its first step
(``torch.optim``'s moments) has it made before the trace, as the health stats' snapshot
(telemetry on) is; a chained window runs as the card runs its first window (the warm steps,
the graph's static inputs, the captured bodies once more). What the trace cannot see is
added as a constant: ``staged_units`` more copies of the unit's batch (the device
prefetcher's batches in flight), and a second copy of the gradients when the model is
wrapped in ``DistributedDataParallel`` (its buckets).

The peak's bytes are split into the JAX package's six classes, in its order
(:data:`BUFFER_CLASSES`), and sum to the peak by construction:

* ``params``: the parameters and the model's buffers (BatchNorm statistics);
* ``optimizer_state``: what the step carries from step to step besides the model: the
  optimizer's state, the loss scale's tensors, the device learning rate and, with the
  health stats on, their snapshot of the params;
* ``gradients``: the parameters' ``.grad`` storages (and DDP's buckets);
* ``activations``: everything else live at the peak: saved activations, temporaries;
* ``input_batch``: the unit's batch, the staged copies and a window's static copy;
* ``executable``: 0. The kernels' code and a CUDA graph's instantiation live outside the
  caching allocator, whose ``max_memory_allocated`` is the measured side.

What stays between the prediction and ``torch.cuda.max_memory_allocated``: the
allocator's larger blocks (a block whose remainder is under 1 MiB is not split), cuBLAS's
workspaces, and the kernels' own workspaces inside library calls.

XLA's HLO-only helpers of the JAX module (``top_buffers_from_hlo``, ``memory_stats_dict``,
``predicted_peak_bytes`` of a compiled object) have no counterpart: the port has no
compiled module text or memory analysis to read.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch import nn
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_training_pytorch_tpu_torch.ops.dispatch import allocation_route
from distributed_training_pytorch_tpu_torch.precision import is_dynamic
from distributed_training_pytorch_tpu_torch.train.state import TrainState, unwrap

__all__ = [
    "BLOCK_BYTES",
    "BUFFER_CLASSES",
    "MemoryProfile",
    "analyze_step_memory",
    "batch_class_bytes",
    "state_class_bytes",
]

BUFFER_CLASSES = ("params", "optimizer_state", "gradients", "activations", "input_batch", "executable")

BLOCK_BYTES = 512  # the caching allocator rounds every block up to a multiple of this


def _block(nbytes: int, block: int = BLOCK_BYTES) -> int:
    return -(-int(nbytes) // block) * block


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> "list[torch.Tensor]":
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def state_class_bytes(state: TrainState) -> "dict[str, float]":
    """Bytes of a ``TrainState`` by class: ``params`` (the parameters and the model's
    buffers, each tied tensor once) and ``optimizer_state`` (the optimizer's state tensors
    and a dynamic loss scale's three). Exact bytes, not blocks."""
    net = unwrap(state.model)
    params = sum(_nbytes(t) for t in [*net.parameters(), *net.buffers()])
    optimizer = sum(_nbytes(t) for t in _tensors(list(state.optimizer.state.values())))
    if is_dynamic(state.loss_scale):
        optimizer += sum(_nbytes(t) for t in state.loss_scale.state_dict().values())
    return {"params": float(params), "optimizer_state": float(optimizer)}


def batch_class_bytes(batch) -> float:
    """Bytes of a batch's tensors (a chained window's whole stacked batch: every step's
    rows are on the device at once)."""
    return float(sum(_nbytes(t) for t in _tensors(batch)))


@dataclasses.dataclass
class MemoryProfile:
    """The predicted peak of one step (or chained window) and its split over
    :data:`BUFFER_CLASSES` (sums to ``peak_bytes``, so :meth:`fractions` sum to 1);
    ``stats`` the trace's own counts; ``top_buffers`` the largest storages live at the
    peak, as ``{name, op, shape, dtype, bytes, op_name}`` rows (``op`` the operator that
    allocated it, ``op_name`` the module running then, or its class for a tensor that was
    there before the step)."""

    peak_bytes: int
    bytes_by_class: "dict[str, float]"
    stats: "dict[str, int]"
    top_buffers: list = dataclasses.field(default_factory=list)
    chain_length: "int | None" = None

    def fractions(self) -> "dict[str, float]":
        if self.peak_bytes <= 0:
            return {c: 0.0 for c in BUFFER_CLASSES}
        return {c: v / self.peak_bytes for c, v in self.bytes_by_class.items()}

    def to_fields(self) -> dict:
        """The JSON payload of the JAX module's, for events."""
        return {
            "predicted_peak_bytes": int(self.peak_bytes),
            "bytes_by_class": {k: int(v) for k, v in self.bytes_by_class.items()},
            "fractions": {k: round(v, 4) for k, v in self.fractions().items()},
            **({"chain_length": self.chain_length} if self.chain_length else {}),
        }


class _LiveStorages(TorchDispatchMode):
    """The live storages' bytes (in blocks) while the mode is on, and the live set at the
    highest point. A storage is added when an operator returns it (or by :meth:`track`)
    and dropped by a finaliser when it is freed; a view adds nothing."""

    def __init__(self, block_bytes: int = BLOCK_BYTES):
        super().__init__()
        self._block_bytes = int(block_bytes)
        self._live: "dict[int, list]" = {}  # id(storage) -> [serial, bytes, label, op, shape, dtype, finaliser]
        self._serial = 0
        self.current = 0
        self.peak = 0
        self.allocations = 0
        self._at_peak: "list[tuple] | None" = None
        self._rising = False
        self.module = ""  # the module whose forward runs now

    def track(self, t: torch.Tensor, label: str = "", op: str = "") -> int:
        st = t.untyped_storage()
        key = id(st)
        entry = self._live.get(key)
        if entry is not None:
            return entry[0]
        self._serial += 1
        nbytes = _block(st.nbytes(), self._block_bytes)
        fin = weakref.finalize(st, self._free, key, self._serial)
        self._live[key] = [self._serial, nbytes, label, op, tuple(t.shape), str(t.dtype).replace("torch.", ""), fin]
        self.current += nbytes
        self.allocations += 1
        if self.current > self.peak:
            self.peak = self.current
            self._rising = True
        return self._serial

    def serial(self, t: torch.Tensor) -> "int | None":
        entry = self._live.get(id(t.untyped_storage()))
        return None if entry is None else entry[0]

    def _free(self, key: int, serial: int) -> None:
        entry = self._live.get(key)
        if entry is None or entry[0] != serial:
            return
        if self._rising:
            self._at_peak = [tuple(e[:6]) for e in self._live.values()]
            self._rising = False
        del self._live[key]
        self.current -= entry[1]

    def at_peak(self) -> "list[tuple]":
        if self._rising or self._at_peak is None:
            return [tuple(e[:6]) for e in self._live.values()]
        return self._at_peak

    def close(self) -> None:
        for entry in self._live.values():
            entry[6].detach()
        self._live.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                self.track(t, self.module, func.overloadpacket.__name__)
        return out


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t, device="meta")


def _optimizer_twin(opt: torch.optim.Optimizer, meta_of: dict) -> torch.optim.Optimizer:
    """The same optimizer class and hyperparameters over the meta params, with meta
    copies of its state (a fused-form optimizer's groups as the engine sets them, so the
    twin warns of nothing)."""
    groups = []
    for g in opt.param_groups:
        options = {k: (float(v) if torch.is_tensor(v) and v.ndim == 0 else v) for k, v in g.items() if k != "params"}
        if "fused" in options:
            options["fused"], options["foreach"] = True, False
        groups.append({**options, "params": [meta_of[id(p)] for p in g["params"]]})
    twin = type(opt)(groups)
    for p, st in opt.state.items():
        if id(p) in meta_of:
            twin.state[meta_of[id(p)]] = {k: (_meta(v) if torch.is_tensor(v) else v) for k, v in st.items()}
    return twin


def _stack_window(batch: dict, length: int) -> dict:
    return {k: torch.empty((length, *v.shape), dtype=v.dtype, device="meta") for k, v in batch.items()}


class _StepCall(nn.Module):
    """The step as a module's forward, so that ``functional_call`` swaps the model's
    tensors for the meta ones for its whole length (forward, backward and update)."""

    def __init__(self, net: nn.Module, run):
        super().__init__()
        self.net = net
        self._run = run

    def forward(self):
        return self._run(self.net)


def analyze_step_memory(engine, state: TrainState, batch, *, chain_length: "int | None" = None, top_k: int = 8,
                        staged_units: int = 0, block_bytes: int = BLOCK_BYTES) -> MemoryProfile:
    """The predicted peak of one ``engine.train_step`` on ``batch`` (a per-step batch of
    tensors on any device, or meta tensors; only shapes and dtypes are read), or of one
    ``train_steps_chained`` window of ``chain_length`` such batches; ``staged_units`` more
    units of that batch are counted as in flight (the device prefetcher's). Each storage
    counts in whole ``block_bytes`` (1: its exact bytes, as the CPU's allocator counts
    them). The engine and ``state`` are not changed: the trace runs a twin of the engine
    (``engine.with_accum``) on meta tensors (see the module docstring)."""
    twin = engine.with_accum(engine.accum_steps)
    net = unwrap(state.model)
    named = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    meta_named = {}
    meta_of = {}
    for name, t in named.items():
        m = nn.Parameter(_meta(t), requires_grad=t.requires_grad) if isinstance(t, nn.Parameter) else _meta(t)
        meta_named[name] = meta_of[id(t)] = m
    opt = _optimizer_twin(state.optimizer, meta_of)
    scale = state.loss_scale.to("meta") if is_dynamic(state.loss_scale) else state.loss_scale
    step_batch = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta") for k, v in batch.items()}
    unit = _stack_window(step_batch, chain_length) if chain_length else step_batch
    grad_params = [meta_of[id(p)] for p in net.parameters() if p.requires_grad]
    # The steady state: the optimizer's (and the health stats') state made as its first step makes it.
    meta_state = TrainState(model=None, optimizer=opt, step=int(state.step), loss_scale=scale)
    twin._prepare(meta_state)
    for p in grad_params:
        p.grad = torch.empty_like(p)
    twin._optimizer_step(opt)
    if twin._health is not None:
        twin._health._snapshot = [torch.empty_like(p, memory_format=torch.preserve_format) for p in grad_params]
    for p in grad_params:
        p.grad = None
    staged = [{k: torch.empty_like(v) for k, v in unit.items()} for _ in range(int(staged_units))]

    tracer = _LiveStorages(block_bytes)
    names = {id(m): n for n, m in net.named_modules()}
    serials: "dict[str, set]" = {c: set() for c in BUFFER_CLASSES}
    param_name = {id(m): n for n, m in meta_named.items()}
    labels: "dict[int, str]" = {}

    def pre_hook(module, args):
        tracer.module = names.get(id(module), tracer.module)

    def post_hook(module, args, output):
        name = names.get(id(module))
        if name is not None:
            tracer.module = name.rpartition(".")[0] if name else ""

    def run(model):
        meta_state.model = model
        for name, t in meta_named.items():
            serials["params"].add(tracer.track(t, name, "param" if isinstance(t, nn.Parameter) else "buffer"))
        for p, st in opt.state.items():
            for key, t in st.items():
                if torch.is_tensor(t):
                    serials["optimizer_state"].add(tracer.track(t, f"{key}:{param_name.get(id(p), '?')}", "state"))
        for t in _tensors([scale.state_dict() if is_dynamic(scale) else None, twin._lr,
                           twin._health._snapshot if twin._health is not None else None]):
            serials["optimizer_state"].add(tracer.track(t, "engine_state", "state"))
        for u in (unit, *staged):
            for k, t in u.items():
                serials["input_batch"].add(tracer.track(t, f"batch:{k}", "input"))
        if chain_length:
            twin.train_steps_chained(meta_state, unit, chain_length)
            if twin._window is not None:
                serials["input_batch"].update(tracer.serial(t) for t in twin._window.batch.values())
        else:
            twin.train_step(meta_state, unit)
        for p in grad_params:
            if p.grad is not None and tracer.serial(p.grad) is not None:
                serials["gradients"].add(tracer.serial(p.grad))
                labels[tracer.serial(p.grad)] = f"grad:{param_name[id(p)]}"
        serials["optimizer_state"].update(tracer.serial(t) for t in _tensors(list(opt.state.values())))
        return None

    was_training = net.training
    handles = [nn.modules.module.register_module_forward_pre_hook(pre_hook),
               nn.modules.module.register_module_forward_hook(post_hook)]
    try:
        with allocation_route(), tracer:
            torch.func.functional_call(_StepCall(net, run), {f"net.{k}": v for k, v in meta_named.items()}, (),
                                       strict=False)
            live = tracer.at_peak()
            peak, allocations = tracer.peak, tracer.allocations
    finally:
        for h in handles:
            h.remove()
        tracer.close()
        net.train(was_training)
        meta_state.model = None

    by_serial = {}
    for cls in ("params", "optimizer_state", "input_batch", "gradients"):
        for s in serials[cls]:
            if s is not None:
                by_serial.setdefault(s, cls)
    classes = {c: 0.0 for c in BUFFER_CLASSES}
    rows = []
    for serial, nbytes, label, op, shape, dtype in live:
        cls = by_serial.get(serial, "activations")
        classes[cls] += nbytes
        if cls == "activations":
            name, origin = f"{op}#{serial}", label
        else:
            name, origin = labels.get(serial, label), cls
        rows.append({"name": name, "op": op, "shape": list(shape), "dtype": dtype, "bytes": int(nbytes),
                     "op_name": origin})
    buckets = 0
    if isinstance(state.model, nn.parallel.DistributedDataParallel):
        buckets = sum(_block(_nbytes(p), block_bytes) for p in grad_params)
        classes["gradients"] += buckets
    rows.sort(key=lambda r: -r["bytes"])
    return MemoryProfile(
        peak_bytes=int(peak + buckets),
        bytes_by_class=classes,
        stats={"traced_peak_bytes": int(peak), "ddp_bucket_bytes": int(buckets), "storages_at_peak": len(live),
               "allocations": int(allocations), "staged_units": int(staged_units)},
        top_buffers=rows[:top_k] if top_k > 0 else [],
        chain_length=chain_length,
    )
