"""A sharded layout of a model's state over ``torch.distributed``: FSDP and tensor
parallelism as ``parallel/sharding.py`` decides them.

The JAX package gives every state leaf a ``NamedSharding`` and lets XLA insert the
collectives; here :meth:`ShardedLayout.apply` replaces each sharded parameter of a built
model by this rank's shard and installs what its use needs:

* **fsdp** (ZeRO-3): the shard is the parameter; where the module reads it (a
  ``torch.nn.utils.parametrize`` parametrization) the whole tensor is gathered over the
  fsdp group, and the backward of that gather reduce-scatters the gradient over the group
  (the sum of this rank's part). The engine reads each laid-out leaf once a micro-batch's
  forward (``parametrize.cached``): the tied table, read by the lookup and the head, is
  gathered once. Nothing is prefetched: each gather waits for its collective.
* **tensor**, on a ``Linear`` of the model zoo (``models.transformer_lm._Dense``): the
  layer computes on its shard, Megatron-style. Column-parallel layers (weight split on
  dim 0, ``[out, in]``) take their input through an identity whose backward all-reduces
  over the tensor group; row-parallel ones (dim 1) all-reduce their output over the group,
  then add their replicated bias once. The attention between them runs on the rank's
  own heads (the qkv rows are split by heads, ``sharding.Strided``).
* **expert**, on an MoE layer's experts (``parallel.moe.MoEMlp``'s ``w_in``/``w_out``):
  the layer computes on its rank's experts and sums the partial outputs over the expert
  group (:attr:`MoEMlp.expert_split`, the ``psum`` form of ``parallel/moe.py``); each
  rank's gradient of its experts is whole (every token routed to them passed through it).
* **tensor** or **expert**, on any other leaf (the LM's vocab-parallel embedding): stored split,
  gathered over the tensor group where it is read (the lookup and the fused tied CE, which
  needs the whole table); every tensor rank computes the same gradient of the whole
  table, so the gather's backward keeps this rank's part without a sum.

The optimizer is built over the shards, so its state takes each parameter's layout and
the update stays local. :meth:`reduce_gradients` averages what the backward left over the
batch shards (``data x fsdp``): a gathered fsdp leaf's summed shard over the data group,
every other leaf (replicated ones included: a leaf under ``fsdp_min_size`` is not in any
fsdp reduction) over the batch group; :meth:`broadcast_buffers` then gives every batch
shard the first one's floating buffers, as DDP does.

Checkpoints hold the global layout: :meth:`full_state_dict` gathers every shard under
the parameter's own name (the names the model has without the layout), and
:meth:`optimizer_state_dict` gives the state dict an optimizer over the whole model
would have, so a checkpoint written by 4 ranks loads into one process as it is, and the
reverse (:meth:`load_full_state_dict`, :meth:`load_optimizer_state_dict`) cuts it into any
layout. Collectives run on every rank in the same order; on meta tensors (the memory
trace) they are skipped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from distributed_training_pytorch_tpu_torch.parallel.mesh import EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS, mesh_axes
from distributed_training_pytorch_tpu_torch.parallel.sharding import (
    P,
    Strided,
    sharding_record,
    state_shardings,
    tree_shard_bytes,
)

__all__ = ["ExpertSplit", "ShardedLayout", "TensorSplit"]


def _canonical_name(name: str) -> str:
    """A parameter's name without the layout's parametrization:
    ``blocks.0.qkv.parametrizations.weight.original`` -> ``blocks.0.qkv.weight``."""
    return name.replace("parametrizations.", "").replace(".original", "")


def _part(full: torch.Tensor, dim: int, groups: int, n: int, index: int) -> torch.Tensor:
    """Part ``index`` of ``n`` of ``full`` along ``dim`` (each group's part, for
    ``groups`` > 1)."""
    if groups == 1:
        size = full.shape[dim] // n
        return full.narrow(dim, index * size, size)
    view = full.unflatten(dim, (groups, full.shape[dim] // groups))
    size = view.shape[dim + 1] // n
    return view.narrow(dim + 1, index * size, size).flatten(dim, dim + 1)


def _assemble(parts, dim: int, groups: int) -> torch.Tensor:
    if groups == 1:
        return torch.cat(parts, dim)
    return torch.cat([p.unflatten(dim, (groups, -1)) for p in parts], dim + 1).flatten(dim, dim + 1)


def _all_gather(local: torch.Tensor, split) -> torch.Tensor:
    if local.device.type == "meta":  # the memory trace allocates, it sends nothing
        parts = [local] * split.n
    else:
        parts = [torch.empty_like(local) for _ in range(split.n)]
        dist.all_gather(parts, local.contiguous(), group=split.group)
    return _assemble(parts, split.dim, split.groups)


def _reduce_scatter(full: torch.Tensor, split) -> torch.Tensor:
    """This rank's part of ``full`` summed over the split's group: one reduce-scatter of
    the parts stacked in the group's rank order."""
    if full.device.type == "meta" or split.group is None:
        return split.part(full).contiguous()
    stacked = full.unflatten(split.dim, (split.groups, split.n, -1)).movedim(split.dim + 1, 0).contiguous()
    out = torch.empty(stacked.shape[1:], dtype=full.dtype, device=full.device)
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    reduce_scatter(out.view(-1), stacked.view(-1), group=split.group)  # flat: gloo splits dim 0
    return out.flatten(split.dim, split.dim + 1)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None and t.device.type != "meta":
        dist.all_reduce(t, group=group)
    return t


class _Split:
    """Where a leaf is split: ``dim`` (viewed as ``[groups, rest]`` when ``groups`` > 1)
    over ``axis``, ``n`` ways, this rank holding part ``index``, ``group`` the axis's
    process group."""

    def __init__(self, axis: str, dim: int, groups: int, n: int, index: int, group):
        self.axis, self.dim, self.groups, self.n, self.index, self.group = axis, dim, groups, n, index, group

    def part(self, full: torch.Tensor) -> torch.Tensor:
        return _part(full, self.dim, self.groups, self.n, self.index)


class _GatherFn(torch.autograd.Function):
    """The whole tensor from the shards; backward: this rank's part of the gradient,
    reduce-scattered over the group when ``summed`` (fsdp: each rank saw other rows)."""

    @staticmethod
    def forward(ctx, local, split, summed):
        ctx.split, ctx.summed = split, summed
        return _all_gather(local, split)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            return _reduce_scatter(grad, ctx.split), None, None
        return ctx.split.part(grad).contiguous(), None, None


class _Gathered(nn.Module):
    """The parametrization of a leaf stored split and read whole."""

    def __init__(self, split: _Split, summed: bool):
        super().__init__()
        self.split, self.summed = split, summed

    def forward(self, local):
        return _GatherFn.apply(local, self.split, self.summed)


class _CopyToTensorRegion(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the tensor group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTensorRegion(torch.autograd.Function):
    """All-reduce over the tensor group forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorSplit:
    """A ``Linear`` computing on its tensor shard: ``"column"`` (its output features
    split) or ``"row"`` (its input features split; the output all-reduced, the bias added
    once)."""

    def __init__(self, kind: str, group):
        if kind not in ("column", "row"):
            raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")
        self.kind, self.group = kind, group

    def linear(self, x, weight, bias):
        if self.kind == "column":
            return F.linear(_CopyToTensorRegion.apply(x, self.group), weight, bias)
        out = _ReduceFromTensorRegion.apply(F.linear(x, weight), self.group)
        return out if bias is None else out + bias


@dataclasses.dataclass(frozen=True)
class ExpertSplit:
    """Where an MoE layer's experts live: ``n`` ranks of the expert ``group``, this one
    holding experts ``index * E / n`` to ``(index + 1) * E / n``."""

    n: int
    index: int
    group: object = None


def _leaf_split(name: str, spec, mesh) -> "_Split | None":
    """The one split dim of ``spec`` on ``mesh``, or None for a replicated leaf."""
    split = None
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axis, groups = (entry.axis, entry.groups) if isinstance(entry, Strided) else (entry, 1)
        if split is not None or not isinstance(axis, str):
            raise NotImplementedError(
                f"{name}: spec {spec} splits more than one dim or over more than one axis; the port's layout "
                "splits one dim over one axis"
            )
        if axis == FSDP_AXIS:
            split = _Split(axis, dim, groups, mesh.shape[FSDP_AXIS], mesh.fsdp_index, mesh.fsdp_group)
        elif axis == TENSOR_AXIS:
            split = _Split(axis, dim, groups, mesh.shape[TENSOR_AXIS], mesh.tensor_index, mesh.tensor_group)
        elif axis == EXPERT_AXIS:
            split = _Split(axis, dim, groups, mesh.shape[EXPERT_AXIS], mesh.expert_index, mesh.expert_group)
        else:
            raise NotImplementedError(
                f"{name}: spec {spec} names axis {axis!r}; the layout splits over fsdp/tensor/expert")
    return split


def _owner(model: nn.Module, name: str) -> "tuple[nn.Module, str]":
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


class ShardedLayout:
    """The sharded layout of one model on one mesh (see the module docstring)."""

    def __init__(self, mesh, specs: "dict[str, P]", global_shapes: dict, state_keys: list):
        self.mesh = mesh
        self.specs = specs
        self.global_shapes = global_shapes  # {name: (shape, dtype)}, the model's parameter order
        self.state_keys = state_keys  # the model's state_dict keys without the layout
        self.splits: "dict[str, _Split]" = {}

    # -- building -----------------------------------------------------------

    @classmethod
    def apply(cls, model: nn.Module, mesh, rules=None, *, fsdp_min_size: int = 2**18) -> "ShardedLayout":
        """Decide the specs of ``model``'s parameters on ``mesh`` (``state_shardings``) and
        replace each sharded one by this rank's shard, in place. Every rank must build the
        same model (the same seed) first: each keeps its part of the same tensors."""
        specs = state_shardings(model, mesh, rules or (), fsdp_min_size=fsdp_min_size)
        layout = cls(mesh, specs, {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()},
                     list(model.state_dict().keys()))
        with torch.no_grad():
            for name, spec in specs.items():
                split = _leaf_split(name, spec, mesh)
                if split is None:
                    continue
                layout.splits[name] = split
                owner, attr = _owner(model, name)
                whole = getattr(owner, attr)
                setattr(owner, attr, nn.Parameter(split.part(whole.detach()).clone(), requires_grad=whole.requires_grad))
                if split.axis == TENSOR_AXIS and hasattr(owner, "tensor_split"):
                    layout._split_linear(name, owner, attr, split)
                elif split.axis == EXPERT_AXIS and hasattr(owner, "expert_split") and attr in ("w_in", "w_out"):
                    layout._split_experts(name, owner, split)
                else:  # read whole where it is used
                    parametrize.register_parametrization(
                        owner, attr, _Gathered(split, summed=split.axis == FSDP_AXIS), unsafe=True)
        return layout

    def _split_linear(self, name, owner, attr, split) -> None:
        """Make ``owner`` (a zoo ``Linear``) compute on its tensor shard (its bias is split
        with a column-parallel weight and whole with a row-parallel one)."""
        if attr != "weight":
            return
        kind = "column" if split.dim == 0 else "row"
        bias = self.specs.get(name[: -len(attr)] + "bias", P())
        if (kind == "column") != any(e is not None for e in bias):
            raise ValueError(f"{name} is {kind}-parallel but its bias spec is {bias}: a column-parallel Linear splits "
                             "its bias with its output features, a row-parallel one keeps it whole")
        owner.tensor_split = TensorSplit(kind, split.group)

    def _split_experts(self, name, owner, split) -> None:
        """Make ``owner`` (an ``MoEMlp``) compute on its rank's experts: both expert leaves
        must be split the same way, on dim 0."""
        prefix = name.rpartition(".")[0]
        specs = {self.specs.get(f"{prefix}.{a}" if prefix else a, P()) for a in ("w_in", "w_out")}
        if len(specs) != 1 or split.dim != 0:
            raise ValueError(f"{prefix or 'the MoE layer'}: w_in and w_out must both be split on dim 0 over the "
                             f"expert axis, got specs {sorted(map(str, specs))}")
        owner.expert_split = ExpertSplit(split.n, split.index, split.group)

    # -- what it holds -------------------------------------------------------

    def record(self) -> "dict | None":
        """The checkpoint's sharding record (``sharding.sharding_record``)."""
        return sharding_record(self.specs, self.mesh)

    def _named_params(self, model: nn.Module) -> "dict[str, nn.Parameter]":
        return {_canonical_name(n): p for n, p in model.named_parameters()}

    def _gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        split = self.splits.get(name)
        if split is None:
            return local
        return _all_gather(local.detach(), split)

    # -- checkpoints: the global layout ---------------------------------------

    def full_state_dict(self, model: nn.Module) -> "dict[str, torch.Tensor]":
        """The model's state dict in the global layout, under its own names, in its own
        order. Collective: every rank calls it."""
        params = self._named_params(model)
        buffers = dict(model.named_buffers())
        out = {}
        for key in self.state_keys:
            if key in params:
                out[key] = self._gather(key, params[key].detach())
            else:
                out[key] = buffers[key].detach()
        return out

    @torch.no_grad()
    def load_full_state_dict(self, model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
        """Load a global state dict (a checkpoint's ``params``) into the shards."""
        missing = [k for k in self.state_keys if k not in state]
        unexpected = [k for k in state if k not in self.state_keys]
        if missing or unexpected:
            raise RuntimeError(f"state dict does not match the model: missing {missing}, unexpected {unexpected}")
        params = self._named_params(model)
        buffers = dict(model.named_buffers())
        for key in self.state_keys:
            value = state[key]
            target = params.get(key, buffers.get(key))
            split = self.splits.get(key)
            target.copy_(split.part(value.to(target.device)) if split is not None else value)

    def _optimizer_names(self, optimizer, model) -> "list[str]":
        by_id = {id(p): n for n, p in self._named_params(model).items()}
        return [by_id[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def optimizer_state_dict(self, optimizer, model: nn.Module) -> dict:
        """``optimizer.state_dict()`` as an optimizer over the whole model would give it:
        its parameters numbered in the model's order, each group's in that order, every
        state tensor of a parameter's shape gathered. Collective."""
        sd = optimizer.state_dict()
        names = self._optimizer_names(optimizer, model)
        order = {n: i for i, n in enumerate(self.global_shapes)}
        state = {}
        for i in sorted(sd["state"], key=lambda i: order[names[i]]):
            name = names[i]
            local_shape = self._local_shape(name)
            state[order[name]] = {
                k: (self._gather(name, v) if torch.is_tensor(v) and tuple(v.shape) == local_shape and v.dim() else v)
                for k, v in sd["state"][i].items()
            }
        groups = [{**g, "params": sorted(order[names[i]] for i in g["params"])} for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def load_optimizer_state_dict(self, optimizer, model: nn.Module, payload: dict) -> None:
        """Load a global optimizer state dict (:meth:`optimizer_state_dict`'s form, or a run's
        without the layout) into the shards' optimizer: each saved group's parameters pair,
        in order, with the group's parameters in the model's order."""
        names = self._optimizer_names(optimizer, model)
        order = {n: i for i, n in enumerate(self.global_shapes)}
        saved_state = {int(k): v for k, v in payload["state"].items()}
        state, groups, start = {}, [], 0
        for saved_group, group in zip(payload["param_groups"], optimizer.param_groups, strict=True):
            positions = list(range(start, start + len(group["params"])))
            start += len(positions)
            if len(saved_group["params"]) != len(positions):
                raise ValueError("the checkpoint's optimizer groups do not match this optimizer's")
            for pos, saved_id in zip(sorted(positions, key=lambda i: order[names[i]]), saved_group["params"]):
                entry = saved_state.get(int(saved_id))
                if entry is None:
                    continue
                name, split = names[pos], self.splits.get(names[pos])
                state[pos] = {k: (split.part(v).clone() if split is not None and torch.is_tensor(v) and v.dim()
                                  and tuple(v.shape) == self.global_shapes[name][0] else v)
                              for k, v in entry.items()}
            groups.append({**saved_group, "params": positions})
        optimizer.load_state_dict({"state": state, "param_groups": groups})

    def _local_shape(self, name: str) -> tuple:
        shape = list(self.global_shapes[name][0])
        split = self.splits.get(name)
        if split is not None:
            shape[split.dim] //= split.n
        return tuple(shape)

    # -- the step ------------------------------------------------------------------

    def reduce_gradients(self, model: nn.Module) -> None:
        """Average the gradients over the batch shards (see the module docstring): one
        all-reduce per (group, dtype), then a division by ``data x fsdp``."""
        extent = self.mesh.batch_extent
        buckets: "dict[tuple, list[torch.Tensor]]" = {}
        for name, p in self._named_params(model).items():
            if p.grad is None:
                continue
            split = self.splits.get(name)
            group = self.mesh.data_group if split is not None and split.axis == FSDP_AXIS else self.mesh.batch_group
            buckets.setdefault((id(group), p.grad.dtype), [group]).append(p.grad)
        with torch.no_grad():
            for (_, _), (group, *grads) in buckets.items():
                if group is not None and grads[0].device.type != "meta":
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    dist.all_reduce(flat, group=group)
                    for g, part in zip(grads, flat.split([g.numel() for g in grads]), strict=True):
                        g.copy_(part.view_as(g))
                if extent > 1:
                    for g in grads:
                        g.div_(extent)

    def broadcast_buffers(self, model: nn.Module) -> None:
        """The model's floating buffers (BatchNorm's running statistics) from the first rank
        of the batch group to the others, as DDP's ``broadcast_buffers`` keeps them: each
        rank's forward updated them from its own rows."""
        group = self.mesh.batch_group
        buffers = [b for b in model.buffers() if b.is_floating_point()]
        if group is None or not buffers or buffers[0].device.type == "meta":
            return
        src = dist.get_global_rank(group, 0) if group is not dist.group.WORLD else 0
        with torch.no_grad():
            flat = torch.cat([b.reshape(-1) for b in buffers])
            dist.broadcast(flat, src=src, group=group)
            for b, part in zip(buffers, flat.split([b.numel() for b in buffers]), strict=True):
                b.copy_(part.view_as(b))

    def all_finite(self, ok: torch.Tensor) -> torch.Tensor:
        """``ok`` (this rank's finite flag of the loss and its gradient shards) and-ed over
        the world, so every rank skips or takes the same step."""
        if ok.device.type == "meta" or not dist.is_initialized():
            return ok
        bad = (~ok).float()
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
        return bad == 0

    def describe(self) -> str:
        sharded = sum(1 for s in self.specs.values() if s and any(e is not None for e in s))
        total = math.fsum(math.prod(s) * torch.empty((), dtype=d).element_size() for s, d in self.global_shapes.values())
        return (f"mesh {mesh_axes(self.mesh)}: {sharded}/{len(self.specs)} parameters sharded; per-device param bytes "
                f"{int(tree_shard_bytes(self.global_shapes, self.specs, self.mesh))} (global {int(total)})")
