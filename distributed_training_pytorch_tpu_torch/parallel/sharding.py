"""Parameter and optimizer-state sharding rules: FSDP, tensor and expert parallelism.

Counterpart of ``distributed_training_pytorch_tpu/parallel/sharding.py``: the same rule
grammar, leaf decisions, accounting and rule sets, over a module's ``named_parameters()``
instead of a pytree. What it decides, ``parallel/layout.py`` carries out on a
``torch.distributed`` world.

Two layers of rules, applied per parameter:

1. **Explicit rules**: ``(regex, spec)`` pairs matched (``re.search``) against the
   parameter's name, e.g. ``(r"mlp_in\\.weight$", P("tensor", None))``. A spec is a
   :class:`P`, one entry per leading dim: ``None`` (not split), a mesh axis name, a tuple
   of names, or :class:`Strided` (the dim viewed as ``[groups, rest]`` and ``rest`` split).
2. **FSDP fallback**: with an ``fsdp`` axis above 1, the largest divisible dim of any
   parameter of at least ``fsdp_min_size`` elements is split over it; smaller ones stay
   replicated.

Optimizer state takes its parameter's spec, so the update stays local. Every decision
and byte count works from axis sizes alone (a ``Mesh``, or a mapping such as
``{"data": 1, "fsdp": 8}``), with no world: the tests and the preflight ask about
``fsdp=8`` without 8 ranks.

**The port's layouts, where they differ from the JAX package's.** ``nn.Linear`` holds
``[out, in]`` where flax holds ``[in, out]``, so column-parallel layers split dim 0 and
row-parallel ones dim 1. The fused ``qkv.weight`` is ``[3 D, D]`` with its rows in
``(3, H, Dh)`` order (``models/transformer_lm.py``, ``models/convert.py``): a plain split
of dim 0 would give the first tensor rank all of q and half of k. The rule splits it by
heads instead, ``Strided("tensor", 3)``, so each tensor rank holds q, k and v of its own
heads, as the JAX rule's split of ``H`` in ``[D, 3, H, Dh]`` does (``sharding.py:270``).
Checkpoints stay in the global layout.

**The expert axis.** The JAX package has no rule for an MoE layer's experts: its forward
constrains ``w_in``/``w_out`` to ``P("expert")`` (``moe.py:206-207``) and GSPMD splits them
there. The port stores them split, so the split is a rule, :func:`moe_expert_rules` (dim 0,
the experts, over ``expert``), in the default set of a mesh with an expert axis; the
router and every other leaf stay replicated across the expert group.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Mapping, Sequence

import torch

from distributed_training_pytorch_tpu_torch.parallel.mesh import EXPERT_AXIS, FSDP_AXIS, TENSOR_AXIS, mesh_axes

__all__ = [
    "P",
    "Rule",
    "Strided",
    "default_sharding_rules",
    "moe_expert_rules",
    "rule_for_leaf",
    "shard_shape",
    "sharding_record",
    "spec_for_leaf",
    "state_shardings",
    "transformer_tp_rules",
    "tree_shard_bytes",
]

_logger = logging.getLogger(__name__)


class Strided:
    """A spec entry: the dim is viewed as ``[groups, dim // groups]`` and the second factor
    is split over ``axis`` (each rank holds its slice of every group)."""

    __slots__ = ("axis", "groups")

    def __init__(self, axis: str, groups: int):
        self.axis, self.groups = axis, int(groups)

    def __eq__(self, other):
        return isinstance(other, Strided) and (self.axis, self.groups) == (other.axis, other.groups)

    def __hash__(self):
        return hash((self.axis, self.groups))

    def __repr__(self):
        return f"Strided({self.axis!r}, {self.groups})"


class P(tuple):
    """A partition spec (JAX's ``PartitionSpec``): one entry per leading dim, trailing
    dims replicated. ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"

    __str__ = __repr__


# A rule: (regex matched against the parameter's name, spec to apply).
Rule = tuple  # (str, P)


def _axes(mesh_or_axes) -> "dict[str, int]":
    if mesh_or_axes is None:
        return {}
    if hasattr(mesh_or_axes, "shape") and not isinstance(mesh_or_axes, Mapping):
        return dict(mesh_axes(mesh_or_axes))
    return {str(k): int(v) for k, v in mesh_or_axes.items()}


def _entry_names(entry) -> "tuple[str, ...]":
    if entry is None:
        return ()
    if isinstance(entry, Strided):
        return (entry.axis,)
    return entry if isinstance(entry, tuple) else (entry,)


def _entry_split(entry, axes: Mapping[str, int]) -> "int | None":
    """How many ways ``entry`` splits its dim, or None when it names an axis the mesh
    does not have."""
    total = 1
    for name in _entry_names(entry):
        if name not in axes:
            return None
        total *= axes[name]
    return total


def _spec_fits(spec, shape: "tuple[int, ...]", mesh, unit: int = 1) -> bool:
    """A spec fits when every named dim exists in the mesh and divides the corresponding
    dimension into whole ``unit``s (a :class:`Strided` entry: the groups divide the dim,
    and the split divides each group into whole units)."""
    axes = _axes(mesh)
    if len(spec) > len(shape):
        return False
    for dim, entry in zip(shape, spec, strict=False):
        if entry is None:
            continue
        total = _entry_split(entry, axes)
        if total is None:
            return False
        if isinstance(entry, Strided):
            if dim % entry.groups or (dim // entry.groups) % (total * unit):
                return False
        elif dim % (total * unit):
            return False
    return True


def _fsdp_spec(shape: "tuple[int, ...]", mesh, axis: str, min_size: int) -> P:
    """Split the largest divisible dim over ``axis``; replicated if none fits or the leaf
    has fewer than ``min_size`` elements."""
    axes = _axes(mesh)
    if axes.get(axis, 1) <= 1:
        return P()
    if math.prod(shape) < min_size:
        return P()
    n = axes[axis]
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for i in order:
        if shape[i] % n == 0:
            spec = [None] * len(shape)
            spec[i] = axis
            return P(*spec)
    return P()


def rule_for_leaf(path: str, shape: "tuple[int, ...]", mesh, rules: Sequence = (), unit: int = 1
                  ) -> "tuple[str, P] | None":
    """The ``(pattern, spec)`` of the first explicit rule that matched and fits this leaf,
    or None when the leaf takes the FSDP/replicated fallback. A rule that matches but does
    not divide the leaf warns and ends the search, as in the JAX package. ``unit``: the
    leaf's split dims hold whole units of this size (a ``Linear``'s ``split_unit``: an
    attention head's width, so that a split of the fused heads checks the head count, as
    the JAX rule on ``[D, 3, H, Dh]`` does)."""
    for pattern, spec in rules or ():
        if re.search(pattern, path):
            if _spec_fits(spec, shape, mesh, unit):
                return pattern, spec
            _logger.warning(
                "sharding rule %r matched %s (shape %s) but spec %s does not fit mesh %s — falling back to "
                "FSDP/replicated", pattern, path, shape, spec, _axes(mesh),
            )
            break
    return None


def spec_for_leaf(path: str, shape: "tuple[int, ...]", mesh, rules: Sequence = (), *, fsdp_axis: str = FSDP_AXIS,
                  fsdp_min_size: int = 2**18, unit: int = 1) -> P:
    matched = rule_for_leaf(path, shape, mesh, rules, unit)
    if matched is not None:
        return matched[1]
    return _fsdp_spec(shape, mesh, fsdp_axis, fsdp_min_size)


def _named_shapes(model_or_named) -> "dict[str, tuple]":
    """``{name: (shape, dtype)}`` of a module's parameters (its ``named_parameters()``;
    under ``DistributedDataParallel`` the module's own names), or of a mapping of names to
    tensors or ``(shape, dtype)`` pairs."""
    if isinstance(model_or_named, torch.nn.Module):
        module = getattr(model_or_named, "module", model_or_named)
        return {n: (tuple(p.shape), p.dtype) for n, p in module.named_parameters()}
    out = {}
    for name, value in model_or_named.items():
        if isinstance(value, torch.Tensor):
            out[name] = (tuple(value.shape), value.dtype)
        else:
            shape, dtype = value
            out[name] = (tuple(shape), dtype)
    return out


def state_shardings(model, mesh, rules: Sequence = (), *, fsdp_axis: str = FSDP_AXIS, fsdp_min_size: int = 2**18,
                    optimizer=None) -> "dict[str, P]":
    """``{parameter name: spec}`` for every parameter of ``model`` (a module, or a mapping
    of names to tensors or ``(shape, dtype)``) on ``mesh`` (a ``Mesh`` or axis sizes).
    Scalars are replicated; a module's ``split_unit`` (see :func:`rule_for_leaf`) is read
    from the module that holds the leaf. With ``optimizer`` (built over ``model``'s
    parameters), its state tensors of their parameter's shape are in the map too, as
    ``"<parameter>/<state key>"``, each with its parameter's spec: the update stays local."""
    units = {}
    if isinstance(model, torch.nn.Module):
        module = getattr(model, "module", model)
        for prefix, mod in module.named_modules():
            for pname, _ in mod.named_parameters(recurse=False):
                units[f"{prefix}.{pname}" if prefix else pname] = int(getattr(mod, "split_unit", 1))
    out = {}
    for name, (shape, _) in _named_shapes(model).items():
        out[name] = P() if not shape else spec_for_leaf(
            name, shape, mesh, rules, fsdp_axis=fsdp_axis, fsdp_min_size=fsdp_min_size, unit=units.get(name, 1))
    if optimizer is not None:
        names = {id(p): n for n, p in getattr(model, "module", model).named_parameters()}
        for p, st in optimizer.state.items():
            for key, value in st.items():
                if torch.is_tensor(value) and value.dim() and value.shape == p.shape and id(p) in names:
                    out[f"{names[id(p)]}/{key}"] = out[names[id(p)]]
    return out


# -- per-device shard accounting -------------------------------------------


def shard_shape(global_shape: "tuple[int, ...]", spec, mesh=None) -> "tuple[int, ...]":
    """The per-device shape of a leaf of ``global_shape`` under ``spec`` on ``mesh`` (None
    or ``P()``: the global shape)."""
    shape = list(global_shape)
    if not spec:
        return tuple(shape)
    axes = _axes(mesh)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        total = _entry_split(entry, axes)
        if total is None or shape[i] % total:
            raise ValueError(f"spec {spec} does not fit shape {tuple(global_shape)} on mesh {axes}")
        shape[i] //= total
    return tuple(shape)


def tree_shard_bytes(leaves: Mapping, specs=None, mesh=None) -> float:
    """Per-device bytes of ``leaves`` (a module, ``{name: tensor}`` or ``{name: (shape,
    dtype)}``), every leaf at its shard shape under ``specs`` (``{name: spec}``; a missing
    name, or ``specs=None``, is replicated)."""
    total = 0
    for name, (shape, dtype) in _named_shapes(leaves).items():
        spec = None if specs is None else specs.get(name)
        total += math.prod(shard_shape(shape, spec, mesh)) * torch.empty((), dtype=dtype).element_size()
    return float(total)


def sharding_record(specs: "Mapping | None", mesh=None) -> "dict | None":
    """The checkpoint's sharding record: ``{"mesh": axis sizes, "specs": {name: spec
    string}}`` over the leaves that are not replicated, None when nothing is sharded (a
    pure data-parallel state: checkpoints with and without sharding are told apart by the
    record's presence). ``specs`` may carry optimizer-state names too."""
    if not specs:
        return None
    axes = _axes(mesh)
    sharded = {str(k): str(v) for k, v in specs.items() if v and any(e is not None for e in v)}
    if not axes or not sharded:
        return None
    return {"mesh": axes, "specs": sharded}


# -- predefined tensor-parallel rule sets ----------------------------------


def default_sharding_rules(mesh) -> "list | None":
    """The one default rule policy (``Trainer(sharding_rules="auto")`` through its
    ``build_sharding_rules`` hook): a mesh with a ``tensor`` axis above 1 gets
    :func:`transformer_tp_rules` (other models match none of its patterns and take the
    FSDP fallback), one with an ``expert`` axis above 1 :func:`moe_expert_rules`; any other
    mesh gets None."""
    axes = _axes(mesh)
    rules = []
    if axes.get(EXPERT_AXIS, 1) > 1:
        rules += moe_expert_rules()
    if axes.get(TENSOR_AXIS, 1) > 1:
        rules += transformer_tp_rules()
    return rules or None


def moe_expert_rules(expert_axis: str = EXPERT_AXIS) -> list:
    """An MoE layer's experts split over the expert axis: ``w_in`` ``[E, d, h]`` and
    ``w_out`` ``[E, h, d]`` on dim 0 (``parallel/moe.py::MoEMlp``), where the JAX forward
    constrains them (``moe.py:206-207``)."""
    return [(r"(^|\.)w_(in|out)$", P(expert_axis))]


def transformer_tp_rules(tensor_axis: str = TENSOR_AXIS) -> list:
    """Megatron-style TP for the transformer blocks of the port's model zoo, against its
    own parameter names: ``models.transformer_lm`` (``blocks.N.qkv``, ``attn_out``,
    ``mlp_in``, ``mlp_out``, ``embed``) and ``models.vit`` (``qkv``, ``out``,
    ``mlp.dense_in``, ``mlp.dense_out``). Column-parallel qkv (by heads) and MLP-in (their
    output features and biases split), row-parallel attention-out and MLP-out (their input
    features split; their biases replicated). The LM's embedding splits over the vocab
    (``[V, D]``, dim 0): the byte vocab of 256 divides 2 and 4, GPT-2's 50,257 divides
    neither and then warns and stays replicated (or takes the FSDP fallback), as in the JAX
    package. The table is stored split and gathered over the tensor group where it is used
    (the lookup and the fused tied CE, which needs the whole table)."""
    return [
        # qkv [3 D, D] (rows in (3, H, Dh) order) and its bias [3 D]: by heads.
        (r"(^|\.)qkv\.weight$", P(Strided(tensor_axis, 3), None)),
        (r"(^|\.)qkv\.bias$", P(Strided(tensor_axis, 3))),
        # attention out [D, H * Dh]: its input (heads) split. ViT names it `out`.
        (r"(^|\.)(out|attn_out)\.weight$", P(None, tensor_axis)),
        # MLP: the first Linear column-parallel, the second row-parallel.
        (r"(^|\.)(mlp_in|dense_in)\.weight$", P(tensor_axis, None)),
        (r"(^|\.)(mlp_in|dense_in)\.bias$", P(tensor_axis)),
        (r"(^|\.)(mlp_out|dense_out)\.weight$", P(None, tensor_axis)),
        # the LM's embedding [V, D] (tied to the logits): vocab-parallel.
        (r"(^|\.)embed\.weight$", P(tensor_axis, None)),
    ]
