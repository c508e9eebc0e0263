"""The distributed world: the data axis and the sequence axis.

Counterpart of ``distributed_training_pytorch_tpu/parallel/mesh.py`` over
``torch.distributed``: the JAX package's ``data`` and ``seq`` mesh axes, its mesh-spec
grammar (:func:`mesh_config_from_spec`) and :class:`MeshConfig`. The ``fsdp``,
``tensor``, ``pipe`` and ``expert`` axes come with later slices of the port and raise
``NotImplementedError`` naming theirs.

A built :class:`Mesh` says where the ``s`` sequence shards live. The JAX package is one
controller over every device; its counterpart here is one process holding all ``s`` shards
(on one card, or on the CPU), each rank of the world then being one data shard. The other
placement is one shard per rank, the world a ``data x seq`` grid of ranks (rank ``=
data_index * seq + seq_index``, ``seq`` innermost as in the JAX axis order). The mesh
carries the ``torch.distributed`` sub-groups of that grid: the data group (ranks that hold
the same sequence shard, over which gradients and metrics are averaged) and the seq group
(ranks that hold the same rows, around which ring attention passes its blocks, and over
which :func:`broadcast_over_seq` keeps the model's copies equal).

``setup_distributed`` reads torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or takes an explicit ``init_method`` (for
example ``tcp://localhost:<port>``), rank and world size.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "MeshConfig",
    "broadcast_over_seq",
    "local_batch_size",
    "mesh_config_from_spec",
    "mesh_from_env",
    "process_count",
    "process_index",
    "setup_distributed",
    "shutdown_distributed",
]

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def setup_distributed(
    init_method: "str | None" = None,
    world_size: "int | None" = None,
    rank: "int | None" = None,
    *,
    backend: "str | None" = None,
) -> None:
    """Join the process group when this process is one rank of several; a no-op for a
    single process. The backend is NCCL when a card is visible, gloo otherwise. On the
    card each rank takes ``cuda:LOCAL_RANK`` (default: its rank)."""
    if _in_group():
        return
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if world_size is None or world_size <= 1:
        if rank not in (None, 0):
            raise ValueError(
                "RANK is set but WORLD_SIZE is not above 1: a partial distributed config would "
                "train independent single-process worlds. Set both (or neither)."
            )
        return
    if rank is None:
        raise ValueError("WORLD_SIZE > 1 needs this process's RANK")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank
    )


def shutdown_distributed() -> None:
    if _in_group():
        dist.destroy_process_group()


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if _in_group() else 0


def process_count() -> int:
    """Ranks in the process group (1 outside one)."""
    return dist.get_world_size() if _in_group() else 1


def local_batch_size(global_batch_size: int) -> int:
    """This rank's rows of a global batch: ``global_batch_size // process_count()``."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} ranks")
    return global_batch_size // n


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A built data x seq mesh, as this process sees it.

    ``shape`` maps ``"data"`` and ``"seq"`` to their extents. ``data_index`` is this
    process's data shard. ``seq_shards`` are the sequence shards it holds: all of
    ``range(seq)`` in the one-process placement, its one ``seq_index`` otherwise.
    ``data_group`` and ``seq_group`` are the ``torch.distributed`` groups of the ranks
    that share this process's sequence shard and its rows (``None`` where that group is
    this process alone); ``seq_ranks`` are the global ranks of the seq group in ring
    order."""

    shape: "dict[str, int]"
    data_index: int
    seq_shards: "tuple[int, ...]"
    data_group: object = None
    seq_group: object = None
    seq_ranks: "tuple[int, ...]" = ()

    @property
    def seq_local(self) -> bool:
        """True when this process holds every sequence shard."""
        return len(self.seq_shards) == self.shape[SEQ_AXIS]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh spec: the extents of the ``data`` and ``seq`` axes. ``data=-1``
    takes the ranks left over, as the JAX package's ``-1`` takes the devices left over:
    ``world // seq`` when the world spreads the sequence shards over ranks, else the
    world."""

    data: int = -1
    seq: int = 1

    def build(self) -> Mesh:
        """Place the shards on this world and make its sub-groups. Every rank must call it
        (new groups are collective). One process holds all ``seq`` shards when the world
        is ``data`` ranks; each rank holds one when it is ``data * seq``; any other split
        raises."""
        world, rank = process_count(), process_index()
        seq = int(self.seq)
        if seq < 1:
            raise ValueError(f"seq extent must be >= 1, got {seq}")
        data = int(self.data)
        if data == -1:
            data = world // seq if world % seq == 0 else world
        if data < 1:
            raise ValueError(f"data extent must be >= 1 (or -1), got {self.data}")
        shape = {DATA_AXIS: data, SEQ_AXIS: seq}
        if world == data:  # every process holds all the sequence shards of its rows
            group = dist.group.WORLD if world > 1 else None
            return Mesh(shape, data_index=rank, seq_shards=tuple(range(seq)), data_group=group)
        if world != data * seq:
            raise ValueError(
                f"mesh data={data} x seq={seq} does not fit a world of {world} ranks: one process "
                f"holds every seq shard ({data} ranks) or each rank holds one ({data * seq} ranks)"
            )
        data_index, seq_index = divmod(rank, seq)
        data_group = seq_group = None
        seq_ranks = ()
        # new_group is collective: every rank makes every group, in the same order.
        for j in range(seq):
            ranks = [i * seq + j for i in range(data)]
            group = _sub_group(ranks, world)
            if j == seq_index:
                data_group = group
        for i in range(data):
            ranks = [i * seq + j for j in range(seq)]
            group = _sub_group(ranks, world)
            if i == data_index:
                seq_group, seq_ranks = group, tuple(ranks)
        return Mesh(shape, data_index=data_index, seq_shards=(seq_index,), data_group=data_group,
                    seq_group=seq_group, seq_ranks=seq_ranks)


def broadcast_over_seq(tensors, mesh: "Mesh | None") -> None:
    """Overwrite ``tensors`` in place with those of the first rank of this rank's seq
    group. With one sequence shard per rank, every seq rank of a data shard holds the whole
    model and computes the same gradients; broadcasting the parameters once and the
    gradients every step keeps those copies bit-equal by construction (a nondeterministic
    kernel on one rank cannot make them drift, which would feed the ring k/v projected
    with other weights). A no-op when this process holds every sequence shard."""
    if mesh is None or mesh.seq_group is None:
        return
    by_dtype: "dict[torch.dtype, list[torch.Tensor]]" = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            if flat.device.type != "meta":  # the memory trace allocates, it sends nothing
                dist.broadcast(flat, src=mesh.seq_ranks[0], group=mesh.seq_group)
            for t, part in zip(group, flat.split([t.numel() for t in group]), strict=True):
                t.copy_(part.view_as(t))


def _sub_group(ranks, world):
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


# The mesh-spec grammar of the JAX package (``MESH``): axis-size pairs ("dp2sp2" -> data=2,
# seq=2) or the shorthand "<kind>KxD", K the kind's extent and D the data extent ("sp4x2"
# -> seq=4, data=2). "dp8" is pure 8-way data parallelism.
_SPEC_KINDS = {"dp": "data", "fsdp": "fsdp", "tp": "tensor", "sp": "seq", "pp": "pipe", "ep": "expert"}
_SPEC_SHORT_RE = re.compile(r"^(fsdp|tp|sp|pp|ep)(\d+)x(\d+)$")
_SPEC_PAIRS_RE = re.compile(r"(fsdp|dp|tp|sp|pp|ep)(\d+)")
_LATER_AXES = {
    "fsdp": "the sharding slice",
    "tensor": "the sharding slice",
    "pipe": "the pipeline slice",
    "expert": "the expert-parallel slice",
}


def mesh_config_from_spec(spec: str) -> MeshConfig:
    """Parse a mesh spec (``"sp4"``, ``"dp2sp2"``, ``"sp4x2"``, ``"dp8"``) into a
    :class:`MeshConfig`, as the JAX package's grammar does. An axis other than ``data``
    and ``seq`` at an extent above 1 raises ``NotImplementedError`` naming the slice of
    the port that brings it."""
    text = spec.strip().lower()
    if not text:
        raise ValueError("empty mesh spec")
    m = _SPEC_SHORT_RE.match(text)
    if m:
        axes = {"data": int(m.group(3)), _SPEC_KINDS[m.group(1)]: int(m.group(2))}
    else:
        pairs = _SPEC_PAIRS_RE.findall(text)
        if not pairs or "".join(k + n for k, n in pairs) != text:
            raise ValueError(
                f"unparseable mesh spec {spec!r}: use axis-size pairs like 'dp8', 'dp2sp2', or "
                "the shorthand 'sp4x2' (<kind><extent>x<data>)"
            )
        axes = {}
        for kind, n in pairs:
            name = _SPEC_KINDS[kind]
            if name in axes:
                raise ValueError(f"mesh spec {spec!r} names axis {name!r} twice")
            axes[name] = int(n)
        axes.setdefault("data", 1)
    for name, slice_name in _LATER_AXES.items():
        if axes.get(name, 1) != 1:
            raise NotImplementedError(
                f"mesh spec {spec!r}: the {name!r} axis comes with {slice_name} of the port; "
                "it runs the data and seq axes (dpN, spN, dpNspM, spNxM)"
            )
    return MeshConfig(data=axes["data"], seq=axes.get("seq", 1))


def mesh_from_env(var: str = "MESH") -> "Mesh | None":
    """The examples' ``MESH`` knob through :func:`mesh_config_from_spec`, built on this
    world; unset or empty gives ``None`` (one data axis over every rank)."""
    spec = os.environ.get(var)
    if not spec:
        return None
    return mesh_config_from_spec(spec).build()
