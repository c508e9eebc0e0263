"""The distributed world: the data, fsdp, pipe, expert, tensor and seq axes.

Counterpart of ``distributed_training_pytorch_tpu/parallel/mesh.py`` over
``torch.distributed``: the JAX package's axis names and order (:data:`AXIS_ORDER`), its
mesh-spec grammar (:func:`mesh_config_from_spec`), :class:`MeshConfig` and
:func:`batch_shard_extent`.

A built :class:`Mesh` says where the ``s`` sequence shards, or the ``p`` pipeline stages,
live. The JAX package is one controller over every device; its counterpart here is one
process holding all ``s`` shards (or all ``p`` stages: on one card, or on the CPU), each
rank of the world then being one data shard. The other placement is one shard (or stage)
per rank, the world a ``data x seq`` (``data x pipe``) grid of ranks (rank ``= data_index
* seq + seq_index``, the inner axis innermost as in the JAX axis order). The mesh carries
the ``torch.distributed`` sub-groups of that grid: the data group (ranks that hold the same
shard or stage, over which gradients and metrics are averaged) and the seq or pipe group
(ranks that hold the same rows: around which ring attention passes its blocks and Ulysses
exchanges its heads, or through which the pipeline passes its activations; over it
:func:`broadcast_over_copies` keeps the model's copies equal). The ``pipe`` axis is
module-managed, as in the JAX package: no rule shards the state over it and the batch is
not split over it; a model reaches it through ``parallel/pipeline.py::pipeline_apply``.

With an ``fsdp``, ``expert`` or ``tensor`` axis each rank is one device of a ``data x fsdp x
expert x tensor`` grid, built by ``torch.distributed.device_mesh.init_device_mesh`` with its
dims in the JAX axis order (``tensor`` innermost: rank ``= ((data_index * fsdp +
fsdp_index) * expert + expert_index) * tensor + tensor_index``). The batch is split over
``data x fsdp`` (the batch group, ranks with the same expert and tensor index): the ranks
of one expert group read the same batch shard, as in the JAX package; the state is laid
out by ``parallel/sharding.py`` and ``parallel/layout.py`` (the experts of an MoE layer
split over the expert group, ``parallel/moe.py``). The seq axis beside ``fsdp``, ``expert``
or ``tensor``, ``expert`` beside ``tensor``, and the pipe axis beside any axis but ``data``
are not ported (Queue 1 item 6).

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
    "AXIS_ORDER",
    "AxisRing",
    "DATA_AXIS",
    "EXPERT_AXIS",
    "FSDP_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "TENSOR_AXIS",
    "Mesh",
    "MeshConfig",
    "batch_shard_extent",
    "broadcast_over_copies",
    "mesh_axes",
    "local_batch_size",
    "mesh_config_from_spec",
    "mesh_from_env",
    "process_count",
    "process_index",
    "setup_distributed",
    "shutdown_distributed",
]

# The JAX package's axis names, in its mesh order (data outermost, tensor innermost).
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
TENSOR_AXIS = "tensor"
SEQ_AXIS = "seq"
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, PIPE_AXIS, EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
_SHARDED_ITEM = "ROADMAP.md Queue 1 item 6"


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
    """A built mesh, as this process sees it.

    ``shape`` maps ``"data"`` and ``"seq"`` to their extents, and ``"fsdp"``, ``"pipe"``,
    ``"expert"`` and ``"tensor"`` too where they are above 1. ``data_index`` is this
    process's data shard. ``seq_shards`` are the sequence shards it holds: all of
    ``range(seq)`` in the one-process placement, its one ``seq_index`` otherwise;
    ``pipe_shards`` the same for the pipeline stages. ``data_group``, ``seq_group`` and
    ``pipe_group`` are the ``torch.distributed`` groups of the ranks that share this
    process's shard or stage (and fsdp and tensor index) and its rows (``None`` where that
    group is this process alone); ``seq_ranks`` and ``pipe_ranks`` are the global ranks of
    the seq and pipe groups in ring order. ``fsdp_index``/``fsdp_group``,
    ``expert_index``/``expert_group`` and ``tensor_index``/``tensor_group`` are the same for
    those axes, ``device_mesh`` the ``DeviceMesh`` of a sharded grid."""

    shape: "dict[str, int]"
    data_index: int
    seq_shards: "tuple[int, ...]"
    data_group: object = None
    seq_group: object = None
    seq_ranks: "tuple[int, ...]" = ()
    pipe_shards: "tuple[int, ...]" = (0,)
    pipe_group: object = None
    pipe_ranks: "tuple[int, ...]" = ()
    fsdp_index: int = 0
    fsdp_group: object = None
    tensor_index: int = 0
    tensor_group: object = None
    expert_index: int = 0
    expert_group: object = None
    batch_group_: object = None
    device_mesh: object = None

    @property
    def seq_local(self) -> bool:
        """True when this process holds every sequence shard."""
        return len(self.seq_shards) == self.shape[SEQ_AXIS]

    @property
    def pipe_index(self) -> int:
        """This process's pipeline stage when it holds one (the first it holds otherwise)."""
        return self.pipe_shards[0]

    def axis_shards(self, axis: str) -> "tuple[int, ...]":
        """The shards of the ``seq`` or ``pipe`` axis that this process holds."""
        return {SEQ_AXIS: self.seq_shards, PIPE_AXIS: self.pipe_shards}[axis]

    def axis_group(self, axis: str):
        """The group of the ``seq`` or ``pipe`` axis (None: this process alone)."""
        return {SEQ_AXIS: self.seq_group, PIPE_AXIS: self.pipe_group}[axis]

    def axis_ranks(self, axis: str) -> "tuple[int, ...]":
        """The global ranks of the ``seq`` or ``pipe`` group, in ring order."""
        return {SEQ_AXIS: self.seq_ranks, PIPE_AXIS: self.pipe_ranks}[axis]

    @property
    def sharded(self) -> bool:
        """True with an ``fsdp``, ``expert`` or ``tensor`` axis above 1: the state is laid
        out by ``parallel/layout.py`` instead of replicated under DDP."""
        return any(self.shape.get(a, 1) > 1 for a in (FSDP_AXIS, EXPERT_AXIS, TENSOR_AXIS))

    @property
    def batch_extent(self) -> int:
        """The batch shards: ``data x fsdp`` (:func:`batch_shard_extent`)."""
        return batch_shard_extent(self)

    @property
    def batch_index(self) -> int:
        """This process's batch shard, ``data_index * fsdp + fsdp_index``."""
        return self.data_index * self.shape.get(FSDP_AXIS, 1) + self.fsdp_index

    @property
    def batch_group(self):
        """The ranks over which the batch is split and gradients and metrics are averaged
        (``data x fsdp`` at this expert and tensor index; the data group without a sharded
        axis)."""
        return self.batch_group_ if self.sharded else self.data_group


def batch_shard_extent(mesh) -> int:
    """How many ways the batch is split: the product of the ``data`` and ``fsdp`` extents
    (a ``Mesh`` or an axis-size mapping), as in the JAX package (``mesh.py:197-209``)."""
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    extent = 1
    for axis in (DATA_AXIS, FSDP_AXIS):
        extent *= int(shape.get(axis, 1))
    return max(1, extent)


def mesh_axes(mesh) -> "dict[str, int]":
    """The JAX mesh's ``shape`` of this mesh: ``data`` and every other axis above 1, in
    :data:`AXIS_ORDER` (what a checkpoint's sharding record and the elastic re-plan read)."""
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    return {a: int(shape[a]) for a in AXIS_ORDER if a in shape and (a == DATA_AXIS or int(shape[a]) > 1)}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh spec: the extents of the ``data``, ``fsdp``, ``pipe``, ``expert``,
    ``seq`` and ``tensor`` axes (JAX ``mesh.py:309-331``). ``data=-1`` takes the ranks left
    over, as the JAX package's ``-1`` takes the devices left over."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    def build(self) -> Mesh:
        """Place the shards on this world and make its sub-groups. Every rank must call it
        (new groups are collective). Without ``fsdp``, ``expert`` or ``tensor``: one process
        holds all ``seq`` shards (or all ``pipe`` stages) when the world is ``data`` ranks,
        each rank holds one when it is ``data * seq`` (``data * pipe``), and any other split
        raises. With them, the world is the ``data x fsdp x expert x tensor`` grid."""
        fsdp, expert, tensor = int(self.fsdp), int(self.expert), int(self.tensor)
        seq, pipe = int(self.seq), int(self.pipe)
        if min(fsdp, expert, tensor) < 1:
            raise ValueError(f"fsdp, expert and tensor extents must be >= 1, got {fsdp}, {expert}, {tensor}")
        if seq < 1 or pipe < 1:
            raise ValueError(f"seq and pipe extents must be >= 1, got {seq}, {pipe}")
        if pipe > 1:
            beside = [a for a, n in ((FSDP_AXIS, fsdp), (EXPERT_AXIS, expert), (SEQ_AXIS, seq), (TENSOR_AXIS, tensor))
                      if n > 1]
            if beside:
                raise NotImplementedError(
                    f"the pipe axis beside {', '.join(beside)} is not ported ({_SHARDED_ITEM}): use ppN or dpNppM for "
                    "pipeline parallelism"
                )
        if fsdp > 1 or expert > 1 or tensor > 1:
            return self._build_sharded(fsdp, expert, tensor)
        inner_axis, inner = (PIPE_AXIS, pipe) if pipe > 1 else (SEQ_AXIS, seq)
        world, rank = process_count(), process_index()
        data = int(self.data)
        if data == -1:
            data = world // inner if world % inner == 0 else world
        if data < 1:
            raise ValueError(f"data extent must be >= 1 (or -1), got {self.data}")
        shape = {DATA_AXIS: data, SEQ_AXIS: seq, **({PIPE_AXIS: pipe} if pipe > 1 else {})}
        if world == data:  # every process holds all the shards (stages) of its rows
            group = dist.group.WORLD if world > 1 else None
            return Mesh(shape, data_index=rank, seq_shards=tuple(range(seq)), data_group=group,
                        pipe_shards=tuple(range(pipe)))
        if world != data * inner:
            raise ValueError(
                f"mesh data={data} x {inner_axis}={inner} does not fit a world of {world} ranks: one process holds "
                f"every {inner_axis} shard ({data} ranks) or each rank holds one ({data * inner} ranks)"
            )
        data_index, inner_index = divmod(rank, inner)
        data_group = inner_group = None
        inner_ranks = ()
        # new_group is collective: every rank makes every group, in the same order.
        for j in range(inner):
            ranks = [i * inner + j for i in range(data)]
            group = _sub_group(ranks, world)
            if j == inner_index:
                data_group = group
        for i in range(data):
            ranks = [i * inner + j for j in range(inner)]
            group = _sub_group(ranks, world)
            if i == data_index:
                inner_group, inner_ranks = group, tuple(ranks)
        if inner_axis == PIPE_AXIS:
            return Mesh(shape, data_index=data_index, seq_shards=(0,), data_group=data_group,
                        pipe_shards=(inner_index,), pipe_group=inner_group, pipe_ranks=inner_ranks)
        return Mesh(shape, data_index=data_index, seq_shards=(inner_index,), data_group=data_group,
                    seq_group=inner_group, seq_ranks=inner_ranks)

    def _build_sharded(self, fsdp: int, expert: int, tensor: int) -> Mesh:
        """The ``data x fsdp x expert x tensor`` grid, one device a rank, through
        ``init_device_mesh`` (dims in the JAX axis order, extents of 1 left out but data)."""
        if int(self.seq) != 1:  # (pipe beside these axes raised in build)
            raise NotImplementedError(
                f"the seq axis beside fsdp, expert or tensor is not ported ({_SHARDED_ITEM}): use spN or dpNspM "
                "for sequence parallelism, fsdpN/tpN/epN/dpNfsdpM for sharded state"
            )
        if expert > 1 and tensor > 1:
            raise NotImplementedError(f"the expert axis beside tensor is not ported ({_SHARDED_ITEM}): use epN or "
                                      "dpNepM for expert parallelism")
        world, rank = process_count(), process_index()
        inner = fsdp * expert * tensor
        data = int(self.data)
        if data == -1:
            data = world // inner if world % inner == 0 else 0
        if data < 1 or data * inner != world:
            raise ValueError(
                f"mesh data={self.data} x fsdp={fsdp} x expert={expert} x tensor={tensor} does not fit a world of "
                f"{world} ranks: each rank holds one device of the data x fsdp x expert x tensor grid"
            )
        from torch.distributed.device_mesh import init_device_mesh

        sizes = {DATA_AXIS: data, FSDP_AXIS: fsdp, EXPERT_AXIS: expert, TENSOR_AXIS: tensor}
        names = tuple(a for a in AXIS_ORDER if a in sizes and (a == DATA_AXIS or sizes[a] > 1))
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(device_type, tuple(sizes[a] for a in names), mesh_dim_names=names)
        data_index, rest = divmod(rank, inner)
        fsdp_index, rest = divmod(rest, expert * tensor)
        expert_index, tensor_index = divmod(rest, tensor)
        groups = {a: (device_mesh.get_group(a) if sizes[a] > 1 else None) for a in names}
        # The batch group, data x fsdp at one expert and tensor index (collective: every
        # rank makes every group, in the same order).
        batch_group = None
        for e in range(expert):
            for t in range(tensor):
                ranks = [((d * fsdp + f) * expert + e) * tensor + t for d in range(data) for f in range(fsdp)]
                group = _sub_group(ranks, world)
                if (e, t) == (expert_index, tensor_index):
                    batch_group = group
        shape = {DATA_AXIS: data, SEQ_AXIS: 1,
                 **{a: sizes[a] for a in (FSDP_AXIS, EXPERT_AXIS, TENSOR_AXIS) if sizes[a] > 1}}
        return Mesh(shape, data_index=data_index, seq_shards=(0,), data_group=groups[DATA_AXIS],
                    fsdp_index=fsdp_index, fsdp_group=groups.get(FSDP_AXIS), tensor_index=tensor_index,
                    tensor_group=groups.get(TENSOR_AXIS), expert_index=expert_index,
                    expert_group=groups.get(EXPERT_AXIS), batch_group_=batch_group, device_mesh=device_mesh)


def broadcast_over_copies(tensors, mesh: "Mesh | None") -> None:
    """Overwrite ``tensors`` in place with those of the first rank of this rank's seq or
    pipe group. With one sequence shard (or pipeline stage) per rank, every rank of the
    group holds the whole model for the same rows and computes the same gradients;
    broadcasting the parameters once and the gradients every step keeps those copies
    bit-equal by construction (a nondeterministic kernel on one rank cannot make them
    drift, which would feed the ring k/v projected with other weights, or the next stage
    activations of other weights). A no-op when this process holds every shard."""
    if mesh is None:
        return
    group, ranks = (mesh.seq_group, mesh.seq_ranks) if mesh.seq_group is not None else (mesh.pipe_group,
                                                                                        mesh.pipe_ranks)
    if group is None:
        return
    by_dtype: "dict[torch.dtype, list[torch.Tensor]]" = {}
    for t in tensors:
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for same in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in same])
            if flat.device.type != "meta":  # the memory trace allocates, it sends nothing
                dist.broadcast(flat, src=ranks[0], group=group)
            for t, part in zip(same, flat.split([t.numel() for t in same]), strict=True):
                t.copy_(part.view_as(t))


class AxisRing:
    """The ``s`` shards of a mesh's ``seq`` or ``pipe`` axis as a ring: the shards this
    process holds (``shards``; every one when ``local``), the axis's group, and between
    ranks the global ranks of the group (``ranks``, in ring order) and of this shard's two
    neighbours. What the ring attention and the pipeline pass around it."""

    def __init__(self, mesh: Mesh, axis: str):
        if axis not in (SEQ_AXIS, PIPE_AXIS):
            raise ValueError(f"mesh has no axis {axis!r}")
        self.s = int(mesh.shape.get(axis, 1))
        self.shards = tuple(mesh.axis_shards(axis))
        self.local = len(self.shards) == self.s
        self.group = mesh.axis_group(axis)
        if not self.local:
            self.ranks = mesh.axis_ranks(axis)
            me = self.shards[0]
            self.next_rank, self.prev_rank = self.ranks[(me + 1) % self.s], self.ranks[(me - 1) % self.s]

    def p2p(self, x: torch.Tensor, direction: int) -> torch.Tensor:
        """Send ``x`` one rank along the ring (``+1``: to the next) and take the tensor of
        its shape that the rank on the other side sends, in one ``batch_isend_irecv``."""
        dst, src = (self.next_rank, self.prev_rank) if direction > 0 else (self.prev_rank, self.next_rank)
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, dst, self.group), dist.P2POp(dist.irecv, out, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def _sub_group(ranks, world):
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


# The mesh-spec grammar of the JAX package (``MESH``): axis-size pairs ("dp2fsdp2tp2" ->
# data=2, fsdp=2, tensor=2) or the shorthand "<kind>KxD", K the kind's extent and D the data
# extent ("fsdp4x2" -> fsdp=4, data=2; "tp2x4" -> tensor=2, data=4). "dp8" is pure 8-way
# data parallelism.
_SPEC_KINDS = {"dp": "data", "fsdp": "fsdp", "tp": "tensor", "sp": "seq", "pp": "pipe", "ep": "expert"}
_SPEC_SHORT_RE = re.compile(r"^(fsdp|tp|sp|pp|ep)(\d+)x(\d+)$")
_SPEC_PAIRS_RE = re.compile(r"(fsdp|dp|tp|sp|pp|ep)(\d+)")


def mesh_config_from_spec(spec: str) -> MeshConfig:
    """Parse a mesh spec (``"dp8"``, ``"fsdp4x2"``, ``"tp2x4"``, ``"dp2fsdp2tp2"``,
    ``"sp4"``, ``"dp2sp2"``, ``"pp4"``, ``"dp2pp2"``, ``"pp2x4"``, ``"ep2"``, ``"dp2ep2"``)
    into a :class:`MeshConfig`, as the JAX package's grammar does."""
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
                f"unparseable mesh spec {spec!r}: use axis-size pairs like 'dp8', 'dp2fsdp2tp2', or the "
                "shorthand 'fsdp4x2' / 'tp2x4' (<kind><extent>x<data>)"
            )
        axes = {}
        for kind, n in pairs:
            name = _SPEC_KINDS[kind]
            if name in axes:
                raise ValueError(f"mesh spec {spec!r} names axis {name!r} twice")
            axes[name] = int(n)
        axes.setdefault("data", 1)
    return MeshConfig(**axes)


def mesh_from_env(var: str = "MESH") -> "Mesh | None":
    """The examples' ``MESH`` knob through :func:`mesh_config_from_spec`, built on this
    world; unset or empty gives ``None`` (one data axis over every rank)."""
    spec = os.environ.get(var)
    if not spec:
        return None
    return mesh_config_from_spec(spec).build()
