"""The distributed world, data axis only.

Counterpart of ``distributed_training_pytorch_tpu/parallel/mesh.py`` for pure data
parallelism over ``torch.distributed``: the JAX package's 1-D ``data`` mesh is the process
group, one rank per card (NCCL) or per CPU process (gloo), each feeding its rows of the
global batch. The ``fsdp``/``tensor``/``seq``/``pipe``/``expert`` axes come with the
sharding slice of the port.

``setup_distributed`` reads torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or takes an explicit ``init_method`` (for
example ``tcp://localhost:<port>``), rank and world size.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

__all__ = [
    "local_batch_size",
    "mesh_from_env",
    "process_count",
    "process_index",
    "setup_distributed",
    "shutdown_distributed",
]


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


_DP_RE = re.compile(r"^dp(\d+)$")


def mesh_from_env(var: str = "MESH") -> "int | None":
    """The examples' ``MESH`` knob, data axis only: unset or empty gives ``None`` (one data
    axis over every rank), ``dpN`` gives ``N``, which must then equal the world size. Any
    other axis raises ``NotImplementedError``: it comes with the sharding slice."""
    spec = (os.environ.get(var) or "").strip().lower()
    if not spec:
        return None
    m = _DP_RE.match(spec)
    if m is None:
        raise NotImplementedError(
            f"{var}={spec!r}: the port runs the data axis only (dpN); fsdp/tp/sp/pp/ep meshes "
            "come with the sharding slice of the port"
        )
    return int(m.group(1))
