"""Elastic topology re-planning: resume a checkpoint on a different device count.

Counterpart of ``distributed_training_pytorch_tpu/parallel/elastic.py``, whose decisions it
makes the same way (the tests hold them equal over a grid): given the mesh axes a
checkpoint's sharding record names and the device count of this world, re-solve the mesh
and the gradient-accumulation factor so the resumed run is batch-equivalent to the
interrupted one.

* **Model-sharding axes are kept as they are.** ``tensor``/``seq``/``pipe``/``expert``
  extents shape every leaf's split; if the new device count is not a multiple of their
  product, the re-plan refuses with :class:`ElasticReplanError`.
* **The batch axes take the change.** ``M / kept product`` becomes the new batch extent
  (``data x fsdp``); the fsdp share is ``gcd(old_fsdp, new_extent)`` and the rest lands on
  ``data``. ``N -> 1`` is pure data parallelism.
* **The global batch does not change.** :func:`replan_accum` picks the smallest
  accumulation factor whose per-shard micro-batch rows do not exceed the old run's, with
  ``batch % (extent * accum) == 0``.

:class:`TopologyMismatchError` is what ``CheckpointManager.restore`` raises, naming both
topologies, for a checkpoint whose record covers another device count than this world,
unless ``allow_topology_change=True``. The ``Trainer`` peeks at the resume checkpoint
before it builds its mesh and re-plans for ``mesh=None``.

In the port a device is a rank of the ``torch.distributed`` world (one card, or one
gloo process on the CPU). ``replan_reader`` raises: the streaming reader it re-splits is
not in the port (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from distributed_training_pytorch_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    MeshConfig,
)

__all__ = [
    "TopologyMismatchError",
    "ElasticReplanError",
    "ElasticPlan",
    "record_axes",
    "axes_device_product",
    "validate_topology",
    "replan",
    "replan_accum",
    "replan_absorbing",
    "replan_excluding",
    "replan_reader",
    "nearest_divisible_accum",
]

# Axes whose extents the re-plan preserves verbatim (model-sharding axes)
# vs. the batch-sharding axes it re-solves (batch_shard_extent's axes).
PRESERVED_AXES = (PIPE_AXIS, EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


class TopologyMismatchError(RuntimeError):
    """A checkpoint's recorded mesh covers a different device count than the
    running world — restoring it blindly would fail deep in the load with
    no mention of topology. Raised up front by
    ``CheckpointManager.restore`` (named topologies on both sides); pass
    ``allow_topology_change=True`` after re-planning the restore target for
    the current backend (``Trainer`` does both automatically for
    ``mesh=None``)."""


class ElasticReplanError(TopologyMismatchError):
    """The topology change cannot be re-planned automatically — a preserved
    model-sharding extent does not divide the new device count, or the
    global batch cannot be laid out on the re-solved batch extent."""


def record_axes(record_or_axes: Mapping) -> "dict[str, int]":
    """Normalize a sharding record (``{"mesh": {axis: size}, "specs": ...}``)
    or a bare axis-size mapping into ``{axis: int}``."""
    axes = record_or_axes.get("mesh", record_or_axes)
    return {str(k): int(v) for k, v in axes.items()}


def axes_device_product(axes: Mapping[str, int]) -> int:
    """The device count a mesh with these axis sizes covers."""
    product = 1
    for size in axes.values():
        product *= int(size)
    return product


def validate_topology(
    record: Mapping, device_count: int, *, name: str = "checkpoint"
) -> None:
    """Raise :class:`TopologyMismatchError` when ``record``'s mesh axes do
    not multiply out to ``device_count`` — the up-front check that turns an
    opaque restore failure into an error naming both topologies."""
    axes = record_axes(record)
    saved = axes_device_product(axes)
    if saved == int(device_count):
        return
    raise TopologyMismatchError(
        f"{name} was written on a {saved}-device mesh {axes}, but this "
        f"backend has {device_count} devices. Re-plan the restore for the "
        "current topology (Trainer does this automatically for mesh=None — "
        "parallel.elastic.replan), or pass allow_topology_change=True with "
        "a restore target already laid out for the current backend."
    )


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """One solved topology change: the re-planned mesh + accumulation."""

    old_axes: "dict[str, int]"
    new_axes: "dict[str, int]"
    mesh_config: MeshConfig
    old_accum_steps: int
    accum_steps: int
    reason: str

    @property
    def old_devices(self) -> int:
        return axes_device_product(self.old_axes)

    @property
    def new_devices(self) -> int:
        return axes_device_product(self.new_axes)

    def event_fields(self) -> dict:
        """The ``elastic_restore`` telemetry event's payload
        (docs/observability.md)."""
        return {
            "from_mesh": dict(self.old_axes),
            "to_mesh": dict(self.new_axes),
            "from_devices": self.old_devices,
            "to_devices": self.new_devices,
            "old_accum_steps": self.old_accum_steps,
            "accum_steps": self.accum_steps,
            "reason": self.reason,
        }


def replan_accum(
    batch_size: int, old_extent: int, new_extent: int, old_accum: int = 1
) -> int:
    """The re-planned grad-accumulation factor for a batch-extent change.

    Invariants: the effective global batch never changes (accumulation only
    splits one optimizer step's gradient mean into microbatch partial means);
    per-shard microbatch rows never exceed the original run's (an elastic
    shrink cannot exceed the activation memory the old config fit in); and
    ``batch % (new_extent * accum) == 0`` (the engine's microbatch reshape +
    batch-sharding contract). Picks the *smallest* such factor, so a grow
    relaxes accumulation symmetrically.
    """
    batch_size, old_extent, new_extent = int(batch_size), int(old_extent), int(new_extent)
    old_accum = max(1, int(old_accum))
    if batch_size % new_extent:
        raise ElasticReplanError(
            f"global batch_size {batch_size} is not divisible by the "
            f"re-planned batch-shard extent {new_extent}: no accumulation "
            "factor can fix row placement. Round batch_size to a multiple "
            f"of {new_extent}, or resume on a device count whose batch "
            "extent divides it."
        )
    # Per-shard microbatch rows of the ORIGINAL config — the memory budget
    # the re-plan must stay inside. A config that was itself un-divisible
    # (never dispatched) still yields a sane floor.
    old_rows = max(1, batch_size // (old_extent * old_accum))
    max_accum = batch_size // new_extent  # 1 row per shard per microbatch
    for accum in range(1, max_accum + 1):
        if batch_size % (new_extent * accum):
            continue
        if batch_size // (new_extent * accum) <= old_rows:
            return accum
    # Unreachable: accum == max_accum always qualifies (divides by the guard
    # above, and its 1 row/shard <= old_rows which is clamped >= 1).
    raise AssertionError("replan_accum: no divisible accumulation factor")


def replan_reader(plan_or_axes, *, shard_sizes, global_batch_size: int, cursor: int, process_index: int = 0,
                  process_count: int = 1) -> dict:
    """Re-split the streaming shard assignment for a re-planned topology: the data-plane
    half of an elastic resume. It needs the streaming reader (``data/streaming/``), which
    is not ported, so it raises."""
    raise NotImplementedError(
        "replan_reader re-splits the streaming reader's shard assignment, and data streaming is not in the port "
        "yet: ROADMAP.md Queue 1 item 5 (data/streaming/, R1)"
    )


def nearest_divisible_accum(
    batch_size: int, extent: int, accum: int
) -> "int | None":
    """The accumulation factor closest to ``accum`` (ties to the smaller)
    satisfying the engine's microbatch contract
    ``batch % (extent * accum) == 0`` — the fail-fast suggestion the
    trainer's post-replan re-validation attaches. None when ``extent`` does
    not divide ``batch`` at all (no factor can fix row placement)."""
    batch_size, extent, accum = int(batch_size), int(extent), max(1, int(accum))
    if extent <= 0 or batch_size % extent:
        return None
    per_shard = batch_size // extent
    divisors = [d for d in range(1, per_shard + 1) if per_shard % d == 0]
    return min(divisors, key=lambda d: (abs(d - accum), d))


def replan(
    record_or_axes: Mapping,
    device_count: int,
    *,
    batch_size: int | None = None,
    accum_steps: int = 1,
) -> ElasticPlan:
    """Solve a saved mesh's axes for ``device_count`` devices.

    ``record_or_axes`` is the checkpoint's sharding record (or its bare
    ``mesh`` axes). ``batch_size``/``accum_steps`` are the resumed run's
    *configured* values (the same script config the interrupted run used);
    when ``batch_size`` is given, divisibility is validated and the
    accumulation factor re-solved (see :func:`replan_accum`), else
    accumulation passes through unchanged.
    """
    old_axes = record_axes(record_or_axes)
    device_count = int(device_count)
    if device_count < 1:
        raise ValueError(f"device_count must be >= 1, got {device_count}")
    unknown = [a for a in old_axes if a not in AXIS_ORDER]
    if unknown:
        raise ElasticReplanError(
            f"saved mesh {old_axes} names unknown axes {unknown}; known "
            f"axes are {AXIS_ORDER} — cannot re-plan a mesh this library "
            "did not lay out."
        )
    preserved = {
        axis: old_axes.get(axis, 1)
        for axis in PRESERVED_AXES
        if old_axes.get(axis, 1) > 1
    }
    preserved_product = axes_device_product(preserved)
    if device_count % preserved_product:
        raise ElasticReplanError(
            f"cannot re-plan the saved {axes_device_product(old_axes)}-device "
            f"mesh {old_axes} onto {device_count} devices: the preserved "
            f"model-sharding extents {preserved} (product {preserved_product}) "
            f"do not divide {device_count}. Tensor/seq/pipe/expert extents "
            "shape per-leaf partition sizes and are never re-solved — resume "
            "on a multiple of their product, or rebuild the run with a new "
            "explicit mesh."
        )
    new_extent = device_count // preserved_product
    old_fsdp = old_axes.get(FSDP_AXIS, 1)
    old_extent = old_axes.get(DATA_AXIS, 1) * old_fsdp
    # fsdp takes the largest share that both divides the new extent and
    # divides the OLD fsdp extent (gcd): every leaf the old mesh sharded
    # over fsdp stays divisible by construction; growth lands on `data`.
    new_fsdp = math.gcd(old_fsdp, new_extent)
    new_data = new_extent // new_fsdp
    new_axes = {DATA_AXIS: new_data}
    if new_fsdp > 1:
        new_axes[FSDP_AXIS] = new_fsdp
    new_axes.update(preserved)
    new_axes = {a: new_axes[a] for a in AXIS_ORDER if a in new_axes}
    new_accum = max(1, int(accum_steps))
    if batch_size is not None:
        new_accum = replan_accum(
            batch_size, old_extent, new_extent, old_accum=accum_steps
        )
    old_devices = axes_device_product(old_axes)
    direction = "shrink" if device_count < old_devices else "grow"
    config_kwargs = {
        name: size for name, size in new_axes.items() if name != DATA_AXIS
    }
    return ElasticPlan(
        old_axes=old_axes,
        new_axes=new_axes,
        mesh_config=MeshConfig(data=new_data, **config_kwargs),
        old_accum_steps=max(1, int(accum_steps)),
        accum_steps=new_accum,
        reason=f"{direction} {old_devices}->{device_count} devices",
    )


def replan_excluding(
    record_or_axes: Mapping,
    device_ids,
    exclude,
    *,
    batch_size: int | None = None,
    accum_steps: int = 1,
) -> ElasticPlan:
    """Re-plan a saved mesh onto the survivors of a degraded fleet: the
    devices in ``device_ids`` minus the ``exclude`` set — the fleet
    controller's straggler-remediation entry (a persistent ``straggler``
    verdict names a chip; the remediation is a restart onto the M−1 healthy
    devices, solved by the same :func:`replan` rules an ordinary elastic
    shrink uses).

    ``device_ids`` is the CURRENT topology's device-id set (plain ints, so
    a supervising controller can plan feasibility without a world of its
    own); ``exclude`` the degraded ids to drop. Excluded ids not
    present are ignored (the chip may already be gone). Raises
    :class:`ElasticReplanError` when no devices survive; divisibility
    failures (a preserved model axis not dividing M−1, the global batch
    not fitting the shrunk extent) propagate from :func:`replan` — the
    controller treats any of these as "cannot remediate, surface to a
    human"."""
    ids = [int(d) for d in device_ids]
    dropped = sorted({int(d) for d in exclude} & set(ids))
    survivors = [d for d in ids if d not in set(dropped)]
    if not survivors:
        raise ElasticReplanError(
            f"excluding {sorted(int(d) for d in exclude)} from devices "
            f"{sorted(ids)} leaves no survivors — nothing to re-plan onto."
        )
    plan = replan(
        record_or_axes,
        len(survivors),
        batch_size=batch_size,
        accum_steps=accum_steps,
    )
    return dataclasses.replace(
        plan,
        reason=plan.reason
        + f" (excluding degraded chip(s) {','.join(str(d) for d in dropped)})",
    )


def replan_absorbing(
    record_or_axes: Mapping,
    device_ids,
    absorb,
    *,
    batch_size: int | None = None,
    accum_steps: int = 1,
) -> ElasticPlan:
    """:func:`replan_excluding`'s grow twin: re-plan a mesh onto
    the devices in ``device_ids`` PLUS the offered ``absorb`` ids — the
    fleet controller's chip-offer actuation entry. When a trainer's
    ``restart_excluding`` frees a chip, the accepted offer re-plans the
    serving replica's mesh onto its current devices plus the freed one
    through the same solver rules an elastic grow uses (model-sharding
    axes preserved-or-refused, the extra device landing on the batch
    axes). Offered ids already present are ignored (idempotent re-offer);
    divisibility failures propagate as :class:`ElasticReplanError` — the
    controller treats them as "cannot absorb, revert the handshake"."""
    ids = [int(d) for d in device_ids]
    added = sorted({int(d) for d in absorb} - set(ids))
    plan = replan(
        record_or_axes,
        len(ids) + len(added),
        batch_size=batch_size,
        accum_steps=accum_steps,
    )
    if not added:
        return plan
    return dataclasses.replace(
        plan,
        reason=plan.reason
        + f" (absorbing offered chip(s) {','.join(str(d) for d in added)})",
    )
