"""The port's elastic re-plan (``parallel/elastic.py``), the checkpoint's topology check and
resharding record, and the preflight's fsdp recommendation, held against the JAX package.

* **Decisions**: ``replan``, ``replan_accum``, ``replan_excluding``, ``replan_absorbing``
  and ``validate_topology`` over a grid (saved axes dp8, fsdp8, dp2fsdp4, dp2fsdp2tp2 and
  sp4; 1 to 16 devices; global batches 8, 12, 16 and 64; accumulation 1, 2 and 4) give
  equal plans (axes, mesh config, accumulation, reason, event fields) or an error of the
  same type, with the same message.
* **Checkpoints**: a checkpoint whose sharding record covers 4 devices, restored in a
  world of one, raises ``TopologyMismatchError`` with the JAX message naming both
  topologies; with ``allow_topology_change=True`` it restores, and emits the JAX manager's
  ``checkpoint_reshard`` fields exactly; the ``Trainer`` honours an explicit mesh (no
  re-plan) and its ``elastic_restore`` carries the JAX Trainer's fields for both branches.
* **The preflight**: ``recommended_fsdp`` on a pure data mesh of 8 equals the JAX
  search's at four usable limits, one peak model for both (a fixed part plus the
  per-device state bytes of the split).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.checkpoint import manager as jax_manager_lib
from distributed_training_pytorch_tpu.memory import preflight as jax_preflight
from distributed_training_pytorch_tpu.models import transformer_lm as jax_lm
from distributed_training_pytorch_tpu.parallel import elastic as jax_elastic
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.parallel import sharding as jax_sharding
from distributed_training_pytorch_tpu.train import TrainEngine as JaxTrainEngine
from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
from distributed_training_pytorch_tpu_torch.memory import preflight as port_preflight
from distributed_training_pytorch_tpu_torch.models import LMTiny
from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
from distributed_training_pytorch_tpu_torch.parallel import elastic
from distributed_training_pytorch_tpu_torch.parallel.mesh import Mesh, MeshConfig
from distributed_training_pytorch_tpu_torch.train import TrainEngine, TrainState
from distributed_training_pytorch_tpu_torch.trainer import Trainer

SAVED = {
    "dp8": {"data": 8},
    "fsdp8": {"data": 1, "fsdp": 8},
    "dp2fsdp4": {"data": 2, "fsdp": 4},
    "dp2fsdp2tp2": {"data": 2, "fsdp": 2, "tensor": 2},
    "sp4": {"data": 1, "seq": 4},
}
DEVICES = range(1, 17)
BATCHES = (8, 12, 16, 64)
ACCUMS = (1, 2, 4)
CONFIG_FIELDS = ("data", "fsdp", "pipe", "expert", "seq", "tensor")
RECORD = {"mesh": {"data": 1, "fsdp": 4}, "specs": {"embed.weight": "PartitionSpec(None, 'fsdp')"}}


def _outcome(fn, *args, **kw):
    """A plan as comparable fields, or the error's type name and message."""
    try:
        plan = fn(*args, **kw)
    except (elastic.ElasticReplanError, jax_elastic.ElasticReplanError, ValueError) as e:
        return ("error", type(e).__name__, str(e))
    if isinstance(plan, int) or plan is None:
        return plan
    return (plan.old_axes, plan.new_axes, tuple(getattr(plan.mesh_config, f) for f in CONFIG_FIELDS),
            plan.old_accum_steps, plan.accum_steps, plan.reason, plan.event_fields(), plan.old_devices,
            plan.new_devices)


@pytest.mark.parametrize("devices", DEVICES)
@pytest.mark.parametrize("saved", SAVED)
def test_replan_equals_jax(saved, devices):
    axes = SAVED[saved]
    assert _outcome(elastic.replan, axes, devices) == _outcome(jax_elastic.replan, axes, devices)
    record = {"mesh": axes, "specs": {}}
    for batch in BATCHES:
        for accum in ACCUMS:
            kw = dict(batch_size=batch, accum_steps=accum)
            got = _outcome(elastic.replan, record, devices, **kw)
            assert got == _outcome(jax_elastic.replan, record, devices, **kw), (saved, devices, batch, accum)
            old_extent = axes.get("data", 1) * axes.get("fsdp", 1)
            got = _outcome(elastic.replan_accum, batch, old_extent, devices, accum)
            assert got == _outcome(jax_elastic.replan_accum, batch, old_extent, devices, accum)
            got = elastic.nearest_divisible_accum(batch, devices, accum)
            assert got == jax_elastic.nearest_divisible_accum(batch, devices, accum)


@pytest.mark.parametrize("saved", SAVED)
def test_replan_excluding_and_absorbing_equal_jax(saved):
    axes = SAVED[saved]
    ids = list(range(elastic.axes_device_product(axes)))
    for exclude in ([], [0], [1, 3], [99], ids, ids[:-1]):
        for batch in (None, 8, 16):
            kw = {} if batch is None else dict(batch_size=batch, accum_steps=2)
            assert (_outcome(elastic.replan_excluding, axes, ids, exclude, **kw)
                    == _outcome(jax_elastic.replan_excluding, axes, ids, exclude, **kw)), (exclude, batch)
    for absorb in ([], [len(ids)], [len(ids), len(ids) + 1], [0], list(range(len(ids), 3 * len(ids)))):
        for batch in (None, 8, 64):
            kw = {} if batch is None else dict(batch_size=batch)
            assert (_outcome(elastic.replan_absorbing, axes, ids, absorb, **kw)
                    == _outcome(jax_elastic.replan_absorbing, axes, ids, absorb, **kw)), (absorb, batch)


@pytest.mark.parametrize("saved", SAVED)
def test_validate_topology_and_record_helpers_equal_jax(saved):
    axes = SAVED[saved]
    record = {"mesh": axes, "specs": {}}
    assert elastic.record_axes(record) == jax_elastic.record_axes(record) == elastic.record_axes(axes)
    assert elastic.axes_device_product(axes) == jax_elastic.axes_device_product(axes)
    for devices in DEVICES:
        outcomes = []
        for fn in (elastic.validate_topology, jax_elastic.validate_topology):
            try:
                outcomes.append(fn(record, devices, name="checkpoint 'last'"))
            except Exception as e:  # noqa: BLE001 — compared by type name and message
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1], devices
    assert issubclass(elastic.ElasticReplanError, elastic.TopologyMismatchError)


def test_unknown_axes_and_the_reader_refuse():
    with pytest.raises(elastic.ElasticReplanError, match="unknown axes"):
        elastic.replan({"data": 2, "bogus": 2}, 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        elastic.replan_reader({"data": 1}, shard_sizes=[4], global_batch_size=4, cursor=0)


# -- checkpoints --------------------------------------------------------------


def _state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    return TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), step=seed)


class _Events:
    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append((event, fields))


def test_a_recorded_topology_is_checked_before_the_restore(tmp_path):
    manager = CheckpointManager(tmp_path)
    manager.save("last", _state(3), epoch=2, sharding=RECORD)
    meta = manager.read_meta("last")
    assert meta["sharding"] == RECORD
    target = _state(0)
    with pytest.raises(elastic.TopologyMismatchError) as err:
        manager.restore("last", target)
    try:
        jax_elastic.validate_topology(RECORD, 1, name="checkpoint 'last'")
    except jax_elastic.TopologyMismatchError as e:
        assert str(err.value) == str(e)
    assert "4-device mesh {'data': 1, 'fsdp': 4}" in str(err.value) and "has 1 devices" in str(err.value)
    assert target.step == 0  # nothing was read
    manager.event_log = _Events()
    state, epoch = manager.restore("last", target, allow_topology_change=True)
    assert epoch == 2 and state.step == 3
    for key, value in _state(3).model.state_dict().items():
        assert torch.equal(state.params[key], value)
    # The JAX manager's record of the same resharding restore (its target replicated).
    jax_mgr = jax_manager_lib.CheckpointManager.__new__(jax_manager_lib.CheckpointManager)
    jax_mgr.event_log = _Events()
    jax_mgr._note_reshard("last", meta, {"w": np.zeros(2)})
    assert manager.event_log.records == jax_mgr.event_log.records
    assert manager.event_log.records[0][0] == "checkpoint_reshard"
    # a record-less checkpoint has no topology to check, and no reshard to note
    manager.save("plain", _state(4), epoch=1)
    assert "sharding" not in manager.read_meta("plain")
    manager.event_log = _Events()
    manager.restore("plain", _state(0))
    assert manager.event_log.records == []


class _Tiny(Trainer):
    def build_train_dataset(self):
        rows = np.random.RandomState(0).randint(0, 256, size=(16, 9)).astype(np.int32)
        return ArrayDataSource(image=rows[:, :-1], label=rows[:, 1:])

    def build_model(self):
        return LMTiny(device="cpu")

    def build_criterion(self):
        return None

    def build_loss_fn(self):
        return make_fused_lm_loss(self.model)

    def build_scheduler(self):
        return 0.1

    def build_optimizer(self, schedule):
        return torch.optim.SGD(self.model.parameters(), lr=0.1)


def test_the_trainer_honours_an_explicit_mesh_and_emits_the_jax_fields(tmp_path, monkeypatch):
    writer = _Tiny(max_epoch=1, batch_size=8, save_folder=str(tmp_path / "w"), device="cpu", async_checkpoint=False)
    writer.checkpoints.save("last", writer.state, 1, sharding=RECORD)
    emitted = []
    monkeypatch.setattr("distributed_training_pytorch_tpu_torch.telemetry.events.EventLog.emit",
                        lambda self, event, **fields: emitted.append((event, fields)))
    ckpt = str(tmp_path / "w" / "weights" / "last")
    honoured = _Tiny(max_epoch=1, batch_size=8, save_folder=str(tmp_path / "h"), device="cpu", snapshot_path=ckpt,
                     mesh=MeshConfig(data=1).build(), accum_steps=2, async_checkpoint=False)
    assert honoured.accum_steps == honoured.engine.accum_steps == 2 and honoured._elastic_plan is None
    replanned = _Tiny(max_epoch=1, batch_size=8, save_folder=str(tmp_path / "r"), device="cpu", snapshot_path=ckpt,
                      async_checkpoint=False)
    assert replanned.accum_steps == 4
    events = [f for e, f in emitted if e == "elastic_restore"]
    assert [e["replanned"] for e in events] == [False, True]
    jax_fields = set(jax_elastic.replan(RECORD, 1).event_fields()) | {"name", "replanned"}
    assert all(set(e) == jax_fields for e in events)
    assert events[0]["reason"] == "explicit mesh (no re-plan)" and events[0]["to_mesh"] == {"data": 1}
    assert events[1]["reason"] == "shrink 4->1 devices" and events[1]["accum_steps"] == 4
    assert len([e for e, _ in emitted if e == "checkpoint_reshard"]) == 2
    assert jax_elastic.nearest_divisible_accum(12, 1, 8) == 6
    with pytest.raises(ValueError, match="Nearest divisible accum_steps: 6"):
        _Tiny(max_epoch=1, batch_size=12, save_folder=str(tmp_path / "x"), device="cpu", snapshot_path=ckpt,
              mesh=MeshConfig(data=1).build(), accum_steps=8, async_checkpoint=False)


# -- the preflight's fsdp recommendation ---------------------------------------------


@pytest.mark.parametrize("fits", [2, 4, 8, None])
def test_recommended_fsdp_equals_the_jax_search(devices, monkeypatch, fits):
    jax_model = jax_lm.LMTiny(vocab_size=256)
    engine = JaxTrainEngine(jax_lm.make_fused_lm_loss(jax_model), optax.adamw(1e-3), jax_mesh.create_mesh({"data": 8}),
                            fsdp_min_size=1024)
    jax_state = engine.init_state(jax.random.key(0), lambda r: jax_model.init(r, jnp.zeros((1, 16), jnp.int32)))
    fixed = 10_000_000

    def state_bytes(engine_, state_):
        sh = jax_sharding.state_shardings(state_, engine_.mesh, engine_.sharding_rules or (),
                                          fsdp_min_size=engine_.fsdp_min_size)
        return (jax_sharding.tree_shard_bytes(state_.params, sh.params)
                + jax_sharding.tree_shard_bytes(state_.opt_state, sh.opt_state))

    def jax_predict(engine_, state_, batch_, chain_length, report):
        report.trials += 1
        return fixed + state_bytes(engine_, state_)

    def port_predict(engine_, state_, batch_, chain_length, report, staged_units):
        report.trials += 1
        return report.predicted_peak_bytes

    monkeypatch.setattr(jax_preflight, "_predict", jax_predict)
    monkeypatch.setattr(port_preflight, "_predict", port_predict)
    levels = {f: fixed + state_bytes(engine.with_mesh(jax_mesh.create_mesh({"data": 8 // f, "fsdp": f})), jax_state)
              for f in (2, 4, 8)}
    whole = fixed + state_bytes(engine, jax_state)
    usable = levels[fits] if fits is not None else levels[8] - 1
    jax_report = jax_preflight.PreflightReport(predicted_peak_bytes=whole, batch_size=96, profile=None,
                                              usable_bytes=usable)
    batch = {"image": jax.ShapeDtypeStruct((96, 16), jnp.int32), "label": jax.ShapeDtypeStruct((96, 16), jnp.int32)}
    jax_preflight._recommend(engine, jax_state, batch, jax_preflight.Preflight(), jax_report, None)

    model = LMTiny(device="cpu")
    params = sum(p.numel() * 4 for p in model.parameters())
    scalars = whole - fixed - 3 * params  # optax's counters: replicated, in both peaks
    classes = {"params": params, "gradients": 0, "optimizer_state": 2 * params, "activations": fixed + scalars}
    profile = types.SimpleNamespace(bytes_by_class=classes, fractions=lambda: {k: v / whole for k, v in classes.items()})
    port = TrainEngine(make_fused_lm_loss(model), mesh=Mesh({"data": 8, "seq": 1}, 0, (0,)), fsdp_min_size=1024)
    state = TrainState(model=model, optimizer=torch.optim.AdamW(model.parameters()))
    report = port_preflight.PreflightReport(predicted_peak_bytes=whole, batch_size=96, profile=profile,
                                            usable_bytes=usable)
    port_batch = {k: torch.empty(96, 16, dtype=torch.int32, device="meta") for k in ("image", "label")}
    port_preflight._recommend(port, state, port_batch, port_preflight.Preflight(), report, None, 0)
    assert report.recommended_fsdp == jax_report.recommended_fsdp == fits
    assert (report.recommended_batch, report.recommended_accum) == (jax_report.recommended_batch,
                                                                    jax_report.recommended_accum) == (None, None)
    if fits is not None:
        assert f"enable fsdp={fits}" in port_preflight._failure_message(report)
