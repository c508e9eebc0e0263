"""The port's sharded state (``parallel/sharding.py``, ``parallel/layout.py``) against the
JAX package's ``state_shardings`` and ``TrainEngine`` on the same axes and weights.

* **Leaf decisions**, from axis sizes alone: an ``LMTiny`` at ``fsdp_min_size=1024`` on
  the conftest's 8 CPU devices as ``fsdp8``, ``fsdp4x2``, ``tp2x4`` and ``dp2fsdp2tp2``
  (with ``default_sharding_rules``): the same set of sharded leaves, mapped through
  ``models/convert.py``'s name map, each over the same axis, and the same per-device
  bytes as the JAX ``tree_shard_bytes``. On each tensor rank the port's qkv shard holds
  exactly its heads' q, k and v: the JAX kernel's slice on that device, converted.
* **Four gloo ranks, one launch**: the port's ``Trainer`` under ``fsdp4``, ``fsdp2tp2`` and
  ``dp4`` (no fsdp or tensor axis: DDP, no layout) takes three SGD steps (momentum 0.9) on
  the JAX-initialised weights, saving ``last`` after the second. The losses and the
  parameters after each run are held against the JAX engine on a mesh of 4 devices with
  the same axes, and ``dp4``'s against one process of the port.
* **The elastic resume**: the ``fsdp4`` checkpoint resumed by one process with
  ``mesh=None`` re-plans to ``{"data": 1}`` with ``accum_steps=4``, restores the gathered
  parameters bit for bit, emits one ``elastic_restore`` and one ``checkpoint_reshard``, and
  its first step equals the four ranks' third; the ``fsdp2tp2`` checkpoint is refused
  with ``ElasticReplanError``, naming both topologies, before any restore.

Tolerances, f32: against the JAX engine 2e-5 on the losses and 1e-5 on the parameters
(the port's fused tied CE against the JAX logits' softmax, and the shards' reduction
order); the port's own layouts against each other and the resume against the
continuation 1e-6 (the same arithmetic, another order of the same sums).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_pytorch_tpu.models.transformer_lm import LMTiny as JaxLMTiny
from distributed_training_pytorch_tpu.ops import cross_entropy_loss
from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu.parallel import sharding as jax_sharding
from distributed_training_pytorch_tpu.train import TrainEngine as JaxEngine
from distributed_training_pytorch_tpu_torch.models import LMTiny, params_from_jax
from distributed_training_pytorch_tpu_torch.parallel import sharding
from distributed_training_pytorch_tpu_torch.parallel.elastic import ElasticReplanError
from distributed_training_pytorch_tpu_torch.parallel.layout import _part

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SIZE = 1024
SEQ, BATCH, LR, STEPS = 16, 8, 0.1, 3
JAX_ATOL_LOSS, JAX_ATOL_PARAMS = 2e-5, 1e-5
PORT_ATOL = 1e-6
SPECS = ["fsdp4", "fsdp2tp2", "dp4"]


def _flat_paths(tree):
    return {jax.tree_util.keystr(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _name_map(abstract_params):
    """JAX leaf path -> port parameter name, through ``params_from_jax``: every leaf filled
    with its own index, converted, and read back."""
    paths = list(_flat_paths(abstract_params))
    leaves = jax.tree_util.tree_leaves(abstract_params)
    filled = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(abstract_params),
        [np.full(leaf.shape, float(i), np.float32) for i, leaf in enumerate(leaves)],
    )
    out = {}
    for name, value in params_from_jax(filled).items():
        out[paths[int(value.reshape(-1)[0])]] = name
    return out


def _jax_lm_params():
    model = JaxLMTiny()
    return model, jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, SEQ), jnp.int32)))["params"]


@pytest.mark.parametrize("spec", ["fsdp8", "fsdp4x2", "tp2x4", "dp2fsdp2tp2"])
def test_leaf_decisions_and_bytes_equal_jax_state_shardings(devices, spec):
    mesh = jax_mesh.mesh_config_from_spec(spec).build()
    rules = jax_sharding.default_sharding_rules(mesh)
    _, abstract = _jax_lm_params()
    shardings = jax_sharding.state_shardings(abstract, mesh, rules or (), fsdp_min_size=MIN_SIZE)
    names = _name_map(abstract)
    want = {}
    for path, s in _flat_paths(shardings).items():
        axes = {a for entry in s.spec if entry is not None for a in ((entry,) if isinstance(entry, str) else entry)}
        if axes:
            want[names[path]] = axes

    axes = {str(k): int(v) for k, v in mesh.shape.items()}  # axis sizes alone: no world
    model = LMTiny(device="cpu")
    specs = sharding.state_shardings(model, axes, sharding.default_sharding_rules(axes), fsdp_min_size=MIN_SIZE)
    got = {}
    for name, s in specs.items():
        named = {e.axis if isinstance(e, sharding.Strided) else e for e in s if e is not None}
        if named:
            got[name] = named
    assert got == want
    assert sharding.tree_shard_bytes(model, specs, axes) == jax_sharding.tree_shard_bytes(abstract, shardings)
    record = sharding.sharding_record(specs, axes)
    assert record["mesh"] == axes and set(record["specs"]) == set(want)
    # the optimizer's state takes its parameter's spec
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    sum(p.sum() for p in model.parameters()).backward()
    opt.step()
    with_state = sharding.state_shardings(model, axes, sharding.default_sharding_rules(axes), fsdp_min_size=MIN_SIZE,
                                          optimizer=opt)
    assert with_state == {**specs, **{f"{n}/momentum_buffer": s for n, s in specs.items()}}


@pytest.mark.parametrize("spec", ["tp4x2", "tp2x4", "dp2fsdp2tp2"])
def test_tensor_rules_split_whole_heads_as_jax(devices, spec):
    """Six heads of 16 (D=96): a tensor axis of 4 divides D but not the heads. The JAX
    rule on ``[D, 3, H, Dh]`` then does not fit (it warns and falls back); the port's
    ``[3 D, D]`` leaf must fall back too, through the layer's ``split_unit``."""
    from distributed_training_pytorch_tpu.models.transformer_lm import TransformerLM as JaxLM
    from distributed_training_pytorch_tpu_torch.models import TransformerLM

    mesh = jax_mesh.mesh_config_from_spec(spec).build()
    dims = dict(vocab_size=256, hidden_dim=96, depth=1, num_heads=6, mlp_dim=192, max_len=32)
    abstract = jax.eval_shape(lambda: JaxLM(**dims).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    shardings = jax_sharding.state_shardings(abstract, mesh, jax_sharding.default_sharding_rules(mesh) or (),
                                             fsdp_min_size=MIN_SIZE)
    names = _name_map(abstract)
    want = {names[p]: str(s.spec) for p, s in _flat_paths(shardings).items() if any(e is not None for e in s.spec)}
    axes = {str(k): int(v) for k, v in mesh.shape.items()}
    model = TransformerLM(**dims, device="cpu")
    specs = sharding.state_shardings(model, axes, sharding.default_sharding_rules(axes), fsdp_min_size=MIN_SIZE)
    got = {n: str(s) for n, s in specs.items() if any(e is not None for e in s)}
    assert set(got) == set(want)
    assert ("blocks.0.qkv.weight" in got) == (axes["tensor"] == 2) == ("blocks.0.attn_out.weight" in got)
    assert sharding.tree_shard_bytes(model, specs, axes) == jax_sharding.tree_shard_bytes(abstract, shardings)


def test_the_qkv_shard_of_each_tensor_rank_holds_its_heads(devices):
    mesh = jax_mesh.mesh_config_from_spec("tp2x4").build()
    model, abstract = _jax_lm_params()
    params = jax.tree.map(np.asarray, model.init(jax.random.key(3), jnp.zeros((1, SEQ), jnp.int32))["params"])
    kernel = params["DecoderBlock_0"]["qkv"]["kernel"]  # [D, 3, H, Dh]
    bias = params["DecoderBlock_0"]["qkv"]["bias"]  # [3, H, Dh]
    port = params_from_jax(params)
    spec_w = sharding.transformer_tp_rules()[0][1]
    assert sharding.rule_for_leaf("blocks.0.qkv.weight", tuple(port["blocks.0.qkv.weight"].shape), dict(mesh.shape),
                                  sharding.transformer_tp_rules())[1] == spec_w
    jax_spec = jax_sharding.spec_for_leaf("['DecoderBlock_0']['qkv']['kernel']", kernel.shape, mesh,
                                          jax_sharding.transformer_tp_rules(), fsdp_min_size=MIN_SIZE)
    named = jax.sharding.NamedSharding(mesh, jax_spec)
    names = list(mesh.axis_names)
    seen = set()
    for device, index in named.devices_indices_map(kernel.shape).items():
        coords = np.argwhere(mesh.devices == device)[0]
        t = int(coords[names.index("tensor")])
        heads = kernel[index]  # [D, 3, H / 2, Dh]: this device's heads' q, k and v
        want_w = torch.tensor(heads.reshape(heads.shape[0], -1).T)
        want_b = torch.tensor(bias[:, index[2]].reshape(-1))
        assert torch.equal(_part(port["blocks.0.qkv.weight"], 0, 3, 2, t), want_w)
        assert torch.equal(_part(port["blocks.0.qkv.bias"], 0, 3, 2, t), want_b)
        seen.add(t)
    assert seen == {0, 1}


# -- four gloo ranks ----------------------------------------------------------------

_COMMON = textwrap.dedent(
    """
    import numpy as np
    import torch

    from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
    from distributed_training_pytorch_tpu_torch.models import LMTiny
    from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
    from distributed_training_pytorch_tpu_torch.trainer import Trainer


    class ShardedLM(Trainer):
        def __init__(self, rows, weights, lr, **kw):
            self.rows, self.weights, self.lr = rows, weights, lr
            super().__init__(**kw)

        def build_train_dataset(self):
            return ArrayDataSource(image=self.rows[:, :-1], label=self.rows[:, 1:])

        def build_model(self):
            model = LMTiny(device="cpu")
            model.load_state_dict(torch.load(self.weights))
            return model

        def build_criterion(self):
            return None

        def build_loss_fn(self):
            return make_fused_lm_loss(self.model)

        def build_scheduler(self):
            return self.lr

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=self.lr, momentum=0.9)


    def local_batch(rows, step, batch, mesh):
        glob = rows[step * batch:(step + 1) * batch]
        n = batch // mesh.batch_extent
        part = glob[mesh.batch_index * n:(mesh.batch_index + 1) * n]
        return {"image": torch.tensor(part[:, :-1]), "label": torch.tensor(part[:, 1:])}
    """
)

_RANK_SIDE = _COMMON + textwrap.dedent(
    """
    import sys

    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    init, rank, folder, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    batch, lr, steps = int(sys.argv[5]), float(sys.argv[6]), int(sys.argv[7])
    specs = sys.argv[8].split(",")
    rows = np.load(folder + "/rows.npy")
    mesh_lib.setup_distributed(init, world_size=4, rank=rank, backend="gloo")
    result = {}
    for spec in specs:
        mesh = mesh_lib.mesh_config_from_spec(spec).build()
        trainer = ShardedLM(rows, folder + "/weights.pt", lr, max_epoch=1, batch_size=batch,
                            save_folder=f"{folder}/{spec}", mesh=mesh, device="cpu", fsdp_min_size=1024,
                            async_checkpoint=False)
        r = {"ddp": isinstance(trainer.model, torch.nn.parallel.DistributedDataParallel),
             "layout": trainer.state.layout is not None, "record": trainer.state.sharding, "losses": []}
        for step in range(steps):
            if step == 2:
                r["saved"] = {k: v.clone() for k, v in trainer.state.params.items()}  # collective under a layout
                trainer.checkpoints.save("last", trainer.state, 1)
            trainer.state, metrics = trainer.engine.train_step(trainer.state, local_batch(rows, step, batch, mesh))
            r["losses"].append(float(metrics["loss"]))
        r["params"] = trainer.state.params
        result[spec] = r
    if rank == 0:
        torch.save(result, out)
    mesh_lib.shutdown_distributed()
    """
)


def _jax_run(devices, rows, spec, init_params=None):
    """The JAX engine on 4 devices with ``spec``'s axes: per-step losses, the params."""
    cfg = jax_mesh.mesh_config_from_spec(spec)
    mesh = cfg.build(devices[:4])
    model = JaxLMTiny()

    def lm_loss(params, model_state, batch, rng, train):
        logits = model.apply({"params": params}, batch["image"], train=train)
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]), batch["label"].reshape(-1))
        return loss, ({"loss": loss}, model_state)

    engine = JaxEngine(lm_loss, optax.sgd(LR, momentum=0.9), mesh,
                       sharding_rules=jax_sharding.default_sharding_rules(mesh), fsdp_min_size=MIN_SIZE)
    state = engine.init_state(jax.random.key(0), lambda r: model.init(r, jnp.zeros((1, SEQ), jnp.int32)))
    init = jax.tree.map(np.asarray, jax.device_get(state.params))
    if init_params is not None:
        for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(init_params), strict=True):
            assert np.array_equal(a, b)
    losses = []
    for step in range(STEPS):
        glob = rows[step * BATCH:(step + 1) * BATCH]
        batch = engine.shard_batch({"image": glob[:, :-1], "label": glob[:, 1:]})
        state, metrics = engine.train_step(state, batch)
        losses.append(float(metrics["loss"]))
    return init, losses, params_from_jax(jax.tree.map(np.asarray, jax.device_get(state.params)))


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    """The JAX engine under fsdp4 and fsdp2tp2, then one launch of four gloo ranks."""
    folder = tmp_path_factory.mktemp("sharded")
    rows = np.random.RandomState(5).randint(0, 256, size=(STEPS * BATCH, SEQ + 1)).astype(np.int32)
    np.save(folder / "rows.npy", rows)
    init, fsdp_losses, fsdp_params = _jax_run(devices, rows, "fsdp4")
    _, tp_losses, tp_params = _jax_run(devices, rows, "fsdp2tp2", init)
    torch.save(params_from_jax(init), folder / "weights.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # four ranks share the CPU
    for knob in ("RANK", "WORLD_SIZE", "MESH"):
        env.pop(knob, None)
    out = str(folder / "ranks.pt")
    procs = [
        subprocess.Popen([sys.executable, "-c", _RANK_SIDE, f"tcp://localhost:{port}", str(rank), str(folder), out,
                          str(BATCH), str(LR), str(STEPS), ",".join(SPECS)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)
    ]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, logs
    return {"folder": str(folder), "rows": rows, "ranks": torch.load(out, weights_only=False),
            "jax": {"fsdp4": (fsdp_losses, fsdp_params), "fsdp2tp2": (tp_losses, tp_params)}}


@pytest.mark.parametrize("spec", ["fsdp4", "fsdp2tp2"])
def test_four_ranks_train_as_the_jax_engine_on_the_same_axes(runs, spec):
    got = runs["ranks"][spec]
    losses, params = runs["jax"][spec]
    assert got["layout"] and not got["ddp"] and got["record"]["mesh"] == {
        "fsdp4": {"data": 1, "fsdp": 4}, "fsdp2tp2": {"data": 1, "fsdp": 2, "tensor": 2}}[spec]
    np.testing.assert_allclose(got["losses"], losses, atol=JAX_ATOL_LOSS, rtol=0)
    assert got["params"].keys() == params.keys()
    for name, value in params.items():
        np.testing.assert_allclose(got["params"][name].numpy(), value.numpy(), atol=JAX_ATOL_PARAMS, rtol=0,
                                   err_msg=f"{spec} {name}")


def test_without_fsdp_or_tensor_the_step_is_ddps_as_before(runs):
    """``dp4``: DDP over the data group, no layout, no sharding record, and the steps of
    one process on the whole batch."""
    from distributed_training_pytorch_tpu_torch.models import LMTiny as PortLMTiny  # noqa: F401

    got = runs["ranks"]["dp4"]
    assert got["ddp"] and not got["layout"] and got["record"] is None
    namespace = {}
    exec(compile(_COMMON, "<sharding-common>", "exec"), namespace)
    folder = runs["folder"]
    one = namespace["ShardedLM"](runs["rows"], folder + "/weights.pt", LR, max_epoch=1, batch_size=BATCH,
                                 save_folder=folder + "/one", device="cpu", async_checkpoint=False)
    assert one.state.layout is None and one.state.sharding is None
    losses = []
    for step in range(STEPS):
        one.state, m = one.engine.train_step(one.state, namespace["local_batch"](runs["rows"], step, BATCH, one.mesh))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses, atol=PORT_ATOL, rtol=0)
    for name, value in one.state.params.items():
        np.testing.assert_allclose(got["params"][name].numpy(), value.numpy(), atol=PORT_ATOL, rtol=0, err_msg=name)
    # the sharded layouts hold the same global tensors as DDP after the same steps
    for spec in ("fsdp4", "fsdp2tp2"):
        for name, value in got["params"].items():
            np.testing.assert_allclose(runs["ranks"][spec]["params"][name].numpy(), value.numpy(), atol=PORT_ATOL,
                                       rtol=0, err_msg=f"{spec} {name}")


def test_the_fsdp4_checkpoint_resumes_on_one_process_with_accum_4(runs, tmp_path):
    namespace = {}
    exec(compile(_COMMON, "<sharding-common>", "exec"), namespace)
    folder, rows = runs["folder"], runs["rows"]
    ranks = runs["ranks"]["fsdp4"]
    meta = json.load(open(os.path.join(folder, "fsdp4", "weights", "last", "meta.json")))
    assert meta["sharding"] == ranks["record"]
    trainer = namespace["ShardedLM"](rows, folder + "/weights.pt", LR, max_epoch=1, batch_size=BATCH,
                                     save_folder=str(tmp_path / "resume"), device="cpu", async_checkpoint=False,
                                     snapshot_path=os.path.join(folder, "fsdp4", "weights", "last"), telemetry=True)
    assert trainer.mesh.shape["data"] == 1 and not trainer.mesh.sharded and trainer.state.layout is None
    assert trainer.accum_steps == trainer.engine.accum_steps == 4
    for name, value in ranks["saved"].items():
        assert torch.equal(trainer.state.params[name], value), name  # the gathered checkpoint, bit for bit
    trainer.state, metrics = trainer.engine.train_step(trainer.state, namespace["local_batch"](rows, 2, BATCH,
                                                                                               trainer.mesh))
    np.testing.assert_allclose(float(metrics["loss"]), ranks["losses"][2], atol=PORT_ATOL, rtol=0)
    for name, value in trainer.state.params.items():
        np.testing.assert_allclose(value.numpy(), ranks["params"][name].numpy(), atol=PORT_ATOL, rtol=0, err_msg=name)
    events = [json.loads(line) for line in open(tmp_path / "resume" / "telemetry" / "events.jsonl")]
    elastic = [e for e in events if e["event"] == "elastic_restore"]
    assert len(elastic) == 1
    assert {k: elastic[0][k] for k in ("from_mesh", "to_mesh", "from_devices", "to_devices", "old_accum_steps",
                                       "accum_steps", "replanned")} == {
        "from_mesh": {"data": 1, "fsdp": 4}, "to_mesh": {"data": 1}, "from_devices": 4, "to_devices": 1,
        "old_accum_steps": 1, "accum_steps": 4, "replanned": True}
    reshard = [e for e in events if e["event"] == "checkpoint_reshard"]
    assert len(reshard) == 1 and reshard[0]["from_mesh"] == {"data": 1, "fsdp": 4} and reshard[0]["to_mesh"] is None


def test_the_tensor_sharded_checkpoint_is_refused_before_any_restore(runs, tmp_path, monkeypatch):
    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager

    namespace = {}
    exec(compile(_COMMON, "<sharding-common>", "exec"), namespace)
    restores = []
    monkeypatch.setattr(CheckpointManager, "restore", lambda *a, **k: restores.append(a))
    with pytest.raises(ElasticReplanError) as err:
        namespace["ShardedLM"](runs["rows"], runs["folder"] + "/weights.pt", LR, max_epoch=1, batch_size=BATCH,
                               save_folder=str(tmp_path), device="cpu",
                               snapshot_path=os.path.join(runs["folder"], "fsdp2tp2", "weights", "last"))
    assert "{'data': 1, 'fsdp': 2, 'tensor': 2}" in str(err.value) and "onto 1 devices" in str(err.value)
    assert restores == []


def test_a_layout_loads_a_multi_group_optimizer_state_in_the_models_order():
    """A checkpoint of a run without the layout (AdamW in two groups, each in the model's
    order) loads into a layout's optimizer, whose groups list the parametrized shards after
    their modules' other parameters: each shard's moments are its part of the whole's."""
    from distributed_training_pytorch_tpu_torch.parallel.layout import ShardedLayout
    from distributed_training_pytorch_tpu_torch.parallel.mesh import Mesh

    whole = LMTiny(device="cpu")
    groups = [[p for p in whole.parameters() if p.dim() > 1], [p for p in whole.parameters() if p.dim() <= 1]]
    opt = torch.optim.AdamW([{"params": groups[0]}, {"params": groups[1], "weight_decay": 0.0}], lr=1e-3)
    sum(p.square().sum() for p in whole.parameters()).backward()
    opt.step()
    model = LMTiny(device="cpu")
    model.load_state_dict(whole.state_dict())
    mesh = Mesh({"data": 1, "seq": 1, "fsdp": 2}, data_index=0, seq_shards=(0,), fsdp_index=1)
    layout = ShardedLayout.apply(model, mesh, fsdp_min_size=MIN_SIZE)
    assert layout.splits and all(s.axis == "fsdp" for s in layout.splits.values())
    shards = {n.replace("parametrizations.", "").replace(".original", ""): p for n, p in model.named_parameters()}
    assert list(shards) != [n for n, _ in whole.named_parameters()]  # the layout's order is another
    dims = {n: p.dim() for n, p in whole.named_parameters()}
    opt2 = torch.optim.AdamW([{"params": [p for n, p in shards.items() if dims[n] > 1]},
                              {"params": [p for n, p in shards.items() if dims[n] <= 1], "weight_decay": 0.0}], lr=1e-3)
    layout.load_optimizer_state_dict(opt2, model, opt.state_dict())
    assert [g["weight_decay"] for g in opt2.param_groups] == [0.01, 0.0]
    for name, p in whole.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            want = opt.state[p][key]
            if name in layout.splits:
                want = layout.splits[name].part(want)
            assert torch.equal(opt2.state[shards[name]][key], want), (name, key)
