"""The expert axis of the port (``parallel/mesh.py``, ``parallel/layout.py``,
``parallel/moe.py``) over two gloo ranks, held against one process of the port.

One launch of two ranks (``MESH=ep2``: ``{"data": 1, "expert": 2}``), module-scoped:

* an ``MoEMlp`` (8 experts, 4 a rank) laid out by ``moe_expert_rules``: its forward, its
  gradients (tokens, router, each rank's experts) and its capacity-free decode on both
  routes against the same layer in one process;
* ``manual_expert_mlp``'s two exchanges (``all_to_all``, ``psum``) on each rank's expert
  slabs against the one-process ``MoEMlp`` (einsum route, the same groups), output and
  token gradients;
* one SGD step of an ``LMTiny`` with ``moe_every=2`` through the port's ``Trainer`` at
  ``ep2`` against one process: the update's relative L2 error at most 1e-5, the
  checkpoint's sharding record naming the expert leaves, and ``replan`` of that
  checkpoint onto one device refused with ``ElasticReplanError``, as in the JAX package.

Tolerances, f32: the layer's output and gradients within 1e-6 (the same arithmetic; the
sum over the group adds the two ranks' parts in another order than one process's
experts).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu.parallel import mesh as jax_mesh
from distributed_training_pytorch_tpu_torch.parallel import elastic, moe
from distributed_training_pytorch_tpu_torch.parallel.mesh import MeshConfig, mesh_config_from_spec
from distributed_training_pytorch_tpu_torch.parallel.sharding import default_sharding_rules, state_shardings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, H, E = 16, 32, 8
SEQ, BATCH, LR = 16, 4, 0.1
ATOL = 1e-6

_COMMON = textwrap.dedent(
    """
    import numpy as np
    import torch

    from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
    from distributed_training_pytorch_tpu_torch.models import LMTiny
    from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
    from distributed_training_pytorch_tpu_torch.parallel import moe
    from distributed_training_pytorch_tpu_torch.trainer import Trainer

    D, H, E = 16, 32, 8


    def layer(impl, state):
        out = moe.MoEMlp(D, E, H, num_groups=2, dispatch_impl=impl, device="cpu")
        out.load_state_dict(state)
        return out


    def run_layer(net, x, ct):
        xt = x.clone().requires_grad_(True)
        out, aux = net(xt)
        (out * ct).sum().backward()
        return {"out": out.detach(), "x": xt.grad, "aux": {k: v.detach() for k, v in aux.items()},
                **{n: p.grad for n, p in net.named_parameters()}}


    class MoELM(Trainer):
        def __init__(self, rows, weights, lr, **kw):
            self.rows, self.weights, self.lr = rows, weights, lr
            super().__init__(**kw)

        def build_train_dataset(self):
            return ArrayDataSource(image=self.rows[:, :-1], label=self.rows[:, 1:])

        def build_model(self):
            model = LMTiny(device="cpu", moe_every=2, num_experts=E)
            model.load_state_dict(torch.load(self.weights))
            return model

        def build_criterion(self):
            return None

        def build_loss_fn(self):
            return make_fused_lm_loss(self.model)

        def build_scheduler(self):
            return self.lr

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=self.lr)


    def batch_of(rows, mesh):
        n = len(rows) // mesh.batch_extent
        part = rows[mesh.batch_index * n:(mesh.batch_index + 1) * n]
        return {"image": torch.tensor(part[:, :-1]), "label": torch.tensor(part[:, 1:])}
    """
)

_RANK_SIDE = _COMMON + textwrap.dedent(
    """
    import sys

    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib
    from distributed_training_pytorch_tpu_torch.parallel.layout import ShardedLayout
    from distributed_training_pytorch_tpu_torch.parallel.sharding import moe_expert_rules

    init, rank, folder, lr = sys.argv[1], int(sys.argv[2]), sys.argv[3], float(sys.argv[4])
    mesh_lib.setup_distributed(init, world_size=2, rank=rank, backend="gloo")
    mesh = mesh_lib.mesh_config_from_spec("ep2").build()
    inputs = torch.load(folder + "/inputs.pt")
    state, x, ct = inputs["state"], inputs["x"], inputs["ct"]
    result = {"mesh": dict(mesh.shape), "expert_index": mesh.expert_index, "batch_index": mesh.batch_index}
    for impl in ("einsum", "sort"):
        net = layer(impl, state)
        ShardedLayout.apply(net, mesh, moe_expert_rules())
        result[impl] = run_layer(net, x, ct)
        result[impl]["split"] = (net.expert_split.n, net.expert_split.index, tuple(net.w_in.shape))
        with torch.no_grad():
            result[impl]["decode"] = net(x[:, :1], decode=True)[0]
    e_loc = E // 2
    local = {**state, "w_in": state["w_in"][rank * e_loc:(rank + 1) * e_loc],
             "w_out": state["w_out"][rank * e_loc:(rank + 1) * e_loc]}
    for exchange in ("all_to_all", "psum"):
        xt = x.clone().requires_grad_(True)
        out = moe.manual_expert_mlp(local, xt, num_experts=E, num_groups=2, mesh=mesh, exchange=exchange)
        (out * ct).sum().backward()
        result[exchange] = {"out": out.detach(), "x": xt.grad}
    rows = np.load(folder + "/rows.npy")
    trainer = MoELM(rows, folder + "/weights.pt", lr, max_epoch=1, batch_size=len(rows),
                    save_folder=folder + "/ep2", mesh=mesh, device="cpu", async_checkpoint=False)
    trainer.state, metrics = trainer.engine.train_step(trainer.state, batch_of(rows, mesh))
    trainer.checkpoints.save("last", trainer.state, 1)
    result["train"] = {"params": trainer.state.params, "record": trainer.state.sharding,
                       "metrics": {k: float(v) for k, v in metrics.items()},
                       "ddp": isinstance(trainer.model, torch.nn.parallel.DistributedDataParallel),
                       "local_w_in": tuple(trainer.model.blocks[1].moe.w_in.shape)}
    torch.save(result, f"{folder}/rank{rank}.pt")
    mesh_lib.shutdown_distributed()
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The layer's inputs and an LMTiny's weights from a seed, then one launch of two gloo
    ranks at ``ep2``."""
    folder = tmp_path_factory.mktemp("experts")
    gen = torch.Generator().manual_seed(0)
    net = moe.MoEMlp(D, E, H, num_groups=2, device="cpu")
    net.init_weights(gen)
    rng = np.random.RandomState(0)
    inputs = {"state": net.state_dict(), "x": torch.tensor(rng.randn(2, 16, D).astype(np.float32)),
              "ct": torch.tensor(rng.randn(2, 16, D).astype(np.float32))}
    torch.save(inputs, folder / "inputs.pt")
    from distributed_training_pytorch_tpu_torch.models import LMTiny

    torch.save(LMTiny(device="cpu", moe_every=2, num_experts=E, generator=gen).state_dict(), folder / "weights.pt")
    rows = rng.randint(0, 256, size=(BATCH, SEQ + 1)).astype(np.int32)
    np.save(folder / "rows.npy", rows)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for knob in ("RANK", "WORLD_SIZE", "MESH"):
        env.pop(knob, None)
    procs = [
        subprocess.Popen([sys.executable, "-c", _RANK_SIDE, f"tcp://localhost:{port}", str(rank), str(folder),
                          str(LR)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    namespace = {}
    exec(compile(_COMMON, "<moe-expert-common>", "exec"), namespace)
    return {"folder": str(folder), "inputs": inputs, "rows": rows, "ns": namespace,
            "ranks": [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(2)]}


@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_ep2_layer_forward_and_grads_equal_one_process(runs, impl):
    ns, inputs = runs["ns"], runs["inputs"]
    want = ns["run_layer"](ns["layer"](impl, inputs["state"]), inputs["x"], inputs["ct"])
    for rank, result in enumerate(runs["ranks"]):
        got = result[impl]
        assert got["split"] == (2, rank, (E // 2, D, H))
        for name in ("out", "x", "router.weight", "router.bias"):
            torch.testing.assert_close(got[name], want[name], atol=ATOL, rtol=0, msg=f"{impl} rank {rank} {name}")
        for name in ("load_balance_loss", "router_z_loss"):  # replicated: the same on both ranks
            torch.testing.assert_close(got["aux"][name], want["aux"][name], atol=0, rtol=0)
    for name in ("w_in", "w_out"):  # each rank's experts' gradients, whole
        got = torch.cat([r[impl][name] for r in runs["ranks"]])
        torch.testing.assert_close(got, want[name], atol=ATOL, rtol=0, msg=f"{impl} {name}")
    with torch.no_grad():  # the capacity-free decode: each rank its experts' choices, summed
        decoded = ns["layer"](impl, inputs["state"])(inputs["x"][:, :1], decode=True)[0]
    for result in runs["ranks"]:
        torch.testing.assert_close(result[impl]["decode"], decoded, atol=ATOL, rtol=0)


@pytest.mark.parametrize("exchange", ["all_to_all", "psum"])
def test_manual_expert_mlp_exchanges_equal_moe_mlp(runs, exchange):
    ns, inputs = runs["ns"], runs["inputs"]
    want = ns["run_layer"](ns["layer"]("einsum", inputs["state"]), inputs["x"], inputs["ct"])
    for rank, result in enumerate(runs["ranks"]):
        for name in ("out", "x"):
            torch.testing.assert_close(result[exchange][name], want[name], atol=ATOL, rtol=0,
                                       msg=f"{exchange} rank {rank} {name}")
    one = moe.manual_expert_mlp(inputs["state"], inputs["x"], num_experts=E, num_groups=2, exchange=exchange)
    torch.testing.assert_close(one, want["out"], atol=ATOL, rtol=0)  # one rank: every expert


def test_ep2_train_step_equals_one_process_and_records_the_expert_leaves(runs):
    ranks, folder = runs["ranks"], runs["folder"]
    assert [r["mesh"] for r in ranks] == [{"data": 1, "seq": 1, "expert": 2}] * 2
    assert [(r["expert_index"], r["batch_index"]) for r in ranks] == [(0, 0), (1, 0)]  # one batch shard
    train = ranks[0]["train"]
    assert not train["ddp"] and train["local_w_in"] == (E // 2, 32, 64)
    assert train["record"]["mesh"] == {"data": 1, "expert": 2}
    assert train["record"]["specs"] == {f"blocks.1.moe.{w}": "PartitionSpec('expert')" for w in ("w_in", "w_out")}
    assert {"moe_load_balance", "moe_router_z"} <= train["metrics"].keys()
    one = runs["ns"]["MoELM"](runs["rows"], folder + "/weights.pt", LR, max_epoch=1, batch_size=BATCH,
                              save_folder=folder + "/one", device="cpu", async_checkpoint=False)
    before = {k: v.clone() for k, v in one.state.params.items()}
    one.state, metrics = one.engine.train_step(one.state, runs["ns"]["batch_of"](runs["rows"], one.mesh))
    for key in ("loss", "moe_load_balance", "moe_router_z"):
        assert train["metrics"][key] == pytest.approx(float(metrics[key]), rel=1e-6)
    after = one.state.params
    num = sum(float(((ranks[0]["train"]["params"][k] - before[k]) - (after[k] - before[k])).norm() ** 2)
              for k in after)
    den = sum(float((after[k] - before[k]).norm() ** 2) for k in after)
    assert (num / den) ** 0.5 <= 1e-5
    for k in after:  # both ranks gathered the same global tensors
        torch.testing.assert_close(ranks[1]["train"]["params"][k], ranks[0]["train"]["params"][k], atol=0, rtol=0)


def test_ep2_checkpoint_is_refused_on_one_device(runs):
    from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager

    manager = CheckpointManager(os.path.join(runs["folder"], "ep2", "weights"))
    record = manager.read_meta(manager.path("last"))["sharding"]
    with pytest.raises(elastic.ElasticReplanError, match="expert"):
        elastic.replan(record, 1, batch_size=BATCH)
    with pytest.raises(elastic.TopologyMismatchError):  # a one-process resume of it: the trainer's peek
        runs["ns"]["MoELM"](runs["rows"], runs["folder"] + "/weights.pt", LR, max_epoch=1, batch_size=BATCH,
                            save_folder=runs["folder"] + "/resumed", device="cpu", async_checkpoint=False,
                            snapshot_path=manager.path("last"))
    plan = elastic.replan(record, 4, batch_size=BATCH)  # onto 4: the expert extent kept, data takes the rest
    assert plan.new_axes == {"data": 2, "expert": 2} and plan.mesh_config == MeshConfig(data=2, expert=2)


@pytest.mark.parametrize("spec", ["ep2", "dp2ep2", "ep4x2", "ep2x1"])
def test_mesh_grammar_takes_the_expert_axis(spec):
    ref = jax_mesh.mesh_config_from_spec(spec)
    got = mesh_config_from_spec(spec)
    fields = ("data", "fsdp", "pipe", "expert", "seq", "tensor")
    assert tuple(getattr(got, f) for f in fields) == tuple(getattr(ref, f) for f in fields)
    assert got.expert > 1
    with pytest.raises(ValueError, match="does not fit a world of 1 ranks"):
        got.build()  # a world of one process has no second rank


def test_mesh_refusals_and_default_rules():
    # the pipe axis builds in one process (both stages held here); beside the expert axis
    # it raises naming the queue item of the compositions still open
    assert mesh_config_from_spec("pp2x2") == MeshConfig(data=2, pipe=2)
    piped = MeshConfig(pipe=2).build()
    assert piped.shape["pipe"] == 2 and piped.pipe_shards == (0, 1) and piped.pipe_group is None
    with pytest.raises(NotImplementedError, match="pipe axis beside expert.*Queue 1 item 6"):
        MeshConfig(data=1, pipe=2, expert=2).build()
    with pytest.raises(NotImplementedError, match="expert axis beside tensor.*Queue 1 item 6"):
        MeshConfig(data=1, expert=2, tensor=2).build()
    with pytest.raises(NotImplementedError, match="seq axis beside .*Queue 1 item 6"):
        MeshConfig(data=1, expert=2, seq=2).build()
    from distributed_training_pytorch_tpu_torch.models import LMTiny

    model = LMTiny(device="cpu", moe_every=2, num_experts=E)
    specs = state_shardings(model, {"data": 2, "expert": 2}, default_sharding_rules({"data": 2, "expert": 2}))
    split = {k for k, v in specs.items() if any(e is not None for e in v)}
    assert split == {"blocks.1.moe.w_in", "blocks.1.moe.w_out"} and "blocks.1.moe.router.weight" in specs
    assert default_sharding_rules({"data": 4}) is None
