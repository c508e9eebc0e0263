"""The port's pipeline with one pipe shard per rank, over ``torch.distributed`` (gloo, on
the CPU), held against the same pipeline with every shard in one process.

One launch of four processes builds ``pp4`` (one pipe group of 4) and then ``dp2pp2`` (two
data shards, each a pipe group of 2) on the same world. Each rank gives
``pipeline_apply`` the same full, replicated inputs, as the op's contract asks, and must
get the one-process output and the one-process gradients of every input: the stacked
stage params, ``first``'s embedding (tied into ``last``), ``last``'s head, and the
micro-batches, whole and once-counted on every rank. The cases cover ``n_virtual`` 1 and
2, the sharded feed with the sharded head (``M % S == 0``), the replicated feed with the
head over all outputs, and a trunk with no ends. The same launch then takes one step of the
LM entry's trainer under each spec (``scripts/torch_pipe_ranks.py::entry_step``: a
pipelined LMTiny-width LM of 4 blocks, SGD), DDP over the data group under ``dp2pp2``, each
data shard its half of the batch: every rank's loss and updated parameters must be those of
the same step in one process holding every stage (``pp4``, ``pp2``) on the whole batch.

Tolerance, f32: 1e-6 (the same stage arithmetic in the same order; only the transport,
and the order of a few gradient sums, differ).
"""

import importlib.util
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.parallel import MeshConfig
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
SPECS = {"pp4": 4, "dp2pp2": 2}  # spec: pipe extent
# (n_virtual, micro-batches, feed, ends)
CASES = [(1, 8, "auto", True), (2, 8, "auto", True), (1, 6, "auto", True), (1, 8, "replicated", False)]

_COMMON = textwrap.dedent(
    """
    import numpy as np
    import torch

    from distributed_training_pytorch_tpu_torch.parallel import pipeline_apply

    D, HIDDEN, VOCAB = 8, 16, 16


    def stage(p, x):
        return x + torch.nn.functional.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


    def pipe_case(mesh, s, v, m, feed, ends):
        rng = np.random.RandomState(100 * v + m)
        stages = {"w1": torch.tensor(rng.randn(s * v, D, HIDDEN) * 0.2, dtype=torch.float32, requires_grad=True),
                  "w2": torch.tensor(rng.randn(s * v, HIDDEN, D) * 0.2, dtype=torch.float32, requires_grad=True)}
        w = torch.tensor(rng.randn(m, 2, 3, VOCAB if ends else D), dtype=torch.float32)
        if ends:
            embed = torch.tensor(rng.randn(VOCAB, D) * 0.3, dtype=torch.float32, requires_grad=True)
            head = torch.tensor(rng.randn(D, VOCAB) * 0.3, dtype=torch.float32, requires_grad=True)
            micro = torch.tensor(rng.randint(0, VOCAB, size=(m, 2, 3)))
            kw = dict(first=({"t": embed}, lambda p, ids: p["t"][ids]),
                      last=({"w": head, "t": embed}, lambda p, x: x @ p["w"] + x @ p["t"].T))
            inputs = [*stages.values(), embed, head]
        else:
            micro = torch.tensor(rng.randn(m, 2, 3, D), dtype=torch.float32, requires_grad=True)
            kw = {}
            inputs = [*stages.values(), micro]
        out = pipeline_apply(stages, micro, stage, mesh, n_virtual=v, feed=feed, **kw)
        grads = torch.autograd.grad((out * w).sum(), inputs)
        return [out.detach(), *grads]
    """
)

_RANK_SIDE = _COMMON + textwrap.dedent(
    """
    import sys

    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    init, rank, out, specs, cases = sys.argv[1], int(sys.argv[2]), sys.argv[3], eval(sys.argv[4]), eval(sys.argv[5])
    script_path = sys.argv[6]
    mesh_lib.setup_distributed(init, world_size=4, rank=rank, backend="gloo")
    result = {}
    for spec, s in specs.items():
        mesh = mesh_lib.mesh_config_from_spec(spec).build()
        assert len(mesh.pipe_shards) == 1 and mesh.shape["pipe"] == s
        result[spec] = {"mesh": (mesh.data_index, mesh.pipe_index, mesh.pipe_ranks)}
        for case in cases:
            result[spec][case] = pipe_case(mesh, s, *case)
    import importlib.util
    module = importlib.util.spec_from_file_location("torch_pipe_ranks", script_path)
    script = importlib.util.module_from_spec(module)
    module.loader.exec_module(script)
    for spec in specs:
        trainer, batch, _, after, metrics = script.entry_step(spec, f"{out}-{spec}")
        result[spec]["entry"] = {
            "loss": float(metrics["loss"]), "params": {k: v.clone() for k, v in after.items()},
            "rows": len(batch["image"]), "ddp": isinstance(trainer.model, torch.nn.parallel.DistributedDataParallel)}
    torch.save(result, out)
    mesh_lib.shutdown_distributed()
    """
)


SCRIPT = os.path.join(REPO, "scripts", "torch_pipe_ranks.py")


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """The four ranks' results, from one launch."""
    tmp_path = tmp_path_factory.mktemp("pipe_ranks")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # four ranks share the CPU
    for knob in ("RANK", "WORLD_SIZE", "MESH"):
        env.pop(knob, None)
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(4)]
    procs = [
        subprocess.Popen([sys.executable, "-c", _RANK_SIDE, f"tcp://localhost:{port}", str(rank), outs[rank],
                          repr(SPECS), repr(CASES), SCRIPT],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(4)
    ]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, logs
    return [torch.load(o, weights_only=False) for o in outs]


PLACEMENTS = {  # (data index, pipe index, pipe ranks) of ranks 0..3
    "pp4": [(0, 0, (0, 1, 2, 3)), (0, 1, (0, 1, 2, 3)), (0, 2, (0, 1, 2, 3)), (0, 3, (0, 1, 2, 3))],
    "dp2pp2": [(0, 0, (0, 1)), (0, 1, (0, 1)), (1, 0, (2, 3)), (1, 1, (2, 3))],
}


def test_one_stage_per_rank_equals_all_stages_in_one_process(rank_results):
    """Both specs in one test: they share the one launch of four ranks."""
    namespace = {}
    exec(compile(_COMMON, "<pipe-common>", "exec"), namespace)
    for spec, s in SPECS.items():
        assert [r[spec]["mesh"] for r in rank_results] == PLACEMENTS[spec]
        local = MeshConfig(pipe=s).build()
        assert local.pipe_shards == tuple(range(s))
        for case in CASES:
            ref = namespace["pipe_case"](local, s, *case)
            for rank, result in enumerate(rank_results):
                for i, (got, want) in enumerate(zip(result[spec][case], ref, strict=True)):
                    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                               err_msg=f"{spec} rank {rank} case {case} tensor {i}")


@pytest.mark.parametrize("spec", SPECS)
def test_the_lm_entry_steps_one_stage_per_rank_as_in_one_process(rank_results, tmp_path, spec):
    """The entry's trainer under ``spec``: each rank's loss and updated parameters against
    the one-process step on the whole batch, at ``pp{s}``."""
    module = importlib.util.spec_from_file_location("torch_pipe_ranks", SCRIPT)
    script = importlib.util.module_from_spec(module)
    module.loader.exec_module(script)
    s = SPECS[spec]
    trainer, batch, before, after, metrics = script.entry_step(f"pp{s}", str(tmp_path / "one"))
    assert trainer.mesh.pipe_shards == tuple(range(s)) and len(batch["image"]) == int(script.ENV["BATCH"])
    data = 4 // s
    for rank, result in enumerate(rank_results):
        entry = result[spec]["entry"]
        assert entry["rows"] == len(batch["image"]) // data and entry["ddp"] == (data > 1), (rank, entry["rows"])
        np.testing.assert_allclose(entry["loss"], float(metrics["loss"]), atol=ATOL, err_msg=f"{spec} rank {rank} loss")
        assert set(entry["params"]) == set(after)
        for name, value in after.items():
            np.testing.assert_allclose(entry["params"][name].numpy(), value.numpy(), atol=ATOL,
                                       err_msg=f"{spec} rank {rank} {name}")
    assert all(not torch.equal(after[k], before[k]) for k in after if "weight" in k)
