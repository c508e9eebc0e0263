"""The port's ring attention with one sequence shard per rank, over ``torch.distributed``
(gloo, on the CPU), held against the same ring with every shard in one process.

Four processes run once as ``sp4`` (one ring of 4) and once as ``dp2sp2`` (two data
shards, each a ring of 2). Each rank gives the ring the same full, replicated
``[B, T, H, D]`` inputs, as the op's contract asks, and must get the one-process output
and the one-process q/k/v gradients: its slice of the replicated output gradient in, the
shards' dq/dk/dv gathered back (not partial, not counted once per rank). Then one
``Trainer`` step of ``LMTiny(attention_impl="ring")`` at a global batch of 8 (rows keyed by
the data shard, DDP over the data group, metrics averaged over it) must give every rank the
one-process loss and updated parameters. Last, with each seq rank given its own initial
weights and its own loss scale, the seq ranks' model copies must stay bit-equal over a few
steps: nothing but the broadcasts over the seq group keeps them so. Ulysses attention
rides the same launches: each rank trades its sequence shard for a head group by
``all_to_all_single`` and back, and must get the one-process output and q/k/v gradients.

Tolerances, f32: the ring and Ulysses ops 1e-6 (the same block arithmetic in the same order; only the
transport differs); the training step 1e-6 on the loss and the params (with two data
shards, DDP averages the halves' gradients in another order than the full batch's mean).
The step is plain SGD, whose update is the gradient times the learning rate: AdamW would
turn the float noise of gradients that are 0 in exact arithmetic (each qkv bias's key
block) into whole steps.
"""

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
SHAPE = (2, 32, 4, 8)  # B, T, H, D
SEQ, BATCH, LR = 32, 8, 0.5
ATOL = 1e-6
SKEW_STEPS = 3
SPECS = [
    # (spec, seq extent, (shape, data index, seq shard, seq ranks) of ranks 0..3)
    ("sp4", 4, [(0, (0,), (0, 1, 2, 3)), (0, (1,), (0, 1, 2, 3)), (0, (2,), (0, 1, 2, 3)), (0, (3,), (0, 1, 2, 3))]),
    ("dp2sp2", 2, [(0, (0,), (0, 1)), (0, (1,), (0, 1)), (1, (0,), (2, 3)), (1, (1,), (2, 3))]),
]

_COMMON = textwrap.dedent(
    """
    import numpy as np
    import torch

    from distributed_training_pytorch_tpu_torch.data import ArrayDataSource
    from distributed_training_pytorch_tpu_torch.models import LMTiny
    from distributed_training_pytorch_tpu_torch.models.transformer_lm import make_fused_lm_loss
    from distributed_training_pytorch_tpu_torch.parallel import ring_attention, ulysses_attention
    from distributed_training_pytorch_tpu_torch.trainer import Trainer


    def ring_case(mesh, shape, impl, causal):
        rng = np.random.RandomState(11)
        q, k, v, w = (torch.tensor(rng.randn(*shape), dtype=torch.float32) for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ring_attention(q, k, v, mesh, causal=causal, impl=impl)
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        return [o.detach(), *grads]


    def ulysses_case(mesh, shape, use_flash, causal):
        rng = np.random.RandomState(13)
        q, k, v, w = (torch.tensor(rng.randn(*shape), dtype=torch.float32) for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ulysses_attention(q, k, v, mesh, causal=causal, use_flash=use_flash)
        grads = torch.autograd.grad((o * w).sum(), (q, k, v))
        return [o.detach(), *grads]


    def windows(seq, batch):
        return np.random.RandomState(5).randint(0, 256, size=(batch, seq + 1)).astype(np.int32)


    class RingLM(Trainer):
        # skew > 0 makes each seq rank differ where nothing should let it: its own initial
        # weights, and its loss scaled by 1 + skew * seq_index.

        def __init__(self, rows, lr, skew=0.0, **kw):
            self.rows, self.lr, self.skew = rows, lr, skew
            super().__init__(**kw)

        def build_train_dataset(self):
            return ArrayDataSource(image=self.rows[:, :-1], label=self.rows[:, 1:])

        def build_model(self):
            model = LMTiny(attention_impl="ring", mesh=self.mesh, device="cpu")
            if self.skew:
                model.init_weights(torch.Generator().manual_seed(1 + self.mesh.seq_shards[0]))
            return model

        def build_criterion(self):
            return None

        def build_loss_fn(self):
            loss_fn = make_fused_lm_loss(self.model)
            if not self.skew:
                return loss_fn
            scale = 1.0 + self.skew * self.mesh.seq_shards[0]

            def skewed(model, batch, train):
                loss, metrics = loss_fn(model, batch, train)
                return loss * scale, metrics

            return skewed

        def build_scheduler(self):
            return self.lr

        def build_optimizer(self, schedule):
            return torch.optim.SGD(self.model.parameters(), lr=self.lr)


    def train_case(mesh, seq, batch, lr, save_folder):
        trainer = RingLM(windows(seq, batch), lr, max_epoch=1, batch_size=batch, save_folder=save_folder,
                         mesh=mesh, device="cpu")
        (host_batch,) = list(trainer.train_dataloader)
        trainer.state, metrics = trainer.train_step(trainer.state, trainer.to_device(host_batch))
        return trainer, float(metrics["loss"]), {k: v.clone() for k, v in trainer.state.params.items()}
    """
)

_RANK_SIDE = _COMMON + textwrap.dedent(
    """
    import sys

    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    init, rank, spec, out, folder = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    shape = tuple(map(int, sys.argv[6].split(",")))
    seq, batch, lr = int(sys.argv[7]), int(sys.argv[8]), float(sys.argv[9])
    SKEW_STEPS = int(sys.argv[10])
    mesh_lib.setup_distributed(init, world_size=4, rank=rank, backend="gloo")
    mesh = mesh_lib.mesh_config_from_spec(spec).build()
    assert len(mesh.seq_shards) == 1 and not mesh.seq_local
    result = {"mesh": (mesh.shape, mesh.data_index, mesh.seq_shards, mesh.seq_ranks)}
    for impl in ("dense", "flash"):
        for causal in (False, True):
            result[(impl, causal)] = ring_case(mesh, shape, impl, causal)
    for use_flash in (False, True):
        for causal in (False, True):
            result[("ulysses", use_flash, causal)] = ulysses_case(mesh, shape, use_flash, causal)
    trainer, loss, params = train_case(mesh, seq, batch, lr, folder)
    assert trainer.train_dataloader.local_batch_size == batch // mesh.shape["data"]
    assert isinstance(trainer.model, torch.nn.parallel.DistributedDataParallel) == (mesh.shape["data"] > 1)
    result["loss"], result["params"] = loss, params
    skewed = RingLM(windows(seq, batch), lr, skew=0.25, max_epoch=1, batch_size=batch, save_folder=folder + "-skew",
                    mesh=mesh, device="cpu")
    result["skew_built"] = {k: v.clone() for k, v in skewed.state.params.items()}
    (host_batch,) = list(skewed.train_dataloader)
    for _ in range(SKEW_STEPS):
        skewed.state, _ = skewed.train_step(skewed.state, skewed.to_device(host_batch))
    result["skew_stepped"] = {k: v.clone() for k, v in skewed.state.params.items()}
    torch.save(result, out)
    mesh_lib.shutdown_distributed()
    """
)


def _run_ranks(tmp_path, spec):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # four ranks share the CPU
    for knob in ("RANK", "WORLD_SIZE", "MESH"):
        env.pop(knob, None)
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(4)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_SIDE, f"tcp://localhost:{port}", str(rank), spec, outs[rank],
             str(tmp_path / "run"), ",".join(map(str, SHAPE)), str(SEQ), str(BATCH), str(LR), str(SKEW_STEPS)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(4)
    ]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, logs
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """The four ranks' results of a spec, run once for the module's tests."""
    cache = {}

    def get(spec):
        if spec not in cache:
            cache[spec] = _run_ranks(tmp_path_factory.mktemp(spec), spec)
        return cache[spec]

    return get


@pytest.mark.parametrize("spec, seq_extent, placement", SPECS)
def test_one_shard_per_rank_equals_all_shards_in_one_process(tmp_path, rank_results, spec, seq_extent, placement):
    ranks = rank_results(spec)
    assert [r["mesh"][1:] for r in ranks] == placement
    assert all(r["mesh"][0] == {"data": 4 // seq_extent, "seq": seq_extent} for r in ranks)

    namespace = {}
    exec(compile(_COMMON, "<ring-common>", "exec"), namespace)
    local = MeshConfig(seq=seq_extent).build()
    assert local.seq_local and local.seq_shards == tuple(range(seq_extent))
    for impl in ("dense", "flash"):
        for causal in (False, True):
            ref = namespace["ring_case"](local, SHAPE, impl, causal)
            for rank, result in enumerate(ranks):
                for name, got, want in zip(("o", "dq", "dk", "dv"), result[(impl, causal)], ref, strict=True):
                    np.testing.assert_allclose(
                        got.numpy(), want.numpy(), atol=ATOL, err_msg=f"{spec} rank {rank} {impl} causal={causal} {name}"
                    )
    # Ulysses between ranks (the all-to-all trades over the seq group) against the head
    # groups of one process, both routes (the flash route runs the plain wrappers here)
    for use_flash in (False, True):
        for causal in (False, True):
            ref = namespace["ulysses_case"](local, SHAPE, use_flash, causal)
            for rank, result in enumerate(ranks):
                for name, got, want in zip(("o", "dq", "dk", "dv"), result[("ulysses", use_flash, causal)], ref,
                                           strict=True):
                    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                               err_msg=f"{spec} rank {rank} ulysses flash={use_flash} causal={causal} "
                                                       f"{name}")

    _, loss, params = namespace["train_case"](local, SEQ, BATCH, LR, str(tmp_path / "one"))
    for rank, result in enumerate(ranks):
        np.testing.assert_allclose(result["loss"], loss, atol=ATOL, err_msg=f"{spec} rank {rank} loss")
        for name, value in params.items():
            np.testing.assert_allclose(result["params"][name].numpy(), value.numpy(), atol=ATOL,
                                       err_msg=f"{spec} rank {rank} {name}")
    initial = namespace["LMTiny"](device="cpu").state_dict()
    assert all(not torch.equal(value, initial[name]) for name, value in params.items() if "weight" in name)


@pytest.mark.parametrize("spec, seq_extent, placement", SPECS)
def test_seq_ranks_keep_bit_equal_model_copies(rank_results, spec, seq_extent, placement):
    """Each seq rank built other initial weights and scaled its loss by another factor:
    the broadcasts from the seq group's first rank (parameters at build, gradients each
    step) must still leave every rank of a seq group with the same parameters, bit for
    bit, before and after several steps."""
    ranks = rank_results(spec)
    for seq_ranks in sorted({p[2] for p in placement}):
        first = ranks[seq_ranks[0]]
        for rank in seq_ranks[1:]:
            for key in ("skew_built", "skew_stepped"):
                for name, value in first[key].items():
                    assert torch.equal(ranks[rank][key][name], value), f"{spec} rank {rank} {key} {name}"
    for result in ranks:
        assert any(not torch.equal(result["skew_stepped"][n], v) for n, v in result["skew_built"].items())


def test_a_mesh_that_does_not_fit_the_world_raises(monkeypatch):
    from distributed_training_pytorch_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(mesh_lib, "process_count", lambda: 3)
    monkeypatch.setattr(mesh_lib, "process_index", lambda: 0)
    with pytest.raises(ValueError, match="does not fit a world of 3"):
        MeshConfig(data=2, seq=2).build()
