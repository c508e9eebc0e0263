"""The port's LM training entry (``distributed_training_pytorch_tpu_torch/examples/
train_lm.py``), its ``Trainer``, ``ShardedLoader`` and ``CheckpointManager``, held against
the JAX package's.

The JAX ``Trainer`` and ``ShardedLoader`` import the JAX package's ``data/`` package,
which does not import in this tree (its ``data/streaming/`` was never committed). So the
JAX side runs in a subprocess that first installs a stand-in module for
``distributed_training_pytorch_tpu.data.streaming`` whose names raise when used (neither
the loader nor the LM trainer uses them); nothing of it reaches this process or any other
test. The port side runs here, on the CPU, from the JAX run's initial weights
(``models/convert.py::params_from_jax``).

Tolerances: batches byte-equal; per-epoch train loss and val nll of the two trainers
within 1e-5 (f32, 2 epochs of 23 AdamW steps: the same arithmetic in other summation
orders, which Adam's per-parameter normalisation carries from step to step; the gap
measured on this configuration is about 2.5e-7); a save and resume exact; the 2-rank
step within 1e-6 (gradients averaged in another order).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointManager
from distributed_training_pytorch_tpu_torch.data import ArrayDataSource, ShardedLoader
from distributed_training_pytorch_tpu_torch.examples import train_lm
from distributed_training_pytorch_tpu_torch.models import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, WINDOWS, LR, EPOCHS = 64, 8, 200, 1e-3, 2
LOADER_CASES = [
    # seed, epoch, process_count, shuffle/drop_last (train) or pad_final (val)
    (0, 0, 1, "train"), (0, 3, 2, "train"), (7, 1, 2, "train"), (7, 2, 1, "val"), (0, 0, 2, "val"),
]

_JAX_SIDE = textwrap.dedent(
    """
    import json, os, sys, types
    import numpy as np

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    out, cases, seq, batch, n_windows, lr, epochs = sys.argv[1], json.loads(sys.argv[2]), *map(float, sys.argv[3:8])
    seq, batch, n_windows, epochs = int(seq), int(batch), int(n_windows), int(epochs)
    os.environ["DTYPE"] = "fp32"
    import jax
    from flax import traverse_util
    from distributed_training_pytorch_tpu.data import ArrayDataSource, ShardedLoader

    source = ArrayDataSource(image=np.arange(37 * 5).reshape(37, 5), label=np.arange(37))
    arrays = {}
    for ci, (seed, epoch, count, phase) in enumerate(cases):
        for rank in range(count):
            loader = ShardedLoader(source, 8, shuffle=phase == "train", seed=seed, num_workers=0,
                                   drop_last=phase == "train", pad_final=phase == "val",
                                   process_index=rank, process_count=count)
            loader.set_epoch(epoch)
            for b, batch_ in enumerate(loader):
                for key, value in batch_.items():
                    arrays[f"loader/{ci}/{rank}/{b}/{key}"] = value

    import examples.train_lm as jax_lm
    windows = jax_lm.load_windows(seq)[:n_windows]
    jax_lm.load_windows = lambda seq_len, path=None: windows
    record = {"train": [], "val": []}

    class Recorded(jax_lm.LMTrainer):
        def train_epoch(self, epoch):
            record["train"].append(super().train_epoch(epoch))
            return record["train"][-1]

        def validate(self):
            record["val"].append(super().validate())
            return record["val"][-1]

    trainer = Recorded(seq_len=seq, base_lr=lr, size="tiny", moe_every=0, max_epoch=epochs, batch_size=batch,
                       have_validate=True, save_best_for=("nll", "leq"), save_period=1, last_save_period=1,
                       save_folder=os.path.join(os.path.dirname(out), "jax_run"), progress=False,
                       num_workers=0, async_checkpoint=False)
    params = traverse_util.flatten_dict(jax.tree.map(np.asarray, trainer.state.params), sep="/")
    arrays.update({f"params/{k}": v for k, v in params.items()})
    trainer.train()
    np.savez(out, **arrays)
    with open(out + ".json", "w") as f:
        json.dump(record, f)
    """
)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_side") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1")
    env.pop("PYTHONPATH", None)
    subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, out, json.dumps(LOADER_CASES), str(SEQ), str(BATCH), str(WINDOWS),
         str(LR), str(EPOCHS)],
        cwd=REPO, env=env, check=True, capture_output=True, text=True, timeout=600,
    )
    with open(out + ".json") as f:
        record = json.load(f)
    return dict(np.load(out)), record


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix) :].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def test_loader_batches_equal_the_jax_loader(jax_side):
    arrays, _ = jax_side
    source = ArrayDataSource(image=np.arange(37 * 5).reshape(37, 5), label=np.arange(37))
    for ci, (seed, epoch, count, phase) in enumerate(LOADER_CASES):
        for rank in range(count):
            loader = ShardedLoader(
                source, 8, shuffle=phase == "train", seed=seed, drop_last=phase == "train",
                pad_final=phase == "val", process_index=rank, process_count=count,
            )
            loader.set_epoch(epoch)
            batches = list(loader)
            assert len(batches) == len(loader) == len({k.split("/")[3] for k in arrays if k.startswith(f"loader/{ci}/{rank}/")})
            for b, batch in enumerate(batches):
                for key, value in batch.items():
                    ref = arrays[f"loader/{ci}/{rank}/{b}/{key}"]
                    assert value.dtype == ref.dtype and value.tobytes() == ref.tobytes(), (ci, rank, b, key)
            if phase == "val":
                assert [loader.global_real_count(b) for b in range(len(loader))] == [8, 8, 8, 8, 5]


class _Recorded(train_lm.LMTrainer):
    def __init__(self, **kw):
        self.record = {"train": [], "val": []}
        super().__init__(**kw)

    def train_epoch(self, epoch):
        self.record["train"].append(super().train_epoch(epoch))
        return self.record["train"][-1]

    def validate(self):
        self.record["val"].append(super().validate())
        return self.record["val"][-1]


@pytest.fixture()
def lm_env(monkeypatch):
    windows = train_lm.load_windows(SEQ)[:WINDOWS]
    monkeypatch.setattr(train_lm, "load_windows", lambda seq_len, path=None: windows)
    monkeypatch.setenv("DTYPE", "fp32")
    for knob in ("PALLAS", "FUSED_CE", "LM_CORPUS"):
        monkeypatch.delenv(knob, raising=False)
    return windows


def _trainer(save_folder, *, max_epoch=EPOCHS, snapshot_path=None, cls=_Recorded):
    return cls(
        seq_len=SEQ, base_lr=LR, size="tiny", moe_every=0, max_epoch=max_epoch, batch_size=BATCH,
        have_validate=True, save_best_for=("nll", "leq"), save_period=1, last_save_period=1,
        save_folder=str(save_folder), snapshot_path=snapshot_path, device="cpu",
    )


def test_lm_entry_tracks_the_jax_lm_trainer(jax_side, lm_env, tmp_path):
    arrays, ref = jax_side
    trainer = _trainer(tmp_path)
    trainer.model.load_state_dict(params_from_jax(_unflatten(arrays, "params/")))
    assert len(trainer.train_dataloader) == 23 and len(trainer.val_dataloader) == 2
    trainer.train()
    got = trainer.record
    assert len(got["train"]) == len(ref["train"]) == EPOCHS
    for epoch in range(EPOCHS):
        np.testing.assert_allclose(got["train"][epoch]["loss"], ref["train"][epoch]["loss"], atol=1e-5)
        np.testing.assert_allclose(got["train"][epoch]["lr"], ref["train"][epoch]["lr"], rtol=1e-5)
        np.testing.assert_allclose(got["val"][epoch]["nll"], ref["val"][epoch]["nll"], atol=1e-5)
        np.testing.assert_allclose(got["val"][epoch]["ppl"], ref["val"][epoch]["ppl"], rtol=1e-5)
    assert got["train"][-1]["loss"] < got["train"][0]["loss"]
    manager = CheckpointManager(os.path.join(tmp_path, "weights"))
    assert set(manager.checkpoint_names()) == {"best", "last"}
    assert manager.read_meta("last")["epoch"] == EPOCHS


def test_save_and_resume_round_trip_is_exact(lm_env, tmp_path):
    first = _trainer(tmp_path / "a", max_epoch=2)
    first.max_epoch = 1  # stop after one epoch of the 2-epoch schedule, as an interrupted run
    first.train()
    resumed = _trainer(tmp_path / "a", max_epoch=2, snapshot_path="last")
    assert (resumed.state.step, resumed.cur_epoch) == (first.state.step, 1) == (23, 1)
    for name, value in first.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    saved, restored = first.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert saved["param_groups"] == restored["param_groups"]
    for idx, slots in saved["state"].items():
        for key, value in slots.items():
            assert torch.equal(restored["state"][idx][key], value), (idx, key)
    assert resumed.checkpoints.best_value == first.checkpoints.best_value
    resumed.train()
    # ...and the resumed epoch continues exactly as an uninterrupted 2-epoch run.
    straight = _trainer(tmp_path / "b", max_epoch=2)
    straight.train()
    assert resumed.state.step == straight.state.step == 46
    for name, value in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    latest = _trainer(tmp_path / "a", max_epoch=2, snapshot_path="latest_valid")
    assert (latest.state.step, latest.cur_epoch) == (46, 2)


_RANK_SIDE = textwrap.dedent(
    """
    import sys
    import torch
    from distributed_training_pytorch_tpu_torch.examples import train_lm
    from distributed_training_pytorch_tpu_torch.parallel import mesh

    init, rank, save_dir, out, seq, n_windows = sys.argv[1], int(sys.argv[2]), *sys.argv[3:5], *map(int, sys.argv[5:7])
    windows = train_lm.load_windows(seq)[:n_windows]
    train_lm.load_windows = lambda seq_len, path=None: windows
    mesh.setup_distributed(init, world_size=2, rank=rank, backend="gloo")
    trainer = train_lm.LMTrainer(seq_len=seq, base_lr=1e-3, size="tiny", moe_every=0, max_epoch=2, batch_size=8,
                                 have_validate=True, save_best_for=("nll", "leq"), save_period=1,
                                 save_folder=save_dir, device="cpu", mesh=2)
    assert isinstance(trainer.model, torch.nn.parallel.DistributedDataParallel)
    assert trainer.train_dataloader.local_batch_size == 4
    trainer.train()
    if rank == 0:
        torch.save(trainer.state.params, out)
    mesh.shutdown_distributed()
    """
)


def test_two_rank_gloo_step_equals_the_one_rank_step(monkeypatch, tmp_path):
    """Two processes, one data-parallel rank each (gloo), against one process at the
    same global batch: 2 epochs of 1 step each (the first at lr 0, by the warmup)."""
    n_windows = 9  # 8 train rows = one global batch; 1 val row
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "two_rank.pt")
    env = dict(os.environ, DTYPE="fp32")
    for knob in ("PALLAS", "FUSED_CE", "LM_CORPUS", "RANK", "WORLD_SIZE"):
        env.pop(knob, None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_SIDE, f"tcp://localhost:{port}", str(rank), str(tmp_path / "dp"), out,
             str(SEQ), str(n_windows)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(2)
    ]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    windows = train_lm.load_windows(SEQ)[:n_windows]
    monkeypatch.setattr(train_lm, "load_windows", lambda seq_len, path=None: windows)
    monkeypatch.setenv("DTYPE", "fp32")
    one = _trainer(tmp_path / "one", max_epoch=2, cls=train_lm.LMTrainer)
    one.train()
    two = torch.load(out, weights_only=True)
    assert one.state.step == 2
    for name, value in one.model.state_dict().items():
        np.testing.assert_allclose(two[name].numpy(), value.numpy(), atol=1e-6, err_msg=name)


def test_unported_knobs_raise(lm_env, tmp_path, monkeypatch):
    # chain_steps > 1 is ported: a chained epoch trains (windows of 4 and a tail single).
    chained = _trainer(tmp_path).__class__(
        seq_len=SEQ, base_lr=LR, size="tiny", moe_every=0, max_epoch=1, batch_size=BATCH,
        save_folder=str(tmp_path / "chained"), device="cpu", chain_steps=4, log_every=4,
    )
    chained.train()
    assert chained.state.step == len(chained.train_dataloader) == 23
    assert np.isfinite(chained.record["train"][0]["loss"])
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        _trainer(tmp_path).__class__(
            seq_len=SEQ, base_lr=LR, size="tiny", moe_every=2, max_epoch=1, batch_size=BATCH,
            save_folder=str(tmp_path), device="cpu",
        )
    with pytest.raises(NotImplementedError, match="observability"):
        train_lm.LMTrainer(seq_len=SEQ, base_lr=LR, size="tiny", moe_every=0, max_epoch=1, batch_size=BATCH,
                           save_folder=str(tmp_path), device="cpu", telemetry=True)
    # DTYPE=fp16 trains with dynamic loss scaling; the flash kernels, which have no fp16
    # variant, refuse it by name where they would launch (here on the CPU the plain
    # attention runs, as for every dtype)
    monkeypatch.setenv("DTYPE", "fp16")
    from distributed_training_pytorch_tpu_torch.ops import flash_attention as fa
    from distributed_training_pytorch_tpu_torch.precision import is_dynamic

    assert is_dynamic(_trainer(tmp_path).state.loss_scale)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16 on the flash-attention kernels"):
        fa._check_kernel_inputs((("q", q), ("k", q), ("v", q)))
    monkeypatch.setenv("MESH", "fsdp2x1")
    from distributed_training_pytorch_tpu_torch.parallel.mesh import mesh_from_env

    with pytest.raises(NotImplementedError, match="sharding slice"):
        mesh_from_env()


def test_checkpoint_retention_corruption_fallback_and_crash_repair(tmp_path):
    """The manager's safety behaviour, on a small state: periodic saves keep the newest
    ``max_to_keep``; a checkpoint whose bytes no longer match its manifest fails
    validation and ``restore_latest_valid`` falls back past it; a staging dir left by a
    crash is promoted when its manifest was written, and dropped when it was not."""
    import time

    from distributed_training_pytorch_tpu_torch.checkpoint import (
        CheckpointError,
        CorruptCheckpointError,
        epoch_checkpoint_name,
    )
    from distributed_training_pytorch_tpu_torch.train import TrainState

    model = torch.nn.Linear(4, 3)
    state = TrainState(model=model, optimizer=torch.optim.AdamW(model.parameters(), lr=1e-3))
    manager = CheckpointManager(tmp_path, max_to_keep=2)
    with pytest.raises(CheckpointError):
        manager.restore_latest_valid(state)
    for epoch in (1, 2, 3):
        with torch.no_grad():
            model.weight.fill_(float(epoch))
        state.step = 10 * epoch
        manager.save(epoch_checkpoint_name(epoch), state, epoch)
        time.sleep(0.02)  # distinct directory mtimes: names sort newest first by them
    assert manager.checkpoint_names() == ["checkpoint_epoch_3", "checkpoint_epoch_2"]

    with open(os.path.join(manager.path("checkpoint_epoch_3"), "state.pt"), "r+b") as f:
        f.truncate(16)
    with pytest.raises(CorruptCheckpointError):
        manager.validate("checkpoint_epoch_3")
    state, epoch, name = manager.restore_latest_valid(state)
    assert (epoch, name, state.step) == (2, "checkpoint_epoch_2", 20)
    assert torch.equal(model.weight, torch.full((3, 4), 2.0))

    staging = os.path.join(tmp_path, ".staging")
    os.rename(manager.path("checkpoint_epoch_2"), os.path.join(staging, "promoted.7"))
    os.makedirs(os.path.join(staging, "torn.8"))
    CheckpointManager(tmp_path)
    assert manager.is_valid("promoted")
    assert not os.path.exists(staging) and not os.path.exists(manager.path("torn"))


class _PoisonedThirdStep(train_lm.LMTrainer):
    """The LM entry whose third train step's loss is NaN (its metrics stay finite)."""

    def build_loss_fn(self):
        base, calls = super().build_loss_fn(), {"train": 0}

        def loss_fn(model, batch, train):
            loss, metrics = base(model, batch, train)
            if train:
                calls["train"] += 1
                if calls["train"] == 3:
                    return loss * float("nan"), metrics
            return loss, metrics

        return loss_fn


@pytest.mark.parametrize("policy", ["skip", "raise"])
def test_nan_policy_through_the_trainer(lm_env, tmp_path, policy):
    from distributed_training_pytorch_tpu_torch.train import NonFiniteLossError

    trainer = _PoisonedThirdStep(
        seq_len=SEQ, base_lr=LR, size="tiny", moe_every=0, max_epoch=1, batch_size=BATCH,
        save_folder=str(tmp_path), device="cpu", nan_policy=policy,
    )
    if policy == "raise":  # no guard: the NaN update lands, and the epoch's metrics show it
        with pytest.raises(NonFiniteLossError):
            trainer.train()
        return
    metrics = trainer.train_epoch(0)
    assert trainer.nonfinite_steps == 1 and metrics["nonfinite"] == 1.0
    assert trainer.state.step == 23
    assert np.isfinite(metrics["loss"])
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())
