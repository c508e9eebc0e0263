"""The port's background saver (``distributed_training_pytorch_tpu_torch/resilience/
async_saver.py``) and the checkpoint manager's retry and corruption seams, on the CPU.

* Newest wins per name and FIFO across names: while a commit is held, ``best``, ``last``
  and a newer ``best`` are queued; the newer ``best`` takes the older one's place, and the
  commits land as first, ``best`` (the newer), ``last``.
* A background commit's error is raised by ``flush`` (and by the next ``save_async``),
  once; ``save_sync`` keeps a prior error for the next ``flush``.
* ``checkpoint_write`` faults are retried (``save_retries``), and past the retries the
  save raises ``CheckpointError`` and leaves no staging behind; a ``corrupt_checkpoint``
  fault on a commit makes ``restore_latest_valid`` fall back to the checkpoint before.
* The snapshot is a copy: params changed in place right after ``save_async``, before the
  commit runs, leave the checkpoint with the values from before.
* ``measure_save_stall`` returns its four numbers.
"""

import os
import threading
import time

import pytest
import torch

from distributed_training_pytorch_tpu_torch.checkpoint import CheckpointError, CheckpointManager
from distributed_training_pytorch_tpu_torch.fault import FaultPlan
from distributed_training_pytorch_tpu_torch.resilience import AsyncCheckpointSaver, measure_save_stall
from distributed_training_pytorch_tpu_torch.train import TrainState


def _state(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.BatchNorm1d(5), torch.nn.Linear(5, 3))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    x = torch.randn(8, 6)
    model(x).square().mean().backward()
    opt.step()  # momentum buffers exist
    return TrainState(model=model, optimizer=opt, step=1)


class _Recording:
    """A manager stand-in: records each commit; the first one waits on ``gate``."""

    def __init__(self, fail_on=None):
        self.commits, self.gate, self.started = [], threading.Event(), threading.Event()
        self.fail_on = fail_on

    def save(self, name, state, epoch, **kw):
        self.started.set()
        if not self.commits:
            assert self.gate.wait(timeout=10.0)
        if name == self.fail_on:
            raise OSError(f"disk full writing {name}")
        self.commits.append((name, epoch))

    def best_improved(self, metrics):
        return True


def test_newest_wins_per_name_and_fifo_across_names():
    manager = _Recording()
    with AsyncCheckpointSaver(manager) as saver:
        state = _state()
        saver.save_async("first", state, 0)
        assert manager.started.wait(timeout=10.0)  # the worker holds "first"
        saver.save_async("best", state, 1)
        saver.save_async("last", state, 2)
        saver.save_async("best", state, 3)  # replaces the queued best, in its place
        assert saver.in_flight
        manager.gate.set()
        saver.flush()
        assert manager.commits == [("first", 0), ("best", 3), ("last", 2)]
        assert (saver.committed, saver.superseded) == (3, 1)
        assert not saver.in_flight


def _idle(saver, bound_s=10.0):
    deadline = time.monotonic() + bound_s
    while saver.in_flight:
        assert time.monotonic() < deadline, "the saver did not finish its queue in time"
        time.sleep(0.005)


def test_errors_surface_at_flush_and_at_the_next_save():
    manager = _Recording(fail_on="last")
    manager.gate.set()
    state = _state()
    saver = AsyncCheckpointSaver(manager)
    saver.save_async("last", state, 1)
    with pytest.raises(OSError, match="disk full"):
        saver.flush()
    saver.flush()  # raised once, then cleared
    saver.save_async("last", state, 2)
    _idle(saver)
    with pytest.raises(OSError, match="disk full"):
        saver.save_async("best", state, 3)  # the pending error comes first
    saver.save_async("last", state, 4)
    _idle(saver)
    manager.fail_on = None
    saver.save_sync("best", state, 5)  # the emergency save runs; the error waits
    with pytest.raises(OSError, match="disk full"):
        saver.flush()
    assert ("best", 5) in manager.commits
    saver.close()


def test_checkpoint_write_faults_are_retried_then_raise(tmp_path):
    state = _state()
    plan = FaultPlan().add("checkpoint_write", count=2)
    manager = CheckpointManager(str(tmp_path / "a"), fault_plan=plan, retry_backoff=0.01)
    manager.save("last", state, 1)
    assert plan.count_fired("checkpoint_write") == 2 and manager.is_valid("last")
    plan = FaultPlan().add("checkpoint_write", count=3)
    manager = CheckpointManager(str(tmp_path / "b"), fault_plan=plan, retry_backoff=0.01)
    with pytest.raises(CheckpointError, match="3 attempts"):
        manager.save("last", state, 1)
    assert not manager.exists("last")
    staging = os.path.join(str(tmp_path / "b"), ".staging")
    assert not os.path.isdir(staging) or not os.listdir(staging)


def test_restore_falls_back_past_a_corrupted_commit(tmp_path):
    plan = FaultPlan().add("corrupt_checkpoint", payload="flip")
    manager = CheckpointManager(str(tmp_path), fault_plan=plan)
    good = _state(0)
    manager.save("checkpoint_epoch_1", good, 1)  # the plan's event fires on this first commit
    assert not manager.is_valid("checkpoint_epoch_1")
    manager.save("checkpoint_epoch_2", good, 2)
    os.utime(manager.path("checkpoint_epoch_1"), (2e9, 2e9))  # the corrupt one is the newest
    target = _state(1)
    _, epoch, name = manager.restore_latest_valid(target)
    assert (name, epoch) == ("checkpoint_epoch_2", 2)
    for a, b in zip(target.model.state_dict().values(), good.model.state_dict().values(), strict=True):
        assert torch.equal(a, b)


def test_the_snapshot_is_a_copy_not_a_reference(tmp_path):
    state = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [s["momentum_buffer"].clone() for s in state.optimizer.state.values()]
    manager = CheckpointManager(str(tmp_path))
    saver = AsyncCheckpointSaver(manager)
    saver.commit_delay_s = 0.2  # the commit runs after the writes below
    saver.save_async("last", state, 3, loop_state={"step_in_epoch": 2})
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for s in state.optimizer.state.values():
            s["momentum_buffer"].mul_(-1.0)
    state.step = 99
    saver.close()
    fresh = _state(5)
    manager.restore("last", fresh)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for s, want in zip(fresh.optimizer.state.values(), moments, strict=True):
        assert torch.equal(s["momentum_buffer"], want)
    assert fresh.step == 1
    assert manager.read_meta("last")["loop"] == {"step_in_epoch": 2}
    assert manager.read_data_state("last") is None


def test_measure_save_stall_reports_both_paths(tmp_path):
    out = measure_save_stall(CheckpointManager(str(tmp_path)), _state(), repeats=2)
    assert set(out) == {"sync_ms", "stall_ms", "commit_ms", "stall_ratio"}
    assert out["sync_ms"] > 0 and out["stall_ms"] > 0 and out["commit_ms"] > 0
    assert out["stall_ratio"] == pytest.approx(out["stall_ms"] / out["sync_ms"])
