"""The port's fault injection and hung-step watchdog (``distributed_training_pytorch_tpu_torch/
fault/``) held against the JAX package's ``fault/`` (which imports here, in-process).

* The same schedule gives the same firing sequence, the same ``fired`` record, the same
  ``active_in_window`` answers and the same ``slow_chip`` answers from both plans.
* ``corrupt_checkpoint`` damages the same file to the same bytes in each of its modes,
  and a ``CorruptingSource`` raises the port's ``CorruptRecordError`` where the plan says.
* The watchdog fires after its timeout, not while it is patted, at most ``max_fires``
  times, and its ``progress_elapsed`` is not reset by a fire. Every wait is bounded.
"""

import os
import threading
import time

import numpy as np
import pytest

from distributed_training_pytorch_tpu.fault import inject as jax_inject
from distributed_training_pytorch_tpu_torch.data.records import CorruptRecordError
from distributed_training_pytorch_tpu_torch.fault import (
    CorruptingSource,
    FaultPlan,
    InjectedFault,
    StepWatchdog,
    corrupt_checkpoint,
)

SCHEDULE = [
    ("sigterm", dict(epoch=0, step=3)),
    ("hang", dict(epoch=1, payload=0.5)),
    ("nan_loss", dict(step=5, count=2)),
    ("checkpoint_write", dict(count=2)),
    ("corrupt_checkpoint", dict(payload="flip")),
    ("slow_chip", dict(epoch=2, payload={"device": 1, "delay_ms": 30})),
]
QUERIES = [
    ("sigterm", dict(epoch=0, step=2)), ("sigterm", dict(epoch=0, step=3)), ("sigterm", dict(epoch=0, step=3)),
    ("hang", dict(epoch=0, step=1)), ("hang", dict(epoch=1, step=7)), ("hang", dict(epoch=1, step=8)),
    ("nan_loss", dict(epoch=4, step=5)), ("nan_loss", dict(epoch=0, step=5)), ("nan_loss", dict(epoch=0, step=5)),
    ("checkpoint_write", dict()), ("checkpoint_write", dict()), ("checkpoint_write", dict()),
    ("corrupt_checkpoint", dict()), ("corrupt_checkpoint", dict()),
]
WINDOWS = [(0, 0, 2), (0, 2, 4), (0, 4, 6), (1, 0, 2), (2, 4, 6), (2, 6, 8), (3, 0, 100)]


def _plans():
    jax_plan, port_plan = jax_inject.FaultPlan(), FaultPlan()
    for kind, kw in SCHEDULE:
        jax_plan.add(kind, **kw)
        port_plan.add(kind, **kw)
    return jax_plan, port_plan


def _answer(ev):
    return None if ev is None else (ev.kind, ev.epoch, ev.step, ev.count, ev.payload)


def test_the_same_schedule_fires_the_same_sequence():
    jax_plan, port_plan = _plans()
    got, want = [], []
    for (epoch, start, stop) in WINDOWS:
        want.append(jax_plan.active_in_window(epoch, start, stop))
        got.append(port_plan.active_in_window(epoch, start, stop))
    for kind, kw in QUERIES:
        want.append(_answer(jax_plan.fires(kind, **kw)))
        got.append(_answer(port_plan.fires(kind, **kw)))
        for (epoch, start, stop) in WINDOWS:  # budgets spent change the answers
            want.append(jax_plan.active_in_window(epoch, start, stop))
            got.append(port_plan.active_in_window(epoch, start, stop))
    for ids, epoch in (([0], 2), ([0, 1], 1), ([0, 1], 2), ([1], 2)):
        want.append(jax_plan.slow_chip(ids, epoch=epoch))
        got.append(port_plan.slow_chip(ids, epoch=epoch))
    assert got == want
    assert port_plan.fired == jax_plan.fired
    for kind in ("sigterm", "hang", "nan_loss", "checkpoint_write", "corrupt_checkpoint", "slow_chip"):
        assert port_plan.count_fired(kind) == jax_plan.count_fired(kind)


def test_maybe_raise_is_a_retryable_os_error_on_both_sides():
    jax_plan, port_plan = _plans()
    for plan, exc in ((jax_plan, jax_inject.InjectedFault), (port_plan, InjectedFault)):
        for _ in range(2):
            with pytest.raises(exc) as info:
                plan.maybe_raise("checkpoint_write")
            assert isinstance(info.value, OSError)
        plan.maybe_raise("checkpoint_write")  # the budget of 2 is spent
    assert str(InjectedFault("x")) == str(jax_inject.InjectedFault("x"))


def _tree(root, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "sub"))
    files = {"state.pt": 3001, "meta.json": 120, "sub/data.bin": 777, "manifest.dtp.json": 9000}
    for rel, size in files.items():
        with open(os.path.join(root, rel), "wb") as f:
            f.write(rng.randint(0, 256, size=size).astype(np.uint8).tobytes())


def _read_all(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("mode", ["truncate", "flip", "delete"])
def test_corrupt_checkpoint_damages_the_same_bytes(tmp_path, mode):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _tree(jax_dir, 0)
    _tree(port_dir, 0)
    hit_jax = jax_inject.corrupt_checkpoint(jax_dir, mode=mode)
    hit_port = corrupt_checkpoint(port_dir, mode=mode)
    assert os.path.relpath(hit_port, port_dir) == os.path.relpath(hit_jax, jax_dir) == "state.pt"
    assert _read_all(port_dir) == _read_all(jax_dir)
    with pytest.raises(ValueError, match="truncate\\|flip\\|delete"):
        corrupt_checkpoint(port_dir, mode="bogus")


def test_corrupting_source_raises_the_ports_corrupt_record_error():
    source = [{"image": np.full((2,), i)} for i in range(6)]
    plan = FaultPlan().add("corrupt_record", step=4).add("corrupt_record", step=1, count=2)
    wrapped = CorruptingSource(source, plan)
    assert len(wrapped) == 6
    seen = []
    for i in (0, 1, 1, 1, 4, 4):
        try:
            seen.append(int(wrapped[i]["image"][0]))
        except CorruptRecordError:
            seen.append("corrupt")
    assert seen == [0, "corrupt", "corrupt", 1, "corrupt", 4]
    assert plan.count_fired("corrupt_record") == 3


def _wait_for(predicate, bound_s):
    deadline = time.monotonic() + bound_s
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def test_watchdog_fires_after_its_timeout_and_not_while_patted():
    fired = threading.Event()
    dog = StepWatchdog(0.3, fired.set, poll_interval=0.02)
    with dog:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.8:  # patted every 20 ms for 0.8 s: longer than the timeout
            dog.pat()
            time.sleep(0.02)
        assert not fired.is_set() and dog.fired == 0
        assert dog.elapsed < 0.3
        t_stop = time.monotonic()
        assert fired.wait(timeout=5.0)  # no more pats: it fires
        waited = time.monotonic() - t_stop
    assert 0.25 <= waited < 5.0
    assert dog.fired == 1
    assert dog.progress_elapsed >= 0.25  # a fire re-arms elapsed, not the progress clock


def test_watchdog_fires_at_most_max_fires_and_survives_a_raising_callback():
    calls = []

    def on_timeout():
        calls.append(time.monotonic())
        raise RuntimeError("a callback that raises must not stop the watchdog")

    dog = StepWatchdog(0.05, on_timeout, poll_interval=0.01, max_fires=2, escalation_factor=2.0).start()
    try:
        assert _wait_for(lambda: len(calls) >= 2, 5.0)
        time.sleep(0.3)  # a third fire would have come by now
    finally:
        dog.stop()
    assert len(calls) == 2 and dog.fired == 2
    assert calls[1] - calls[0] >= 0.09  # the second window is timeout x escalation_factor
    with pytest.raises(ValueError):
        StepWatchdog(0)
