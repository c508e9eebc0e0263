"""``distributed_training_pytorch_tpu_torch/data/prefetch.py::device_prefetch``: the same
batches in the same order, a producer's error raised in the consumer, no thread left
behind by an abandoned consumer, and, on the card, the compute stream waiting for the
side stream's copy.

The card cases carry the ``cuda`` marker and skip without a card. This file imports
neither JAX nor the JAX package, so it runs where only the port is.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.data import prefetch
from distributed_training_pytorch_tpu_torch.data.prefetch import device_prefetch


def _batches(n, rng_seed=0):
    rng = np.random.RandomState(rng_seed)
    return [
        {"image": rng.randint(0, 256, size=(4, 8, 8, 3)).astype(np.uint8),
         "label": rng.randint(0, 10, size=(4,)).astype(np.int32),
         "mask": (np.arange(4) < 3).astype(np.float32)}
        for _ in range(n)
    ]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device-prefetch" and t.is_alive()]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_cpu_yields_the_same_batches_in_order(depth):
    host = _batches(7)
    got = list(device_prefetch(iter(host), "cpu", depth=depth))
    assert len(got) == len(host)
    for g, h in zip(got, host, strict=True):
        assert set(g) == set(h)
        for k in h:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert g[k].dtype == torch.from_numpy(h[k]).dtype
            assert np.array_equal(g[k].numpy(), h[k])


def test_nothing_runs_before_the_first_batch_is_asked_for():
    started = []

    def batches():
        started.append(True)
        yield from _batches(2)

    it = device_prefetch(batches(), "cpu")
    time.sleep(0.05)
    assert started == [] and _prefetch_threads() == []
    assert len(list(it)) == 2 and started == [True]


def test_a_producer_error_is_raised_in_the_consumer():
    def batches():
        yield from _batches(3)
        raise ValueError("the loader broke")

    got = []
    with pytest.raises(ValueError, match="the loader broke"):
        for batch in device_prefetch(batches(), "cpu"):
            got.append(batch)
    assert len(got) == 3
    assert _wait_for_no_prefetch_thread()


def _wait_for_no_prefetch_thread(timeout=3.0):
    deadline = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    return _prefetch_threads() == []


def test_an_abandoned_consumer_leaves_no_live_thread():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.array([i])}
            i += 1

    it = device_prefetch(endless(), "cpu", depth=2)
    first = next(it)
    assert int(first["x"][0]) == 0
    assert len(_prefetch_threads()) == 1
    it.close()
    assert _wait_for_no_prefetch_thread()
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n  # the producer stopped


def test_drain_releases_what_the_queue_held(monkeypatch):
    """The consumer's cleanup empties the queue, also of an item put after the first
    drain, so no batch stays referenced by the stopped prefetcher."""
    import gc
    import weakref

    refs = []

    class Batch(dict):
        pass

    def batches():
        for i in range(6):
            b = Batch(x=np.array([i]))
            refs.append(weakref.ref(b))
            yield b

    it = prefetch._prefetched(batches(), 2)
    next(it)
    time.sleep(0.1)  # the producer fills the queue and blocks on its bounded put
    it.close()
    assert _wait_for_no_prefetch_thread()
    del it
    gc.collect()
    assert sum(r() is not None for r in refs) == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side-stream copy runs only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_cuda_compute_stream_waits_for_the_side_stream_copy(cuda_device, monkeypatch):
    """Large batches copied on the side stream and read at once on the compute stream:
    each read sees the whole copy, because the compute stream waited on the copy's event
    (counted), and each tensor is marked for the compute stream (counted)."""
    waits, marks = [], []
    real_wait, real_mark = torch.cuda.Stream.wait_event, torch.Tensor.record_stream
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", lambda s, e: (waits.append(s), real_wait(s, e))[1])
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: (marks.append(s), real_mark(t, s))[1])
    rng = np.random.RandomState(0)
    host = [{"x": rng.randint(0, 256, size=(256 << 20,)).astype(np.uint8), "i": np.array([i])} for i in range(4)]
    want = [int(h["x"].sum(dtype=np.int64)) for h in host]
    got = []
    for batch in device_prefetch(iter(host), cuda_device):
        assert batch["x"].device == cuda_device and batch["x"].dtype == torch.uint8
        got.append(int(batch["x"].sum(dtype=torch.int64)))  # launched at once on the compute stream
    assert got == want
    compute = torch.cuda.current_stream(cuda_device)
    assert len(waits) == 4 and all(s == compute for s in waits)
    assert len(marks) == 8 and all(s == compute for s in marks)


@pytest.mark.cuda
def test_cuda_batches_match_the_cpu_path(cuda_device):
    host = _batches(5, rng_seed=3)
    on_card = list(device_prefetch(iter(host), cuda_device))
    on_cpu = list(device_prefetch(iter(host), "cpu"))
    for c, h in zip(on_card, on_cpu, strict=True):
        for k in h:
            assert torch.equal(c[k].cpu(), h[k])
