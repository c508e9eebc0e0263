"""The port's ``ShardedLoader`` with thread workers
(``distributed_training_pytorch_tpu_torch/data/loader.py``), held against itself without
workers and against the JAX package's loader with workers on.

The JAX loader imports the JAX package's ``data/`` package, which does not import in this
tree (its ``data/streaming/`` was never committed), so it runs in a subprocess that first
installs a stand-in ``data.streaming`` module whose names raise when used, as
``tests/test_torch_trainer_lm.py`` does; it builds the JAX native library under a file
lock, as ``tests/test_torch_native_data.py`` does.

Tolerance: batches byte-equal (same dtypes, shapes and bytes) for every rank, for
``num_workers`` 0, 1 and 8, on the ``"arrays"`` fast path (the native crop/flip) and on
the per-record path (flip + normalise through ``transforms.Compose``).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.data import ArrayDataSource, ShardedLoader, native
from distributed_training_pytorch_tpu_torch.data import transforms as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RECORDS, BATCH = 75, 16
CASES = [  # seed, epoch, process_count, phase, path
    (0, 0, 1, "train", "arrays"), (3, 2, 2, "train", "arrays"), (5, 1, 2, "val", "arrays"),
    (0, 1, 1, "train", "records"), (4, 3, 2, "train", "records"), (2, 0, 2, "val", "records"),
]

JAX_SIDE = textwrap.dedent(
    """
    import fcntl, json, os, sys, types
    import numpy as np

    stub = types.ModuleType("distributed_training_pytorch_tpu.data.streaming")
    def _unavailable(*a, **k):
        raise RuntimeError("data/streaming is not in this tree")
    for name in ("DecodePool", "ReaderState", "StreamingLoader", "shard_array_source"):
        setattr(stub, name, _unavailable)
    sys.modules[stub.__name__] = stub

    from distributed_training_pytorch_tpu.data import ArrayDataSource, ShardedLoader, native
    from distributed_training_pytorch_tpu.data import transforms as T
    os.makedirs("build", exist_ok=True)
    with open("build/.jax_native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one make at a time across test processes
        assert native.available(), "the JAX package's native library did not build"

    out, n, batch, cases = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), json.loads(sys.argv[4])
    rng = np.random.RandomState(17)
    images = rng.randint(0, 256, size=(n, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, 10, size=(n,)).astype(np.int32)
    res = {"images": images, "labels": labels}
    for ci, (seed, epoch, count, phase, path) in enumerate(cases):
        train = phase == "train"
        if path == "arrays":
            tfm = native.NativeCropFlipU8(pad=4, seed=seed, train=train)
        else:
            tfm = T.Compose([T.horizontal_flip(), T.normalize()], seed=seed)
        source = ArrayDataSource(transform=tfm, image=images, label=labels)
        for rank in range(count):
            loader = ShardedLoader(source, batch, shuffle=train, seed=seed, drop_last=train, pad_final=not train,
                                   process_index=rank, process_count=count, num_workers=8, prefetch_batches=2)
            assert loader._batch_fast_path() == ("arrays" if path == "arrays" else None)
            loader.set_epoch(epoch)
            for b, got in enumerate(loader):
                for k, v in got.items():
                    res[f"{ci}/{rank}/{b}/{k}"] = v
    np.savez(out, **res)
    """
)


def _source(path, seed, train, images, labels):
    if path == "arrays":
        tfm = native.NativeCropFlipU8(pad=4, seed=seed, train=train)
    else:
        tfm = T.Compose([T.horizontal_flip(), T.normalize()], seed=seed)
    return ArrayDataSource(transform=tfm, image=images, label=labels)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_loader") / "batches.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, out, str(N_RECORDS), str(BATCH), json.dumps(CASES)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("num_workers", [0, 1, 8])
@pytest.mark.parametrize("ci", range(len(CASES)), ids=["-".join(map(str, c)) for c in CASES])
def test_batches_are_byte_equal_whatever_the_workers_and_to_the_jax_loader(jax_side, ci, num_workers):
    seed, epoch, count, phase, path = CASES[ci]
    train = phase == "train"
    source = _source(path, seed, train, jax_side["images"], jax_side["labels"])
    n_batches = 0
    for rank in range(count):
        loader = ShardedLoader(source, BATCH, shuffle=train, seed=seed, drop_last=train, pad_final=not train,
                               process_index=rank, process_count=count, num_workers=num_workers)
        assert loader._batch_fast_path() == ("arrays" if path == "arrays" else None)
        loader.set_epoch(epoch)
        batches = list(loader)
        assert len(batches) == len(loader)
        for b, got in enumerate(batches):
            keys = {k.rsplit("/", 1)[1] for k in jax_side if k.startswith(f"{ci}/{rank}/{b}/")}
            assert set(got) == keys == ({"image", "label"} | ({"mask"} if not train else set()))
            for k, v in got.items():
                want = jax_side[f"{ci}/{rank}/{b}/{k}"]
                assert v.dtype == want.dtype and v.shape == want.shape, (b, k)
                assert v.tobytes() == want.tobytes(), (b, k)
            n_batches += 1
    assert n_batches == count * len(loader) > 0
    assert f"{ci}/0/{len(loader)}/label" not in jax_side  # the JAX loader gave no more batches


class _Source:
    """A per-record source that can fail on one index and counts the batches started."""

    def __init__(self, n, fail_at=None, delay=0.0):
        self.n, self.fail_at, self.delay = n, fail_at, delay

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        if index == self.fail_at:
            raise KeyError(f"record {index} is broken")
        time.sleep(self.delay)
        return {"x": np.array([index], np.int64)}


class _BatchSource(_Source):
    """A source with its own whole-batch path (``load_batch``)."""

    def __init__(self, n, batch, **kw):
        super().__init__(n, **kw)
        self.batch = batch
        self.started = []
        self.lock = threading.Lock()

    def load_batch(self, rows, epoch):
        with self.lock:
            self.started.append(int(rows[0]))
        if self.fail_at is not None and self.fail_at in rows:
            raise KeyError(f"record {self.fail_at} is broken")
        time.sleep(self.delay)
        return {"x": np.asarray(rows, np.int64)}


@pytest.mark.parametrize("kind", ["records", "source"])
@pytest.mark.parametrize("num_workers", [0, 4])
def test_a_workers_exception_reaches_the_consumer(kind, num_workers):
    source = _Source(40, fail_at=21) if kind == "records" else _BatchSource(40, 8, fail_at=21)
    loader = ShardedLoader(source, 8, shuffle=False, num_workers=num_workers)
    got = []
    with pytest.raises(KeyError, match="record 21 is broken"):
        for batch in loader:
            got.append(batch["x"])
    assert len(got) == 2  # the batches before the broken one arrive, in order
    assert np.array_equal(np.concatenate(got).ravel(), np.arange(16))


@pytest.mark.parametrize("kind", ["arrays", "records"])
@pytest.mark.parametrize("start", [0, 1, 3, 4])
def test_iter_batches_from_start_is_the_tail_of_the_epoch(kind, start):
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, size=(37, 32, 32, 3)).astype(np.uint8)
    source = _source(kind, 6, True, images, np.arange(37, dtype=np.int32))
    loader = ShardedLoader(source, 8, seed=6, num_workers=3)
    loader.set_epoch(4)
    full = list(loader)
    tail = list(loader.iter_batches(start))
    assert len(full) == 4 and len(tail) == len(full) - start
    for a, b in zip(full[start:], tail, strict=True):
        assert all(np.array_equal(a[k], b[k]) for k in a)


class _RecordThreads(_Source):
    """Records the intra-op thread count of the thread that loads each record."""

    def __init__(self, n):
        super().__init__(n)
        self.threads = []

    def __getitem__(self, index):
        self.threads.append(torch.get_num_threads())
        return super().__getitem__(index)


class _BatchThreads(_BatchSource):
    """Records the intra-op thread count of the thread that loads each batch."""

    def __init__(self, n, batch):
        super().__init__(n, batch)
        self.threads = []

    def load_batch(self, rows, epoch):
        self.threads.append(torch.get_num_threads())
        return super().load_batch(rows, epoch)


@pytest.mark.parametrize("kind", ["records", "source"])
def test_workers_run_torch_on_one_thread_and_the_counts_are_restored(kind):
    """Each worker's torch CPU ops get one intra-op thread (8 workers with a full OpenMP
    team each would oversubscribe the cores); the consumer's count and the default of
    threads started after the epoch are what they were."""
    before = torch.get_num_threads()
    source = _RecordThreads(40) if kind == "records" else _BatchThreads(40, 8)
    loader = ShardedLoader(source, 8, shuffle=False, num_workers=4)
    assert len(list(loader)) == 5
    assert len(source.threads) == (40 if kind == "records" else 5) and set(source.threads) == {1}
    assert torch.get_num_threads() == before
    later = []
    thread = threading.Thread(target=lambda: later.append(torch.get_num_threads()))
    thread.start()
    thread.join()
    assert later == [before]


@pytest.mark.parametrize("window", [1, 2, 3])
def test_the_in_flight_window_holds_at_most_prefetch_batches(window):
    """While the consumer holds its k-th batch, at most ``k + prefetch_batches`` batches
    have been started."""
    source = _BatchSource(80, 8, delay=0.005)
    loader = ShardedLoader(source, 8, shuffle=False, num_workers=8, prefetch_batches=window)
    most_ahead = 0
    for k, batch in enumerate(loader, start=1):
        time.sleep(0.02)  # a slow consumer: the workers run ahead as far as they may
        with source.lock:
            started = len(source.started)
        most_ahead = max(most_ahead, started - k)
        assert int(batch["x"][0]) == (k - 1) * 8
    assert most_ahead == window


def test_collate_fn_takes_the_records_and_the_loader_keeps_the_mask():
    source = _Source(10)
    seen = []

    def collate(records):
        seen.append(len(records))
        return {"x": np.concatenate([r["x"] for r in records]) * 10}

    loader = ShardedLoader(source, 4, shuffle=False, drop_last=False, pad_final=True, collate_fn=collate,
                           num_workers=2)
    batches = list(loader)
    assert loader._batch_fast_path() is None and seen == [4, 4, 4]
    assert np.array_equal(batches[-1]["x"], [80, 90, 90, 90])
    assert np.array_equal(batches[-1]["mask"], [1, 1, 0, 0])


def test_record_slice_options_raise():
    """The record slice's loader options, which raised before it landed: ``skip_corrupt``
    substitutes the next readable record for one that raises ``CorruptRecordError`` and
    counts it, and ``load_delay_s`` is set and read back (the seam sleeps a batch)."""
    from distributed_training_pytorch_tpu_torch.data.records import CorruptRecordError

    class _Corrupt(_Source):
        def __getitem__(self, index):
            if index == 1:
                raise CorruptRecordError("record 1 is damaged")
            return super().__getitem__(index)

    loader = ShardedLoader(_Corrupt(4), 2, shuffle=False, skip_corrupt=True, num_workers=2)
    batches = list(loader)
    assert loader.corrupt_skipped == 1
    assert np.array_equal(batches[0]["x"], [[0], [2]])  # record 1 gave way to record 2
    with pytest.raises(CorruptRecordError):
        list(ShardedLoader(_Corrupt(4), 2, shuffle=False, num_workers=0))
    loader = ShardedLoader(_Source(4), 2)
    loader.load_delay_s = 0.5
    assert loader.load_delay_s == 0.5


