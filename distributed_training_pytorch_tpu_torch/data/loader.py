"""Rank-sharded batch loader with a deterministic global shuffle and thread workers.

Counterpart of ``distributed_training_pytorch_tpu/data/loader.py::ShardedLoader``, with
its semantics kept exactly, so both loaders give the same batches:

* the caller names the *global* batch size; rank ``p`` of ``P`` takes rows
  ``[p * L, (p + 1) * L)`` of each global batch, ``L = global_batch // P``;
* the epoch's permutation is a Philox stream keyed by ``(seed, epoch, SHUFFLE_INDEX)``
  (``loader.py:142-151``), the same on every rank;
* training drops the trailing partial batch; evaluation pads it at the global level (the
  last real row repeated) and emits a ``mask`` column, with ``global_real_count`` as the
  weight for aggregating padded batches;
* ``transform`` (else the source's ``transform`` attribute) is applied to each record's
  ``image`` as ``transform(image, epoch=, index=)``, keyed by the record's index in the
  source; ``collate_fn`` (else the source's attribute) turns the list of records into the
  batch, by default a field-wise ``np.stack``;
* whole-batch fast paths (``_batch_fast_path``): ``"source"`` when the source has
  ``load_batch(rows, epoch)``, ``"arrays"`` when it has in-memory ``arrays`` and the
  transform has ``batch_apply(images, rows, epoch)`` (the native augmenter) or there is
  no transform; a custom collate turns them off;
* ``num_workers`` threads (8 by default; 0 produces on the calling thread) with at most
  ``prefetch_batches`` batches in flight beyond the one being consumed: a fast-path batch
  is one task, a per-record batch one task a record. Batches come out in the order they
  were submitted (a FIFO of futures), never in the order they finish, so the batches of
  a ``(seed, epoch, rank)`` are byte-equal whatever ``num_workers`` is. Each worker runs
  its torch CPU ops (the per-record resize) on one intra-op thread, as torch's
  ``DataLoader`` workers do: 8 workers, each with an OpenMP team as wide as the machine,
  would put 8 times the cores' threads on the cores;
* ``iter_batches(start)`` resumes mid-epoch without reading the skipped batches.

The shard index and count (``process_index``/``process_count``) default to the rank and
world size of ``torch.distributed`` (0 and 1 outside a process group); the trainer passes
its mesh's data index and data extent instead, so the seq ranks of one data shard read the
same rows.

``skip_corrupt`` (``loader.py:56``, ``:94-126``): a record that fails to load
(``CorruptRecordError``, or a decode ``ValueError``) is replaced by the next readable one,
deterministically, and counted in ``corrupt_skipped``; a source with its own tolerant batch
path (``data/records.py``'s ``skip_corrupt``) gets the flag set on it, so its whole-batch
fast path degrades the same way (this sets the attribute on the caller's source object).
``load_delay_s`` is an injection seam: a sleep of that many seconds in every batch's
production, on the producing thread (at collate for the per-record path with workers),
so that a test can make the loader the bottleneck on purpose; it is 0 in production.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from distributed_training_pytorch_tpu_torch.data import transforms
from distributed_training_pytorch_tpu_torch.parallel import mesh

__all__ = ["ShardedLoader"]


class ShardedLoader:
    """Iterate this rank's batches ``{field: np.ndarray}`` over an indexable source of
    ``{field: array}`` records."""

    def __init__(
        self,
        source,
        global_batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        transform: Optional[Callable] = None,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 8,
        prefetch_batches: int = 2,
        drop_last: bool = True,
        pad_final: bool = False,
        process_index: "int | None" = None,
        process_count: "int | None" = None,
        skip_corrupt: bool = False,
    ):
        if drop_last and pad_final:
            raise ValueError("drop_last and pad_final are mutually exclusive")
        self.source = source
        self.collate_fn = collate_fn if collate_fn is not None else getattr(source, "collate_fn", None)
        # Sources carry their transform as an attribute; the loader applies it, so the
        # augmentation keys on (epoch, index).
        self.transform = transform if transform is not None else getattr(source, "transform", None)
        self.global_batch_size = int(global_batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = int(num_workers)
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.skip_corrupt = bool(skip_corrupt)
        self._corrupt_skipped = 0
        self._skip_lock = threading.Lock()
        self.load_delay_s = 0.0
        if self.skip_corrupt and hasattr(source, "skip_corrupt"):
            source.skip_corrupt = True
        self._epoch = 0
        self._pidx = mesh.process_index() if process_index is None else process_index
        self._pcount = mesh.process_count() if process_count is None else process_count
        if self.global_batch_size % self._pcount:
            raise ValueError(f"global batch {global_batch_size} not divisible by {self._pcount} ranks")
        self.local_batch_size = self.global_batch_size // self._pcount

    @property
    def corrupt_skipped(self) -> int:
        """Records skipped as corrupt: the loader's own substitutions plus the source's
        (its tolerant reads and batch decodes), one number whichever layer skipped."""
        return self._corrupt_skipped + int(getattr(self.source, "corrupt_skipped", 0))

    def set_epoch(self, epoch: int) -> None:
        """Reseed the epoch permutation (``sampler.set_epoch``)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.source)
        if self.drop_last:
            return n // self.global_batch_size
        return -(-n // self.global_batch_size)

    def _global_order(self) -> np.ndarray:
        n = len(self.source)
        if self.shuffle:
            key = transforms.philox_key(self.seed, self._epoch, transforms.SHUFFLE_INDEX)
            return np.random.Generator(np.random.Philox(key=key)).permutation(n)
        return np.arange(n)

    def global_real_count(self, batch_index: int) -> int:
        """Real (unpadded) rows of global batch ``batch_index``: the same on every rank,
        so the right weight for aggregating padded validation batches."""
        n = len(self.source)
        return max(0, min(self.global_batch_size, n - batch_index * self.global_batch_size))

    def _batch_fast_path(self) -> "str | None":
        """``"source"``, ``"arrays"`` or None (per-record production)."""
        if self.collate_fn is not None:
            return None  # a custom collate exists to replace the fast paths' own stacking
        if hasattr(self.source, "load_batch"):
            return "source"
        if hasattr(self.source, "arrays") and (self.transform is None or hasattr(self.transform, "batch_apply")):
            return "arrays"
        return None

    def _load_one_raw(self, index: int, epoch: int) -> dict:
        record = dict(self.source[int(index)])
        if self.transform is not None and "image" in record:
            record["image"] = self.transform(record["image"], epoch=epoch, index=int(index))
        return record

    def _load_one(self, index: int, epoch: int) -> dict:
        if not self.skip_corrupt:
            return self._load_one_raw(index, epoch)
        from distributed_training_pytorch_tpu_torch.data.records import CorruptRecordError, tolerant_fetch

        record, skipped = tolerant_fetch(
            lambda i: self._load_one_raw(i, epoch), index, len(self.source),
            exceptions=(CorruptRecordError, ValueError),  # decode and transform failures raise ValueError too
        )
        if skipped:
            with self._skip_lock:  # worker threads count at once
                self._corrupt_skipped += skipped
        return record

    def _maybe_delay(self) -> None:
        if self.load_delay_s:
            time.sleep(float(self.load_delay_s))  # the injection seam (see the module docstring)

    def _collate(self, records: "list[dict]", mask: "np.ndarray | None") -> dict:
        if self.collate_fn is not None:
            batch = dict(self.collate_fn(records))
        else:
            batch = {k: np.stack([r[k] for r in records]) for k in records[0]}
        if mask is not None:
            batch["mask"] = mask  # the loader's, even under a custom collate
        return batch

    def _produce_batch(self, rows: np.ndarray, mask, epoch: int, fast: "str | None") -> dict:
        self._maybe_delay()
        if fast == "source":
            batch = dict(self.source.load_batch(rows, epoch))
        elif fast == "arrays":
            batch = {k: v[rows] for k, v in self.source.arrays.items()}
            if self.transform is not None and "image" in batch:
                batch["image"] = self.transform.batch_apply(batch["image"], rows, epoch)
        else:
            return self._collate([self._load_one(i, epoch) for i in rows], mask)
        if mask is not None:
            batch["mask"] = mask
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0) -> Iterator[dict]:
        """This rank's batches from global batch ``start`` on. The permutation is a pure
        function of ``(seed, epoch)``, so a mid-epoch resume skips at the index level and
        reads none of the skipped records."""
        order = self._global_order()
        epoch = self._epoch
        num_batches = len(self)
        g, l, p = self.global_batch_size, self.local_batch_size, self._pidx

        def batch_rows(b: int) -> "tuple[np.ndarray, np.ndarray | None]":
            rows = order[b * g : (b + 1) * g]
            mask = None
            if self.pad_final:
                real = len(rows)
                if real < g:
                    rows = np.concatenate([rows, np.repeat(rows[-1:], g - real)])
                mask = (np.arange(g) < real).astype(np.float32)[p * l : (p + 1) * l]
            return rows[p * l : (p + 1) * l], mask

        fast = self._batch_fast_path()
        start = max(0, int(start))
        if self.num_workers <= 0:
            for b in range(start, num_batches):
                yield self._produce_batch(*batch_rows(b), epoch, fast)
            return

        # torch.set_num_threads sets the calling thread's OpenMP team and the default of
        # every thread started after it: the workers take 1, and the finally below gives
        # the default back (this thread's own count is read, and so fixed, first).
        threads = torch.get_num_threads()
        pool = cf.ThreadPoolExecutor(
            self.num_workers, thread_name_prefix="loader", initializer=torch.set_num_threads, initargs=(1,)
        )
        window: queue.SimpleQueue = queue.SimpleQueue()  # futures in submission order

        def submit(b: int) -> None:
            rows, mask = batch_rows(b)
            if fast is not None:
                window.put((pool.submit(self._produce_batch, rows, mask, epoch, fast), None))
            else:
                window.put(([pool.submit(self._load_one, i, epoch) for i in rows], mask))

        try:
            upto = min(start + self.prefetch_batches, num_batches)
            for b in range(start, upto):
                submit(b)
            for _ in range(start, num_batches):
                item, mask = window.get()
                if upto < num_batches:
                    submit(upto)
                    upto += 1
                if fast is not None:
                    yield item.result()
                else:
                    self._maybe_delay()  # the per-record path: the delay at collate
                    yield self._collate([f.result() for f in item], mask)
        finally:
            # An abandoned iterator drops the batches not yet started.
            pool.shutdown(wait=True, cancel_futures=True)
            torch.set_num_threads(threads)
