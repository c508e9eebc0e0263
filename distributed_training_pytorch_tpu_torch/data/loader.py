"""Rank-sharded batch loader with a deterministic global shuffle.

Counterpart of ``distributed_training_pytorch_tpu/data/loader.py::ShardedLoader``, with
its semantics kept exactly, so both loaders give the same batches:

* the caller names the *global* batch size; rank ``p`` of ``P`` takes rows
  ``[p * L, (p + 1) * L)`` of each global batch, ``L = global_batch // P``;
* the epoch's permutation is a Philox stream keyed by ``(seed, epoch, SHUFFLE_INDEX)``
  (``loader.py:142-151``), the same on every rank;
* training drops the trailing partial batch; evaluation pads it at the global level (the
  last real row repeated) and emits a ``mask`` column, with ``global_real_count`` as the
  weight for aggregating padded batches.

* the source's ``transform`` attribute, when it has one, is applied to each record's
  ``image`` as ``transform(image, epoch=, index=)``, keyed by the record's index in the
  source (``loader.py:153-157``); a source's ``arrays`` are sliced whole only when there is
  no transform.

The shard index and count (``process_index``/``process_count``) default to the rank and
world size of ``torch.distributed`` (0 and 1 outside a process group); the trainer passes
its mesh's data index and data extent instead, so the seq ranks of one data shard read the
same rows. Batches are numpy arrays, made on the calling thread. What the JAX loader
also has comes with later slices: the whole-batch fast paths (``load_batch``,
``batch_apply``) of the record and native sources, a ``collate_fn``, thread workers with a
prefetch window, corrupt-record skipping, and the mid-epoch resume entry
``iter_batches``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from distributed_training_pytorch_tpu_torch.data import transforms
from distributed_training_pytorch_tpu_torch.parallel import mesh

__all__ = ["ShardedLoader"]


class ShardedLoader:
    """Iterate this rank's batches ``{field: np.ndarray}`` over an indexable source of
    ``{field: array}`` records (an ``ArrayDataSource``'s rows are sliced at once)."""

    def __init__(
        self,
        source,
        global_batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        pad_final: bool = False,
        process_index: "int | None" = None,
        process_count: "int | None" = None,
    ):
        if drop_last and pad_final:
            raise ValueError("drop_last and pad_final are mutually exclusive")
        self.source = source
        # Sources carry their transform as an attribute; the loader applies it, so the
        # augmentation keys on (epoch, index).
        self.transform = getattr(source, "transform", None)
        self.global_batch_size = int(global_batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_final = pad_final
        self._epoch = 0
        self._pidx = mesh.process_index() if process_index is None else process_index
        self._pcount = mesh.process_count() if process_count is None else process_count
        if self.global_batch_size % self._pcount:
            raise ValueError(f"global batch {global_batch_size} not divisible by {self._pcount} ranks")
        self.local_batch_size = self.global_batch_size // self._pcount

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

    def _load_one(self, index: int) -> dict:
        record = dict(self.source[index])
        if self.transform is not None and "image" in record:
            record["image"] = self.transform(record["image"], epoch=self._epoch, index=index)
        return record

    def _produce(self, rows: np.ndarray) -> dict:
        arrays = getattr(self.source, "arrays", None)
        if arrays is not None and self.transform is None:
            return {k: v[rows] for k, v in arrays.items()}
        records = [self._load_one(int(i)) for i in rows]
        return {k: np.stack([r[k] for r in records]) for k in records[0]}

    def __iter__(self) -> Iterator[dict]:
        order = self._global_order()
        g, l, p = self.global_batch_size, self.local_batch_size, self._pidx
        for b in range(len(self)):
            rows = order[b * g : (b + 1) * g]
            mask = None
            if self.pad_final:
                real = len(rows)
                if real < g:
                    rows = np.concatenate([rows, np.repeat(rows[-1:], g - real)])
                mask = (np.arange(g) < real).astype(np.float32)[p * l : (p + 1) * l]
            batch = self._produce(rows[p * l : (p + 1) * l])
            if mask is not None:
                batch["mask"] = mask
            yield batch
