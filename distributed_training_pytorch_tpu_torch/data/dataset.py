"""Data sources: indexable record stores the loader shards across ranks.

The port's copy of ``ArrayDataSource`` from ``distributed_training_pytorch_tpu/data/
dataset.py`` (the in-memory source the LM entry and the tests use). The image-folder
sources come with the image-training slices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ArrayDataSource"]


class ArrayDataSource:
    """In-memory source over parallel arrays: record ``i`` is ``{field: array[i]}``."""

    def __init__(self, transform=None, **arrays: np.ndarray):
        self.transform = transform
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"array lengths differ: {lengths}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self._len = next(iter(lengths.values()))

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, index: int) -> dict:
        return {k: v[index] for k, v in self.arrays.items()}
