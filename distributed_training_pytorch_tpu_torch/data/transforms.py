"""Deterministic per-record randomness keys.

The port's copy of the key packing of ``distributed_training_pytorch_tpu/data/
transforms.py`` (``philox_key``, ``SHUFFLE_INDEX``), which the loader's epoch shuffle
needs. The image transforms themselves come with the image-training slices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SHUFFLE_INDEX", "philox_key"]


def philox_key(seed: int, epoch: int, index: int) -> np.ndarray:
    """Pack (seed, epoch, index) into Philox's 2x64-bit key (epoch in the top 24 bits of
    word 1, index below: 2^40-1 records per epoch; the top index is ``SHUFFLE_INDEX``)."""
    word1 = (np.uint64(epoch) << np.uint64(40)) | np.uint64(index)
    return np.array([np.uint64(seed), word1], dtype=np.uint64)


# Reserved record index for the loader's epoch-shuffle stream: it keeps the permutation's
# draws apart from every per-record stream of the same (seed, epoch).
SHUFFLE_INDEX = (1 << 40) - 1
