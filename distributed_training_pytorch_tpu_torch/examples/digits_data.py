"""The digits corpus as an image-folder tree, without scikit-learn or OpenCV.

Counterpart of the repository's ``examples/digits_data.py``. The 1,797 8x8 grayscale
handwritten digits (values 0..16) and their labels are read from ``digits_8x8.npz`` beside
this module: the test set of the UCI "Optical Recognition of Handwritten Digits" data
(creator E. Alpaydin, 1998;
https://archive.ics.uci.edu/ml/datasets/Optical+Recognition+of+Handwritten+Digits), as
scikit-learn 1.9.0 ships it (``sklearn.datasets.load_digits``), under the Creative Commons
Attribution 4.0 licence (CC BY 4.0). The file was written once from that installed copy;
nothing is downloaded.

``materialize`` writes ``<root>/{train,test}/<digit>/{i:04d}.png`` as the JAX package
does: the same stratified 80/20 split from ``np.random.RandomState(seed)`` (1,438 train and
359 test images), the same float64 scaling to 0..255, the 8 -> 32 nearest-neighbour
upscale (``cv2.INTER_NEAREST`` at scale 4, which is ``np.repeat`` by 4 on both axes), and
3-channel PNG files from the port's own writer (``data/png.py``), which decode to the same
pixels as the JAX package's files. A ``.complete`` marker makes it a no-op the second time.
"""

from __future__ import annotations

import os

import numpy as np

from distributed_training_pytorch_tpu_torch.data.png import rgb_png

__all__ = ["LABELS", "SIZE", "load_digits", "materialize"]

LABELS = [str(d) for d in range(10)]
SIZE = 32
CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "digits_8x8.npz")


def load_digits() -> "tuple[np.ndarray, np.ndarray]":
    """``(images, targets)``: float64 ``[1797, 8, 8]`` in 0..16 and int64 ``[1797]``, the
    arrays ``sklearn.datasets.load_digits()`` returns as ``images`` and ``target``."""
    with np.load(CORPUS) as z:
        return z["images"].astype(np.float64), z["target"].astype(np.int64)


def materialize(root: str, *, seed: int = 0) -> dict:
    """Write ``<root>/{train,test}/<digit>/*.png``; a no-op if already present.

    Returns counts ``{"train": n, "test": n}``."""
    marker = os.path.join(root, ".complete")
    if os.path.exists(marker):
        return {
            split: sum(len(os.listdir(os.path.join(root, split, lb))) for lb in LABELS) for split in ("train", "test")
        }
    images, targets = load_digits()
    scale = SIZE // images.shape[1]
    rng = np.random.RandomState(seed)
    counts = {"train": 0, "test": 0}
    for digit in range(10):
        idx = np.flatnonzero(targets == digit)
        rng.shuffle(idx)
        n_test = max(1, int(round(0.2 * len(idx))))
        for split, members in (("test", idx[:n_test]), ("train", idx[n_test:])):
            d = os.path.join(root, split, str(digit))
            os.makedirs(d, exist_ok=True)
            for i in members:
                img = np.clip(images[i] * (255.0 / 16.0), 0, 255).astype(np.uint8)
                img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
                with open(os.path.join(d, f"{i:04d}.png"), "wb") as f:
                    f.write(rgb_png(np.repeat(img[:, :, None], 3, axis=2)))
            counts[split] += len(members)
    with open(marker, "w") as f:
        f.write("ok\n")
    return counts


if __name__ == "__main__":
    import sys

    print(materialize(sys.argv[1] if len(sys.argv) > 1 else "./data/digits"))
