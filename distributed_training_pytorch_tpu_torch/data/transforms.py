"""Host-side image transforms with deterministic per-record randomness.

The port's copy of what the ImageNet entry needs from ``distributed_training_pytorch_tpu/
data/transforms.py``: the Philox key packing (``philox_key``, ``SHUFFLE_INDEX``, also the
loader's epoch shuffle), ``IMAGENET_MEAN``/``IMAGENET_STD``, ``resize``,
``random_resized_crop``, ``horizontal_flip``, ``normalize``, ``Compose`` and
``eval_transform``. A transform maps ``(rgb uint8 HWC image, np.random.Generator)`` to an
image; ``Compose`` keys its generator by ``(seed, epoch, index)``, so every rank computes
the same augmentation for the same record, and a resume replays the same stream.

The random draws are the JAX package's, in the same order, so the crop boxes and flips
are identical. Resizing differs in one respect: the JAX package calls OpenCV's
``INTER_LINEAR``, and the card's machine has no OpenCV, so here the resize is bilinear in
f32 with half-pixel centres and no antialiasing (OpenCV's sampling grid), rounded to
uint8. OpenCV's fixed-point arithmetic may land a pixel 1 away.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "SHUFFLE_INDEX",
    "Compose",
    "eval_transform",
    "horizontal_flip",
    "normalize",
    "philox_key",
    "random_resized_crop",
    "resize",
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

Transform = Callable[[np.ndarray, np.random.Generator], np.ndarray]


def philox_key(seed: int, epoch: int, index: int) -> np.ndarray:
    """Pack (seed, epoch, index) into Philox's 2x64-bit key (epoch in the top 24 bits of
    word 1, index below: 2^40-1 records per epoch; the top index is ``SHUFFLE_INDEX``)."""
    word1 = (np.uint64(epoch) << np.uint64(40)) | np.uint64(index)
    return np.array([np.uint64(seed), word1], dtype=np.uint64)


# Reserved record index for the loader's epoch-shuffle stream: it keeps the permutation's
# draws apart from every per-record stream of the same (seed, epoch).
SHUFFLE_INDEX = (1 << 40) - 1


def _resize_image(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of an HWC image to ``(height, width)``: half-pixel centres, edge
    clamp, no antialias (OpenCV ``INTER_LINEAR``'s grid); uint8 rounds half up."""
    if img.shape[:2] == (height, width):
        return img.copy()
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    out = F.interpolate(t, size=(height, width), mode="bilinear", align_corners=False, antialias=False)
    out = out[0].permute(1, 2, 0)
    if img.dtype == np.uint8:
        out = torch.floor(out + 0.5).clamp_(0, 255).to(torch.uint8)
    return out.numpy().astype(img.dtype, copy=False)


def resize(height: int, width: int) -> Transform:
    def apply(img, rng):
        return _resize_image(img, height, width)

    return apply


def random_resized_crop(
    height: int,
    width: int,
    scale: "tuple[float, float]" = (0.08, 1.0),
    ratio: "tuple[float, float]" = (3 / 4, 4 / 3),
) -> Transform:
    """Standard ImageNet train crop: sample an area fraction and aspect ratio, crop,
    resize to (height, width). Falls back to a centre crop when 10 attempts do not fit
    (torchvision semantics)."""

    def apply(img, rng):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * rng.uniform(*scale)
            log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
            cw = int(round(np.sqrt(target * np.exp(log_r))))
            ch = int(round(np.sqrt(target / np.exp(log_r))))
            if 0 < cw <= w and 0 < ch <= h:
                y0 = int(rng.integers(0, h - ch + 1))
                x0 = int(rng.integers(0, w - cw + 1))
                return _resize_image(img[y0 : y0 + ch, x0 : x0 + cw], height, width)
        side = min(h, w)
        y0, x0 = (h - side) // 2, (w - side) // 2
        return _resize_image(img[y0 : y0 + side, x0 : x0 + side], height, width)

    return apply


def horizontal_flip(p: float = 0.5) -> Transform:
    def apply(img, rng):
        return img[:, ::-1] if rng.random() < p else img

    return apply


def normalize(mean: np.ndarray = IMAGENET_MEAN, std: np.ndarray = IMAGENET_STD) -> Transform:
    def apply(img, rng):
        return (img.astype(np.float32) / 255.0 - mean) / std

    return apply


class Compose:
    """Apply transforms in order with a Philox generator keyed by ``(seed, epoch, index)``:
    deterministic and the same on every host."""

    def __init__(self, transforms: Sequence[Transform], seed: int = 0):
        self.transforms = list(transforms)
        self.seed = seed

    def __call__(self, img: np.ndarray, *, epoch: int = 0, index: int = 0) -> np.ndarray:
        rng = np.random.Generator(np.random.Philox(key=philox_key(self.seed, epoch, index)))
        for t in self.transforms:
            img = t(img, rng)
        return np.ascontiguousarray(img)


def eval_transform(height: int, width: int) -> Compose:
    """The val-phase pipeline: resize, then normalise."""
    return Compose([resize(height, width), normalize()])
