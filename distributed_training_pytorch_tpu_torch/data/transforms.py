"""Host-side image transforms with deterministic per-record randomness.

The port's copy of ``distributed_training_pytorch_tpu/data/transforms.py``: the Philox key
packing (``philox_key``, ``SHUFFLE_INDEX``, also the loader's epoch shuffle),
``IMAGENET_MEAN``/``IMAGENET_STD``, every transform, ``Compose``, ``train_transform`` (the
image-folder entry's ten-step train chain) and ``eval_transform``. A transform maps
``(rgb uint8 HWC image, np.random.Generator)`` to an image; ``Compose`` keys its generator
by ``(seed, epoch, index)``, so every rank computes the same augmentation for the same
record, and a resume replays the same stream.

The random draws are the JAX package's, in the same order, so the same transforms fire
with the same parameters. The JAX package calls OpenCV for five of them; the card's
machine has no OpenCV, so here:

* ``blur``, ``median_blur``, ``clahe`` and ``image_compression`` call the port's native
  library (``data/native.py``: ``box_blur``, ``median_blur``, ``clahe``,
  ``jpeg_roundtrip``), which reproduces OpenCV's and libjpeg-turbo's arithmetic and gives
  the same bytes (``tests/test_torch_folder_transforms.py``). A library that did not build
  raises; there is no other path;
* ``resize`` is bilinear in f32 with half-pixel centres and no antialiasing (OpenCV's
  sampling grid), rounded to uint8; OpenCV's fixed-point arithmetic may land a pixel 1
  away.

``FIRED`` counts, per transform name, how many times a random transform fired in this
process (loader workers included), so a run can show that each one ran.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FIRED",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "SHUFFLE_INDEX",
    "Compose",
    "blur",
    "clahe",
    "eval_transform",
    "horizontal_flip",
    "image_compression",
    "median_blur",
    "normalize",
    "philox_key",
    "random_brightness_contrast",
    "random_gamma",
    "random_resized_crop",
    "random_rotate90",
    "resize",
    "train_transform",
    "vertical_flip",
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

Transform = Callable[[np.ndarray, np.random.Generator], np.ndarray]

FIRED: "collections.Counter[str]" = collections.Counter()
_fired_lock = threading.Lock()


def _fired(name: str) -> None:
    with _fired_lock:
        FIRED[name] += 1


def _native():
    from distributed_training_pytorch_tpu_torch.data import native

    return native


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


def random_rotate90(p: float = 0.5) -> Transform:
    def apply(img, rng):
        if rng.random() < p:
            _fired("random_rotate90")
            img = np.rot90(img, k=int(rng.integers(1, 4)))
        return img

    return apply


def horizontal_flip(p: float = 0.5) -> Transform:
    def apply(img, rng):
        if rng.random() < p:
            _fired("horizontal_flip")
            return img[:, ::-1]
        return img

    return apply


def vertical_flip(p: float = 0.5) -> Transform:
    def apply(img, rng):
        if rng.random() < p:
            _fired("vertical_flip")
            return img[::-1]
        return img

    return apply


def blur(p: float = 0.5, max_kernel: int = 7) -> Transform:
    """``cv2.blur`` with an odd kernel of 3 to ``max_kernel``, through ``native.box_blur``."""

    def apply(img, rng):
        if rng.random() < p:
            k = int(rng.integers(1, max_kernel // 2 + 1)) * 2 + 1  # odd, 3..7
            _fired("blur")
            img = _native().box_blur(img, k)
        return img

    return apply


def median_blur(p: float = 0.5, max_kernel: int = 5) -> Transform:
    """``cv2.medianBlur`` with an odd kernel of 3 to ``max_kernel``, through
    ``native.median_blur``."""

    def apply(img, rng):
        if rng.random() < p:
            k = int(rng.integers(1, max_kernel // 2 + 1)) * 2 + 1  # odd, 3..5
            _fired("median_blur")
            img = _native().median_blur(img, k)
        return img

    return apply


def clahe(p: float = 0.5, clip_limit: float = 4.0, tile: int = 8) -> Transform:
    """CLAHE on LAB's L channel (OpenCV's), through ``native.clahe``."""

    def apply(img, rng):
        if rng.random() < p:
            _fired("clahe")
            img = _native().clahe(img, clip_limit, tile)
        return img

    return apply


def random_brightness_contrast(p: float = 0.5, limit: float = 0.2) -> Transform:
    def apply(img, rng):
        if rng.random() < p:
            alpha = 1.0 + float(rng.uniform(-limit, limit))  # contrast
            beta = float(rng.uniform(-limit, limit)) * 255.0  # brightness
            _fired("random_brightness_contrast")
            img = np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)
        return img

    return apply


def random_gamma(p: float = 0.5, gamma_range: "tuple[int, int]" = (80, 120)) -> Transform:
    def apply(img, rng):
        if rng.random() < p:
            gamma = float(rng.uniform(*gamma_range)) / 100.0
            _fired("random_gamma")
            img = (np.power(img.astype(np.float32) / 255.0, gamma) * 255.0).astype(np.uint8)
        return img

    return apply


def image_compression(p: float = 0.5, quality_range: "tuple[int, int]" = (80, 100)) -> Transform:
    """A JPEG encode and decode at a quality in ``quality_range`` (OpenCV's, with
    libjpeg-turbo's defaults), through ``native.jpeg_roundtrip``."""

    def apply(img, rng):
        if rng.random() < p:
            quality = int(rng.integers(quality_range[0], quality_range[1] + 1))
            _fired("image_compression")
            img = _native().jpeg_roundtrip(img, quality)
        return img

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


def train_transform(height: int, width: int, *, seed: int = 0, p: float = 0.5) -> Compose:
    """The image-folder entry's train chain: resize, rotate90, the two flips, blur,
    median blur, CLAHE, brightness/contrast, gamma and JPEG re-encoding (each at ``p``),
    then normalise."""
    return Compose(
        [
            resize(height, width),
            random_rotate90(p),
            horizontal_flip(p),
            vertical_flip(p),
            blur(p),
            median_blur(p),
            clahe(p),
            random_brightness_contrast(p),
            random_gamma(p),
            image_compression(p),
            normalize(),
        ],
        seed=seed,
    )


def eval_transform(height: int, width: int) -> Compose:
    """The val-phase pipeline: resize, then normalise."""
    return Compose([resize(height, width), normalize()])
