"""The native library's codec-free uint8 entries (``data/native.py::resize_u8_batch`` and
``rrc_flip_u8_batch`` over ``csrc/dtp_native.cpp``) held against a numpy reference, on the
card's machine, where the library is built without libjpeg/libpng (``-DDTP_NO_CODECS``)
and these entries carry every record batch (``data/records.py``).

The reference is written from the algorithm, not from the C++: Philox4x32-10 keyed by
``(seed, epoch << 40 | index)``, 10 attempts of an area fraction and a log-uniform aspect
ratio, the centre square after them, a flip at p 0.5, and bilinear sampling with
half-pixel centres in float64, each sample rounded half up. Tolerance: bit-equal.

Every test carries the ``cuda`` marker and skips without a card: this host's build is held
bit-equal to the fused decode entries and the JAX library in ``tests/test_torch_records.py``.
The file imports neither JAX nor the JAX package, so it runs on the card's machine under
``pytest --noconftest -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from distributed_training_pytorch_tpu_torch.data import native

pytestmark = pytest.mark.cuda

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


@pytest.fixture()
def card_build():
    if not torch.cuda.is_available():
        pytest.skip("runs on the card's machine, whose library has no codecs; this host's build is held in "
                    "tests/test_torch_records.py")
    assert native.available(), native.build_error()


class _Philox:
    """Philox4x32-10 as a stream of 32-bit words, last word of each block first."""

    def __init__(self, seed: int, stream: int):
        self.key = [seed & MASK, (seed >> 32) & MASK]
        self.ctr = [stream & MASK, (stream >> 32) & MASK, 0, 0]
        self.out: "list[int]" = []

    def _block(self):
        c, k = list(self.ctr), list(self.key)
        for _ in range(10):
            p0, p1 = M0 * c[0], M1 * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & MASK, (p0 >> 32) ^ c[3] ^ k[1], p0 & MASK]
            k = [(k[0] + W0) & MASK, (k[1] + W1) & MASK]
        self.out = c
        self.ctr[2] = (self.ctr[2] + 1) & MASK
        if self.ctr[2] == 0:
            self.ctr[3] = (self.ctr[3] + 1) & MASK

    def uniform(self) -> float:
        if not self.out:
            self._block()
        return self.out.pop() / 4294967296.0

    def randint(self, n: int) -> int:
        return int(self.uniform() * n)


def _bilinear(src, x0, y0, cw, ch, out_h, out_w, mirror=False):
    """The window ``(x0, y0, cw, ch)`` of ``src`` resampled to ``out_h x out_w``."""
    sy, sx = ch / out_h, cw / out_w
    fy = (np.arange(out_h) + 0.5) * sy - 0.5
    gx = np.arange(out_w)[::-1] if mirror else np.arange(out_w)
    fx = (gx + 0.5) * sx - 0.5
    iy0, ix0 = np.floor(np.maximum(fy, 0)).astype(int), np.floor(np.maximum(fx, 0)).astype(int)
    wy, wx = np.where(fy < 0, 0.0, fy - iy0), np.where(fx < 0, 0.0, fx - ix0)
    iy1, ix1 = np.minimum(iy0 + 1, ch - 1), np.minimum(ix0 + 1, cw - 1)
    win = src[y0 : y0 + ch, x0 : x0 + cw].astype(np.float64)
    wy, wx = wy[:, None, None], wx[None, :, None]
    v = (win[iy0][:, ix0] * (1 - wy) * (1 - wx) + win[iy0][:, ix1] * (1 - wy) * wx
         + win[iy1][:, ix0] * wy * (1 - wx) + win[iy1][:, ix1] * wy * wx)
    return np.floor(v + 0.5).astype(np.uint8)


def _rrc(img, out_h, out_w, seed, epoch, index, hflip, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    h, w = img.shape[:2]
    rng = _Philox(seed, (epoch << 40) | index)
    lo, hi = (float(np.float32(v)) for v in scale)
    rlo, rhi = (math.log(float(np.float32(v))) for v in ratio)
    window = None
    for _ in range(10):
        target = h * w * (lo + rng.uniform() * (hi - lo))
        r = math.exp(rlo + rng.uniform() * (rhi - rlo))
        tw, th = math.floor(math.sqrt(target * r) + 0.5), math.floor(math.sqrt(target / r) + 0.5)
        if 0 < tw <= w and 0 < th <= h:
            y0 = rng.randint(h - th + 1)
            window = (rng.randint(w - tw + 1), y0, tw, th)
            break
    if window is None:
        side = min(h, w)
        window = ((w - side) // 2, (h - side) // 2, side, side)
    flip = hflip and rng.uniform() < 0.5
    return _bilinear(img, *window, out_h, out_w, mirror=flip)


def _images():
    rng = np.random.RandomState(11)
    shapes = [(40, 30), (23, 57), (64, 64), (7, 9), (300, 20), (1, 1)]
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]


@pytest.mark.parametrize("size", [(16, 16), (24, 20), (64, 64)])
def test_resize_u8_batch_matches_the_numpy_reference(card_build, size):
    images = _images()
    got = native.resize_u8_batch(images, *size)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        want = img if (h, w) == size else _bilinear(img, 0, 0, w, h, *size)
        assert np.array_equal(got[i], want), i


@pytest.mark.parametrize("seed, epoch, hflip", [(0, 0, True), (5, 3, False), (2**40 + 7, 1, True)])
def test_rrc_flip_u8_batch_matches_the_numpy_reference(card_build, seed, epoch, hflip):
    images = _images()
    indices = np.array([0, 9, 2**38 + 5, 17, 3, 1], np.int64)
    got = native.rrc_flip_u8_batch(images, 16, 20, indices, seed=seed, epoch=epoch, hflip=hflip)
    for i, img in enumerate(images):
        want = _rrc(img, 16, 20, seed, epoch, int(indices[i]), hflip)
        assert np.array_equal(got[i], want), i
