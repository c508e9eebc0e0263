"""Data sources: indexable record stores the loader shards across ranks.

The port's copies of ``distributed_training_pytorch_tpu/data/dataset.py``:
``ArrayDataSource`` (the in-memory source), ``ImageFolderDataSource`` (sorted files under
``<root>/<label>/``, classes by ``labels.index``) and ``NativeImageFolderSource`` (its
batch-decoding counterpart for evaluation).

Decoding is the port's own, because the card's machine has no OpenCV, no PIL and no
libjpeg/libpng (the JAX package decodes with ``cv2.imread``):

* PNG: the chunks are parsed here, the IDAT stream inflated with the standard library's
  ``zlib``, and the scanlines unfiltered and turned into RGB by the native library
  (``native.png_unfilter``), byte-equal to ``cv2.imread(path)[..., ::-1]``. Adam7-interlaced
  files raise a ``DecodeError`` naming the file;
* BMP: uncompressed 24- and 32-bit, and 8-bit and lower with a palette, read with numpy;
* JPEG: the native library's own decoder (``native.jpeg_decode``, in every build), then
  the EXIF orientation as ``cv2.imread`` applies it (``data/jpeg.py``); arithmetic-coded,
  lossless, 12-bit, CMYK, truncated and corrupt files raise a ``DecodeError`` naming the
  file and the reason;
* WebP: a ``DecodeError`` naming the file (the port has no WebP decoder).

A file is recognised by its first bytes, not its extension.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

from distributed_training_pytorch_tpu_torch.data import jpeg, native, transforms

__all__ = ["ArrayDataSource", "ImageFolderDataSource", "NativeImageFolderSource", "decode_bytes", "decode_image"]

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class ImageFolderDataSource:
    """Records = sorted files under ``<data_path>/<label>/`` per label; ``labels`` maps a
    directory name to its class index by position. The scan is deterministic; the loader
    shuffles, seeded alike on every rank."""

    def __init__(self, data_path: str, labels: Sequence[str], transform=None):
        self.data_path = data_path
        self.labels = list(labels)
        # Applied by the loader (not __getitem__), so augmentation keys on (epoch, index).
        self.transform = transform
        self.records: "list[tuple[str, int]]" = []
        for idx, label in enumerate(self.labels):
            label_dir = os.path.join(data_path, label)
            if not os.path.isdir(label_dir):
                raise FileNotFoundError(f"label directory missing: {label_dir}")
            for fname in sorted(os.listdir(label_dir)):
                if fname.lower().endswith(_IMAGE_EXTS):
                    self.records.append((os.path.join(label_dir, fname), idx))
        if not self.records:
            raise ValueError(f"no images found under {data_path} for labels {labels}")

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int) -> dict:
        path, label = self.records[index]
        return {"image": decode_image(path), "label": np.int32(label)}


def decode_image(path: str) -> np.ndarray:
    """A PNG, BMP or JPEG file -> RGB uint8 HWC, as ``cv2.imread(path)[..., ::-1]``."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_bytes(data, f"file {path!r}")


def decode_bytes(data: bytes, what: str) -> np.ndarray:
    """PNG, BMP or JPEG bytes -> RGB uint8 HWC, as ``cv2.imdecode(..., IMREAD_COLOR)[...,
    ::-1]`` (a JPEG turned by its EXIF orientation); a ``DecodeError`` names ``what`` (a
    file, a record) and says what was wrong."""
    try:
        if data.startswith(_PNG_SIGNATURE):
            return _decode_png(data, what)
        if data.startswith(b"BM"):
            return _decode_bmp(data, what)
    except native.DecodeError:
        raise
    except (struct.error, ValueError) as e:  # a header or pixel array cut short
        raise native.DecodeError(None, what, f"a truncated or malformed image ({e})") from None
    if data.startswith(b"\xff\xd8"):
        return _decode_jpeg(data, what)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise native.DecodeError(None, what, "the port has no WebP decoder")
    raise native.DecodeError(None, what, "not a PNG, BMP or JPEG file")


def _decode_png(data: bytes, what: str) -> np.ndarray:
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise native.DecodeError(None, what, "a PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise native.DecodeError(None, what, "Adam7-interlaced PNG is not supported")
    try:
        return native.png_unfilter(zlib.decompress(b"".join(idat)), height, width, depth, color, palette)
    except (zlib.error, ValueError) as e:
        raise native.DecodeError(None, what, str(e)) from None


def _decode_bmp(data: bytes, what: str) -> np.ndarray:
    offset = struct.unpack_from("<I", data, 10)[0]
    header_size, width, height, _, bits, compression = struct.unpack_from("<IiiHHI", data, 14)
    colors_used = struct.unpack_from("<I", data, 46)[0] if header_size >= 40 else 0
    if compression not in (0, 3) or bits not in (1, 4, 8, 24, 32) or (compression == 3 and bits != 32):
        raise native.DecodeError(None, what, f"a {bits}-bit BMP with compression {compression}")
    h, w = abs(height), width
    stride = (w * bits + 31) // 32 * 4
    rows = np.frombuffer(data, np.uint8, h * stride, offset).reshape(h, stride)
    if bits >= 24:
        bgr = rows[:, : w * bits // 8].reshape(h, w, bits // 8)[:, :, :3]
    else:
        n = colors_used or (1 << bits)
        table = np.frombuffer(data, np.uint8, n * 4, 14 + header_size).reshape(n, 4)[:, :3]
        index = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // bits, bits)[:, :w]
        index = index.dot(1 << np.arange(bits - 1, -1, -1))
        bgr = np.zeros((256, 3), np.uint8)
        bgr[:n] = table
        bgr = bgr[index]
    rgb = bgr[:, :, ::-1]
    return np.ascontiguousarray(rgb[::-1] if height > 0 else rgb)  # positive height: bottom-up


def _decode_jpeg(data: bytes, what: str) -> np.ndarray:
    return jpeg.apply_orientation(native.jpeg_decode(data, what), jpeg.exif_orientation(data))


class NativeImageFolderSource(ImageFolderDataSource):
    """Image-folder source whose batches decode, resize and normalise through the native
    library (the val/eval path; no augmentation): the JPEG records in one call a batch, as
    the JAX package's native path decodes them (with the library's own JPEG decoder, in
    every build, and no EXIF orientation, as the JAX native path's libjpeg applies none);
    the PNG and BMP records through this module's decoders, then the library's resize and
    normalisation (``native.resize_normalize``), so every record of a batch shares one
    resize and one normalisation (a PNG record comes out as the JAX native path's)."""

    _NATIVE_EXTS = (".jpg", ".jpeg")

    def __init__(self, data_path: str, labels: Sequence[str], height: int, width: int, mean=None, std=None):
        super().__init__(data_path, labels, transform=None)
        self.height, self.width = height, width
        self.mean = transforms.IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
        self.std = transforms.IMAGENET_STD if std is None else np.asarray(std, np.float32)
        if not native.available():
            raise RuntimeError(f"native library unavailable: {native.build_error()}")

    def _decode_one(self, index: int) -> np.ndarray:
        image = decode_image(self.records[index][0])
        return native.resize_normalize(image, self.height, self.width, self.mean, self.std)

    def load_batch(self, rows: np.ndarray, epoch: int) -> dict:
        labels = np.array([self.records[int(i)][1] for i in rows], np.int32)
        jpegs = [p for p, i in enumerate(rows) if self.records[int(i)][0].lower().endswith(self._NATIVE_EXTS)]
        images = native.mixed_native_batch(
            len(rows), self.height, self.width, jpegs,
            lambda pos: native.decode_resize_normalize(
                [self.records[int(rows[p])][0] for p in pos], self.height, self.width, self.mean, self.std
            ),
            lambda p: self._decode_one(int(rows[p])),
        )
        return {"image": images, "label": labels}


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
