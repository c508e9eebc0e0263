"""Sharded record files: the input path for corpora too large for a folder of files.

Counterpart of ``distributed_training_pytorch_tpu/data/records.py``, with the same shard
layout, byte for byte (little-endian)::

    magic  b"DTPR1\\0"            6 bytes
    count  u64                     number of records
    count * { label i64, length u64, payload bytes }   back to back
    index  count * u64             byte offset of each record
    index_offset u64               (last 8 bytes) where the index starts

Shards are named ``<prefix>-%05d-of-%05d.rec``. A reader reads each shard's footer index
once and then serves random access by offset with ``os.pread``, so loader worker threads
share one descriptor per shard.

Decoding is the port's own (``data/dataset.py::decode_bytes``: PNG through the standard
library's ``zlib`` and the native unfilter, BMP in numpy, JPEG through the native library's
own decoder, in every build), never OpenCV's. :func:`decode_image_bytes` turns a JPEG by
its EXIF orientation, as ``cv2.imdecode`` does; the batch sources apply none, as the JAX
package's native path applies none. The batch sources take one of two routes for a
payload:

* the library's fused batch entries, as the JAX package's native path (decode + resize,
  decode + resize + normalise, decode + random-resized-crop + flip), for every JPEG
  payload, and for the PNG payloads where the library has libpng;
* the PNG payloads where it has none (``-DDTP_NO_CODECS``, the card's machine), and the
  BMP payloads, are decoded here, on a pool of threads, and the library continues from the
  uint8 pixels (``native.resize_u8_batch``, ``native.resize_normalize``,
  ``native.rrc_flip_u8_batch``), with the same resize, the same Philox draws and the same
  sampling, so a PNG payload gives the same bytes through either route.

``skip_corrupt`` (set on a source by ``ShardedLoader(skip_corrupt=True)``): a record whose
header or payload is damaged is replaced by the next readable one (deterministically: the
same substitute every epoch) and counted in ``corrupt_skipped``. Without it the batch
raises ``CorruptRecordError``, a ``DecodeError`` that names the shard and the record. The
JAX package's native batch path substitutes a payload that fails inside its decoder and
raises for one without a JPEG or PNG signature; the port substitutes any payload it cannot
decode.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob
import os
import struct
import threading
from typing import Callable, Iterable, Sequence

import numpy as np

from distributed_training_pytorch_tpu_torch.data import dataset, native, transforms

__all__ = [
    "MAGIC",
    "CorruptRecordError",
    "NativeRecordFileSource",
    "NativeRecordTrainSource",
    "RecordFileSource",
    "RecordFileWriter",
    "decode_image_bytes",
    "pack_image_folder",
    "shard_paths",
    "tolerant_fetch",
    "write_shards",
]

MAGIC = b"DTPR1\x00"

# Past this many consecutive corrupt records the corpus, not a record, is broken.
TOLERANT_PROBE_LIMIT = 9

# Skip counters are bumped from loader worker threads.
_SKIP_COUNT_LOCK = threading.Lock()


class CorruptRecordError(native.DecodeError):
    """A record whose header or payload is damaged, or whose payload does not decode; the
    message names the shard and the record. A ``DecodeError`` (so a ``ValueError``), as
    the JAX package's is a ``ValueError``."""

    def __init__(self, message: str):
        ValueError.__init__(self, message)
        self.index = None
        self.reason = None


def tolerant_fetch(fetch, index: int, n: int, *, exceptions=None):
    """Deterministic skip-and-substitute: ``fetch((index + k) % n)`` for ``k = 0, 1, ...``
    until one succeeds; returns ``(value, k)``, ``k`` the corrupt records skipped. Raises
    ``CorruptRecordError`` after ``TOLERANT_PROBE_LIMIT`` failures in a row."""
    exceptions = exceptions or (CorruptRecordError,)
    limit = min(TOLERANT_PROBE_LIMIT, n)
    last_err: "Exception | None" = None
    for k in range(limit):
        try:
            return fetch((int(index) + k) % n), k
        except exceptions as e:
            last_err = e
    raise CorruptRecordError(f"{limit} consecutive corrupt records starting at {int(index)}") from last_err


class RecordFileWriter:
    """Single-pass writer of one shard; :func:`write_shards` writes the sharded layout."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<Q", 0))  # count, patched on close
        self._offsets: "list[int]" = []
        self._closed = False

    def append(self, payload: bytes, label: int) -> None:
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<qQ", int(label), len(payload)))
        self._f.write(payload)

    def close(self) -> None:
        if self._closed:
            return
        index_offset = self._f.tell()
        for off in self._offsets:
            self._f.write(struct.pack("<Q", off))
        self._f.write(struct.pack("<Q", index_offset))
        self._f.seek(len(MAGIC))
        self._f.write(struct.pack("<Q", len(self._offsets)))
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_shards(prefix: str, records: "Iterable[tuple[bytes, int]]", *, num_shards: int) -> "list[str]":
    """Round-robin ``(payload, label)`` records into ``num_shards`` shards named
    ``<prefix>-%05d-of-%05d.rec``; returns the paths."""
    paths = [f"{prefix}-{i:05d}-of-{num_shards:05d}.rec" for i in range(num_shards)]
    writers = [RecordFileWriter(p) for p in paths]
    try:
        for i, (payload, label) in enumerate(records):
            writers[i % num_shards].append(payload, label)
    finally:
        for w in writers:
            w.close()
    return paths


def decode_image_bytes(payload: bytes, what: str = "record payload") -> np.ndarray:
    """PNG, BMP or JPEG bytes -> RGB uint8 HWC, as the JAX package's ``cv2.imdecode``
    gives them (a JPEG turned by its EXIF orientation), with the port's decoders; ``what``
    names the payload in a ``DecodeError``."""
    return dataset.decode_bytes(payload, what)


_pool_lock = threading.Lock()
_pool: "cf.ThreadPoolExecutor | None" = None


def _decode_pool() -> cf.ThreadPoolExecutor:
    """The threads that decode a batch's payloads on the codec-free route (``zlib`` and
    the native unfilter release the interpreter lock)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1), thread_name_prefix="record-decode")
        return _pool


def _fused(payload: bytes, png: bool) -> bool:
    """Whether the library's fused entries decode ``payload``: a JPEG always, a PNG where
    the library has libpng (``png``)."""
    return payload[:2] == b"\xff\xd8" or (png and payload[:8] == b"\x89PNG\r\n\x1a\n")


def shard_paths(pattern: str) -> "list[str]":
    """The sorted shard files of a glob (``.../train-*.rec``) or a directory (every
    ``*.rec`` in it); ``FileNotFoundError`` when none match."""
    if os.path.isdir(pattern):
        pattern = os.path.join(pattern, "*.rec")
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no record shards match {pattern}")
    return paths


class RecordFileSource:
    """Random-access source over record shards: ``pattern`` is a glob
    (``.../train-*.rec``) or a directory (every ``*.rec`` in it); records are ordered
    shard by shard. ``decode`` maps a payload to the record's ``image`` (default
    :func:`decode_image_bytes`); ``transform`` is applied by the loader per record."""

    def __init__(
        self,
        pattern: str,
        *,
        decode: "Callable[[bytes], np.ndarray] | None" = None,
        transform=None,
        skip_corrupt: bool = False,
    ):
        self.paths = shard_paths(pattern)
        self.decode = decode
        self.transform = transform
        self.skip_corrupt = bool(skip_corrupt)
        self.corrupt_skipped = 0
        self._shard_offsets: "list[np.ndarray]" = []
        self._shard_base: "list[int]" = []
        self._shard_payload_end: "list[int]" = []  # index_offset: the payload region's end
        total = 0
        for path in self.paths:
            with open(path, "rb") as f:
                header = f.read(len(MAGIC) + 8)
                if header[: len(MAGIC)] != MAGIC:
                    raise ValueError(f"{path}: bad magic (not a DTPR1 record file)")
                (count,) = struct.unpack("<Q", header[len(MAGIC) :])
                f.seek(-8, os.SEEK_END)
                (index_offset,) = struct.unpack("<Q", f.read(8))
                f.seek(index_offset)
                offsets = np.frombuffer(f.read(8 * count), dtype="<u8")
            self._shard_offsets.append(offsets)
            self._shard_base.append(total)
            self._shard_payload_end.append(index_offset)
            total += count
        self._len = total
        self._fds: "dict[int, int]" = {}

    def __len__(self) -> int:
        return self._len

    def _locate(self, index: int) -> "tuple[int, int]":
        shard = int(np.searchsorted(self._shard_base, index, side="right")) - 1
        return shard, index - self._shard_base[shard]

    def _fd(self, shard: int) -> int:
        fd = self._fds.get(shard)
        if fd is None:
            fd = os.open(self.paths[shard], os.O_RDONLY)
            winner = self._fds.setdefault(shard, fd)
            if winner != fd:  # another thread opened it first
                os.close(fd)
                fd = winner
        return fd

    def describe(self, index: int) -> str:
        """Record ``index`` by shard path and position in it (a batch position means
        nothing after the epoch's shuffle)."""
        shard, local = self._locate(int(index))
        return f"record {int(index)} ({self.paths[shard]} #{local})"

    def read_record(self, index: int) -> "tuple[bytes, int]":
        """``(payload, label)`` of record ``index``; ``CorruptRecordError`` when its header
        or payload lies outside the shard's payload region or is cut short."""
        shard, local = self._locate(index)
        fd = self._fd(shard)
        offset = int(self._shard_offsets[shard][local])
        payload_end = self._shard_payload_end[shard]
        if offset + 16 > payload_end:
            raise CorruptRecordError(
                f"{self.describe(index)}: header at {offset} beyond the payload region ({payload_end}): a corrupt "
                "index or a truncated shard"
            )
        try:
            label, length = struct.unpack("<qQ", os.pread(fd, 16, offset))
        except struct.error as e:  # a short read: the shard was truncated
            raise CorruptRecordError(f"{self.describe(index)}: truncated header") from e
        if offset + 16 + length > payload_end:
            raise CorruptRecordError(
                f"{self.describe(index)}: payload of {length} bytes at {offset} overruns the payload region "
                f"({payload_end}): a truncated shard"
            )
        payload = os.pread(fd, length, offset + 16)
        if len(payload) != length:
            raise CorruptRecordError(f"{self.describe(index)}: short read ({len(payload)}/{length} bytes)")
        return payload, int(label)

    def read_record_tolerant(self, index: int) -> "tuple[bytes, int]":
        """``read_record`` under ``skip_corrupt``: a corrupt record is replaced by the next
        readable one and counted."""
        if not self.skip_corrupt:
            return self.read_record(index)
        rec, skipped = tolerant_fetch(self.read_record, index, len(self))
        if skipped:
            with _SKIP_COUNT_LOCK:
                self.corrupt_skipped += skipped
        return rec

    def _decode(self, payload: bytes, index: int) -> np.ndarray:
        if self.decode is not None:
            return self.decode(payload)
        return decode_image_bytes(payload, self.describe(index))

    def __getitem__(self, index: int) -> dict:
        payload, label = self.read_record_tolerant(int(index))
        try:
            image = self._decode(payload, int(index))
        except CorruptRecordError:
            raise
        except native.DecodeError as e:  # it names the record already
            raise CorruptRecordError(str(e)) from e
        except ValueError as e:
            raise CorruptRecordError(f"failed to decode {self.describe(int(index))}: {e}") from e
        return {"image": image, "label": np.int32(label)}

    # -- whole-batch production (the native sources) ------------------------

    def _decoded_rows(self, payloads, positions) -> "list[np.ndarray]":
        """The payloads at ``positions`` decoded here (on the decode pool); a failure is a
        ``DecodeError`` of its batch position."""

        def one(p):
            try:
                return decode_image_bytes(payloads[p])
            except native.DecodeError as e:
                raise native.DecodeError(p, "batch record", e.reason) from None

        if len(positions) == 1:
            return [one(positions[0])]
        return list(_decode_pool().map(one, positions))

    def _two_routes(self, payloads, height, width, fused, from_pixels, dtype) -> np.ndarray:
        """A decoded batch: the rows the library decodes itself through ``fused(positions)``
        (their stacked images), the others decoded here and finished by
        ``from_pixels(positions, images)``."""
        n = len(payloads)
        png = native.codecs_available()
        fused_pos = [p for p in range(n) if _fused(payloads[p], png)]
        rest = sorted(set(range(n)) - set(fused_pos))
        out = np.empty((n, height, width, 3), dtype)
        if fused_pos:
            try:
                out[fused_pos] = fused(fused_pos)
            except native.DecodeError as e:
                raise native.DecodeError(fused_pos[e.index], "batch record", e.reason) from None
        if rest:
            out[rest] = from_pixels(rest, self._decoded_rows(payloads, rest))
        return out

    def _produce_batch_tolerant(self, rows, payloads: list, labels: list, produce):
        """``produce(payloads) -> images`` with whole-batch decode tolerance: under
        ``skip_corrupt`` a position whose payload does not decode is given the next
        readable neighbour's ``(payload, label)`` and the batch is produced again, as the
        per-record path degrades; without it, a ``CorruptRecordError`` names the record."""
        n = len(self)
        shifts: "dict[int, int]" = {}
        for _ in range(TOLERANT_PROBE_LIMIT + 1):
            try:
                return produce(payloads)
            except native.DecodeError as e:
                if not self.skip_corrupt:
                    self._raise_located(e, rows)
                p = e.index
                s = shifts.get(p, 0)
                while True:
                    s += 1
                    if s > TOLERANT_PROBE_LIMIT:
                        self._raise_located(e, rows)
                    try:
                        payloads[p], labels[p] = self.read_record((int(rows[p]) + s) % n)
                        break
                    except CorruptRecordError:
                        continue
                shifts[p] = s
                with _SKIP_COUNT_LOCK:
                    self.corrupt_skipped += 1
        self._raise_located(e, rows)

    def _raise_located(self, e, rows):
        """Re-raise a batch-position ``DecodeError`` naming the record."""
        raise CorruptRecordError(
            f"failed to decode {self.describe(int(rows[e.index]))}" + (f": {e.reason}" if e.reason else "")
        ) from None

    def _read_batch(self, rows) -> "tuple[list, list]":
        payloads, labels = map(list, zip(*(self.read_record_tolerant(int(i)) for i in rows), strict=True))
        return payloads, labels

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_fds"] = {}  # descriptors are not picklable; a copy reopens lazily
        return state

    def __del__(self, _close=os.close):
        for fd in self.__dict__.get("_fds", {}).values():
            try:
                _close(fd)
            except Exception:
                pass


def _require_native() -> None:
    if not native.available():
        raise RuntimeError(f"native library unavailable: {native.build_error()}")


class NativeRecordFileSource(RecordFileSource):
    """Record source whose batches decode, resize and normalise through the native library
    (the val/eval path; no augmentation): float32 ``[N, H, W, 3]``, normalised by
    ``mean``/``std`` (ImageNet's by default)."""

    def __init__(self, pattern: str, height: int, width: int, mean=None, std=None):
        super().__init__(pattern, transform=None)
        _require_native()
        self.height, self.width = height, width
        self.mean = transforms.IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
        self.std = transforms.IMAGENET_STD if std is None else np.asarray(std, np.float32)

    def _normalised(self, payloads) -> np.ndarray:
        h, w = self.height, self.width
        return self._two_routes(
            payloads, h, w,
            lambda pos: native.decode_resize_normalize_bytes([payloads[p] for p in pos], h, w, self.mean, self.std),
            lambda pos, images: np.stack([native.resize_normalize(img, h, w, self.mean, self.std) for img in images]),
            np.float32,
        )

    def load_batch(self, rows: np.ndarray, epoch: int) -> dict:
        payloads, labels = self._read_batch(rows)
        images = self._produce_batch_tolerant(rows, payloads, labels, self._normalised)
        return {"image": images, "label": np.asarray(labels, np.int32)}


class NativeRecordTrainSource(RecordFileSource):
    """The train-path record source: payload -> decode -> resize (uint8) -> crop/flip
    (uint8), shipped as uint8 for ``models.InputNormalizer`` to normalise on the device.
    Every draw is Philox-keyed per ``(seed, epoch, record index)``, so a batch is the same
    on every host and across resumes.

    ``aug="pad_crop"``: CIFAR-style reflect-pad random crop (+ flip) of the resized image
    (``native.augment_crop_flip_u8``). ``aug="rrc"``: ImageNet-style random-resized crop
    (+ flip), 10 attempts and then the centre square, straight from the decoded image.
    ``hflip=False`` for corpora whose orientation matters (digits); ``train=False`` skips
    the augmentation (the resize alone)."""

    def __init__(
        self,
        pattern: str,
        height: int,
        width: int,
        *,
        aug: str = "pad_crop",
        pad: int = 4,
        seed: int = 0,
        hflip: bool = True,
        train: bool = True,
    ):
        if aug not in ("pad_crop", "rrc"):
            raise ValueError(f"aug must be pad_crop|rrc, got {aug!r}")
        super().__init__(pattern, transform=None)
        _require_native()
        self.height, self.width = height, width
        self.aug = aug
        self.pad = pad
        self.seed = seed
        self.hflip = hflip
        self.train = train

    def _decode_u8(self, payloads) -> np.ndarray:
        h, w = self.height, self.width
        return self._two_routes(
            payloads, h, w,
            lambda pos: native.decode_resize_u8_bytes([payloads[p] for p in pos], h, w),
            lambda pos, images: native.resize_u8_batch(images, h, w),
            np.uint8,
        )

    def _rrc(self, payloads, rows, epoch: int) -> np.ndarray:
        h, w = self.height, self.width
        idx = np.asarray(rows, np.int64)
        keys = dict(seed=self.seed, epoch=epoch, hflip=self.hflip)
        return self._two_routes(
            payloads, h, w,
            lambda pos: native.decode_rrc_flip_u8_bytes([payloads[p] for p in pos], h, w, idx[pos], **keys),
            lambda pos, images: native.rrc_flip_u8_batch(images, h, w, idx[pos], **keys),
            np.uint8,
        )

    def load_batch(self, rows: np.ndarray, epoch: int) -> dict:
        payloads, labels = self._read_batch(rows)
        if self.train and self.aug == "rrc":
            images = self._produce_batch_tolerant(rows, payloads, labels, lambda pls: self._rrc(pls, rows, epoch))
            return {"image": images, "label": np.asarray(labels, np.int32)}
        images = self._produce_batch_tolerant(rows, payloads, labels, self._decode_u8)
        if self.train:
            images = native.augment_crop_flip_u8(
                images, np.asarray(rows, np.int64), pad=self.pad, seed=self.seed, epoch=epoch, hflip=self.hflip
            )
        return {"image": images, "label": np.asarray(labels, np.int32)}


def pack_image_folder(data_path: str, labels: Sequence[str], out_prefix: str, *, num_shards: int = 64) -> "list[str]":
    """Pack a ``<root>/<label>/`` tree into record shards, the files' bytes as payloads
    (the one-time conversion a corpus of that size needs before training)."""
    folder = dataset.ImageFolderDataSource(data_path, labels)

    def records():
        for path, label in folder.records:
            with open(path, "rb") as f:
                yield f.read(), label

    return write_shards(out_prefix, records(), num_shards=num_shards)
