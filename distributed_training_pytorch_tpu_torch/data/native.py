"""ctypes bindings for the port's host data runtime (``csrc/dtp_native.cpp``).

Counterpart of ``distributed_training_pytorch_tpu/data/native.py``: one GIL-free C++ call
per batch (decode + resize + normalise, CIFAR-style crop/flip(/normalise), or plain
normalise), multithreaded inside, with Philox randomness keyed per record by
``(seed, epoch << 40 | index)``, so its output is bit-equal to the JAX package's library
on the same inputs.

The library is host C++, not a device kernel. It is built with ``g++`` at first use
(the flags of the JAX package's ``csrc/Makefile``) into
``build/torch_native/libdtp_native.so`` under the checkout root, which the repository's
``.gitignore`` covers, and rebuilt when the source is newer than it.

JPEG is decoded by the library's own decoder (:func:`jpeg_decode`; baseline, extended
sequential and progressive Huffman files, byte-equal to OpenCV's libjpeg-turbo), which
needs no library and is in every build. PNG is decoded by libpng where it is installed (a
probe compiles and links against it first); elsewhere the library is built with
``-DDTP_NO_CODECS`` and its decode entries refuse PNG payloads, which the port then decodes
with the standard library's ``zlib`` and :func:`png_unfilter`.

Five per-image entry points need no library and are in both builds: the PNG scanline
unfilter (:func:`png_unfilter`, over a stream the caller inflated with the standard
library's ``zlib``), and :func:`box_blur`, :func:`median_blur`, :func:`clahe` and
:func:`jpeg_roundtrip`, which reproduce the OpenCV and libjpeg-turbo arithmetic of the JAX
package's ``cv2`` transforms. They take and return uint8 HWC images, one image a call.
:func:`jpeg_encode` writes baseline JPEG files (the counterpart of ``cv2.imencode``, for
test data where there is no OpenCV).

Two batch entry points start from uint8 pixels the caller decoded, the codec-free route
of the uint8 decode entries for a PNG payload in a build without libpng:
:func:`resize_u8_batch` (the resize of :func:`decode_resize_u8_bytes`) and
:func:`rrc_flip_u8_batch` (the random-resized crop and flip of
:func:`decode_rrc_flip_u8_bytes`). A PNG payload gives the same bytes through either route
(``data/records.py`` takes the fused entries where the library has libpng, and these where
it has none).

A failed build is never silent: :func:`available` says whether the library loaded, and
:func:`build_error` returns the compiler's message when it did not. Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = [
    "ARGTYPES",
    "DecodeError",
    "NativeCropFlipNormalize",
    "NativeCropFlipU8",
    "augment_crop_flip",
    "augment_crop_flip_u8",
    "available",
    "box_blur",
    "build_error",
    "clahe",
    "codecs_available",
    "decode_resize_normalize",
    "decode_resize_normalize_bytes",
    "decode_resize_u8_bytes",
    "decode_rrc_flip_u8_bytes",
    "jpeg_decode",
    "jpeg_encode",
    "jpeg_header",
    "jpeg_roundtrip",
    "median_blur",
    "mixed_native_batch",
    "normalize",
    "png_unfilter",
    "resize_normalize",
    "resize_u8_batch",
    "rrc_flip_u8_batch",
]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "dtp_native.cpp"
LIBRARY = _PKG.parent / "build" / "torch_native" / "libdtp_native.so"
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
CODEC_LIBS = ["-lpng"]
_CODEC_PROBE = "#include <cstdio>\n#include <png.h>\nint main() { return 0; }\n"

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_error: "str | None" = None


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _codecs_installed(workdir: str) -> bool:
    """Whether a program including ``png.h`` compiles and links against libpng here."""
    probe = os.path.join(workdir, "probe.cpp")
    with open(probe, "w") as f:
        f.write(_CODEC_PROBE)
    out = subprocess.run(
        [_cxx(), probe, "-o", os.path.join(workdir, "probe"), *CODEC_LIBS],
        capture_output=True, text=True, timeout=120,
    )
    return out.returncode == 0


def _build() -> None:
    """Compile ``SOURCE`` into ``LIBRARY`` (atomically: a concurrent loader sees the old
    library or the new one, whole); raises ``RuntimeError`` with the compiler's output."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=LIBRARY.parent) as tmp:
        codecs = _codecs_installed(tmp)
        defines = [] if codecs else ["-DDTP_NO_CODECS"]
        libs = (CODEC_LIBS if codecs else []) + ["-lpthread"]
        tmp_lib = os.path.join(tmp, LIBRARY.name)
        cmd = [_cxx(), *CXXFLAGS, *defines, "-o", tmp_lib, str(SOURCE), *libs]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if out.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} exited {out.returncode}:\n{out.stdout}{out.stderr}")
        os.replace(tmp_lib, LIBRARY)


_i64, _i32, _u64, _f32 = ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_float
_fptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8ptr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64ptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_strs = ctypes.POINTER(ctypes.c_char_p)
_ptrs = ctypes.POINTER(ctypes.c_void_p)

# The ctypes argument types of every extern "C" function of ``SOURCE`` that returns
# int64_t, which ctypes converts by these alone (tests/test_torch_records.py parses the
# source and holds each entry against its signature).
ARGTYPES = {
    "dtp_decode_resize_normalize": [_strs, _i64, _i32, _i32, _fptr, _fptr, _fptr, _i32],
    "dtp_augment_crop_flip": [_u8ptr, _i64, _i32, _i32, _i32, _u64, _u64, _i64ptr, _fptr, _fptr, _i32, _fptr, _i32],
    "dtp_normalize": [_u8ptr, _i64, _i32, _i32, _fptr, _fptr, _fptr, _i32],
    "dtp_augment_crop_flip_u8": [_u8ptr, _i64, _i32, _i32, _i32, _u64, _u64, _i64ptr, _i32, _u8ptr, _i32],
    "dtp_decode_resize_normalize_bytes": [_strs, _i64ptr, _i64, _i32, _i32, _fptr, _fptr, _fptr, _i32],
    "dtp_decode_resize_u8_bytes": [_strs, _i64ptr, _i64, _i32, _i32, _u8ptr, _i32],
    "dtp_decode_rrc_flip_u8_bytes": [
        _strs, _i64ptr, _i64, _i32, _i32, _u64, _u64, _i64ptr, _i32, _f32, _f32, _f32, _f32, _u8ptr, _i32,
    ],
    "dtp_resize_u8_batch": [_ptrs, _i64ptr, _i64ptr, _i64, _i32, _i32, _u8ptr, _i32],
    "dtp_rrc_flip_u8_batch": [
        _ptrs, _i64ptr, _i64ptr, _i64, _i32, _i32, _u64, _u64, _i64ptr, _i32, _f32, _f32, _f32, _f32, _u8ptr, _i32,
    ],
    "dtp_resize_normalize_u8": [_u8ptr, _i32, _i32, _i32, _i32, _fptr, _fptr, _fptr],
    "dtp_png_unfilter": [_u8ptr, _i64, _i32, _i32, _i32, _i32, _u8ptr, _i32, _u8ptr],
    "dtp_box_blur_u8": [_u8ptr, _i32, _i32, _i32, _i32, _u8ptr],
    "dtp_median_blur_u8": [_u8ptr, _i32, _i32, _i32, _i32, _u8ptr],
    "dtp_clahe_u8": [_u8ptr, _i32, _i32, ctypes.c_double, _i32, _u8ptr],
    "dtp_jpeg_roundtrip_u8": [_u8ptr, _i32, _i32, _i32, _u8ptr],
    "dtp_jpeg_encode_u8": [_u8ptr, _i32, _i32, _i32, _i32, _i32, _i32, _u8ptr, _i64],
    "dtp_jpeg_header": [_u8ptr, _i64, _i64ptr],
    "dtp_jpeg_decode_u8": [_u8ptr, _i64, _i32, _i32, _u8ptr],
}


def _bind(lib: ctypes.CDLL) -> None:
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = _i64
    lib.dtp_has_codecs.argtypes = []
    lib.dtp_has_codecs.restype = _i32


def _load() -> "ctypes.CDLL | None":
    """The loaded library, built first when it is missing or older than its source; None
    when the build or the load failed (``build_error`` says why)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            built = not LIBRARY.exists() or SOURCE.stat().st_mtime > LIBRARY.stat().st_mtime
            if built:
                _build()
            try:
                lib = ctypes.CDLL(str(LIBRARY))
            except OSError:
                if built:
                    raise
                # a library built elsewhere (another machine's libjpeg): build it here
                _build()
                lib = ctypes.CDLL(str(LIBRARY))
            _bind(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it on the first call)."""
    return _load() is not None


def build_error() -> "str | None":
    """The compiler's (or loader's) message when the library could not be built or loaded;
    None when it loaded."""
    _load()
    return _error


def codecs_available() -> bool:
    """Whether the loaded library is linked against libpng, so that its decode entries
    take PNG payloads too (JPEG they take in every build)."""
    lib = _load()
    return lib is not None and bool(lib.dtp_has_codecs())


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


class DecodeError(ValueError):
    """A payload in a native decode batch failed; ``index`` is its position in the
    sequence passed to that call (None for a single file, which ``what`` names), and
    ``reason`` what was wrong with it, where that is known."""

    def __init__(self, index: "int | None", what: str = "record payload", reason: "str | None" = None):
        self.index = index
        self.reason = reason
        super().__init__(f"failed to decode {what}" + (f" #{index}" if index is not None else "")
                         + (f": {reason}" if reason else ""))


# dtp_jpeg_header / dtp_jpeg_decode_u8's refusals (csrc/dtp_native.cpp, enum JpegError).
JPEG_ERRORS = {
    1: "not a JPEG file (no start-of-image marker)",
    2: "a truncated JPEG file (the data ends before its end-of-image marker)",
    3: "a malformed JPEG marker segment",
    4: "an arithmetic-coded JPEG (not supported)",
    5: "a lossless JPEG (not supported)",
    6: "a hierarchical JPEG (not supported)",
    7: "a JPEG of other than 8-bit precision (not supported)",
    8: "a JPEG with a component count other than 1 or 3",
    9: "a JPEG whose height is set by a DNL marker (not supported)",
    10: "a JPEG of more than 2^30 pixels",
    11: "a JPEG with unsupported sampling factors",
    12: "a JPEG with a bad or missing Huffman table",
    13: "a JPEG with a bad or missing quantisation table",
    14: "a JPEG with corrupt entropy-coded data",
    15: "a JPEG whose restart markers are missing or out of order",
    16: "a JPEG with bad scan parameters",
    17: "an incomplete JPEG (a component or coefficients never fully coded; libjpeg would smooth the blocks)",
    18: "a JPEG without a frame or a scan",
    19: "a 4-component (CMYK/YCCK) JPEG (not supported)",
}


def _threads(n: "int | None") -> int:
    return n if n is not None else min(16, os.cpu_count() or 1)


def decode_resize_normalize(
    paths: Sequence[str], height: int, width: int, mean: np.ndarray, std: np.ndarray, *,
    threads: "int | None" = None,
) -> np.ndarray:
    """JPEG/PNG files -> [N, H, W, 3] float32, resized (OpenCV-compatible bilinear) and
    normalised, in one native call (PNG only where the library has libpng)."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.dtp_decode_resize_normalize(
        arr, n, height, width, _per_image(mean, 3, np.float32, "channel means"),
        _per_image(std, 3, np.float32, "channel stds"),
        out, _threads(threads),
    )
    if rc:
        with open(paths[rc - 1], "rb") as f:
            reason = _refusal(f.read())
        raise ValueError(f"failed to decode {paths[rc - 1]!r}" + (f": {reason}" if reason else ""))
    return out


def _refusal(payload: bytes) -> "str | None":
    """Why a decode entry refused ``payload``: the JPEG decoder's reason, or the missing
    libpng."""
    if payload[:2] == b"\xff\xd8":
        try:
            jpeg_decode(payload)
        except DecodeError as e:
            return e.reason
    elif payload[:8] == b"\x89PNG\r\n\x1a\n" and not codecs_available():
        return "a PNG payload, and the library was built without libpng"
    return None


def _raise_refused(payloads: Sequence[bytes], rc: int):
    raise DecodeError(rc - 1, reason=_refusal(payloads[rc - 1]))


def _payloads(payloads: Sequence[bytes]):
    n = len(payloads)
    # c_char_p elements point at each bytes object's buffer; lengths are passed apart.
    return n, np.asarray([len(p) for p in payloads], np.int64), (ctypes.c_char_p * n)(*payloads)


def decode_resize_normalize_bytes(
    payloads: Sequence[bytes], height: int, width: int, mean: np.ndarray, std: np.ndarray, *,
    threads: "int | None" = None,
) -> np.ndarray:
    """In-memory JPEG/PNG payloads -> [N, H, W, 3] float32, resized and normalised (PNG
    only where the library has libpng)."""
    lib = _require()
    n, lengths, bufs = _payloads(payloads)
    out = np.empty((n, height, width, 3), np.float32)
    rc = lib.dtp_decode_resize_normalize_bytes(
        bufs, lengths, n, height, width, _per_image(mean, 3, np.float32, "channel means"),
        _per_image(std, 3, np.float32, "channel stds"), out, _threads(threads),
    )
    if rc:
        _raise_refused(payloads, rc)
    return out


def decode_resize_u8_bytes(
    payloads: Sequence[bytes], height: int, width: int, *, threads: "int | None" = None
) -> np.ndarray:
    """In-memory JPEG/PNG payloads -> [N, H, W, 3] uint8 (decode + resize, no normalise;
    PNG only where the library has libpng)."""
    lib = _require()
    n, lengths, bufs = _payloads(payloads)
    out = np.empty((n, height, width, 3), np.uint8)
    rc = lib.dtp_decode_resize_u8_bytes(bufs, lengths, n, height, width, out, _threads(threads))
    if rc:
        _raise_refused(payloads, rc)
    return out


def decode_rrc_flip_u8_bytes(
    payloads: Sequence[bytes], height: int, width: int, indices: np.ndarray, *, seed: int, epoch: int,
    hflip: bool = True, scale: "tuple[float, float]" = (0.08, 1.0), ratio: "tuple[float, float]" = (3 / 4, 4 / 3),
    threads: "int | None" = None,
) -> np.ndarray:
    """In-memory JPEG/PNG payloads -> [N, H, W, 3] uint8 through decode, random-resized
    crop and an optional flip in one call, Philox-keyed per ``(seed, epoch, indices[i])``
    (10 attempts, then the centre square, as ``transforms.random_resized_crop``; PNG only
    where the library has libpng)."""
    lib = _require()
    n, lengths, bufs = _payloads(payloads)
    out = np.empty((n, height, width, 3), np.uint8)
    rc = lib.dtp_decode_rrc_flip_u8_bytes(
        bufs, lengths, n, height, width, seed, epoch, _per_image(indices, n, np.int64, "indices"), int(hflip),
        float(scale[0]), float(scale[1]), float(ratio[0]), float(ratio[1]), out, _threads(threads),
    )
    if rc:
        _raise_refused(payloads, rc)
    return out


def _pixels(images: Sequence[np.ndarray]):
    """Pointers to, and the heights and widths of, decoded uint8 HWC RGB images (each
    made contiguous; the returned list keeps those arrays alive for the call)."""
    kept = [_hwc_u8(img, 3) for img in images]
    ptrs = (ctypes.c_void_p * len(kept))(*[img.ctypes.data for img in kept])
    heights = np.asarray([img.shape[0] for img in kept], np.int64)
    widths = np.asarray([img.shape[1] for img in kept], np.int64)
    return kept, ptrs, heights, widths


def resize_u8_batch(images: Sequence[np.ndarray], height: int, width: int, *, threads: "int | None" = None) -> np.ndarray:
    """Decoded uint8 RGB images of any sizes -> [N, H, W, 3] uint8, with the resize of
    :func:`decode_resize_u8_bytes`: the codec-free route of that entry, for images the
    caller decoded (a PNG payload through ``zlib`` and :func:`png_unfilter`)."""
    lib = _require()
    kept, ptrs, heights, widths = _pixels(images)
    out = np.empty((len(kept), height, width, 3), np.uint8)
    rc = lib.dtp_resize_u8_batch(ptrs, heights, widths, len(kept), height, width, out, _threads(threads))
    if rc:
        raise DecodeError(rc - 1, "image", "no pixels")
    return out


def rrc_flip_u8_batch(
    images: Sequence[np.ndarray], height: int, width: int, indices: np.ndarray, *, seed: int, epoch: int,
    hflip: bool = True, scale: "tuple[float, float]" = (0.08, 1.0), ratio: "tuple[float, float]" = (3 / 4, 4 / 3),
    threads: "int | None" = None,
) -> np.ndarray:
    """Decoded uint8 RGB images -> [N, H, W, 3] uint8 through the random-resized crop and
    flip of :func:`decode_rrc_flip_u8_bytes` (the same Philox draws per
    ``(seed, epoch, indices[i])``, the same 10 attempts and centre square, the same
    bilinear sampling): its codec-free route."""
    lib = _require()
    kept, ptrs, heights, widths = _pixels(images)
    n = len(kept)
    out = np.empty((n, height, width, 3), np.uint8)
    rc = lib.dtp_rrc_flip_u8_batch(
        ptrs, heights, widths, n, height, width, seed, epoch, _per_image(indices, n, np.int64, "indices"),
        int(hflip), float(scale[0]), float(scale[1]), float(ratio[0]), float(ratio[1]), out, _threads(threads),
    )
    if rc:
        raise DecodeError(rc - 1, "image", "no pixels")
    return out


def resize_normalize(
    image: np.ndarray, height: int, width: int, mean: np.ndarray, std: np.ndarray
) -> np.ndarray:
    """One decoded uint8 RGB image -> [height, width, 3] float32, with the decode
    entries' resize and normalisation (a decoded PNG or BMP record of the folder sources
    comes out as the native PNG decode path's would)."""
    lib = _require()
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected a uint8 HWC image with 3 channels, got shape {image.shape}")
    out = np.empty((height, width, 3), np.float32)
    _check(lib.dtp_resize_normalize_u8(image, image.shape[0], image.shape[1], height, width,
                                       _per_image(mean, 3, np.float32, "channel means"),
                                       _per_image(std, 3, np.float32, "channel stds"), out),
           "resize_normalize", (image.shape, height, width))
    return out


def mixed_native_batch(n, height, width, native_positions, native_fn, py_fn, *, dtype=np.float32) -> np.ndarray:
    """Assemble a decoded batch where the rows at ``native_positions`` take one batch call
    (``native_fn(positions)`` returns their stacked images) and each other row its own
    (``py_fn(position)``). Positions, not record indices: a padded batch repeats rows. A
    ``DecodeError`` of the batch call names the batch position."""
    images = np.empty((n, height, width, 3), dtype)
    if native_positions:
        try:
            images[native_positions] = native_fn(native_positions)
        except DecodeError as e:
            raise DecodeError(native_positions[e.index], "batch record") from None
    for p in sorted(set(range(n)) - set(native_positions)):
        images[p] = py_fn(p)
    return images


def _nhwc_u8(images: np.ndarray) -> np.ndarray:
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected uint8 NHWC images with 3 channels, got shape {images.shape}")
    return images


def _per_image(values, n: int, dtype, name: str) -> np.ndarray:
    """``values`` as a contiguous array of exactly ``n`` entries: the C code reads ``n``
    (an index per image, or a value per channel) without knowing the length."""
    values = np.ascontiguousarray(values, dtype)
    if values.shape != (n,):
        raise ValueError(f"expected {n} {name}, got shape {values.shape}")
    return values


def augment_crop_flip(
    images: np.ndarray, indices: np.ndarray, *, pad: int, seed: int, epoch: int, mean: np.ndarray,
    std: np.ndarray, hflip: bool = True, threads: "int | None" = None,
) -> np.ndarray:
    """Reflect-pad, random crop, horizontal flip and normalise over a uint8 NHWC batch;
    randomness keyed per record by ``(seed, epoch, indices[i])``."""
    lib = _require()
    images = _nhwc_u8(images)
    n, h, w, _ = images.shape
    out = np.empty((n, h, w, 3), np.float32)
    lib.dtp_augment_crop_flip(
        images, n, h, w, pad, seed, epoch, _per_image(indices, n, np.int64, "indices"),
        _per_image(mean, 3, np.float32, "channel means"), _per_image(std, 3, np.float32, "channel stds"),
        int(hflip), out, _threads(threads),
    )
    return out


def augment_crop_flip_u8(
    images: np.ndarray, indices: np.ndarray, *, pad: int, seed: int, epoch: int, hflip: bool = True,
    threads: "int | None" = None,
) -> np.ndarray:
    """Crop and flip only, uint8 -> uint8, on the same Philox stream as
    :func:`augment_crop_flip`: for normalising on the device, so the host-to-device copy
    carries 1 byte a pixel channel instead of 4."""
    lib = _require()
    images = _nhwc_u8(images)
    n, h, w, _ = images.shape
    out = np.empty((n, h, w, 3), np.uint8)
    lib.dtp_augment_crop_flip_u8(
        images, n, h, w, pad, seed, epoch, _per_image(indices, n, np.int64, "indices"), int(hflip), out,
        _threads(threads),
    )
    return out


def normalize(images: np.ndarray, mean: np.ndarray, std: np.ndarray, *, threads: "int | None" = None) -> np.ndarray:
    """uint8 NHWC -> normalised float32, one native call."""
    lib = _require()
    images = _nhwc_u8(images)
    n, h, w, _ = images.shape
    out = np.empty((n, h, w, 3), np.float32)
    lib.dtp_normalize(
        images, n, h, w, _per_image(mean, 3, np.float32, "channel means"),
        _per_image(std, 3, np.float32, "channel stds"), out, _threads(threads),
    )
    return out


class NativeCropFlipU8:
    """Batch transform (the loader's ``batch_apply`` protocol) that keeps images uint8:
    crop and flip only, normalised on the device by ``models.InputNormalizer``.
    ``train=False`` passes the images through."""

    def __init__(self, *, pad: int = 4, seed: int = 0, train: bool = True):
        self.pad = pad
        self.seed = seed
        self.train = train

    def batch_apply(self, images: np.ndarray, indices: np.ndarray, epoch: int) -> np.ndarray:
        if not self.train:
            return np.ascontiguousarray(images, np.uint8)
        return augment_crop_flip_u8(images, np.asarray(indices, np.int64), pad=self.pad, seed=self.seed, epoch=epoch)

    def __call__(self, img: np.ndarray, *, epoch: int = 0, index: int = 0) -> np.ndarray:
        """One record (the loader's per-record path)."""
        return self.batch_apply(img[None], np.array([index]), epoch)[0]


class NativeCropFlipNormalize:
    """Batch transform: reflect-pad-``pad`` random crop, horizontal flip and normalise
    over uint8 NHWC batches, one native call a batch; ``train=False`` normalises only.
    Keyed by ``(seed, epoch, index)`` like the Python pipeline, but it draws from Philox
    differently, so the two paths are each deterministic and not equal to each other."""

    def __init__(self, mean, std, *, pad: int = 4, seed: int = 0, train: bool = True):
        self.mean = np.ascontiguousarray(mean, np.float32)
        self.std = np.ascontiguousarray(std, np.float32)
        self.pad = pad
        self.seed = seed
        self.train = train

    def batch_apply(self, images: np.ndarray, indices: np.ndarray, epoch: int) -> np.ndarray:
        if not self.train:
            return normalize(images, self.mean, self.std)
        return augment_crop_flip(
            images, np.asarray(indices, np.int64), pad=self.pad, seed=self.seed, epoch=epoch, mean=self.mean,
            std=self.std,
        )

    def __call__(self, img: np.ndarray, *, epoch: int = 0, index: int = 0) -> np.ndarray:
        return self.batch_apply(img[None], np.array([index]), epoch)[0]


def _hwc_u8(image: np.ndarray, channels: "int | None" = None) -> np.ndarray:
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or (channels is not None and image.shape[-1] != channels):
        want = f"{channels} channels" if channels is not None else "channels last"
        raise ValueError(f"expected a uint8 HWC image with {want}, got shape {image.shape}")
    return image


def _check(rc: int, name: str, args) -> None:
    if rc:
        raise ValueError(f"{name}{args} refused its arguments (code {rc})")


def png_unfilter(
    stream: bytes, height: int, width: int, bit_depth: int, color_type: int, palette: "bytes | None" = None
) -> np.ndarray:
    """A non-interlaced PNG's inflated IDAT stream -> [H, W, 3] uint8 RGB, as
    ``cv2.imread(path, IMREAD_COLOR)[..., ::-1]`` gives it: filters 0-4 reversed, gray
    replicated, the palette expanded, alpha dropped, 16-bit samples' high byte kept.
    Raises ``ValueError`` for an unsupported type or depth, a short stream or a bad
    filter byte."""
    lib = _require()
    raw = np.frombuffer(stream, np.uint8)
    pal = np.frombuffer(palette or bytes(3), np.uint8)
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.dtp_png_unfilter(np.ascontiguousarray(raw), raw.size, height, width, bit_depth, color_type,
                              np.ascontiguousarray(pal), pal.size // 3, out)
    if rc:
        reason = {1: f"bit depth {bit_depth} with color type {color_type}", 2: "a truncated image stream",
                  3: "an unknown scanline filter"}[rc]
        raise ValueError(f"PNG with {reason}")
    return out


def box_blur(image: np.ndarray, k: int) -> np.ndarray:
    """``cv2.blur(image, (k, k))``: the k x k mean (odd k), BORDER_REFLECT_101, rounded."""
    image = _hwc_u8(image)
    out = np.empty_like(image)
    _check(_require().dtp_box_blur_u8(image, *image.shape, int(k), out), "box_blur", (image.shape, k))
    return out


def median_blur(image: np.ndarray, k: int) -> np.ndarray:
    """``cv2.medianBlur(image, k)`` for k in {3, 5}: each channel's k x k median,
    BORDER_REPLICATE."""
    image = _hwc_u8(image)
    out = np.empty_like(image)
    _check(_require().dtp_median_blur_u8(image, *image.shape, int(k), out), "median_blur", (image.shape, k))
    return out


def clahe(image: np.ndarray, clip_limit: float = 4.0, tile: int = 8) -> np.ndarray:
    """CLAHE on the L channel of an RGB image, as ``cv2.cvtColor(RGB2LAB)``,
    ``cv2.createCLAHE(clip_limit, (tile, tile)).apply`` on L and ``cvtColor(LAB2RGB)``."""
    image = _hwc_u8(image, 3)
    out = np.empty_like(image)
    h, w, _ = image.shape
    _check(_require().dtp_clahe_u8(image, h, w, float(clip_limit), int(tile), out), "clahe", (image.shape, tile))
    return out


def jpeg_roundtrip(image: np.ndarray, quality: int) -> np.ndarray:
    """An RGB image through a baseline 4:2:0 JPEG at ``quality`` and back, as
    ``cv2.imdecode(cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, quality]))`` with
    libjpeg-turbo gives it (no entropy coding: it is lossless)."""
    image = _hwc_u8(image, 3)
    out = np.empty_like(image)
    h, w, _ = image.shape
    _check(_require().dtp_jpeg_roundtrip_u8(image, h, w, int(quality), out), "jpeg_roundtrip", (image.shape, quality))
    return out


def _payload_u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)


def jpeg_header(data: bytes, what: str = "JPEG data") -> "tuple[int, int]":
    """``(height, width)`` from a JPEG's frame header; ``DecodeError`` naming ``what``."""
    hw = np.zeros(2, np.int64)
    rc = _require().dtp_jpeg_header(_payload_u8(data), len(data), hw)
    if rc:
        raise DecodeError(None, what, JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    return int(hw[0]), int(hw[1])


def jpeg_decode(data: bytes, what: str = "JPEG data") -> np.ndarray:
    """A JPEG file's bytes -> [H, W, 3] uint8 RGB, byte-equal to ``cv2.imdecode(...,
    IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)[..., ::-1]`` with OpenCV's libjpeg-turbo (no
    EXIF orientation: ``data/jpeg.py`` applies it where the port follows ``cv2``). Refuses
    arithmetic-coded, lossless, hierarchical, 12-bit, CMYK/YCCK, truncated, corrupt and
    incomplete progressive files with a ``DecodeError`` naming ``what`` and the reason."""
    h, w = jpeg_header(data, what)
    out = np.empty((h, w, 3), np.uint8)
    rc = _require().dtp_jpeg_decode_u8(_payload_u8(data), len(data), h, w, out)
    if rc:
        raise DecodeError(None, what, JPEG_ERRORS.get(rc, f"JPEG error {rc}"))
    return out


def jpeg_encode(image: np.ndarray, quality: int = 95, *, subsampling: str = "4:2:0", restart_interval: int = 0) -> bytes:
    """A baseline JPEG file of ``image`` (uint8 RGB HWC, or grey HW / HW1) at ``quality``,
    as ``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, quality])`` writes it with
    libjpeg-turbo's defaults: JFIF, the standard quantisation tables scaled to the quality,
    the standard Huffman tables, islow DCT. ``subsampling`` is ``"4:2:0"`` or ``"4:4:4"``
    (colour only); ``restart_interval`` counts MCUs (0: no restart markers)."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[-1] != 3):
        raise ValueError(f"expected a uint8 HW or HWC image with 3 channels, got shape {image.shape}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling must be 4:2:0 or 4:4:4, got {subsampling!r}")
    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else 3
    # The largest a baseline block can take (every coefficient coded at full length, each
    # byte stuffed) is under 400 bytes: an upper bound for the entropy-coded data.
    blocks = ((h + 15) // 8) * ((w + 15) // 8) * (1 if channels == 1 else 3)
    out = np.empty(2048 + 400 * blocks, np.uint8)
    n = _require().dtp_jpeg_encode_u8(image, h, w, channels, int(quality), int(subsampling.replace(":", "")),
                                      int(restart_interval), out, out.size)
    if n < 0:
        raise ValueError(f"jpeg_encode{(image.shape, quality, subsampling, restart_interval)} refused its arguments")
    return out[:n].tobytes()
