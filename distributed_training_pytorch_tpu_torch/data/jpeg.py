"""The EXIF orientation of a JPEG file, applied as OpenCV applies it.

``cv2.imread(path, IMREAD_COLOR)`` and ``cv2.imdecode(..., IMREAD_COLOR)`` turn a decoded
JPEG by the orientation tag of its EXIF data (OpenCV's ``ExifReader`` and
``ApplyExifOrientation``), so the JAX package's cv2 routes do. The port decodes JPEG with
its own native decoder (``native.jpeg_decode``), which leaves the samples as they are
coded, and its cv2-counterpart routes (``dataset.decode_image``,
``records.decode_image_bytes``) then apply :func:`exif_orientation` through
:func:`apply_orientation`. The native batch routes apply none, as the JAX package's
libjpeg-based native routes apply none. :func:`with_orientation` writes such a tag into a
file, for test data.

What is read, as OpenCV 5 reads it: the first APP1 segment that starts with
``Exif\\0\\0`` among the markers before the first scan; the TIFF header after it (``II``
little-endian, any other pair big-endian, then 42); IFD0 at the header's offset; the first
entry of tag 0x0112, whose value is the 16-bit word at the entry's offset 8, whatever its
declared type. Every read is bounds-checked: a segment or IFD cut before the value, a bad
TIFF header or offset, or a value outside 1..8 leaves the image as it is. An IFD cut
after the orientation entry still gives its value.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["apply_orientation", "exif_orientation", "exif_segment", "with_orientation"]

ORIENTATION_TAG = 0x0112


def _app1_exif(data: bytes) -> "bytes | None":
    """The TIFF data of the first ``Exif`` APP1 segment before the first scan."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:  # markers without a body
            pos += 2
            continue
        if marker in (0xDA, 0xD9):  # the first scan, or the end
            return None
        length = int.from_bytes(data[pos + 2 : pos + 4], "big")
        if length < 2:
            return None
        body = data[pos + 4 : pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
        pos += 2 + length
    return None


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG file's bytes, or 1 where it has none that
    OpenCV would read (see the module's docstring)."""
    tiff = _app1_exif(data)
    if tiff is None or len(tiff) < 2:
        return 1
    order = "little" if tiff[:2] == b"II" else "big"

    def word(offset: int, size: int) -> int:
        if offset < 0 or offset + size > len(tiff):
            raise IndexError(offset)
        return int.from_bytes(tiff[offset : offset + size], order)

    try:
        if word(2, 2) != 42:
            return 1
        ifd = word(4, 4)
        for i in range(word(ifd, 2)):
            entry = ifd + 2 + 12 * i
            if word(entry, 2) == ORIENTATION_TAG:
                value = word(entry + 8, 2)
                return value if 1 <= value <= 8 else 1
    except IndexError:
        return 1
    return 1


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """``image`` (HWC) turned as OpenCV's ``ApplyExifOrientation`` turns it for
    ``orientation``: 2 flips left-right, 3 rotates 180 degrees, 4 flips top-bottom, 5
    transposes, 6 transposes then flips left-right (90 degrees clockwise), 7 transposes
    then rotates 180 degrees, 8 transposes then flips top-bottom (90 degrees
    counter-clockwise); 1 and anything else leave it as it is."""
    if orientation in (5, 6, 7, 8):
        image = image.transpose(1, 0, 2)
        orientation -= 4
    turned = {2: image[:, ::-1], 3: image[::-1, ::-1], 4: image[::-1]}.get(orientation, image)
    return np.ascontiguousarray(turned)


def exif_segment(orientation: int, order: bytes = b"II") -> bytes:
    """An APP1 segment of EXIF data (byte order ``II`` or ``MM``) whose IFD0 holds one
    orientation entry of type SHORT."""
    e = "<" if order == b"II" else ">"
    tiff = order + struct.pack(e + "HIH", 42, 8, 1) + struct.pack(e + "HHIHH", ORIENTATION_TAG, 3, 1, orientation, 0)
    body = b"Exif\x00\x00" + tiff + struct.pack(e + "I", 0)
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_orientation(data: bytes, orientation: int, order: bytes = b"II") -> bytes:
    """A JPEG file's bytes with :func:`exif_segment` spliced in after its start-of-image
    marker."""
    return data[:2] + exif_segment(orientation, order) + data[2:]
