"""TensorBoard scalars without a TensorBoard package: ``Trainer(tensorboard_dir=...)``.

Counterpart of ``distributed_training_pytorch_tpu/utils/tensorboard.py::MetricsWriter``,
with the same contract: ``write(step, {"loss": ...}, prefix="train")`` writes one scalar
per finite scalar entry (tag ``prefix/key``), rank 0 writes and the other ranks hold a
no-op writer, and a failed write warns once and disables the writer for good.

The JAX writer goes through ``tensorboardX`` and writes nothing without it. The card's
machine has neither ``tensorboardX`` nor ``tensorboard``, so this writer writes the event
files itself: ``events.out.tfevents.<time>.<host>`` in ``log_dir``, a sequence of
TFRecords (the data's length as a little-endian u64, its masked CRC-32C, the data, the
data's masked CRC-32C), each holding one ``Event`` protobuf: first ``{wall_time,
file_version: "brain.Event:2"}``, then one ``{wall_time, step, summary {value {tag,
simple_value}}}`` a scalar. TensorBoard's ``EventAccumulator`` reads them;
:func:`read_scalars` reads them back where TensorBoard is not installed, checking every
record's checksums.
"""

from __future__ import annotations

import math
import os
import socket
import struct
import time
from typing import Mapping

__all__ = ["MetricsWriter", "crc32c", "encode_scalar_event", "read_scalars"]


def _crc_table() -> "list[int]":
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1  # int64 fields: two's complement
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, *, step: "int | None" = None, file_version: "str | None" = None,
           summary: "bytes | None" = None) -> bytes:
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)  # wall_time: double
    if step is not None:
        out += _varint(2 << 3 | 0) + _varint(int(step))  # step: int64
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


def encode_scalar_event(wall_time: float, step: int, scalars: "Mapping[str, float]") -> bytes:
    """One ``Event`` holding a ``Summary`` with a ``simple_value`` per tag."""
    summary = b"".join(
        _len_field(1, _len_field(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack("<f", value))
        for tag, value in scalars.items()
    )
    return _event(wall_time, step=step, summary=summary)


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return header + struct.pack("<I", _masked_crc(header)) + data + struct.pack("<I", _masked_crc(data))


def _read_varint(buf: bytes, i: int) -> "tuple[int, int]":
    value = shift = 0
    while True:
        byte = buf[i]
        i += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, i


def _fields(buf: bytes):
    """``(field, wire_type, value)`` of one protobuf message (varint, 64-bit, length-delimited
    and 32-bit fields)."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not used by scalar events")
        yield field, wire, value


def read_scalars(path: str) -> "dict[str, list[tuple[int, float]]]":
    """``{tag: [(step, value), ...]}`` of one event file; raises ``ValueError`` on a record
    whose length or data checksum does not match."""
    with open(path, "rb") as f:
        raw = f.read()
    out: "dict[str, list[tuple[int, float]]]" = {}
    at = 0
    while at < len(raw):
        header = raw[at:at + 8]
        (n,) = struct.unpack("<Q", header)
        data = raw[at + 12:at + 12 + n]
        if (struct.unpack("<I", raw[at + 8:at + 12])[0] != _masked_crc(header)
                or struct.unpack("<I", raw[at + 12 + n:at + 16 + n])[0] != _masked_crc(data)):
            raise ValueError(f"{path}: record at byte {at} fails its checksum")
        at += 16 + n
        step = 0
        values = []
        for field, _, value in _fields(data):
            if field == 2:
                step = value
            elif field == 5:
                for vfield, _, v in _fields(value):
                    if vfield == 1:
                        tag = simple = None
                        for f2, _, x in _fields(v):
                            if f2 == 1:
                                tag = x.decode()
                            elif f2 == 2:
                                simple = struct.unpack("<f", x)[0]
                        values.append((tag, simple))
        for tag, simple in values:
            out.setdefault(tag, []).append((int(step), float(simple)))
    return out


class MetricsWriter:
    """Scalar writer: ``writer.write(step, {"loss": ...}, prefix="train")``; no-op without
    a ``log_dir`` and off rank 0."""

    def __init__(self, log_dir: "str | None"):
        self._log_dir = log_dir
        self._file = None
        self._dead = False
        self.reopen()

    def reopen(self) -> None:
        """(Re)open the event file, so a re-entered ``train()`` writes on; a writer a
        failure disabled stays disabled."""
        from distributed_training_pytorch_tpu_torch.parallel.mesh import process_index

        if self._file is not None or self._dead or not self._log_dir or process_index() != 0:
            return
        try:
            os.makedirs(self._log_dir, exist_ok=True)
            now = time.time()
            path = os.path.join(self._log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}.{os.getpid()}")
            self._file = open(path, "ab")
            self._file.write(_record(_event(now, file_version="brain.Event:2")))
            self._file.flush()
        except OSError as e:
            self._disable(e)

    @property
    def active(self) -> bool:
        return self._file is not None

    def write(self, step: int, metrics: Mapping, prefix: str = "") -> None:
        """One scalar per finite scalar entry of ``metrics`` (tensors, numpy and Python
        numbers); a non-scalar or non-finite entry is skipped, a failed write disables
        the writer with one warning."""
        if self._file is None:
            return
        scalars = {}
        for key, value in metrics.items():
            try:
                value = float(value.item() if hasattr(value, "item") and getattr(value, "size", 1) in (1, ()) else value)
            except (TypeError, ValueError, RuntimeError):
                continue
            if math.isfinite(value):
                scalars[f"{prefix}/{key}" if prefix else str(key)] = value
        if not scalars:
            return
        try:
            self._file.write(_record(encode_scalar_event(time.time(), int(step), scalars)))
            self._file.flush()
        except OSError as e:
            self._disable(e)

    def _disable(self, err: BaseException) -> None:
        import warnings

        self._dead = True
        f, self._file = self._file, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        warnings.warn(f"MetricsWriter disabled — TensorBoard write to {self._log_dir!r} failed: {err}")

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
