"""Dependency-free TensorBoard event-file writer (the port's own copy of
``cfm_tpu/tb_events.py``): scalar summaries written in TensorBoard's on-disk
format with no tensorflow or tensorboard import.

The file is a TFRecord stream of serialized ``tensorflow.Event`` protos:

    uint64  length (little-endian)
    uint32  masked crc32c of the length bytes
    bytes   data (the Event proto)
    uint32  masked crc32c of the data bytes

The record framing (CRC32C, Castagnoli polynomial, with TensorFlow's
rotate-and-offset masking) and the few Event/Summary fields used (wall_time,
step, file_version, Summary.Value{tag, simple_value}) are encoded by hand.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, reflected polynomial 0x82F63B78 — the
# checksum TFRecord framing uses (zlib.crc32 is CRC32/ISO-HDLC, NOT this one).
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C checksum of ``data`` (optionally continuing from ``crc``)."""
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TensorFlow's masked CRC: rotate right 15 bits, add a constant."""
    c = crc32c(data)
    return ((c >> 15) | ((c << 17) & 0xFFFFFFFF)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding (wire format only — no proto runtime).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    # Event.step is int64; negative steps don't occur, plain varint suffices.
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    """Serialized tensorflow.Event carrying one Summary.Value simple_value."""
    value_msg = _len_delim(1, tag.encode("utf-8")) + _float32(2, float(value))
    summary = _len_delim(1, value_msg)  # Summary.value (field 1, repeated)
    return (
        _double(1, wall_time)  # Event.wall_time
        + _int64(2, int(step))  # Event.step
        + _len_delim(5, summary)  # Event.summary
    )


def encode_file_version_event(wall_time: float) -> bytes:
    """The header event every tfevents file starts with."""
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


def frame_record(data: bytes) -> bytes:
    """Wrap one serialized proto in TFRecord length+CRC framing."""
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


class TBEventWriter:
    """Append scalar summaries to an ``events.out.tfevents.*`` file.

    Drop-in for the scalar slice of ``SummaryWriter``: one writer per run
    directory, ``add_scalar(tag, value, step)``, buffered with explicit
    ``flush()``. The filename follows TensorBoard's discovery convention
    (``events.out.tfevents.<unixtime>.<hostname>``).
    """

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}{filename_suffix}"
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "ab")
        self._file.write(frame_record(encode_file_version_event(now)))
        self._file.flush()

    def add_scalar(
        self, tag: str, value: float, step: int, wall_time: Optional[float] = None
    ) -> None:
        wt = time.time() if wall_time is None else wall_time
        self._file.write(frame_record(encode_scalar_event(tag, value, step, wt)))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()
