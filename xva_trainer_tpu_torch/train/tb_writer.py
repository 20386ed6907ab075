"""TensorBoard scalar event files, written with the standard library alone.

The port's copy of ``xva_trainer_tpu/train/tb_writer.py`` (the port imports
nothing of the JAX package): the same bytes for the same scalars and wall
times. The reference logs ``loss/*`` and ``meta/frames/s`` scalars through
torch's SummaryWriter (reference python/xvapitch/xva_train.py:765-771);
TensorBoard's on-disk format is simple enough to emit directly:

- an event file is a TFRecord stream: ``<len u64le><masked-crc32c(len) u32le>
  <payload><masked-crc32c(payload) u32le>``;
- each payload is a ``tensorflow.Event`` protobuf; scalars use
  ``summary.value {tag, simple_value}``. Both messages are tiny and fixed, so
  they are hand-encoded here (protobuf wire format, no dependency).

TensorBoard itself reads these files unmodified.
"""
from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# ---- crc32c (Castagnoli), table-driven ----

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf wire encoding ----

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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(v)


def scalar_event(tag: str, value: float, step: int,
                 wall_time: Optional[float] = None) -> bytes:
    """tensorflow.Event{wall_time, step, summary{value{tag, simple_value}}}"""
    value_msg = (_field_bytes(1, tag.encode("utf-8"))
                 + _field_float(2, float(value)))
    summary = _field_bytes(1, value_msg)
    return (_field_double(1, wall_time if wall_time is not None else time.time())
            + _field_varint(2, int(step))
            + _field_bytes(5, summary))


def version_event(wall_time: Optional[float] = None) -> bytes:
    """The leading Event{file_version: "brain.Event:2"} record."""
    return (_field_double(1, wall_time if wall_time is not None else time.time())
            + _field_bytes(3, b"brain.Event:2"))


def write_record(f, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", _masked_crc(header)))
    f.write(payload)
    f.write(struct.pack("<I", _masked_crc(payload)))


class ScalarWriter:
    """Minimal SummaryWriter-compatible scalar logger (add_scalar/flush/close).

    Thread-safe; buffers writes and flushes every ``flush_secs`` like the
    reference's SummaryWriter(flush_secs=30)."""

    def __init__(self, log_dir: str, flush_secs: float = 30.0):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.v2")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "wb")
        self._lock = threading.Lock()
        self._flush_secs = flush_secs
        self._last_flush = time.monotonic()
        write_record(self._f, version_event())
        self._f.flush()

    def add_scalar(self, tag: str, value, step: int) -> None:
        with self._lock:
            if self._f.closed:
                return
            write_record(self._f, scalar_event(tag, float(value), step))
            if time.monotonic() - self._last_flush >= self._flush_secs:
                self._f.flush()
                self._last_flush = time.monotonic()

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._last_flush = time.monotonic()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()
