"""A TensorBoard scalar event writer without the tensorboard package.

A copy of the JAX package's ``utils/tb_writer.py``, byte for byte in what
it writes: scalar summaries hand-encoded as protobuf ``Event`` records in
the TFRecord framing TensorBoard reads, in files named
``events.out.tfevents.{time}.{host}{suffix}``.

Wire format:
- TFRecord: uint64 length | masked crc32c(length) | bytes | masked crc32c(bytes)
- Event: 1 = wall_time (double), 2 = step (int64), 3 = file_version
  (string), 5 = summary (Summary)
- Summary: 1 = repeated Value; Value: 1 = tag (string), 2 = simple_value (float)
"""

from __future__ import annotations

import os
import struct
import time
from pathlib import Path
from typing import Dict, Optional


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    """crc32c (Castagnoli), TensorBoard's record checksum."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


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


def _key(field: int, wire: int) -> bytes:
    """A protobuf field key (wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32)."""
    return _varint((field << 3) | wire)


def _encode_value(tag: str, value: float) -> bytes:
    t = tag.encode("utf-8")
    return _key(1, 2) + _varint(len(t)) + t + _key(2, 5) + struct.pack("<f", float(value))


def _encode_event(step: int, scalars: Dict[str, float], wall_time: float) -> bytes:
    values = b"".join(_key(1, 2) + _varint(len(v)) + v
                      for v in (_encode_value(k, x) for k, x in scalars.items()))
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
            + _key(5, 2) + _varint(len(values)) + values)


def _frame(data: bytes) -> bytes:
    """One TFRecord."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header)) + data
            + struct.pack("<I", _masked_crc(data)))


class SummaryWriter:
    """Append-only scalar event writer, TensorBoard-compatible.

    >>> w = SummaryWriter("runs/exp1")
    >>> w.add_scalars({"val/auc": 0.8, "val/acc": 0.75}, step=1)
    >>> w.close()
    """

    def __init__(self, log_dir, filename_suffix: str = ""):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}{filename_suffix}"
        self.path = self.log_dir / name
        self._f = open(self.path, "ab")
        version = b"brain.Event:2"  # TensorBoard expects a leading file-version event
        self._f.write(_frame(_key(1, 1) + struct.pack("<d", time.time())
                             + _key(3, 2) + _varint(len(version)) + version))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self.add_scalars({tag: value}, step, wall_time)

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    wall_time: Optional[float] = None) -> None:
        self._f.write(_frame(_encode_event(int(step), scalars, wall_time or time.time())))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["SummaryWriter"]
