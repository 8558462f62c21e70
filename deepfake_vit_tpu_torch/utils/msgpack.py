"""Pure-Python reader of flax msgpack checkpoint files.

Decodes the msgpack subset flax's ``serialization.msgpack_serialize``
writes: maps, arrays, str/bin, nil/bool, ints, floats, and the extension
types — 1 = ndarray ``[shape, dtype name, bytes]``, 2 = complex
``[real, imag]``, 3 = numpy scalar (an ndarray payload), each payload
itself a msgpack array; bfloat16 arrays widen to float32. Returns nested dicts with numpy leaves, as
``flax.serialization.msgpack_restore`` does, without needing the
``msgpack`` package.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple, Union

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2), 0xD6: lambda: self.ext(4),
            0xD7: lambda: self.ext(8), 0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str(self.unpack(">B")),
            0xDA: lambda: self.str(self.unpack(">H")),
            0xDB: lambda: self.str(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map(self.unpack(">H")),
            0xDF: lambda: self.map(self.unpack(">I")),
        }
        if b not in simple:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        return simple[b]()

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = loads_raw(bytes(self.take(n)))
        if code == _EXT_NDARRAY:
            return _ndarray(*payload)
        if code == _EXT_COMPLEX:
            return complex(*payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(*payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(shape, dtype: str, buf: bytes) -> np.ndarray:
    if dtype == "bfloat16":
        # numpy has no bfloat16: widen the raw bits to float32 exactly.
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def loads_raw(data: bytes) -> Any:
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _restore_chunks(tree: Any) -> Any:
    """flax splits arrays over 2**30 bytes into chunk maps; rejoin them."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            as_tuple = lambda d: tuple(d[str(i)] for i in range(len(d)))  # noqa: E731
            chunks = as_tuple(tree["chunks"])
            shape = as_tuple(tree["shape"])
            return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _restore_chunks(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: Union[bytes, str, Path]) -> Any:
    """Decode flax msgpack bytes (or a path to a file of them)."""
    if isinstance(data, (str, Path)):
        data = Path(data).read_bytes()
    return _restore_chunks(loads_raw(data))


def tree_shapes(tree: Any, prefix: Tuple[str, ...] = ()) -> dict:
    """Flatten a nested tree to {path: shape} (for tests and diagnostics)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_shapes(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tuple(np.shape(tree))}
