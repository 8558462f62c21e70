"""Pure-Python reader and writer of flax msgpack checkpoint files.

The reader decodes the msgpack subset flax's ``serialization.msgpack_serialize``
writes: maps, arrays, str/bin, nil/bool, ints, floats, and the extension
types — 1 = ndarray ``[shape, dtype name, bytes]``, 2 = complex
``[real, imag]``, 3 = numpy scalar (an ndarray payload), each payload
itself a msgpack array; bfloat16 arrays widen to float32. Returns nested dicts with numpy leaves, as
``flax.serialization.msgpack_restore`` does, without needing the
``msgpack`` package. The writer (``msgpack_serialize``) encodes the same
subset as ``flax.serialization.msgpack_serialize`` does, byte for byte:
string-keyed maps (keys sorted, as flax's tree walk leaves them), lists and tuples as arrays, numpy arrays and CPU or
CUDA tensors as ndarray extensions (bfloat16 as its raw bits under the
name "bfloat16"), numpy scalars as scalar extensions, Python scalars,
strings, bytes and None. Arrays of 2**30 bytes or more, which flax would
split into chunks, are refused.
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


_MAX_ARRAY_BYTES = 2 ** 30


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def put(self, fmt: str, *vals) -> None:
        self.out += struct.pack(fmt, *vals)

    def sized(self, n: int, fix: Tuple[int, int], codes: Tuple[Tuple[int, str, int], ...]) -> None:
        """A length header: the fix form (base, limit) or the first code
        whose limit holds n."""
        base, limit = fix
        if base is not None and n <= limit:
            self.put(">B", base | n)
            return
        for code, fmt, top in codes:
            if n <= top:
                self.put(">B" + fmt, code, n)
                return
        raise ValueError(f"msgpack length {n} too large")

    def int(self, v: int) -> None:
        if 0 <= v < 0x80 or -0x20 <= v < 0:
            self.put(">b" if v < 0 else ">B", v)
        elif 0 <= v:
            for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                                   (0xCE, "I", 0xFFFFFFFF), (0xCF, "Q", 2 ** 64 - 1)):
                if v <= top:
                    self.put(">B" + fmt, code, v)
                    return
            raise ValueError(f"integer {v} does not fit msgpack")
        else:
            for code, fmt, low in ((0xD0, "b", -0x80), (0xD1, "h", -0x8000),
                                   (0xD2, "i", -0x80000000), (0xD3, "q", -2 ** 63)):
                if v >= low:
                    self.put(">B" + fmt, code, v)
                    return
            raise ValueError(f"integer {v} does not fit msgpack")

    def str(self, v: str) -> None:
        data = v.encode("utf-8")
        self.sized(len(data), (0xA0, 31), ((0xD9, "B", 0xFF), (0xDA, "H", 0xFFFF),
                                            (0xDB, "I", 0xFFFFFFFF)))
        self.out += data

    def bin(self, v: bytes) -> None:
        self.sized(len(v), (None, -1), ((0xC4, "B", 0xFF), (0xC5, "H", 0xFFFF),
                                         (0xC6, "I", 0xFFFFFFFF)))
        self.out += v

    def ext(self, code: int, data: bytes) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            self.put(">B", fixed[len(data)])
        else:
            self.sized(len(data), (None, -1), ((0xC7, "B", 0xFF), (0xC8, "H", 0xFFFF),
                                                (0xC9, "I", 0xFFFFFFFF)))
        self.put(">b", code)
        self.out += data

    def obj(self, v: Any) -> None:
        if v is None:
            self.put(">B", 0xC0)
        elif v is True or v is False:
            self.put(">B", 0xC3 if v else 0xC2)
        elif type(v) is int:
            self.int(v)
        elif type(v) is float:
            self.put(">Bd", 0xCB, v)
        elif type(v) is str:
            self.str(v)
        elif type(v) is bytes:
            self.bin(v)
        elif isinstance(v, dict):
            self.sized(len(v), (0x80, 15), ((0xDE, "H", 0xFFFF), (0xDF, "I", 0xFFFFFFFF)))
            if not all(type(k) is str for k in v):
                raise TypeError(f"msgpack map keys must be str, got {sorted(map(repr, v))}")
            for k in sorted(v):  # flax's tree walk sorts dict keys
                self.str(k)
                self.obj(v[k])
        elif isinstance(v, (list, tuple)):
            self.sized(len(v), (0x90, 15), ((0xDC, "H", 0xFFFF), (0xDD, "I", 0xFFFFFFFF)))
            for item in v:
                self.obj(item)
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
        elif isinstance(v, np.ndarray) or _is_tensor(v):
            self.ext(_EXT_NDARRAY, _ndarray_payload(v))
        elif isinstance(v, complex):
            inner = _Writer()
            inner.obj([v.real, v.imag])
            self.ext(_EXT_COMPLEX, bytes(inner.out))
        else:
            raise TypeError(f"cannot write {type(v).__name__} to msgpack")


def _is_tensor(v: Any) -> bool:
    return type(v).__module__.startswith("torch") and hasattr(v, "detach")


def _ndarray_payload(arr: Any) -> bytes:
    """The ndarray extension's payload: msgpack ``[shape, dtype name, bytes]``."""
    if _is_tensor(arr):
        import torch

        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, buf = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
    if not _is_tensor(arr):
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be written")
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    if len(buf) >= _MAX_ARRAY_BYTES:
        raise ValueError(f"an array of {len(buf)} bytes needs flax's chunked layout, "
                         "which this writer does not produce")
    w = _Writer()
    w.sized(3, (0x90, 15), ())
    w.obj([int(d) for d in shape])
    w.str(name)
    w.bin(buf)
    return bytes(w.out)


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree as ``flax.serialization.msgpack_serialize`` does."""
    w = _Writer()
    w.obj(tree)
    return bytes(w.out)


def tree_shapes(tree: Any, prefix: Tuple[str, ...] = ()) -> dict:
    """Flatten a nested tree to {path: shape} (for tests and diagnostics)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_shapes(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tuple(np.shape(tree))}
