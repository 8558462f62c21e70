"""ctypes binding of the native decode thread pool (``native/dataloader.cc``).

Counterpart of the JAX package's ``data/native_loader.py``. The C++ pool
decodes face images with OpenCV, converts BGR to RGB, resizes (bilinear),
ImageNet-normalizes and writes straight into a caller-owned NHWC float32
batch, with no Python object per image and no GIL on the decode path.

The library is built at first use from ``native/dataloader.cc`` as it is,
with the flags of ``native/build.sh`` (``g++ -O3 -march=native``,
OpenCV 4's headers under ``/usr/include/opencv4``, ``-lopencv_imgcodecs
-lopencv_imgproc -lopencv_core``), into ``build/deepfake_vit_tpu_torch/``
at the repository root. Its name carries the hash of the source, and it
is written to a temporary directory then moved into place, so parallel
processes never load half a library. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataloader.cc"
BUILD_DIR = _ROOT / "build" / "deepfake_vit_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-I/usr/include/opencv4")
LIBS = ("-lopencv_imgcodecs", "-lopencv_imgproc", "-lopencv_core")

_lib: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compile ``native/dataloader.cc`` unless a library for its current
    hash exists; returns the library's path. Raises when g++ fails."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libdfv_dataloader_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = Path(tmp) / "lib.so"
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(lib_tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("the native decoder needs g++ on PATH") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the native decoder failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded decoder library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.dfv_loader_create.argtypes = [ctypes.c_int]
        lib.dfv_loader_create.restype = ctypes.c_void_p
        lib.dfv_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.dfv_loader_destroy.restype = None
        lib.dfv_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.dfv_decode_batch.restype = ctypes.c_int
        lib.dfv_decode_one.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float)]
        lib.dfv_decode_one.restype = ctypes.c_int
        _lib = lib
    return _lib


def is_available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


class NativeDecoder:
    """A persistent decode thread pool over the C interface.

    ``decode_batch`` returns ``(images, failed)``: an (N, S, S, 3) float32
    NHWC array and an (N,) bool array that flags files that did not
    decode (their slots are zeros).
    """

    def __init__(self, num_threads: int = 4):
        self._lib = library()
        self._handle = self._lib.dfv_loader_create(int(num_threads))

    def decode_batch(self, paths: Sequence[str], image_size: int = 224,
                     normalize: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        n = len(paths)
        images = np.empty((n, image_size, image_size, 3), dtype=np.float32)
        failed = np.zeros((n,), dtype=np.uint8)
        if n == 0:
            return images, failed.astype(bool)
        arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        self._lib.dfv_decode_batch(
            self._handle, arr, n, int(image_size), 1 if normalize else 0,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            failed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return images, failed.astype(bool)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dfv_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


__all__ = ["NativeDecoder", "build_library", "is_available", "library"]
