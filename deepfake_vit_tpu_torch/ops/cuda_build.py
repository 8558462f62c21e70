"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source is compiled with ``nvcc`` for ``sm_90a`` (one compiler process
per source, all started together), linked into one shared library with a
plain C interface under ``build/deepfake_vit_tpu_torch/`` at the repository
root, and loaded with ``ctypes``. The library's name carries the hash of all
sources and of the header they share (``csrc/*.cuh``), so it is rebuilt only
when one of them changes. Nothing happens at import: the first kernel call
builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepfake_vit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR))
# The sm_90a card the kernels are planned for (H100): shared memory one
# block can ask for (227 KB) and streaming multiprocessors.
SMEM_PER_BLOCK = 232448
SM_COUNT = 132

_P, _I = ctypes.c_void_p, ctypes.c_int
# The extern "C" interface of csrc/*.cu; every function returns cudaError.
_SIGNATURES = {
    "dfv_crop_frac_bf16": [*[_P] * 8, *[_I] * 9, _P],
    "dfv_crop_pool_bf16": [*[_P] * 6, *[_I] * 12, _P],
    "dfv_warp_affine": [_P, _P, _P, _P, *[_I] * 10, _P],
    "dfv_int8_gemm": [*[_P] * 6, *[_I] * 6, _P],
    "dfv_int8_conv": [*[_P] * 6, *[_I] * 14, _P],
    "dfv_fused_stem": [*[_P] * 4, *[_I] * 9, _P],
    "dfv_fused_block": [*[_P] * 14, *[_I] * 11, _P],
    "dfv_fused_mbconv": [*[_P] * 14, *[_I] * 9, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless a library for their and the headers'
    current hash exists.

    Returns the path of the shared library. ``verbose`` adds ``-Xptxas -v``
    and prints the compiler's report (registers, shared memory, spills).
    """
    srcs = sources()
    digest = hashlib.sha256()
    for src in [*srcs, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libdfv_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                 "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(srcs, objects)
        ]
        results = [(src, proc, *proc.communicate()) for src, proc in zip(srcs, procs)]
        for src, proc, _, err in results:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            if verbose:
                print(err, end="")
        lib_tmp = Path(tmp) / "lib.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(lib_tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
