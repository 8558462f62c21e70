"""Time design variants of the affine warp kernel on one NVIDIA GPU.

    python3 deepfake_vit_tpu_torch/tools/warp_variants.py

Each variant is ``csrc/warp.cu`` as committed with a few lines replaced
(``VARIANTS``), compiled with ``nvcc`` into a library of its own under
``build/warp_variants/`` and called through the port's C entry
(``dfv_warp_affine``) at path A's shape: 128 faces, 128² bf16 crops to 192²
f32 faces, C = 3, seeded similarities (scale 0.5-0.8, roll ±20°). Every
variant and tile configuration is timed with CUDA events (median and range
of 5 × 200 launches) and its output held to the committed kernel's; the
committed kernel's to the plain version first. Beside them, a fill of the
output (the store floor) and ``F.grid_sample`` on the same input. The
variants that skip a phase compute something else: they measure what that
phase costs. Prints one line a measurement; exits non-zero without a card
or when an exact variant's output differs.

The replaced lines are matched literally: a change to ``csrc/warp.cu``
that touches them makes this script stop with the line it misses.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "warp_variants"
sys.path.insert(0, str(ROOT))  # run as a script from anywhere

_RESAMPLE = "  const int G = (C + 3) / 4;\n  const int box_cols = b.c_hi - b.c_lo + 1;\n"
_SKIP_RESAMPLE = (_RESAMPLE + "  if (true) {\n    for (int p = threadIdx.x; p < th * kWarpTileW * C; "
                  "p += kWarpThreads) outS[p] = 0.5f;\n    return;\n  }\n")
_STAGED = "  const bool staged = empty || (long long)rows * cols * G * 16 <= box_budget;"
_STREAM = ("        __stcs(reinterpret_cast<float4*>(g + k0), "
           "*reinterpret_cast<const float4*>(s + k0));")
# name: ([(committed line(s), replacement)], exact, [(tile_h, tile_w, box budget)])
VARIANTS = {
    "committed": ([], True, [(32, 32, 24 * 1024)]),
    "tile 16 x 64": ([("constexpr int kWarpTileW = 32;", "constexpr int kWarpTileW = 64;")], True,
                     [(16, 64, 24 * 1024)]),
    "plain 16-byte stores": ([(_STREAM, "        *reinterpret_cast<float4*>(g + k0) = "
                                        "*reinterpret_cast<const float4*>(s + k0);")], True,
                             [(32, 32, 24 * 1024)]),
    "products rounded on the integer pipe": ([(
        "  float m0 = __fmul_rn(p0, h0), m1 = __fmul_rn(p1, h1);\n  round_bf16x2(&m0, &m1);\n",
        "  const float m0 = round_bf16_int(__fmul_rn(p0, h0)), m1 = round_bf16_int(__fmul_rn(p1, h1));\n"),
        ("// Round a and b to bf16 in one conversion.\n",
         "__device__ __forceinline__ float round_bf16_int(float x) {\n"
         "  unsigned u = __float_as_uint(x);\n  u += 0x7fffu + ((u >> 16) & 1u);\n"
         "  return __uint_as_float(u & 0xffff0000u);\n}\n\n// Round a and b to bf16 in one conversion.\n")],
        True, [(32, 32, 24 * 1024)]),
    "8 blocks an SM (at most 32 registers)": ([(
        "__global__ void __launch_bounds__(kWarpThreads)\nwarp_tile_kernel(",
        "__global__ void __launch_bounds__(kWarpThreads, 8)\nwarp_tile_kernel(")],
        True, [(32, 32, 16 * 1024), (32, 32, 12 * 1024)]),
    "7 blocks an SM": ([(
        "__global__ void __launch_bounds__(kWarpThreads)\nwarp_tile_kernel(",
        "__global__ void __launch_bounds__(kWarpThreads, 7)\nwarp_tile_kernel(")],
        True, [(32, 32, 16 * 1024)]),
    "taps from device memory, nothing staged": ([(_STAGED, "  const bool staged = empty;")],
                                                True, [(32, 32, 24 * 1024)]),
    "stage + store, no resampling": ([(_RESAMPLE, _SKIP_RESAMPLE)], False, [(32, 32, 24 * 1024)]),
    "store only": ([(_RESAMPLE, _SKIP_RESAMPLE), (_STAGED, "  const bool staged = true;"),
                    ("  if (staged) {\n    // 2. Stage", "  if (false) {\n    // 2. Stage")],
                   False, [(32, 32, 24 * 1024)]),
}


def build(src: str) -> dict:
    """Compile every variant in parallel; returns name -> loaded library."""
    from deepfake_vit_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k, (name, (pairs, _, _)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in pairs:
            if old not in text:
                sys.exit(f"warp_variants: {name!r}: csrc/warp.cu has no line {old.strip()!r}")
            text = text.replace(old, new)
        cu, so = OUT_DIR / f"warp_{k}.cu", OUT_DIR / f"libwarp_{k}.so"
        cu.write_text(text)
        procs.append((name, so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"warp_variants: nvcc failed on {name!r}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dfv_warp_affine.argtypes = [P, P, P, P, *[I] * 10, P]
        lib.dfv_warp_affine.restype = I
        libs[name] = lib
    return libs


def timed(fn, iters: int = 200, repeats: int = 5):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples), min(samples), max(samples)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("warp_variants: needs an NVIDIA GPU")
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    libs = build((ROOT / "deepfake_vit_tpu_torch" / "csrc" / "warp.cu").read_text())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    N, S, Ho, C = 128, 128, 192, 3
    img = (torch.rand((N, S, S, C), generator=g) * 255).to(torch.bfloat16).to(dev)
    ang = torch.rand(N, generator=g) * 0.7 - 0.35
    sc = torch.rand(N, generator=g) * 0.3 + 0.5
    t = torch.rand((2, N), generator=g) * 20
    A = torch.stack([sc * ang.cos(), -sc * ang.sin(), t[0], sc * ang.sin(), sc * ang.cos(), t[1]],
                    -1).contiguous().to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    plains = (wk.warp_affine_legacy_plain, wk.warp_affine_uw_plain, wk.warp_affine_int8_plain)
    for taps, tname in ((0, "legacy"), (1, "rank-1 (uw, uw16)"), (2, "int8")):
        ref = None
        for name, lib in libs.items():
            _, exact, configs = VARIANTS[name]
            for tile_h, tile_w, budget in configs:
                out = torch.empty((N, Ho, Ho, C), device=dev)
                smem = tile_h * tile_w * C * 4 + budget

                def call():
                    return lib.dfv_warp_affine(img.data_ptr(), A.data_ptr(), out.data_ptr(), None,
                                               N, S, S, C, Ho, Ho, taps, tile_h, budget, smem,
                                               stream)

                if call() != 0:
                    sys.exit(f"warp_variants: {name!r} did not launch")
                torch.cuda.synchronize()
                if ref is None:
                    if not torch.equal(out, plains[taps](img, A, (Ho, Ho))):
                        sys.exit(f"warp_variants: the committed {tname} kernel differs from its "
                                 f"plain version")
                    ref = out.clone()
                same = torch.equal(out, ref)
                if exact and not same:
                    sys.exit(f"warp_variants: {name!r} ({tname}) differs from the committed kernel")
                ms, lo, hi = timed(call)
                print(f"[{card}] {tname}, {name}, tile {tile_h} x {tile_w}, box budget {budget}: "
                      f"{ms:.4f} ms [{lo:.4f}, {hi:.4f}]"
                      + ("" if exact else " (computes something else)"))
    out = torch.empty((N, Ho, Ho, C), device=dev)
    print(f"[{card}] fill (zero_) of the f32 output: {timed(lambda: out.zero_())[0]:.4f} ms")
    jj = torch.arange(Ho, device=dev, dtype=torch.float32)
    a, b, c, d, e, f = (A[:, k, None, None] for k in range(6))
    ii, jj = jj[:, None], jj[None, :]
    grid = torch.stack([(2 * (a * jj + b * ii + c) + 1) / S - 1,
                        (2 * (d * jj + e * ii + f) + 1) / S - 1], -1)
    x = img.permute(0, 3, 1, 2).float().contiguous()
    lib_ms = timed(lambda: F.grid_sample(x, grid, align_corners=False))[0]
    print(f"[{card}] F.grid_sample on the same input: {lib_ms:.4f} ms")


if __name__ == "__main__":
    main()
