"""Time design variants and other launch plans of the stem and pooled-crop
kernels on one NVIDIA GPU.

    python3 deepfake_vit_tpu_torch/tools/stem_pool_variants.py

Source variants (``VARIANTS``): ``csrc/`` as committed with a few lines of
``fused.cu`` replaced literally, compiled in parallel under
``build/stem_pool_variants/`` (``mma_variants.build``) and put in place of
the port's library, so that ``run_stem`` itself runs them. A variant that
drops or changes work computes something else and measures what that work
costs. Plan variants: the kernels take their work split from the plan
functions (``ops/fused_stages.py::stem_plan``,
``ops/warp_kernel.py::crop_pool_plan``), whose constants this tool sets in
turn: the stem's output pixels a work item (``_STEM_PIXELS``: rows of a
band = pixels // columns) and the crop's band of output rows, stage buffer
and output rows a stage (``_POOL_BAND``, ``_POOL_STAGE``,
``_POOL_OUT_ROWS``). The committed library and plans are held to the plain
versions (the crop bit for bit on integer pixels, the stem within
``chip_smoke.FUSED_TOL``). Every time is the kernel's own device time
(``chip_smoke.device_ms``) at the serving paths' shapes: the stem at
(128, 192², 48) and (32, 224², 48) on B4's seeded stem, the crop at path
B's 128 faces and path F's 96 slots sharing 32 frames. Prints one line a
measurement and one JSON line; exits non-zero without a card or when a
committed kernel disagrees.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "stem_pool_variants"
sys.path.insert(0, str(ROOT))  # run as a script from anywhere

_SILU = "silu_f(acc[j][e] + bias[j][e & 1]);"
_STORE = "    for (int idx = tid; idx < npix * cpp; idx += STEM_THREADS) {"
_BOUNDS = ("template <int kCopy, int kNT>\n__global__ void __launch_bounds__(STEM_THREADS, 5)\n"
           "fused_stem_kernel(")


def _silu(expr: str) -> tuple:
    """The stem's SiLU of {v} = acc + bias replaced by ``expr``."""
    return _SILU, expr.format(v="(acc[j][e] + bias[j][e & 1])") + ";"


_NO_STORES = (_STORE, _STORE.replace("idx < npix", "idx < 0 * npix"))
# name: (source, [(committed line(s), replacement)], exact)
VARIANTS = {
    "committed": ("", [], True),
    "SiLU as the identity": ("fused.cu", [_silu("{v}")], False),
    "SiLU with __expf and __fdividef": ("fused.cu", [_silu("__fdividef({v}, 1.0f + __expf(-{v}))")],
                                        False),
    "no output stores": ("fused.cu", [_NO_STORES], False),
    "SiLU as the identity, no output stores": ("fused.cu", [_silu("{v}"), _NO_STORES], False),
    "no register bound (up to 255)": ("fused.cu", [(_BOUNDS, _BOUNDS.replace(
        "(STEM_THREADS, 5)", "(STEM_THREADS)"))], True),
    "at most 168 registers (3 blocks an SM)": ("fused.cu", [(_BOUNDS, _BOUNDS.replace(
        "(STEM_THREADS, 5)", "(STEM_THREADS, 3)"))], True),
    "at most 128 registers (4 blocks an SM)": ("fused.cu", [(_BOUNDS, _BOUNDS.replace(
        "(STEM_THREADS, 5)", "(STEM_THREADS, 4)"))], True),
    "at most 80 registers (6 blocks an SM)": ("fused.cu", [(_BOUNDS, _BOUNDS.replace(
        "(STEM_THREADS, 5)", "(STEM_THREADS, 6)"))], True),
    "one block an item (not persistent)": ("fused.cu", [(
        "  const int blocks = (int)std::min<long long>(items, (long long)std::max(1, sms * per_sm));",
        "  const int blocks = (int)items;")], True),
    "256 threads a block": ("fused.cu", [("constexpr int STEM_THREADS = 128;",
                                          "constexpr int STEM_THREADS = 256;")], True),
    "the general instantiation (no constant channel count)": ("fused.cu", [(
        "                : cstem == 48   ? fused_stem_kernel<16, 6>",
        "                : cstem == -48  ? fused_stem_kernel<16, 6>")], True),
}
STEM_PIXELS = (256, 128, 384, 512)
POOL_PLANS = ((8, 16384, 4), (4, 16384, 4), (16, 16384, 4), (8, 32768, 4), (8, 16384, 8),
              (16, 32768, 8))


def load_chip_smoke():
    """chip_smoke.py of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def pool_inputs(cs, dev):
    """(frames, y0_l0, x0, level, frame_idx) at path B's and F's shapes."""
    from deepfake_vit_tpu_torch.ops.warp import max_window_levels, window_geometry

    g = torch.Generator(device="cpu").manual_seed(0)
    (H, W), N = cs.SERVING, 128
    frames = torch.randint(0, 256, (N, H, W, 3), generator=g, dtype=torch.uint8).to(dev)
    frames = frames.to(torch.bfloat16).reshape(N, H, W * 3)
    levels = max_window_levels((H, W), cs.POOL_WINDOW)
    cases = {}
    n_f = cs.BATCH * cs.MULTI_K
    for path, A, fidx, fr in (
            ("B", cs.seeded_geometry(N, 1, dev), None, frames),
            ("F", cs.seeded_geometry(n_f, 7, dev),
             torch.arange(n_f, device=dev).int() // cs.MULTI_K, frames[:cs.BATCH])):
        level, y0s, x0s, _ = window_geometry(A, cs.POOL_FACE, (H, W), cs.POOL_WINDOW, levels,
                                             y_align=16)
        idx = torch.arange(A.shape[0], device=dev)
        cases[path] = (fr, y0s[level.long(), idx] << level, x0s[level.long(), idx], level, fidx)
    return cases


def main() -> None:
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.ops import fused_stages as fs
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk
    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet

    from deepfake_vit_tpu_torch.ops import cuda_build
    from deepfake_vit_tpu_torch.tools.mma_variants import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    libs = build(VARIANTS, OUT_DIR)
    cuda_build._lib = libs["committed"]
    report = {"card": card, "stem_variants": [], "stem": [], "crop_pool": []}

    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    sw = fs.fold_stem_weights(bb)
    g = torch.Generator(device="cpu").manual_seed(3)
    stem_x = {}
    for B, face in cs.STEM_SHAPES:
        faces = torch.randint(0, 256, (B, *face, 3), generator=g, dtype=torch.uint8).to(dev)
        x = normalize_imagenet(faces.float() / 255.0).to(torch.bfloat16)
        stem_x[f"({B}, {face[0]}²)"] = (x, fs.run_stem_plain(x, sw))

    refs = {}

    def stem_times(label, exact):
        """Device ms at both shapes; an exact variant must give the committed
        library's output bit for bit, and that one agrees with the plain
        version."""
        row = {"variant": label}
        for name, (x, want) in stem_x.items():
            got = fs.run_stem(x, sw)
            torch.cuda.synchronize()
            if name not in refs:
                cs.fused_agreement(f"run_stem, {label}", got, want)
                refs[name] = got
            same = torch.equal(got, refs[name])
            if exact and not same:
                cs.fail(f"stem_pool_variants: {label!r} changes run_stem at {name}")
            row[name] = cs.device_ms(lambda: fs.run_stem(x, sw), "fused_stem")["ms"]
            row[f"{name} equal to committed"] = same
        return row

    # About a second of launches first, so that the first variant does not
    # meet a card still raising its clocks.
    x_warm = next(iter(stem_x.values()))[0]
    for _ in range(10000):
        fs.run_stem(x_warm, sw)
    torch.cuda.synchronize()
    for name, lib in libs.items():
        cuda_build._lib = lib
        row = stem_times(name, VARIANTS[name][2])
        print(f"[{card}] run_stem, {name}: device_ms {row}")
        report["stem_variants"].append(row)
    cuda_build._lib = libs["committed"]
    committed = fs._STEM_PIXELS
    for pixels in STEM_PIXELS:
        fs._STEM_PIXELS = pixels
        row = {"pixels": pixels, **stem_times(f"{pixels} pixels a work item", True)}
        print(f"[{card}] run_stem, {pixels} output pixels a work item: device_ms {row}")
        report["stem"].append(row)
    fs._STEM_PIXELS = committed

    cases = pool_inputs(cs, dev)
    committed = (wk._POOL_BAND, wk._POOL_STAGE, wk._POOL_OUT_ROWS)
    for band, stage, out_rows in POOL_PLANS:
        wk._POOL_BAND, wk._POOL_STAGE, wk._POOL_OUT_ROWS = band, stage, out_rows
        row = {"band": band, "stage_bytes": stage, "out_rows": out_rows,
               "smem_bytes": wk.crop_pool_plan(cs.POOL_WINDOW, 3, cs.SERVING[1]).smem_bytes}
        for path, (fr, y0_l0, x0, level, fidx) in cases.items():
            def call():
                return wk.crop_pool(fr, y0_l0, x0, level, cs.POOL_WINDOW, 3, frame_idx=fidx)
            plain_idx = torch.arange(level.shape[0], device=dev).int() if fidx is None else fidx
            want = wk.crop_pool_plain(fr, y0_l0.int(), x0.int(), level.int(), cs.POOL_WINDOW, 3,
                                      plain_idx)
            if not torch.equal(call(), want):
                cs.fail(f"crop_pool with band {band}, stage {stage}, {out_rows} output rows "
                        f"differs from its plain version at path {path}'s shape")
            row[path] = cs.device_ms(call, "crop_pool")["ms"]
        print(f"[{card}] crop_pool, band {band}, stage {stage} bytes, {out_rows} output rows a stage: "
              f"device_ms {row}")
        report["crop_pool"].append(row)
    wk._POOL_BAND, wk._POOL_STAGE, wk._POOL_OUT_ROWS = committed
    print(json.dumps(report))


if __name__ == "__main__":
    main()
