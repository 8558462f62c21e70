"""Time design variants of the int8 convolution and the fused MBConv block
on one NVIDIA GPU.

    python3 deepfake_vit_tpu_torch/tools/mma_variants.py

Each variant is ``csrc/`` as committed with a few lines of one source
replaced (``VARIANTS``), compiled with ``nvcc`` (all sources, one library a
variant, the variants in parallel) under ``build/mma_variants/`` and put in
place of the port's kernel library, so that the wrappers themselves
(``int8_conv``, ``run_block``) run it. ``int8_conv`` is timed at every
shape the int8 detector launches (recorded from ``ScrfdInt8Runner`` on one
320² canvas, B = 128, K-major kernels) and summed over the 25 launches of a
batch; the committed library also under each of its three block tiles, the
plan overridden. ``run_block`` is timed at ``chip_smoke.py``'s B4 block
shapes. Every time is the kernels' own device time from ``torch.profiler``
(``chip_smoke.device_ms``). A variant marked exact must give the committed
kernel's output bit for bit; the others compute something else and measure
what the lines they drop or change cost. Prints one line a measurement;
exits non-zero without a card or when an exact variant differs.

The replaced lines are matched literally: a change to a source that touches
them makes this script stop with the line it misses.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "mma_variants"
sys.path.insert(0, str(ROOT))  # run as a script from anywhere

_SILU = "__device__ __forceinline__ float silu_f(float v) { return v / (1.0f + expf(-v)); }"
_PROJECT = "            if (nt >= t_lo && nt < t_hi) {\n              unsigned b[4];"
# name: (source, [(committed line(s), replacement)], exact)
VARIANTS = {
    "committed": ("", [], True),
    "4 pipeline stages": ("int8.cu", [("constexpr int kStages = 3;",
                                       "constexpr int kStages = 4;")], True),
    "plain f32 stores (no evict-first hint)": ("int8.cu", [(
        "        __stcs(reinterpret_cast<float2*>(out + (size_t)m * N + n), make_float2(v0, v1));",
        "        *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(v0, v1);")],
        True),
    "SiLU with __expf and __fdividef": (
        "fused.cu", [(_SILU, "__device__ __forceinline__ float silu_f(float v) "
                             "{ return __fdividef(v, 1.0f + __expf(-v)); }")], False),
    "projection without its products": (
        "fused.cu", [(_PROJECT, _PROJECT.replace("nt >= t_lo && nt < t_hi", "false"))], False),
}


def build(variants: dict = VARIANTS, out_dir: Path = OUT_DIR) -> dict:
    """Compile every variant ({name: (source, [(old, new)], exact)}) in
    parallel under ``out_dir``; returns name -> loaded library."""
    from deepfake_vit_tpu_torch.ops import cuda_build

    nvcc = cuda_build._nvcc()
    procs = []
    for k, (name, (src, pairs, _)) in enumerate(variants.items()):
        vdir = out_dir / f"v{k}"
        shutil.rmtree(vdir, ignore_errors=True)
        vdir.mkdir(parents=True)
        for cu in cuda_build.sources():
            text = cu.read_text()
            if cu.name == src:
                for old, new in pairs:
                    if text.count(old) != 1:
                        sys.exit(f"{out_dir.name}: {name!r}: csrc/{src} does not hold the line "
                                 f"{old.strip()!r} once")
                    text = text.replace(old, new)
            (vdir / cu.name).write_text(text)
        so = vdir / "lib.so"
        procs.append((name, so, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared", "-o", str(so),
             *map(str, sorted(vdir.glob("*.cu")))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"{out_dir.name}: nvcc failed on {name!r}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_build._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    from deepfake_vit_tpu_torch.tools.kernel_times import detector_convs, load_chip_smoke

    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.ops import cuda_build
    from deepfake_vit_tpu_torch.ops import fused_stages as fs
    from deepfake_vit_tpu_torch.ops import int8_kernel as ik

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    libs = build()
    dev = torch.device("cuda")
    cuda_build._lib = libs["committed"]
    convs, _ = detector_convs(cs, dev)

    conv_inputs = {}
    for H, cin, cout, k, stride in dict.fromkeys(convs):
        g = torch.Generator(device="cpu").manual_seed(H + cin + cout + k)
        xq = torch.randint(-127, 128, (128, H, H, cin), generator=g, dtype=torch.int8).to(dev)
        kq = torch.randint(-127, 128, (cout, k, k, cin), generator=g, dtype=torch.int8)
        conv_inputs[(H, cin, cout, k, stride)] = (
            xq, kq.to(dev).permute(1, 2, 3, 0), torch.tensor([0.031], device=dev),
            (torch.rand(cout, generator=g) * 0.01 + 0.001).to(dev),
            torch.randn(cout, generator=g).to(dev), stride)
    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
    g = torch.Generator(device="cpu").manual_seed(3)
    blocks = {f"B4 block {idx}, B = {B}, {h}²": cs.block_inputs(fs, bb, v, idx, h, B, g, dev)[2:]
              for v, idx, h, B in cs.FUSED_BLOCKS if v == "b4"}

    def conv_sweep(label, refs):
        total = 0.0
        for shape, args in conv_inputs.items():
            out = ik.int8_conv(*args)
            torch.cuda.synchronize()
            if shape not in refs:
                refs[shape] = out
            same = torch.equal(out, refs[shape])
            ms = cs.device_ms(lambda: ik.int8_conv(*args), "int8_conv_kernel")["ms"]
            total += ms * convs.count(shape)
            print(f"[{card}] {label}: int8_conv {shape} {ms:.4f} ms" + ("" if same else " DIFFERS"))
            if not same:
                return None
        print(f"[{card}] {label}: int8_conv, the detector's {len(convs)} launches a batch: "
              f"{total:.4f} ms")
        return total

    def block_sweep(label, refs, exact):
        for name, (bp, weights, x) in blocks.items():
            out = fs.run_block(bp, x, weights)
            torch.cuda.synchronize()
            refs.setdefault(name, out)
            same = torch.equal(out, refs[name])
            if exact and not same:
                cs.fail(f"mma_variants: {label!r} changes run_block at {name}")
            ms = cs.device_ms(lambda: fs.run_block(bp, x, weights), "fused_", iters=5)["ms"]
            print(f"[{card}] {label}: run_block {name} {ms:.4f} ms"
                  + ("" if same else " (computes something else)"))

    conv_refs, block_refs = {}, {}
    for name, lib in libs.items():
        cuda_build._lib = lib
        src, _, exact = VARIANTS[name]
        if src in ("", "int8.cu") and conv_sweep(name, conv_refs) is None and exact:
            cs.fail(f"mma_variants: {name!r} changes int8_conv")
        if src in ("", "fused.cu"):
            block_sweep(name, block_refs, exact)
    cuda_build._lib = libs["committed"]
    plan = ik.int8_conv_plan
    for config, tile in enumerate(ik.CONV_TILES):
        ik.int8_conv_plan = lambda M, K, N, Cin, c=config: plan(M, K, N, Cin)._replace(config=c)
        if conv_sweep(f"committed, every conv on tile {tile[0]} x {tile[1]}", conv_refs) is None:
            cs.fail(f"mma_variants: tile {tile} changes int8_conv")
    ik.int8_conv_plan = plan


if __name__ == "__main__":
    main()
