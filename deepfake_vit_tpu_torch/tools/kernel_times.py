"""Time the int8 convolution at every shape the int8 detector launches, the
fused stem, MBConv block and prototype and the pooled crop at
``chip_smoke.py``'s shapes, for the port of a given checkout, on one NVIDIA
GPU.

    python3 deepfake_vit_tpu_torch/tools/kernel_times.py [--root DIR]
        [--kernels int8_conv,stem,blocks,crop_pool]

``--root`` is a directory that holds a checkout's ``deepfake_vit_tpu_torch``
package (default: this checkout). An earlier commit unpacked with ``git
archive`` into an ignored directory is timed by the same measurement code as
the current one, so the two compare within one call, on one card, in turns
(earlier, current, current, earlier). The measurement is ``chip_smoke.py``'s
own, from this checkout (``detector_conv_shapes``, ``check_int8_conv``,
``check_stem``, ``check_fused``, ``check_crop_pool``: the stem at paths C's
and D's shapes, the pooled crop at paths B's and F's on seeded 640² frames),
applied to the root's kernels: CUDA-event and profiler
device times, the plain versions, the bounds and the agreement; the
one-device-launch checks of the stem and the crop only for this checkout
(an earlier one launched more). The detector's launches are recorded from the root's own ``ScrfdInt8Runner``
(seeded weights, dynamic scales) on one 320² detection canvas, and its
kernels are laid out as that runner keeps them. The root's kernels build
into its own ``build/`` directory. ``--kernels`` picks the groups to time
(default: all of them; ``blocks`` includes the stem and the prototype).

Prints the card and chip_smoke's lines, then one JSON line with every
number; exits non-zero without a card or when a kernel disagrees with its
plain version.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def load_chip_smoke():
    """chip_smoke.py of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def detector_convs(cs, dev):
    """The int8 detector's launches, [(H, Cin, Cout, k, stride)], recorded
    from the importable package's ``ScrfdInt8Runner`` (seeded weights,
    dynamic scales) on one 320² detection canvas, and whether its kernels
    are K-major."""
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.models.scrfd_int8 import ScrfdInt8Runner
    from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net

    det = build_detection_net("scrfd", dtype=torch.bfloat16, stem_pool=2)
    runner = ScrfdInt8Runner(init_weights(det, 0).to(dev).eval(), dtype=torch.bfloat16)
    canvas = torch.zeros((1, 640, 640, 3), dtype=torch.bfloat16, device=dev)
    return cs.detector_conv_shapes(runner, canvas)


GROUPS = ("int8_conv", "stem", "blocks", "crop_pool")


def crop_pool_rows(cs, wk, dev, check_launches):
    """chip_smoke's pooled-crop check on its phase-3 inputs: 128 seeded
    640² frames and the seeded geometry of its fractional crop."""
    g = torch.Generator(device="cpu").manual_seed(0)
    (H, W), C, N = cs.SERVING, 3, 128
    frames = torch.randint(0, 256, (N, H, W, C), generator=g, dtype=torch.uint8).to(dev)
    return cs.check_crop_pool(wk, frames.to(torch.bfloat16).reshape(N, H, W * C),
                              cs.seeded_geometry(N, 1, dev), dev, check_launches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="directory holding deepfake_vit_tpu_torch")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help=f"comma-separated groups to time, of {', '.join(GROUPS)}")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    groups = opts.kernels.split(",")
    if not set(groups) <= set(GROUPS):
        ap.error(f"--kernels takes {GROUPS}, got {groups}")
    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")

    sys.path.insert(0, str(root))
    import deepfake_vit_tpu_torch
    from deepfake_vit_tpu_torch.ops import fused_mbconv as fm
    from deepfake_vit_tpu_torch.ops import fused_stages as fs
    from deepfake_vit_tpu_torch.ops import int8_kernel as ik
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk

    if Path(deepfake_vit_tpu_torch.__file__).resolve().parents[1] != root:
        cs.fail(f"imported {deepfake_vit_tpu_torch.__file__}, not the package under {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; timing the port under {root}")
    dev = torch.device("cuda")
    report = {"card": card, "root": str(root)}
    # An earlier checkout's stem and crop launched more than their kernels.
    own = root == ROOT
    if "int8_conv" in groups:
        convs, k_major = detector_convs(cs, dev)
        report.update(detector_convs=convs, kernels_k_major=k_major,
                      int8_conv=cs.check_int8_conv(ik, dev, convs, k_major))
    if "blocks" in groups:
        stem_rows, block_rows, proto_rows = cs.check_fused(fs, fm, dev, own)
        report.update(run_stem=stem_rows, run_block=block_rows, fused_mbconv=proto_rows)
    elif "stem" in groups:
        from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
        from deepfake_vit_tpu_torch.models.layers import init_weights

        bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 1).to(dev).eval()
        report["run_stem"] = cs.check_stem(fs, bb, dev, own)
    if "crop_pool" in groups:
        report["crop_pool"] = crop_pool_rows(cs, wk, dev, own)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
