"""The benchmark of ``deepfake_vit_tpu_torch`` on an NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the numbers its output check
compared, each beside its limit, as the last lines of standard error, and
as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. Exits non-zero, printing no result,
without a card (it never falls back to the CPU) or when JAX or the JAX
package was loaded. Build and kernel caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch

    # One host thread for PyTorch's CPU ops: the loop's host work is kernel
    # dispatch, and the benchmark's own load stays on one core.
    torch.set_num_threads(1)

    from benchmark.harness import CellFiles, banned_modules, run_cell

    files = CellFiles(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(files.cell["chips"]):
        print(f"benchmark: the cell needs {files.cell['chips']} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 3
    result = run_cell(files, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = banned_modules()
    if found:
        print(f"benchmark: modules loaded that must not be: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
