"""Readings for the limits of a clip-serving cell's output check, in one
process: ``calibrate.py`` for a cell whose kind brings its own controls
and planted faults (``controls(files)`` and ``FAULTS`` of
``benchmark/kinds/<kind>.py``, as ``kinds/serve_clips.py`` does).

    python3 benchmark/calibrate_clips.py --workload <cell> --seeds <n> [--first <seed>]
        [--control-seeds <m>] [--faults <name,...>] [--seconds <s>] [--out <file>]

For each of ``n`` seeds a run of the cell gives the program's numbers (the
lower readings); for ``m`` seeds each control and each fault named in
``--faults`` gives its numbers (the upper readings). Every number the check
computes is read. Prints one JSON line a run, writes them all to
``--out``, and prints to stderr the three faces and the three clips that
read highest on each number. Needs a card; not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]


def worst(details: Dict[str, Dict[str, Any]], n: int = 3) -> Dict[str, Any]:
    """Per group (faces, clips) and number, the n rows reading highest,
    each with every number of its group."""
    import torch

    out = {}
    for group, d in details.items():
        per = {k: v.float().cpu() for k, v in d.items()}
        for name, v in per.items():
            idx = torch.argsort(v, descending=True)[:n].tolist()
            out[f"{group}.{name}"] = [{k: round(float(w[i]), 4) for k, w in per.items()}
                                      | {"row": i} for i in idx]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_017)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="", help="planted faults to read, comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import CellFiles, run_cell

    if not torch.cuda.is_available():
        print("calibrate_clips: no CUDA device is available", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    files = CellFiles(ROOT, args.workload)
    rows = []

    def one(kind: str, seed: int, make_cell=None) -> None:
        t0 = time.perf_counter()
        cells = []

        def factory(*a, **kw):
            cells.append((make_cell or files.kind.Cell)(*a, **kw))
            return cells[-1]

        r = run_cell(files, seed, args.seconds, False, dev, t0, make_cell=factory)
        for d in cells[0].details:
            print(json.dumps({"seed": seed, "run": kind, "look": worst(d)}), file=sys.stderr,
                  flush=True)
        row: Dict[str, Any] = {"cell": args.workload, "run": kind, "seed": seed,
                               "numbers": cells[0].readings,
                               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                               "memory_peak_bytes": r["device"]["memory_peak_bytes"],
                               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)

    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    for s in seeds:
        one("program", s)
    for name, factory in files.kind.controls(files).items():
        for s in seeds[:args.control_seeds]:
            one(f"control:{name}", s, factory)
    for name in filter(None, args.faults.split(",")):
        for s in seeds[:args.control_seeds]:
            one(f"fault:{name}", s, files.kind.FAULTS[name])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
