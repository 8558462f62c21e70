"""Readings for the limits of a serving cell's output check, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [--first <seed>]
        [--control-seeds <m>] [--faults <name,...>] [--seconds <s>] [--out <file>]

For each of ``n`` seeds, a run of the cell (set-up, a window of
``seconds``, the output check) gives the program's numbers: the lower
readings. For ``m`` seeds each of the cell's controls (``faults.controls``:
the program with the configuration's ``lower_precision`` options on, where
it names them, and the fp8 reference in the program's place) gives its
numbers, and so does each planted fault named in ``--faults``
(``faults.SERVE_FAULTS``): the upper readings. Every number the check
computes is read, also those the cell's limits file does not name. Prints
one JSON line per run, writes them all to ``--out``, and prints to stderr
the look behind each number (its worst faces). Needs a card; not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]


def worst_faces(d: Dict[str, Any], n: int = 3) -> Dict[str, Any]:
    """The n faces that read highest on each number, with every number of
    theirs: the look behind a limit."""
    import torch

    per = {k: v.float().cpu() for k, v in d.items()}
    out = {}
    from benchmark.kinds.serve_closed import STATS

    for name in STATS:
        idx = torch.argsort(per[name], descending=True)[:n].tolist()
        out[name] = [{k: round(float(v[i]), 4) for k, v in per.items()} | {"face": i}
                     for i in idx]
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

    from benchmark import faults
    from benchmark.harness import CellFiles, run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is available", file=sys.stderr)
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
        details = getattr(cells[0], "details", [])
        for d in details:
            print(json.dumps({"seed": seed, "run": kind, "look": worst_faces(d)}),
                  file=sys.stderr, flush=True)
        row: Dict[str, Any] = {"cell": args.workload, "run": kind, "seed": seed,
                               "numbers": cells[0].readings,
                               "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)

    seeds = [args.first + 7919 * i for i in range(args.seeds)]
    for s in seeds:
        one("program", s)
    for name, factory in faults.controls(files).items():
        for s in seeds[:args.control_seeds]:
            one(f"control:{name}", s, factory)
    for name in filter(None, args.faults.split(",")):
        for s in seeds[:args.control_seeds]:
            one(f"fault:{name}", s, faults.SERVE_FAULTS[name])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
