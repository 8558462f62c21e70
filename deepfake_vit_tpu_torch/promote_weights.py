"""Promote a staged weights file into the shipped weights directory, gated.

    python -m deepfake_vit_tpu_torch.promote_weights STAGED.msgpack
        --model scrfd|lite|mtcnn|hog|refine|classifier [--device cuda|cpu]

The flags of the JAX package's ``scripts/promote_weights.py``, plus
``--device``. The family's acceptance bars (``acceptance.py``) run against
the candidate in a child process whose ``DFV_WEIGHTS_<MODEL>`` names the
staged file, so every loader of the port reads the candidate there
(``preprocessing/detector.py::default_weights_path``). The file is copied
atomically into the shipped directory only when every bar holds;
otherwise the run exits 1 and the file stays staged. The child runs on
the parent's device: the card unless ``--device cpu`` is given, and it
loads the kernel library the parent's checkout has built (``build/``).

``promote(candidate, model, dest_dir)`` takes the destination as an
argument, by default the directory the port reads (``_WEIGHTS_DIR``), so
that tests promote into a directory of their own.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional, Union

from .preprocessing.detector import _WEIGHTS_DIR, DEFAULT_WEIGHTS_BY_MODEL

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("classifier", "hog", "lite", "mtcnn", "refine", "scrfd")


def run_acceptance(candidate: Union[str, Path], model: str, device: Optional[str] = None) -> bool:
    """Run the family's bars against ``candidate`` in a child process."""
    env = {**os.environ, f"DFV_WEIGHTS_{model.upper()}": str(Path(candidate).resolve())}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "deepfake_vit_tpu_torch.acceptance", "--model", model]
    if device is not None:
        cmd += ["--device", str(device)]
    return subprocess.run(cmd, cwd=ROOT, env=env).returncode == 0


def promote(candidate: Union[str, Path], model: str,
            dest_dir: Union[str, Path] = _WEIGHTS_DIR) -> Path:
    """Atomically copy an accepted candidate to ``dest_dir`` under the
    family's shipped name."""
    dest = Path(dest_dir) / DEFAULT_WEIGHTS_BY_MODEL[model].name
    dest.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dest.parent, suffix=".tmp")
    os.close(fd)
    try:
        shutil.copyfile(candidate, tmp)
        os.replace(tmp, dest)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise
    return dest


def main(argv: Optional[List[str]] = None, dest_dir: Union[str, Path] = _WEIGHTS_DIR) -> int:
    parser = argparse.ArgumentParser(description="Promote staged weights, gated by the "
                                     "family's acceptance bars (PyTorch port)")
    parser.add_argument("candidate", type=str, help="staged msgpack weights")
    parser.add_argument("--model", required=True, choices=FAMILIES)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)

    candidate = Path(args.candidate).resolve()
    if not candidate.exists():
        parser.error(f"candidate not found: {candidate}")
    if args.device is None:
        from .device import resolve_device

        resolve_device(None)  # the card, or raise here rather than in the child
    print(f"[promote] acceptance run: model={args.model} candidate={candidate}", flush=True)
    if not run_acceptance(candidate, args.model, args.device):
        print(f"[promote] REFUSED: acceptance bars failed; {candidate} stays staged",
              file=sys.stderr)
        return 1
    dest = promote(candidate, args.model, dest_dir)
    print(f"[promote] accepted -> {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
