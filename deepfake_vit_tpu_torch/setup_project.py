"""Project scaffolding: the data, checkpoint and output directory skeleton.

    python -m deepfake_vit_tpu_torch.setup_project [--root .]

The JAX package's ``scripts/setup_project.py``: the same directories, a
README in each top directory naming the port's CLIs that read or write it,
and a ``.gitignore`` where none exists. Existing READMEs and
``.gitignore`` are left as they are. Host-only: no device is touched.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

DIRS = [
    "data/raw",
    "data/processed/faces",
    "data/processed/landmarks",
    "data/processed/metadata",
    "data/processed/splits",
    "checkpoints",
    "runs",
    "outputs/logs",
    "outputs/visualizations",
]

READMES = {
    "data/raw": "Place raw datasets here: LFW-FER/, DeeperForensics/, GenAI/ "
    "(see the 'datasets' block of deepfake_vit_tpu_torch/configs.py::PREPROCESSING_CONFIG).",
    "data/processed": "Written by python -m deepfake_vit_tpu_torch.preprocess_dataset: faces/ "
    "(aligned PNGs), landmarks/ (NPY), metadata/ (JSON), splits/ (train/val/test CSVs), "
    "preprocessing_results.csv, preprocessing_statistics.json.",
    "checkpoints": "Rotating training checkpoints + best_model.ckpt "
    "(python -m deepfake_vit_tpu_torch.train).",
    "runs": "Training logs and TensorBoard files (python -m deepfake_vit_tpu_torch.train).",
    "outputs": "Evaluation metrics, predictions, visualizations "
    "(python -m deepfake_vit_tpu_torch.evaluate, python -m deepfake_vit_tpu_torch.predict).",
}

GITIGNORE = """\
data/
checkpoints/
runs/
outputs/
*.ckpt
__pycache__/
"""


def setup(root: Path) -> None:
    for d in DIRS:
        (root / d).mkdir(parents=True, exist_ok=True)
        print(f"created {root / d}")
    for d, text in READMES.items():
        readme = root / d / "README.md"
        if not readme.exists():
            readme.write_text(text + "\n")
    gi = root / ".gitignore"
    if not gi.exists():
        gi.write_text(GITIGNORE)
    print("project skeleton ready")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Create project directory skeleton")
    parser.add_argument("--root", type=str, default=".")
    setup(Path(parser.parse_args(argv).root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
