"""Predict real (0) or fake (1) for every file of a directory.

    python -m deepfake_vit_tpu_torch.predict --data-dir DIR [--output submission.csv]
        [--checkpoint CKPT --config MODEL.yaml] [--preprocessing-config PRE.yaml]
        [--frames 5] [--threshold 0.5] [--device cuda|cpu]

The flags of the JAX package's ``scripts/predict.py``. An image is one
frame; a video gives ``--frames`` frames spaced evenly over its length; a
``.npy`` file holds RGB uint8 frames saved with numpy, (H, W, 3) or
(N, H, W, 3), and needs no decoder. Each file's frames are detected,
aligned and classified in one batch, the mean fake probability is held
against ``--threshold``, and a file that fails to decode, holds no frame
or shows no face is labelled 0. Writes
``filename,label`` rows to ``--output``. Without ``--checkpoint`` the
committed packaged classifier (``classifier_synface.msgpack``, b0 at 224²)
is used. ``--config`` and ``--preprocessing-config`` are YAML files
(``configs.MODEL_CONFIG`` and ``configs.PREPROCESSING_CONFIG`` by
default). Runs on the card unless ``--device cpu`` is given. Images and
videos need OpenCV (``cv2``), YAML files need PyYAML; both are imported
only when used.
"""

from __future__ import annotations

import argparse
import csv
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm"}
ARRAY_EXTS = {".npy"}

log = logging.getLogger("predict")


def sample_video_frames(path: Path, count: int) -> List[np.ndarray]:
    """``count`` RGB frames at evenly spaced positions of a video (seeks)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if total <= 0:
            return []
        frames = []
        for idx in np.linspace(0, total - 1, min(count, total)).astype(int):
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame = cap.read()
            if ok:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        return frames
    finally:
        cap.release()


def read_frames(path: Path, count: int) -> List[np.ndarray]:
    """The RGB frames of one file: one for an image, ``count`` for a video,
    those of a ``.npy`` array, none for anything else or an image that
    does not decode."""
    suffix = path.suffix.lower()
    if suffix in ARRAY_EXTS:
        frames = np.load(path, allow_pickle=False)
        return list(frames) if frames.ndim == 4 else [frames]
    import cv2

    if suffix in IMAGE_EXTS:
        bgr = cv2.imread(str(path))
        return [cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)] if bgr is not None else []
    if suffix in VIDEO_EXTS:
        return sample_video_frames(path, count)
    return []


def _load_yaml(path: Optional[str], default: Dict[str, Any]) -> Dict[str, Any]:
    if path is None:
        return default
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Predict real/fake for files (PyTorch port)")
    parser.add_argument("--data-dir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="trained checkpoint; when absent, the committed packaged "
                        "classifier (deepfake_vit_tpu/weights/classifier_synface.msgpack)")
    parser.add_argument("--config", type=str, default=None, help="model config YAML")
    parser.add_argument("--preprocessing-config", type=str, default=None)
    parser.add_argument("--output", type=str, default="submission.csv")
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    from .configs import MODEL_CONFIG, PREPROCESSING_CONFIG
    from .inference import DeepfakePredictor
    from .preprocessing.detector import default_weights_path

    pre_config = _load_yaml(args.preprocessing_config, PREPROCESSING_CONFIG)
    common = dict(frame_count=args.frames, threshold=args.threshold, device=args.device)
    if args.checkpoint:
        predictor = DeepfakePredictor(_load_yaml(args.config, MODEL_CONFIG), pre_config,
                                      checkpoint_path=args.checkpoint, **common)
    else:
        shipped = default_weights_path("classifier")
        if not shipped:
            parser.error("--checkpoint not given and no committed classifier weights found "
                         "(deepfake_vit_tpu/weights/classifier_synface.msgpack)")
        log.info(f"using the committed classifier weights: {shipped}")
        predictor = DeepfakePredictor.from_packaged(shipped, pre_config, **common)

    results = []
    for path in sorted(p for p in Path(args.data_dir).iterdir() if p.is_file()):
        label = 0
        try:
            frames = read_frames(path, args.frames)
            if frames:
                label = predictor.predict_frames(frames)["label"]
        except Exception as e:  # a file that fails is labelled real; the run goes on
            log.warning(f"{path.name}: {e!r} -> label 0")
            label = 0
        results.append((path.name, label))
        log.info(f"{path.name}: {label}")

    with open(args.output, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["filename", "label"])
        writer.writerows(results)
    log.info(f"wrote {args.output} ({len(results)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
