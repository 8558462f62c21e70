"""The acceptance bars of the committed weights, one function a family.

    python -m deepfake_vit_tpu_torch.acceptance --model scrfd|lite|mtcnn|hog|refine|classifier|all
        [--device cuda|cpu]

Each function loads its family through the loaders a user calls
(``FaceDetector``, ``create_face_detector``, ``PreprocessingPipeline``),
which read the committed file or, where ``DFV_WEIGHTS_<MODEL>`` names one,
a staged candidate (``preprocessing/detector.py::default_weights_path``),
measures the family's bars on drawn held-out scenes and returns its
numbers with ``held``. The bars are those of the JAX package's acceptance
tests:

- ``scrfd`` (``tests/test_detector_trained.py``): recall >= 0.9 at
  IoU > 0.5 and mean landmark error < 0.10 of the inter-eye distance on 32
  held-out 320² scenes (faces 48-220 px, seed 20260816); at least 90 % of
  16 clutter scenes with no score of 0.6 or more (seed + 1); ``detect`` on
  one scene returns the contract's dict with a box at IoU > 0.5.
- ``lite``: the S2D-Lite family held to SCRFD's two bars (clutter seed + 11).
- ``mtcnn``: recall >= 0.85 and landmark error < 0.20 on 24 160² scenes
  (faces 36-110 px, seed + 7).
- ``hog`` (``tests/test_hog_detector.py``): recall >= 0.9 on 32 scenes
  (faces 48-180 px), at most 6 of 30 clutter scenes firing.
- ``refine`` (``tests/test_refine_net.py``): the cascade keeps SCRFD's
  recall and landmark bars on 24 scenes (seed + 21), its mean best IoU no
  more than 0.01 below the proposal detector's, and the clutter bar (seed
  + 22).
- ``classifier`` (``tests/test_classifier_trained.py``): the packaged
  format's contract, and held-out ROC-AUC >= 0.62 over 2 × 50 drawn faces
  (seed 20260820) through ``PreprocessingPipeline`` (SCRFD at 320²,
  confidence 0.3), with at least 90 % of them processed.

The CLI prints one JSON line a family and exits 0 only when every bar
holds. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

HELDOUT_SEED = 20260816  # the detectors' held-out scenes (training draws seed 42)
CLASSIFIER_SEED = 20260820  # the classifier's held-out faces
CLASSIFIER_PER_CLASS = 50
CLASSIFIER_AUC_BAR = 0.62
CLASSIFIER_MIN_SUCCESS = 0.9
PACKAGED_FACE_SIZES = (96, 128, 160, 192, 224)

Device = Optional[Union[str, torch.device]]


def _iou(a, b) -> float:
    x1, y1, x2, y2 = max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / max(union, 1e-9))


def heldout_scenes(seed: int, n: int, size: int, min_face: int, max_face: int) -> List[tuple]:
    """n single-face drawn scenes (image, boxes, keypoints), as the JAX
    acceptance tests draw them."""
    from .data.synth_faces import render_scene

    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        img, boxes, kps = render_scene(rng, size=size, max_faces=1, min_face=min_face,
                                       max_face=max_face, p_empty=0.0)
        if len(boxes):
            out.append((img, boxes, kps))
    return out


def best_faces(out: Dict[str, np.ndarray], scenes) -> tuple:
    """Recall at IoU > 0.5 of each scene's best detection, the mean landmark
    error of the hits in inter-eye distances, and each scene's best IoU."""
    hits, lm_errs, ious = 0, [], []
    for i, (_, boxes, kps) in enumerate(scenes):
        valid = out["valid"][i]
        if not valid.any():
            ious.append(0.0)
            continue
        best = int(np.argmax(out["scores"][i][valid]))
        bbox, lms = out["boxes"][i][valid][best], out["landmarks"][i][valid][best]
        face_ious = [_iou(bbox, b) for b in boxes]
        gi = int(np.argmax(face_ious))
        ious.append(face_ious[gi])
        if face_ious[gi] > 0.5:
            hits += 1
            ied = float(np.linalg.norm(kps[gi][0] - kps[gi][1]))
            lm_errs.append(float(np.linalg.norm(lms - kps[gi], axis=1).mean()) / ied)
    return hits / len(scenes), float(np.mean(lm_errs)) if lm_errs else math.inf, np.asarray(ious)


def clutter_quiet(det, seed: int, n: int = 16, size: int = 320) -> float:
    """Share of n face-free clutter scenes whose best score stays below 0.6."""
    from .data.synth_faces import render_scene

    rng = np.random.default_rng(seed)
    images = np.stack([render_scene(rng, size=size, p_empty=1.1)[0] for _ in range(n)])
    out = det.detect_batch_raw(images.astype(np.float32))
    return float((np.where(out["valid"], out["scores"], 0.0).max(axis=1) < 0.6).mean())


def _recall_bars(det, clutter_seed: int) -> Dict[str, Any]:
    """SCRFD's bars: recall and landmarks on the 32 held-out scenes, clutter."""
    scenes = heldout_scenes(HELDOUT_SEED, 32, 320, 48, 220)
    recall, lm_err, _ = best_faces(
        det.detect_batch_raw(np.stack([s[0] for s in scenes]).astype(np.float32)), scenes)
    quiet = clutter_quiet(det, clutter_seed)
    return {"recall": recall, "landmark_ied": lm_err, "clutter_quiet": quiet,
            "held": recall >= 0.9 and lm_err < 0.10 and quiet >= 0.9, "scenes": scenes}


def scrfd(device: Device = None) -> Dict[str, Any]:
    from .preprocessing.detector import FaceDetector

    det = FaceDetector(confidence_threshold=0.3, input_size=(320, 320), keep_top_k=1,
                       device=device)
    res = _recall_bars(det, HELDOUT_SEED + 1)
    img, boxes, _ = res.pop("scenes")[0]
    r = det.detect(img)
    contract = (r is not None and r["bbox"].shape == (4,) and r["landmarks"].shape == (5, 2)
                and 0.0 < r["confidence"] <= 1.0 and _iou(r["bbox"], boxes[0]) > 0.5)
    res["detect_contract"] = bool(contract)
    res["held"] = res["held"] and res["detect_contract"]
    return res


def lite(device: Device = None) -> Dict[str, Any]:
    from .preprocessing.detector import FaceDetector

    det = FaceDetector(model_name="lite", confidence_threshold=0.3, input_size=(320, 320),
                       keep_top_k=1, device=device)
    res = _recall_bars(det, HELDOUT_SEED + 11)
    res.pop("scenes")
    return res


def mtcnn(device: Device = None) -> Dict[str, Any]:
    from .preprocessing.detector import create_face_detector

    det = create_face_detector({"model": "mtcnn", "confidence_threshold": 0.3,
                                "scrfd": {"input_size": [160, 160]}}, device=device)
    scenes = heldout_scenes(HELDOUT_SEED + 7, 24, 160, 36, 110)
    recall, lm_err, _ = best_faces(det.detect_batch_raw(np.stack([s[0] for s in scenes])), scenes)
    return {"recall": recall, "landmark_ied": lm_err, "held": recall >= 0.85 and lm_err < 0.20}


def hog(device: Device = None) -> Dict[str, Any]:
    from .preprocessing.detector import create_face_detector

    return hog_bar(create_face_detector({"model": "hog", "scrfd": {"input_size": [320, 320]},
                                         "confidence_threshold": 0.5, "upsample": 1},
                                        device=device))


def hog_bar(det) -> Dict[str, Any]:
    """The HOG bar of any HOG detector (a fitted template too)."""
    from .data.synth_faces import render_scene

    scenes = heldout_scenes(HELDOUT_SEED, 32, 320, 48, 180)
    found = det.batch_detect([s[0] for s in scenes])
    recall = sum(r is not None and _iou(r["bbox"], s[1][0]) > 0.5
                 for r, s in zip(found, scenes)) / len(scenes)
    rng = np.random.default_rng(HELDOUT_SEED + 1)
    clutter = [render_scene(rng, size=320, p_empty=1.0)[0] for _ in range(30)]
    fired = sum(r is not None for r in det.batch_detect(clutter))
    return {"recall": recall, "clutter_fired": fired, "held": recall >= 0.9 and fired <= 6}


def refine(device: Device = None) -> Dict[str, Any]:
    from .preprocessing.detector import FaceDetector

    base = FaceDetector(confidence_threshold=0.3, input_size=(320, 320), device=device)
    casc = FaceDetector(confidence_threshold=0.3, input_size=(320, 320), refine=True,
                        refine_threshold=0.5, device=device)
    scenes = heldout_scenes(HELDOUT_SEED + 21, 24, 320, 48, 220)
    images = np.stack([s[0] for s in scenes]).astype(np.float32)
    _, _, iou_b = best_faces(base.detect_batch_raw(images), scenes)
    recall, lm_err, iou_c = best_faces(casc.detect_batch_raw(images), scenes)
    quiet = clutter_quiet(casc, HELDOUT_SEED + 22)
    return {"recall": recall, "landmark_ied": lm_err, "mean_iou": float(iou_c.mean()),
            "base_mean_iou": float(iou_b.mean()), "clutter_quiet": quiet,
            "held": (recall >= 0.9 and lm_err < 0.10 and iou_c.mean() >= iou_b.mean() - 0.01
                     and quiet >= 0.9)}


def packaged_contract(packaged: Dict[str, Any]) -> bool:
    """The packaged classifier's format: ``dfv-classifier-v1`` with params,
    batch_stats, a model config with a feature extractor and a face size
    the protocol trains at."""
    cfg = packaged.get("model_config")
    return bool(packaged.get("format") == "dfv-classifier-v1"
                and "params" in packaged and "batch_stats" in packaged
                and cfg and "feature_extractor" in cfg
                and int(packaged.get("face_size", 0)) in PACKAGED_FACE_SIZES)


def classifier(device: Device = None, per_class: int = CLASSIFIER_PER_CLASS,
               batch: int = 25) -> Dict[str, Any]:
    from .data.synth_faces import render_labeled_face
    from .device import resolve_device
    from .models.bridge import load_flax_variables
    from .models.feature_extractor import create_model_from_config
    from .ops.image import IMAGENET_MEAN, IMAGENET_STD
    from .ops.metrics import roc_auc
    from .preprocessing.detector import default_weights_path
    from .preprocessing.pipeline import PreprocessingPipeline
    from .utils.msgpack import msgpack_restore

    path = default_weights_path("classifier")
    if path is None:
        return {"weights": None, "held": False}
    packaged = msgpack_restore(path)
    if not packaged_contract(packaged):
        return {"weights": path, "packaged_contract": False, "held": False}
    face = int(packaged["face_size"])
    dev = resolve_device(device)

    rng = np.random.default_rng(CLASSIFIER_SEED)
    images, labels = [], []
    for label in (0, 1):
        for _ in range(per_class):
            images.append(render_labeled_face(rng, size=320, fake=bool(label))[0])
            labels.append(label)
    pipe = PreprocessingPipeline({
        "detection": {"method": "scrfd", "confidence_threshold": 0.3,
                      "scrfd": {"input_size": [320, 320]}},
        "alignment": {"output_size": [face, face]},
        "quality": {"enabled": False},
    }, device=dev)
    kept_imgs, kept_lms, kept_labels = [], [], []
    for i in range(0, len(images), batch):
        for out, lab in zip(pipe.process_batch(images[i:i + batch]), labels[i:i + batch]):
            if out.success:
                kept_imgs.append(np.asarray(out.aligned_face, np.float32))
                kept_lms.append(np.asarray(out.landmarks, np.float32))
                kept_labels.append(lab)
    n = len(kept_labels)

    model = create_model_from_config(packaged["model_config"])
    load_flax_variables(model, {"params": packaged["params"],
                                "batch_stats": packaged["batch_stats"]})
    model.to(dev).eval()
    mean, std = np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)
    probs: List[float] = []
    with torch.inference_mode():
        for i in range(0, n, batch):
            imgs = (np.clip(np.stack(kept_imgs[i:i + batch]), 0, 255) / 255.0 - mean) / std
            logits, _ = model(torch.as_tensor(imgs, dtype=torch.float32, device=dev),
                              torch.as_tensor(np.stack(kept_lms[i:i + batch]), device=dev))
            probs.extend(torch.softmax(logits.float(), dim=-1)[:, 1].cpu().tolist())
    auc = roc_auc(np.asarray(kept_labels), np.asarray(probs)) if n else float("nan")
    processed = n / len(images)
    return {"weights": path, "packaged_contract": True, "face_size": face, "processed": processed,
            "faces": n, "auc": auc,
            "held": processed >= CLASSIFIER_MIN_SUCCESS and auc >= CLASSIFIER_AUC_BAR}


FAMILIES: Dict[str, Callable[..., Dict[str, Any]]] = {
    "scrfd": scrfd, "lite": lite, "mtcnn": mtcnn, "hog": hog, "refine": refine,
    "classifier": classifier}


def run(model: str, device: Device = None) -> Dict[str, Any]:
    """The bars of one family, with ``model`` and the weights file read."""
    from .preprocessing.detector import default_weights_path

    if model not in FAMILIES:
        raise ValueError(f"unknown family {model!r}; expected one of {sorted(FAMILIES)}")
    res = FAMILIES[model](device)
    res["held"] = bool(res["held"])
    return {"model": model, "weights": default_weights_path(model), **res}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Acceptance bars of the committed weights")
    parser.add_argument("--model", required=True, choices=sorted(FAMILIES) + ["all"])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    held = True
    for model in sorted(FAMILIES) if args.model == "all" else [args.model]:
        res = run(model, args.device)
        held &= res["held"]
        print(json.dumps(res, default=float), flush=True)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
