"""Train a face detector.

    python -m deepfake_vit_tpu_torch.train_detector (--annotations ANN.json | --synthetic N)
        [--model scrfd|mtcnn|lite|hog|refine] [--save OUT.msgpack] [--input-size 320]
        [--batch-size 32] [--epochs 50] [--lr 1e-3] [--max-faces 8] [--resume W.msgpack]
        [--save-every 10] [--seed 42] [--kps-weight 2.0] [--domain-aug P]
        [--synthetic-dir DIR] [--device cuda|cpu]

The flags of the JAX package's ``scripts/train_detector.py``, plus
``--device`` (the card unless ``cpu`` is given). Annotations are a JSON
list of ``{"image": path, "boxes": [[x1, y1, x2, y2], ...], "landmarks":
[[[x, y] × 5], ...]}`` in image pixels; images are letterboxed to
``--input-size`` and ground truths padded to ``--max-faces``.
``--synthetic N`` draws N scenes (``data/synth_faces.py::write_corpus``)
into ``--synthetic-dir`` and trains on them (reused when enough are
there). ``--domain-aug P`` applies, with probability P per image, one of
``data/domain_shift.py``'s photometric shifts or its safe clutter.

The anchor-head families (scrfd, mtcnn, lite) train with AdamW (clip
5.0) on the detection loss; ``refine`` trains the cascade's second stage
on crops sampled around the ground truth; ``hog`` fits the linear
template (``fit_hog_template`` on ``--synthetic`` or 400 scenes). The
weights are written as flax-layout msgpack (``--save``, atomically, also
every ``--save-every`` epochs), which both packages' ``FaceDetector``
load; ``--resume`` continues from such a file. ``--save`` may not point
inside ``deepfake_vit_tpu/weights/``: the committed weights are promoted
there only after their acceptance tests pass.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

log = logging.getLogger("train_detector")


def shipped_weights_dir() -> Path:
    """The directory of the committed weights."""
    return Path(__file__).resolve().parents[1] / "deepfake_vit_tpu" / "weights"


def save_targets_shipped_dir(save_path: str) -> bool:
    """True if ``save_path`` lies inside ``deepfake_vit_tpu/weights/``."""
    try:
        resolved = Path(save_path).resolve()
    except OSError:
        return False
    shipped = shipped_weights_dir()
    return resolved == shipped or shipped in resolved.parents


def load_annotations(path) -> list:
    with open(path) as f:
        return json.load(f)


def make_batch(records, indices, input_size: int, max_faces: int, domain_aug: float = 0.0,
               aug_rng=None) -> dict:
    """Letterboxed (B, S, S, 3) float32 RGB images with their boxes, kps
    and validity, ground truths scaled with the image."""
    import cv2

    B = len(indices)
    images = np.zeros((B, input_size, input_size, 3), np.float32)
    boxes = np.zeros((B, max_faces, 4), np.float32)
    kps = np.zeros((B, max_faces, 5, 2), np.float32)
    valid = np.zeros((B, max_faces), np.float32)
    for i, idx in enumerate(indices):
        rec = records[int(idx)]
        bgr = cv2.imread(rec["image"])
        if bgr is None:
            continue
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if domain_aug and aug_rng is not None and aug_rng.uniform() < domain_aug:
            from .data.domain_shift import SHIFTS, augment_clutter

            choices = list(SHIFTS) + ["clutter"]
            shift = choices[int(aug_rng.integers(len(choices)))]
            if shift == "clutter":
                gt = np.asarray(rec.get("boxes", []), np.float32).reshape(-1, 4)
                rgb = augment_clutter(rgb, gt, aug_rng)
            else:
                rgb = SHIFTS[shift](rgb, aug_rng)
        h, w = rgb.shape[:2]
        scale = min(input_size / w, input_size / h)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        images[i, :nh, :nw] = cv2.resize(rgb, (nw, nh), interpolation=cv2.INTER_LINEAR)
        for g, box in enumerate(rec.get("boxes", [])[:max_faces]):
            boxes[i, g] = np.asarray(box, np.float32) * scale
            lms = rec.get("landmarks")
            if lms and g < len(lms):
                kps[i, g] = np.asarray(lms[g], np.float32) * scale
            valid[i, g] = 1.0
    return {"image": images, "boxes": boxes, "kps": kps, "valid": valid}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train a face detector (PyTorch port)")
    p.add_argument("--annotations", type=str, default=None, help="JSON annotation file")
    p.add_argument("--synthetic", type=int, default=0,
                   help="draw N procedural scenes and train on them instead of --annotations")
    p.add_argument("--synthetic-dir", type=str, default="data/synth_faces")
    p.add_argument("--save", type=str, default="checkpoints/detector.msgpack")
    p.add_argument("--input-size", type=int, default=320)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--model", type=str, default="scrfd",
                   choices=("scrfd", "mtcnn", "hog", "lite", "refine"))
    p.add_argument("--resume", type=str, default=None, help="msgpack weights to continue from")
    p.add_argument("--max-faces", type=int, default=8)
    p.add_argument("--save-every", type=int, default=10,
                   help="also write --save every N epochs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--kps-weight", type=float, default=2.0,
                   help="refine only: the landmark loss's weight")
    p.add_argument("--domain-aug", type=float, default=0.0,
                   help="probability of a photometric shift or safe clutter per image")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return p, p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    parser, args = parse_args(argv)
    if not args.annotations and not args.synthetic:
        parser.error("one of --annotations or --synthetic is required")
    if save_targets_shipped_dir(args.save):
        parser.error(f"--save must not point inside the committed weights directory "
                     f"({shipped_weights_dir()}): train to a staging path and promote "
                     "weights only after their acceptance tests pass")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    from .device import resolve_device
    from .models.bridge import export_flax_variables, load_flax_variables
    from .models.layers import init_weights
    from .preprocessing.detector import build_detection_net
    from .training import create_optimizer
    from .training.detection import make_detector_train_step
    from .utils.msgpack import msgpack_restore, msgpack_serialize

    device = resolve_device(args.device)
    out = Path(args.save)
    if args.model == "hog":
        from .models.hog_detector import HogFaceDetector, fit_hog_template

        n = args.synthetic or 400
        log.info(f"fitting the HOG template on {n} drawn scenes on {device}")
        params = fit_hog_template(n_scenes=n, scene_size=args.input_size, seed=args.seed,
                                  log=log.info, device=device)
        out.parent.mkdir(parents=True, exist_ok=True)
        HogFaceDetector(input_size=(args.input_size, args.input_size), params=params,
                        pretrained=False, device=device).save_weights(str(out))
        log.info(f"saved the HOG template -> {out}")
        return 0

    if args.synthetic:
        from .data.synth_faces import write_corpus

        ann_path = Path(args.synthetic_dir) / "annotations.json"
        existing = load_annotations(ann_path) if ann_path.exists() else []
        if len(existing) >= args.synthetic:
            log.info(f"reusing {len(existing)} drawn scenes in {args.synthetic_dir}")
        else:
            log.info(f"drawing {args.synthetic} scenes -> {args.synthetic_dir}")
            write_corpus(args.synthetic_dir, args.synthetic, size=args.input_size,
                         seed=args.seed, max_faces=args.max_faces)
        args.annotations = str(ann_path)

    records = load_annotations(args.annotations)
    log.info(f"{len(records)} annotated images; device {device}")
    size = (args.input_size, args.input_size)
    if args.model == "refine":
        from .models.refine_net import RefineNet
        from .training.refinement import make_refiner_train_step, sample_refine_targets

        model = RefineNet()
    else:
        model = build_detection_net(args.model)
    model = init_weights(model, args.seed).to(device)
    if args.resume:
        load_flax_variables(model, msgpack_restore(args.resume))
        log.info(f"resumed the detector weights from {args.resume}")
    optimizer = create_optimizer(model.parameters(), {"type": "AdamW", "lr": args.lr},
                                 gradient_clip=5.0)
    if args.model == "refine":
        step = make_refiner_train_step(model, optimizer, kps_weight=args.kps_weight)
    else:
        step = make_detector_train_step(model, optimizer, size)
    out.parent.mkdir(parents=True, exist_ok=True)

    def save() -> None:
        tmp = out.with_suffix(out.suffix + ".tmp")
        with open(tmp, "wb") as f:
            f.write(msgpack_serialize(export_flax_variables(model)))
        tmp.replace(out)

    rng = np.random.default_rng(args.seed)
    n = len(records)
    steps_per_epoch = max(n // args.batch_size, 1)
    for epoch in range(args.epochs):
        order = rng.permutation(n)
        t0 = time.perf_counter()
        losses = []
        for s in range(steps_per_epoch):
            idx = order[s * args.batch_size: (s + 1) * args.batch_size]
            if len(idx) < args.batch_size:
                break
            batch = make_batch(records, idx, args.input_size, args.max_faces,
                               domain_aug=args.domain_aug, aug_rng=rng)
            if args.model == "refine":
                batch = sample_refine_targets(batch, rng)
            losses.append(step(batch))
        m = {k: float(np.mean([float(x[k]) for x in losses])) for k in
             ("total", "cls", "box", "kps")} if losses else {}
        log.info(f"[epoch {epoch + 1}/{args.epochs}] "
                 + " ".join(f"{k}={v:.4f}" for k, v in m.items())
                 + f" ({time.perf_counter() - t0:.1f}s)")
        if args.save_every and (epoch + 1) % args.save_every == 0:
            save()
            log.info(f"checkpointed the detector weights -> {out}")
    save()
    log.info(f"saved the detector weights -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
