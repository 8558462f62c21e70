"""Write a synthetic processed directory for the train and evaluate CLIs.

    python -m deepfake_vit_tpu_torch.tools.synth_processed --out DIR
        [--train 128] [--val 32] [--test 32] [--size 224] [--seed 0]

The layout ``scripts/preprocess_dataset.py`` writes: ``faces/``,
``landmarks/`` (5×2 float32 at the reference layout, jittered) and
``splits/{train,val,test}.csv``. Faces are PNGs (written with ``cv2``) of
RGB noise over a colour gradient; the fake ones (every other face) get a
red cast, a cue a classifier learns in a few steps.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

# The aligner's reference layout (fractions of the face size).
REFERENCE = np.asarray([[0.31, 0.32], [0.69, 0.32], [0.5, 0.55], [0.35, 0.75], [0.65, 0.75]],
                       np.float32)
HEADER = "image_id,dataset,label,processed,face_path,landmark_path,metadata_path,quality_score\n"


def write_processed(out: Path, counts=(128, 32, 32), size: int = 224, seed: int = 0) -> Path:
    import cv2

    rng = np.random.default_rng(seed)
    for d in ("faces", "landmarks", "splits"):
        (out / d).mkdir(parents=True, exist_ok=True)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    k = 0
    for split, n in zip(("train", "val", "test"), counts):
        rows = [HEADER]
        for i in range(n):
            fake = i % 2
            base, g = rng.uniform(40, 200, 3), rng.normal(0, 0.2, (2, 3))
            img = base + g[0] * xs[..., None] + g[1] * ys[..., None]
            img = img + rng.normal(0, 12, img.shape)
            img[..., 0] += 40.0 * fake
            rgb = np.clip(img, 0, 255).astype(np.uint8)
            name = f"synth_{k:06d}"
            face = f"faces/{name}.png"
            cv2.imwrite(str(out / face), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
            lms = REFERENCE * size + rng.normal(0, 1.5, (5, 2)).astype(np.float32)
            np.save(out / "landmarks" / f"{name}.npy", lms.astype(np.float32))
            rows.append(f"{name},synth,{('real', 'fake')[fake]},True,{face},"
                        f"landmarks/{name}.npy,,{rng.uniform(0.5, 1.0):.4f}\n")
            k += 1
        (out / "splits" / f"{split}.csv").write_text("".join(rows))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--train", type=int, default=128)
    parser.add_argument("--val", type=int, default=32)
    parser.add_argument("--test", type=int, default=32)
    parser.add_argument("--size", type=int, default=224)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    write_processed(Path(args.out), (args.train, args.val, args.test), args.size, args.seed)
    print(f"wrote {args.train + args.val + args.test} faces under {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
