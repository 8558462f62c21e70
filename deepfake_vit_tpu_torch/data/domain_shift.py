"""Shifted-domain perturbations of the procedural scenes.

Counterpart of the JAX package's ``data/domain_shift.py``, a copy of its
numpy and ``cv2`` code (bit for bit from the same seed). Every detector
family is trained on ``synth_faces``; these perturbations give statistics
the training corpus never emits, applied after rendering so the ground
truth stays exact:

- ``low_light`` / ``overexposed``: a global gain outside the training
  range [0.6, 1.15], with clipping;
- ``color_cast``: one channel boosted, one suppressed (training gains are
  scalar);
- ``heavy_noise``: sensor noise σ in [18, 30] (training: [2, 10]);
- ``jpeg``: a quality 12-17 JPEG round trip;
- ``texture_background`` (``render_shifted_scene`` only): the face over a
  checkerboard and dense clutter.

``augment_clutter`` is the train-only augmentation of
``train_detector --domain-aug``: clutter drawn around the ground-truth
boxes, never over them. It is not in ``SHIFTS``, which stay disjoint from
anything trained on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from .synth_faces import _rand_color, _skin_tone, render_scene


def _low_light(img: np.ndarray, rng) -> np.ndarray:
    gain = rng.uniform(0.35, 0.5)
    return np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)


def _overexposed(img: np.ndarray, rng) -> np.ndarray:
    gain = rng.uniform(1.45, 1.75)
    return np.clip(img.astype(np.float32) * gain, 0, 255).astype(np.uint8)


def _color_cast(img: np.ndarray, rng) -> np.ndarray:
    # One channel boosted, one suppressed — never emitted by the scalar
    # training gain.
    gains = np.ones(3, np.float32)
    hot, cold = rng.choice(3, size=2, replace=False)
    gains[hot] = rng.uniform(1.25, 1.5)
    gains[cold] = rng.uniform(0.55, 0.75)
    return np.clip(img.astype(np.float32) * gains, 0, 255).astype(np.uint8)


def _heavy_noise(img: np.ndarray, rng) -> np.ndarray:
    sigma = rng.uniform(18, 30)
    noisy = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _jpeg(img: np.ndarray, rng) -> np.ndarray:
    import cv2

    quality = int(rng.integers(12, 18))
    ok, buf = cv2.imencode(".jpg", img[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    assert ok
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]


SHIFTS: Dict[str, Callable[[np.ndarray, np.random.Generator], np.ndarray]] = {
    "low_light": _low_light,
    "overexposed": _overexposed,
    "color_cast": _color_cast,
    "heavy_noise": _heavy_noise,
    "jpeg": _jpeg,
}


def augment_clutter(img: np.ndarray, boxes: np.ndarray, rng) -> np.ndarray:
    """Train-only augmentation: dense high-frequency clutter drawn AROUND
    the ground-truth boxes (never over them, so labels stay exact).

    Not part of :data:`SHIFTS` — evaluation shifts must stay disjoint from
    anything trained on, or the suite would measure memorization. Targets
    the ``texture_background`` shift's weakness by teaching
    the detector that busy high-frequency surroundings are not faces.
    """
    import cv2

    out = img.astype(np.float32).copy()
    H, W = out.shape[:2]
    for _ in range(int(rng.integers(25, 60))):
        kind = rng.integers(0, 3)
        color = (_rand_color(rng) if kind != 2
                 else tuple(int(v) for v in _skin_tone(rng)))
        cx, cy = int(rng.integers(0, W)), int(rng.integers(0, H))
        r = int(rng.integers(3, max(4, W // 10)))
        # Skip shapes whose bounding square intersects any gt box.
        if any(cx + r > b[0] and cx - r < b[2] and cy + r > b[1] and cy - r < b[3]
               for b in boxes):
            continue
        if kind == 0:
            cv2.rectangle(out, (cx - r, cy - r), (cx + r, cy + r), color,
                          int(rng.integers(1, 4)))
        elif kind == 1:
            cv2.circle(out, (cx, cy), r, color, int(rng.integers(1, 4)))
        else:
            cv2.ellipse(out, (cx, cy), (r, max(2, r // 2)),
                        float(rng.uniform(0, 180)), 0, 360, color, -1)
    return np.clip(out, 0, 255).astype(img.dtype)


def _texture_background(size: int, rng) -> np.ndarray:
    """High-frequency checkerboard + dense clutter — statistics far from
    the training corpus's smooth-gradient backgrounds."""
    import cv2

    cell = int(rng.integers(4, 12))
    ys, xs = np.mgrid[0:size, 0:size]
    checker = (((ys // cell) + (xs // cell)) % 2).astype(np.float32)
    a = np.asarray(_rand_color(rng, 10, 120), np.float32)
    b = np.asarray(_rand_color(rng, 130, 245), np.float32)
    img = checker[..., None] * a + (1 - checker[..., None]) * b
    for _ in range(int(rng.integers(40, 80))):
        kind = rng.integers(0, 3)
        color = (_rand_color(rng) if kind != 2
                 else tuple(int(v) for v in _skin_tone(rng)))
        p1 = (int(rng.integers(0, size)), int(rng.integers(0, size)))
        if kind == 0:
            p2 = (int(rng.integers(0, size)), int(rng.integers(0, size)))
            cv2.rectangle(img, p1, p2, color, int(rng.integers(1, 4)))
        elif kind == 1:
            cv2.circle(img, p1, int(rng.integers(3, size // 8)), color,
                       int(rng.integers(1, 4)))
        else:
            axes = (int(rng.integers(5, size // 6)), int(rng.integers(5, size // 6)))
            cv2.ellipse(img, p1, axes, float(rng.uniform(0, 180)), 0, 360,
                        color, -1)
    return np.clip(img, 0, 255)


def render_shifted_scene(
    rng,
    shift: str,
    size: int = 320,
    min_face: int = 48,
    max_face: int = 220,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One single-face scene under a named domain shift.

    ``texture_background`` re-renders the face over a hostile background;
    photometric shifts post-process the standard rendering. Ground truth
    is exact in both cases.
    """
    if shift == "texture_background":
        from .synth_faces import _draw_face

        img = _texture_background(size, rng)
        # Resample until the face (with its placement margin) fits — same
        # guard as render_scene's placement loop.
        while True:
            half_w = float(np.exp(rng.uniform(np.log(min_face / 2),
                                              np.log(max_face / 2))))
            margin = half_w * 1.5
            if size - margin > margin:
                break
        center = rng.uniform(margin, size - margin, 2).astype(np.float32)
        theta = float(rng.uniform(-0.45, 0.45))
        bbox, lm = _draw_face(img, rng, center, half_w, theta)
        img = np.clip(img, 0, 255).astype(np.uint8)
        return img, bbox[None], lm[None]

    img, boxes, kps = render_scene(
        rng, size=size, max_faces=1, min_face=min_face, max_face=max_face,
        p_empty=0.0,
    )
    if not len(boxes):
        return img, boxes, kps
    return SHIFTS[shift](img, rng), boxes, kps


def shifted_scene_batch(
    shift: str, n: int, seed: int, size: int = 320,
    min_face: int = 48, max_face: int = 220,
) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """n single-face shifted scenes (images stacked, per-scene gt lists)."""
    rng = np.random.default_rng(seed)
    imgs, bs, ks = [], [], []
    while len(imgs) < n:
        img, boxes, kps = render_shifted_scene(
            rng, shift, size=size, min_face=min_face, max_face=max_face
        )
        if len(boxes):
            imgs.append(img)
            bs.append(boxes[0])
            ks.append(kps[0])
    return np.stack(imgs), bs, ks
