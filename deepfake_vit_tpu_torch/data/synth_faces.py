"""Procedural face scenes with exact detection ground truth.

Counterpart of the JAX package's ``data/synth_faces.py``, a copy of its
numpy and ``cv2`` code: the same seed gives the same pixels, boxes and
landmarks, bit for bit. ``render_scene`` draws parametric faces (a
skin-tone head ellipse, eyes, brows, nose, mouth) over cluttered
backgrounds and returns the exact box and 5 landmarks of each;
``write_corpus`` writes scenes as PNGs with the annotation JSON that
``python -m deepfake_vit_tpu_torch.train_detector`` reads;
``render_labeled_face`` and ``write_classification_corpus`` draw single
faces, real or with a localized manipulation artifact near a landmark.

Landmark order is the aligner's: [left_eye, right_eye, nose, left_mouth,
right_mouth], (x, y) pixels.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def _rot(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]], np.float32)


def _rand_color(rng, lo=0, hi=255) -> Tuple[int, int, int]:
    return tuple(int(v) for v in rng.integers(lo, hi, 3))


def _skin_tone(rng) -> np.ndarray:
    """RGB skin tone across a broad range (light to dark)."""
    base = rng.uniform(0.35, 1.0)
    r = 230 * base + rng.normal(0, 8)
    g = 180 * base + rng.normal(0, 10)
    b = 150 * base + rng.normal(0, 12)
    return np.clip([r, g, b], 20, 255).astype(np.float32)


def _draw_background(img: np.ndarray, rng) -> None:
    import cv2

    H, W = img.shape[:2]
    # Low-frequency gradient base.
    base = np.asarray(_rand_color(rng, 20, 235), np.float32)
    gx = rng.normal(0, 0.3, 3)
    gy = rng.normal(0, 0.3, 3)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for c in range(3):
        img[..., c] = np.clip(base[c] + gx[c] * xs + gy[c] * ys, 0, 255)
    # Clutter: rectangles, circles, lines (possible false-positive bait —
    # including skin-colored ellipses WITHOUT facial features).
    for _ in range(int(rng.integers(4, 12))):
        kind = rng.integers(0, 4)
        color = _rand_color(rng) if kind != 3 else tuple(int(v) for v in _skin_tone(rng))
        p1 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
        if kind == 0:
            p2 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            cv2.rectangle(img, p1, p2, color, -1)
        elif kind == 1:
            cv2.circle(img, p1, int(rng.integers(5, W // 4)), color, -1)
        elif kind == 2:
            p2 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            cv2.line(img, p1, p2, color, int(rng.integers(1, 8)))
        else:
            axes = (int(rng.integers(10, W // 4)), int(rng.integers(10, H // 4)))
            cv2.ellipse(img, p1, axes, float(rng.uniform(0, 180)), 0, 360, color, -1)


def _draw_face(
    img: np.ndarray, rng, center: np.ndarray, half_w: float, theta: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw one face; returns (bbox xyxy, landmarks (5,2))."""
    import cv2

    half_h = half_w * rng.uniform(1.15, 1.4)
    R = _rot(theta)
    skin = _skin_tone(rng)
    deg = float(np.degrees(theta))

    def to_img(pts_face: np.ndarray) -> np.ndarray:
        """Face-frame (x right, y down; unit = pixels) → image coords."""
        return (pts_face @ R.T) + center

    # Head.
    cv2.ellipse(
        img, tuple(int(v) for v in center), (int(half_w), int(half_h)), deg,
        0, 360, tuple(float(v) for v in skin), -1, cv2.LINE_AA,
    )
    # Subtle shading ellipse (lighting variation).
    shade = np.clip(skin * rng.uniform(0.82, 0.95), 0, 255)
    off = to_img(np.array([[rng.uniform(-0.3, 0.3) * half_w, rng.uniform(-0.2, 0.2) * half_h]], np.float32))[0]
    cv2.ellipse(
        img, tuple(int(v) for v in off), (int(half_w * 0.8), int(half_h * 0.8)),
        deg, 200, 340, tuple(float(v) for v in shade), int(max(2, half_w * 0.08)), cv2.LINE_AA,
    )

    ex, ey = 0.42 * half_w, -0.28 * half_h
    eye_r = max(2.0, 0.16 * half_w)
    nose = np.array([0.0, 0.22 * half_h], np.float32)
    mouth_y = 0.55 * half_h
    mouth_hw = 0.32 * half_w

    # Eyes: sclera + iris.
    for sx in (-1, 1):
        e = to_img(np.array([[sx * ex, ey]], np.float32))[0]
        cv2.ellipse(
            img, tuple(int(v) for v in e), (int(eye_r * 1.35), int(eye_r * 0.85)),
            deg, 0, 360, (245, 245, 245), -1, cv2.LINE_AA,
        )
        iris = np.clip(np.asarray(_rand_color(rng, 10, 120), np.float32), 0, 255)
        cv2.circle(img, tuple(int(v) for v in e), int(eye_r * 0.55),
                   tuple(float(v) for v in iris), -1, cv2.LINE_AA)
        # Brow.
        b1 = to_img(np.array([[sx * ex - eye_r, ey - eye_r * 1.6]], np.float32))[0]
        b2 = to_img(np.array([[sx * ex + eye_r, ey - eye_r * 1.9]], np.float32))[0]
        cv2.line(img, tuple(int(v) for v in b1), tuple(int(v) for v in b2),
                 (40, 30, 25), max(1, int(eye_r * 0.35)), cv2.LINE_AA)

    # Nose: bridge line + nostrils.
    n_top = to_img(np.array([[0.0, -0.05 * half_h]], np.float32))[0]
    n_tip = to_img(nose[None])[0]
    dark_skin = tuple(float(v) for v in np.clip(skin * 0.75, 0, 255))
    cv2.line(img, tuple(int(v) for v in n_top), tuple(int(v) for v in n_tip),
             dark_skin, max(1, int(half_w * 0.07)), cv2.LINE_AA)
    for sx in (-1, 1):
        nst = to_img(np.array([[sx * 0.1 * half_w, 0.26 * half_h]], np.float32))[0]
        cv2.circle(img, tuple(int(v) for v in nst), max(1, int(half_w * 0.045)),
                   (60, 40, 35), -1, cv2.LINE_AA)

    # Mouth.
    m = to_img(np.array([[0.0, mouth_y]], np.float32))[0]
    lip = (float(rng.uniform(120, 200)), float(rng.uniform(30, 80)), float(rng.uniform(40, 90)))
    cv2.ellipse(img, tuple(int(v) for v in m), (int(mouth_hw), int(max(2, mouth_hw * 0.35))),
                deg, 0, 360, lip, -1, cv2.LINE_AA)

    # Ground truth.
    lms_face = np.array(
        [
            [-ex, ey],                 # left eye
            [ex, ey],                  # right eye
            [nose[0], nose[1]],        # nose tip
            [-mouth_hw * 0.85, mouth_y],  # left mouth corner
            [mouth_hw * 0.85, mouth_y],   # right mouth corner
        ],
        np.float32,
    )
    lms = to_img(lms_face)
    # Tight bbox of the rotated head ellipse.
    bx = np.sqrt((half_w * np.cos(theta)) ** 2 + (half_h * np.sin(theta)) ** 2)
    by = np.sqrt((half_w * np.sin(theta)) ** 2 + (half_h * np.cos(theta)) ** 2)
    bbox = np.array(
        [center[0] - bx, center[1] - by, center[0] + bx, center[1] + by], np.float32
    )
    return bbox, lms


def render_scene(
    rng,
    size: int = 320,
    max_faces: int = 3,
    min_face: int = 28,
    max_face: int = 150,
    p_empty: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One training scene.

    Returns (image uint8 (size,size,3) RGB, boxes (G,4) xyxy, kps (G,5,2));
    G varies 0..max_faces. ``min_face``/``max_face`` bound the head
    half-width in pixels, spanning all three SCRFD stride ranges.
    """
    import cv2

    img = np.zeros((size, size, 3), np.float32)
    _draw_background(img, rng)

    boxes: List[np.ndarray] = []
    lms: List[np.ndarray] = []
    if rng.uniform() >= p_empty:
        n_faces = int(rng.integers(1, max_faces + 1))
        placed: List[Tuple[np.ndarray, float]] = []
        for _ in range(n_faces):
            for _attempt in range(20):
                # log-uniform face size → balanced coverage of stride levels
                half_w = float(np.exp(rng.uniform(np.log(min_face / 2), np.log(max_face / 2))))
                margin = half_w * 1.5
                if size - margin <= margin:
                    continue
                center = rng.uniform(margin, size - margin, 2).astype(np.float32)
                if all(
                    np.linalg.norm(center - c) > (half_w + r) * 1.6 for c, r in placed
                ):
                    theta = float(rng.uniform(-0.45, 0.45))  # ±26°
                    bbox, lm = _draw_face(img, rng, center, half_w, theta)
                    boxes.append(bbox)
                    lms.append(lm)
                    placed.append((center, half_w))
                    break

    # Global lighting + sensor noise + occasional blur.
    img *= rng.uniform(0.6, 1.15)
    img += rng.normal(0, rng.uniform(2, 10), img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if rng.uniform() < 0.25:
        k = int(rng.integers(1, 3)) * 2 + 1
        img = cv2.GaussianBlur(img, (k, k), 0)

    G = len(boxes)
    return (
        img,
        np.stack(boxes) if G else np.zeros((0, 4), np.float32),
        np.stack(lms) if G else np.zeros((0, 5, 2), np.float32),
    )


def write_corpus(
    out_dir, n: int, size: int = 320, seed: int = 0, max_faces: int = 3
) -> str:
    """Render ``n`` scenes to PNG + a train_detector.py annotations JSON.

    Returns the annotation file path.
    """
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    records: List[Dict] = []
    for i in range(n):
        img, boxes, kps = render_scene(rng, size=size, max_faces=max_faces)
        path = out_dir / f"scene_{i:06d}.png"
        cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        records.append(
            {
                "image": str(path),
                "boxes": boxes.tolist(),
                "landmarks": kps.tolist(),
            }
        )
    ann = out_dir / "annotations.json"
    with open(ann, "w") as f:
        json.dump(records, f)
    return str(ann)


# ---------------------------------------------------------------------------
# Classification corpus: real vs *manipulated* faces. Fakes are the rendered
# face with a localized deepfake-style artifact — a rescaled-and-reblended
# mouth/eye patch (blend seam), a smoothed landmark region (GAN blur), or a
# face-interior color shift with a visible blend boundary. Artifacts sit at
# landmark regions by construction, so landmark attention should help.
# ---------------------------------------------------------------------------


def _apply_manipulation(img: np.ndarray, lms: np.ndarray, bbox: np.ndarray, rng) -> np.ndarray:
    """One localized artifact near a landmark region; subtle but learnable."""
    import cv2

    H, W = img.shape[:2]
    out = img.astype(np.float32)
    kind = int(rng.integers(0, 3))
    # Pick an anchor landmark region: eyes, nose, or mouth (midpoint of corners).
    region = int(rng.integers(0, 4))
    if region < 2:
        cx, cy = lms[region]
    elif region == 2:
        cx, cy = lms[2]
    else:
        cx, cy = (lms[3] + lms[4]) / 2.0
    face_w = float(bbox[2] - bbox[0])
    r = max(6, int(face_w * rng.uniform(0.14, 0.24)))
    x1, y1 = int(max(0, cx - r)), int(max(0, cy - r))
    x2, y2 = int(min(W, cx + r)), int(min(H, cy + r))
    if x2 - x1 < 4 or y2 - y1 < 4:
        return img
    patch = out[y1:y2, x1:x2].copy()

    if kind == 0:
        # Rescale-and-reblend: the patch is zoomed and alpha-blended back
        # with a soft-edged mask → geometry mismatch + seam.
        zoom = rng.uniform(1.18, 1.45)
        zh, zw = int(patch.shape[0] * zoom), int(patch.shape[1] * zoom)
        big = cv2.resize(patch, (zw, zh), interpolation=cv2.INTER_LINEAR)
        oy, ox = (zh - patch.shape[0]) // 2, (zw - patch.shape[1]) // 2
        rep = big[oy : oy + patch.shape[0], ox : ox + patch.shape[1]]
        mask = np.zeros(patch.shape[:2], np.float32)
        cv2.circle(mask, (patch.shape[1] // 2, patch.shape[0] // 2),
                   int(min(patch.shape[:2]) * 0.45), 1.0, -1)
        mask = cv2.GaussianBlur(mask, (7, 7), 0)[..., None]
        out[y1:y2, x1:x2] = patch * (1 - mask) + rep * mask
    elif kind == 1:
        # Over-smoothed region (GAN-style loss of high frequency).
        k = int(rng.integers(3, 6)) * 2 + 1
        sm = cv2.GaussianBlur(patch, (k, k), 0)
        mask = np.zeros(patch.shape[:2], np.float32)
        cv2.circle(mask, (patch.shape[1] // 2, patch.shape[0] // 2),
                   int(min(patch.shape[:2]) * 0.48), 1.0, -1)
        mask = cv2.GaussianBlur(mask, (9, 9), 0)[..., None]
        out[y1:y2, x1:x2] = patch * (1 - mask) + sm * mask
    else:
        # Color-transfer mismatch with a blend boundary.
        shift = rng.normal(0, 26, 3).astype(np.float32)
        gain = rng.uniform(0.75, 1.28)
        rep = np.clip(patch * gain + shift, 0, 255)
        mask = np.zeros(patch.shape[:2], np.float32)
        cv2.ellipse(mask, (patch.shape[1] // 2, patch.shape[0] // 2),
                    (int(patch.shape[1] * 0.42), int(patch.shape[0] * 0.42)),
                    0, 0, 360, 1.0, -1)
        mask = cv2.GaussianBlur(mask, (5, 5), 0)[..., None]
        out[y1:y2, x1:x2] = patch * (1 - mask) + rep * mask

    return np.clip(out, 0, 255).astype(np.uint8)


def render_labeled_face(
    rng, size: int = 320, fake: bool = False, min_face: int = 90, max_face: int = 240
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One single-face scene, optionally manipulated.

    Returns (image uint8, bbox (4,), landmarks (5,2)). Fake scenes get 1–2
    localized artifacts at landmark regions.
    """
    while True:
        img, boxes, lms = render_scene(
            rng, size=size, max_faces=1, min_face=min_face, max_face=max_face, p_empty=0.0
        )
        if len(boxes):
            break
    bbox, lm = boxes[0], lms[0]
    if fake:
        for _ in range(int(rng.integers(2, 4))):
            img = _apply_manipulation(img, lm, bbox, rng)
    return img, bbox, lm


def write_classification_corpus(
    out_dir, n_per_class: int, size: int = 320, seed: int = 0
) -> str:
    """GenAI-layout raw corpus (real/ + fake/ dirs of PNGs) consumable by
    the preprocessing script (the full detect → align → train path).
    Returns ``out_dir``."""
    import cv2

    out_dir = Path(out_dir)
    rng = np.random.default_rng(seed)
    for label in ("real", "fake"):
        d = out_dir / label
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n_per_class):
            img, _, _ = render_labeled_face(rng, size=size, fake=label == "fake")
            cv2.imwrite(str(d / f"{label}_{i:05d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return str(out_dir)
