"""Inputs drawn from the seed: serving frames with drawn faces, and aligned
faces with their landmarks and labels (on which the weights' BatchNorm
statistics are set).

The per-face draws (sizes, positions, colours) come from a numpy generator
seeded with (seed, stream); the frames are painted on the device, a chunk
of frames at a time, and the sensor noise comes from a generator on the
device. The same seed gives the same inputs.

A drawn face is an ellipse of skin with sclera, iris and brow ellipses at
the eyes, a nose ridge, nostrils and a mouth, on a colour gradient (the
faces ``chip_smoke.py::drawn_face_frames`` draws, which the committed
detector finds with confidence near 1).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .reference.align import REFERENCE_LANDMARKS

CHUNK = 16


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def _face_layers(rng, n, cx, cy, hw, hh):
    """(cx, cy, ax, ay, rgb) ellipses of n faces, back to front, each (n,)
    or (n, 3)."""
    skin = np.asarray([230.0, 180.0, 150.0]) * rng.uniform(0.5, 1.0, (n, 1))
    iris = rng.uniform(10, 120, (n, 2, 3))
    lips = np.stack([rng.uniform(120, 200, n), rng.uniform(30, 80, n), rng.uniform(40, 90, n)], 1)
    er = np.maximum(2.0, 0.16 * hw)
    const = lambda v: np.broadcast_to(np.asarray(v, np.float64), (n, 3))  # noqa: E731
    layers = [(cx, cy, hw, hh, skin)]
    for k, side in enumerate((-1, 1)):
        ex, ey = cx + side * 0.42 * hw, cy - 0.28 * hh
        layers += [(ex, ey, er * 1.35, er * 0.85, const((245, 245, 245))),
                   (ex, ey, er * 0.55, er * 0.55, iris[:, k]),
                   (ex, ey - 1.75 * er, er, np.maximum(1.0, 0.2 * er), const((40, 30, 25)))]
    layers.append((cx, cy + 0.085 * hh, np.maximum(1.0, 0.035 * hw), 0.135 * hh, skin * 0.75))
    for side in (-1, 1):
        r = np.maximum(1.0, 0.045 * hw)
        layers.append((cx + side * 0.1 * hw, cy + 0.26 * hh, r, r, const((60, 40, 35))))
    layers.append((cx, cy + 0.55 * hh, 0.32 * hw, np.maximum(2.0, 0.11 * hw), lips))
    return layers


def _paint(base, gx, gy, faces, size, noise_std, gen, device) -> torch.Tensor:
    """uint8 (n, H, W, 3): the gradients, then every face's layers, then
    noise. ``faces``: per face slot a list of layers over the n frames."""
    H, W = size
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    img = (t(base)[:, None, None, :] + t(gx)[:, None, None, :] * xs[None, ..., None]
           + t(gy)[:, None, None, :] * ys[None, ..., None]).clamp(0, 255)
    for layers in faces:
        for cx, cy, ax, ay, rgb in layers:
            inside = (((xs - t(cx)[:, None, None]) / t(ax)[:, None, None]) ** 2
                      + ((ys - t(cy)[:, None, None]) / t(ay)[:, None, None]) ** 2) <= 1.0
            img = torch.where(inside[..., None], t(rgb)[:, None, None, :], img)
    img = img + noise_std * torch.randn(img.shape, generator=gen, device=device)
    return img.clamp(0, 255).to(torch.uint8)


def face_frames(n: int, size: Sequence[int], seed: int, device, faces: int = 1,
                half_width: Tuple[float, float] = (0.08, 0.22),
                noise_std: float = 4.0) -> torch.Tensor:
    """(n, H, W, 3) uint8 frames, ``faces`` faces each: a face's half-width
    is U(half_width) of the shorter side, its height 1.15–1.4× that, at a
    random place inside the frame's vertical band of that face slot."""
    H, W = size
    rng = _rng(seed, 0)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 62) + 1)
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    band = W / faces
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        base, gx, gy = (rng.uniform(40, 200, (m, 3)), rng.normal(0, 0.1, (m, 3)),
                        rng.normal(0, 0.1, (m, 3)))
        slots = []
        for k in range(faces):
            hw = rng.uniform(*half_width, m) * min(H, W)
            hw = np.minimum(hw, band / 3.4)
            hh = hw * rng.uniform(1.15, 1.4, m)
            cx = rng.uniform(band * k + 1.6 * hw, band * (k + 1) - 1.6 * hw)
            cy = rng.uniform(1.2 * hh, H - 1.2 * hh)
            slots.append(_face_layers(rng, m, cx, cy, hw, hh))
        out[lo:lo + m] = _paint(base, gx, gy, slots, (H, W), noise_std, gen, device)
    return out


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def train_faces(n: int, size: Sequence[int], seed: int, device,
                noise_std: float = 4.0) -> Dict[str, torch.Tensor]:
    """n aligned faces: ImageNet-normalized float32 images (n, H, W, 3), their
    five landmarks (n, 5, 2) in pixels (the alignment targets moved by up to
    3 % of the side) and balanced labels (n,) in a seeded order. Fake faces
    (label 1) get their mouth and eyes drawn 8 % wider."""
    H, W = size
    rng = _rng(seed, 1)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 62) + 2)
    labels = rng.permutation(np.arange(n) % 2)
    target = np.asarray(REFERENCE_LANDMARKS) * np.asarray([W, H])
    lms = target[None] + rng.uniform(-0.03, 0.03, (n, 5, 2)) * np.asarray([W, H])
    images = torch.empty((n, H, W, 3), dtype=torch.float32, device=device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        sl = lms[lo:lo + m]
        eyes = sl[:, :2].mean(1)
        cx = 0.5 * (sl[:, 0, 0] + sl[:, 1, 0])
        hw = (sl[:, 1, 0] - sl[:, 0, 0]) / 0.84 * (1 + 0.08 * labels[lo:lo + m])
        hh = (sl[:, 3:, 1].mean(1) - eyes[:, 1]) / 0.83
        cy = eyes[:, 1] + 0.28 * hh
        base, gx, gy = (rng.uniform(40, 200, (m, 3)), rng.normal(0, 0.1, (m, 3)),
                        rng.normal(0, 0.1, (m, 3)))
        u8 = _paint(base, gx, gy, [_face_layers(rng, m, cx, cy, hw, hh)], (H, W), noise_std,
                    gen, device)
        images[lo:lo + m] = (u8.float() / 255.0 - mean) / std
    return {"image": images,
            "landmarks": torch.as_tensor(lms, dtype=torch.float32, device=device),
            "label": torch.as_tensor(labels, dtype=torch.long, device=device)}
