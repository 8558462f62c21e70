"""HOG + linear-template sliding-window face detector (the dlib family).

Counterpart of the JAX package's ``models/hog_detector.py``, in batched
torch ops on the detector's device:

- HOG features: central-difference gradients (zero at the border),
  unsigned orientation split between the two nearest of 9 bins, summed
  over 8×8 cells (``hog_cells``); 2×2-cell blocks, L2-normalized with the
  Dalal-Triggs 0.2 clip (``hog_blocks``).
- The sliding 80×80 window is one VALID convolution of the (Hb, Wb, 36)
  block map with the (9, 9, 36) template.
- The pyramid is a fixed ladder of (5/6)^k scales of the canvas
  (``pyramid_sizes``), ``upsample`` 2× levels first; each level is
  ``jax.image.resize(..., "linear")``'s filter (a triangle widened by the
  scale on a down-scale), here ``F.interpolate(mode="bilinear",
  antialias=True)``. On 320² frames of 0-255 noise both lie within
  5.1e-5 (the port) and 2.5e-3 (JAX on the CPU, its einsum) of a float64
  resize with JAX's own weights.
- Candidates go through the fixed-size batched NMS and the
  ``FaceDetector`` host API. The detector has no landmarks: it places the
  five canonical frontal landmarks at fixed fractions of each box.

``fit_hog_template`` trains the template: a linear SVM (class-balanced
hinge loss + L2, full-batch Adam) on positive windows around drawn faces
and random face-free windows, then ``mining_rounds`` of hard negatives the
current template fires on.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.nms import nms_batched
from ..preprocessing.detector import FaceDetector, default_weights_path
from ..device import resolve_device

CELL = 8  # pixels per HOG cell
BINS = 9  # unsigned orientation bins over [0, pi)
WINDOW_CELLS = 10  # detection window = 10x10 cells = 80x80 px
WINDOW = WINDOW_CELLS * CELL
BLOCK_DIM = BINS * 4  # 2x2-cell blocks, L2-normalized
TEMPLATE_BLOCKS = WINDOW_CELLS - 1  # 9x9 block grid inside the window
# A window hit means "an 80 px window holds a face box of ~80/1.25 px
# centered in it": the context margin the template is trained with.
FACE_IN_WINDOW = 1.25
PYRAMID_RATIO = 5.0 / 6.0  # dlib's default pyramid_down ratio
_GRAY = (0.299, 0.587, 0.114)

# Box-relative canonical landmark fractions (the aligner's reference layout).
_CANONICAL_LM = np.array(
    [(0.31, 0.32), (0.69, 0.32), (0.50, 0.55), (0.35, 0.75), (0.65, 0.75)], np.float32)


def hog_cells(gray: torch.Tensor) -> torch.Tensor:
    """Per-cell orientation histograms: (B, H, W) gray → (B, H//8, W//8, 9)."""
    g = gray.float()
    dx = F.pad(g[:, :, 2:] - g[:, :, :-2], (1, 1))
    dy = F.pad(g[:, 2:, :] - g[:, :-2, :], (0, 0, 1, 1))
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.remainder(torch.atan2(dy, dx), math.pi)  # unsigned: [0, pi)
    binf = ang * (BINS / math.pi)
    b0 = torch.floor(binf)
    frac = binf - b0
    b0 = b0.long() % BINS
    b1 = (b0 + 1) % BINS
    votes = F.one_hot(b0, BINS).float() * (mag * (1.0 - frac))[..., None]
    votes = votes + F.one_hot(b1, BINS).float() * (mag * frac)[..., None]
    B, H, W = g.shape
    Hc, Wc = H // CELL, W // CELL
    votes = votes[:, : Hc * CELL, : Wc * CELL]
    return votes.reshape(B, Hc, CELL, Wc, CELL, BINS).sum(dim=(2, 4))


def hog_blocks(cells: torch.Tensor) -> torch.Tensor:
    """2×2-cell block descriptor: (B, Hc, Wc, 9) → (B, Hc−1, Wc−1, 36)."""
    block = torch.cat([cells[:, :-1, :-1], cells[:, :-1, 1:], cells[:, 1:, :-1],
                       cells[:, 1:, 1:]], dim=-1)
    norm = torch.sqrt((block * block).sum(-1, keepdim=True) + 1e-6)
    block = torch.clamp_max(block / norm, 0.2)
    norm = torch.sqrt((block * block).sum(-1, keepdim=True) + 1e-6)
    return block / norm


def hog_descriptor(gray: torch.Tensor) -> torch.Tensor:
    """Whole-window descriptor of 80×80 patches: (B, 80, 80) → (B, 2916)."""
    return hog_blocks(hog_cells(gray)).reshape(gray.shape[0], -1)


def _score_map(blocks: torch.Tensor, template: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The (9, 9, 36) template slid over (B, Hb, Wb, 36): → (B, Hs, Ws)."""
    out = F.conv2d(blocks.permute(0, 3, 1, 2), template.permute(2, 0, 1)[None])
    return out[:, 0] + bias


def pyramid_sizes(canvas: Tuple[int, int], upsample: int = 1,
                  min_side: int = WINDOW) -> List[Tuple[int, int]]:
    """The ladder of (5/6)^k scaled canvas sizes, largest first, snapped
    to multiples of the cell; ``upsample`` starts it at 2^upsample."""
    H, W = canvas
    sizes: List[Tuple[int, int]] = []
    scale = float(2 ** upsample)
    while True:
        h, w = int(round(H * scale)), int(round(W * scale))
        if min(h, w) < min_side:
            break
        sizes.append((h - h % CELL, w - w % CELL))
        scale *= PYRAMID_RATIO
    return sizes


def resize_linear(gray: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) → (B, h, w): ``jax.image.resize(gray, (B, h, w),
    "linear")``, a triangle filter at half-pixel centres, widened by the
    scale on a down-scale."""
    return F.interpolate(gray[:, None].float(), size=size, mode="bilinear", align_corners=False,
                         antialias=True)[:, 0]


def to_gray(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB → (B, H, W) float32 luma."""
    return images.float() @ torch.tensor(_GRAY, dtype=torch.float32, device=images.device)


class HogFaceDetector(FaceDetector):
    """The dlib-style frontal detector behind the ``FaceDetector`` host
    API (``batch_detect``, ``detect``, ``detect_batch_raw``, keep_top_k
    and the confidence filter). Confidence is the logistic of the SVM
    margin, so 0.5 is the margin-0 decision rule."""

    def __init__(self, confidence_threshold: float = 0.5, nms_threshold: float = 0.3,
                 keep_top_k: int = 1, input_size: Tuple[int, int] = (320, 320),
                 max_detections: int = 16, params: Optional[Dict[str, Any]] = None,
                 pretrained: bool = True, upsample: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        self.confidence_threshold = confidence_threshold
        self.nms_threshold = nms_threshold
        self.keep_top_k = keep_top_k
        self.input_size = tuple(input_size)
        self.max_detections = max_detections
        self.model_name = "hog"
        self.device = resolve_device(device)
        self.upsample = upsample
        self._levels = pyramid_sizes(self.input_size, upsample=upsample)
        if params is not None:
            self.set_params(params)
        else:
            self.set_params({"template": np.zeros((TEMPLATE_BLOCKS, TEMPLATE_BLOCKS, BLOCK_DIM),
                                                  np.float32),
                             "bias": np.zeros((), np.float32)})
            if pretrained and default_weights_path("hog"):
                self.load_weights(default_weights_path("hog"))

    def set_params(self, params: Dict[str, Any]) -> None:
        """``{"template": (9, 9, 36), "bias": ()}``, arrays or tensors."""
        self.template = torch.as_tensor(np.asarray(params["template"], np.float32),
                                        device=self.device)
        self.bias = torch.as_tensor(np.asarray(params["bias"], np.float32), device=self.device)

    @property
    def params(self) -> Dict[str, np.ndarray]:
        return {"template": self.template.cpu().numpy(), "bias": self.bias.cpu().numpy()}

    @torch.inference_mode()
    def _detect_graph(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) uint8/float RGB [0, 255] → padded detections."""
        gray = to_gray(images)
        H0, W0 = self.input_size
        all_scores, all_boxes = [], []
        for h, w in self._levels:
            lvl = gray if (h, w) == (H0, W0) else resize_linear(gray, (h, w))
            smap = _score_map(hog_blocks(hog_cells(lvl)), self.template, self.bias)
            B, Hs, Ws = smap.shape
            # The window at block (bi, bj) covers [bj·8, bj·8 + 80) × [bi·8,
            # bi·8 + 80) at this level: its face box shrinks by
            # FACE_IN_WINDOW around the centre, rescaled to the canvas.
            sy, sx = H0 / h, W0 / w
            bi, bj = torch.meshgrid(torch.arange(Hs, dtype=torch.float32, device=gray.device),
                                    torch.arange(Ws, dtype=torch.float32, device=gray.device),
                                    indexing="ij")
            cx = (bj * CELL + WINDOW / 2.0) * sx
            cy = (bi * CELL + WINDOW / 2.0) * sy
            half_w = (WINDOW / FACE_IN_WINDOW / 2.0) * sx
            half_h = (WINDOW / FACE_IN_WINDOW / 2.0) * sy
            boxes = torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], dim=-1)
            all_scores.append(smap.reshape(B, -1))
            all_boxes.append(boxes.reshape(1, -1, 4).expand(B, Hs * Ws, 4))
        scores = torch.sigmoid(torch.cat(all_scores, dim=1))
        boxes = torch.cat(all_boxes, dim=1)
        idx, valid = nms_batched(boxes, scores, iou_threshold=self.nms_threshold,
                                 score_threshold=self.confidence_threshold,
                                 max_outputs=self.max_detections)
        safe = idx.clamp_min(0)
        rows = torch.arange(boxes.shape[0], device=boxes.device)[:, None]
        sel_boxes = boxes[rows, safe]
        tl = sel_boxes[..., :2]
        size = sel_boxes[..., 2:] - tl
        lm = torch.as_tensor(_CANONICAL_LM, device=boxes.device)
        return {"boxes": sel_boxes, "scores": torch.where(valid, scores.gather(1, safe), 0.0),
                "landmarks": tl[:, :, None, :] + lm * size[:, :, None, :], "valid": valid}

    def load_weights(self, path: str) -> None:
        from ..utils.msgpack import msgpack_restore

        self.set_params(msgpack_restore(path))

    def save_weights(self, path: str) -> None:
        """The template as the JAX package's msgpack (``{"template", "bias"}``)."""
        from ..utils.msgpack import msgpack_serialize

        with open(path, "wb") as f:
            f.write(msgpack_serialize(self.params))


# ---------------------------------------------------------------------------
# Training: a linear SVM with hard-negative mining
# ---------------------------------------------------------------------------
def _extract_window(img_gray: np.ndarray, cx: float, cy: float, side: float) -> Optional[np.ndarray]:
    """A square window resampled to 80×80 (bilinear, cv2)."""
    import cv2

    h, w = img_gray.shape
    half = side / 2.0
    x1, y1, x2, y2 = cx - half, cy - half, cx + half, cy + half
    if x1 < 0 or y1 < 0 or x2 > w or y2 > h or side < 8:
        return None
    xi1, yi1, xi2, yi2 = int(x1), int(y1), int(np.ceil(x2)), int(np.ceil(y2))
    patch = img_gray[yi1:yi2, xi1:xi2]
    if patch.size == 0:
        return None
    return cv2.resize(patch, (WINDOW, WINDOW), interpolation=cv2.INTER_LINEAR)


def _svm_fit(X: np.ndarray, y: np.ndarray, l2: float, steps: int, lr: float,
             device: Union[str, torch.device] = "cpu") -> Tuple[np.ndarray, float]:
    """Linear SVM by full-batch gradient descent on the class-balanced
    hinge loss + l2·|w|² (Adam, eps outside the root: optax's ``adam``)."""
    Xt = torch.as_tensor(X, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, dtype=torch.float32, device=device)  # +1 / -1
    n = yt.shape[0]
    wpos = n / (2.0 * torch.clamp_min((yt > 0).sum().float(), 1.0))
    wneg = n / (2.0 * torch.clamp_min((yt < 0).sum().float(), 1.0))
    sw = torch.where(yt > 0, wpos, wneg)
    w = torch.zeros(X.shape[1], dtype=torch.float32, device=device, requires_grad=True)
    b = torch.zeros((), dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        margin = Xt @ w + b
        hinge = torch.clamp_min(1.0 - yt * margin, 0.0)
        loss = (sw * hinge).mean() + l2 * (w ** 2).sum()
        loss.backward()
        opt.step()
    return w.detach().cpu().numpy(), float(b.detach())


def fit_hog_template(n_scenes: int = 400, scene_size: int = 320, seed: int = 0,
                     mining_rounds: int = 2, negatives_per_scene: int = 8,
                     hard_per_scene: int = 4, l2: float = 1e-4, steps: int = 600,
                     lr: float = 0.05, log=None,
                     device: Union[str, torch.device, None] = None) -> Dict[str, np.ndarray]:
    """Train the frontal-face template on ``n_scenes`` drawn scenes.

    Positives: each face box, jittered twice, windowed at FACE_IN_WINDOW
    context. Negatives: random face-free windows, then ``mining_rounds``
    of the windows the current template fires on away from every face.
    Returns the ``HogFaceDetector`` params ``{"template", "bias"}``.
    """
    from ..data.synth_faces import render_scene

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(n_scenes):
        img, boxes, _ = render_scene(rng, size=scene_size)
        gray = img.astype(np.float32) @ np.array(_GRAY, np.float32)
        scenes.append((gray, boxes))

    def batch_desc(wins: List[np.ndarray]) -> np.ndarray:
        x = torch.as_tensor(np.stack(wins), dtype=torch.float32, device=dev)
        return hog_descriptor(x).cpu().numpy()

    pos_wins: List[np.ndarray] = []
    neg_wins: List[np.ndarray] = []
    for gray, boxes in scenes:
        h, w = gray.shape
        for b in boxes:
            side_face = max(b[2] - b[0], b[3] - b[1])
            cx, cy = (b[0] + b[2]) / 2.0, (b[1] + b[3]) / 2.0
            for _ in range(2):  # small jitter augmentation
                jcx = cx + rng.uniform(-0.03, 0.03) * side_face
                jcy = cy + rng.uniform(-0.03, 0.03) * side_face
                jside = side_face * FACE_IN_WINDOW * rng.uniform(0.95, 1.05)
                win = _extract_window(gray, jcx, jcy, jside)
                if win is not None:
                    pos_wins.append(win)
        for _ in range(negatives_per_scene):
            side = float(rng.uniform(WINDOW * 0.6, min(h, w) * 0.9))
            cx = float(rng.uniform(side / 2, w - side / 2))
            cy = float(rng.uniform(side / 2, h - side / 2))
            tight = side / FACE_IN_WINDOW / 2.0
            cand = np.array([cx - tight, cy - tight, cx + tight, cy + tight])
            if any(_iou_np(cand, b) > 0.25 for b in boxes):
                continue
            win = _extract_window(gray, cx, cy, side)
            if win is not None:
                neg_wins.append(win)

    Xp = batch_desc(pos_wins)
    Xn = batch_desc(neg_wins)
    if log:
        log(f"positives {len(Xp)}, negatives {len(Xn)}")

    for rnd in range(mining_rounds + 1):
        X = np.concatenate([Xp, Xn])
        y = np.concatenate([np.ones(len(Xp)), -np.ones(len(Xn))])
        w_vec, b_val = _svm_fit(X, y, l2=l2, steps=steps, lr=lr, device=dev)
        if rnd == mining_rounds:
            break
        det = HogFaceDetector(
            confidence_threshold=0.5, input_size=(scene_size, scene_size),
            params={"template": w_vec.reshape(TEMPLATE_BLOCKS, TEMPLATE_BLOCKS, BLOCK_DIM),
                    "bias": np.float32(b_val)},
            max_detections=32, upsample=0, device=dev)
        hard: List[np.ndarray] = []
        bs = 16
        for i in range(0, len(scenes), bs):
            chunk = scenes[i: i + bs]
            frames = np.stack([np.repeat(g[..., None], 3, axis=-1) for g, _ in chunk])
            out = det.detect_batch_raw(frames.astype(np.float32))
            for bi, (gray, boxes) in enumerate(chunk):
                cnt = 0
                for k in range(out["valid"].shape[1]):
                    if not out["valid"][bi][k] or cnt >= hard_per_scene:
                        continue
                    box = out["boxes"][bi][k]
                    if any(_iou_np(box, b) > 0.25 for b in boxes):
                        continue
                    cx = (box[0] + box[2]) / 2.0
                    cy = (box[1] + box[3]) / 2.0
                    side = float(max(box[2] - box[0], box[3] - box[1])) * FACE_IN_WINDOW
                    win = _extract_window(gray, float(cx), float(cy), side)
                    if win is not None:
                        hard.append(win)
                        cnt += 1
        if hard:
            Xn = np.concatenate([Xn, batch_desc(hard)])
        if log:
            log(f"mining round {rnd}: +{len(hard)} hard negatives (total {len(Xn)})")

    return {"template": w_vec.reshape(TEMPLATE_BLOCKS, TEMPLATE_BLOCKS, BLOCK_DIM),
            "bias": np.float32(b_val)}


def _iou_np(a: np.ndarray, b: np.ndarray) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ua = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    ub = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return float(inter / max(ua + ub - inter, 1e-9))


__all__ = ["HogFaceDetector", "fit_hog_template", "hog_blocks", "hog_cells", "hog_descriptor",
           "pyramid_sizes", "resize_linear", "to_gray"]
