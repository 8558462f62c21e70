"""Visualizations as numpy images.

Counterpart of the JAX package's ``utils/visualization.py``: a detection
overlay, a quality overlay, a landmark-Gaussian attention heatmap, the
pipeline canvas (detection | aligned face | attention), a captioned batch
grid and training curves. Each returns an (H, W, 3) uint8 RGB image (the
curves a matplotlib figure) and, with ``save_path``, writes it (cv2 as
BGR). ``cv2`` is imported by the functions that draw; ``matplotlib``,
which the card's machine may lack, only by ``plot_training_curves``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

_COLORS = ((66, 133, 244), (52, 168, 83), (251, 188, 5), (234, 67, 53), (154, 64, 219))


def _save(img: np.ndarray, path) -> None:
    import cv2

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def visualize_detection(image: np.ndarray, detection: Optional[Dict[str, Any]],
                        save_path=None) -> np.ndarray:
    """Draw the box, the 5 landmarks and the confidence onto an RGB image."""
    import cv2

    canvas = np.ascontiguousarray(image).astype(np.uint8).copy()
    if detection is not None:
        x1, y1, x2, y2 = [int(v) for v in detection["bbox"]]
        cv2.rectangle(canvas, (x1, y1), (x2, y2), (66, 133, 244), 2)
        for k, (x, y) in enumerate(np.asarray(detection["landmarks"], int)):
            cv2.circle(canvas, (int(x), int(y)), 3, _COLORS[k % 5], -1)
        cv2.putText(canvas, f"{detection['confidence']:.2f}", (x1, max(y1 - 6, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (66, 133, 244), 1)
    if save_path:
        _save(canvas, save_path)
    return canvas


def visualize_quality(image: np.ndarray, quality_result: Dict[str, Any],
                      save_path=None) -> np.ndarray:
    """Overlay the per-metric scores and the validity verdict."""
    import cv2

    canvas = np.ascontiguousarray(image).astype(np.uint8).copy()
    ok = quality_result.get("is_valid", False)
    color = (52, 168, 83) if ok else (234, 67, 53)
    lines = [f"valid: {ok}  overall: {quality_result.get('overall_score', 0):.2f}"]
    for k, v in quality_result.get("scores", {}).items():
        lines.append(f"{k}: {v:.1f}" if isinstance(v, float) else f"{k}: {v}")
    for i, line in enumerate(lines):
        cv2.putText(canvas, line, (4, 14 + 13 * i), cv2.FONT_HERSHEY_SIMPLEX, 0.38, color, 1)
    if save_path:
        _save(canvas, save_path)
    return canvas


def visualize_attention_map(landmarks: np.ndarray, image: Optional[np.ndarray] = None,
                            size: int = 224, sigma: float = 1.5, save_path=None) -> np.ndarray:
    """A size² landmark-Gaussian heatmap (σ scaled to the size), blended
    onto the face when ``image`` is given."""
    import cv2

    from ..ops.gaussian import landmark_gaussian_map

    amap = landmark_gaussian_map(torch.as_tensor(np.asarray(landmarks, np.float32))[None],
                                 (size, size), sigma=sigma * size / 7.0,
                                 normalize="per_sample", clip_range=None)
    heat8 = (np.clip(amap[0, 0].numpy(), 0, 1) * 255).astype(np.uint8)
    heat_rgb = cv2.applyColorMap(heat8, cv2.COLORMAP_JET)[:, :, ::-1]
    if image is not None:
        base = cv2.resize(np.asarray(image).astype(np.uint8), (size, size))
        out = (0.55 * base + 0.45 * heat_rgb).astype(np.uint8)
    else:
        out = heat_rgb
    if save_path:
        _save(out, save_path)
    return out


def visualize_pipeline(original: np.ndarray, output, save_path=None) -> np.ndarray:
    """Side by side: the frame with its detection | the aligned face | its
    attention map (``output``: a ``preprocessing.pipeline.PipelineOutput``)."""
    import cv2

    H = 224
    side = max(original.shape[:2])
    orig = cv2.resize(np.asarray(original).astype(np.uint8), (H, H))
    det = {
        "bbox": (output.bbox * H / side if output.bbox is not None
                 else np.asarray([0, 0, 1, 1])),
        "landmarks": (np.zeros((5, 2)) if output.original_landmarks is None
                      else output.original_landmarks * H / side),
        "confidence": output.confidence,
    }
    panel1 = visualize_detection(orig, det if output.success else None)
    panel2 = (cv2.resize(output.aligned_face, (H, H)) if output.aligned_face is not None
              else np.zeros((H, H, 3), np.uint8))
    panel3 = (visualize_attention_map(output.landmarks, panel2, size=H)
              if output.landmarks is not None else np.zeros((H, H, 3), np.uint8))
    canvas = np.concatenate([panel1, panel2, panel3], axis=1)
    if save_path:
        _save(canvas, save_path)
    return canvas


def visualize_batch(images: np.ndarray, labels: Optional[Sequence[int]] = None,
                    predictions: Optional[Sequence[int]] = None, max_images: int = 16,
                    denormalize: bool = True, save_path=None) -> np.ndarray:
    """A grid of 112² tiles of the batch's images, captioned with label and
    prediction; ``denormalize`` undoes the ImageNet normalization."""
    import cv2

    from ..data.dataset import IMAGENET_MEAN, IMAGENET_STD

    n = min(len(images), max_images)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    size = 112
    canvas = np.zeros((rows * size, cols * size, 3), np.uint8)
    for i in range(n):
        img = np.asarray(images[i], np.float32)
        if denormalize:
            img = np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0, 1) * 255
        tile = cv2.resize(img.astype(np.uint8), (size, size))
        caption = []
        if labels is not None:
            caption.append(f"y={int(labels[i])}")
        if predictions is not None:
            caption.append(f"p={int(predictions[i])}")
        if caption:
            cv2.putText(tile, " ".join(caption), (3, 13), cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                        (66, 244, 133), 1)
        r, c = divmod(i, cols)
        canvas[r * size:(r + 1) * size, c * size:(c + 1) * size] = tile
    if save_path:
        _save(canvas, save_path)
    return canvas


def plot_training_curves(history: Dict[str, List[float]], save_path=None):
    """Loss, accuracy, validation AUC / F1 and learning-rate curves from
    ``MetricsTracker.history``; a matplotlib figure (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    epochs = range(1, len(history.get("train_loss", [])) + 1)
    for ax, (title, keys) in zip(axes.flat[:3], (
            ("loss", (("train_loss", "train"), ("val_loss", "val"))),
            ("accuracy", (("train_acc", "train"), ("val_acc", "val"))),
            ("val AUC / F1", (("val_auc", "val AUC"), ("val_f1", "val F1"))))):
        for key, label in keys:
            ax.plot(epochs, history.get(key, []), label=label)
        ax.set_title(title)
        ax.legend()
    axes[1, 1].plot(epochs, history.get("lr", []))
    axes[1, 1].set_title("learning rate")
    axes[1, 1].set_yscale("log")
    fig.tight_layout()
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=110)
    return fig


__all__ = ["plot_training_curves", "visualize_attention_map", "visualize_batch",
           "visualize_detection", "visualize_pipeline", "visualize_quality"]
