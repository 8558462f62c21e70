"""CSV-driven dataset and the host loader (the host half of the JAX
package's ``data/dataset.py``).

- ``PreprocessedFaceDataset``: rows of a split CSV with ``processed ==
  True``, each face decoded to RGB float32 HWC (``cv2``, imported when an
  image is read), resized to ``image_size`` and ImageNet-normalized;
  real=0 / fake=1 labels; landmarks from ``.npy`` files; inverse-frequency
  class weights.
- ``collate_batch``, ``HostLoader`` (epoch-seeded order, bit for bit the
  JAX loader's; a Python thread pool decodes), ``create_dataloaders``.
- ``batch_to_device``: a batch's numeric leaves as tensors on a device.

The JAX package's device-resident loaders (``DeviceLoader``,
``CachedDeviceLoader``, ``cache="device"``) and its native C++ decoder
are not ported (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import csv
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..ops import image

IMAGENET_MEAN = np.array(image.IMAGENET_MEAN, dtype=np.float32)
IMAGENET_STD = np.array(image.IMAGENET_STD, dtype=np.float32)

LABEL_MAP = {"real": 0, "fake": 1}
_TRUE = {"True", "true", "TRUE", "1", "1.0"}
_NOT_PORTED = "is not ported (ROADMAP Queue A item 6)"


def _path_field(row: Dict[str, str], key: str) -> Optional[str]:
    """A CSV path cell, or None where the column is missing or empty."""
    v = row.get(key)
    return v if v else None


def _load_image(path, image_size: int, normalize: bool = True) -> np.ndarray:
    """Decode a face to RGB float32 (image_size, image_size, 3) in [0, 1],
    ImageNet-normalized when ``normalize``; zeros if it does not decode."""
    import cv2

    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if bgr is None:
        return np.zeros((image_size, image_size, 3), dtype=np.float32)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    if rgb.shape[:2] != (image_size, image_size):
        rgb = cv2.resize(rgb, (image_size, image_size), interpolation=cv2.INTER_LINEAR)
    img = rgb.astype(np.float32) / 255.0
    if normalize:
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
    return img


class PreprocessedFaceDataset:
    """Dataset over a split CSV and the faces/landmarks/metadata layout.

    CSV columns (as ``scripts/preprocess_dataset.py`` writes them):
    ``image_id``, ``dataset``, ``label`` ('real'/'fake'), ``processed``,
    ``face_path`` / ``landmark_path`` / ``metadata_path`` (relative to
    ``root_dir``), ``quality_score``. Rows whose ``processed`` is not true
    are dropped.
    """

    def __init__(self, csv_path, root_dir, use_landmarks: bool = True,
                 load_metadata: bool = False, image_size: int = 224, normalize: bool = True,
                 native_threads: Optional[int] = None):
        if native_threads is not None:
            raise NotImplementedError(f"the native decoder {_NOT_PORTED}")
        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        if rows and "processed" in rows[0]:
            rows = [r for r in rows if r["processed"] in _TRUE]
        self.rows = rows
        self.root = Path(root_dir)
        self.use_landmarks = use_landmarks
        self.load_metadata = load_metadata
        self.image_size = int(image_size)
        self.normalize = normalize

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        row = self.rows[index]
        q = row.get("quality_score")
        item: Dict[str, Any] = {
            "image": _load_image(self.root / row["face_path"], self.image_size, self.normalize),
            "label": np.int32(LABEL_MAP.get(str(row["label"]), 0)),
            "image_id": str(row["image_id"]),
            "dataset": str(row.get("dataset", "")),
            "quality_score": np.float32(q if q else ("nan" if q == "" else 0.0)),
        }
        lm_rel = _path_field(row, "landmark_path")
        if self.use_landmarks and lm_rel:
            lm_path = self.root / lm_rel
            item["landmarks"] = (np.load(lm_path).astype(np.float32) if lm_path.exists()
                                 else np.zeros((5, 2), dtype=np.float32))
        md_rel = _path_field(row, "metadata_path")
        if self.load_metadata and md_rel:
            md_path = self.root / md_rel
            if md_path.exists():
                with open(md_path) as f:
                    item["metadata"] = json.load(f)
        return item

    def get_class_weights(self) -> np.ndarray:
        """Inverse-frequency weights ``total / (2 · count)`` per class,
        ordered [real, fake]."""
        labels = np.array([LABEL_MAP.get(str(r["label"]), 0) for r in self.rows])
        total = len(labels)
        weights = np.ones(2, dtype=np.float32)
        for c in (0, 1):
            count = int((labels == c).sum())
            weights[c] = total / (2.0 * count) if count > 0 else 1.0
        return weights


def collate_batch(items: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack items into a batch: numeric leaves as leading-batch numpy
    arrays, strings and other metadata as lists."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if isinstance(first, (str, dict)) or first is None:
            out[key] = vals
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class HostLoader:
    """Epoch-seeded shuffling batcher with threaded decode (the JAX
    package's class, its per-item path).

    ``shuffle`` reshuffles every epoch deterministically from ``seed``
    (``np.random.default_rng((seed, epoch))``; ``set_epoch`` restores any
    epoch's order, the resume contract); ``drop_last`` keeps the batch
    size fixed. One process reads every batch (the JAX class's
    per-process stripes come with data parallelism, ROADMAP Queue A item
    9). Batches are numpy dicts; the train and eval steps move them to the
    model's device.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, int(num_workers))
        self.seed = int(seed)
        self._epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self._epoch)).permutation(n)
        return np.arange(n)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _fetch(self, indices: np.ndarray) -> Dict[str, Any]:
        if self.num_workers > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            items = list(self._pool.map(self.dataset.__getitem__, [int(i) for i in indices]))
        else:
            items = [self.dataset[int(i)] for i in indices]
        return collate_batch(items)

    def __iter__(self):
        order = self._order()
        # Epoch auto-advances AT ITERATOR CREATION so plain re-iteration
        # reshuffles like a torch DataLoader across epochs, and an abandoned
        # iterator (e.g. next(iter(loader)) for model init) leaves the same
        # epoch state as a drained one; set_epoch() overrides for resume.
        self._epoch += 1
        bs = self.batch_size
        n_full = len(order) // bs
        for b in range(n_full):
            yield self._fetch(order[b * bs : (b + 1) * bs])
        if not self.drop_last and n_full * bs < len(order):
            yield self._fetch(order[n_full * bs :])


_NUMERIC_KINDS = frozenset("fiub")


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The batch's numeric leaves as tensors on ``device`` (labels as int64);
    strings and other metadata are dropped."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            t = v
        elif isinstance(v, np.ndarray) and v.dtype.kind in _NUMERIC_KINDS:
            t = torch.from_numpy(v)
        else:
            continue
        out[k] = (t.long() if k == "label" else t).to(device)
    return out


def create_dataloaders(processed_dir, batch_size: int = 64, num_workers: int = 4,
                       use_landmarks: bool = True, seed: int = 42,
                       splits: Iterable[str] = ("train", "val", "test"), image_size: int = 224,
                       cache: Optional[str] = None) -> Dict[str, HostLoader]:
    """A loader for each split CSV found under ``{processed_dir}/splits/``:
    train shuffled with ``drop_last``, val and test in order keeping
    their tail."""
    if cache == "device":
        raise NotImplementedError(f"cache='device' (CachedDeviceLoader) {_NOT_PORTED}")
    processed_dir = Path(processed_dir)
    loaders: Dict[str, HostLoader] = {}
    for split in splits:
        csv_path = processed_dir / "splits" / f"{split}.csv"
        if not csv_path.exists():
            continue
        ds = PreprocessedFaceDataset(csv_path, processed_dir, use_landmarks=use_landmarks,
                                     image_size=image_size)
        is_train = split == "train"
        loaders[split] = HostLoader(ds, batch_size=batch_size, shuffle=is_train,
                                    drop_last=is_train, num_workers=num_workers, seed=seed)
    return loaders
