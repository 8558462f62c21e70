"""CSV-driven dataset, the host loader and the device loaders
(counterpart of the JAX package's ``data/dataset.py``).

- ``PreprocessedFaceDataset``: rows of a split CSV with ``processed ==
  True``, each face decoded to RGB float32 HWC (``cv2``, imported when an
  image is read), resized to ``image_size`` and ImageNet-normalized;
  real=0 / fake=1 labels; landmarks from ``.npy`` files; inverse-frequency
  class weights; quality statistics. ``native_threads=N`` decodes whole
  batches through the native C++ pool (``data/native_loader.py``, built
  at first use; a failed build raises). The default, None, keeps the
  per-item ``cv2`` path; the JAX package instead takes the native pool
  whenever its library is present.
- ``collate_batch``, ``HostLoader`` (epoch-seeded order, bit for bit the
  JAX loader's; a Python thread pool decodes per item, or the dataset's
  native pool decodes the batch).
- ``DeviceLoader``: a ``HostLoader`` whose batches a producer thread
  decodes one ahead and copies to the device (pinned memory, a side
  stream, ``non_blocking``; the consumer's stream waits on the copy).
- ``CachedDeviceLoader``: the whole split decoded once and kept on the
  device; each batch is an ``index_select`` of it, in ``HostLoader``'s
  order, each epoch's order uploaded once. One process and one device.
- ``create_dataloaders``, and ``batch_to_device`` (a batch's numeric
  leaves as tensors on a device).
"""

from __future__ import annotations

import csv
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from queue import Full, Queue
from typing import Any, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops import image

IMAGENET_MEAN = np.array(image.IMAGENET_MEAN, dtype=np.float32)
IMAGENET_STD = np.array(image.IMAGENET_STD, dtype=np.float32)

LABEL_MAP = {"real": 0, "fake": 1}
_TRUE = {"True", "true", "TRUE", "1", "1.0"}


def _path_field(row: Dict[str, str], key: str) -> Optional[str]:
    """A CSV path cell, or None where the column is missing or empty."""
    v = row.get(key)
    return v if v else None


def _quality(row: Dict[str, str]) -> np.float32:
    """The row's quality score: NaN for an empty cell (as pandas reads
    it), 0 where the column is missing."""
    q = row.get("quality_score")
    return np.float32(q if q else ("nan" if q == "" else 0.0))


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
    are dropped. ``native_threads``: decode batches (``get_batch``)
    through the native pool with that many threads.
    """

    def __init__(self, csv_path, root_dir, use_landmarks: bool = True,
                 load_metadata: bool = False, image_size: int = 224, normalize: bool = True,
                 native_threads: Optional[int] = None):
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
        self.native_threads = native_threads
        self._decoder = None
        if native_threads is not None:
            from .native_loader import NativeDecoder

            self._decoder = NativeDecoder(num_threads=native_threads)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        row = self.rows[index]
        item: Dict[str, Any] = {
            "image": _load_image(self.root / row["face_path"], self.image_size, self.normalize),
            "label": np.int32(LABEL_MAP.get(str(row["label"]), 0)),
            "image_id": str(row["image_id"]),
            "dataset": str(row.get("dataset", "")),
            "quality_score": _quality(row),
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

    def get_batch(self, indices: Sequence[int]) -> Dict[str, Any]:
        """A batch of the rows at ``indices``, decoded by the native pool
        (per item when the dataset has none). Landmarks, with
        ``use_landmarks`` and a ``landmark_path`` column, are zeros where
        a row has no file."""
        if self._decoder is None:
            return collate_batch([self[int(i)] for i in indices])
        rows = [self.rows[int(i)] for i in indices]
        images, _failed = self._decoder.decode_batch(
            [str(self.root / r["face_path"]) for r in rows], image_size=self.image_size,
            normalize=self.normalize)
        batch: Dict[str, Any] = {
            "image": images,
            "label": np.array([LABEL_MAP.get(str(r["label"]), 0) for r in rows], np.int32),
            "image_id": [str(r["image_id"]) for r in rows],
            "dataset": [str(r.get("dataset", "")) for r in rows],
            "quality_score": np.array([_quality(r) for r in rows], np.float32),
        }
        if self.use_landmarks and self.rows and "landmark_path" in self.rows[0]:
            lms = []
            for r in rows:
                rel = _path_field(r, "landmark_path")
                p = self.root / rel if rel else None
                lms.append(np.load(p).astype(np.float32) if p is not None and p.exists()
                           else np.zeros((5, 2), np.float32))
            batch["landmarks"] = np.stack(lms)
        return batch

    def get_quality_stats(self) -> Dict[str, float]:
        """Mean, std, min and max of the quality scores (NaN where a cell
        is empty); {} without the column or rows."""
        if not self.rows or "quality_score" not in self.rows[0]:
            return {}
        q = np.asarray([_quality(r) for r in self.rows], np.float64)
        return {"mean": float(q.mean()), "std": float(q.std()), "min": float(q.min()),
                "max": float(q.max())}

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
    package's class).

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
        if getattr(self.dataset, "native_threads", None) is not None:
            return self.dataset.get_batch([int(i) for i in indices])
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


def _numeric(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.dtype.kind in _NUMERIC_KINDS}


class CachedDeviceLoader(HostLoader):
    """``HostLoader`` over a split decoded once and kept on ``device``.

    The first iteration decodes every row (the dataset's ``get_batch``, so
    the native pool where the dataset has one) and copies the image,
    label, landmark and quality arrays to the device. Each epoch then
    uploads its order (``HostLoader._order``, so the same batches in the
    same order) once and serves every batch by ``index_select``; no host
    data moves per step. One process and one device: a process group of
    more than one rank raises.
    """

    _CACHE_KEYS = ("image", "label", "landmarks", "quality_score")

    def __init__(self, *args, device: Union[str, torch.device, None] = None, **kwargs):
        super().__init__(*args, **kwargs)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise RuntimeError("CachedDeviceLoader serves one process on one device; "
                               f"this process group has {dist.get_world_size()} ranks")
        self.device = resolve_device(device)
        self._cache: Optional[Dict[str, torch.Tensor]] = None

    def _stage(self) -> Dict[str, torch.Tensor]:
        if self._cache is None:
            host = self.dataset.get_batch(list(range(len(self.dataset))))
            self._cache = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                           for k, v in _numeric(host).items() if k in self._CACHE_KEYS}
        return self._cache

    def __iter__(self):
        cache = self._stage()
        order = torch.from_numpy(self._order()).to(self.device)
        self._epoch += 1  # at iterator creation, as HostLoader
        bs = self.batch_size
        n_full = len(order) // bs
        spans = [(b * bs, (b + 1) * bs) for b in range(n_full)]
        if not self.drop_last and n_full * bs < len(order):
            spans.append((n_full * bs, len(order)))
        for lo, hi in spans:
            idx = order[lo:hi]
            yield {k: v.index_select(0, idx) for k, v in cache.items()}


class DeviceLoader:
    """A ``HostLoader`` whose batches arrive on ``device``.

    A producer thread runs the host loader ``prefetch`` batches ahead
    (bounded queue; an abandoned iterator releases and joins it). On a
    CUDA device the producer copies each batch's numeric leaves into
    pinned memory and on to the device on a side stream
    (``non_blocking``) and records an event; the consumer's stream waits
    on that event, and ``record_stream`` keeps the caching allocator from
    reusing the buffers before the consumer's work is done. Strings and
    other metadata are dropped; labels become int64 (``batch_to_device``).
    """

    def __init__(self, loader: HostLoader, device: Union[str, torch.device, None] = None,
                 prefetch: int = 1):
        self.loader = loader
        self.device = resolve_device(device)
        self.prefetch = max(0, int(prefetch))

    @property
    def dataset(self):
        return self.loader.dataset

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def _copy(self, batch: Dict[str, Any], stream) -> tuple:
        """(device batch, event or None), issued on ``stream``."""
        if stream is None:
            return batch_to_device(batch, self.device), None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   for k, v in _numeric(batch).items()}
            out = {k: (t.long() if k == "label" else t).to(self.device, non_blocking=True)
                   for k, t in out.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _ready(self, item: tuple) -> Dict[str, torch.Tensor]:
        out, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out.values():
                t.record_stream(current)
        return out

    def __iter__(self):
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if self.prefetch == 0:
            for batch in self.loader:
                yield self._ready(self._copy(batch, stream))
            return
        q: Queue = Queue(maxsize=self.prefetch)
        end, stop = object(), threading.Event()
        failure: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.loader:
                    if not put(self._copy(batch, stream)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                failure.append(e)
            finally:
                put(end)

        t = threading.Thread(target=producer, name="DeviceLoader producer", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    if failure:
                        raise failure[0]
                    break
                yield self._ready(item)
        finally:
            stop.set()
            t.join(timeout=5.0)


def create_dataloaders(processed_dir, batch_size: int = 64, num_workers: int = 4,
                       use_landmarks: bool = True, seed: int = 42,
                       splits: Iterable[str] = ("train", "val", "test"), image_size: int = 224,
                       cache: Optional[str] = None,
                       device: Union[str, torch.device, None] = None,
                       native_threads: Optional[int] = None) -> Dict[str, Any]:
    """A loader for each split CSV found under ``{processed_dir}/splits/``:
    train shuffled with ``drop_last``, val and test in order keeping
    their tail. ``device`` wraps each in a ``DeviceLoader`` (the JAX
    function's ``mesh``); ``cache="device"`` builds ``CachedDeviceLoader``s
    on ``device`` (the card when None); ``native_threads`` decodes through
    the native pool."""
    processed_dir = Path(processed_dir)
    loaders: Dict[str, Any] = {}
    for split in splits:
        csv_path = processed_dir / "splits" / f"{split}.csv"
        if not csv_path.exists():
            continue
        ds = PreprocessedFaceDataset(csv_path, processed_dir, use_landmarks=use_landmarks,
                                     image_size=image_size, native_threads=native_threads)
        is_train = split == "train"
        common = dict(batch_size=batch_size, shuffle=is_train, drop_last=is_train,
                      num_workers=num_workers, seed=seed)
        if cache == "device":
            loaders[split] = CachedDeviceLoader(ds, device=device, **common)
        elif device is not None:
            loaders[split] = DeviceLoader(HostLoader(ds, **common), device)
        else:
            loaders[split] = HostLoader(ds, **common)
    return loaders
