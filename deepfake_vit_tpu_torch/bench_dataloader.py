"""Data-loading throughput harness.

    python -m deepfake_vit_tpu_torch.bench_dataloader [--processed-dir data/processed]
        [--split train] [--batch-size 64] [--num-workers 8] [--batches 50] [--device cuda|cpu]

The JAX package's ``scripts/bench_dataloader.py``, plus ``--device``:
batches/s, ms a batch and samples/s of ``HostLoader`` over a processed
split, first on the per-item cv2 path (a pool of ``--num-workers``
threads), then, where the native decoder builds
(``data/native_loader.is_available()``), with ``native_threads`` set to
the same count. Where it does not build, a line says so: neither path
stands in for the other. Each batch is moved to the device, as the train
step moves it (host → card copy included in the time on the card). Prints
one JSON line with the numbers last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch


def measure(loader, n_batches: int, label: str, device: torch.device) -> Optional[Dict[str, Any]]:
    """Time ``n_batches`` after one warm batch; None when the loader is empty."""
    from .data.dataset import batch_to_device

    it = iter(loader)
    next(it, None)  # warm
    t0 = time.perf_counter()
    count = samples = 0
    for batch in it:
        batch_to_device(batch, device)
        count += 1
        samples += len(batch["label"])
        if count >= n_batches:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if count == 0:
        print(f"{label}: no batches")
        return None
    res = {"batches_per_s": count / dt, "ms_per_batch": dt / count * 1e3,
           "samples_per_s": samples / dt, "batches": count}
    print(f"{label}: {res['batches_per_s']:.2f} batches/s, {res['ms_per_batch']:.2f} ms/batch, "
          f"{res['samples_per_s']:.1f} samples/s")
    return res


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Measure dataloader throughput (PyTorch port)")
    parser.add_argument("--processed-dir", type=str, default="data/processed")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--batches", type=int, default=50)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device the batches go to (default: the card)")
    args = parser.parse_args(argv)

    from .data import HostLoader, PreprocessedFaceDataset, native_loader
    from .device import resolve_device

    device = resolve_device(args.device)
    csv_path = Path(args.processed_dir) / "splits" / f"{args.split}.csv"
    if not csv_path.exists():
        print(f"no split CSV at {csv_path}: run preprocess_dataset first")
        return 1

    ds = PreprocessedFaceDataset(csv_path, args.processed_dir)
    native = native_loader.is_available()
    print(f"dataset: {len(ds)} samples; native loader available: {native}")
    results: Dict[str, Any] = {"samples": len(ds), "native_available": native}
    loader = HostLoader(ds, batch_size=args.batch_size, shuffle=True, drop_last=True,
                        num_workers=args.num_workers)
    results["python threads"] = measure(loader, args.batches, "python threads", device)
    if native:
        ds_native = PreprocessedFaceDataset(csv_path, args.processed_dir,
                                            native_threads=args.num_workers)
        loader = HostLoader(ds_native, batch_size=args.batch_size, shuffle=True,
                            drop_last=True, num_workers=args.num_workers)
        results["native+threads"] = measure(loader, args.batches, "native+threads", device)
    else:
        print("native+threads: not measured: the native decoder (native/dataloader.cc) did not "
              "build here")
    print(json.dumps(results))
    return 0 if results["python threads"] is not None else 1


if __name__ == "__main__":
    sys.exit(main())
