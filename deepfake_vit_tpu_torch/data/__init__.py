"""Data layer of the trainer (the host half of the JAX package's
``deepfake_vit_tpu.data``)."""

from .dataset import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    HostLoader,
    PreprocessedFaceDataset,
    batch_to_device,
    collate_batch,
    create_dataloaders,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "HostLoader", "PreprocessedFaceDataset",
           "batch_to_device", "collate_batch", "create_dataloaders"]
