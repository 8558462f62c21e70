"""Data layer: the split dataset and its loaders, the native decoder, the
split writer, the preprocessing → model interface and the procedural
scenes (counterpart of the JAX package's ``deepfake_vit_tpu.data``)."""

from .dataset import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    CachedDeviceLoader,
    DeviceLoader,
    HostLoader,
    PreprocessedFaceDataset,
    batch_to_device,
    collate_batch,
    create_dataloaders,
)
from .interface import (FeatureExtractionInput, PreprocessingToFeatureInterface,
                        collate_preprocessing_outputs)
from .splits import create_data_splits

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "CachedDeviceLoader", "DeviceLoader",
           "FeatureExtractionInput", "HostLoader", "PreprocessedFaceDataset",
           "PreprocessingToFeatureInterface", "batch_to_device", "collate_batch",
           "collate_preprocessing_outputs", "create_data_splits", "create_dataloaders"]
