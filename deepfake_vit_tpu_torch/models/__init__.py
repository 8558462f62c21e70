"""Networks of the serving and training paths (PyTorch counterparts of
``deepfake_vit_tpu.models``)."""

from .feature_extractor import DeepfakeDetectionModel, create_model_from_config
from .scrfd import ScrfdDetector, fold_stem_pool_params

__all__ = [
    "DeepfakeDetectionModel",
    "ScrfdDetector",
    "create_model_from_config",
    "fold_stem_pool_params",
]
