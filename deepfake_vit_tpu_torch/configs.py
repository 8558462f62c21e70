"""The headline model configuration, the training configuration and the
preprocessing configuration as Python dicts.

``MODEL_CONFIG`` is the ``model`` block of
``deepfake_vit_tpu/configs/model_config.yaml`` (EfficientNet-B4 + hybrid
attention + [512, 128, 32] head); ``TRAINING_CONFIG`` is that whole file
(the model block, data, augmentation, training, validation, early
stopping, checkpoint, logging, hardware and seed), the default of the
port's train and evaluate CLIs; ``PREPROCESSING_CONFIG`` is the whole of
``deepfake_vit_tpu/configs/preprocessing_config.yaml`` (its
``detection.device`` key is data the port does not read). They are kept
here so that the port's entry points need no YAML reader; tests hold each
equal to its file.
"""

MODEL_CONFIG = {
    "model": {
        "name": "DeepfakeDetectionModel",
        "feature_extractor": {
            "variant": "b4",
            "pretrained": True,
            "pretrained_path": None,
            "freeze_bn": False,
            "dropout_rate": 0.4,
            "use_attention": True,
            "attention_config": {
                "use_landmark": True,
                "use_spatial": True,
                "use_channel": True,
            },
        },
        "classifier": {
            "hidden_dims": [512, 128, 32],
            "dropout_rate": 0.4,
            "num_classes": 2,
        },
    }
}

TRAINING_CONFIG = {
    "model": MODEL_CONFIG["model"],
    "data": {
        "processed_dir": "data/processed",
        "batch_size": 64,
        "num_workers": 4,
        "use_landmarks": True,
        "augmentation": {"enabled": False, "random_flip": True, "random_rotation": 5,
                         "color_jitter": 0.1},
    },
    "training": {
        "num_epochs": 100,
        "gradient_clip": 1.0,
        "accumulation_steps": 1,
        "use_amp": True,
        "remat": False,
        "optimizer": {"type": "AdamW", "lr": 0.0001, "weight_decay": 0.0001,
                      "betas": [0.9, 0.999], "momentum": 0.9, "nesterov": True},
        "scheduler": {"type": "CosineAnnealingWarmRestarts", "step_size": 30, "gamma": 0.1,
                      "T_max": 50, "eta_min": 0.000001, "mode": "min", "factor": 0.5,
                      "patience": 5, "min_lr": 0.000001, "T_0": 10, "T_mult": 2,
                      "eta_min_restart": 0.000001},
        "loss": {"type": "CombinedLoss", "weights": {"ce": 1.0, "focal": 0.5, "contrastive": 0.2},
                 "focal_gamma": 2.0, "smoothing": 0.1, "class_weights": None},
    },
    "validation": {"eval_freq": 1, "save_freq": 5, "print_freq": 10},
    "early_stopping": {"patience": 15, "min_delta": 0.001},
    "checkpoint": {"save_dir": "checkpoints", "max_keep": 5, "save_best_only": False},
    "logging": {"log_dir": "runs", "log_freq": 10},
    "hardware": {"device": "tpu", "mesh_axes": ["data"], "mesh_shape": None},
    "seed": 42,
    "experiment": {
        "name": "deepfake_detection_efficientnet_b4_tpu",
        "tags": ["efficientnet", "landmark_attention", "combined_loss", "tpu"],
        "notes": "TPU-native EfficientNet-B4 + hybrid attention deepfake detector",
    },
}

PREPROCESSING_CONFIG = {
    "detection": {
        "model": "scrfd",
        "device": "tpu",
        "confidence_threshold": 0.5,
        "nms_threshold": 0.4,
        "keep_top_k": 1,
        "scrfd": {"input_size": [640, 640], "pretrained_path": None, "max_detections": 64},
    },
    "alignment": {
        "output_size": [224, 224],
        "reference_landmarks": {
            "left_eye": [0.31, 0.32],
            "right_eye": [0.69, 0.32],
            "nose": [0.5, 0.55],
            "left_mouth": [0.35, 0.75],
            "right_mouth": [0.65, 0.75],
        },
        "method": "similarity",
        "border_mode": "constant",
        "border_value": 0,
    },
    "quality": {
        "enabled": True,
        "min_face_size": 50,
        "max_face_size": 2000,
        "blur_threshold": 100.0,
        "check_occlusion": True,
        "occlusion_threshold": 0.3,
        "min_brightness": 30,
        "max_brightness": 225,
        "min_contrast": 20,
    },
    "pipeline": {
        "normalize": {"enabled": True, "mean": [0.485, 0.456, 0.406],
                      "std": [0.229, 0.224, 0.225]},
        "color_space": "RGB",
        "save_intermediate": True,
        "save_format": "png",
        "jpg_quality": 95,
        "batch_size": 64,
    },
    "datasets": {
        "lfw_fer": {"path": "data/raw/LFW-FER", "image_extension": ".jpg", "label_file": None},
        "deeper_forensics": {
            "path": "data/raw/DeeperForensics",
            "real_folder": "real",
            "fake_folder": "fake",
            "image_extension": ".png",
            "video_extensions": [".mp4"],
            "frame_stride": 30,
            "max_frames_per_video": 10,
        },
        "gen_ai": {
            "path": "data/raw/GenAI",
            "real_folder": "real",
            "fake_folder": "fake",
            "image_extensions": [".png", ".jpg", ".jpeg"],
            "video_extensions": [".mp4"],
            "frame_stride": 30,
            "max_frames_per_video": 10,
        },
    },
    "output": {
        "base_dir": "data/processed",
        "faces_dir": "faces",
        "landmarks_dir": "landmarks",
        "metadata_dir": "metadata",
        "naming_pattern": "{dataset}_{label}_{id:06d}",
        "metadata_format": "csv",
    },
    "logging": {
        "level": "INFO",
        "log_dir": "outputs/logs",
        "log_file": "preprocessing_{timestamp}.log",
        "console_output": True,
    },
    "performance": {"batch_size": 64, "num_workers": 4, "prefetch_batches": 2},
}
