"""The headline model configuration as a Python dict.

The ``model`` block of ``deepfake_vit_tpu/configs/model_config.yaml``
(EfficientNet-B4 + hybrid attention + [512, 128, 32] head), kept here
because the port reads no YAML. A test holds the two equal.
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
