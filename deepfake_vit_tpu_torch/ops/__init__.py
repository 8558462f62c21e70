"""Batched tensor ops of the serving and training paths (PyTorch
counterparts of ``deepfake_vit_tpu.ops``)."""
