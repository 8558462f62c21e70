"""Batched tensor ops of the serving path (PyTorch counterparts of
``deepfake_vit_tpu.ops``)."""
