"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W power limit): the denominators of every roofline and MFU share."""

BF16_FLOPS = 989e12      # dense bf16 tensor-core operations per second
INT8_OPS = 1979e12       # dense int8 tensor-core operations per second
HBM_BYTES = 3.35e12      # device memory bytes per second
