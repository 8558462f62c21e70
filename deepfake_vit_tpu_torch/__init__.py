"""PyTorch + CUDA port of the deepfake detection framework.

Mirrors the module layout of the JAX package (``ops/``, ``models/``,
``preprocessing/``, ``e2e.py``) so each function has an obvious
counterpart, but is written in PyTorch idiom: ``nn.Module``s, explicit
devices and ``torch.Generator`` initialization. The kernels of the
serving paths are hand-written CUDA C++ for Hopper, each with a plain
PyTorch version beside its wrapper: fractional window crop, pooled window
crop and legacy-tap affine warp (``csrc/warp.cu``, ``ops/warp_kernel.py``),
s8 GEMM and s8 convolution (``csrc/int8.cu``, ``ops/int8_kernel.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
