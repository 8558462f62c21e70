"""PyTorch + CUDA port of the deepfake detection framework.

Mirrors the module layout of the JAX package (``ops/``, ``models/``,
``preprocessing/``, ``e2e.py``) so each function has an obvious
counterpart, but is written in PyTorch idiom: ``nn.Module``s, explicit
devices and ``torch.Generator`` initialization. The two kernels of the
serving path (fractional window crop, legacy-tap affine warp) are
hand-written CUDA C++ for Hopper (``csrc/warp.cu``), each with a plain
PyTorch version beside its wrapper (``ops/warp_kernel.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
