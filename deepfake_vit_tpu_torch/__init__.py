"""PyTorch + CUDA port of the deepfake detection framework.

Mirrors the module layout of the JAX package (``ops/``, ``models/``,
``preprocessing/``, ``training/``, ``data/``, ``e2e.py``) so each function
has an obvious counterpart, but is written in PyTorch idiom:
``nn.Module``s with ``train()`` / ``eval()``, ``torch.autograd``, explicit
devices and explicit ``torch.Generator``s. Entry points: ``predict``,
``train`` and ``evaluate`` (``python -m deepfake_vit_tpu_torch.<name>``).
The kernels are hand-written CUDA C++ for Hopper, each with a plain
PyTorch version beside its wrapper: fractional and pooled window crops and
the affine warp (``csrc/warp.cu``, ``ops/warp_kernel.py``; the train
step's augmentation rotates through the warp), s8 GEMM and s8
convolution (``csrc/int8.cu``, ``ops/int8_kernel.py``), the fused stem
and MBConv blocks (``csrc/fused.cu``, ``ops/fused_stages.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
