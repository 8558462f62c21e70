"""Fused EfficientNet early stages: the stem and whole MBConv blocks with
BatchNorm folded into the weights, hand-written in CUDA C++ for Hopper
(``csrc/fused.cu``). Inference only.

Counterpart of ``deepfake_vit_tpu/ops/pallas/fused_stages.py`` with the same
rounding points (see :func:`run_block_plain`, which spells them out): bf16
activations, expand and project weights rounded to bf16, f32 depthwise taps
and squeeze-excite weights, f32 accumulation everywhere. Activations are
NHWC at every public function, as in the JAX package's runner.

What has no counterpart here, because it answers the TPU's memory system
and does not change the result: ``group_for`` and the per-cell channel
groups with ``cexp`` padded to a multiple of them (padded channels are exact
zeros), ``space_to_depth_phases`` and ``space_to_depth_stem`` (the phase
planes and the 27-plane im2col stack that turn strided reads into matmuls
and lane rolls: a CUDA thread reads its neighbours directly), ``LANES`` (the
128-lane padding of W) and ``_HALO``. Folded weights are therefore flat:
``(cexp, cin)`` where the JAX package has ``(G, group, cin)``.

Each wrapper (:func:`run_stem`, :func:`run_block`) checks its inputs,
allocates output and scratch with ``torch.empty`` and launches on the
current stream when the tensors lie on a CUDA device; for CPU tensors it
runs the plain PyTorch version beside it. ``launches`` counts kernel
launches and nothing else: one per call of ``run_stem`` (one device launch)
and one per call of ``run_block`` (a group of ``LAUNCHES_PER_BLOCK`` device
launches: pass 1, squeeze-excite, pass 2). The kernels do the stem's
27-term product and the block's two 1×1 products on the tensor cores (bf16
``mma.sync``, f32 accumulators), which sum in their own order, so kernel and
plain version agree within two bf16 steps, not bit for bit; the depthwise
conv and the squeeze-excite of the plain version repeat the kernels' order
of operations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.quant import folded_hwio
from .cuda_build import SMEM_PER_BLOCK, check, library, stream

LAUNCHES_PER_BLOCK = 3  # device launches behind one run_block call
_TILE = 8               # the kernels' output tile (csrc/fused.cu)
_CHUNK = 32             # expanded channels per chunk there
_MAX_GROUP = 192        # output channels of a projection group there, at most


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Static description of one MBConv block."""

    kernel: int            # 3 or 5
    stride: int            # 1 or 2
    cin: int
    cexp: int
    cse: int
    cout: int
    has_expand: bool
    residual: bool


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Blocks executed back to back at one output resolution, optionally
    entered through the stem (each block is its own launch group)."""

    blocks: Tuple[BlockPlan, ...]
    h_in: int
    stem: bool = False
    c_stem: int = 0

    @property
    def downsamples(self) -> bool:
        return bool(self.stem or (self.blocks and self.blocks[0].stride == 2))

    @property
    def h_out(self) -> int:
        return self.h_in // 2 if self.downsamples else self.h_in


def block_plan_from_args(args: Dict[str, Any]) -> BlockPlan:
    return BlockPlan(
        kernel=args["kernel"],
        stride=args["stride"],
        cin=args["in_filters"],
        cexp=args["in_filters"] * args["expand_ratio"],
        cse=max(1, int(args["in_filters"] * args["se_ratio"])),
        cout=args["out_filters"],
        has_expand=args["expand_ratio"] != 1,
        residual=args["stride"] == 1 and args["in_filters"] == args["out_filters"],
    )


# ---------------------------------------------------------------------------
# Weight folding
# ---------------------------------------------------------------------------


def fold_stem_weights(backbone) -> List[torch.Tensor]:
    """Stem 3×3-s2 conv with its BatchNorm folded: [w (C0, 27) bf16,
    b (C0,) f32]; column (dy·3 + dx)·3 + ci, tap dy reads input row 2y + dy."""
    k, b = folded_hwio(backbone.stem_conv, backbone.stem_bn)  # (3, 3, 3, C0)
    w = k.permute(3, 0, 1, 2).reshape(k.shape[-1], 27)
    return [w.to(torch.bfloat16).contiguous(), b]


def fold_block_weights(block, bp: BlockPlan) -> List[torch.Tensor]:
    """Fold one ``MBConvBlock`` module into the kernel's weights.

    Order (the JAX package's, ungrouped): [w_exp (cexp, cin) bf16, b_exp
    (cexp,) f32, taps (k², cexp) f32, b_dw (cexp,) f32, w_se1 (cse, cexp)
    f32, b_se1 (cse,) f32, w_se2 (cexp, cse) f32, b_se2 (cexp,) f32, w_proj
    (cout, cexp) bf16, b_proj (cout,) f32]. A block without an expand conv
    gets the identity and a zero bias there, which the kernels never read
    (e = x)."""
    with torch.no_grad():
        dev = block.project_conv.weight.device
        if bp.has_expand:
            ke, b_exp = folded_hwio(block.expand_conv, block.bn0)
            w_exp = ke[0, 0].t()
        else:
            w_exp = torch.eye(bp.cexp, bp.cin, device=dev)
            b_exp = torch.zeros(bp.cexp, device=dev)
        kdw, b_dw = folded_hwio(block.depthwise_conv, block.bn1)  # (k, k, 1, cexp)
        taps = kdw.reshape(bp.kernel ** 2, bp.cexp)
        w_se1 = block.se_reduce.weight[:, :, 0, 0].float()
        b_se1 = block.se_reduce.bias.float()
        w_se2 = block.se_expand.weight[:, :, 0, 0].float()
        b_se2 = block.se_expand.bias.float()
        kp, b_proj = folded_hwio(block.project_conv, block.bn2)
        w_proj = kp[0, 0].t()
        out = [w_exp.to(torch.bfloat16), b_exp, taps, b_dw, w_se1, b_se1, w_se2, b_se2,
               w_proj.to(torch.bfloat16), b_proj]
        return [t.detach().clone().contiguous() for t in out]


# ---------------------------------------------------------------------------
# Checks shared by the wrappers
# ---------------------------------------------------------------------------


def _check_activation(name: str, x: torch.Tensor, channels: int) -> None:
    if x.dim() != 4 or x.shape[3] != channels:
        raise ValueError(f"{name}: x must be (B, H, W, {channels}) NHWC, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bf16 activations, got {x.dtype}")
    if x.shape[0] < 1:
        raise ValueError(f"{name}: empty batch")


def _check_weights(name: str, dev, weights: Sequence[torch.Tensor], spec) -> None:
    if len(weights) != len(spec):
        raise ValueError(f"{name}: {len(weights)} weight tensors, expected {len(spec)}")
    for (label, shape, dtype), t in zip(spec, weights):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: {label} must be {shape} {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _block_spec(bp: BlockPlan):
    f32, b16 = torch.float32, torch.bfloat16
    return (("w_exp", (bp.cexp, bp.cin), b16), ("b_exp", (bp.cexp,), f32),
            ("taps", (bp.kernel ** 2, bp.cexp), f32), ("b_dw", (bp.cexp,), f32),
            ("w_se1", (bp.cse, bp.cexp), f32), ("b_se1", (bp.cse,), f32),
            ("w_se2", (bp.cexp, bp.cse), f32), ("b_se2", (bp.cexp,), f32),
            ("w_proj", (bp.cout, bp.cexp), b16), ("b_proj", (bp.cout,), f32))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load and store 16 bytes)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def check_plan(name: str, bp: BlockPlan) -> None:
    """What the block kernels take, as far as the plan says; raises on
    everything else."""
    if bp.kernel not in (3, 5) or bp.stride not in (1, 2):
        raise ValueError(f"{name}: kernel {bp.kernel} stride {bp.stride} is not k3/k5 at stride 1/2")
    if bp.cin % 8 or bp.cexp % 8 or bp.cout % 8:
        raise ValueError(f"{name}: channel counts must be multiples of 8, got "
                         f"{bp.cin} -> {bp.cexp} -> {bp.cout}")
    if not bp.has_expand and bp.cexp != bp.cin:
        raise ValueError(f"{name}: a block without an expand conv has cexp == cin")
    if bp.residual and (bp.stride != 1 or bp.cin != bp.cout):
        raise ValueError(f"{name}: a residual needs stride 1 and cin == cout")
    need = block_smem_bytes(bp)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"{name}: the tile needs {need} bytes of shared memory, "
                         f"more than a block's {SMEM_PER_BLOCK}")


def check_block(name: str, bp: BlockPlan, x: torch.Tensor, weights) -> None:
    """Plan, activation and weights of one block call; raises on what the
    kernels do not take."""
    check_plan(name, bp)
    _check_activation(name, x, bp.cin)
    _check_weights(name, x.device, weights, _block_spec(bp))
    if bp.stride == 2 and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"{name}: a stride-2 block needs even H and W, got {tuple(x.shape[1:3])}")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: batch {x.shape[0]} exceeds the grid's 65535")


def proj_group(cout: int) -> int:
    """Output channels of one projection group of pass 2 (csrc/fused.cu):
    cout split into as few groups of at most 192 as it takes, as even as
    multiples of 8 allow (200 → 104 + 96, 224 → 112 + 112)."""
    groups = -(-cout // _MAX_GROUP)
    size = -(-cout // groups)
    return -(-size // 8) * 8


def block_smem_bytes(bp: BlockPlan) -> int:
    """Shared memory of pass 2 for this block (the layout of csrc/fused.cu):
    the bf16 input tile with its halo (rows padded to 16, channels to 16 and
    8 more), f32 e, the chunk's bf16 expand weights and f32 taps, bf16 scaled
    d, and one projection group's bf16 weights and output tile."""
    def a16(v):
        return (v + 15) & ~15

    tin = bp.stride * (_TILE - 1) + bp.kernel
    npin = tin * tin
    xrow = -(-bp.cin // 16) * 16 + 8
    row = _CHUNK + 8  # a row of e (f32), of scaled d and of a projection weight (bf16)
    group = proj_group(bp.cout)
    regions = (-(-npin // 16) * 16 * xrow * 2, npin * row * 4, _CHUNK * xrow * 2,
               bp.kernel ** 2 * _CHUNK * 4, 3 * _CHUNK * 4, 8 * _CHUNK * 4, npin,
               _TILE * _TILE * row * 2, group * row * 2, _TILE * _TILE * (group + 2) * 2)
    return sum(a16(r) for r in regions)


def _tiles(h: int, w: int) -> int:
    return -(-h // _TILE) * -(-w // _TILE)


# ---------------------------------------------------------------------------
# Stem
# ---------------------------------------------------------------------------


class StemPlan(NamedTuple):
    """Launch plan of the stem kernel (``fused_stem_kernel``)."""

    rows: int          # output rows of a work item
    seg: int           # output columns of a work item: the whole row up to 128
    row_stride: int    # bf16 elements of a staged input row: 6·seg + 6, rounded up to 8
    copy_bytes: int    # 16-byte cp.async when an image row is a multiple of 16 bytes, else 4
    items: int         # work items (band, segment) per image
    smem_bytes: int    # two buffers of staged input rows and the item's output


_STEM_SEG = 128     # output columns of a work item at most (a multiple of 4: 16-byte aligned starts)
_STEM_PIXELS = 256  # output pixels a work item aims at


def stem_plan(h: int, w: int, c_stem: int) -> StemPlan:
    """Work item and shared memory of the stem kernel for (B, h, w, 3) images.

    A work item is ``rows`` output rows by ``seg`` output columns of one
    image; a persistent block walks the items, staging the 2·rows + 1 input
    rows of the next item (each over the segment's 2·seg + 2 input pixels,
    the last two zeros past the image: 6·seg + 6 bf16) while it computes
    the current one, whose output is staged as rows·seg pixels of
    c_stem + 8 bf16 (the pad spreads a fragment's stores over the banks)."""
    ho, wo = h // 2, w // 2
    seg = min(wo, _STEM_SEG)
    rows = max(1, min(ho, _STEM_PIXELS // seg))
    row_stride = -(-(6 * seg + 6) // 8) * 8

    def smem(r):
        return 2 * (2 * r + 1) * row_stride * 2 + r * seg * (c_stem + 8) * 2

    while rows > 1 and smem(rows) > SMEM_PER_BLOCK:
        rows -= 1
    if smem(rows) > SMEM_PER_BLOCK:
        raise ValueError(f"run_stem: {c_stem} channels over {seg} columns need {smem(rows)} "
                         f"bytes of shared memory a block, more than {SMEM_PER_BLOCK}")
    items = -(-ho // rows) * -(-wo // seg)
    return StemPlan(rows, seg, row_stride, 16 if w % 8 == 0 else 4, items, smem(rows))


def run_stem_plain(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the stem kernel:
    ``bf16(silu(W(bf16) · patch(bf16) + b))`` with an f32 sum over the 27
    taps of the 3×3 stride-2 window (pad 0 before, 1 after)."""
    w, b = weights
    B, H, W, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 0, 1, 0, 1))
    patches = torch.cat([xp[:, dy:dy + H:2, dx:dx + W:2, :] for dy in range(3) for dx in range(3)],
                        dim=-1)  # (B, H/2, W/2, 27), column (dy·3 + dx)·3 + ci
    return F.silu(patches @ w.float().t() + b).to(torch.bfloat16)


def run_stem(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """EfficientNet stem: 3×3 stride-2 conv (TF 'SAME' on even sizes), folded
    BatchNorm, SiLU.

    x: (B, H, W, 3) bf16 NHWC normalized images, H and W even; weights: the
    pair of :func:`fold_stem_weights`. Returns (B, H/2, W/2, C0) bf16 NHWC.
    """
    _check_activation("run_stem", x, 3)
    if len(weights) != 2:
        raise ValueError("run_stem: weights are the (w, b) pair of fold_stem_weights")
    c_stem = weights[0].shape[0]
    _check_weights("run_stem", x.device, weights,
                   (("w", (c_stem, 27), torch.bfloat16), ("b", (c_stem,), torch.float32)))
    B, H, W, _ = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"run_stem: H and W must be even, got {(H, W)}")
    if c_stem % 8:
        raise ValueError(f"run_stem: stem channels must be a multiple of 8, got {c_stem}")
    if x.device.type == "cpu":
        return run_stem_plain(x, weights)
    if x.device.type != "cuda":
        raise RuntimeError(f"run_stem has no kernel for device {x.device}")
    plan = stem_plan(H, W, c_stem)
    if B * plan.items >= 2 ** 31:
        raise ValueError(f"run_stem: {B} images of {plan.items} work items are too many")
    x, w, b = (_aligned(t) for t in (x, *weights))
    out = torch.empty((B, H // 2, W // 2, c_stem), dtype=torch.bfloat16, device=x.device)
    err = library().dfv_fused_stem(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   B, H, W, c_stem, plan.rows, plan.seg, plan.row_stride,
                                   plan.copy_bytes, plan.smem_bytes, stream())
    check(err, "run_stem")
    run_stem.launches += 1
    return out


run_stem.launches = 0


# ---------------------------------------------------------------------------
# MBConv block
# ---------------------------------------------------------------------------


def depthwise_plain(e: torch.Tensor, taps: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """f32 depthwise conv on NHWC ``e`` (B, H, W, C) with taps (k², C), zero
    padding: symmetric k//2 at stride 1; at stride 2 on even sizes TF 'SAME',
    (k−2)//2 before. One multiply-add per tap, taps in (dy, dx) order."""
    _, H, W, _ = e.shape
    Ho, Wo = H // stride, W // stride
    before = kernel // 2 if stride == 1 else (kernel - 2) // 2
    after = kernel - 1 - before if stride == 1 else kernel - 2 - before
    ep = F.pad(e, (0, 0, before, after, before, after))
    acc = torch.zeros((e.shape[0], Ho, Wo, e.shape[3]), dtype=torch.float32, device=e.device)
    for dy in range(kernel):
        for dx in range(kernel):
            view = ep[:, dy:dy + stride * (Ho - 1) + 1:stride, dx:dx + stride * (Wo - 1) + 1:stride]
            acc = acc + view * taps[dy * kernel + dx]
    return acc


def _running_sum(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` one term after the other (float32 adds in index order)."""
    parts = terms.unbind(dim)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def tile_mean_plain(d: torch.Tensor) -> torch.Tensor:
    """Per-image channel means of NHWC ``d`` (B, H, W, C), summed in the
    kernels' order: the 8 columns of a row of an 8×8 tile, the tile's 8 rows,
    then the tiles row-major; divided by H·W."""
    B, H, W, C = d.shape
    t = F.pad(d, (0, 0, 0, -W % _TILE, 0, -H % _TILE))
    t = t.reshape(B, -(-H // _TILE), _TILE, -(-W // _TILE), _TILE, C)
    tiles = _running_sum(_running_sum(t, 4), 2)  # (B, tiles_y, tiles_x, C)
    return _running_sum(tiles.reshape(B, -1, C), 1) / float(H * W)


def squeeze_excite_plain(mean, w_se1, b_se1, w_se2, b_se2) -> torch.Tensor:
    """``sigmoid(W_se2 · silu(W_se1 · mean + b_se1) + b_se2)`` in float32 with
    the kernels' summation order: the first product as 32 interleaved running
    sums (channel c in sum c mod 32) joined by a butterfly, the second as one
    running sum; every multiply and add rounded on its own."""
    B, C = mean.shape
    prod = F.pad(w_se1 * mean[:, None, :], (0, -C % 32)).reshape(B, w_se1.shape[0], -1, 32)
    s = _running_sum(prod, 2)
    lanes = torch.arange(32, device=mean.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ off]
    s1 = F.silu(s[..., 0] + b_se1)
    return torch.sigmoid(_running_sum(w_se2 * s1[:, None, :], 2) + b_se2)


def mbconv_plain(bp: BlockPlan, x: torch.Tensor, weights: Sequence[torch.Tensor],
                 proto: bool = False) -> torch.Tensor:
    """The block's arithmetic in plain PyTorch, rounding where the TPU
    kernels round. ``proto=False`` is the fused-stage block, ``proto=True``
    the single-block prototype:

    1. ``e = silu(W_exp(bf16) · x(bf16) + b_exp)`` in f32, then **rounded to
       bf16** (prototype: kept in f32). Without an expand conv ``e = x``.
    2. ``d = silu(depthwise(e) + b_dw)``: f32 taps, zero padding (``e`` is 0
       outside the image, not ``silu(b_exp)``).
    3. squeeze-excite in f32 from the mean of the **f32** ``d`` (prototype:
       of ``bf16(d)``): ``se = sigmoid(W_se2 · silu(W_se1 · mean + b_se1) + b_se2)``,
       summed in the kernels' order (:func:`tile_mean_plain`,
       :func:`squeeze_excite_plain`).
    4. ``out = bf16(W_proj(bf16) · bf16(f32(bf16(d)) · se) + b_proj [+ x])``.
    """
    w_exp, b_exp, taps, b_dw, w_se1, b_se1, w_se2, b_se2, w_proj, b_proj = weights
    xf = x.float()
    if bp.has_expand:
        e = F.silu(xf @ w_exp.float().t() + b_exp)
        if not proto:
            e = e.to(torch.bfloat16).float()
    else:
        e = xf
    d = F.silu(depthwise_plain(e, taps, bp.kernel, bp.stride) + b_dw)
    d16 = d.to(torch.bfloat16).float()
    se = squeeze_excite_plain(tile_mean_plain(d16 if proto else d), w_se1, b_se1, w_se2, b_se2)
    scaled = (d16 * se[:, None, None, :]).to(torch.bfloat16).float()
    out = scaled @ w_proj.float().t() + b_proj
    if bp.residual:
        out = out + xf
    return out.to(torch.bfloat16)


def launch_block(entry: str, bp: BlockPlan, x: torch.Tensor,
                 weights: Sequence[torch.Tensor], extra: Tuple[int, ...]) -> torch.Tensor:
    """Allocate output and scratch and call one of the library's two block
    entries (``extra``: the trailing integer arguments after ``cout``)."""
    B, H, W, _ = x.shape
    Ho, Wo = H // bp.stride, W // bp.stride
    x, *weights = (_aligned(t) for t in (x, *weights))
    dev = x.device
    out = torch.empty((B, Ho, Wo, bp.cout), dtype=torch.bfloat16, device=dev)
    partials = torch.empty((B, _tiles(Ho, Wo), bp.cexp), dtype=torch.float32, device=dev)
    se = torch.empty((B, bp.cexp), dtype=torch.float32, device=dev)
    err = getattr(library(), entry)(
        x.data_ptr(), *(w.data_ptr() for w in weights), partials.data_ptr(), se.data_ptr(),
        out.data_ptr(), B, H, W, bp.cin, bp.cexp, bp.cse, bp.cout, *extra, stream())
    check(err, entry)
    return out


def run_block_plain(bp: BlockPlan, x: torch.Tensor,
                    weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the block kernels (see :func:`mbconv_plain`)."""
    return mbconv_plain(bp, x, weights, proto=False)


def run_block(bp: BlockPlan, x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """One whole MBConv block, BatchNorm folded: expand 1×1 → SiLU →
    depthwise k3/k5 at stride 1 or 2 → SiLU → squeeze-excite → project 1×1 →
    residual. The expanded activations never reach device memory.

    x: (B, H, W, cin) bf16 NHWC (H, W even at stride 2); weights: the ten
    tensors of :func:`fold_block_weights`. Returns (B, H/stride, W/stride,
    cout) bf16 NHWC.
    """
    check_block("run_block", bp, x, weights)
    if x.device.type == "cpu":
        return run_block_plain(bp, x, weights)
    if x.device.type != "cuda":
        raise RuntimeError(f"run_block has no kernel for device {x.device}")
    out = launch_block("dfv_fused_block", bp, x, weights,
                       (bp.kernel, bp.stride, int(bp.has_expand), int(bp.residual)))
    run_block.launches += 1
    return out


run_block.launches = 0


def run_stage(plan: StagePlan, x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Execute one stage: the stem, if the plan has it, then its blocks.

    x: NHWC bf16 — the images (B, h_in, h_in, 3) for a stem stage, else the
    previous stage's output (B, h_in, h_in, cin). ``weights``: the stem pair
    (if any) followed by ten tensors per block. Returns (B, h_out, h_out,
    cout_last) bf16."""
    it = iter(weights)
    if plan.stem:
        x = run_stem(x, [next(it), next(it)])
    for bp in plan.blocks:
        x = run_block(bp, x, [next(it) for _ in range(10)])
    return x


__all__ = ["BlockPlan", "StagePlan", "StemPlan", "LAUNCHES_PER_BLOCK", "block_plan_from_args",
           "block_smem_bytes", "check_block", "check_plan", "proj_group", "fold_stem_weights", "fold_block_weights", "run_stem",
           "run_stem_plain", "stem_plan", "run_block", "run_block_plain", "run_stage",
           "mbconv_plain",
           "depthwise_plain", "tile_mean_plain", "squeeze_excite_plain", "launch_block"]
