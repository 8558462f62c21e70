"""Fused-stage backbone runner: the early EfficientNet stages through the
fused kernels (``ops/fused_stages.py``), the late stages and the head left
to the stock backbone.

Counterpart of ``deepfake_vit_tpu/models/fused_backbone.py``: the same
plans and split point. The runner works on NHWC tensors throughout (the
kernels' own layout), so nothing is reshaped between the stages.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops.fused_stages import (StagePlan, block_plan_from_args, check_plan, fold_block_weights,
                                fold_stem_weights, run_stage)
from .efficientnet import VARIANT_PARAMS, EfficientNetBackbone, block_args, round_filters

_MIN_FUSED_H = 14  # stop fusing below this output resolution


def plan_fused_stages(variant: str, image_size: int = 224, min_fused_h: int = _MIN_FUSED_H
                      ) -> Tuple[List[Tuple[StagePlan, List[int]]], int]:
    """Resolution-group plan: [(StagePlan, flat block indices)], tail_start.

    Blocks are grouped by output resolution; the first group enters through
    the stem, every later one through a stride-2 block. Fusing stops once
    the running resolution drops below ``min_fused_h``."""
    blocks = block_args(variant)
    c_stem = round_filters(32, VARIANT_PARAMS[variant][0])
    plans: List[Tuple[StagePlan, List[int]]] = []
    cur: List[int] = []
    cur_h_in, cur_stem = image_size, True
    h = image_size // 2  # after the stem
    tail_start = len(blocks)

    def flush():
        nonlocal cur, cur_stem
        if cur or cur_stem:
            bps = tuple(block_plan_from_args(blocks[i]) for i in cur)
            plans.append((StagePlan(blocks=bps, h_in=cur_h_in, stem=cur_stem, c_stem=c_stem),
                          list(cur)))
        cur, cur_stem = [], False

    for i, args in enumerate(blocks):
        h_after = h // args["stride"]
        if h_after < min_fused_h:
            tail_start = i
            break
        if args["stride"] == 2 and (cur or cur_stem):
            flush()
            cur_h_in = h
        cur.append(i)
        h = h_after
        tail_start = i + 1
    flush()
    return plans, tail_start


class FusedBackboneRunner:
    """Callable: NHWC images → NHWC activations at ``tail_start``'s input.

    Built once from a backbone module: BatchNorms are folded here, not per
    call, so this is an inference object; build it again after the
    backbone's weights change. Finish the network with
    ``backbone(x.permute(0, 3, 1, 2), start_block=runner.tail_start)``.
    """

    def __init__(self, backbone: EfficientNetBackbone, image_size: int = 224,
                 min_fused_h: int = _MIN_FUSED_H):
        self.variant = backbone.variant
        self.image_size = image_size
        self.plans, self.tail_start = plan_fused_stages(self.variant, image_size, min_fused_h)
        self.weights: List[List[torch.Tensor]] = []
        for plan, idxs in self.plans:
            ws: List[torch.Tensor] = []
            if plan.stem:
                ws += fold_stem_weights(backbone)
            for i, bp in zip(idxs, plan.blocks):
                check_plan(f"FusedBackboneRunner, block {i}", bp)  # fail here, not in a call
                ws += fold_block_weights(getattr(backbone, f"block_{i}"), bp)
            self.weights.append(ws)

    @property
    def n_blocks(self) -> int:
        return sum(len(idxs) for _, idxs in self.plans)

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, S, S, 3) normalized NHWC, S == ``image_size``.
        Returns the (B, h, h, C) bf16 NHWC input of flat block ``tail_start``."""
        if images.dim() != 4 or tuple(images.shape[1:3]) != (self.image_size, self.image_size):
            raise ValueError(f"FusedBackboneRunner was planned for {self.image_size}² images, "
                             f"got {tuple(images.shape)}")
        x = images.to(torch.bfloat16)
        for (plan, _), ws in zip(self.plans, self.weights):
            x = run_stage(plan, x, ws)
        return x


__all__ = ["FusedBackboneRunner", "plan_fused_stages"]
