"""The yardstick's operation and byte counts against hand counts."""

import math

import torch

from benchmark import counts
from benchmark.reference import effnet


def effnet_by_hand(variant: str, image: int, hidden, classes: int) -> float:
    """2 × multiply-adds of every convolution and linear layer, block by block."""
    width = effnet.VARIANTS[variant][0]
    stem = effnet.round_filters(32, width)
    h = math.ceil(image / 2)
    total = 2 * h * h * stem * 3 * 9
    for a in effnet.blocks(variant):
        cexp = a["cin"] * a["expand"]
        ho = math.ceil(h / a["stride"])
        if a["expand"] != 1:
            total += 2 * h * h * a["cin"] * cexp
        total += 2 * ho * ho * cexp * a["kernel"] ** 2
        se = max(1, int(a["cin"] * 0.25))
        total += 2 * cexp * se * 2
        total += 2 * ho * ho * cexp * a["cout"]
        h = ho
    head = effnet.feature_dim(variant)
    total += 2 * h * h * effnet.blocks(variant)[-1]["cout"] * head
    total += 2 * 2 * (head * (head // 16) * 2)  # channel MLP on the mean and the max
    total += 2 * h * h * 2 * 49  # spatial attention's 7×7 conv
    cin = head
    for d in hidden:
        total += 2 * cin * d
        cin = d
    return total + 2 * cin * classes


def test_effnet_block_by_block():
    for variant, image, hidden in (("b0", 64, (32, 16)), ("b4", 224, (512, 128, 32))):
        assert counts.effnet_flops(variant, image, hidden, 2) == effnet_by_hand(variant, image,
                                                                                hidden, 2)


def test_b4_at_224_is_about_3_gflop():
    # 4.2 G multiply-adds at 380² (the paper) scale as the area to ~1.5 G at 224².
    assert 2.6e9 < counts.effnet_flops("b4", 224, (512, 128, 32), 2) < 3.4e9


def test_vit_by_hand():
    P, W, M, depth, image = 16, 192, 768, 12, 64
    n = (image // P) ** 2
    L = n + 1
    per_block = 2 * L * W * 3 * W + 2 * 2 * L * L * W + 2 * L * W * W + 2 * 2 * L * W * M
    want = 2 * n * W * 3 * P * P + depth * per_block + 2 * W * 2
    assert counts.vit_flops("tiny16", image, 2) == want


def test_vit_b16_is_about_35_gflop():
    assert 33e9 < counts.vit_flops("base16", 224, 2) < 36e9


def test_warp_bytes_by_hand():
    # Integer source coordinates: one tap a point has a nonzero weight.
    on_grid = torch.tensor([[1.0, 0.0, 3.0, 0.0, 1.0, 5.0]])
    assert counts.warp_bytes(on_grid, (16, 16), (4, 4)) == 16 * 3 * 2 + 4 * 4 * 3 * 4
    # Half a pixel across: two columns a point, 4 rows × 5 columns read.
    half = torch.tensor([[1.0, 0.0, 3.5, 0.0, 1.0, 5.0]])
    assert counts.warp_bytes(half, (16, 16), (4, 4)) == 20 * 3 * 2 + 4 * 4 * 3 * 4
    # Points off the window read nothing.
    off = torch.tensor([[1.0, 0.0, 40.0, 0.0, 1.0, 5.0]])
    assert counts.warp_bytes(off, (16, 16), (4, 4)) == 4 * 4 * 3 * 4


def test_crop_pool_bytes_by_hand():
    one = lambda v: torch.tensor([v])  # noqa: E731
    # Level 1, window 4 at (2, 3) of the pooled frame: frame rows 4..11, columns 6..13.
    assert counts.crop_pool_bytes(one(1), one(2), one(3), (16, 16), 4) == 8 * 8 * 6 + 16 * 6 + 16
    # A block reaching past the frame's edge reads only its part on the frame.
    assert counts.crop_pool_bytes(one(1), one(2), one(6), (16, 16), 4) == 8 * 4 * 6 + 16 * 6 + 16


def test_detector_counts_its_convolutions():
    from benchmark.reference.detector_scrfd import tree_to_torch
    from benchmark.tests.tiny import DETECTOR
    from benchmark.weights import read_msgpack

    shapes = counts.detector_shapes(tree_to_torch(read_msgpack(DETECTOR), "meta"))
    small, big = counts.detector_flops((64, 64), shapes), counts.detector_flops((320, 320), shapes)
    assert big == 25 * small  # every layer's work scales with the canvas's area
    assert 0.5e9 < big < 5e9
