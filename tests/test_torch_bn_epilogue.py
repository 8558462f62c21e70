"""The backbone's BatchNorm epilogues (``ops/bn_epilogue.py``) on the CPU:
the plain versions against the eager expressions they stand for, the
wrappers' checks, the launch plan, the factor cache, and when the backbone
hands an epilogue to the kernels. The kernels themselves are held to the
plain versions bit for bit on the card (``tests/test_torch_gpu_kernels.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone, block_args
from deepfake_vit_tpu_torch.models.layers import BatchNorm, init_weights
from deepfake_vit_tpu_torch.ops import bn_epilogue as be
from deepfake_vit_tpu_torch.ops.cuda_build import SM_COUNT


def _bn(C, seed, eps=1e-3):
    bn = BatchNorm(C, eps).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        bn.weight.copy_(torch.exp(torch.randn(C, generator=g)))
        bn.bias.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_mean.copy_(torch.randn(C, generator=g))
        bn.running_var.copy_(torch.exp(torch.randn(C, generator=g)))
    return bn


def _x(B, C, H, seed, scale=3.0):
    g = torch.Generator().manual_seed(seed)
    x = (scale * torch.randn(B, H, H, C, generator=g)).to(torch.bfloat16)
    return x.permute(0, 3, 1, 2)  # channels-last, as the backbone's conv outputs


def _randomize_bns(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            with torch.no_grad():
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + (0.2 * torch.randn(n, generator=g)).abs())
    return module


@pytest.mark.parametrize("epilogue", ["bn_act", "bn", "bn_residual", "se_gate"])
def test_plain_versions_equal_the_eager_expressions(epilogue):
    """Bit for bit, in bf16 on channels-last tensors; the CPU wrappers run
    the plain versions and count no launch."""
    B, C, H = 3, 24, 9
    bn, x = _bn(C, 1), _x(B, C, H, 2)
    factors = be.bn_factors(bn)
    before = (be.bn_act.launches, be.bn_add.launches, be.se_gate.launches)
    with torch.no_grad():
        if epilogue == "bn_act":
            want, plain, got = F.silu(bn(x)), be.bn_act_plain(x, factors), be.bn_act(x, factors)
        elif epilogue == "bn":
            want, plain, got = bn(x), be.bn_add_plain(x, factors), be.bn_add(x, factors)
        elif epilogue == "bn_residual":
            r = _x(B, C, H, 3)
            want = bn(x) + r
            plain, got = be.bn_add_plain(x, factors, r), be.bn_add(x, factors, r)
        else:
            gate = torch.sigmoid(_x(B, C, 1, 4, 2.0))
            want = x * gate
            plain = be.se_gate_plain(x, gate.reshape(B, C).contiguous())
            got = be.se_gate(x, gate.reshape(B, C).contiguous())
    assert want.dtype == torch.bfloat16
    assert torch.equal(plain, want) and torch.equal(got, want)
    assert (be.bn_act.launches, be.bn_add.launches, be.se_gate.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    bn, x = _bn(24, 0), _x(2, 24, 5, 0)
    f = be.bn_factors(bn)
    with pytest.raises(TypeError):
        be.bn_act(x.float(), f)
    with pytest.raises(ValueError):
        be.bn_act(x.contiguous(), f)  # NCHW-contiguous
    with pytest.raises(ValueError):
        be.bn_act(_x(2, 20, 5, 0), be.bn_factors(_bn(20, 0)))  # C not a multiple of 8
    with pytest.raises(ValueError):
        be.bn_act(x, f[:, :16])
    with pytest.raises(ValueError):
        be.bn_add(x, f, x.contiguous())  # residual NCHW-contiguous
    with pytest.raises(ValueError):
        be.bn_add(x, f, _x(1, 24, 5, 1))
    with pytest.raises(ValueError):
        be.se_gate(x, torch.ones(2, 24, dtype=torch.bfloat16).t().contiguous().t())
    with pytest.raises(ValueError):
        be.se_gate(x, torch.ones(2, 24))


# The B4's epilogue shapes at 224² faces, B = 128 (C, side), and ragged ones.
B4_SHAPES = [(128, 48, 112), (128, 144, 112), (128, 24, 112), (128, 192, 56), (128, 336, 28),
             (128, 960, 14), (128, 2688, 7), (128, 1792, 7), (5, 144, 112), (3, 8, 1),
             (1, 2688, 7)]


@pytest.mark.parametrize("shape", B4_SHAPES, ids=[f"B{b}-C{c}-{h}" for b, c, h in B4_SHAPES])
def test_epilogue_plan_is_one_wave_of_whole_pixel_rows(shape):
    B, C, H = shape
    plan = be.epilogue_plan((B, C, H, H))
    threads = plan.lanes * plan.cv
    assert plan.nvec == B * C * H * H // 8 and plan.cv == C // 8 and plan.hwcv == H * H * plan.cv
    assert 1 <= plan.lanes <= B * H * H
    assert (plan.blocks - 1) * be.EPILOGUE_THREADS < threads <= plan.blocks * be.EPILOGUE_THREADS
    assert plan.blocks <= SM_COUNT * be.EPILOGUE_BLOCKS_PER_SM
    if B * H * H * plan.cv >= SM_COUNT * be.EPILOGUE_BLOCKS_PER_SM * be.EPILOGUE_THREADS:
        assert threads > (SM_COUNT * be.EPILOGUE_BLOCKS_PER_SM - 1) * be.EPILOGUE_THREADS - C
    # A thread's channels stay put: its stride is whole pixels.
    assert threads % plan.cv == 0


def test_bn_factors_follow_the_parameters():
    bn = _bn(16, 5)
    f = be.bn_factors(bn)
    want = torch.stack([bn.running_mean, torch.rsqrt(bn.running_var + bn.eps) * bn.weight,
                        bn.bias])
    assert torch.equal(f, want) and f.dtype == torch.float32
    assert be.bn_factors(bn) is f  # cached
    with torch.no_grad():
        bn.running_var.mul_(2.0)  # a version bump: recomputed
    g = be.bn_factors(bn)
    assert g is not f and torch.equal(g[1], torch.rsqrt(bn.running_var + bn.eps) * bn.weight)
    with torch.no_grad():
        bn.bias.add_(1.0)
    h = be.bn_factors(bn)
    assert torch.equal(h[2], bn.bias)
    with torch.inference_mode():
        assert be.bn_factors(bn) is h


# b0 and b4 forwards: (bn_act, bn_add, se_gate) launches a forward.
EXPECTED_LAUNCHES = {"b0": (1 + 15 + 16 + 1, 16, 16), "b4": (1 + 30 + 32 + 1, 32, 32)}


def _count_kernels(monkeypatch, kernel_device="cpu"):
    """Take ``kernel_device`` for the kernels' device and put a counting
    launch of the plain versions in the kernels' place; returns the counts
    by wrapper and, per bn_add launch, whether it had a residual."""
    monkeypatch.setattr(be, "_on_kernel_device", lambda t: t.device.type == kernel_device)
    counts, residual = {"bn_act": 0, "bn_add": 0, "se_gate": 0}, []
    modes = {"bn_act": {be._BN_SILU}, "bn_add": {be._BN, be._BN_RESIDUAL},
             "se_gate": {be._SE_GATE}}

    def launch(kernel, mode, x, other, factors):
        name = kernel.__name__
        assert mode in modes[name] and (mode == be._BN_RESIDUAL) == (
            name == "bn_add" and other is not None)
        counts[name] += 1
        if name == "bn_add":
            residual.append(other is not None)
            return be.bn_add_plain(x, factors, other)
        return be.bn_act_plain(x, factors) if name == "bn_act" else be.se_gate_plain(x, other)

    monkeypatch.setattr(be, "_launch", launch)
    return counts, residual


@pytest.mark.parametrize("case", ["no_grad", "inference_mode", "train_step", "autograd_eval",
                                  "float32", "cpu"])
def test_engagement_condition(monkeypatch, case):
    """The backbone hands every epilogue to the kernels in inference on
    bf16 channels-last activations (here the kernel device is taken to be
    the CPU and the wrappers count and run their plain versions), and
    nothing in train mode with autograd, in eval with autograd, in float32
    or on the CPU itself; either way the feature maps equal the eager
    path's bit for bit."""
    bb = _randomize_bns(init_weights(EfficientNetBackbone("b0", dtype=torch.bfloat16), 0), 1)
    bb.drop_connect_rate = 0.0
    bb.train(case == "train_step")
    images = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(2))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    grad = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        case, torch.enable_grad)

    def forward():
        with grad():
            return bb(images, dtype=dtype).detach()

    want = forward()
    counts, _ = _count_kernels(monkeypatch, "cuda" if case == "cpu" else "cpu")
    got = forward()
    engaged = case in ("no_grad", "inference_mode")
    assert tuple(counts.values()) == (EXPECTED_LAUNCHES["b0"] if engaged else (0, 0, 0))
    assert torch.equal(got, want)


def test_b4_hands_128_epilogues_to_the_kernels_a_forward(monkeypatch):
    """64 BatchNorm + SiLU (stem, 30 expands, 32 depthwise, head), 32
    BatchNorm (25 with the residual) and 32 gates, as a served batch."""
    bb = init_weights(EfficientNetBackbone("b4", dtype=torch.bfloat16), 0).eval()
    counts, residual = _count_kernels(monkeypatch)
    with torch.inference_mode():
        bb(torch.randn((1, 16, 16, 3)))
    assert tuple(counts.values()) == EXPECTED_LAUNCHES["b4"]
    assert sum(residual) == sum(b["stride"] == 1 and b["in_filters"] == b["out_filters"]
                                for b in block_args("b4")) == 25
