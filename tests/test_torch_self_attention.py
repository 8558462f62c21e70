"""The transformers' attention-core kernel (``ops/self_attention.py``) on the
CPU: the plain version against the eager expression that
``MultiHeadDotProductAttention.forward`` ran before the kernel, the wrapper's
checks and launch plan, when an attention module hands its QKV product to
the kernel (the kernel's device stood in by the CPU, the launch by a
counting call of the plain version) and the ViT's and TimeSformer's
forwards on the CPU. The kernel itself is held to float32 attention on the
card (``tests/test_torch_gpu_kernels.py``)."""

import math

import pytest
import torch
import torch.nn.functional as F

from deepfake_vit_tpu_torch.models import timesformer
from deepfake_vit_tpu_torch.models.layers import (MultiHeadDotProductAttention, init_weights,
                                                  keep_mask)
from deepfake_vit_tpu_torch.models.timesformer import TimeSformerClassifier
from deepfake_vit_tpu_torch.models.vit import ViTClassifier
from deepfake_vit_tpu_torch.ops import self_attention as sa


def eager_forward(module, x, generator=None):
    """``MultiHeadDotProductAttention.forward`` before the kernel, as it was
    written there."""
    B, L, W = x.shape
    H, dt = module.heads, x.dtype
    hd = W // H
    qkv = F.linear(x, module.qkv_weight.to(dt), module.qkv_bias.to(dt))
    q, k, v = qkv.view(B, L, 3, H, hd).permute(2, 0, 3, 1, 4)
    q = q / torch.tensor(math.sqrt(hd), dtype=dt, device=x.device)
    weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    if module.training and module.dropout_rate > 0.0:
        keep = 1.0 - module.dropout_rate
        mask = keep_mask((L, L), keep, x, generator).to(dt)
        weights = weights * (mask / torch.tensor(keep, dtype=dt, device=x.device))
    o = (weights @ v).transpose(1, 2).reshape(B, L, W)
    return F.linear(o, module.out_weight.to(dt), module.out_bias.to(dt))


def _module(width=128, heads=2, dropout=0.0, seed=0):
    m = init_weights(MultiHeadDotProductAttention(width, heads, dropout), seed)
    with torch.no_grad():  # biases away from 0, so that a mix-up of q, k and v shows
        m.qkv_bias.copy_(0.3 * torch.randn(3 * width, generator=torch.Generator().manual_seed(seed)))
    return m.eval()


def _x(shape, dtype=torch.bfloat16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (1.5 * torch.randn(shape, generator=g, dtype=torch.float64)).to(dtype)


def _qkv(B, L, heads, dtype=torch.bfloat16, seed=2):
    return _x((B, L, 3 * heads * sa.HEAD_DIM), dtype, seed)


def _stand_in(monkeypatch, kernel_device="cpu"):
    """Take ``kernel_device`` for the kernel's device and put a counting
    launch of the plain version in the kernel's place (its output
    contiguous, as the kernel writes it); returns the (B, L, heads,
    strides) of every launch. Each operand handed over passes the
    wrapper's checks and is aligned."""
    monkeypatch.setattr(sa, "_on_kernel_device", lambda t: t.device.type == kernel_device)
    seen = []

    def launch(qkv, heads):
        sa._check(qkv, heads)
        assert qkv.data_ptr() % 16 == 0
        seen.append((*qkv.shape[:2], heads, sa._strides(qkv)))
        sa.self_attention.launches += 1
        return sa.self_attention_plain(qkv, heads).contiguous()

    monkeypatch.setattr(sa, "launch", launch)
    return seen


@pytest.mark.parametrize("L", [1, 8, 197])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_equals_the_eager_expression(dtype, L):
    """Bit for bit: the module's forward on the CPU equals the eager
    expression it ran before the kernel, and ``self_attention_plain`` its
    core between the two projections; the wrapper runs the plain version on
    CPU tensors and counts no launch."""
    m = _module()
    x = _x((3, L, 128), dtype)
    before = sa.self_attention.launches
    with torch.no_grad():
        want = eager_forward(m, x)
        assert want.dtype == dtype
        assert torch.equal(m(x), want)
        qkv = F.linear(x, m.qkv_weight.to(dtype), m.qkv_bias.to(dtype))
        core = sa.self_attention_plain(qkv, m.heads)
        assert torch.equal(F.linear(core, m.out_weight.to(dtype), m.out_bias.to(dtype)), want)
        if dtype == torch.bfloat16:
            assert torch.equal(sa.self_attention(qkv, m.heads), core)
    assert sa.self_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_draws_the_eager_mask(dtype):
    """In training with dropout the module draws its (L, L) mask from the
    generator as before and weights the attention with it: the same output
    bit for bit from the same seed, and gradients through it."""
    m = _module(dropout=0.3).train()
    x = _x((2, 9, 128), dtype).requires_grad_()
    got = m(x, torch.Generator().manual_seed(5))
    want = eager_forward(m, x, torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    got.float().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = _qkv(2, 9, 2)
    with pytest.raises(TypeError):
        sa.self_attention(q.float(), 2)
    with pytest.raises(ValueError):
        sa.self_attention(q, 4)  # heads of 32
    with pytest.raises(ValueError):
        sa.self_attention(_qkv(1, sa.MAX_SEQ + 1, 2), 2)  # longer than the kernel holds
    with pytest.raises(ValueError):
        sa.self_attention(_qkv(2, 9, 2)[:, :0], 2)  # no token
    with pytest.raises(ValueError):
        sa.self_attention(q.transpose(1, 2).contiguous().transpose(1, 2), 2)  # columns strided
    with pytest.raises(ValueError):
        sa.self_attention(torch.zeros((2, 9, 388), dtype=torch.bfloat16)[..., :384], 2)
    with pytest.raises(ValueError):
        sa.self_attention(q[0], 2)  # no batch dim


# (B, L, heads) of the served calls (the ViT's and the TimeSformer's spatial
# attention, the TimeSformer's temporal one), ragged lengths and counts of
# pairs, the plans' edges.
PLAN_CASES = [(128, 197, 12), (3136, 8, 12), (13, 1, 5), (13, 7, 5), (13, 8, 5), (13, 9, 5),
              (13, 16, 5), (13, 17, 5), (13, 63, 5), (13, 200, 5), (1, 256, 1), (1, 1, 1)]


@pytest.mark.parametrize("B,L,heads", PLAN_CASES)
def test_plan_covers_every_pair_once(B, L, heads):
    """Short plan (L ≤ 16): one warp a tile of 16 rows, two pairs a tile up to
    8 tokens and one up to 16, no block without a tile; long plan: one
    block a pair."""
    plan = sa.self_attention_plan(B, heads, L)
    pairs = B * heads
    if L <= sa.SHORT_SEQ:
        assert plan.plan == 0 and plan.size == (8 if L <= 8 else 16)
        per_tile = 16 // plan.size
        warps = plan.blocks * sa.SHORT_WARPS
        assert warps * per_tile >= pairs > (warps - sa.SHORT_WARPS) * per_tile
    else:
        assert plan == (1, 0, pairs)


def test_plan_rejects_lengths_out_of_range():
    for L in (0, sa.MAX_SEQ + 1):
        with pytest.raises(ValueError):
            sa.self_attention_plan(2, 12, L)


# Views of a QKV product whose rows the kernel reads where they lie: the
# product itself, x[:, 1] of a (B, 2, L, 3W) tensor, a slice of wider rows,
# one sequence, an expanded one.
LAYOUT_VIEWS = {
    "contiguous": lambda t: t,
    "second_of_two": lambda t: t.view(3, 2, 9, 384)[:, 1],
    "wider_rows": lambda t: torch.cat([t, t[..., :8]], -1)[..., :384],
    "one_sequence": lambda t: t[2:3],
    "expanded": lambda t: t[:1].expand(4, 9, 384),
}


@pytest.mark.parametrize("view", list(LAYOUT_VIEWS))
def test_strides_find_every_row(view):
    """Row i of sequence b lies at b · batch stride + i · row stride: the
    views' rows as the kernel indexes them are the view's rows."""
    x = LAYOUT_VIEWS[view](_qkv(6, 9, 2))
    assert sa._kernel_layout(x, 2)
    bs, rs = sa._strides(x)
    B, L, W3 = x.shape
    rows = torch.as_strided(x, (B, L, W3), (bs, rs, 1), x.storage_offset())
    assert torch.equal(rows, x)
    assert torch.equal(sa.self_attention(x, 2), sa.self_attention_plain(x.contiguous(), 2))


def _engagement_input(case):
    """(module, x, grad context) of one case."""
    m, x = _module(), _x((3, 9, 128))
    grad = torch.no_grad
    if case == "inference_mode":
        grad = torch.inference_mode
    elif case == "grad_enabled":
        grad = torch.enable_grad
    elif case == "float32":
        x = x.float()
    elif case == "float64_module":
        m, x = m.double(), x.double()
    elif case == "heads_of_32":
        m = _module(128, 4)
    elif case == "longer_than_256":
        x = _x((1, sa.MAX_SEQ + 1, 128))
    elif case == "dropout_in_training":
        m = _module(dropout=0.1).train()
    elif case == "dropout_in_eval":
        m = _module(dropout=0.1)
    elif case == "train_mode_without_dropout":
        m = _module().train()
    elif case == "long":
        x = _x((2, 197, 128))
    elif case == "single_token":
        x = _x((2, 1, 128))
    return m, x, grad


ENGAGED = ("no_grad", "inference_mode", "dropout_in_eval", "train_mode_without_dropout", "long",
           "single_token")


@pytest.mark.parametrize("case", [*ENGAGED, "cpu", "float32", "float64_module", "grad_enabled",
                                  "heads_of_32", "longer_than_256", "dropout_in_training"])
def test_engagement_condition(monkeypatch, case):
    """An attention module hands its bf16 QKV product in inference to the
    kernel (here the kernel's device is taken to be the CPU and the launch
    runs the plain version) and nothing else: not on the CPU, in float32 or
    float64, with autograd recorded, at another head width or length, or
    with dropout in training; either way its output equals the eager
    expression's bit for bit."""
    m, x, grad = _engagement_input(case)
    seen = _stand_in(monkeypatch, "cuda" if case == "cpu" else "cpu")
    before = sa.self_attention.launches
    gen = torch.Generator().manual_seed(3)
    with grad():
        qkv = F.linear(x, m.qkv_weight.to(x.dtype), m.qkv_bias.to(x.dtype))
        assert sa.engages(qkv, m) == (case in ENGAGED)
        got = m(x, gen)
        want = eager_forward(m, x, torch.Generator().manual_seed(3))
    assert torch.equal(got.detach(), want.detach())
    assert sa.self_attention.launches - before == len(seen) == (case in ENGAGED)
    if case in ENGAGED:
        B, L, _ = x.shape
        assert seen == [(B, L, m.heads, (L * 384, 384 if L > 1 else 0))]


def test_engagement_refuses_unaligned_products(monkeypatch):
    """A product whose rows lie 4 values apart, or that starts 2 bytes off a
    16-byte boundary, stays on the eager path."""
    m = _module()
    monkeypatch.setattr(sa, "_on_kernel_device", lambda t: True)
    wide = _x((3, 9, 388))[..., :384]
    flat = _x((3 * 9 * 384 + 1,))[1:].view(3, 9, 384)
    with torch.no_grad():
        assert not sa.engages(wide, m)
        assert not sa.engages(flat, m)
        assert sa.engages(flat.clone(), m)


def _family(name, monkeypatch, dtype=torch.bfloat16):
    """A seeded ViT-Ti/16 (12 blocks, 3 heads of 64) on 2 faces of 32² (5
    tokens), or a TimeSformer of 2 blocks at ViT-Ti's widths on 2 clips of
    4 frames (5 tokens a frame, 4 frames a patch)."""
    if name == "vit":
        model, n = ViTClassifier("tiny16", image_size=32, dtype=dtype), 2
    else:
        monkeypatch.setitem(timesformer.TIMESFORMER_CONFIGS, "ti16x2",
                            dict(patch=16, width=192, depth=2, heads=3, mlp=768))
        model, n = TimeSformerClassifier("ti16x2", num_frames=4, image_size=32, dtype=dtype), 8
    model = init_weights(model, 0)
    for i, m in enumerate(mod for mod in model.modules()
                          if isinstance(mod, MultiHeadDotProductAttention)):
        with torch.no_grad():
            m.qkv_bias.copy_(0.2 * torch.randn(m.qkv_bias.shape,
                                               generator=torch.Generator().manual_seed(50 + i)))
    return model, torch.randn((n, 32, 32, 3), generator=torch.Generator().manual_seed(1))


# Attention cores a forward: one a block; the TimeSformer's temporal one besides.
FAMILY_LAUNCHES = {"vit": [(2, 5, 3)] * 12,
                   "timesformer": [(2 * 4, 4, 3), (2 * 4, 5, 3)] * 2}


@pytest.mark.parametrize("case", ["inference", "cpu", "train_step", "float32"])
@pytest.mark.parametrize("family", ["vit", "timesformer"])
def test_transformer_forwards(monkeypatch, family, case):
    """Every attention core of a ViT or TimeSformer forward in inference goes
    to the kernel (the TimeSformer's temporal one over each patch's frames,
    its spatial one over each frame's tokens); none on the CPU, in a train
    step or in float32. The forward is unchanged: features and logits equal
    those of the eager expression bit for bit."""
    model, faces = _family(family, monkeypatch,
                           torch.float32 if case == "float32" else torch.bfloat16)
    model.train(case == "train_step")
    grad = torch.enable_grad if case == "train_step" else torch.inference_mode

    def forward():
        with grad():
            logits, feats = model(faces, generator=torch.Generator().manual_seed(4))
        return logits.detach(), feats.detach()

    with monkeypatch.context() as mp:
        mp.setattr(MultiHeadDotProductAttention, "forward", eager_forward)
        want = forward()
    before = sa.self_attention.launches
    seen = _stand_in(monkeypatch, "cuda" if case == "cpu" else "cpu")
    got = forward()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    engaged = FAMILY_LAUNCHES[family] if case == "inference" else []
    assert [s[:3] for s in seen] == engaged
    assert sa.self_attention.launches - before == len(engaged)
