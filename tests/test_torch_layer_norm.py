"""The transformers' LayerNorm kernel (``ops/layer_norm.py``) on the CPU: the
plain version against the eager expression ``LayerNorm.forward`` ran before
the kernel, the wrapper's checks, the launch plan, when a LayerNorm hands
its rows to the kernel (the kernel's device stood in by the CPU, the launch
by a counting call of the plain version), and the ViT's and TimeSformer's
forwards on the CPU. The kernel itself is held to the plain version on the
card (``tests/test_torch_gpu_kernels.py``)."""

import pytest
import torch

from deepfake_vit_tpu_torch.models.layers import LayerNorm, init_weights
from deepfake_vit_tpu_torch.models.timesformer import TimeSformerClassifier
from deepfake_vit_tpu_torch.models.vit import ViTClassifier
from deepfake_vit_tpu_torch.ops import layer_norm as ln
from deepfake_vit_tpu_torch.ops.cuda_build import SM_COUNT


def eager_layer_norm(x, weight, bias, eps):
    """``LayerNorm.forward`` before the kernel, as it was written there."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((xf - mean) * mul + bias).to(x.dtype)


def _module(W, eps=1e-6, seed=0):
    m = LayerNorm(W, eps)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.3 * torch.randn(W, generator=g))
        m.bias.copy_(0.5 * torch.randn(W, generator=g))
    return m


def _x(shape, dtype=torch.bfloat16, seed=1):
    """Rows with a mean away from 0 and a spread of a few units."""
    g = torch.Generator().manual_seed(seed)
    return (2.0 + 3.0 * torch.randn(shape, generator=g, dtype=torch.float64)).to(dtype)


def _stand_in(monkeypatch, kernel_device="cpu"):
    """Take ``kernel_device`` for the kernel's device and put a counting
    launch of the plain version in the kernel's place (its output
    contiguous, as the kernel writes it); returns the (rows,
    inner, outer stride, inner stride) of every launch. Each operand handed
    over passes the wrapper's checks and is aligned."""
    monkeypatch.setattr(ln, "_on_kernel_device", lambda t: t.device.type == kernel_device)
    seen = []

    def launch(x, weight, bias, eps):
        ln._check(x, weight, bias)
        assert not any(t.data_ptr() % 16 for t in (x, weight, bias))
        seen.append(ln._row_layout(x))
        ln.layer_norm.launches += 1
        return ln.layer_norm_plain(x, weight, bias, eps).contiguous()  # as the kernel writes it

    monkeypatch.setattr(ln, "launch", launch)
    return seen


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
@pytest.mark.parametrize("W", [64, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_plain_version_equals_the_eager_expression(dtype, W, eps):
    """Bit for bit, and ``LayerNorm.forward`` on the CPU with it; the
    wrapper runs the plain version on CPU bf16 rows and counts no launch."""
    m = _module(W, eps).to(torch.float64 if dtype == torch.float64 else torch.float32)
    x = _x((3, 5, W), dtype)
    before = ln.layer_norm.launches
    with torch.no_grad():
        want = eager_layer_norm(x, m.weight, m.bias, eps)
        assert want.dtype == dtype
        assert torch.equal(ln.layer_norm_plain(x, m.weight, m.bias, eps), want)
        assert torch.equal(m(x), want)
        if dtype == torch.bfloat16:
            assert torch.equal(ln.layer_norm(x, m.weight, m.bias, eps), want)
    assert ln.layer_norm.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    m, x = _module(64), _x((4, 64))
    with pytest.raises(TypeError):
        ln.layer_norm(x.float(), m.weight, m.bias, 1e-6)
    with pytest.raises(ValueError):
        ln.layer_norm(_x((4, 20)), *_module(20).parameters(), 1e-6)  # W not a multiple of 8
    with pytest.raises(ValueError):
        ln.layer_norm(_x((4, 1024)), *_module(1024).parameters(), 1e-6)  # wider than the cap
    with pytest.raises(ValueError):
        ln.layer_norm(_x((64, 4)).t(), m.weight, m.bias, 1e-6)  # rows not contiguous
    with pytest.raises(ValueError):
        ln.layer_norm(_x((2, 3, 5, 64)).transpose(0, 2), m.weight, m.bias, 1e-6)  # three strides
    with pytest.raises(ValueError):
        ln.layer_norm(_x((4, 68))[:, :64], m.weight, m.bias, 1e-6)  # rows 68 apart
    with pytest.raises(ValueError):
        ln.layer_norm(x, m.weight[:32], m.bias, 1e-6)
    with pytest.raises(ValueError):
        ln.layer_norm(x, m.weight.double(), m.bias, 1e-6)


# The served calls' rows: the ViT's (128 × 197), the TimeSformer's ln_t (16
# clips × 196 patches × 8 frames), ln2 (16 × 1,569) and CLS rows (16); small
# and ragged ones.
PLAN_ROWS = [25216, 25088, 25104, 16, 1, 7, 8, 9, 2111, 2112, 2113, 10 ** 6]


@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_layer_norm_plan_is_one_wave_of_warps(rows):
    blocks = ln.layer_norm_plan(rows)
    cap = SM_COUNT * ln.LN_BLOCKS_PER_SM
    assert 1 <= blocks <= cap
    assert blocks * ln.LN_WARPS >= min(rows, cap * ln.LN_WARPS)  # every warp has a row
    assert (blocks - 1) * ln.LN_WARPS < rows  # no block without one


# Views whose rows the kernel reads where they lie: contiguous, a row of
# each (C, L) block, a slice of wider rows, an expanded row, one and two
# strides of transposed tokens, a single row, none.
LAYOUT_VIEWS = {
    "contiguous": lambda t: t,
    "cls_rows": lambda t: t[:, 0],
    "wider_rows": lambda t: t[..., :32],
    "expanded": lambda t: t[:1, :1].expand(3, 4, 64),
    "one_clip_temporal": lambda t: (t[:1, 1:].reshape(1, 2, 2, 64).transpose(1, 2)
                                    .reshape(2, 2, 64)),
    "transposed": lambda t: t.transpose(0, 1),
    "single_row": lambda t: t[1, 2],
    "empty": lambda t: t[:, :0],
}


@pytest.mark.parametrize("view", list(LAYOUT_VIEWS))
def test_row_layout_finds_every_row(view):
    """Row r of ``_row_layout``'s grid is row r of the view, in order; the
    views need at most two strides."""
    x = LAYOUT_VIEWS[view](_x((3, 5, 64)))
    rows, inner, outer_stride, inner_stride = ln._row_layout(x)
    W = x.shape[-1]
    assert rows == x.numel() // W and rows % inner == 0
    grid = torch.as_strided(x, (rows // inner, inner, W), (outer_stride, inner_stride, 1),
                            x.storage_offset())
    assert torch.equal(grid.reshape(-1, W), x.reshape(-1, W))


def _engagement_input(case):
    """(module, x, grad context) of one case."""
    m, x = _module(64), _x((6, 64))
    grad = torch.no_grad
    if case == "inference_mode":
        grad = torch.inference_mode
    elif case == "grad_enabled":
        grad = torch.enable_grad
    elif case == "float32":
        x = x.float()
    elif case == "width_not_a_multiple_of_8":
        m, x = _module(20), _x((6, 20))
    elif case == "wider_than_the_cap":
        m, x = _module(1024), _x((6, 1024))
    elif case == "misaligned_rows":
        x = _x((6 * 64 + 1,))[1:].view(6, 64)
    elif case == "row_stride_not_a_multiple_of_8":
        x = _x((6, 68))[:, :64]
    elif case == "float64_module":
        m = m.double()
    elif case == "strided_rows":  # the TimeSformer's CLS rows: one stride, no copy
        x = _x((6, 9, 64))[:, 0]
    elif case == "two_strides":  # the temporal rows of one clip: (N, T) of frame-major tokens
        x = _x((1, 1 + 4 * 5, 64))[:, 1:].reshape(1, 4, 5, 64).transpose(1, 2).reshape(5, 4, 64)
    elif case == "three_strides":
        x = _x((2, 3, 5, 64)).transpose(0, 2)
    return m, x, grad


ENGAGED = ("no_grad", "inference_mode", "strided_rows", "two_strides")


@pytest.mark.parametrize("case", [*ENGAGED, "cpu", "float32", "grad_enabled",
                                  "width_not_a_multiple_of_8", "wider_than_the_cap",
                                  "misaligned_rows", "row_stride_not_a_multiple_of_8",
                                  "three_strides", "float64_module"])
def test_engagement_condition(monkeypatch, case):
    """A LayerNorm hands bf16 rows in inference to the kernel (here the
    kernel's device is taken to be the CPU and the launch runs the plain
    version) and nothing else; either way its output equals the eager
    expression's bit for bit."""
    m, x, grad = _engagement_input(case)
    seen = _stand_in(monkeypatch, "cuda" if case == "cpu" else "cpu")
    before = ln.layer_norm.launches
    with grad():
        assert ln.engages(x, m) == (case in ENGAGED)
        got = m(x)
        want = eager_layer_norm(x, m.weight, m.bias, m.eps)
    assert torch.equal(got.detach(), want.detach())
    assert ln.layer_norm.launches - before == len(seen) == (case in ENGAGED)
    if case == "strided_rows":
        assert seen == [(6, 6, 9 * 64 * 6, 9 * 64)] and got.is_contiguous()
    if case == "two_strides":
        assert seen == [(20, 4, 64, 5 * 64)] and got.is_contiguous()


def _family(name, dtype=torch.bfloat16):
    """A seeded ViT-Ti/16 (25 LayerNorms) or TimeSformer tiny8 (2 blocks: 7
    LayerNorms) and faces for it: 2 faces, or 2 clips of 4 frames, of 32²."""
    if name == "vit":
        model = ViTClassifier("tiny16", image_size=32, dtype=dtype)
        n = 2
    else:
        model = TimeSformerClassifier("tiny8", num_frames=4, image_size=32, dtype=dtype)
        n = 8
    model = init_weights(model, 0)
    for i, m in enumerate(mod for mod in model.modules() if isinstance(mod, LayerNorm)):
        g = torch.Generator().manual_seed(100 + i)
        with torch.no_grad():
            m.weight.copy_(1.0 + 0.2 * torch.randn(m.weight.shape, generator=g))
            m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return model, torch.randn((n, 32, 32, 3), generator=torch.Generator().manual_seed(1))


# LayerNorms a forward: 2 a block and the final one; the TimeSformer's ln_t besides.
FAMILY_LAUNCHES = {"vit": 2 * 12 + 1, "timesformer": 3 * 2 + 1}


@pytest.mark.parametrize("case", ["inference", "cpu", "train_step", "float32"])
@pytest.mark.parametrize("family", ["vit", "timesformer"])
def test_transformer_forwards(monkeypatch, family, case):
    """Every LayerNorm of a ViT or TimeSformer forward in inference goes to
    the kernel (the TimeSformer's final one on the CLS rows where they lie
    in the tokens, 1 + T·N rows apart); none on the CPU, in a train step or
    in float32. The CPU forward is unchanged: the features and logits equal
    those of the eager expression bit for bit."""
    model, faces = _family(family, torch.float32 if case == "float32" else torch.bfloat16)
    model.train(case == "train_step")
    grad = torch.enable_grad if case == "train_step" else torch.inference_mode

    def forward():
        with grad():
            logits, feats = model(faces)
        return logits.detach(), feats.detach()

    with monkeypatch.context() as mp:
        mp.setattr(LayerNorm, "forward",
                   lambda self, x: eager_layer_norm(x, self.weight, self.bias, self.eps))
        want = forward()
    before = ln.layer_norm.launches
    seen = _stand_in(monkeypatch, "cuda" if case == "cpu" else "cpu")
    got = forward()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    engaged = case == "inference"
    assert ln.layer_norm.launches - before == len(seen) == (FAMILY_LAUNCHES[family] if engaged
                                                            else 0)
    if engaged and family == "timesformer":
        assert seen[-1] == (2, 2, 2 * (1 + 4 * 16) * 64, (1 + 4 * 16) * 64)
