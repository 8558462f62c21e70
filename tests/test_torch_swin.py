"""The Swin classifier (``models/swin.py``) and its serving path on the CPU,
at a tiny size (``tiny2w4``: widths 16 → 128, 2 blocks a stage, heads of
8, patch 2, windows of 4 over grids of 32, 16, 8 and 4 at 64² faces, so
three stages run shifted blocks and the last one's grid is its window),
on seeded weights:

- the port in float32 against the plain reference
  (``benchmark/reference/swin.py``) to rounding, and in bf16 within the
  band bf16 rounding leaves; the reference against ``transformers``'
  ``SwinForImageClassification`` with the same weights, and the HF
  converter loading them into the port;
- the published widths and parameter count built from a configuration,
  and the window counters of a Swin-B batch of 128 on the meta device;
- the attention core without a bias as it was before the bias existed, bit
  for bit, in the ViT and the TimeSformer; the kernel refusing a biased call;
- ``FusedPipeline`` with the Swin classifier: outputs, spans, counters and
  the refusal of the EfficientNet options.

The JAX package has no such family, so nothing here runs JAX."""

import json
import math

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import swin as ref
from benchmark.reference.nn import Operands
from benchmark.traffic_gen import face_frames
from benchmark.weights import make_weights
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.models.layers import MultiHeadDotProductAttention, init_weights
from deepfake_vit_tpu_torch.models.swin import (SwinClassifier, convert_hf_swin, load_hf_swin,
                                                relative_index, shift_mask, stage_plan)
from deepfake_vit_tpu_torch.models.timesformer import TimeSformerClassifier
from deepfake_vit_tpu_torch.models.vit import ViTClassifier
from deepfake_vit_tpu_torch.ops import self_attention as sa
from deepfake_vit_tpu_torch.ops.image import normalize_imagenet
from deepfake_vit_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

FACE, N = 64, 3
MODEL = {"type": "swin", "feature_extractor": {"variant": "tiny2w4", "image_size": FACE},
         "classifier": {"num_classes": 2}}
COMMON = dict(detection_input_size=(64, 64), serving_size=(128, 128), output_size=(FACE, FACE),
              warp_window=64, dtype=torch.float32, device="cpu")
# Window sequences a tiny face attends (stages 1-4: 64, 16, 4 and 1 windows,
# 2 blocks each) and those under a shift mask (the odd blocks of stages 1-3).
TINY_WINDOWS, TINY_SHIFTED = 2 * (64 + 16 + 4 + 1), 64 + 16 + 4


def weights(seed, gain=1.0):
    """The benchmark's seeded weights (every tensor drawn, none zero), the
    bias tables ``gain`` times the published initializer's spread."""
    w = make_weights(ref.param_spec("tiny2w4", FACE, 2), seed, "cpu")
    return {k: v * gain if k.endswith(".rel_bias") else v for k, v in w.items()}


def faces(seed, n=N):
    return torch.randn(n, FACE, FACE, 3, generator=torch.Generator().manual_seed(seed))


def model(sd, dtype=torch.float32):
    m = SwinClassifier("tiny2w4", image_size=FACE, dtype=dtype).eval()
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_matches_the_reference_float32(seed):
    sd, x = weights(seed, gain=10.0), faces(seed)
    with torch.no_grad():
        logits, feats = model(sd)(x)
        want_logits, want_feats = ref.forward(sd, x, "tiny2w4", Operands())
    assert logits.shape == (N, 2) and feats.shape == (N, 128)
    assert logits.dtype == feats.dtype == torch.float32
    assert (logits - want_logits).abs().max() <= 1e-4
    assert (feats - want_feats).abs().max() <= 1e-4


def test_port_bf16_within_rounding_of_the_reference():
    """bf16 keeps 8 significant bits (0.4 % a rounding): through the eight
    blocks' residual sums and three merges the mean features lie 0.56–0.63 %
    from float32 on these weights, the logits (of size 1.5–2.2) within
    0.012; the band is 2 % and 0.05, about three and four times that."""
    for seed in range(3):
        sd, x = weights(seed, gain=10.0), faces(seed)
        with torch.no_grad():
            logits, feats = model(sd, torch.bfloat16)(x)
            want_logits, want_feats = ref.forward(sd, x, "tiny2w4", Operands())
        assert logits.dtype == torch.float32
        rel = (feats - want_feats).norm(dim=1) / want_feats.norm(dim=1)
        assert rel.max() <= 0.02
        assert (logits - want_logits).abs().max() <= 0.05


def _hf_model(seed):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.SwinConfig(image_size=FACE, patch_size=2, embed_dim=16,
                                  depths=[2, 2, 2, 2], num_heads=[2, 4, 8, 16], window_size=4,
                                  num_labels=2, drop_path_rate=0.0)
    hf = transformers.SwinForImageClassification(cfg).eval()
    with torch.no_grad():  # HF's init leaves the biases and the bias tables at 0
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return hf


def _hf_forward(hf, x):
    """HF's logits and pooled features of (N, H, W, 3) faces."""
    pixels = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        return hf(pixel_values=pixels).logits, hf.swin(pixel_values=pixels).pooler_output


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_transformers(seed):
    """The relative index, the mask regions, the merge order and the last
    stage's window clipped to its grid, against HF's own module."""
    hf = _hf_model(seed)
    x = faces(seed)
    want_logits, want_feats = _hf_forward(hf, x)
    sd = convert_hf_swin(hf.state_dict(), "tiny2w4")
    with torch.no_grad():
        logits, feats = ref.forward(sd, x, "tiny2w4", Operands())
    assert (logits - want_logits).abs().max() <= 1e-5
    assert (feats - want_feats).abs().max() <= 1e-5


def test_load_hf_swin_matches_transformers():
    hf = _hf_model(3)
    x = faces(3)
    want_logits, want_feats = _hf_forward(hf, x)
    m = SwinClassifier("tiny2w4", image_size=FACE).eval()
    assert load_hf_swin(m, hf.state_dict()) is m
    with torch.no_grad():
        logits, feats = m(x)
    assert (logits - want_logits).abs().max() <= 1e-5
    assert (feats - want_feats).abs().max() <= 1e-5
    index = hf.state_dict()["swin.encoder.layers.0.blocks.0.attention.self.relative_position_index"]
    assert torch.equal(relative_index(4), index)


def test_shift_mask_regions():
    """Rolled by (−2, −2), an 8² grid under windows of 4 has 9 regions cut at
    [0:4], [4:6], [6:8]: the first window lies in one, the last in four."""
    m = shift_mask(8, 4, 2)
    assert m.shape == (4, 16, 16) and set(m.unique().tolist()) == {0.0, -100.0}
    assert (m[0] == 0).all()
    last = (m[3] == 0).int()
    assert last.sum() == 4 * 4 * 4  # four regions of 2×2 tokens, each seeing its own 4
    assert torch.equal(m, m.transpose(1, 2))


def test_stage_plan_clips_the_window_and_refuses_untiled_grids():
    plan = stage_plan("base4w7", 224)
    assert [(p["res"], p["width"], p["heads"], p["window"], p["shift"]) for p in plan] == [
        (56, 128, 4, 7, 3), (28, 256, 8, 7, 3), (14, 512, 16, 7, 3), (7, 1024, 32, 7, 0)]
    with pytest.raises(ValueError):
        stage_plan("base4w7", 192)  # a 48² grid: windows of 7 do not tile it
    with pytest.raises(ValueError):
        stage_plan("tiny2w4", 63)


def test_published_widths_from_the_configuration():
    cfg = {"type": "swin", "feature_extractor": {"variant": "base4w7", "image_size": 224,
                                                  "dropout_rate": 0.0},
           "classifier": {"num_classes": 2}}
    with torch.device("meta"):
        m = create_model_from_config(cfg)
        published = SwinClassifier("base4w7", num_classes=1000)
    assert isinstance(m, SwinClassifier) and m.feature_dim == 1024
    assert sum(p.numel() for p in m.parameters()) == 86_745_274
    assert sum(p.numel() for p in published.parameters()) == 87_768_224
    assert {k: tuple(v.shape) for k, v in m.named_parameters()} == {
        n: s for n, s, _ in ref.param_spec("base4w7", 224, 2)}


def test_window_counters_of_a_swin_b_batch():
    """A batch of 128 faces attends 234 window sequences a face (stages 1-4:
    2 × 64, 2 × 16, 18 × 4, 2 × 1), 116 of them under a shift mask (64 +
    16 + 9 × 4; the last stage's window is its grid, unshifted)."""
    with torch.device("meta"):
        m = SwinClassifier("base4w7", dtype=torch.bfloat16).eval()
        with torch.no_grad():
            logits, feats = m(torch.empty(128, 224, 224, 3))
    assert logits.shape == (128, 2) and feats.shape == (128, 1024)
    assert (m.windows, m.shifted_windows) == (29_952, 14_848)


def _core_before(qkv, heads, dropout=None, bias=None):
    """The plain attention core as it was before it took a bias."""
    assert bias is None
    B, L, W3 = qkv.shape
    W, dt = W3 // 3, qkv.dtype
    hd = W // heads
    q, k, v = qkv.view(B, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q = q / torch.tensor(math.sqrt(hd), dtype=dt, device=qkv.device)
    weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    if dropout is not None:
        weights = weights * dropout
    return (weights @ v).transpose(1, 2).reshape(B, L, W)


@pytest.mark.parametrize("family", ["vit-ti16", "timesformer-tiny8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_free_core_is_unchanged(monkeypatch, family, dtype):
    if family == "vit-ti16":
        m, x = ViTClassifier("tiny16", image_size=32, dtype=dtype), faces(4, 2)[:, :32, :32]
    else:
        m, x = TimeSformerClassifier("tiny8", num_frames=4, image_size=32, dtype=dtype), \
            faces(4, 8)[:, :32, :32]
    m = init_weights(m, 5).eval()
    with torch.no_grad():
        got = m(x)
        monkeypatch.setattr(sa, "self_attention_plain", _core_before)
        want = m(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    qkv = torch.randn(3, 9, 3 * 64, generator=torch.Generator().manual_seed(1)).to(dtype)
    assert torch.equal(sa.self_attention_plain(qkv, 4), _core_before(qkv, 4))


def test_biased_core_adds_the_bias_to_the_scores():
    """``bias`` (G, 1 or heads, L, L) lands on sequence b as bias[b % G]:
    the same as adding it to each sequence's scores one by one."""
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn(6, 5, 3 * 16, generator=g)
    bias = torch.randn(3, 2, 5, 5, generator=g)
    got = sa.self_attention_plain(qkv, 2, bias=bias)
    q, k, v = qkv.view(6, 5, 3, 2, 8).permute(2, 0, 3, 1, 4)
    scores = q @ k.transpose(-1, -2) / math.sqrt(8) + bias.repeat(2, 1, 1, 1)
    want = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(6, 5, 16)
    assert torch.allclose(got, want, atol=1e-6)
    one = sa.self_attention_plain(qkv, 2, bias=bias[:1, :1])
    scores = q @ k.transpose(-1, -2) / math.sqrt(8) + bias[0, 0]
    assert torch.allclose(one, (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(6, 5, 16),
                          atol=1e-6)


def test_kernel_refuses_a_biased_call(monkeypatch):
    """In inference on a bf16 product the kernel takes the core of heads of
    64 (here its device is taken to be the CPU), but never one carrying a
    bias, which the module hands to the plain core."""
    monkeypatch.setattr(sa, "_on_kernel_device", lambda t: True)
    launched = []
    monkeypatch.setattr(sa, "launch", lambda qkv, heads: launched.append(heads)
                        or sa.self_attention_plain(qkv, heads))
    m = init_weights(MultiHeadDotProductAttention(128, 2), 0).eval()
    x = torch.randn(4, 9, 128, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    bias = torch.randn(2, 2, 9, 9, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        qkv = F.linear(x, m.qkv_weight.to(x.dtype), m.qkv_bias.to(x.dtype))
        assert sa.engages(qkv, m) and not sa.engages(qkv, m, bias)
        m(x)
        assert launched == [2]
        got = m(x, bias=bias)
        want = F.linear(sa.self_attention_plain(qkv, 2, bias=bias.to(x.dtype)),
                        m.out_weight.to(x.dtype), m.out_bias.to(x.dtype))
    assert launched == [2] and torch.equal(got, want)


def test_train_mode_draws_dropout_and_drop_path():
    m = SwinClassifier("tiny2w4", image_size=FACE, dropout=0.1)
    m.load_state_dict(weights(6))
    x = faces(6)
    with torch.no_grad():
        a = m.eval()(x)[1]
        assert torch.equal(a, m(x)[1])
        m.train()
        b = m(x, generator=torch.Generator().manual_seed(1))[1]
        c = m(x, generator=torch.Generator().manual_seed(1))[1]
        d = m(x, generator=torch.Generator().manual_seed(2))[1]
    assert torch.equal(b, c) and not torch.allclose(b, d) and not torch.allclose(a, b)


def test_seeded_init_draws_the_bias_tables():
    m = init_weights(SwinClassifier("tiny2w4", image_size=FACE), 3)
    tables = [p for n, p in m.named_parameters() if n.endswith(".rel_bias")]
    assert len(tables) == 8
    assert all(0.005 < float(t.detach().std()) < 0.04 and float(t.detach().abs().max()) <= 0.04
               for t in tables)


@pytest.fixture(scope="module")
def served():
    """A pipeline with the tiny Swin and the committed detector, and four
    frames with drawn faces."""
    pipe = FusedPipeline({"model": MODEL}, **COMMON)
    pipe.load_variables(seed=0)
    pipe.model.load_state_dict(weights(5, gain=10.0))
    frames = face_frames(4, (128, 128), 2**31 + 13, "cpu", half_width=(0.16, 0.22)).numpy()
    return pipe, frames, pipe.forward(frames)


def test_pipeline_serves_each_frame(served):
    pipe, frames, out = served
    B = frames.shape[0]
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "has_face": (B,), "confidence": (B,), "bbox": (B, 4), "landmarks": (B, 5, 2),
        "quality": (B,), "quality_valid": (B,), "probs": (B, 2), "fake_prob": (B,),
        "features": (B, 128)}
    assert pipe.clip_frames is None
    st = pipe._detect_align(torch.as_tensor(frames))
    with torch.no_grad():
        logits, feats = pipe.model(normalize_imagenet(st["aligned"] / 255.0))
    assert torch.allclose(out["probs"], torch.softmax(logits, -1), atol=1e-6)
    assert torch.allclose(out["features"], feats, atol=1e-6)


def test_pipeline_counts_windows(served):
    pipe, frames, _ = served
    pipe.model.windows = pipe.model.shifted_windows = 0
    pipe.forward(frames)
    B = frames.shape[0]
    assert (pipe.model.windows, pipe.model.shifted_windows) == (B * TINY_WINDOWS,
                                                                B * TINY_SHIFTED)


@pytest.mark.parametrize("option", ["use_fused_backbone", "use_int8_tail", "use_s2d_early"])
def test_pipeline_refuses_efficientnet_options(option):
    with pytest.raises(ValueError, match="a Swin classifier"):
        FusedPipeline({"model": MODEL}, **{option: True}, **COMMON)


def test_pipeline_refuses_a_flax_checkpoint(served):
    pipe, _, _ = served
    with pytest.raises(ValueError, match="flax checkpoint"):
        pipe.load_variables(classifier_checkpoint="deepfake_vit_tpu/weights/"
                                                  "classifier_synface.msgpack")


def test_make_sharded_serves_the_same(served):
    pipe, frames, out = served
    got = pipe.make_sharded(make_mesh(devices=["cpu", "cpu"]))(frames)
    assert got.keys() == out.keys()
    for k in out:
        assert torch.allclose(got[k].float(), out[k].float(), atol=1e-5), k


def test_spans_per_block(served, tmp_path):
    """One ``classify.window`` range a block inside ``serve.classify``, the
    attention's ``classify.attention`` inside each, a ``classify.merge``
    range after each stage but the last; the outputs as without the
    profiler."""
    pipe, frames, out = served
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pipe.forward(frames)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == name)

    def inside(s, outer):
        return outer[0] <= s[0] and s[1] <= outer[1]

    (classify,) = spans("serve.classify")
    window, attention, merge = (spans(n) for n in ("classify.window", "classify.attention",
                                                   "classify.merge"))
    assert len(window) == len(attention) == 8 and len(merge) == 3
    assert all(inside(s, classify) for s in window + merge)
    assert all(inside(a, w) for a, w in zip(attention, window))
    # Two blocks, then a merge, three times; the last stage's two blocks.
    order = sorted([(s[0], "w") for s in window] + [(s[0], "m") for s in merge])
    assert "".join(k for _, k in order) == "wwmwwmwwmww"
    for k in out:
        assert torch.equal(traced[k], out[k]), k
