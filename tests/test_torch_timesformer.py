"""The TimeSformer clip classifier (``models/timesformer.py``) and its
serving path on the CPU, at a tiny size (``tiny8``: width 64, 2 blocks of
2 heads, patch 8, clips of 4 frames of 32² faces), on seeded weights:

- the port in float32 against the plain reference
  (``benchmark/reference/timesformer.py``) to rounding, and in bf16 within
  the band bf16 rounding leaves; the reference against ``transformers``'
  ``TimesformerForVideoClassification`` with the same weights, and the HF
  converter loading them into the port;
- the order of a clip's frames reaches its verdict and no other clip's;
- ``FusedPipeline`` with the clip classifier: whole clips of consecutive
  frames, each frame slot carrying its clip's answer, ``clip_probs`` and
  ``clip_features``, the counters, the refusals, ``make_sharded`` on clip
  boundaries, ``predict_clip``, the spans; the published widths built
  from a configuration.

The JAX package has no such family, so nothing here runs JAX."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.kinds.serve_clips import track_frames
from benchmark.reference import timesformer as ref
from benchmark.reference.nn import Operands
from benchmark.weights import make_weights
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.models.timesformer import (TimeSformerClassifier,
                                                       convert_hf_timesformer,
                                                       load_hf_timesformer)
from deepfake_vit_tpu_torch.ops.image import normalize_imagenet
from deepfake_vit_tpu_torch.parallel import make_mesh

torch.set_num_threads(1)

T, FACE, CLIPS = 4, 32, 3
MODEL = {"type": "timesformer",
         "feature_extractor": {"variant": "tiny8", "image_size": FACE, "num_frames": T},
         "classifier": {"num_classes": 2}}
COMMON = dict(detection_input_size=(64, 64), serving_size=(128, 128), output_size=(FACE, FACE),
              warp_window=64, dtype=torch.float32, device="cpu")


def weights(seed):
    """The benchmark's seeded weights: every tensor drawn, none zero."""
    return make_weights(ref.param_spec("tiny8", FACE, T, 2), seed, "cpu")


def faces(seed, n=CLIPS * T):
    return torch.randn(n, FACE, FACE, 3, generator=torch.Generator().manual_seed(seed))


def model(sd, dtype=torch.float32):
    m = TimeSformerClassifier("tiny8", num_frames=T, image_size=FACE, dtype=dtype).eval()
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_matches_the_reference_float32(seed):
    sd, x = weights(seed), faces(seed)
    with torch.no_grad():
        logits, feats = model(sd)(x)
        want_logits, want_feats = ref.forward(sd, x, "tiny8", T, Operands())
    assert logits.shape == (CLIPS, 2) and feats.shape == (CLIPS, 64)
    assert logits.dtype == feats.dtype == torch.float32
    assert (logits - want_logits).abs().max() <= 1e-4
    assert (feats - want_feats).abs().max() <= 1e-4


def test_port_bf16_within_rounding_of_the_reference():
    """bf16 keeps 8 significant bits (0.4 % a rounding): through the two
    blocks' residual sums the CLS features lie 0.8–1.2 % from float32 on
    these weights, the logits (of size ~1) within 0.02; the band is 3 %
    and 0.05."""
    for seed in range(3):
        sd, x = weights(seed), faces(seed)
        with torch.no_grad():
            logits, feats = model(sd, torch.bfloat16)(x)
            want_logits, want_feats = ref.forward(sd, x, "tiny8", T, Operands())
        assert logits.dtype == torch.float32
        rel = (feats - want_feats).norm(dim=1) / want_feats.norm(dim=1)
        assert rel.max() <= 0.03
        assert (logits - want_logits).abs().max() <= 0.05


def _hf_model(seed):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    cfg = transformers.TimesformerConfig(
        image_size=FACE, patch_size=8, num_frames=T, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=256, num_labels=2, layer_norm_eps=1e-6,
        attention_type="divided_space_time")
    hf = transformers.TimesformerForVideoClassification(cfg).eval()
    with torch.no_grad():  # HF's init leaves the biases, cls and time embeddings at 0
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return hf


def _hf_forward(hf, x):
    """HF's logits and CLS features of (C·T, H, W, 3) faces."""
    pixels = x.view(-1, T, FACE, FACE, 3).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        out = hf(pixel_values=pixels, output_hidden_states=True)
        feats = hf.timesformer.layernorm(out.hidden_states[-1])[:, 0]
    return out.logits, feats


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_transformers(seed):
    hf = _hf_model(seed)
    x = faces(seed)
    want_logits, want_feats = _hf_forward(hf, x)
    sd = convert_hf_timesformer(hf.state_dict(), depth=2)
    with torch.no_grad():
        logits, feats = ref.forward(sd, x, "tiny8", T, Operands())
    assert (logits - want_logits).abs().max() <= 1e-5
    assert (feats - want_feats).abs().max() <= 1e-5


def test_load_hf_timesformer_matches_transformers():
    hf = _hf_model(3)
    x = faces(3)
    want_logits, want_feats = _hf_forward(hf, x)
    m = TimeSformerClassifier("tiny8", num_frames=T, image_size=FACE).eval()
    assert load_hf_timesformer(m, hf.state_dict()) is m
    with torch.no_grad():
        logits, feats = m(x)
    assert (logits - want_logits).abs().max() <= 1e-5
    assert (feats - want_feats).abs().max() <= 1e-5
    short = TimeSformerClassifier("tiny8", num_frames=T + 1, image_size=FACE)
    with pytest.raises(RuntimeError):  # strictly: the time embedding's frames must agree
        load_hf_timesformer(short, hf.state_dict())


def test_the_order_of_a_clips_frames_reaches_its_verdict():
    sd, x = weights(4), faces(4)
    m = model(sd)
    rotated = x.clone().view(CLIPS, T, FACE, FACE, 3)
    rotated[1] = rotated[1].roll(1, dims=0)
    with torch.no_grad():
        logits, _ = m(x)
        logits_r, _ = m(rotated.view_as(x))
    assert not torch.allclose(logits[1], logits_r[1], atol=1e-4)
    assert torch.equal(logits[0], logits_r[0]) and torch.equal(logits[2], logits_r[2])


def test_model_refuses_partial_clips():
    with pytest.raises(ValueError):
        model(weights(0))(faces(0, n=T + 1))


def test_published_widths_from_the_configuration():
    cfg = {"type": "timesformer", "feature_extractor": {"variant": "base16", "image_size": 224,
                                                         "num_frames": 8, "dropout_rate": 0.0},
           "classifier": {"num_classes": 2}}
    with torch.device("meta"):
        m = create_model_from_config(cfg)
    assert isinstance(m, TimeSformerClassifier)
    assert (m.num_frames, m.n_patches, m.width, m.depth) == (8, 196, 768, 12)
    # 12 blocks of 10,042,368 (temporal 2,954,496 + spatial 2,363,904 + MLP
    # 4,723,968) and 751,874 in the embeddings, final LayerNorm and head.
    assert sum(p.numel() for p in m.parameters()) == 121_260_290
    assert {k for k, _ in m.named_parameters()} == {
        n for n, _, _ in ref.param_spec("base16", 224, 8, 2)}


@pytest.fixture(scope="module")
def served():
    """A pipeline with the tiny TimeSformer and the committed detector, and
    two 4-frame face tracks in whose second a frame is blank (no face)."""
    pipe = FusedPipeline({"model": MODEL}, **COMMON)
    pipe.load_variables(seed=0)
    pipe.model.load_state_dict(weights(5))
    frames = track_frames(2, T, (128, 128), 2**31 + 11, "cpu", half_width=(0.16, 0.22)).numpy()
    frames[T + 2] = 90
    return pipe, frames, pipe.forward(frames)


def test_pipeline_serves_clips_to_every_frame_slot(served):
    pipe, frames, out = served
    B = frames.shape[0]
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "has_face": (B,), "confidence": (B,), "bbox": (B, 4), "landmarks": (B, 5, 2),
        "quality": (B,), "quality_valid": (B,), "probs": (B, 2), "fake_prob": (B,),
        "features": (B, 64), "clip_probs": (2, 2), "clip_features": (2, 64)}
    assert out["has_face"].tolist() == [True] * (T + 2) + [False] + [True]
    assert torch.equal(out["probs"], out["clip_probs"].repeat_interleave(T, 0))
    assert torch.equal(out["features"], out["clip_features"].repeat_interleave(T, 0))
    assert torch.equal(out["fake_prob"], torch.where(out["has_face"], out["probs"][:, 1],
                                                     torch.zeros(B)))
    # The clip's verdict is the classifier's on its frames' aligned faces, in order.
    st = pipe._detect_align(torch.as_tensor(frames))
    with torch.no_grad():
        logits, feats = pipe.model(normalize_imagenet(st["aligned"] / 255.0))
    assert torch.allclose(out["clip_probs"], torch.softmax(logits, -1), atol=1e-6)
    assert torch.allclose(out["clip_features"], feats, atol=1e-6)


def test_pipeline_counts_clips_and_partial_clips():
    pipe = FusedPipeline({"model": MODEL}, **COMMON)
    pipe.load_variables(seed=1)
    frames = track_frames(2, T, (128, 128), 2**31 + 11, "cpu", half_width=(0.16, 0.22)).numpy()
    assert (pipe.clips, pipe.partial_clips) == (0, 0)
    pipe.forward(frames)
    frames[1] = 90
    pipe.forward(frames)
    assert (pipe.clips, pipe.partial_clips) == (4, 1)


def test_pipeline_refuses_what_it_cannot_serve(served):
    pipe, frames, _ = served
    with pytest.raises(ValueError, match="whole clips"):
        pipe.forward(frames[:T + 1])
    with pytest.raises(ValueError, match="keep_top_k"):
        FusedPipeline({"model": MODEL}, keep_top_k=3, **COMMON)
    with pytest.raises(ValueError, match="flax checkpoint"):
        pipe.load_variables(classifier_checkpoint="deepfake_vit_tpu/weights/"
                                                  "classifier_synface.msgpack")


@pytest.mark.parametrize("option", ["use_fused_backbone", "use_int8_tail", "use_s2d_early"])
def test_pipeline_refuses_efficientnet_options(option):
    with pytest.raises(ValueError, match="TimeSformer"):
        FusedPipeline({"model": MODEL}, **{option: True}, **COMMON)


def test_seeded_init_and_load_variables():
    a, b = (FusedPipeline({"model": MODEL}, **COMMON) for _ in range(2))
    a.init_variables(seed=3)
    b.load_variables(seed=3, detector_weights=None)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert sa["time_embed"].abs().sum() > 0 and sa["pos_embed"].abs().sum() > 0


def test_make_sharded_stripes_whole_clips(served):
    pipe, frames, out = served
    sharded = pipe.make_sharded(make_mesh(devices=["cpu", "cpu"]))
    got = sharded(frames)
    assert got.keys() == out.keys()
    for k in out:
        assert torch.allclose(got[k].float(), out[k].float(), atol=1e-5), k
    with pytest.raises(ValueError, match="cut clips"):
        sharded(frames[:T])


def test_predict_clip_gives_each_clip_its_own_verdict(served):
    pipe, frames, out = served
    one = pipe.predict_clip(frames[:T])
    p0 = float(out["clip_probs"][0, 1])
    assert one["fake_prob"] == pytest.approx(p0) and one["clip_probs"] == pytest.approx([p0])
    assert one["label"] == int(p0 >= 0.5) and one["num_faces"] == T
    both = pipe.predict_clip(frames)
    assert both["fake_prob"] == pytest.approx(float(out["clip_probs"][:, 1].mean()))
    assert both["num_faces"] == 2 * T - 1 and len(both["frame_probs"]) == 2 * T
    with pytest.raises(ValueError, match="fewer"):
        pipe.predict_clip(frames[:T - 1])


def test_predict_clip_per_frame_path_unchanged(served):
    """A per-frame classifier's verdict stays the mean fake probability
    over the frames with a face."""
    _, frames, _ = served
    vit = {"type": "vit", "feature_extractor": {"variant": "tiny16", "image_size": FACE},
           "classifier": {"num_classes": 2}}
    pipe = FusedPipeline({"model": vit}, **COMMON)
    pipe.load_variables(seed=0)
    out = pipe.forward(frames)
    res = pipe.predict_clip(frames[:T + 3])
    mask = out["has_face"][:T + 3].numpy()
    want = float((out["fake_prob"][:T + 3].numpy() * mask).sum() / mask.sum())
    assert res["fake_prob"] == pytest.approx(want, abs=1e-6)
    assert "clip_probs" not in res and res["num_faces"] == int(mask.sum())


def test_spans_per_block(served, tmp_path):
    """One ``classify.temporal`` and one ``classify.spatial`` range a block
    inside ``serve.classify``, the attention's ``classify.attention``
    inside each spatial one; the outputs as without the profiler."""
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
    temporal, spatial, attention = (spans(n) for n in ("classify.temporal", "classify.spatial",
                                                       "classify.attention"))
    assert len(temporal) == len(spatial) == len(attention) == pipe.model.depth
    assert all(inside(s, classify) for s in temporal + spatial)
    for t, s, a in zip(temporal, spatial, attention):
        assert t[1] <= s[0] and inside(a, s)
    for k in out:
        assert torch.equal(traced[k], out[k]), k
