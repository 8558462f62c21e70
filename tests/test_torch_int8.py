"""The port's int8 path vs the JAX package's, on the CPU at a small size.

On the CPU the port's ``int8_gemm`` and ``int8_conv`` run their plain
versions (float64 sums, exact); the JAX side runs its XLA int8 ops. Inputs
are made with numpy from a seed and handed to both. What is compared, and
how closely:

- the two products: the s32 sums are exact on both sides and the
  dequantizing ``(acc·sx)·sw + bias`` is the same three float32 operations
  (JAX evaluated eagerly, so XLA fuses nothing): **equal**;
- quantized weights, weight scales and folded biases of both runners,
  built from the same trained weights through the bridge: **equal**
  (BatchNorm folding and quantization keep the JAX operation order);
- runner outputs with the activation scales **handed over from the JAX
  side**: the int8 products agree exactly given equal inputs, but between
  them sit bf16 depthwise / float convolutions that the two frameworks sum
  in different orders, and a value that lands on the other side of a
  rounding tie moves one quantization step (1/127 of the tensor's range);
  the tolerances below are a few such steps and are stated at each check;
- calibrated scales: max-abs of bf16-path activations. The JAX
  calibration functions jit their graphs themselves, and XLA's CPU compiler
  keeps bf16 intermediates of a jitted graph in float32 ("excess
  precision"), which the TPU and the port do not: relative 5 %.

The JAX reference graphs of the runner and pipeline comparisons are
compiled with ``xla_allow_excess_precision=False`` for that reason, once per
module-scoped fixture; every case reads those results.
"""

import copy

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepfake_vit_tpu.e2e as je2e
from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu.models.feature_extractor import create_model_from_config as jcreate
from deepfake_vit_tpu.models.int8_tail import Int8TailRunner as JTail
from deepfake_vit_tpu.models.int8_tail import _int8_matmul as j_int8_matmul
from deepfake_vit_tpu.models.int8_tail import calibrate_act_scales as j_calibrate_tail
from deepfake_vit_tpu.models.int8_tail import default_tail_start as j_default_tail_start
from deepfake_vit_tpu.models.scrfd_int8 import ScrfdInt8Runner as JDet
from deepfake_vit_tpu.models.scrfd_int8 import calibrate_det_act_scales as j_calibrate_det
from deepfake_vit_tpu.ops.warp import warp_affine_windowed as j_warp_windowed
from deepfake_vit_tpu_torch.e2e import FusedPipeline
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.models.int8_tail import (Int8TailRunner, _int8_matmul,
                                                     calibrate_act_scales, default_tail_start)
from deepfake_vit_tpu_torch.models.quant import quantize_s8
from deepfake_vit_tpu_torch.models.scrfd import ScrfdDetector
from deepfake_vit_tpu_torch.models.scrfd_int8 import ScrfdInt8Runner, calibrate_det_act_scales
from deepfake_vit_tpu_torch.ops import int8_kernel as ik
from deepfake_vit_tpu_torch.ops.anchors import (all_anchor_centers, decode_boxes,
                                                decode_landmarks)
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

torch.set_num_threads(1)

CLASSIFIER = "deepfake_vit_tpu/weights/classifier_synface.msgpack"


def _restore(path):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def _t(x):
    return torch.from_numpy(np.array(x))


def _jit_rounding(fn, *args):
    """Run ``fn`` jitted with ``xla_allow_excess_precision=False``: by default
    XLA's CPU compiler keeps bf16 intermediates of a jitted graph in float32,
    where the TPU (and the port) round at every cast."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return jax.device_get(compiled(*args))


# ---------------------------------------------------------------------------
# The two products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N", [(56, 336), (960, 160)])
@pytest.mark.parametrize("scales", ["static", "dynamic"])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_gemm_matches_jax(K, N, scales, bias):
    rng = np.random.default_rng(K + N)
    x = rng.normal(0, 2.0, (3, 4, 5, K)).astype(np.float32)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    sw = rng.uniform(1e-3, 1e-2, N).astype(np.float32)
    b = rng.normal(0, 1, N).astype(np.float32) if bias else None
    sx = 0.0437 if scales == "static" else None

    ref = np.asarray(j_int8_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(sw),
                                   None if b is None else jnp.asarray(b), sx=sx))
    out = _int8_matmul(_t(x), _t(wq), _t(sw), None if b is None else _t(b),
                       sx=None if sx is None else torch.tensor([sx])).numpy()
    np.testing.assert_array_equal(out, ref)

    # The integer part on its own: the plain version's sum against numpy's int64.
    s = torch.tensor([sx]) if sx else torch.from_numpy(np.abs(x).max((1, 2, 3)) / np.float32(127.0))
    xq = quantize_s8(_t(x), s).reshape(-1, K)
    acc = ik.int8_gemm(xq, _t(wq), torch.ones(1), torch.ones(N)).numpy()
    want = xq.numpy().astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(want).max() < 2 ** 24 or K < 960  # the wide case leaves f32's exact range
    np.testing.assert_array_equal(acc, want.astype(np.float32))


@pytest.mark.parametrize("k,stride,size,cin,cout", [(3, 1, (9, 12), 32, 64), (3, 2, (12, 16), 64, 32),
                                                    (1, 2, (12, 16), 32, 64)])
def test_int8_conv_matches_jax(k, stride, size, cin, cout):
    """3×3 stride 1, 3×3 stride 2 on an even size (SAME pads (0, 1)) and the
    1×1 stride-2 shortcut (no padding), one static scale and one per image."""
    rng = np.random.default_rng(k * 10 + stride)
    B = 3
    xq = rng.integers(-127, 128, (B, *size, cin)).astype(np.int8)
    kq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    sw = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    b = rng.normal(0, 1, cout).astype(np.float32)
    acc = JDet._conv_s8(jnp.asarray(xq), jnp.asarray(kq), stride)
    assert acc.dtype == jnp.int32
    for sx in (np.asarray([0.031], np.float32), rng.uniform(0.01, 0.05, B).astype(np.float32)):
        ref = np.asarray(acc.astype(jnp.float32) * jnp.asarray(sx).reshape(-1, 1, 1, 1)
                         * jnp.asarray(sw) + jnp.asarray(b))
        out = ik.int8_conv(_t(xq), _t(kq), _t(sx), _t(sw), _t(b), stride).numpy()
        assert out.shape == ref.shape == (B, -(-size[0] // stride), -(-size[1] // stride), cout)
        np.testing.assert_array_equal(out, ref)


def test_int8_wrappers_validate_and_count_only_launches():
    q = torch.zeros((8, 8), dtype=torch.int8)
    with pytest.raises(TypeError):
        ik.int8_gemm(q.float(), q, torch.ones(1), torch.ones(8))
    with pytest.raises(ValueError, match="multiples of 4"):
        ik.int8_gemm(q[:, :6], q[:6], torch.ones(1), torch.ones(8))
    with pytest.raises(ValueError, match="do not divide"):
        ik.int8_gemm(q, q, torch.ones(3), torch.ones(8))
    with pytest.raises(ValueError, match="1 or 2 scales"):
        ik.int8_conv(q.reshape(2, 2, 2, 8), q.reshape(1, 1, 8, 8), torch.ones(4), torch.ones(8))
    before = (ik.int8_gemm.launches, ik.int8_conv.launches)
    ik.int8_gemm(q, q, torch.ones(1), torch.ones(8))
    ik.int8_conv(q.reshape(2, 2, 2, 8), q.reshape(1, 1, 8, 8), torch.ones(2), torch.ones(8))
    # The CPU runs the plain versions: no kernel launched, nothing counted.
    assert (ik.int8_gemm.launches, ik.int8_conv.launches) == before


# ---------------------------------------------------------------------------
# The int8 tail (EfficientNet-b0, trained weights)
# ---------------------------------------------------------------------------

EXPLICIT_START = 11  # inside stage 5; the default start for b0 is block 8


@pytest.fixture(scope="module")
def tail():
    ck = _restore(CLASSIFIER)
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    bbp = variables["params"]["feature_extractor"]["backbone"]
    bbs = variables["batch_stats"]["feature_extractor"]["backbone"]
    model = load_flax_variables(create_model_from_config(ck["model_config"]), variables).eval()
    backbone = model.feature_extractor.backbone
    rng = np.random.default_rng(21)
    faces = rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    lms = rng.uniform(10, 54, (4, 5, 2)).astype(np.float32)
    start = default_tail_start("b0")
    n_blocks = len(backbone.blocks)
    assert start == j_default_tail_start("b0") == 8 and n_blocks == 16

    # Block-input activations from the port's bf16 early blocks, handed to both sides.
    with torch.no_grad():
        split = {s: backbone(_t(faces), stop_block=s, dtype=torch.bfloat16)
                 .permute(0, 2, 3, 1).float().numpy() for s in (start, EXPLICIT_START)}

    j_scales = j_calibrate_tail("b0", bbp, bbs, [faces], start_block=start)
    jr = JTail("b0", bbp, bbs, act_scales=j_scales)  # built eagerly: weights readable
    jr_dyn = copy.copy(jr)
    jr_dyn.act_scales = None
    jm = jcreate(ck["model_config"])

    def run(v, x8, x11, landmarks):
        p = v["params"]["feature_extractor"]["backbone"]
        s = v["batch_stats"]["feature_extractor"]["backbone"]
        static = jr(x8)
        logits, _ = jm.apply(v, static, landmarks, train=False, return_features=True,
                             backbone_start_block=n_blocks)
        return {"static": static, "dynamic": jr_dyn(x8),
                "explicit": JTail("b0", p, s, start_block=EXPLICIT_START)(x11),
                "probs": jax.nn.softmax(logits, axis=-1)}

    ref = _jit_rounding(run, variables, jnp.asarray(split[start], jnp.bfloat16),
                        jnp.asarray(split[EXPLICIT_START], jnp.bfloat16), jnp.asarray(lms))
    ref = {k: np.asarray(v, np.float32) for k, v in ref.items()}
    return dict(model=model, backbone=backbone, faces=faces, lms=lms, split=split, start=start,
                j_scales=j_scales, j_runner=jr, ref=ref)


def _maps_close(port, ref, steps):
    """Within ``steps`` bf16 steps at the tensor's magnitude (2⁻⁸ relative)."""
    scale = np.abs(ref).max()
    err = np.abs(port - ref).max()
    assert err <= steps * scale * 2.0 ** -8, f"max error {err:.4g} at scale {scale:.4g}"


def test_int8_tail_weights_equal_jax(tail):
    runner = Int8TailRunner(tail["backbone"], act_scales=tail["j_scales"])
    assert runner.start == tail["start"] and len(runner.blocks) == len(tail["j_runner"].blocks)
    for e, je in zip(runner.blocks, tail["j_runner"].blocks):
        assert ("exp" in e) == ("exp" in je)
        for name in ("exp", "proj"):
            if name in e:
                for mine, theirs in zip(e[name], je[name]):
                    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=name)
        kdw, bdw = e["dw"]
        np.testing.assert_array_equal(kdw.permute(2, 3, 1, 0).float().numpy(),
                                      np.asarray(je["dw"][0].astype(jnp.float32)))
        np.testing.assert_array_equal(bdw.numpy(), np.asarray(je["dw"][1]))


@pytest.mark.parametrize("case", ["static", "dynamic", "explicit"])
def test_int8_tail_runner_matches_jax(tail, case):
    """Eight (five for the explicit start) blocks of int8 1×1 products around
    bf16 depthwise convs: the output maps stay within 8 bf16 steps of the
    JAX runner's at the maps' magnitude (a flipped rounding tie costs one
    quantization step, and bf16 depthwise sums differ in the last place)."""
    backbone = tail["backbone"]
    if case == "explicit":
        runner = Int8TailRunner(backbone, start_block=EXPLICIT_START)
        x = tail["split"][EXPLICIT_START]
    else:
        runner = Int8TailRunner(backbone,
                                act_scales=tail["j_scales"] if case == "static" else None)
        x = tail["split"][tail["start"]]
    out = runner(_t(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and out.shape[-1] == backbone.blocks[-1]["out_filters"]
    ref = tail["ref"][case]
    assert out.shape == ref.shape
    _maps_close(out.float().numpy(), ref, steps=8)


def test_int8_tail_probabilities(tail):
    """End probabilities: within 5e-3 of the JAX int8 runner's (same scales,
    same weights) and within the JAX package's own bar of 0.03 of the
    unquantized model (the port's float32 model, itself held to the JAX
    model by tests/test_torch_models.py)."""
    model, backbone = tail["model"], tail["backbone"]
    runner = Int8TailRunner(backbone, act_scales=tail["j_scales"])
    lms = _t(tail["lms"])
    with torch.no_grad():
        maps = runner(_t(tail["split"][tail["start"]]).to(torch.bfloat16))
        logits, _ = model(maps.permute(0, 3, 1, 2), lms, backbone_start_block=len(backbone.blocks))
        logits_ref, _ = model(_t(tail["faces"]), lms)
    probs = torch.softmax(logits, -1).numpy()
    np.testing.assert_allclose(probs, tail["ref"]["probs"], atol=5e-3)
    np.testing.assert_allclose(probs, torch.softmax(logits_ref, -1).numpy(), atol=0.03)


def test_calibrate_act_scales_matches_jax(tail):
    scales = calibrate_act_scales(tail["backbone"], [_t(tail["faces"][:2]), _t(tail["faces"][2:])],
                                  start_block=tail["start"])
    assert [sorted(s) for s in scales] == [sorted(s) for s in tail["j_scales"]]
    for mine, theirs in zip(scales, tail["j_scales"]):
        for k in theirs:
            assert mine[k] == pytest.approx(theirs[k], rel=0.05), k
    with pytest.raises(ValueError, match="start_block >= 1"):
        calibrate_act_scales(tail["backbone"], [], start_block=0)
    with pytest.raises(ValueError, match="no calibration"):
        calibrate_act_scales(tail["backbone"], [], start_block=tail["start"])


# ---------------------------------------------------------------------------
# The int8 detector (committed SCRFD weights, rendered scenes)
# ---------------------------------------------------------------------------

SIZE = 128


@pytest.fixture(scope="module")
def det():
    det_vars = _restore(default_weights_path("scrfd"))
    rng = np.random.default_rng(987)
    scenes = np.stack([render_scene(rng, size=SIZE, max_faces=1, min_face=32, max_face=90,
                                    p_empty=0.0)[0] for _ in range(3)])
    x = ((scenes.astype(np.float32) - 127.5) / 128.0).astype(np.float32)
    j_scales = j_calibrate_det(det_vars, [x])
    jr = JDet(det_vars, act_scales=j_scales)  # built eagerly: weights readable
    jr_dyn = copy.copy(jr)
    jr_dyn.act_scales = None
    ref = _jit_rounding(lambda a: {"static": jr(a), "dynamic": jr_dyn(a)}, jnp.asarray(x))
    detector = load_flax_variables(ScrfdDetector(dtype=torch.bfloat16), det_vars).eval()
    return dict(det_vars=det_vars, detector=detector, x=x, j_scales=j_scales, j_runner=jr, ref=ref)


def _best_face(outs):
    centers, strides = (_t(v) for v in all_anchor_centers((SIZE, SIZE)))
    cat = lambda key: torch.cat([torch.as_tensor(np.asarray(outs[s][key], np.float32))
                                 for s in (8, 16, 32)], 1)
    scores = torch.sigmoid(cat("scores"))
    best = scores.argmax(1)
    rows = torch.arange(scores.shape[0])
    return (scores[rows, best].numpy(), decode_boxes(centers, strides, cat("bbox"))[rows, best].numpy(),
            decode_landmarks(centers, strides, cat("kps"))[rows, best].numpy())


def _iou(a, b):
    x1, y1 = np.maximum(a[:, 0], b[:, 0]), np.maximum(a[:, 1], b[:, 1])
    x2, y2 = np.minimum(a[:, 2], b[:, 2]), np.minimum(a[:, 3], b[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = lambda r: (r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])
    return inter / (area(a) + area(b) - inter)


def test_int8_detector_weights_equal_jax(det):
    runner, jr = ScrfdInt8Runner(det["detector"], act_scales=det["j_scales"]), det["j_runner"]
    pairs = [(runner.stem2, jr.stem2)]
    for e, je in zip(runner.blocks, jr.blocks):
        assert e["stride"] == je["stride"] and e["last"] == je["last"] and ("down" in e) == ("down" in je)
        pairs += [(e[k], je[k]) for k in ("c1", "c2", "down") if k in e]
    pairs += list(zip(runner.smooth, jr.smooth)) + list(zip(runner.towers, jr.towers))
    assert len(pairs) == 21  # weight sets; the two towers serve all three levels: 25 convs
    for mine, theirs in pairs:
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Unquantized pieces, OIHW here and HWIO there.
    np.testing.assert_array_equal(runner.stem1[0].permute(2, 3, 1, 0).float().numpy(),
                                  np.asarray(jr.stem1[0].astype(jnp.float32)))
    np.testing.assert_array_equal(runner.head_out[0].permute(2, 3, 1, 0).float().numpy(),
                                  np.asarray(jr.head_out[0].astype(jnp.float32)))


@pytest.mark.parametrize("case", ["static", "dynamic"])
def test_int8_detector_matches_jax(det, case):
    """Per-level raw outputs within 0.05 of the level's largest logit /
    distance (bf16 stem, lateral and output convs sum in another order, and
    a flipped tie moves one quantization step), and after decode the best
    face far inside the JAX package's own int8-vs-bf16 bars (IoU > 0.9,
    confidence Δ < 0.06, landmarks Δ < 3 px): IoU > 0.98, confidence
    Δ < 0.01, landmarks Δ < 0.5 px — both sides quantize the same way."""
    runner = ScrfdInt8Runner(det["detector"], act_scales=det["j_scales"] if case == "static" else None)
    out = runner(_t(det["x"]))
    ref = det["ref"][case]
    assert sorted(out) == sorted(ref) == [8, 16, 32]
    for s in ref:
        for k in ("scores", "bbox", "kps"):
            r = np.asarray(ref[s][k], np.float32)
            assert out[s][k].shape == r.shape and out[s][k].dtype == torch.float32
            assert np.abs(out[s][k].numpy() - r).max() <= 0.05 * np.abs(r).max(), (s, k)
    conf, box, lm = _best_face(out)
    conf_r, box_r, lm_r = _best_face(ref)
    assert conf_r.min() > 0.5, "rendered faces give a clear best face"
    assert _iou(box, box_r).min() > 0.98
    assert np.abs(conf - conf_r).max() < 0.01
    assert np.abs(lm - lm_r).max() < 0.5


def test_calibrate_det_act_scales_matches_jax(det):
    x = _t(det["x"])
    scales = calibrate_det_act_scales(det["detector"], [x[:2], x[2:]])
    assert sorted(scales) == sorted(det["j_scales"]) and len(scales) == 22
    for k, v in det["j_scales"].items():
        assert scales[k] == pytest.approx(v, rel=0.05), k
    with pytest.raises(ValueError, match="no calibration"):
        calibrate_det_act_scales(det["detector"], [])


# ---------------------------------------------------------------------------
# The slice as a whole: int8 detector + int8 tail through FusedPipeline
# ---------------------------------------------------------------------------


def test_int8_pipeline_matches_jax(tail, det, monkeypatch):
    """Serving 256², detection 128² (pool folded into the stem), fractional
    window 64, 64² faces, b0, float32 pipeline dtype, both int8 options on
    with the scales of the fixtures above handed to both sides (calibrated
    on the JAX side; the values only have to be the same on both). The JAX
    warp runs its Pallas kernels in interpret mode. Tolerances as in
    tests/test_torch_e2e.py, except boxes and landmarks: float32 convs in
    two frameworks differ in the last place, which now and then puts an
    activation on the other side of a rounding tie and moves it one
    quantization step; a frame with such a flip moves by up to 0.1 px at
    256² (seen: 0.09 px on one frame, 1e-5 px on the other), so 0.25 px —
    against the JAX package's own 3 px bar between its int8 and bf16
    detectors."""
    from functools import partial

    from jax.experimental.pallas import tpu as pltpu

    ck = _restore(CLASSIFIER)
    model_vars = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    cfg = {"model": ck["model_config"]}
    common = dict(detection_input_size=(128, 128), serving_size=(256, 256), output_size=(64, 64),
                  warp_window=64, warp_fractional=True, confidence_threshold=0.0,
                  use_int8_tail=True, use_int8_detector=True,
                  int8_act_scales=tail["j_scales"], det_act_scales=det["j_scales"])
    rng = np.random.default_rng(3)
    frames = np.stack([render_scene(rng, size=256, max_faces=1, p_empty=0.0, min_face=60,
                                    max_face=140)[0] for _ in range(2)])

    jpipe = je2e.FusedPipeline(cfg, dtype=jnp.float32, **common)
    monkeypatch.setattr(je2e, "warp_affine_windowed", partial(j_warp_windowed, use_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        ref = _jit_rounding(jpipe._graph, det["det_vars"], model_vars, jnp.asarray(frames))

    pipe = FusedPipeline(cfg, dtype=torch.float32, device="cpu", **common)
    pipe.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    assert pipe._tail.start == 8 and pipe._det_int8.stem_pool == 2
    out = {k: v.numpy() for k, v in pipe.forward(frames).items()}

    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["has_face"], ref["has_face"])
    assert ref["confidence"].min() > 0.5
    np.testing.assert_allclose(out["confidence"], ref["confidence"], atol=5e-3)
    np.testing.assert_allclose(out["bbox"], ref["bbox"], atol=0.25)
    np.testing.assert_allclose(out["landmarks"], ref["landmarks"], atol=0.25)
    np.testing.assert_allclose(out["quality"], ref["quality"], atol=1e-2)
    np.testing.assert_allclose(out["fake_prob"], ref["fake_prob"], atol=0.02)
    assert out["features"].shape == ref["features"].shape == (2, 1280)

    # compute_quality=False: ones, valid, the rest of the outputs untouched.
    fast = FusedPipeline(cfg, dtype=torch.float32, device="cpu", compute_quality=False, **common)
    fast.load_variables(seed=0, classifier_checkpoint=CLASSIFIER)
    quick = fast.forward(frames)
    assert (quick["quality"] == 1).all() and quick["quality_valid"].all()
    np.testing.assert_array_equal(quick["fake_prob"].numpy(), out["fake_prob"])


def test_pipeline_calibration_entry_points():
    """calibrate_int8 / calibrate_int8_detector store their scales and the
    rebuilt runners serve with them (b0, seeded weights, tiny shapes)."""
    cfg = {"model": {"feature_extractor": {"variant": "b0"}, "classifier": {"hidden_dims": [16]}}}
    kw = dict(detection_input_size=(64, 64), serving_size=(128, 128), output_size=(64, 64),
              warp_window=64, warp_fractional=True, confidence_threshold=0.0, device="cpu")
    with pytest.raises(ValueError, match="scrfd family"):
        FusedPipeline(cfg, use_int8_detector=True, detector_arch="lite", **kw)
    plain = FusedPipeline(cfg, **kw)
    plain.init_variables(0)
    with pytest.raises(ValueError, match="use_int8_tail"):
        plain.calibrate_int8(np.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError, match="use_int8_detector"):
        plain.calibrate_int8_detector(np.zeros((1, 128, 128, 3)))

    pipe = FusedPipeline(cfg, use_int8_tail=True, int8_tail_start=10, use_int8_detector=True, **kw)
    with pytest.raises(RuntimeError, match="init_variables"):
        pipe.calibrate_int8(np.zeros((1, 64, 64, 3)))
    pipe.load_variables(seed=0)
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    dynamic = pipe.forward(frames)
    scales = pipe.calibrate_int8(rng.uniform(0, 255, (4, 64, 64, 3)), batch_size=2)
    det_scales = pipe.calibrate_int8_detector(frames.astype(np.float32), batch_size=2)
    assert pipe.int8_act_scales is scales and len(scales) == 16 - 10
    assert pipe.det_act_scales is det_scales and len(det_scales) == 22
    assert pipe._tail.act_scales is scales and pipe._det_int8.act_scales is det_scales
    static = pipe.forward(frames)
    for out in (dynamic, static):
        assert out["probs"].shape == (3, 2) and torch.isfinite(out["probs"]).all()
        assert torch.isfinite(out["bbox"]).all() and torch.isfinite(out["features"]).all()
