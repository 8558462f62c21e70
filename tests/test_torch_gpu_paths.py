"""The port on the card beyond single kernels, held to the CPU, to float64 or
to its own counts.

Run on a machine with an NVIDIA GPU:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
tests/test_torch_gpu_paths.py``. Without one every test skips.

- every served path, A to J, card against the CPU in float32 (plain kernel
  versions on the CPU), and the kernels one served batch launches;
- ``make_sharded`` over two replicas on the card against ``forward``; the
  "uw" warp through ``warp_affine_windowed``; the kernels' names in a trace;
- the predictor of every detector family and the preprocessing pipeline,
  card against the CPU;
- the B4, ViT-B/16 and SCRFD float32 train steps against float64 on the
  CPU, the bf16 step piece by piece with its breaking controls, the
  trainer, the loaders, two data-parallel ranks on the card, the sharded
  checkpoint;
- the ``run_pipeline`` and ``preprocess_dataset`` CLIs against
  ``--device cpu``; the acceptance bars, a HOG template fit, ``profile_e2e``,
  the probes, ``bench_dataloader`` and ``diag_rss`` on the card.

Served frames with drawn faces come from ``benchmark/traffic_gen.py``; the
training checks keep the batches their limits were measured on.
"""

import contextlib
import copy
import csv
import functools
import hashlib
import io
import json
import math
import socket
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import traffic_gen
from deepfake_vit_tpu_torch import acceptance
from deepfake_vit_tpu_torch.configs import MODEL_CONFIG, PREPROCESSING_CONFIG, TRAINING_CONFIG
from deepfake_vit_tpu_torch.ops import bn_epilogue as be
from deepfake_vit_tpu_torch.ops import fused_mbconv as fm
from deepfake_vit_tpu_torch.ops import fused_stages as fs
from deepfake_vit_tpu_torch.ops import int8_kernel as ik
from deepfake_vit_tpu_torch.ops import layer_norm as ln
from deepfake_vit_tpu_torch.ops import self_attention as sa
from deepfake_vit_tpu_torch.ops import warp_kernel as wk

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    wk.build_library()
    return torch.device("cuda")


@contextlib.contextmanager
def tf32_off():
    """float32 convs and matmuls without TF32; restores both flags."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def kernels():
    """Every hand-written kernel's wrapper, each counting its launches."""
    return (wk.crop_frac, wk.crop_frac_mxu, wk.crop_pool, wk.warp_affine_legacy,
            wk.warp_affine_uw, wk.warp_affine_uw16, wk.warp_affine_int8, ik.int8_gemm,
            ik.int8_conv, fs.run_stem, fs.run_block, fm.fused_mbconv, be.bn_act, be.bn_add,
            be.se_gate, ln.layer_norm, sa.self_attention)


@contextlib.contextmanager
def counted(names=None):
    """Yields a dict filled on exit with the launches of the named wrappers
    (every one by default) inside the block."""
    for k in kernels():
        k.launches = 0
    launches = {}
    yield launches
    torch.cuda.synchronize()
    launches.update({k.__name__: k.launches for k in kernels()
                     if names is None or k.__name__ in names})


def drawn(n, size, seed, faces=1):
    """n uint8 frames (numpy) with drawn faces, ``size`` a side or (H, W)."""
    hw = (size, size) if isinstance(size, int) else size
    return traffic_gen.face_frames(n, hw, seed, "cpu", faces=faces).numpy()


def drawn_train_faces(n, seed, side=224):
    """n ImageNet-normalized drawn faces (float32 NHWC numpy), labels 0/1 in
    turns with a learnable cue (fake faces carry a white band across their
    top tenth, which flips and 5° rotations keep), and landmarks at the
    aligned positions of the reference layout. These are the batches the
    training limits below were measured on: each face an ellipse of skin
    with sclera, iris and brow ellipses, a nose ridge, nostrils and a mouth
    on a colour gradient (``benchmark/traffic_gen.py`` draws the same kind
    of face in other draws, with another cue)."""
    from deepfake_vit_tpu_torch.ops.image import normalize_imagenet
    from deepfake_vit_tpu_torch.preprocessing.aligner import (DEFAULT_REFERENCE_LANDMARKS,
                                                              _LANDMARK_ORDER)

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:side, 0:side].astype(np.float32)
    rgb = np.empty((n, side, side, 3), np.float32)

    def ellipse(img, cx, cy, ax, ay, color):
        img[((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0] = color

    for i in range(n):
        base, gx, gy = rng.uniform(40, 200, 3), rng.normal(0, 0.1, 3), rng.normal(0, 0.1, 3)
        img = np.clip(base + gx * xs[..., None] + gy * ys[..., None], 0, 255).astype(np.float32)
        hw = rng.uniform(0.08, 0.22) * side
        hh = hw * rng.uniform(1.15, 1.4)
        cx, cy = rng.uniform(1.6 * hw, side - 1.6 * hw), rng.uniform(1.2 * hh, side - 1.2 * hh)
        skin = np.asarray([230.0, 180.0, 150.0]) * rng.uniform(0.5, 1.0)
        ellipse(img, cx, cy, hw, hh, skin)
        ex, ey, er = 0.42 * hw, -0.28 * hh, max(2.0, 0.16 * hw)
        for sgn in (-1, 1):
            ellipse(img, cx + sgn * ex, cy + ey, er * 1.35, er * 0.85, (245, 245, 245))
            ellipse(img, cx + sgn * ex, cy + ey, er * 0.55, er * 0.55, rng.uniform(10, 120, 3))
            ellipse(img, cx + sgn * ex, cy + ey - 1.75 * er, er, max(1.0, 0.2 * er), (40, 30, 25))
        ellipse(img, cx, cy + 0.085 * hh, max(1.0, 0.035 * hw), 0.135 * hh, skin * 0.75)
        for sgn in (-1, 1):
            ellipse(img, cx + sgn * 0.1 * hw, cy + 0.26 * hh, max(1.0, 0.045 * hw),
                    max(1.0, 0.045 * hw), (60, 40, 35))
        ellipse(img, cx, cy + 0.55 * hh, 0.32 * hw, max(2.0, 0.11 * hw),
                (rng.uniform(120, 200), rng.uniform(30, 80), rng.uniform(40, 90)))
        img += rng.normal(0, 4.0, img.shape)
        rgb[i] = np.clip(img, 0, 255).astype(np.uint8)
    labels = np.arange(n, dtype=np.int32) % 2
    rgb[labels == 1, : side // 10] = 255.0
    images = normalize_imagenet(torch.from_numpy(rgb / 255.0)).numpy().astype(np.float32)
    ref = np.asarray([DEFAULT_REFERENCE_LANDMARKS[k] for k in _LANDMARK_ORDER], np.float32)
    lms = np.broadcast_to(ref * np.float32(side), (n, 5, 2)).copy()
    return {"image": images, "label": labels, "landmarks": lms}


# ---------------------------------------------------------------------------
# The served paths
# ---------------------------------------------------------------------------

SERVING, DETECT, WINDOW, FACE, TAIL_START, MULTI_K = (640, 640), (320, 320), 128, (192, 192), 10, 3
VIT_MODEL = {"type": "vit", "feature_extractor": {"variant": "base16", "image_size": 224},
             "classifier": {"num_classes": 2}}
TSF_MODEL = {"type": "timesformer",
             "feature_extractor": {"variant": "base16", "image_size": 224, "num_frames": 8},
             "classifier": {"num_classes": 2}}
SWIN_MODEL = {"type": "swin", "feature_extractor": {"variant": "base4w7", "image_size": 224},
              "classifier": {"num_classes": 2}}
_INT8 = {"int8_gemm": 44, "int8_conv": 25}
_B4_EPILOGUES = {"bn_act": 64, "bn_add": 32, "se_gate": 32}
_NO_EPILOGUES = {"bn_act": 0, "bn_add": 0, "se_gate": 0}
# Launches a served batch: 22 tail blocks x (expand, project); 1 + 12 + 3 + 3
# + 6 detector convs; one crop and one warp; the stem and one launch group
# (three device launches) per fused block: blocks 0-9 at 192² faces, 0-21 at
# 224²; the B4's epilogues (stem, 30 expands, 32 depthwise and the head; 32
# bn2, 25 with the residual; 32 gates) and none in the transformers, whose
# LayerNorms are 2 a block and the final one (the TimeSformer's ln_t
# besides) and whose attention cores are 1 a block (the TimeSformer's
# temporal one besides); the Swin-B's 46 LayerNorms of at most 768 values
# (the embedding's, 2 a block in stages 1-3, the first merge's; the 7 wider
# take the plain path) and no attention kernel (its core adds a bias and has
# heads of 32). Every wrapper of _ZERO_UNLESS_LISTED that a path
# does not list launches 0 times: the first twelve and a thirteenth, the
# attention core (0 on every B4 path).
PATHS = {
    "A int8 headline": {**_INT8, "crop_frac": 1, "warp_affine_legacy": 1},
    "B default pooled warp": {"crop_pool": 1, "warp_affine_legacy": 1, **_B4_EPILOGUES,
                              "layer_norm": 0},
    "bf16 headline geometry": {"crop_frac": 1, "warp_affine_legacy": 1},
    "C fused backbone": {"crop_frac": 1, "warp_affine_legacy": 1, "run_stem": 1, "run_block": 10},
    "D fused backbone, default geometry": {"crop_pool": 1, "warp_affine_legacy": 1,
                                           "run_stem": 1, "run_block": 22},
    "E int8-tap headline": {**_INT8, "crop_frac_mxu": 1, "warp_affine_int8": 1},
    "F multi-face, lite detector": {"crop_pool": 1, "warp_affine_uw16": 1},
    "G s2d + int8 headline": {**_INT8, "crop_frac": 1, "warp_affine_legacy": 1},
    "H mtcnn detector": {"crop_pool": 1, "warp_affine_legacy": 1},
    "I ViT-B/16, default pooled warp": {"crop_pool": 1, "warp_affine_legacy": 1,
                                        **_NO_EPILOGUES, "layer_norm": 25,
                                        "self_attention": 12},
    "J TimeSformer-Base, default pooled warp": {"crop_pool": 1, "warp_affine_legacy": 1,
                                                **_NO_EPILOGUES, "layer_norm": 37,
                                                "self_attention": 24},
    "K Swin-B, default pooled warp": {"crop_pool": 1, "warp_affine_legacy": 1,
                                      **_NO_EPILOGUES, "layer_norm": 46, "self_attention": 0},
}
_ZERO_UNLESS_LISTED = [k.__name__ for k in kernels()[:12]] + [sa.self_attention.__name__]
# The batches each path is served at: 32 and the benchmark cells' 128; the
# fused backbone's path D and the multi-face path F (3 face slots a frame) at
# 32.
PATH_BATCHES = {path: (32,) if path[0] in "DF" else (32, 128) for path in PATHS}
H_FACES = (36, 110)  # MTCNN-Lite's training faces (px), drawn into 640² frames


def build_pipeline(path, dtype=torch.bfloat16, device=None, scales=None):
    """One of the served configurations. Paths A, E and G are calibrated as
    the JAX benchmark calibrates its headline (8 uniform-noise faces, 4
    uniform-noise frames, seeded; G's tail on its own s2d activations)
    unless ``scales`` hands the scales over."""
    from deepfake_vit_tpu_torch.e2e import FusedPipeline

    common = dict(detection_input_size=DETECT, serving_size=SERVING, confidence_threshold=0.0,
                  dtype=dtype, device=device)
    int8 = path[0] in "AEG"
    if int8:
        tail_scales, det_scales = scales or (None, None)
        pipe = FusedPipeline(MODEL_CONFIG, use_int8_tail=True, int8_tail_start=TAIL_START,
                             warp_window=WINDOW, warp_fractional=True, use_int8_detector=True,
                             output_size=FACE, int8_act_scales=tail_scales,
                             det_act_scales=det_scales, use_s2d_early=path[0] == "G",
                             warp_tap_mode="int8" if path[0] == "E" else "legacy", **common)
    elif path[0] in "BDFHIJK":  # default warp arguments and face size
        extra = (dict(detector_arch="lite", keep_top_k=MULTI_K, warp_tap_mode="uw16")
                 if path[0] == "F" else {})
        if path[0] == "H":  # MTCNN-Lite serves at a pool ratio of 1: a 640² canvas
            extra = dict(detector_arch="mtcnn")
            common["detection_input_size"] = SERVING
        config = {"I": {"model": VIT_MODEL}, "J": {"model": TSF_MODEL},
                  "K": {"model": SWIN_MODEL}}.get(path[0], MODEL_CONFIG)
        pipe = FusedPipeline(config, use_fused_backbone=path[0] == "D", **extra, **common)
        assert (pipe.warp_window, pipe.warp_fractional, pipe.output_size) == (160, False, (224, 224))
    else:
        pipe = FusedPipeline(MODEL_CONFIG, output_size=FACE, warp_window=WINDOW,
                             warp_fractional=True, warp_tap_mode="legacy",
                             use_fused_backbone=path[0] == "C", **common)
    pipe.load_variables(seed=0)
    if int8 and scales is None:
        pipe.calibrate_int8(np.random.default_rng(1).uniform(0, 255, (8, *FACE, 3)), batch_size=8)
        pipe.calibrate_int8_detector(
            np.random.default_rng(2).uniform(0, 255, (4, *SERVING, 3)).astype(np.float32))
    return pipe


def h_scenes(n, seed):
    """n 640² drawn scenes (``data/synth_faces.py::render_scene``) with 1-3
    faces of H_FACES px each, and whether MTCNN-Lite (640² canvas,
    threshold 0.5) finds a face in each on the CPU."""
    from deepfake_vit_tpu_torch.data.synth_faces import render_scene
    from deepfake_vit_tpu_torch.preprocessing.detector import FaceDetector

    rng = np.random.default_rng(seed)
    frames = np.stack([render_scene(rng, size=SERVING[0], max_faces=3, min_face=H_FACES[0],
                                    max_face=H_FACES[1], p_empty=0.0)[0] for _ in range(n)])
    det = FaceDetector(model_name="mtcnn", input_size=SERVING, device="cpu")
    return frames, np.asarray([d is not None for d in det.batch_detect(list(frames))])


# Card vs CPU, float32. Float convolutions differ in the last place between
# cuDNN and the CPU; on the int8 path that now and then puts an activation
# on the other side of a rounding tie and moves it one quantization step,
# hence the wider limits of paths A, E and G. The fused backbone works in
# bf16 whatever the pipeline dtype, and kernel and plain version differ by a
# bf16 step in a small share of the early activations, which the float32
# tail carries on. The seeded B4 puts every probability at 0.5 (its features
# are of the order 1e-7), so the fused paths are also held on the features,
# relative to the largest.
TIGHT = {"bbox": 1e-2, "landmarks": 1e-2, "quality": 1e-2, "probs": 1e-3}
INT8_LIMITS = {"confidence": 0.02, "bbox": 0.5, "landmarks": 0.5, "quality": 0.02, "probs": 0.02}
FUSED_FEATURES_REL = 1e-2  # max |Δfeatures| / max |features|
CARD_VS_CPU = {
    "A int8 headline": INT8_LIMITS, "B default pooled warp": TIGHT,
    "bf16 headline geometry": TIGHT,
    "C fused backbone": {**TIGHT, "features_rel": FUSED_FEATURES_REL},
    "D fused backbone, default geometry": {**TIGHT, "features_rel": FUSED_FEATURES_REL},
    "E int8-tap headline": INT8_LIMITS,
    # Two and three faces found in the two frames, their scores at least 0.003
    # apart on the CPU: the NMS order is no near tie.
    "F multi-face, lite detector": {**TIGHT, "confidence": 1e-3, "face_valid": 0.0},
    "G s2d + int8 headline": INT8_LIMITS, "H mtcnn detector": TIGHT,
    "I ViT-B/16, default pooled warp": TIGHT, "J TimeSformer-Base, default pooled warp": TIGHT,
    "K Swin-B, default pooled warp": TIGHT,
}


def card_vs_cpu_frames(path):
    if path[0] == "F":
        return drawn(2, SERVING[0], 8, faces=3)
    if path[0] == "H":  # drawn scenes with MTCNN-Lite's face sizes
        frames, found = h_scenes(32, 9)
        assert found.sum() >= 2, f"MTCNN-Lite finds faces in {int(found.sum())} of 32 scenes"
        return frames[np.flatnonzero(found)[:2]]
    return drawn(8 if path[0] == "J" else 2, SERVING[0], 5)  # J: one clip of 8 frames


@pytest.mark.parametrize("path", list(PATHS))
def test_path_card_matches_cpu(dev, path):
    """The pipeline on the card against the same pipeline on the CPU (plain
    kernel versions), float32 without TF32, on frames with drawn faces;
    the int8 paths hand the card's calibrated scales to the CPU side."""
    frames, limits = card_vs_cpu_frames(path), CARD_VS_CPU[path]
    outs, scales = {}, None
    with tf32_off():
        for where in (dev, "cpu"):
            p = build_pipeline(path, torch.float32, where, scales)
            if path[0] in "AEG":
                scales = (p.int8_act_scales, p.det_act_scales)
            outs[str(where)] = {k: v.float().cpu().numpy() for k, v in p.forward(frames).items()}
            del p
    card, cpu = outs[str(dev)], outs["cpu"]
    assert card["confidence"].min() >= 0.5, card["confidence"]
    err = {k: float(np.abs(card[k] - cpu[k]).max()) for k in limits if k != "features_rel"}
    if "features_rel" in limits:  # relative to the largest feature: seeded weights give tiny ones
        err["features_rel"] = float(np.abs(card["features"] - cpu["features"]).max()
                                    / np.abs(cpu["features"]).max())
    print(f"path {path}: card vs CPU, float32, {len(frames)} frames: max_abs {err}")
    assert all(err[k] <= limits[k] for k in limits), (err, limits)


def served_frames(path, n):
    """n served frames: seeded noise; path H its drawn scenes, repeated."""
    if path[0] == "H":
        return torch.from_numpy(np.resize(h_scenes(32, 9)[0], (n, *SERVING, 3)))
    return torch.from_numpy(np.random.default_rng(32).integers(0, 256, (n, *SERVING, 3),
                                                               dtype=np.uint8))


@pytest.mark.parametrize("path,n", [(p, n) for p in PATHS for n in PATH_BATCHES[p]])
def test_served_batch_launches_the_paths_kernels(dev, path, n):
    """One served batch of n frames after a warm-up: each wrapper launches
    as often as the path says, and the outputs are finite, one row a face
    slot."""
    frames = served_frames(path, n)
    pipe = build_pipeline(path)
    pipe.forward(frames)
    torch.cuda.synchronize()
    want = {**dict.fromkeys(_ZERO_UNLESS_LISTED, 0), **PATHS[path]}
    with counted(want) as launches:
        out = pipe.forward(frames)
    assert launches == want
    lead = (n, pipe.keep_top_k) if pipe.keep_top_k > 1 else (n,)
    feat = pipe.model.width if path[0] in "IJK" else pipe.model.feature_extractor.feature_dim
    assert out["probs"].shape == (*lead, 2) and out["features"].shape == (*lead, feat)
    for key in ("probs", "bbox", "landmarks", "quality", "features", "fake_prob"):
        assert torch.isfinite(out[key].float()).all(), key


def test_a_traced_batch_names_the_kernels(dev):
    """One batch of path I under ``utils/profiling.trace``: the Chrome trace
    names the crop and warp kernels and the caller's range."""
    from deepfake_vit_tpu_torch.utils.profiling import annotate, trace

    pipe = build_pipeline("I ViT-B/16, default pooled warp")
    frames = torch.from_numpy(drawn(8, SERVING[0], 5))
    pipe.forward(frames)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp), annotate("path I batch"):
            pipe.forward(frames)
        text = (Path(tmp) / "trace.json").read_text()
    for name in ("warp_tile_kernel", "crop_pool_band_kernel", "path I batch"):
        assert name in text, name


def test_make_sharded_over_two_replicas_matches_forward(dev):
    """Path A through ``make_sharded`` over [card, card] (two replicas on one
    card) against ``forward`` on 128 frames (drawn faces first, then seeded
    noise): ``has_face`` identical, the int8 limits, every kernel twice path
    A's count; a one-device mesh gives ``forward`` itself."""
    from deepfake_vit_tpu_torch.parallel import make_mesh

    pipe = build_pipeline("A int8 headline")
    frames = torch.from_numpy(np.random.default_rng(77).integers(0, 256, (128, *SERVING, 3),
                                                                 dtype=np.uint8))
    frames[:16] = torch.from_numpy(drawn(16, SERVING[0], 78))
    assert pipe.make_sharded(make_mesh(devices=[dev])) == pipe.forward
    sharded = pipe.make_sharded(make_mesh(devices=[dev, dev]))
    ref = pipe.forward(frames)
    sharded(frames)
    want = {k: 2 * v for k, v in {**dict.fromkeys(_ZERO_UNLESS_LISTED, 0),
                                  **PATHS["A int8 headline"]}.items()}
    with counted(want) as launches:
        out = sharded(frames)
    assert launches == want
    assert torch.equal(out["has_face"], ref["has_face"])
    err = {k: float((out[k].float() - ref[k].float()).abs().max()) for k in INT8_LIMITS}
    assert all(err[k] <= INT8_LIMITS[k] for k in INT8_LIMITS), err


def test_uw_windowed_warp_launches_one_crop_and_one_warp(dev):
    """The "uw" tap mode is on no served path: ``warp_affine_windowed(
    tap_construction="uw")`` on 32 frames with 3 faces each launches one
    pooled crop and one "uw" warp, and equals the "uw16" call bit for bit."""
    from deepfake_vit_tpu_torch.ops.warp import warp_affine_windowed

    n = 32 * MULTI_K
    frames = torch.from_numpy(drawn(32, SERVING[0], 9)).to(dev)
    rng = np.random.default_rng(9)
    s, th = rng.uniform(0.4, 2.5, n), rng.uniform(-0.35, 0.35, n)
    R = s[:, None, None] * np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                                     np.stack([np.sin(th), np.cos(th)], -1)], 1)
    t = rng.uniform(-40, 680, (n, 2)) - np.einsum("nij,j->ni", R, np.asarray([111.5, 111.5]))
    A_inv = torch.as_tensor(np.concatenate([R, t[..., None]], -1), dtype=torch.float32,
                            device=dev)
    args = dict(window=160, inverse=True, frame_indices=torch.arange(n, device=dev) // MULTI_K)
    want = {**dict.fromkeys(_ZERO_UNLESS_LISTED, 0), "crop_pool": 1, "warp_affine_uw": 1}
    with counted(want) as launches:
        uw = warp_affine_windowed(frames, A_inv, (224, 224), tap_construction="uw", **args)
    assert launches == want
    assert torch.equal(uw, warp_affine_windowed(frames, A_inv, (224, 224),
                                                tap_construction="uw16", **args))


# ---------------------------------------------------------------------------
# The predictor and the preprocessing pipeline
# ---------------------------------------------------------------------------

# The predictor's clips of drawn faces: a video at 1280×720, letterboxed
# into the 640² detection canvas, and one at 640²: frames, height, width,
# seed. On the CPU the committed SCRFD scores every frame at least 0.158
# from the 0.5 threshold (19 of the 32 640² frames hold a face above it),
# MTCNN-Lite at least 0.097.
PREDICTOR_CLIPS = {"1280x720": (5, 720, 1280, 34), "640x640": (32, 640, 640, 47)}
PREDICTOR_PROB_TOL = 0.02  # fake_prob, card vs CPU (tests/test_torch_e2e.py's bound)
# Overrides of PREPROCESSING_CONFIG["detection"] (HOG at its class default
# canvas, 320²; the others at the config's 640²); "hog + ViT-B/16" is the
# reference's fallback stack with a seeded ViT-B/16.
DETECTOR_FAMILIES = {"scrfd": {}, "mtcnn": {"model": "mtcnn"},
                     "hog": {"model": "hog", "scrfd": {"input_size": [320, 320]}},
                     "scrfd + refine": {"refine": True},
                     "hog + ViT-B/16": {"model": "hog", "scrfd": {"input_size": [320, 320]}}}


def clip(name):
    n, h, w, seed = PREDICTOR_CLIPS[name]
    return list(drawn(n, (h, w), seed))


@pytest.mark.parametrize("family", list(DETECTOR_FAMILIES))
def test_predictor_card_matches_cpu(dev, family):
    """``DeepfakePredictor`` (the committed b0 classifier, or the seeded
    ViT-B/16) with each detector family: in float32 card vs CPU (num_faces
    equal and not 0, fake_prob within PREDICTOR_PROB_TOL, labels equal away
    from the threshold; the ViT on the 1280×720 clip); then in bf16 on the
    card one warp launch a clip (and the ViT's 12 attention cores: one
    batch of faces) and finite probabilities, and with SCRFD a seeded
    full-width B4 predictor the same."""
    from deepfake_vit_tpu_torch.inference import DeepfakePredictor
    from deepfake_vit_tpu_torch.models.vit import ViTClassifier
    from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path

    config = {**PREPROCESSING_CONFIG,
              "detection": {**PREPROCESSING_CONFIG["detection"], **DETECTOR_FAMILIES[family]}}
    vit = family.endswith("ViT-B/16")
    if vit:
        make = functools.partial(DeepfakePredictor, {"model": VIT_MODEL}, config)
    else:
        make = functools.partial(DeepfakePredictor.from_packaged,
                                 default_weights_path("classifier"), config)
    with tf32_off():
        card32, cpu32 = make(dtype=torch.float32, device=dev), make(dtype=torch.float32,
                                                                    device="cpu")
        for name in ["1280x720"] if vit else list(PREDICTOR_CLIPS):
            got, want = card32.predict_frames(clip(name)), cpu32.predict_frames(clip(name))
            err = abs(got["fake_prob"] - want["fake_prob"])
            print(f"{family}, {name}: num_faces {got['num_faces']} / {want['num_faces']}, "
                  f"fake_prob {got['fake_prob']:.5f} / {want['fake_prob']:.5f}")
            assert got["num_faces"] == want["num_faces"] > 0
            assert err <= PREDICTOR_PROB_TOL
            assert (got["label"] == want["label"]
                    or abs(want["fake_prob"] - cpu32.threshold) <= PREDICTOR_PROB_TOL)
    assert isinstance(card32.model, ViTClassifier) == vit
    del card32, cpu32
    served = [(make(device=dev), name) for name in PREDICTOR_CLIPS]
    if family == "scrfd":
        served.append((DeepfakePredictor(MODEL_CONFIG, config, device=dev), "640x640"))
    for pred, name in served:
        frames = clip(name)
        pred.predict_frames(frames)  # warm-up
        want = {**dict.fromkeys(_ZERO_UNLESS_LISTED, 0), "warp_affine_legacy": 1,
                "self_attention": 12 if vit else 0}
        with counted(want) as launches:
            out = pred.predict_frames(frames)
        assert launches == want, name
        assert out["num_faces"] > 0 and all(math.isfinite(p) for p in out["frame_probs"])


# Aligned uint8 faces, card vs CPU: the detections differ by about 2e-4 px
# (float32 convolutions in two orders); the warp's bf16 taps and sums are
# step functions of the coordinates, so such a shift moves an output by up
# to a tap step and two bf16 roundings (about 2.5 levels, 3 after the
# truncation to uint8) at a few per cent of the pixels, by more than one
# level at about 0.1 % (CPU, landmarks moved by 2e-4 px).
ALIGNED_U8_TOL = 3.0


def test_preprocessing_pipeline_card_matches_cpu(dev):
    """``PreprocessingPipeline(PREPROCESSING_CONFIG)``'s one-graph batch of
    the 32-frame clip on the card against the CPU, float32 without TF32:
    the same frames with a face, bboxes within 1e-2 px, quality within
    1e-2, aligned faces within ALIGNED_U8_TOL with fewer than 1 % of the
    values more than one level apart; one warp launch a batch."""
    from deepfake_vit_tpu_torch.preprocessing.pipeline import PreprocessingPipeline

    frames = clip("640x640")
    with tf32_off():
        card = PreprocessingPipeline(PREPROCESSING_CONFIG, device=dev)
        card.process_batch(frames[:2])  # warm-up
        want_launches = {**dict.fromkeys(_ZERO_UNLESS_LISTED, 0), "warp_affine_legacy": 1}
        with counted(want_launches) as launches:
            got = card.process_batch(frames)
        want = PreprocessingPipeline(PREPROCESSING_CONFIG, device="cpu").process_batch(frames)
    assert launches == want_launches
    err = {"bbox": 0.0, "aligned": 0.0, "quality": 0.0}
    beyond_one, pixels = 0, 0
    for g, w in zip(got, want):
        assert g.success == w.success
        if not g.success:
            continue
        err["bbox"] = max(err["bbox"], float(np.abs(g.bbox - w.bbox).max()))
        diff = np.abs(g.aligned_face.astype(np.int32) - w.aligned_face.astype(np.int32))
        err["aligned"] = max(err["aligned"], float(diff.max()))
        beyond_one, pixels = beyond_one + int((diff > 1).sum()), pixels + diff.size
        err["quality"] = max(err["quality"], abs(g.quality_score - w.quality_score))
    err["aligned_share_beyond_1"] = beyond_one / max(pixels, 1)
    limits = {"bbox": 1e-2, "aligned": ALIGNED_U8_TOL, "aligned_share_beyond_1": 0.01,
              "quality": 1e-2}
    assert sum(g.success for g in got) > 0
    assert all(err[k] <= limits[k] for k in limits), err


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# One AdamW step at batch 4 (dropout, drop-connect and augmentation off) on
# the card in float32 without TF32, held on each batch to a float64 step of
# the same batch on the CPU (``compare_steps``' measures). A float32 step on
# the CPU is no yardstick: on an H100 80GB HBM3 at 700 W it lay 1.9e-4 /
# 6.1e-3 / 3.0e-4 / 2.2e-4 / 7.4e-3 of the largest gradient from float64 on
# five seeded batches of the B4 (its stem and first blocks on two of them),
# the card 1.7e-4 / 2.5e-4 / 3.0e-4 / 2.2e-4 / 4.6e-4 (1 − cosine at most
# 2.9e-8, loss 4.4e-5, grad_norm 1.7e-4, statistics 6.0e-6). The limits are
# the ones the card-vs-CPU gate held on one batch: a sign error moves the
# updates by 2 lr, a wrong lr by about 1 lr.
TRAIN_LIMITS = {"loss_rel": 1e-4, "grad_norm_rel": 3e-4, "grads_rel": 1e-3, "grads_cos_gap": 1e-6,
                "update_rel": 1e-2, "stats_rel": 5e-5}
TRAIN_SEEDS = (22, 24, 25, 27, 29)
DT_SIZE, DT_BATCH, DT_MAX_FACES, DT_LR = 320, 32, 8, 1e-3  # the detector CLI's defaults


def _no_dropout_config(model=None):
    cfg = copy.deepcopy(TRAINING_CONFIG)
    if model is not None:
        cfg["model"] = copy.deepcopy(model)
    else:
        cfg["model"]["feature_extractor"]["dropout_rate"] = 0.0
        cfg["model"]["classifier"]["dropout_rate"] = 0.0
    return cfg


def train_setup(cfg, dtype, dev, seed=0, clip=1.0):
    """The model, optimizer and criterion the train CLI builds from ``cfg``
    (float64: the same initial values in float64)."""
    from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.training import create_optimizer, make_criterion

    model = init_weights(create_model_from_config(cfg["model"], dtype=dtype), seed)
    model = (model.double() if dtype == torch.float64 else model).to(dev)
    opt = create_optimizer(model.parameters(), cfg["training"]["optimizer"], gradient_clip=clip)
    return model, opt, make_criterion(cfg["training"]["loss"], torch.ones(2))


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def step_record(model, p0, metrics):
    """A step's metrics, clipped gradients, each parameter's update and the
    running statistics after, in ``compare_steps``' layout."""
    from deepfake_vit_tpu_torch.models.bridge import export_flax_variables

    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.double().cpu().numpy() for n, p in model.named_parameters()},
            "update": {n: (p.detach().double().cpu() - p0[n]).numpy()
                       for n, p in model.named_parameters()},
            "batch_stats": flat_tree(export_flax_variables(model)["batch_stats"])}


def initial(model):
    return {n: p.detach().to("cpu", torch.float64, copy=True) for n, p in model.named_parameters()}


def one_train_step(cfg, dtype, dev, batch):
    """One step of the train CLI's step function (no augmentation)."""
    from deepfake_vit_tpu_torch.training import TrainState, make_train_step

    model, opt, crit = train_setup(cfg, dtype, dev)
    if hasattr(model, "feature_extractor"):  # a ViT has no drop-connect
        model.feature_extractor.backbone.drop_connect_rate = 0.0
    p0 = initial(model)
    return step_record(model, p0, make_train_step(model, crit, opt)(TrainState(), batch, 0))


def detector_step(dtype, dev, batch):
    """One SCRFD train step (seeded, the detector CLI's optimizer)."""
    from deepfake_vit_tpu_torch.models.layers import init_weights
    from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net
    from deepfake_vit_tpu_torch.training import create_optimizer
    from deepfake_vit_tpu_torch.training.detection import make_detector_train_step

    model = init_weights(build_detection_net("scrfd", dtype=dtype), 0)
    model = (model.double() if dtype == torch.float64 else model).to(dev)
    p0 = initial(model)
    opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": DT_LR}, gradient_clip=5.0)
    losses = make_detector_train_step(model, opt, (DT_SIZE, DT_SIZE))(batch)
    return step_record(model, p0, {"loss": losses["total"], "grad_norm": losses["grad_norm"]})


def compare_steps(got, want, lr):
    """Two steps' gaps: loss and grad_norm relative; gradients as max |Δ|
    over the largest |g| and as 1 − the cosine of the two gradient
    vectors; the updates on the elements whose reference gradient is at
    least 1e-3 of the largest (Adam moves the others by float noise's
    sign) as max |Δ| over lr; running statistics as max |Δ| over the
    largest (0 for a model without any, as the ViT)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    gmax = max(np.abs(g).max() for g in want["grads"].values())
    g1 = np.concatenate([got["grads"][k].ravel() for k in want["grads"]])
    g0 = np.concatenate([g.ravel() for g in want["grads"].values()])
    big = np.abs(g0) >= 1e-3 * gmax
    du = np.abs(np.concatenate([got["update"][k].ravel() for k in want["grads"]])
                - np.concatenate([want["update"][k].ravel() for k in want["grads"]]))[big]
    smax = max((np.abs(s).max() for s in want["batch_stats"].values()), default=1.0)
    return {
        "loss_rel": rel(got["metrics"]["loss"], want["metrics"]["loss"]),
        "grad_norm_rel": rel(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"]),
        "grads_rel": float(np.abs(g1 - g0).max() / gmax),
        "grads_cos_gap": 1.0 - float(g1 @ g0 / (np.linalg.norm(g1) * np.linalg.norm(g0))),
        "update_rel": float(du.max() / lr),
        "stats_rel": max((np.abs(got["batch_stats"][k] - s).max()
                          for k, s in want["batch_stats"].items()), default=0.0) / smax,
    }


def detector_batch():
    """One batch of 32 scenes written by ``write_corpus`` at the detector
    CLI's defaults (320², 8 faces at most)."""
    from deepfake_vit_tpu_torch.data.synth_faces import write_corpus
    from deepfake_vit_tpu_torch.train_detector import load_annotations, make_batch

    with tempfile.TemporaryDirectory() as tmp:
        records = load_annotations(write_corpus(tmp, 64, size=DT_SIZE, seed=42,
                                                max_faces=DT_MAX_FACES))
        order = np.random.default_rng(42).permutation(64)
        return make_batch(records, order[:DT_BATCH], DT_SIZE, DT_MAX_FACES)


@pytest.mark.parametrize("case", [f"b4-{s}" for s in TRAIN_SEEDS] + ["vit-22", "scrfd"])
def test_float32_train_step_matches_float64(dev, case):
    """The B4 of the training configuration at 224² (five batches), the
    ViT-B/16 at 224² (one) and the SCRFD detector at the detector CLI's
    defaults: one step on the card in float32 without TF32 within
    TRAIN_LIMITS of a float64 step on the CPU."""
    if case == "scrfd":
        batch = detector_batch()
        f64, lr = detector_step(torch.float64, "cpu", batch), DT_LR
        with tf32_off():
            got = detector_step(torch.float32, dev, batch)
    else:
        model, seed = case.split("-")
        cfg = _no_dropout_config(VIT_MODEL if model == "vit" else None)
        batch, lr = drawn_train_faces(4, int(seed)), cfg["training"]["optimizer"]["lr"]
        f64 = one_train_step(cfg, torch.float64, "cpu", batch)
        with tf32_off():
            got = one_train_step(cfg, torch.float32, dev, batch)
    gaps = compare_steps(got, f64, lr)
    print(f"{case}: card (float32) vs CPU (float64): "
          f"{ {k: float(f'{v:.3g}') for k, v in gaps.items()} }")
    assert all(gaps[k] <= lim for k, lim in TRAIN_LIMITS.items()), gaps


# bf16 (the configuration's use_amp): at the seeded init a bf16 rounding
# anywhere moves the whole step's gradient by about its own size (the B4's
# bf16 step against the float32 one, the L2 gap of the gradients 1.20-1.45
# over five batches, as far as the CPU's bf16 step; 1.33 at batch 32, 0.64
# with freeze_bn), so the whole step is held only to be finite, and the step
# is held piece by piece (``bf16_pieces``), each piece fed the float32
# input. Five seeded batches on an H100 80GB HBM3 at 700 W: the median
# stem/block piece 0.00741-0.00747, the worst 0.0152-0.0377, the features
# 0.034-0.075, the classifier (its BatchNorm over 4 samples) 0.028-0.25.
# Controls, same batches: every convolution's output and gradient at 7, 6
# and 5 significant bits (bf16 keeps 8) give medians 0.0097, 0.0157 and
# 0.0292; BatchNorm computed in bf16 gives a median of 0.0103 and a worst
# piece of 0.127-0.234. The median holds the precision; the worst piece
# holds a fault in one piece; the features and the classifier only gross
# faults. The 6-bit and the BatchNorm controls must each break a limit.
BF16_PIECE_LIMITS = {"blocks_worst": 0.06, "blocks_median": 0.0086, "features": 0.15,
                     "classifier": 0.5}


def round_conv_outputs(model, bits):
    """A control, coarser than bf16: every convolution's output, and the
    gradient that reaches it in the backward, rounded to ``bits``
    significant bits."""
    from deepfake_vit_tpu_torch.models.layers import Conv

    drop = 24 - bits

    def coarse(x):
        i = x.float().view(torch.int32)
        return ((i + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32).to(x.dtype)

    class Coarse(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return coarse(x)

        @staticmethod
        def backward(ctx, g):
            return coarse(g)

    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(lambda module, inputs, out: Coarse.apply(out))


def bn_in_input_dtype(model):
    """A faulty control: every BatchNorm computes its statistics and its
    output in the activations' dtype (bf16) instead of float32."""
    from deepfake_vit_tpu_torch.models.layers import BatchNorm

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training and not self.frozen:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dims)
            var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.to(x.dtype).view(shape)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = forward.__get__(m)


def bf16_pieces(cfg, dev, batch, fault=None):
    """The bf16 train step piece by piece against float32 on the CPU: the
    stem, each MBConv block, the features (head conv, attention, pooling)
    and the classifier with the loss, each fed the float32 model's input
    to it, in train mode. A piece other than the last ends in a seeded
    random probe (the sum of its output times fixed noise). For each
    piece: its output, the gradient of its input and its parameters'
    gradients as the L2 norm of the difference over the reference's, the
    worst of the three. Returns the worst and the median piece of the stem
    and blocks, and the features' and the classifier's. ``fault`` acts on
    the bf16 model (the controls)."""
    ref, _, crit = train_setup(cfg, torch.float32, "cpu")
    low, _, crit_low = train_setup(cfg, torch.bfloat16, dev)
    for m in (ref, low):
        m.feature_extractor.backbone.drop_connect_rate = 0.0
        m.train()
    if fault is not None:
        fault(low)
    n = len(ref.feature_extractor.backbone.blocks)
    lms, labels = torch.from_numpy(batch["landmarks"]), torch.from_numpy(batch["label"])

    def piece(k, m, x, where):
        bb = m.feature_extractor.backbone
        if k == 0:
            return bb(x, stop_block=0)
        if k <= n:
            return getattr(bb, f"block_{k - 1}")(x.to(bb.dtype))
        if k == n + 1:
            return m.feature_extractor(x, lms.to(where), backbone_start_block=n)
        h = x.to(bb.dtype)
        for i in range(m.n_hidden):
            h = getattr(m, f"head_{i}")(h)
        return (crit if where == "cpu" else crit_low)(m.final(h).float(), labels.to(where),
                                                       x)["total"]

    def gap(a, b):
        return float((a.double().cpu() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    g = torch.Generator().manual_seed(0)
    x = torch.from_numpy(batch["image"])
    errs = []
    for k in range(n + 3):
        runs = []
        for m, where in ((ref, "cpu"), (low, dev)):
            m.zero_grad(set_to_none=True)
            xi = x.to(where).clone().requires_grad_()
            runs.append((xi, piece(k, m, xi, where)))
        (xr, yr), (xl, yl) = runs
        if k <= n + 1:
            probe = torch.randn(yr.shape, generator=g)
            (yr * probe).sum().backward()
            (yl.float() * probe.to(dev)).sum().backward()
        else:
            yr.backward()
            yl.backward()
        named = dict(low.named_parameters())
        pr = [(name, p.grad) for name, p in ref.named_parameters() if p.grad is not None]
        errs.append(max(gap(yl.detach().float(), yr.detach()), gap(xl.grad, xr.grad),
                        gap(torch.cat([named[name].grad.flatten().cpu() for name, _ in pr]),
                            torch.cat([q.flatten() for _, q in pr]))))
        x = yr.detach()
    return {"blocks_worst": max(errs[:n + 1]), "blocks_median": statistics.median(errs[:n + 1]),
            "features": errs[n + 1], "classifier": errs[n + 2]}


BF16_CASES = {"bf16": None, "control: convolutions at 6 bits": lambda m: round_conv_outputs(m, 6),
              "control: BatchNorm in bf16": bn_in_input_dtype}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_train_step_piece_by_piece(dev, case):
    """The B4's bf16 step on the card against float32 on the CPU, piece by
    piece (batch 4, seed 22): within BF16_PIECE_LIMITS, the whole step
    finite; each control breaks a limit."""
    cfg = _no_dropout_config()
    batch = drawn_train_faces(4, TRAIN_SEEDS[0])
    pieces = bf16_pieces(cfg, dev, batch, BF16_CASES[case])
    print(f"{case}: {pieces} (limits {BF16_PIECE_LIMITS})")
    over = {k: v for k, v in pieces.items() if not v <= BF16_PIECE_LIMITS[k]}
    if case == "bf16":
        assert not over
        lr = cfg["training"]["optimizer"]["lr"]
        whole = compare_steps(one_train_step(cfg, torch.bfloat16, dev, batch),
                              one_train_step(cfg, torch.float32, "cpu", batch), lr)
        assert all(math.isfinite(v) for v in whole.values()), whole
    else:
        assert over, "the limits cannot see this fault"


LEARN_AUG = {"enabled": True, "random_flip": True, "random_rotation": 5, "color_jitter": 0.1}


@pytest.mark.parametrize("model", ["b4", "vit"])
def test_trainer_on_the_card(dev, model):
    """30 steps of the training configuration (bf16, CombinedLoss, AdamW +
    clip 1.0, augmentation on; dropout and drop-connect off, whose masks'
    noise hides a 30-step trend) through ``Trainer``'s step on one batch of
    32 drawn faces: one warp launch a step and no other kernel, the loss
    finite; the B4's loss falls, and its checkpoint serves through
    ``DeepfakePredictor`` with the probabilities of the trainer's eval step
    (within 1e-3)."""
    from deepfake_vit_tpu_torch.inference import DeepfakePredictor
    from deepfake_vit_tpu_torch.ops.augment import make_augment_fn
    from deepfake_vit_tpu_torch.training import Trainer, create_scheduler, make_eval_step

    cfg = _no_dropout_config(VIT_MODEL if model == "vit" else None)
    cfg["data"]["augmentation"] = dict(LEARN_AUG)
    net, opt, crit = train_setup(cfg, torch.bfloat16, dev, seed=1)
    if model == "b4":
        net.feature_extractor.backbone.drop_connect_rate = 0.0
    lr = cfg["training"]["optimizer"]["lr"]
    trainer = Trainer(net, opt, crit, [], [], create_scheduler(cfg["training"]["scheduler"], lr),
                      augment_fn=make_augment_fn(LEARN_AUG), seed=5)
    batch = drawn_train_faces(32, 23)
    want = {**dict.fromkeys(_ZERO_UNLESS_LISTED, 0), "warp_affine_legacy": 30}
    with counted(want) as launches:
        losses = [float(trainer.train_step(trainer.state, batch, trainer.seed)["loss"])
                  for _ in range(30)]
    print(f"{model}: losses {[round(v, 4) for v in losses]}")
    assert launches == want
    assert all(math.isfinite(v) for v in losses)
    if model == "vit":
        return
    assert statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    with tempfile.TemporaryDirectory() as tmp:
        trainer.config["save_dir"] = tmp
        trainer.save_checkpoint(0, is_best=True)
        pred = DeepfakePredictor({"model": cfg["model"]}, PREPROCESSING_CONFIG,
                                 checkpoint_path=str(Path(tmp) / "best_model.ckpt"), device=dev)
    ev = make_eval_step(trainer.model, trainer.criterion)(batch)
    x = torch.from_numpy(batch["image"]).to(dev)
    fake, _ = pred._predict(x, torch.from_numpy(batch["landmarks"]).to(dev),
                            torch.ones(32, device=dev))
    assert (fake.float() - ev["probs"][:, 1].float()).abs().max().item() <= 1e-3
    served = pred.predict_frames(clip("640x640")[:8])
    assert served["num_faces"] >= 1 and math.isfinite(served["fake_prob"])


def test_loaders_feed_the_train_step_on_the_card(dev):
    """``HostLoader``, ``DeviceLoader`` and ``CachedDeviceLoader`` over 64
    drawn PNG faces give equal first batches, and the B4's train step
    (augmentation on) fed by each launches one warp a step."""
    from deepfake_vit_tpu_torch.data.dataset import (CachedDeviceLoader, DeviceLoader, HostLoader,
                                                     PreprocessedFaceDataset)
    from deepfake_vit_tpu_torch.ops.augment import make_augment_fn
    from deepfake_vit_tpu_torch.tools.synth_processed import write_processed
    from deepfake_vit_tpu_torch.training import TrainState, make_train_step

    cfg = copy.deepcopy(TRAINING_CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        write_processed(Path(tmp), (64, 0, 0), size=224, seed=0)
        ds = PreprocessedFaceDataset(Path(tmp) / "splits" / "train.csv", tmp, image_size=224)
        common = dict(batch_size=32, shuffle=True, drop_last=True, num_workers=4, seed=0)
        loaders = {"HostLoader": HostLoader(ds, **common),
                   "DeviceLoader": DeviceLoader(HostLoader(ds, **common), dev),
                   "CachedDeviceLoader": CachedDeviceLoader(ds, device=dev, **common)}
        first = {name: next(iter(loader)) for name, loader in loaders.items()}
        for name, batch in first.items():
            for k in ("image", "label", "landmarks", "quality_score"):
                got = batch[k].cpu().numpy() if isinstance(batch[k], torch.Tensor) else batch[k]
                want = np.asarray(first["HostLoader"][k]).astype(got.dtype)
                assert np.array_equal(got, want), (name, k)
        model, opt, crit = train_setup(cfg, torch.bfloat16, dev)
        step = make_train_step(model, crit, opt, augment_fn=make_augment_fn(LEARN_AUG))
        for name, loader in loaders.items():
            it = iter(loader)
            step(TrainState(), next(it), 0)
            with counted(["warp_affine_legacy"]) as launches:
                step(TrainState(), next(it), 0)
            it.close()
            assert launches == {"warp_affine_legacy": 1}, name


DP_BATCH, DP_ACCUMULATION = 32, (1, 2)  # global rows, DP_BATCH / 2 a rank
# Two float32 ranks against one float32 process differ by rounding alone, and
# on some batches by more than TRAIN_LIMITS: on traffic_gen's train faces
# (seed 41, 32 rows) at A = 1 the ranks lay 7.0e-3 (grads_rel) from the
# process, with an Adam update flipped (update_rel 2.0), the same with cuDNN
# deterministic; the process itself lay 1.3e-3 from float64, the ranks
# 6.7e-3 (an H100 80GB HBM3 at 700 W; seed 42: 1.0e-3 ranks vs process; the
# painter's batch, drawn_train_faces(32, 41): 9.3e-5). So the float32 ranks
# are held on the painter's batch, and the same steps in float64 on that
# traffic_gen batch, where rounding cannot hide a fault in the synced
# statistics or the accumulation. There the ranks lay from the float64
# process at most 8.8e-6 (grads_rel),
# 2.9e-11 (cos gap), 3.1e-7 (update_rel), 2.6e-7 (stats_rel), 1.2e-7
# (loss_rel) and 4.4e-7 (grad_norm_rel) over three batches at A = 1; the
# limits are about ten times those readings.
DP_FLOAT64_LIMITS = {"loss_rel": 1e-6, "grad_norm_rel": 5e-6, "grads_rel": 1e-4,
                     "grads_cos_gap": 1e-9, "update_rel": 1e-5, "stats_rel": 3e-6}


def dp_step(cfg, dtype, dev, batch, A, init, mesh=None):
    """One step of the training configuration (augmentation on, dropout and
    drop-connect at their rates, AdamW + clip 1.0) from the parameters
    ``init``: ``step_record`` and a digest of the parameters after it."""
    from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
    from deepfake_vit_tpu_torch.ops.augment import make_augment_fn
    from deepfake_vit_tpu_torch.training import (TrainState, create_optimizer, make_criterion,
                                                 make_train_step)

    model = create_model_from_config(cfg["model"], dtype=dtype)
    if dtype == torch.float64:
        model = model.double()
    model.load_state_dict(init)
    model.to(dev)
    opt = create_optimizer(model.parameters(), cfg["training"]["optimizer"], gradient_clip=1.0)
    p0 = initial(model)
    step = make_train_step(model, make_criterion(cfg["training"]["loss"], torch.ones(2)), opt,
                           accumulation_steps=A, mesh=mesh, augment_fn=make_augment_fn(LEARN_AUG))
    out = step_record(model, p0, step(TrainState(), batch, 0))
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    return out


def dp_worker(rank, port, work, cfg, device):
    """Rank ``rank`` of two on ``device`` over gloo: the float32 steps at each
    accumulation, the local-statistics control and the bf16 steps on
    ``batch.npz``, the float64 steps at each accumulation on
    ``batch64.npz``; then rank r runs the one-process references on the
    whole batches at the r-th accumulation, and rank 0 writes the gaps and
    the ranks' agreement to ``{work}/dp.json``."""
    import torch.distributed as dist

    import deepfake_vit_tpu_torch.models.layers as layers
    from deepfake_vit_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    maybe_initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    dev = torch.device(device)
    mesh = make_mesh(devices=[dev])
    init = torch.load(Path(work) / "init.pt")
    data, data64 = (dict(np.load(Path(work) / f)) for f in ("batch.npz", "batch64.npz"))
    half = len(data["label"]) // 2
    stripe, stripe64 = ({k: v[rank * half:(rank + 1) * half] for k, v in d.items()}
                        for d in (data, data64))
    lr = cfg["training"]["optimizer"]["lr"]
    control = "control: local BatchNorm statistics, A = 1"
    runs = {}
    with tf32_off():
        for A in DP_ACCUMULATION:
            runs[f"float32, A = {A}"] = dp_step(cfg, torch.float32, dev, stripe, A, init, mesh)
        saved = layers.all_reduce_sum
        layers.all_reduce_sum = lambda t, group=None: t  # BatchNorm on the rank's rows
        try:
            runs[control] = dp_step(cfg, torch.float32, dev, stripe, 1, init, mesh)
        finally:
            layers.all_reduce_sum = saved
    for A in DP_ACCUMULATION:
        runs[f"bf16, A = {A}"] = dp_step(cfg, torch.bfloat16, dev, stripe, A, init, mesh)
        runs[f"float64, A = {A}"] = dp_step(cfg, torch.float64, dev, stripe64, A, init, mesh)
    equal, losses = {}, {}
    for name, r in runs.items():
        digests = [None, None]
        dist.all_gather_object(digests, r["digest"])
        equal[name], losses[name] = digests[0] == digests[1], r["metrics"]["loss"]
    A = DP_ACCUMULATION[rank]
    with tf32_off():
        want = dp_step(cfg, torch.float32, dev, data, A, init)
    gaps = {f"float32, A = {A}": compare_steps(runs[f"float32, A = {A}"], want, lr),
            f"float64, A = {A}": compare_steps(runs[f"float64, A = {A}"],
                                               dp_step(cfg, torch.float64, dev, data64, A, init),
                                               lr)}
    if A == 1:
        gaps[control] = compare_steps(runs[control], want, lr)
    parts = [None, None]
    dist.all_gather_object(parts, gaps)
    if rank == 0:
        (Path(work) / "dp.json").write_text(json.dumps(
            {"gaps": {**parts[0], **parts[1]}, "ranks_equal": equal, "losses": losses}))
    dist.barrier()
    dist.destroy_process_group()


def test_data_parallel_ranks_on_one_card_match_one_process(dev):
    """Two ranks (spawned, gloo) sharing the card: the training
    configuration's B4 at 224² with augmentation on, a global batch of 32
    drawn faces (16 a rank), within TRAIN_LIMITS of the one-process step on
    the same rows at each accumulation in float32, and within
    DP_FLOAT64_LIMITS in float64 on traffic_gen's train faces, the ranks
    bit for bit equal; the local-statistics control breaks TRAIN_LIMITS;
    the bf16 steps finite and equal across ranks."""
    import torch.multiprocessing as mp

    cfg = copy.deepcopy(TRAINING_CONFIG)
    with tempfile.TemporaryDirectory() as work:
        model, _, _ = train_setup(cfg, torch.float32, "cpu")
        torch.save(model.state_dict(), Path(work) / "init.pt")
        np.savez(Path(work) / "batch.npz", **drawn_train_faces(DP_BATCH, 41))
        faces = traffic_gen.train_faces(DP_BATCH, (224, 224), 41, "cpu")
        np.savez(Path(work) / "batch64.npz", image=faces["image"].numpy(),
                 label=faces["label"].numpy().astype(np.int32), landmarks=faces["landmarks"].numpy())
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(dp_worker, args=(port, work, cfg, str(dev)), nprocs=2, join=True,
                           start_method="spawn")
        res = json.loads((Path(work) / "dp.json").read_text())
    print(json.dumps(res))
    assert all(res["ranks_equal"].values()), res["ranks_equal"]
    for name, gap in res["gaps"].items():
        limits = DP_FLOAT64_LIMITS if name.startswith("float64") else TRAIN_LIMITS
        within = all(gap[k] <= limits[k] for k in limits)
        assert within != name.startswith("control"), (name, gap)
    assert all(math.isfinite(v) for k, v in res["losses"].items() if k.startswith("bf16"))


def test_sharded_checkpoint_round_trips_the_train_state_on_the_card(dev):
    """The B4 train state on the card (parameters, statistics, AdamW's
    moments after a step, the step) through ``utils/orbax_io``, bit for
    bit, on its devices and in its dtypes."""
    from deepfake_vit_tpu_torch.training import TrainState, make_train_step
    from deepfake_vit_tpu_torch.utils.orbax_io import (restore_checkpoint_sharded,
                                                       save_checkpoint_sharded)

    model, opt, crit = train_setup(copy.deepcopy(TRAINING_CONFIG), torch.float32, dev)
    make_train_step(model, crit, opt)(TrainState(), drawn_train_faces(4, 43), 0)
    tree = {"model": model.state_dict(), "optimizer": opt.state_dict(), "step": 1}
    with tempfile.TemporaryDirectory() as work:
        back = restore_checkpoint_sharded(save_checkpoint_sharded(tree, Path(work) / "b4"),
                                          template=tree)

    def same(a, b):
        if isinstance(b, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in b)
        if isinstance(b, torch.Tensor):
            return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        return a == b

    assert same(back, tree)


# ---------------------------------------------------------------------------
# The CLIs and tools
# ---------------------------------------------------------------------------

CLI_PROB_TOL = 0.02  # fake_prob, card vs CPU (PREDICTOR_PROB_TOL's class)
# The preprocess_dataset CLI's aligned faces, card vs --device cpu, in grey
# levels.
CLI_FACE_TOL = 2.0


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _write_png(path, frame):
    import cv2

    cv2.imwrite(str(path), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))


@pytest.mark.parametrize("cli", ["run_pipeline", "preprocess_dataset"])
def test_cli_card_matches_cpu(dev, cli, tmp_path, monkeypatch):
    """``run_pipeline`` (the committed b0 classifier and SCRFD; 16 drawn-face
    images and a cv2-written 12-frame video; the pipeline class wrapped to
    float32 for the run) and ``preprocess_dataset`` (a drawn gen_ai tree) on
    the card against ``--device cpu``, without TF32: the same rows, labels
    and face counts, fake_prob within CLI_PROB_TOL; the same rows and
    splits, the aligned faces within CLI_FACE_TOL with fewer than 1 % more
    than one level apart."""
    import cv2
    import yaml

    import deepfake_vit_tpu_torch.e2e as e2e
    from deepfake_vit_tpu_torch import preprocess_dataset, run_pipeline
    from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path
    from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

    if cli == "run_pipeline":
        files = tmp_path / "files"
        files.mkdir()
        for i, frame in enumerate(drawn(16, (320, 480), 61)):
            _write_png(files / f"img_{i:02d}.png", frame)
        video = cv2.VideoWriter(str(files / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                                (480, 320))
        for frame in drawn(12, (320, 480), 62):
            video.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        video.release()
        classifier = default_weights_path("classifier")
        cfg = tmp_path / "b0.yaml"
        cfg.write_text(yaml.safe_dump({"model": msgpack_restore(classifier)["model_config"]}))
        argv = ["--data-dir", str(files), "--det-size", "320", "--batch-size", "16",
                "--checkpoint", classifier, "--config", str(cfg), "--workers", "1"]
        monkeypatch.setattr(e2e, "FusedPipeline", functools.partial(e2e.FusedPipeline,
                                                                    dtype=torch.float32))
        with tf32_off():
            with counted(["warp_affine_legacy"]) as launches:
                run_pipeline.main(argv + ["--output", str(tmp_path / "card.csv")])
            run_pipeline.main(argv + ["--output", str(tmp_path / "cpu.csv"), "--device", "cpu"])
        got, want = _rows(tmp_path / "card.csv"), _rows(tmp_path / "cpu.csv")
        key = lambda r: (r["filename"], r["label"], r["num_faces"])  # noqa: E731
        assert [key(g) for g in got] == [key(w) for w in want] and len(got) == 17
        assert sum(int(g["num_faces"]) for g in got) >= 16
        assert max(abs(float(g["fake_prob"]) - float(w["fake_prob"]))
                   for g, w in zip(got, want)) <= CLI_PROB_TOL
        assert launches["warp_affine_legacy"] >= 2
        return
    raw = tmp_path / "raw"
    for label, seed in (("real", 63), ("fake", 64)):
        (raw / label).mkdir(parents=True)
        for i, frame in enumerate(drawn(6, (360, 480), seed)):
            _write_png(raw / label / f"{label}_{i}.png", frame)
    cv2.imwrite(str(raw / "fake" / "blank.png"), np.full((300, 300, 3), 128, np.uint8))
    for where in ("card", "cpu"):
        pre = copy.deepcopy(PREPROCESSING_CONFIG)
        pre.update(output={"base_dir": str(tmp_path / where)}, logging={},
                   datasets={"gen_ai": {"path": str(raw), "real_folder": "real",
                                        "fake_folder": "fake", "image_extensions": [".png"]}})
        (tmp_path / f"{where}.yaml").write_text(yaml.safe_dump(pre))
        with tf32_off():
            preprocess_dataset.main(["--config", str(tmp_path / f"{where}.yaml"), "--datasets",
                                     "gen_ai"] + (["--device", "cpu"] if where == "cpu" else []))
    got = _rows(tmp_path / "card" / "preprocessing_results.csv")
    want = _rows(tmp_path / "cpu" / "preprocessing_results.csv")
    keys = ("image_id", "label", "processed", "reason", "face_path")
    assert [tuple(g[k] for k in keys) for g in got] == [tuple(w[k] for k in keys) for w in want]
    for split in ("train", "val", "test"):
        assert ([r["image_id"] for r in _rows(tmp_path / "card" / "splits" / f"{split}.csv")]
                == [r["image_id"] for r in _rows(tmp_path / "cpu" / "splits" / f"{split}.csv")])
    worst, beyond, pixels = 0, 0, 0
    for g in got:
        if g["processed"] == "True":
            a = cv2.imread(str(tmp_path / "card" / g["face_path"])).astype(np.int32)
            b = cv2.imread(str(tmp_path / "cpu" / g["face_path"])).astype(np.int32)
            d = np.abs(a - b)
            worst, beyond, pixels = max(worst, int(d.max())), beyond + int((d > 1).sum()), \
                pixels + d.size
    assert sum(g["processed"] == "True" for g in got) >= 10
    assert worst <= CLI_FACE_TOL and beyond / max(pixels, 1) < 0.01


@pytest.mark.parametrize("family", list(acceptance.FAMILIES))
def test_acceptance_bars_on_the_card(dev, family):
    """Every family's acceptance bars (``acceptance.py``) with the committed
    weights, on the card."""
    res = acceptance.run(family, dev)
    print(f"{family}: {res}")
    assert res["held"], res


def test_hog_template_fitted_on_the_card_meets_the_hog_bar(dev):
    """One ``fit_hog_template`` of 100 scenes (the CLI default is 400) at
    320² on the card, held to the HOG bar."""
    from deepfake_vit_tpu_torch.acceptance import hog_bar
    from deepfake_vit_tpu_torch.models.hog_detector import HogFaceDetector, fit_hog_template

    params = fit_hog_template(n_scenes=100, scene_size=DT_SIZE, seed=42, device=dev)
    bar = hog_bar(HogFaceDetector(input_size=(DT_SIZE, DT_SIZE), params=params, device=dev))
    assert bar["held"], bar


# profile_e2e's stages of path A at one batch and their launches.
PROFILE_STAGE_LAUNCHES = {
    "canvas": {}, "detect_320": {}, "detect_320_int8": {"int8_conv": 25},
    "align_warp_640": {"crop_frac": 1, "warp_affine_legacy": 1}, "quality": {},
    "classify_b128": {"int8_gemm": 44},
    "e2e_fused": {"int8_conv": 25, "crop_frac": 1, "warp_affine_legacy": 1, "int8_gemm": 44}}


# The child of test_profile_e2e_stages_on_the_card: profile_e2e on path A at
# B = 128, and the composed stages against forward, as one JSON line.
PROFILE_CHILD = """
import json
import numpy as np
import torch
from deepfake_vit_tpu_torch import profile_e2e

pipe = profile_e2e.headline_pipeline()
frames = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (128, 640, 640, 3),
                                                             dtype=np.uint8)).to(pipe.device)
res = profile_e2e.profile(pipe, frames, iters=5, warmup=2, sweep=True)
with torch.inference_mode():
    got = pipe._classify(profile_e2e.staged_state(pipe, frames)["state"])
want = pipe.forward(frames)
res["has_face_equal"] = bool(torch.equal(got["has_face"], want["has_face"]))
res["gap"] = {k: float((got[k].float() - want[k].float()).abs().max())
              for k in ("confidence", "bbox", "landmarks", "quality", "probs")}
print(json.dumps(res))
"""


def test_profile_e2e_stages_on_the_card(dev):
    """``profile_e2e`` on path A at B = 128, in a process of its own (late in
    a process the profiler loses the records of small elementwise kernels,
    the canvas stage's): each stage's launches, every stage with device
    time, the stages' device ms within 10 % of ``forward``'s, and the
    composed stages against ``forward`` within the int8 limits."""
    proc = subprocess.run([sys.executable, "-c", PROFILE_CHILD], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["launches"] == PROFILE_STAGE_LAUNCHES
    dms = res["device_ms"]
    assert set(dms) == set(res["host_ms"]) and min(dms.values()) > 0.0, dms
    staged = sum(dms[k] for k in ("canvas", "detect_320_int8", "align_warp_640", "quality",
                                  "classify_b128"))
    assert abs(staged - dms["e2e_fused"]) <= 0.1 * dms["e2e_fused"], dms
    assert res["has_face_equal"]
    assert all(res["gap"][k] <= INT8_LIMITS[k] for k in INT8_LIMITS), res["gap"]


def run_cli(main_fn, argv):
    """A port CLI's ``main(argv)`` in this process: (exit code, the last
    JSON object it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn([str(a) for a in argv])
    print(buf.getvalue())
    last = None
    for line in buf.getvalue().splitlines():
        if line.startswith("{"):
            with contextlib.suppress(json.JSONDecodeError):
                last = json.loads(line)
    return rc, last


@pytest.mark.parametrize("probe", ["warp_kernel", "serving", "serving_sweep", "lite_detect",
                                   "refine_timing"])
def test_probe_runs_every_mode_on_the_card(dev, probe, tmp_path):
    """The four probes at reduced batch: every mode and combo runs."""
    from deepfake_vit_tpu_torch import (probe_lite_detect, probe_refine_timing, probe_serving,
                                        probe_warp_kernel)

    if probe == "warp_kernel":
        res = probe_warp_kernel.probe(batch=128, window=160, iters=10, warmup=2)
    elif probe == "lite_detect":
        res = probe_lite_detect.probe(batch=64, iters=5)
    elif probe == "refine_timing":
        res = probe_refine_timing.probe(batch=32, iters=5)
    elif probe == "serving":
        rc, res = run_cli(probe_serving.main, ["--batch", 32, "--iters", 3])
        assert rc == 0
    else:
        out = tmp_path / "sweep.jsonl"
        rc, res = run_cli(probe_serving.main, ["--batch", 32, "--iters", 3, "--int8-static",
                                               "--sweep", "128f+d,160b-uw16+L", "--json", out])
        lines = [json.loads(x) for x in out.read_text().splitlines()]
        assert rc == 0 and len(lines) == 2 and not any("error" in x for x in lines), lines
    assert not (isinstance(res, dict) and res.get("failed")), res


@pytest.mark.parametrize("tool", ["bench_dataloader", "diag_rss"])
def test_loader_tools_on_the_card(dev, tool, tmp_path):
    """``bench_dataloader`` (the cv2 path: the chip machine has no OpenCV
    headers for the native decoder) and ``diag_rss`` for two epochs over a
    drawn processed directory."""
    from deepfake_vit_tpu_torch import bench_dataloader, diag_rss
    from deepfake_vit_tpu_torch.tools.synth_processed import write_processed

    write_processed(tmp_path, counts=(256, 32, 32), size=224, seed=3)
    if tool == "bench_dataloader":
        rc, out = run_cli(bench_dataloader.main, ["--processed-dir", tmp_path, "--batch-size", 32,
                                                  "--num-workers", 4, "--batches", 6])
        assert rc == 0 and out and out.get("python threads") is not None, out
    else:
        rc, out = run_cli(diag_rss.main, ["--processed-dir", tmp_path, "--epochs", 2,
                                          "--batch-size", 16, "--action", "clear"])
        assert rc == 0 and out and len(out["rss_mb"]) == 3, out
