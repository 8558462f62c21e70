"""The port's inference entry point (``inference.py``, ``predict.py``) vs the
JAX package's, on the CPU.

- ``DeepfakePredictor.from_packaged`` with the committed packaged
  classifier (b0, 224² faces) and the committed SCRFD weights against the
  JAX ``from_packaged`` on a 3-frame clip of rendered faces at the
  detection canvas's size: ``num_faces`` identical, ``fake_prob`` and the
  frame probabilities within 0.02 (``tests/test_torch_e2e.py``'s bound:
  the two bf16-tap warps differ by one tap step at a few pixels), labels
  equal. The JAX aligner runs its Pallas warp in interpret mode, the
  path it takes on the TPU (off the TPU it runs the exact float32 warp,
  which the port's aligner is held to in ``tests/test_torch_preprocessing.py``).
  The JAX constructors' flax ``init`` runs under ``jax.jit`` to keep the
  test short: the same function, whose values the committed weights
  replace.
- A clip without faces is real; padded slots stay out of the mean; a
  checkpoint written by the JAX ``save_checkpoint`` (with an optax state)
  loads; the CLI writes ``submission.csv`` with a row per file and label 0
  for a file that does not decode.
"""

import csv

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import deepfake_vit_tpu.inference as jinference
import deepfake_vit_tpu.preprocessing.aligner as jaligner
import deepfake_vit_tpu.preprocessing.detector as jdetector
from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu.ops.pallas.warp_kernel import warp_affine_pallas
from deepfake_vit_tpu.utils.io_utils import save_checkpoint
from deepfake_vit_tpu_torch import predict
from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG
from deepfake_vit_tpu_torch.inference import DeepfakePredictor
from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path
from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

torch.set_num_threads(1)

CANVAS = 192
PACKAGED = default_weights_path("classifier")
PRE = {**PREPROCESSING_CONFIG,
       "detection": {**PREPROCESSING_CONFIG["detection"],
                     "scrfd": {"input_size": [CANVAS, CANVAS], "max_detections": 16}}}
MAX_BATCH = 4


class _JitInit:
    """A flax module whose ``init`` runs jitted."""

    def __init__(self, module):
        self._module, self.init = module, jax.jit(module.init)

    def __getattr__(self, name):
        return getattr(self._module, name)


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(21)
    return [render_scene(rng, size=CANVAS, max_faces=1, p_empty=0.0, min_face=60,
                         max_face=110)[0] for _ in range(3)]


@pytest.fixture(scope="module")
def jax_predictor():
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jinference, "create_model_from_config"),
                          (jdetector, "build_detection_net")):
            orig = getattr(mod, name)
            mp.setattr(mod, name, lambda *a, _f=orig, **k: _JitInit(_f(*a, **k)))
        mp.setattr(jaligner, "warp_affine_auto", lambda im, m, out, inverse=False, **k:
                   warp_affine_pallas(im, m, out, inverse=inverse))
        pred = jinference.DeepfakePredictor.from_packaged(PACKAGED, PRE, max_batch=MAX_BATCH,
                                                          dtype=jnp.float32)
        yield pred


@pytest.fixture(scope="module")
def predictor():
    return DeepfakePredictor.from_packaged(PACKAGED, PRE, max_batch=MAX_BATCH,
                                           dtype=torch.float32, device="cpu")


def test_from_packaged_matches_jax(jax_predictor, predictor, clip):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        ref = jax_predictor.predict_frames(clip)
    got = predictor.predict_frames(clip)
    assert ref["num_faces"] == got["num_faces"] == 3
    assert abs(got["fake_prob"] - ref["fake_prob"]) <= 0.02
    np.testing.assert_allclose(got["frame_probs"], ref["frame_probs"], atol=0.02)
    if abs(ref["fake_prob"] - predictor.threshold) > 0.02:
        assert got["label"] == ref["label"]
    assert predictor.aligner.output_size == (224, 224)
    assert predictor.aligner.warp_window is None  # whole frames, as the JAX predictor aligns
    with pytest.raises(ValueError, match="packaged classifier"):
        DeepfakePredictor.from_packaged(default_weights_path("scrfd"), PRE, device="cpu")


def test_no_face_padding_and_preprocess_frame(predictor, clip):
    blank = np.full((CANVAS, CANVAS, 3), 128, np.uint8)
    assert predictor.predict_frames([blank, blank]) == {
        "label": 0, "fake_prob": 0.0, "frame_probs": [], "num_faces": 0}
    # Frames without a face stay out of the mean; three faces pad to four.
    out = predictor.predict_frames([clip[0], blank, clip[1], clip[2]])
    assert out["num_faces"] == 3 and len(out["frame_probs"]) == 3
    assert out["fake_prob"] == pytest.approx(np.mean(out["frame_probs"]), abs=1e-6)
    assert out["label"] == int(out["fake_prob"] >= predictor.threshold)
    single = predictor.predict_image(clip[0])
    assert single["num_faces"] == 1 and single["fake_prob"] == pytest.approx(
        single["frame_probs"][0], abs=1e-6)
    inp = predictor.preprocess_frame(clip[0])
    assert inp["image"].shape == (224, 224, 3) and inp["landmarks"].shape == (5, 2)
    assert predictor.preprocess_frame(blank) is None


def test_jax_checkpoint_loads(predictor, clip, tmp_path):
    packaged = msgpack_restore(PACKAGED)
    params = jax.tree_util.tree_map(jnp.asarray, packaged["params"])
    state = {"epoch": 3, "params": params, "batch_stats": packaged["batch_stats"],
             "opt_state": optax.adamw(1e-4).init(params), "metrics": {"val_auc": 0.5}}
    path = save_checkpoint(state, tmp_path)
    pre = {**PRE, "alignment": {**PRE["alignment"], "output_size": [224, 224]}}
    loaded = DeepfakePredictor({"model": packaged["model_config"]}, pre,
                               checkpoint_path=str(path), max_batch=MAX_BATCH,
                               dtype=torch.float32, device="cpu")
    for a, b in zip(loaded.model.state_dict().values(), predictor.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert loaded.predict_frames(clip) == predictor.predict_frames(clip)


def test_cli_writes_submission(predictor, clip, tmp_path):
    data = tmp_path / "files"
    data.mkdir()
    for i, frame in enumerate(clip[:2]):
        cv2.imwrite(str(data / f"face_{i}.png"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    np.save(data / "clip.npy", np.stack(clip))  # frames saved with numpy: no decoder
    (data / "corrupt.png").write_text("not media")
    (data / "notes.txt").write_text("not media either")
    cfg = tmp_path / "pre.yaml"
    cfg.write_text(yaml.safe_dump(PRE))
    out = tmp_path / "submission.csv"
    assert predict.main(["--data-dir", str(data), "--output", str(out), "--device", "cpu",
                         "--preprocessing-config", str(cfg)]) == 0
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["filename", "label"]
    labels = dict(rows[1:])
    assert sorted(labels) == ["clip.npy", "corrupt.png", "face_0.png", "face_1.png", "notes.txt"]
    assert labels["corrupt.png"] == "0" and labels["notes.txt"] == "0"
    # The CLI's default predictor is the packaged one, in bf16 on the device.
    for name, frames in [("face_0.png", clip[:1]), ("face_1.png", clip[1:2]), ("clip.npy", clip)]:
        ref = predictor.predict_frames(frames)
        if abs(ref["fake_prob"] - predictor.threshold) > 0.02:
            assert labels[name] == str(ref["label"])
