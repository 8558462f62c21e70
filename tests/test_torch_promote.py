"""The port's weights override, acceptance bars and promotion gate against
the JAX package, on the CPU.

- ``default_weights_path`` honours ``DFV_WEIGHTS_<MODEL>`` as the JAX
  function does, for each of the six families: unset (the committed
  file), set to a file that exists (that file) and set to one that does
  not (None).
- The MTCNN-Lite and HOG bars of ``acceptance.py`` on the CPU hold, and
  their numbers equal the same computation on the JAX package's detectors
  over the same drawn scenes: recall and the count of clutter scenes that
  fire exactly; MTCNN-Lite's landmark error within 0.01 of the inter-eye
  distance (the two packages' float32 convolutions sum in another order).
- ``promote_weights`` accepts a copy of the committed MTCNN-Lite weights
  into a temporary directory (the bars run in a child process on the
  staged file) and refuses a candidate whose convolution weights are zero,
  leaving the destination as it was; neither writes into the shipped
  weights directory.
"""

import hashlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepfake_vit_tpu.preprocessing.detector as jdet
from deepfake_vit_tpu_torch import acceptance, promote_weights
from deepfake_vit_tpu_torch.preprocessing import detector as pdet
from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize

ROOT = Path(__file__).resolve().parents[1]
SHIPPED = ROOT / "deepfake_vit_tpu" / "weights"
FAMILIES = ("scrfd", "mtcnn", "hog", "lite", "refine", "classifier")


@pytest.mark.parametrize("model", FAMILIES)
def test_default_weights_path_matches_jax(model, tmp_path, monkeypatch):
    var = f"DFV_WEIGHTS_{model.upper()}"
    monkeypatch.delenv(var, raising=False)
    assert pdet.default_weights_path(model) == jdet.default_weights_path(model)
    assert Path(pdet.default_weights_path(model)) == pdet.DEFAULT_WEIGHTS_BY_MODEL[model]
    staged = tmp_path / f"{model}.msgpack"
    staged.write_bytes(b"staged")
    monkeypatch.setenv(var, str(staged))
    assert pdet.default_weights_path(model) == jdet.default_weights_path(model) == str(staged)
    monkeypatch.setenv(var, str(tmp_path / "missing.msgpack"))
    assert pdet.default_weights_path(model) is None
    assert jdet.default_weights_path(model) is None


def _zeros_like_init(init, *args):
    """Zeros of the variables ``init(*args)`` would give (only their shapes
    are traced: flax's eager init compiles many small programs)."""
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  jax.eval_shape(init, *args))


class _ShapedInit:
    """A flax module whose ``init`` gives zeros of its variables' shapes;
    the JAX ``FaceDetector`` then replaces every leaf with the committed
    weights."""

    def __init__(self, module):
        self._module = module

    def init(self, *args, **kwargs):
        return _zeros_like_init(lambda *a: self._module.init(*a, **kwargs), *args)

    def __getattr__(self, name):
        return getattr(self._module, name)


def test_mtcnn_bar_matches_jax(monkeypatch):
    port = acceptance.mtcnn("cpu")
    assert port["held"], port
    build = jdet.build_detection_net
    monkeypatch.setattr(jdet, "build_detection_net", lambda *a, **k: _ShapedInit(build(*a, **k)))
    det = jdet.create_face_detector({"model": "mtcnn", "confidence_threshold": 0.3,
                                     "scrfd": {"input_size": [160, 160]}})
    from deepfake_vit_tpu.data.synth_faces import render_scene

    rng = np.random.default_rng(acceptance.HELDOUT_SEED + 7)
    scenes = []
    while len(scenes) < 24:
        img, boxes, kps = render_scene(rng, size=160, max_faces=1, min_face=36, max_face=110,
                                       p_empty=0.0)
        if len(boxes):
            scenes.append((img, boxes, kps))
    recall, lm_err, _ = acceptance.best_faces(
        det.detect_batch_raw(jnp.asarray(np.stack([s[0] for s in scenes]))), scenes)
    assert port["recall"] == recall
    assert abs(port["landmark_ied"] - lm_err) < 0.01, (port, lm_err)


def test_hog_bar_matches_jax():
    port = acceptance.hog("cpu")
    assert port["held"], port
    from deepfake_vit_tpu.data.synth_faces import render_scene

    det = jdet.create_face_detector({"model": "hog", "scrfd": {"input_size": [320, 320]},
                                     "confidence_threshold": 0.5, "upsample": 1})
    scenes = acceptance.heldout_scenes(acceptance.HELDOUT_SEED, 32, 320, 48, 180)
    found = det.batch_detect([s[0] for s in scenes])
    recall = sum(r is not None and acceptance._iou(r["bbox"], s[1][0]) > 0.5
                 for r, s in zip(found, scenes)) / len(scenes)
    rng = np.random.default_rng(acceptance.HELDOUT_SEED + 1)
    clutter = [render_scene(rng, size=320, p_empty=1.0)[0] for _ in range(30)]
    # Padded to the scenes' batch of 32 (one JAX compile): each frame's
    # detection is its own, so the first 30 results are the clutter's.
    fired = sum(r is not None for r in det.batch_detect(clutter + clutter[:2])[:30])
    assert (port["recall"], port["clutter_fired"]) == (recall, fired)


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _shipped_state():
    return {p.name: _digest(p) for p in sorted(SHIPPED.glob("*.msgpack"))}


def test_promote_accepts_into_a_temporary_directory(tmp_path):
    before = _shipped_state()
    staged = tmp_path / "staging" / "mtcnn.msgpack"
    staged.parent.mkdir()
    shutil.copyfile(pdet.DEFAULT_WEIGHTS_BY_MODEL["mtcnn"], staged)
    dest = tmp_path / "shipped"
    rc = promote_weights.main([str(staged), "--model", "mtcnn", "--device", "cpu"], dest_dir=dest)
    assert rc == 0
    out = dest / "mtcnn_lite_synface.msgpack"
    assert _digest(out) == _digest(staged)
    assert staged.exists()  # a copy: the staged file stays
    assert sorted(p.name for p in dest.iterdir()) == [out.name]  # no temporary left
    assert _shipped_state() == before


def _zero_convs(tree):
    if isinstance(tree, dict):
        return {k: (np.zeros_like(v) if k == "kernel" else _zero_convs(v)) for k, v in tree.items()}
    return tree


def test_promote_refuses_a_broken_candidate(tmp_path):
    before = _shipped_state()
    staged = tmp_path / "broken.msgpack"
    tree = msgpack_restore(pdet.DEFAULT_WEIGHTS_BY_MODEL["mtcnn"])
    staged.write_bytes(msgpack_serialize(_zero_convs(tree)))
    dest = tmp_path / "shipped"
    dest.mkdir()
    kept = dest / "mtcnn_lite_synface.msgpack"
    kept.write_bytes(b"the file already shipped")
    rc = promote_weights.main([str(staged), "--model", "mtcnn", "--device", "cpu"], dest_dir=dest)
    assert rc == 1
    assert kept.read_bytes() == b"the file already shipped"
    assert sorted(p.name for p in dest.iterdir()) == [kept.name]
    assert staged.exists()
    assert _shipped_state() == before


def test_acceptance_reads_the_staged_candidate(tmp_path, monkeypatch):
    """The bars go through the override: a broken candidate under
    ``DFV_WEIGHTS_MTCNN`` fails them in this process too."""
    staged = tmp_path / "broken.msgpack"
    staged.write_bytes(msgpack_serialize(_zero_convs(
        msgpack_restore(pdet.DEFAULT_WEIGHTS_BY_MODEL["mtcnn"]))))
    monkeypatch.setenv("DFV_WEIGHTS_MTCNN", str(staged))
    res = acceptance.run("mtcnn", "cpu")
    assert res["weights"] == str(staged)
    assert not res["held"], res
