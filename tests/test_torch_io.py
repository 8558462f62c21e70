"""The port's weights reader and its independence from the JAX package.

- The pure-Python msgpack reader gives the same tree as
  ``flax.serialization.msgpack_restore`` on the committed detector weights.
- Neither ``deepfake_vit_tpu_torch`` nor ``chip_smoke.py`` imports ``jax``
  or anything of ``deepfake_vit_tpu`` (a scan of the import statements of
  every ``.py`` file of the package, its CLIs and trainer included).
- ``chip_smoke.py`` refuses to run without a CUDA device.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import flax.serialization
import numpy as np
import pytest

from deepfake_vit_tpu_torch.preprocessing.detector import default_weights_path
from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepfake_vit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _assert_same_tree(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("name", ["scrfd_synface", "classifier_synface"])
def test_msgpack_reader_matches_flax(name):
    path = ROOT / "deepfake_vit_tpu" / "weights" / f"{name}.msgpack"
    if name == "scrfd_synface":
        assert Path(default_weights_path("scrfd")) == path
    ref = flax.serialization.msgpack_restore(path.read_bytes())
    _assert_same_tree(msgpack_restore(path), ref)


def test_msgpack_reader_scalars_and_chunks(monkeypatch):
    tree = {"a": {"x": np.arange(10, dtype=np.float32).reshape(2, 5)},
            "s": np.float32(3.0), "i": -7, "big": 1 << 40, "t": "text", "n": None, "f": 0.25}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 8)  # force chunked arrays
    data = flax.serialization.msgpack_serialize(tree)
    _assert_same_tree(msgpack_restore(data), flax.serialization.msgpack_restore(data))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    banned = [m for m in _imports(path)
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "deepfake_vit_tpu")]
    assert not banned, f"{path.name} imports {banned}"


def test_import_scan_covers_the_entry_points():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for rel in ("train.py", "evaluate.py", "predict.py", "training/trainer.py",
                "training/train_state.py", "data/dataset.py", "ops/augment.py",
                "utils/io_utils.py", "train_detector.py", "data/synth_faces.py",
                "data/domain_shift.py", "data/splits.py", "data/interface.py",
                "data/native_loader.py", "models/mtcnn_lite.py", "models/hog_detector.py",
                "models/refine_net.py", "training/detection.py", "training/refinement.py"):
        assert f"deepfake_vit_tpu_torch/{rel}" in names, rel


def test_chip_smoke_needs_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
