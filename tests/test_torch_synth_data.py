"""The port's data modules against the JAX package's, on the CPU.

- ``data/synth_faces.py`` and ``data/domain_shift.py``: the same seeds give
  the same pixels, boxes and landmarks, bit for bit (``render_scene``,
  ``render_labeled_face``, ``write_corpus``, ``shifted_scene_batch`` under
  every shift).
- ``data/splits.py::create_data_splits`` (csv and numpy, no pandas): the
  same rows in the same order as the JAX function (pandas) in every split
  CSV, read back equal by both packages' ``PreprocessedFaceDataset``;
  ``RandomState(seed).permutation(n)`` is ``DataFrame.sample(frac=1,
  random_state=seed)``'s draw.
- ``data/interface.py``: ``FeatureExtractionInput``,
  ``preprocessing_outputs_to_batch``, the loader-batch adapter and the
  landmark maps equal the JAX interface's (maps within 1e-6).
"""

import json
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from deepfake_vit_tpu.data import domain_shift as jds
from deepfake_vit_tpu.data import interface as jif
from deepfake_vit_tpu.data import splits as jsp
from deepfake_vit_tpu.data import synth_faces as jsf
from deepfake_vit_tpu.data.dataset import PreprocessedFaceDataset as JaxDataset
from deepfake_vit_tpu_torch.data import domain_shift as tds
from deepfake_vit_tpu_torch.data import interface as tif
from deepfake_vit_tpu_torch.data import splits as tsp
from deepfake_vit_tpu_torch.data import synth_faces as tsf
from deepfake_vit_tpu_torch.data.dataset import PreprocessedFaceDataset as PortDataset


def _equal(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed,size", [(0, 320), (7, 160), (11, 96)])
def test_render_scene_bit_for_bit(seed, size):
    for _ in range(3):  # several draws from one generator
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        _equal(jsf.render_scene(rj, size=size), tsf.render_scene(rt, size=size))
        seed += 100


@pytest.mark.parametrize("fake", [False, True])
def test_render_labeled_face_bit_for_bit(fake):
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        _equal(jsf.render_labeled_face(rj, size=128, fake=fake, min_face=40, max_face=100),
               tsf.render_labeled_face(rt, size=128, fake=fake, min_face=40, max_face=100))


def test_write_corpus_bit_for_bit(tmp_path):
    import cv2

    aj = json.loads(open(jsf.write_corpus(tmp_path / "j", 3, size=96, seed=5)).read())
    at = json.loads(open(tsf.write_corpus(tmp_path / "t", 3, size=96, seed=5)).read())
    assert [(r["boxes"], r["landmarks"]) for r in aj] == [(r["boxes"], r["landmarks"]) for r in at]
    for rj, rt in zip(aj, at):
        np.testing.assert_array_equal(cv2.imread(rj["image"]), cv2.imread(rt["image"]))


@pytest.mark.parametrize("shift", [*jds.SHIFTS, "texture_background"])
def test_shifted_scene_batch_bit_for_bit(shift):
    want = jds.shifted_scene_batch(shift, 2, seed=9, size=128, min_face=40, max_face=100)
    got = tds.shifted_scene_batch(shift, 2, seed=9, size=128, min_face=40, max_face=100)
    _equal(want[0:1], got[0:1])
    _equal(want[1], got[1])
    _equal(want[2], got[2])


def test_augment_clutter_bit_for_bit():
    img, boxes, _ = jsf.render_scene(np.random.default_rng(4), size=128)
    _equal([jds.augment_clutter(img, boxes, np.random.default_rng(1))],
           [tds.augment_clutter(img, boxes, np.random.default_rng(1))])


def test_permutation_is_pandas_sample():
    df = pd.DataFrame({"v": np.arange(37)})
    for seed in (0, 42, 1234):
        drawn = df.sample(frac=1, random_state=seed)["v"].to_numpy()
        np.testing.assert_array_equal(drawn, np.random.RandomState(seed).permutation(37))


def _results(tmp_path, n=47):
    """A results CSV in the preprocessing layout, with faces and landmarks:
    two datasets, both labels, a few unprocessed rows, empty cells."""
    import cv2

    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        ds, label = ("gen_ai" if i % 3 else "ff"), ("fake" if i % 2 else "real")
        face, lm = f"faces/{i}.png", f"landmarks/{i}.npy"
        (tmp_path / "faces").mkdir(exist_ok=True)
        (tmp_path / "landmarks").mkdir(exist_ok=True)
        cv2.imwrite(str(tmp_path / face), rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
        np.save(tmp_path / lm, rng.random((5, 2)).astype(np.float32) * 16)
        rows.append({"image_id": f"img{i}", "dataset": ds, "label": label,
                     "processed": i % 11 != 5, "face_path": face,
                     "landmark_path": lm if i % 7 else "", "metadata_path": "",
                     "quality_score": round(float(rng.random()), 4) if i % 9 else ""})
    path = tmp_path / "results.csv"
    pd.DataFrame(rows).to_csv(path, index=False)
    return path, rows


def test_create_data_splits_matches_jax(tmp_path):
    path, rows = _results(tmp_path)
    want = jsp.create_data_splits(pd.read_csv(path), tmp_path / "jax")
    got_path = tsp.create_data_splits(path, tmp_path / "port")
    got_rows = tsp.create_data_splits(rows, tmp_path / "port_rows")
    assert set(want) == set(got_path) == set(got_rows) == {"train", "val", "test"}
    for name in want:
        ids = list(want[name]["image_id"])
        assert [r["image_id"] for r in got_path[name]] == ids
        assert [r["image_id"] for r in got_rows[name]] == ids
        for out in ("port", "port_rows"):
            csv_path = tmp_path / out / "splits" / f"{name}.csv"
            assert list(pd.read_csv(csv_path)["image_id"]) == ids
            for Dataset in (JaxDataset, PortDataset):
                a = Dataset(tmp_path / "jax" / "splits" / f"{name}.csv", tmp_path)
                b = Dataset(csv_path, tmp_path)
                assert len(a) == len(b) == len(ids)
                for i in range(len(a)):
                    x, y = a[i], b[i]
                    assert set(x) == set(y)
                    for k in x:
                        np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def _outputs(n=3, size=32):
    rng = np.random.default_rng(2)
    return [SimpleNamespace(aligned_face=rng.integers(0, 256, (size, size, 3), dtype=np.uint8),
                            landmarks=rng.random((5, 2)).astype(np.float32) * size if i else None,
                            quality_score=float(rng.random()), label=("fake", "real")[i % 2],
                            image_id=f"f{i}") for i in range(n)]


def test_interface_matches_jax():
    outs = _outputs()
    want = jif.collate_preprocessing_outputs(outs)
    got = tif.collate_preprocessing_outputs(outs)
    for k in ("images", "landmarks", "quality_scores", "labels"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.image_ids == want.image_ids and got.batch_metadata == want.batch_metadata
    assert got.batch_size == want.batch_size == 3
    placed = got.to_device("cpu")
    assert placed["label"].dtype == torch.int64
    np.testing.assert_array_equal(placed["image"].numpy(), want.images)

    batch = {"image": want.images, "landmarks": want.landmarks, "label": want.labels,
             "quality_score": want.quality_scores, "image_id": want.image_ids}
    a = jif.PreprocessingToFeatureInterface().dataloader_batch_to_feature_input(batch)
    b = tif.PreprocessingToFeatureInterface().dataloader_batch_to_feature_input(batch)
    for k in ("images", "landmarks", "quality_scores", "labels"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))

    lms = want.landmarks * 7.0
    m_want = np.asarray(jif.PreprocessingToFeatureInterface().create_landmark_attention_maps(
        lms, (14, 14)))
    m_got = tif.PreprocessingToFeatureInterface().create_landmark_attention_maps(lms, (14, 14))
    assert m_got.shape == m_want.shape == (3, 1, 14, 14)
    np.testing.assert_allclose(m_got, m_want, rtol=0, atol=1e-6)
