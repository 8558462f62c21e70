"""The port's native decoder (``data/native_loader.py``, ``native/dataloader.cc``
built at first use) against the per-item ``cv2`` path, on the CPU.

The library links the system's OpenCV, whose version may differ from the
Python ``cv2``'s (4.6 and 5.0 where these tests were written, 4.8e-7
apart on resized images), so every image, resized or not, is held at the
JAX test's 1e-4 (``tests/test_native_loader.py``).
"""

import numpy as np
import pytest

from deepfake_vit_tpu_torch.data import native_loader
from deepfake_vit_tpu_torch.data.dataset import HostLoader, PreprocessedFaceDataset, _load_image


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    import cv2

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("imgs")
    paths = []
    for i in range(12):
        p = d / f"{i:03d}.png"
        cv2.imwrite(str(p), rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        paths.append(str(p))
    pj = d / "x.jpg"  # a JPEG of another shape: decoded, then resized
    cv2.imwrite(str(pj), rng.integers(0, 255, (48, 80, 3), dtype=np.uint8),
                [cv2.IMWRITE_JPEG_QUALITY, 95])
    paths.append(str(pj))
    return paths


def test_native_matches_cv2_path(image_files):
    dec = native_loader.NativeDecoder(num_threads=4)
    batch, failed = dec.decode_batch(image_files, image_size=64, normalize=True)
    assert batch.shape == (len(image_files), 64, 64, 3) and not failed.any()
    for i, path in enumerate(image_files):
        ref = _load_image(path, 64, normalize=True)
        np.testing.assert_allclose(batch[i], ref, rtol=0, atol=1e-4, err_msg=path)
    raw, _ = dec.decode_batch(image_files[:2], image_size=64, normalize=False)
    np.testing.assert_allclose(raw[1], _load_image(image_files[1], 64, normalize=False),
                               rtol=0, atol=1e-6)
    dec.close()


def test_native_failure_flags(image_files, tmp_path):
    dec = native_loader.NativeDecoder(num_threads=2)
    batch, failed = dec.decode_batch([image_files[0], str(tmp_path / "nope.png")], image_size=32)
    assert failed.tolist() == [False, True]
    assert batch[1].max() == 0.0 and batch[0].std() > 0  # the failed slot is zeros
    empty, none = dec.decode_batch([], image_size=32)
    assert empty.shape == (0, 32, 32, 3) and none.shape == (0,)
    dec.close()


def _split_csv(tmp_path, image_files):
    rows = ["image_id,dataset,label,processed,face_path,landmark_path,quality_score"]
    for i, p in enumerate(image_files[:6]):
        rows.append(f"i{i},d,{'fake' if i % 2 else 'real'},True,{p},,{0.5 + i / 10}")
    rows.append("missing,d,real,True,nope.png,,")
    path = tmp_path / "split.csv"
    path.write_text("\n".join(rows) + "\n")
    return path


def test_dataset_native_batches_match_per_item(image_files, tmp_path):
    """``native_threads`` routes HostLoader through ``get_batch``: the same
    batches as the per-item path, a zero image for a file that does not
    decode, NaN for an empty quality cell; quality statistics."""
    csv_path = _split_csv(tmp_path, image_files)
    per_item = PreprocessedFaceDataset(csv_path, "/", image_size=64)
    native = PreprocessedFaceDataset(csv_path, "/", image_size=64, native_threads=3)
    a = list(HostLoader(per_item, batch_size=3, shuffle=True, seed=1))
    b = list(HostLoader(native, batch_size=3, shuffle=True, seed=1))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x["image_id"] == y["image_id"]
        np.testing.assert_allclose(y["image"], x["image"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(y["label"], x["label"])
        np.testing.assert_array_equal(y["quality_score"], x["quality_score"])
    assert np.isnan(native.get_batch([6])["quality_score"][0])
    stats = native.get_quality_stats()
    assert set(stats) == {"mean", "std", "min", "max"} and np.isnan(stats["mean"])
    finite = PreprocessedFaceDataset(csv_path, "/")
    finite.rows = finite.rows[:6]
    stats = finite.get_quality_stats()
    assert (stats["min"], stats["max"]) == (0.5, np.float32(1.0))
    np.testing.assert_allclose(stats["mean"], 0.75, rtol=1e-6)


def test_failed_build_raises(monkeypatch, tmp_path, image_files):
    """An integer ``native_threads`` asks for the native decoder: a build
    that fails raises instead of falling back to cv2."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "CXX_FLAGS", ("-no-such-flag",))
    assert not native_loader.is_available()
    with pytest.raises(RuntimeError, match="building the native decoder failed"):
        PreprocessedFaceDataset(_split_csv(tmp_path, image_files), "/", native_threads=2)
