"""The plain reference against the program in float32 on the CPU, at a
tiny size (b0 and a tiny ViT at 64² faces, 128² frames, the committed
detector at 64²): the output check's numbers, on the timed path's own
outputs, lie at rounding."""

import time

import pytest
import torch

from benchmark.harness import CellFiles, run_cell
from benchmark.tests.tiny import make_root

SEED = 2**31 + 4099


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-b0-serve", "tiny-vit-serve"])
def test_reference_agrees_with_the_program(root, cell):
    r = run_cell(CellFiles(root, cell), SEED, 0.2, False, torch.device("cpu"),
                 time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"faces_per_s", "batch_ms_p95", "setup_s"}
    assert list(r)[-1] == "checks"


def test_weights_are_seeded():
    from benchmark.weights import classifier_weights

    model = {"feature_extractor": {"variant": "b0"}, "classifier": {"hidden_dims": [8]}}
    a = classifier_weights(model, 32, 5, "cpu")
    b = classifier_weights(model, 32, 5, "cpu")
    c = classifier_weights(model, 32, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_frames_are_seeded():
    from benchmark.traffic_gen import face_frames

    a = face_frames(3, (96, 96), 2**33 + 1, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (3, 96, 96, 3)
    assert torch.equal(a, face_frames(3, (96, 96), 2**33 + 1, "cpu"))
    assert not torch.equal(a, face_frames(3, (96, 96), 2**33 + 2, "cpu"))


def test_detector_weights_read_like_the_program():
    """The benchmark's own msgpack reader gives the program's reader's arrays."""
    import numpy as np
    from deepfake_vit_tpu_torch.utils.msgpack import msgpack_restore

    from benchmark.tests.tiny import DETECTOR
    from benchmark.weights import read_msgpack

    mine, theirs = read_msgpack(DETECTOR), msgpack_restore(DETECTOR)

    def flat(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from flat(v, f"{p}/{k}")
        else:
            yield p, np.asarray(t)

    a, b = dict(flat(mine)), dict(flat(theirs))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
