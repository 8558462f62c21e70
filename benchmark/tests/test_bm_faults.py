"""The output check fails every control and every planted fault: a run's
timed path broken underneath, the rest of the run as it is (the look for
a card skipped), ``correct`` comes out false.

The tiny cells run in float32 on the CPU. The fp8 reference in the
program's place is held to the limits of the card's serving cells, which
allow bf16; the program's own int8 path and the faults to the tiny cells'
float32 limits."""

import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import faults
from benchmark.harness import CellFiles, run_cell
from benchmark.tests.tiny import make_root

LIMITS = Path(__file__).resolve().parents[1] / "limits"
SEED = 2**31 + 8191
CARD_CELLS = {"tiny-b0-serve": "b4-serve-b128", "tiny-vit-serve": "vit-serve-b128"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, factory, limits=None):
    files = CellFiles(root, cell)
    if limits is not None:
        files.limits = limits
    return run_cell(files, SEED, 0.1, False, torch.device("cpu"), time.perf_counter(),
                    make_cell=factory)


@pytest.mark.parametrize("cell", sorted(CARD_CELLS))
def test_fp8_control_fails(root, cell):
    limits = json.loads((LIMITS / f"{CARD_CELLS[cell]}.json").read_text())
    r = run(root, cell, faults.controls(CellFiles(root, cell))["fp8_reference"], limits)
    assert not r["correct"], r["checks"]


def test_lower_precision_control_fails(root):
    """The configuration's lower-precision options reach the program."""
    control = faults.controls(CellFiles(root, "tiny-b0-serve"))["lower_precision"]
    r = run(root, "tiny-b0-serve", control)
    assert not r["correct"], r["checks"]
    assert r["checks"]["features_rel"]["value"] > r["checks"]["features_rel"]["limit"]


def test_vit_has_no_lower_precision_control(root):
    assert set(faults.controls(CellFiles(root, "tiny-vit-serve"))) == {"fp8_reference"}


@pytest.mark.parametrize("fault", sorted(faults.SERVE_FAULTS))
@pytest.mark.parametrize("cell", ["tiny-b0-serve", "tiny-vit-serve"])
def test_serve_fault_fails(root, cell, fault):
    r = run(root, cell, faults.SERVE_FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_warp_shift_fails_the_aligned_faces(root):
    """The aligned landmarks come from the transform, not the warp: a shift
    of the warp's source shows in the faces alone."""
    r = run(root, "tiny-b0-serve", faults.SERVE_FAULTS["warp_shift"])
    assert r["checks"]["face_rmse"]["value"] > r["checks"]["face_rmse"]["limit"], r["checks"]


def test_sound_run_passes(root):
    assert run(root, "tiny-b0-serve", None)["correct"]
