"""One short run of a cell through the benchmark's command, on the card.

Runs where a card is (``python -m pytest benchmark/tests -m gpu --noconftest``
on the chip machine, which has no JAX for the repository's root
``conftest.py``); skips elsewhere, deciding inside the test."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_one_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "b4-serve-b128",
                          "--seed", str(2**31 + 77), "--seconds", "3", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"faces_per_s", "batch_ms_p95", "setup_s"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
