"""The port's probes, fidelity table, per-stage profile and host tools
against the JAX package's scripts, on the CPU.

- ``parse_sweep_tokens`` gives the JAX script's tuples for every token
  form and refuses the same bad tokens with the same message.
- ``quad_span``, ``build_corpus`` and ``BINS`` equal the JAX fidelity
  script's (the same drawn scenes and landmarks, bit for bit).
- ``measure_crop_fidelity`` with one window (128), both geometries and
  legacy taps on 6 scenes: every bin's RMSE within 0.01 grey levels of
  the JAX package's windowed warp in Pallas interpret mode, compiled
  without XLA's excess precision (the TPU kernels and the port round the
  bf16 intermediates; XLA's CPU compiler otherwise keeps them in float32,
  and the JAX script as written reads 0.29 where the kernels' arithmetic
  gives 0.34 in the <130 px bin). The two packages' Umeyama fits differ
  by about 4e-4, which moves the RMSE by about 2e-4.
- ``profile_e2e``'s stages, composed, give ``forward``'s outputs bit for
  bit on a b0 headline pipeline (float32, 2 frames), and every stage and
  the launches of each are reported.
- ``probe_warp_kernel`` runs every mode on the CPU, and a mode that raises
  is recorded while the others run and the CLI exits 1.
- ``setup_project`` makes the JAX script's tree.
- Every new entry point raises without a card unless ``--device cpu``.
"""

import copy
import importlib
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deepfake_vit_tpu_torch import measure_crop_fidelity as mcf
from deepfake_vit_tpu_torch import probe_serving, probe_warp_kernel, profile_e2e, setup_project

ROOT = Path(__file__).resolve().parents[1]


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP_TOKENS = ["160b", "128f", "128f-uw16", "128f-int8+d", "160b+L", "128f/o192",
                "128f@512", "96f-uw+d/o160@64", " 160b , 128f-legacy ", "64b-uw16+L@8"]
BAD_TOKENS = ["f", "128", "128x", "abcf", "128f@x", "128f/ox", "128f@", "+d", "128f,,160b"]


@pytest.mark.parametrize("token", SWEEP_TOKENS)
def test_parse_sweep_tokens_matches_jax(token):
    assert probe_serving.parse_sweep_tokens(token) == \
        _script("probe_serving").parse_sweep_tokens(token)


@pytest.mark.parametrize("token", BAD_TOKENS)
def test_parse_sweep_tokens_refuses_as_jax(token):
    with pytest.raises(SystemExit) as port:
        probe_serving.parse_sweep_tokens(token)
    with pytest.raises(SystemExit) as ref:
        _script("probe_serving").parse_sweep_tokens(token)
    assert str(port.value) == str(ref.value)


def test_corpus_and_quad_span_match_jax():
    ref = _script("measure_crop_fidelity")
    assert (mcf.BINS, mcf.BIN_LABELS) == (ref.BINS, ref.BIN_LABELS)
    imgs, kps = mcf.build_corpus(np.random.default_rng(7), 6, 320)
    imgs_j, kps_j = ref.build_corpus(np.random.default_rng(7), 6, 320)
    np.testing.assert_array_equal(imgs, imgs_j)
    np.testing.assert_array_equal(kps, kps_j)
    A = np.random.default_rng(8).normal(0, 1, (5, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(mcf.quad_span(A, (224, 224)), ref.quad_span(A, (224, 224)))


def test_crop_fidelity_matches_jax_interpret():
    from deepfake_vit_tpu.ops.umeyama import invert_affine, umeyama
    from deepfake_vit_tpu.ops.warp import warp_affine, warp_affine_windowed
    from deepfake_vit_tpu.preprocessing.aligner import FaceAligner

    ref = _script("measure_crop_fidelity")
    images, kps = ref.build_corpus(np.random.default_rng(20260818), 6, 640)
    port = mcf.fidelity(images, kps, mcf.configurations([128], ["block", "frac"], ["legacy"]),
                        device="cpu")
    n = len(images)
    tf = umeyama(jnp.asarray(kps), jnp.broadcast_to(jnp.asarray(
        FaceAligner(output_size=(224, 224)).reference), (n, 5, 2)))
    spans = np.asarray(ref.quad_span(np.asarray(invert_affine(tf)), (224, 224)))
    np.testing.assert_allclose(port["spans"], spans, atol=0.05)
    bin_idx = np.digitize(spans, [b[0] for b in ref.BINS[1:]])
    assert port["bin_counts"] == {ref.BIN_LABELS[i]: int((bin_idx == i).sum()) for i in range(3)}
    exact = np.asarray(warp_affine(jnp.asarray(images), tf, (224, 224)))
    for geom in ("block", "frac"):
        def run(imgs, t, geom=geom):
            return warp_affine_windowed(imgs, t, (224, 224), window=128,
                                        fractional=geom == "frac", use_pallas=True,
                                        tap_construction="legacy")

        with pltpu.force_tpu_interpret_mode():
            compiled = jax.jit(run).lower(jnp.asarray(images), tf).compile(
                compiler_options={"xla_allow_excess_precision": False})
            out = jax.device_get(compiled(jnp.asarray(images), tf))
        err2 = ((np.asarray(out) - exact) ** 2).reshape(n, -1).mean(axis=1)
        want = {ref.BIN_LABELS[i]: float(np.sqrt(err2[bin_idx == i].mean())) for i in range(3)}
        got = port["results"][f"w128-{geom}-legacy"]
        for label, v in want.items():
            assert abs(got[label] - v) < 0.01, (geom, label, got[label], v)


@pytest.fixture(scope="module")
def b0_headline():
    from deepfake_vit_tpu_torch.configs import MODEL_CONFIG

    cfg = copy.deepcopy(MODEL_CONFIG)
    cfg["model"]["feature_extractor"]["variant"] = "b0"
    return profile_e2e.headline_pipeline("cpu", cfg, dtype=torch.float32)


def test_profile_stages_compose_to_the_graph(b0_headline):
    pipe = b0_headline
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 640, 640, 3),
                                                                dtype=np.uint8))
    state = profile_e2e.staged_state(pipe, frames)["state"]
    with torch.inference_mode():
        got = pipe._classify(state)
    want = pipe.forward(frames)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    res = profile_e2e.profile(pipe, frames, iters=1, warmup=0)
    assert set(res["host_ms"]) == {"canvas", "detect_320", "detect_320_int8", "align_warp_640",
                                   "quality", "classify_b2", "e2e_fused"}
    assert all(v > 0 for v in res["host_ms"].values())
    assert "device_ms" not in res  # no device time on the CPU
    assert set(res["launches"]) == set(res["host_ms"])


def test_probe_warp_kernel_records_a_failure(monkeypatch, capsys):
    res = probe_warp_kernel.probe(batch=2, window=128, iters=1, warmup=0, device="cpu")
    assert res["failed"] == [] and len(res["results"]) == 8
    from deepfake_vit_tpu_torch.ops import warp_kernel as wk

    def broken(*a, **k):
        raise RuntimeError("broken on purpose")

    monkeypatch.setitem(wk.WARP_KERNELS, "uw16", broken)
    rc = probe_warp_kernel.main(["--batch", "2", "--window", "128", "--iters", "1",
                                 "--warmup", "0", "--skip-crop", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "warp_affine b2 w128 uw16: FAILED (RuntimeError: broken on purpose)" in out
    assert "warp_affine b2 w128 int8:" in out and "int8: FAILED" not in out


def test_setup_project_matches_jax(tmp_path, monkeypatch):
    setup_project.main(["--root", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["setup_project", "--root", str(tmp_path / "jax")])
    _script("setup_project").main()

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*"))

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert ((tmp_path / "port" / ".gitignore").read_text()
            == (tmp_path / "jax" / ".gitignore").read_text())


NEEDS_A_CARD = {
    "acceptance": ["--model", "mtcnn"],
    "profile_e2e": ["2"],
    "probe_serving": ["--batch", "2"],
    "probe_warp_kernel": ["--batch", "2"],
    "probe_lite_detect": ["2"],
    "probe_refine_timing": ["--batch", "2"],
    "measure_crop_fidelity": ["--scenes", "3", "--windows", "128"],
    "bench_dataloader": ["--processed-dir", "."],
    "diag_rss": ["--processed-dir", "."],
    "experiment_attention_ablation": ["--workdir", "{tmp}"],
    "experiment_pipeline_ab": ["--workdir", "{tmp}", "--arm", "a", "face_size=64", "--arm", "b",
                               "face_size=96"],
    "promote_weights": ["{weights}", "--model", "mtcnn"],
}


@pytest.mark.parametrize("module", sorted(NEEDS_A_CARD))
def test_entry_points_need_a_card(module, tmp_path):
    from deepfake_vit_tpu_torch.preprocessing.detector import DEFAULT_WEIGHTS_BY_MODEL

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")

    argv = [a.format(tmp=tmp_path / "ws", weights=DEFAULT_WEIGHTS_BY_MODEL["mtcnn"])
            for a in NEEDS_A_CARD[module]]
    main = importlib.import_module(f"deepfake_vit_tpu_torch.{module}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not (tmp_path / "ws" / "raw").exists()  # raised before any work
