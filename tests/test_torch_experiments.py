"""The port's end-task experiments and their aggregation against the JAX
package's scripts, on the CPU.

- ``_paired_ci95`` and ``aggregate_ablation.pool`` equal the JAX scripts'
  (float for float) on the same deltas and summaries; ``pool`` pools a
  summary the JAX ablation script wrote together with one of the port's.
- ``Arm`` and ``_set_dotted`` parse every override form (``pre:``,
  ``model:``, ``face_size=``) as the JAX script does, and refuse the same
  bad tokens.
- Pairing by seed: both experiments are driven with a runner that writes
  each run's ``eval_test.json`` from a table in which one seed's AUC of
  one arm is missing. The JAX scripts zip the two arms' filtered lists,
  which pairs seed 3 of one arm with seed 2 of the other; the port pairs
  each seed's two metrics and skips the seed with the gap.
- Both experiments end to end at the smallest size (b0, 64² faces, one
  epoch, two seeds, 8 drawn faces a class at 160²), their runner calling
  the port CLIs' ``main(argv)`` in this process on the CPU: the summaries
  carry the JAX scripts' keys, finite AUCs for both seeds of both arms,
  and ``aggregate_ablation`` pools them.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from deepfake_vit_tpu_torch import aggregate_ablation, experiment_attention_ablation as ea
from deepfake_vit_tpu_torch import experiment_pipeline_ab as ab

ROOT = Path(__file__).resolve().parents[1]


def _script(name: str):
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return module


@pytest.mark.parametrize("deltas", [[0.1], [0.02, -0.01], [0.03, 0.01, -0.02, 0.05, 0.0],
                                    list(np.random.default_rng(3).normal(0.01, 0.02, 40))])
def test_paired_ci95_matches_jax(deltas):
    assert ea._paired_ci95(deltas) == _script("experiment_attention_ablation")._paired_ci95(deltas)


def _summary(path, seeds, att, abl, keys=("auc_attention", "auc_ablation")):
    deltas = [a - b for a, b in zip(att, abl)]
    path.write_text(json.dumps({"train_seeds": seeds, "delta_auc_per_seed": deltas,
                                keys[0]: {"per_seed": att}, keys[1]: {"per_seed": abl}}))
    return path


def test_pool_matches_jax(tmp_path):
    files = [_summary(tmp_path / "a.json", [1, 2, 3], [0.7, 0.8, 0.75], [0.65, 0.82, 0.7]),
             _summary(tmp_path / "b.json", [4, 5], [0.9, 0.6], [0.8, 0.61],
                      keys=("auc_treat", "auc_control"))]
    assert aggregate_ablation.pool(files) == _script("aggregate_ablation").pool(files)
    with pytest.raises(SystemExit):
        aggregate_ablation.pool([files[0], files[0]])


ARM_TOKENS = [
    ("w96", ["pre:alignment.warp_window=96"]),
    ("f192", ["face_size=192"]),
    ("mix", ["pre:detection.confidence_threshold=0.4", "model:training.optimizer.lr=1e-3",
             "model:model.feature_extractor.attention_config=null", "pre:a.b.c=[1, 2]"]),
    ("flag", ["model:data.cache=none", "model:model.feature_extractor.use_attention=false"]),
]


@pytest.mark.parametrize("name,tokens", ARM_TOKENS, ids=[a for a, _ in ARM_TOKENS])
def test_arm_and_set_dotted_match_jax(name, tokens):
    jax_ab = _script("experiment_pipeline_ab")
    port, ref = ab.Arm(name, tokens), jax_ab.Arm(name, tokens)
    assert (port.pre, port.model, port.pre_key) == (ref.pre, ref.model, ref.pre_key)
    cfg_p, cfg_j = {"a": {"x": 1}}, {"a": {"x": 1}}
    for k, v in {**port.pre, **port.model}.items():
        ab._set_dotted(cfg_p, k, v)
        jax_ab._set_dotted(cfg_j, k, v)
    assert cfg_p == cfg_j


@pytest.mark.parametrize("tokens", [["novalue"], ["other:x=1"]])
def test_arm_refuses_bad_tokens_as_jax(tokens):
    jax_ab = _script("experiment_pipeline_ab")
    with pytest.raises(SystemExit) as port:
        ab.Arm("bad", tokens)
    with pytest.raises(SystemExit) as ref:
        jax_ab.Arm("bad", tokens)
    assert str(port.value) == str(ref.value)


# AUC per (arm, seed mod 10); one arm lacks seed 2's.
GAPPED = {"first": {1: 0.70, 2: None, 3: 0.90}, "second": {1: 0.60, 2: 0.65, 3: 0.50}}


def _tag_of(out_dir) -> tuple:
    arm, seed = Path(str(out_dir)).name[len("eval_"):].rsplit("_s", 1)
    return arm, int(seed)


def _write_eval(out_dir, arms):
    arm, seed = _tag_of(out_dir)
    auc = GAPPED[arms[arm]][seed % 10]
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    (Path(out_dir) / "eval_test.json").write_text(json.dumps(
        [{"roc_auc": auc, "accuracy": 0.5 if auc is None else auc}]))


def _fake_runner(arms):
    """A runner for either package: writes each evaluate call's metrics."""
    def run(cmd_or_module, args=None, log_path=None):
        argv = [str(a) for a in (cmd_or_module if args is None else args)]
        if "--output-dir" in argv:
            _write_eval(argv[argv.index("--output-dir") + 1], arms)
    return run


def test_ablation_pairs_by_seed_where_the_jax_zip_does_not(tmp_path, monkeypatch):
    arms = {"attention": "first", "ablation": "second"}
    argv = ["--workdir", None, "--train-seeds", "1,2,3", "--skip-render", "--skip-preprocess"]
    jax_script = _script("experiment_attention_ablation")
    monkeypatch.setattr(jax_script, "run", _fake_runner(arms))
    argv[1] = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["x", *argv])
    jax_script.main()
    ref = json.loads((tmp_path / "jax" / "summary.json").read_text())
    argv[1:4] = [str(tmp_path / "port"), "--train-seeds", "11,12,13"]
    assert ea.main([*argv, "--device", "cpu"], runner=_fake_runner(arms)) == 0
    port = json.loads((tmp_path / "port" / "summary.json").read_text())
    # The JAX zip pairs seed 3's attention AUC with seed 2's ablation AUC.
    assert ref["delta_auc_per_seed"] == pytest.approx([0.70 - 0.60, 0.90 - 0.65])
    assert port["delta_auc_per_seed"] == pytest.approx([0.70 - 0.60, 0.90 - 0.50])
    assert port["delta_seeds"] == [11, 13]
    for key in ("auc_attention", "auc_ablation", "acc_attention", "acc_ablation"):
        assert port[key] == pytest.approx(ref[key])
    assert set(ref) <= set(port)
    # A JAX summary and a port one pool alike in both packages' aggregators.
    files = [tmp_path / "jax" / "summary.json", tmp_path / "port" / "summary.json"]
    pooled = aggregate_ablation.pool(files)
    assert pooled == _script("aggregate_ablation").pool(files)
    assert pooled["n_pairs"] == 4 and pooled["train_seeds"] == [1, 2, 3, 11, 12, 13]


def test_pipeline_ab_pairs_by_seed_where_the_jax_zip_does_not(tmp_path, monkeypatch):
    arms = {"ctl": "second", "trt": "first"}
    argv = ["--workdir", None, "--arm", "ctl", "model:seed=0", "--arm", "trt", "model:seed=1",
            "--train-seeds", "1,2,3", "--skip-render"]
    for name in ("jax", "port"):  # both find their processed splits and skip preprocessing
        (tmp_path / name / "processed_ctl" / "splits").mkdir(parents=True)
        (tmp_path / name / "processed_ctl" / "splits" / "train.csv").write_text("")
    jax_script = _script("experiment_pipeline_ab")
    monkeypatch.setattr(jax_script, "run", _fake_runner(arms))
    argv[1] = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["x", *argv])
    jax_script.main()
    ref = json.loads((tmp_path / "jax" / "summary.json").read_text())
    argv[1] = str(tmp_path / "port")
    assert ab.main([*argv, "--device", "cpu"], runner=_fake_runner(arms)) == 0
    port = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert ref["delta_auc_per_seed"] == pytest.approx([0.70 - 0.60, 0.90 - 0.65])
    assert port["delta_auc_per_seed"] == pytest.approx([0.70 - 0.60, 0.90 - 0.50])
    assert port["delta_seeds"] == [1, 3]
    for key in ("auc_control", "auc_treat", "acc_control", "acc_treat", "train_seeds",
                "overrides", "control", "treat"):
        assert port[key] == pytest.approx(ref[key]) if key.startswith(("auc", "acc")) \
            else port[key] == ref[key]
    assert set(ref) <= set(port)


SMALL = ["--n-per-class", "8", "--size", "160", "--epochs", "1", "--batch-size", "4",
         "--train-seeds", "42,43", "--face-size", "64", "--device", "cpu"]


def _finite_pairs(summary, arms):
    for arm in arms:
        assert len(summary[arm]["per_seed"]) == 2
        assert all(0.0 <= v <= 1.0 for v in summary[arm]["per_seed"])
    assert summary["train_seeds"] == [42, 43] and summary["delta_seeds"] == [42, 43]


def test_experiments_end_to_end_smallest(tmp_path):
    """Both experiments at the smallest size through the port's CLIs, in
    this process; the second reuses the first's rendered corpus."""
    ws = tmp_path / "ab"
    assert ab.main(["--workdir", str(ws), "--arm", "attn",
                    "model:model.feature_extractor.use_attention=true", "--arm", "plain",
                    "model:model.feature_extractor.use_attention=false", "--cache", "none",
                    "--quiet-children", *SMALL], runner=ea.run_in_process) == 0
    s_ab = json.loads((ws / "summary.json").read_text())
    _finite_pairs(s_ab, ("auc_control", "auc_treat"))
    assert list(ws.glob("processed_*")) == [ws / "processed_attn"]  # one preprocessing run
    assert (ws / "processed_attn" / "splits" / "test.csv").exists()

    ws2 = tmp_path / "ablation"
    ws2.mkdir()
    (ws2 / "raw").symlink_to(ws / "raw", target_is_directory=True)
    assert ea.main(["--workdir", str(ws2), "--skip-render", *SMALL],
                   runner=ea.run_in_process) == 0
    s_ea = json.loads((ws2 / "summary.json").read_text())
    _finite_pairs(s_ea, ("auc_attention", "auc_ablation"))
    assert aggregate_ablation.pool([ws2 / "summary.json"])["n_pairs"] == 2
    with pytest.raises(SystemExit):  # the same seeds: not independent pairs
        aggregate_ablation.pool([ws / "summary.json", ws2 / "summary.json"])
