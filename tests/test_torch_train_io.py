"""Checkpoints, data loading, the trainer loop and the train/evaluate CLIs
of the port, against the JAX package where both have the piece, on the
CPU.

- The msgpack writer gives ``flax.serialization.msgpack_serialize``'s
  bytes; ``export_flax_variables`` is the flax tree of the model (paths
  and shapes of the JAX model's ``init``) and round-trips the B4 exactly.
- A port checkpoint restores in the JAX package
  (``load_checkpoint`` + ``restore_train_state(restore_opt=False)``) to
  eval probabilities within 1e-4 of the port's; a JAX ``Trainer``
  checkpoint evaluates in the port's ``evaluate`` CLI to the JAX
  evaluator's metrics (probabilities within 1e-4).
- ``HostLoader`` orders equal the JAX loader's for the same seed and
  epoch; batches of a processed directory written with cv2 are equal.
- A two-epoch ``Trainer`` run: rotation, the best copy, resume that
  continues the epoch numbering, the learning rate and the step count;
  early stopping counts as ``tests/test_trainer_edges.py`` has it.
- The CLIs train, resume and evaluate with ``--device cpu`` and fail
  without a card when it is not given; ``DeepfakePredictor`` loads a
  port checkpoint.
"""

import copy
import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepfake_vit_tpu.data.dataset import HostLoader as JHostLoader
from deepfake_vit_tpu.data.dataset import PreprocessedFaceDataset as JDataset
from deepfake_vit_tpu.models.feature_extractor import DeepfakeDetectionModel as JModel
from deepfake_vit_tpu.models.feature_extractor import create_model_from_config as jcreate
from deepfake_vit_tpu.training import Evaluator as JEvaluator
from deepfake_vit_tpu.training import TrainState as JState
from deepfake_vit_tpu.training import Trainer as JTrainer
from deepfake_vit_tpu.training import create_optimizer as jcreate_optimizer
from deepfake_vit_tpu.training import make_criterion as jmake_criterion
from deepfake_vit_tpu.training import restore_train_state
from deepfake_vit_tpu.training.train_state import make_eval_step as jmake_eval_step
from deepfake_vit_tpu.utils.io_utils import load_checkpoint as jload_checkpoint
from deepfake_vit_tpu_torch import evaluate as evaluate_cli
from deepfake_vit_tpu_torch import train as train_cli
from deepfake_vit_tpu_torch.configs import PREPROCESSING_CONFIG, TRAINING_CONFIG
from deepfake_vit_tpu_torch.data import HostLoader, PreprocessedFaceDataset, create_dataloaders
from deepfake_vit_tpu_torch.inference import DeepfakePredictor
from deepfake_vit_tpu_torch.models.bridge import export_flax_variables, load_flax_variables
from deepfake_vit_tpu_torch.models.feature_extractor import (DeepfakeDetectionModel,
                                                             create_model_from_config)
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.tools.synth_processed import write_processed
from deepfake_vit_tpu_torch.training import (Evaluator, Trainer, create_optimizer,
                                             create_scheduler, make_criterion)
from deepfake_vit_tpu_torch.utils.io_utils import latest_checkpoint, load_checkpoint
from deepfake_vit_tpu_torch.utils.msgpack import msgpack_serialize

torch.set_num_threads(1)

S = 64
HEAD = [16]


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """The tool's processed directory with PNG faces written by cv2, and an
    unprocessed row in each split that the datasets must drop."""
    root = write_processed(tmp_path_factory.mktemp("processed"), (12, 4, 4), S)
    for split in ("train", "val", "test"):
        with open(root / "splits" / f"{split}.csv", "a") as f:
            f.write("skipped,synth,fake,False,faces/none.png,,,0.1\n")
    return root


def _run_config(tmp, **overrides):
    cfg = copy.deepcopy(TRAINING_CONFIG)
    cfg["model"]["feature_extractor"]["variant"] = "b0"
    cfg["model"]["classifier"]["hidden_dims"] = HEAD
    cfg["data"].update(batch_size=4, num_workers=2, image_size=S)
    cfg["training"]["num_epochs"] = 2
    cfg["training"]["use_amp"] = False
    cfg["validation"]["save_freq"] = 1
    cfg["checkpoint"]["save_dir"] = str(tmp / "ckpt")
    cfg["logging"]["log_dir"] = str(tmp / "runs")
    for k, v in overrides.items():
        cfg[k].update(v)
    path = tmp / "model.json"
    path.write_text(json.dumps(cfg))
    return cfg, path


def test_training_config_is_the_yaml_file():
    with open("deepfake_vit_tpu/configs/model_config.yaml") as f:
        assert TRAINING_CONFIG == yaml.safe_load(f)


def test_msgpack_writer_gives_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {"epoch": 3, "step": 70000, "params": {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
                                                  "b": np.zeros(4, np.float32)},
            "opt_state": {"state": {"0": {"step": np.float32(2.0),
                                          "exp_avg": rng.normal(0, 1, 5)}},
                          "param_groups": [{"lr": 1e-4, "betas": [0.9, 0.999], "foreach": None,
                                            "amsgrad": False, "params": [0, 1, 2]}]},
            "metrics": {"history": {"lr": [1e-4, 9e-5], "val_acc": []}, "best_epoch": -1,
                        "best_val_acc": float("-inf")},
            "scheduler": None, "config": {"save_dir": "x" * 40, "n": -3, "big": -70000},
            "ints": np.arange(300, dtype=np.int64), "u8": np.ones((2, 2), np.uint8)}
    blob = msgpack_serialize(tree)
    assert blob == flax.serialization.msgpack_serialize(tree)
    back = flax.serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(back["params"]["w"], tree["params"]["w"])
    bf = torch.randn(3, 5).to(torch.bfloat16)
    restored = flax.serialization.msgpack_restore(msgpack_serialize({"x": bf}))["x"]
    assert restored.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(restored, np.float32), bf.float().numpy())


def test_export_is_the_flax_tree_and_round_trips_the_b4():
    from deepfake_vit_tpu_torch.configs import MODEL_CONFIG

    model = init_weights(create_model_from_config(MODEL_CONFIG["model"]), 3)
    with torch.no_grad():  # running statistics away from their init
        for name, buf in model.named_buffers():
            buf.uniform_(0.5, 1.5)
    tree = export_flax_variables(model)
    shapes = jax.eval_shape(
        lambda: jcreate(MODEL_CONFIG["model"]).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
            jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 5, 2))))

    def paths(t):
        return {jax.tree_util.keystr(kp): tuple(np.shape(x))
                for kp, x in jax.tree_util.tree_leaves_with_path(t)}

    for coll in ("params", "batch_stats"):
        assert paths(tree[coll]) == paths(shapes[coll])
    again = load_flax_variables(create_model_from_config(MODEL_CONFIG["model"]), tree)
    a, b = model.state_dict(), again.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(KeyError):
        export_flax_variables(torch.nn.Sequential(torch.nn.Linear(2, 2)))


def _jax_model():
    return JModel(variant="b0", classifier_hidden_dims=tuple(HEAD))


def _numeric(batch):
    return {k: np.asarray(v) for k, v in batch.items() if k in ("image", "label", "landmarks")}


def test_port_checkpoint_evaluates_in_jax(processed, tmp_path):
    loader = create_dataloaders(processed, batch_size=4, num_workers=0, image_size=S,
                                splits=("val",))["val"]
    batch = next(iter(loader))
    model = init_weights(DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=HEAD), 1)
    crit = make_criterion({"type": "CombinedLoss"})
    trainer = Trainer(model, create_optimizer(model.parameters(), {"type": "AdamW"}, 1.0),
                      crit, [batch], [batch], config={"save_dir": str(tmp_path)}, seed=3)
    trainer.train_step(trainer.state, batch, 3)  # moves the running statistics
    path = trainer.save_checkpoint(0, is_best=True)
    port_probs = Evaluator(model, crit).evaluate(loader, return_predictions=True)["probabilities"]

    jm = _jax_model()
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                         jnp.asarray(batch["image"]), jnp.asarray(batch["landmarks"]))
    tx = jcreate_optimizer({"type": "AdamW"})
    template = JState.create(v["params"], v["batch_stats"], tx.init(v["params"]))
    ckpt = jload_checkpoint(path)
    assert ckpt["step"] == 1 and ckpt["epoch"] == 0
    state = restore_train_state(template, ckpt, restore_opt=False)
    step = jmake_eval_step(jm, jmake_criterion({"type": "CombinedLoss"}))
    ref = np.concatenate([np.asarray(step(state, _numeric(b))["probs"]) for b in loader])
    assert np.abs(port_probs - ref).max() <= 1e-4


def test_jax_checkpoint_evaluates_in_the_port_cli(processed, tmp_path):
    cfg, cfg_path = _run_config(tmp_path)
    jm = jcreate(cfg["model"])
    jloader = JHostLoader(JDataset(processed / "splits" / "test.csv", processed, image_size=S),
                          batch_size=4)
    sample = _numeric(next(iter(jloader)))
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(4), "dropout": jax.random.PRNGKey(4)},
                         jnp.asarray(sample["image"]), jnp.asarray(sample["landmarks"]))
    tx = jcreate_optimizer(cfg["training"]["optimizer"])
    state = JState.create(v["params"], v["batch_stats"], tx.init(v["params"]))
    crit = jmake_criterion(cfg["training"]["loss"])
    jt = JTrainer(jm, state, tx, crit, [], [], config={"save_dir": str(tmp_path / "jax")})
    path = jt.save_checkpoint(0, is_best=True)
    ref = JEvaluator(jm, crit).evaluate(state, [_numeric(b) for b in jloader],
                                        return_predictions=True)

    out = tmp_path / "out"
    assert evaluate_cli.main(["--checkpoint", str(path), "--config", str(cfg_path),
                              "--processed-dir", str(processed), "--output-dir", str(out),
                              "--detailed", "--device", "cpu"]) == 0
    got = json.loads((out / "eval_test.json").read_text())[-1]
    preds = np.load(out / "predictions_test.npz")
    assert np.abs(preds["probs"] - ref["probabilities"]).max() <= 1e-4
    np.testing.assert_array_equal(preds["labels"], ref["labels"])
    for k in ("accuracy", "precision", "recall", "f1", "num_samples"):
        assert got[k] == pytest.approx(ref[k]), k
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-4)


@pytest.mark.parametrize("seed,epoch,n,bs,drop_last", [(42, 0, 20, 4, True), (7, 3, 23, 5, True),
                                                       (0, 1, 11, 4, False)])
def test_host_loader_order_matches_jax(seed, epoch, n, bs, drop_last):
    class Items:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"image": np.full((2, 2, 3), i, np.float32), "label": np.int32(i % 2),
                    "image_id": str(i)}

    loaders = [cls(Items(), batch_size=bs, shuffle=True, drop_last=drop_last, seed=seed,
                   num_workers=w) for cls, w in ((HostLoader, 2), (JHostLoader, 0))]
    orders = []
    for loader in loaders:
        loader.set_epoch(epoch)
        orders.append([b["image_id"] for b in loader] + [b["image_id"] for b in loader])
        assert len(loader) == len(orders[-1]) // 2
    assert orders[0] == orders[1]


def test_dataset_batches_match_jax(processed):
    for split in ("train", "test"):
        port = PreprocessedFaceDataset(processed / "splits" / f"{split}.csv", processed,
                                       image_size=S)
        ref = JDataset(processed / "splits" / f"{split}.csv", processed, image_size=S)
        assert len(port) == len(ref) == (12 if split == "train" else 4)
        np.testing.assert_array_equal(port.get_class_weights(), ref.get_class_weights())
        a = HostLoader(port, batch_size=4, shuffle=True, drop_last=True, seed=5, num_workers=2)
        b = JHostLoader(ref, batch_size=4, shuffle=True, drop_last=True, seed=5)
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for k in x:
                if isinstance(x[k], np.ndarray):
                    np.testing.assert_allclose(x[k], y[k], rtol=0, atol=1e-6, err_msg=k)
                else:
                    assert list(x[k]) == list(y[k]), k
    with pytest.raises(RuntimeError, match="device='cpu'"):  # the card, or the CPU by name
        create_dataloaders(processed, cache="device")
    cached = create_dataloaders(processed, batch_size=4, image_size=S, seed=5, cache="device",
                                device="cpu")
    assert type(cached["train"]).__name__ == "CachedDeviceLoader"


def _trainer(processed, save_dir, num_epochs, **config):
    loaders = create_dataloaders(processed, batch_size=4, num_workers=0, image_size=S, seed=1)
    model = init_weights(DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=HEAD), 0)
    opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": 1e-3}, 1.0)
    sched = create_scheduler({"type": "CosineAnnealingWarmRestarts", "T_0": 2, "T_mult": 1},
                             1e-3)
    return Trainer(model, opt, make_criterion({"type": "CombinedLoss"}), loaders["train"],
                   loaders["val"], sched, seed=2,
                   config={"num_epochs": num_epochs, "save_dir": str(save_dir), "save_freq": 1,
                           "max_keep": 1, "print_freq": 100, **config})


def test_trainer_two_epochs_rotation_best_and_resume(processed, tmp_path):
    first = _trainer(processed, tmp_path, 2)
    tracker = first.train()
    assert len(tracker.history["train_loss"]) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best_model.ckpt",
                                                          "checkpoint_epoch_0001.ckpt"]
    ckpt = load_checkpoint(tmp_path / "checkpoint_epoch_0001.ckpt")
    assert ckpt["epoch"] == 1 and ckpt["step"] == 6  # 12 train faces, batches of 4
    assert first.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)  # T_0 = 2: restarted

    resumed = _trainer(processed, tmp_path, 3)
    assert resumed.resume_from_checkpoint(tmp_path / "checkpoint_epoch_0001.ckpt") == 2
    assert resumed.state.step == 6
    assert resumed.scheduler.state_dict() == first.scheduler.state_dict()
    resumed.train(2)
    assert len(resumed.tracker.history["train_loss"]) == 3
    assert resumed.state.step == 9
    assert latest_checkpoint(tmp_path) == tmp_path / "checkpoint_epoch_0002.ckpt"
    assert not (tmp_path / "checkpoint_epoch_0001.ckpt").exists()  # max_keep 1
    assert latest_checkpoint(tmp_path / "none") is None
    lr_epoch3 = create_scheduler({"type": "CosineAnnealingWarmRestarts", "T_0": 2,
                                  "T_mult": 1}, 1e-3).step(3)
    assert resumed.tracker.history["lr"][-1] == pytest.approx(lr_epoch3)
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(lr_epoch3)


def test_early_stopping_counts_and_min_delta(processed, tmp_path):
    t = _trainer(processed, tmp_path, 1, early_stopping_patience=3,
                 early_stopping_min_delta=0.01)
    assert not t._early_stopping(1.0)
    assert not t._early_stopping(0.9)
    assert not t._early_stopping(0.895)  # below min_delta: stagnation
    assert not t._early_stopping(0.893)
    assert t._early_stopping(0.892)
    t2 = _trainer(processed, tmp_path, 1, early_stopping_patience=2,
                  early_stopping_min_delta=0.01)
    assert not t2._early_stopping(1.0)
    assert not t2._early_stopping(1.0)
    assert not t2._early_stopping(0.5)  # reset
    assert not t2._early_stopping(0.5)
    assert t2._early_stopping(0.5)
    assert Evaluator(t.model, t.criterion).evaluate([]) == {"loss": pytest.approx(np.nan,
                                                                                  nan_ok=True),
                                                            "num_samples": 0}
    assert t.tb is None
    t3 = _trainer(processed, tmp_path, 1, tb_dir=str(tmp_path / "tb"))
    assert t3.tb is not None and t3.tb.path.parent == tmp_path / "tb"
    t3.tb.close()


def test_clis_train_resume_evaluate_on_the_cpu(processed, tmp_path):
    cfg, cfg_path = _run_config(tmp_path, data={"augmentation": {
        "enabled": True, "random_flip": True, "random_rotation": 5, "color_jitter": 0.1}})
    common = ["--config", str(cfg_path), "--processed-dir", str(processed)]
    assert train_cli.main(common + ["--device", "cpu"]) == 0
    ckpt_dir = tmp_path / "ckpt"
    assert "epoch 2/2" in (tmp_path / "runs" / "train.log").read_text()
    assert len(list((tmp_path / "runs" / "tb").glob("events.out.tfevents.*"))) == 1
    names = sorted(p.name for p in ckpt_dir.iterdir())
    assert "best_model.ckpt" in names and "checkpoint_epoch_0001.ckpt" in names
    assert train_cli.main(common + ["--device", "cpu", "--epochs", "3", "--resume",
                                    str(ckpt_dir / "checkpoint_epoch_0001.ckpt")]) == 0
    last = load_checkpoint(ckpt_dir / "checkpoint_epoch_0002.ckpt")
    assert last["epoch"] == 2 and last["step"] == 9
    out = tmp_path / "out"
    assert evaluate_cli.main(["--checkpoint", str(ckpt_dir / "best_model.ckpt"),
                              "--output-dir", str(out), "--device", "cpu"] + common) == 0
    assert json.loads((out / "eval_test.json").read_text())[-1]["num_samples"] == 4

    # The predictor reads a port checkpoint.
    pred = DeepfakePredictor({"model": cfg["model"]}, PREPROCESSING_CONFIG,
                             checkpoint_path=str(ckpt_dir / "best_model.ckpt"),
                             dtype=torch.float32, device="cpu")
    ref = create_model_from_config(cfg["model"])
    load_flax_variables(ref, {k: load_checkpoint(ckpt_dir / "best_model.ckpt")[k]
                              for k in ("params", "batch_stats")})
    for (name, a), (_, b) in zip(pred.model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_clis_need_a_card_unless_told_cpu(processed, tmp_path):
    _, cfg_path = _run_config(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", str(cfg_path), "--processed-dir", str(processed)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_cli.main(["--checkpoint", "x.ckpt", "--config", str(cfg_path),
                           "--processed-dir", str(processed)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_cli.main(["--checkpoint", "x.ckpt", "--config", str(cfg_path),
                           "--processed-dir", str(processed), "--visualize"])
