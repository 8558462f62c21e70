"""The port's utilities against the JAX package's ``utils/``, on the CPU.

- TensorBoard: the port's ``SummaryWriter`` writes the JAX writer's
  file, byte for byte, for the same scalars, steps and clock (crc32c of
  the standard check string included); a ``Trainer`` with ``tb_dir``
  writes the JAX trainer's scalars at steps epoch + 1.
- The six visualizations give the JAX functions' arrays (the training
  curves: the same rendered figure).
- The io helpers: YAML, pickle and config files round-trip and each
  package reads the other's; ``get_project_root`` is the repository;
  ``count_parameters`` and ``print_model_info`` of a module equal the JAX
  functions' on its params tree.
- ``StepTimer`` gives the JAX timer's statistics for the same clock;
  ``device_sync`` accepts CPU trees; ``trace`` writes a Chrome trace with
  the ``annotate`` range; ``setup_logger`` logs INFO to the console and
  DEBUG to its file in the JAX format and does not stack handlers.
- ``python -m deepfake_vit_tpu_torch.evaluate --visualize --device cpu``
  writes the prediction grid.
"""

import json
import logging
import struct
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import deepfake_vit_tpu.utils.io_utils as jio
import deepfake_vit_tpu.utils.logger as jlogger
import deepfake_vit_tpu.utils.profiling as jprof
import deepfake_vit_tpu.utils.tb_writer as jtb
import deepfake_vit_tpu.utils.visualization as jviz
from deepfake_vit_tpu.preprocessing import PreprocessingOutput as JOutput
from deepfake_vit_tpu_torch import evaluate as evaluate_cli
from deepfake_vit_tpu_torch.models.bridge import export_flax_variables
from deepfake_vit_tpu_torch.models.feature_extractor import DeepfakeDetectionModel
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.models.vit import ViTClassifier
from deepfake_vit_tpu_torch.preprocessing.pipeline import PreprocessingOutput
from deepfake_vit_tpu_torch.tools.synth_processed import write_processed
from deepfake_vit_tpu_torch.training import Trainer, create_optimizer, make_criterion
from deepfake_vit_tpu_torch.utils import io_utils, logger, profiling, tb_writer, visualization

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TB_TAGS = {"train/loss", "train/accuracy", "val/loss", "val/accuracy", "val/roc_auc", "lr",
           "host/rss_mb"}


def _records(path):
    """TFRecord payloads of an event file, each CRC checked."""
    data, off, out = Path(path).read_bytes(), 0, []
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        assert struct.unpack_from("<I", data, off + 8)[0] == tb_writer._masked_crc(
            data[off:off + 8])
        payload = data[off + 12:off + 12 + length]
        assert struct.unpack_from("<I", data, off + 12 + length)[0] == tb_writer._masked_crc(
            payload)
        out.append(payload)
        off += 16 + length
    return out


def _varint(buf, i):
    shift = v = 0
    while True:
        b = buf[i]
        v |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(buf):
    """{field: [value]} of one protobuf message (varints, fixed64 as double,
    fixed32 as float, length-delimited as bytes)."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 1:
            v, i = struct.unpack_from("<d", buf, i)[0], i + 8
        elif wire == 5:
            v, i = struct.unpack_from("<f", buf, i)[0], i + 4
        else:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        out.setdefault(field, []).append(v)
    return out


def _event(payload):
    """(step, {tag: value}) of a scalar Event record."""
    ev = _fields(payload)
    values = [_fields(v) for v in _fields(ev[5][0]).get(1, [])]
    return ev[2][0], {v[1][0].decode(): v[2][0] for v in values}


def test_tb_writer_is_the_jax_writer_byte_for_byte(tmp_path, monkeypatch):
    assert tb_writer._crc32c(b"123456789") == jtb._crc32c(b"123456789") == 0xE3069283
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    files = []
    for mod, sub in ((tb_writer, "port"), (jtb, "jax")):
        with mod.SummaryWriter(tmp_path / sub, filename_suffix=".x") as w:
            w.add_scalar("train/loss", 0.75, step=1)
            w.add_scalars({"val/auc": 0.9, "val/acc": 0.8125, "lr": float("nan")}, step=2)
            w.add_scalars({"big/step": -3.5e7}, step=2 ** 40, wall_time=12.5)
            files.append(w.path)
    assert files[0].name == files[1].name
    assert files[0].read_bytes() == files[1].read_bytes()
    recs = _records(files[0])
    assert len(recs) == 4 and _fields(recs[0])[3] == [b"brain.Event:2"]
    assert _event(recs[1]) == (1, {"train/loss": 0.75})
    assert _event(recs[3]) == (2 ** 40, {"big/step": -3.5e7})


def _batches(n, seed, size=32):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(0, 1, (4, size, size, 3)).astype(np.float32),
             "label": np.array([0, 1, 0, 1], np.int32),
             "landmarks": rng.uniform(4, size - 4, (4, 5, 2)).astype(np.float32)}
            for _ in range(n)]


def test_trainer_writes_the_jax_scalars(tmp_path):
    model = init_weights(DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=(8,)), 0)
    opt = create_optimizer(model.parameters(), {"type": "AdamW", "lr": 1e-3}, 1.0)
    trainer = Trainer(model, opt, make_criterion({"type": "CrossEntropy"}), _batches(2, 0),
                      _batches(1, 1), config={"num_epochs": 2, "save_dir": str(tmp_path / "c"),
                                              "save_freq": 100, "tb_dir": str(tmp_path / "tb")})
    tracker = trainer.train()
    files = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert len(files) == 1 and trainer.tb._f.closed
    events = [_event(r) for r in _records(files[0])[1:]]
    assert [step for step, _ in events] == [1, 2]
    for epoch, (_, scalars) in enumerate(events):
        assert set(scalars) == TB_TAGS
        for tag, key in (("train/loss", "train_loss"), ("val/loss", "val_loss"),
                         ("val/accuracy", "val_acc")):
            assert scalars[tag] == pytest.approx(tracker.history[key][epoch], rel=1e-6)


def _figure_pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def test_visualizations_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (120, 140, 3), dtype=np.uint8)
    det = {"bbox": np.asarray([10.6, 10.2, 90.7, 100.1], np.float32),
           "landmarks": rng.uniform(20, 80, (5, 2)).astype(np.float32), "confidence": 0.87}
    for name in ("port", "jax"):
        mod = visualization if name == "port" else jviz
        drawn = mod.visualize_detection(img, det, save_path=tmp_path / name / "det.png")
        assert (tmp_path / name / "det.png").exists() and drawn.shape == img.shape
    assert ((tmp_path / "port" / "det.png").read_bytes()
            == (tmp_path / "jax" / "det.png").read_bytes())
    np.testing.assert_array_equal(visualization.visualize_detection(img, det),
                                  jviz.visualize_detection(img, det))
    np.testing.assert_array_equal(visualization.visualize_detection(img, None),
                                  jviz.visualize_detection(img, None))
    q = {"is_valid": False, "overall_score": 0.41, "scores": {"blur": 150.0, "pose": "ok"}}
    np.testing.assert_array_equal(visualization.visualize_quality(img, q),
                                  jviz.visualize_quality(img, q))
    for image in (img, None):
        np.testing.assert_array_equal(
            visualization.visualize_attention_map(det["landmarks"], image, size=112),
            jviz.visualize_attention_map(det["landmarks"], image, size=112))
    fields = dict(aligned_face=rng.integers(0, 255, (224, 224, 3), dtype=np.uint8),
                  landmarks=rng.uniform(0, 224, (5, 2)).astype(np.float32),
                  original_landmarks=det["landmarks"], bbox=det["bbox"], confidence=0.9,
                  success=True)
    for empty in ((), ("aligned_face", "landmarks", "original_landmarks", "bbox")):
        kw = {**fields, **{k: None for k in empty}, "success": not empty}
        np.testing.assert_array_equal(
            visualization.visualize_pipeline(img, PreprocessingOutput(**kw)),
            jviz.visualize_pipeline(img, JOutput(**kw)))
    batch = rng.normal(0, 1, (6, 64, 64, 3)).astype(np.float32)
    for labels, preds in (([0, 1, 0, 1, 0, 1], [0, 1, 1, 1, 0, 0]), (None, None)):
        np.testing.assert_array_equal(
            visualization.visualize_batch(batch, labels=labels, predictions=preds),
            jviz.visualize_batch(batch, labels=labels, predictions=preds))
    history = {"train_loss": [1, 0.5], "val_loss": [1.1, 0.7], "train_acc": [0.5, 0.8],
               "val_acc": [0.5, 0.7], "val_auc": [0.5, 0.8], "val_f1": [0.4, 0.7],
               "lr": [1e-4, 5e-5]}
    fig = visualization.plot_training_curves(history, save_path=tmp_path / "curves.png")
    assert (tmp_path / "curves.png").exists()
    np.testing.assert_array_equal(_figure_pixels(fig),
                                  _figure_pixels(jviz.plot_training_curves(history)))


def test_io_helpers_match_jax(tmp_path, capsys):
    cfg = {"a": 1, "b": {"c": [1, 2, 3], "d": "x"}, "e": None}
    io_utils.save_yaml(cfg, tmp_path / "port.yaml")
    jio.save_yaml(cfg, tmp_path / "jax.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()
    assert jio.load_yaml(tmp_path / "port.yaml") == io_utils.load_yaml(tmp_path / "jax.yaml") == cfg
    for suffix in (".yaml", ".json"):
        io_utils.save_config(cfg, tmp_path / f"c{suffix}")
        assert jio.load_config(tmp_path / f"c{suffix}") == io_utils.load_config(
            tmp_path / f"c{suffix}") == cfg
    with pytest.raises(ValueError, match="unsupported config format"):
        io_utils.save_config(cfg, tmp_path / "c.txt")
    data = {"x": np.arange(5), "y": (1, "two")}
    io_utils.save_pickle(data, tmp_path / "p.pkl")
    back = jio.load_pickle(tmp_path / "p.pkl")
    assert back["y"] == (1, "two") and np.array_equal(back["x"], data["x"])
    jio.save_pickle(data, tmp_path / "q.pkl")
    assert io_utils.load_pickle(tmp_path / "q.pkl")["y"] == (1, "two")
    assert io_utils.get_project_root() == jio.get_project_root() == ROOT

    model = ViTClassifier("tiny16", image_size=32)
    params = export_flax_variables(model)["params"]
    n = jio.count_parameters(params)
    assert io_utils.count_parameters(model) == n > 5_000_000
    b0 = DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=(16,))
    assert io_utils.count_parameters(b0) == jio.count_parameters(
        export_flax_variables(b0)["params"])
    for p in model.head.parameters():
        p.requires_grad_(False)
    assert io_utils.count_parameters(model) == n - 192 * 2 - 2
    assert io_utils.count_parameters(model, trainable_only=False) == n
    for p in model.head.parameters():
        p.requires_grad_(True)
    info = io_utils.print_model_info(model, "vit")
    port_line = capsys.readouterr().out
    assert info == jio.print_model_info(params, "vit")
    assert port_line == capsys.readouterr().out


def test_step_timer_profiling_and_logger(tmp_path, monkeypatch):
    stats = []
    clock_values = np.cumsum([100.0, 0.010, 0.002, 0.030, 0.001, 0.020]).tolist()
    for mod in (profiling, jprof):
        it = iter(clock_values)
        monkeypatch.setattr(mod.time, "perf_counter", lambda it=it: next(it))
        timer = mod.StepTimer(window=2)
        for _ in range(3):
            with timer.step():
                pass
        stats.append(timer.stats(batch_size=8))
        monkeypatch.undo()
    assert stats[0] == stats[1]
    assert stats[0]["steps_timed"] == 2 and stats[0]["step_ms_p50"] == pytest.approx(30.0)
    assert stats[0]["step_ms_mean"] == pytest.approx(25.0)  # the window keeps 30 and 20 ms
    assert profiling.StepTimer().stats() == {}

    x = {"a": torch.ones(3), "b": [torch.zeros(2), 1.0]}
    profiling.device_sync(x)  # CPU tensors: nothing to wait for
    with profiling.trace(str(tmp_path / "prof")) as prof:
        with profiling.annotate("dfv_step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(ev.get("name") == "dfv_step" for ev in trace["traceEvents"])
    assert any(e.key == "dfv_step" for e in prof.key_averages())

    log_file = tmp_path / "logs" / "run.log"
    for _ in range(2):
        log = logger.setup_logger("dfv_port_test", str(log_file))
    assert len(log.handlers) == 2 and not log.propagate
    log.debug("debug line")
    log.info("info line")
    for h in log.handlers:
        h.flush()
    lines = log_file.read_text().splitlines()
    assert [ln.split(" - ", 3)[1:] for ln in lines] == [
        ["dfv_port_test", "DEBUG", "debug line"], ["dfv_port_test", "INFO", "info line"]]
    assert logger._FORMAT == jlogger._FORMAT
    console = [h for h in log.handlers if not isinstance(h, logging.FileHandler)]
    assert console[0].level == logging.INFO
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)


def test_evaluate_cli_visualize_on_the_cpu(tmp_path):
    size = 32
    processed = write_processed(tmp_path / "processed", (4, 4, 6), size)
    model = init_weights(DeepfakeDetectionModel(variant="b0", classifier_hidden_dims=(8,)), 0)
    tree = export_flax_variables(model)
    ckpt = io_utils.save_checkpoint({"epoch": 0, **tree}, tmp_path / "ckpt")
    cfg = {"model": {"feature_extractor": {"variant": "b0"},
                     "classifier": {"hidden_dims": [8]}},
           "data": {"batch_size": 4, "image_size": size, "num_workers": 0},
           "training": {"use_amp": False, "loss": {"type": "CrossEntropy"}}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    out = tmp_path / "out"
    assert evaluate_cli.main(["--checkpoint", str(ckpt), "--config", str(cfg_path),
                              "--processed-dir", str(processed), "--output-dir", str(out),
                              "--visualize", "--device", "cpu"]) == 0
    grid = cv2.imread(str(out / "eval_grid_test.png"))
    assert grid.shape == (2 * 112, 2 * 112, 3)  # the first batch of 4: a 2 × 2 grid
    preds = np.load(out / "predictions_test.npz")
    assert len(preds["preds"]) == 6
