"""The port's detector training against the JAX package's, on the CPU.

- ``assign_targets`` equal to JAX's (per anchor: positives, matched box
  and landmarks); the focal, IoU and Huber losses and ``detection_loss``
  within 1e-5 relative.
- One step of ``make_detector_train_step`` (MTCNN-Lite at 128², B = 4,
  AdamW lr 1e-3, clip 5.0) from the same weights on the same drawn batch:
  the loss within 1e-5 relative, Adam's first moments (the clipped
  gradients) within 1e-2 of the largest, the parameters after the step
  within 1e-5 lr (plus a float32 spacing) where the gradient is at least
  2e-2 of the largest, the running statistics within 1e-5 of the largest
  (``_compare_steps`` says why).
- ``sample_refine_targets`` equal to JAX's from the same ``rng``, bit for
  bit; ``refinement_loss`` and one step of ``make_refiner_train_step``
  likewise.
- ``fit_hog_template(mining_rounds=0, steps=200)`` on 4 scenes: the
  template within 1e-4 of its largest weight (the bias is float noise's,
  see the test).
- ``python -m deepfake_vit_tpu_torch.train_detector`` for two epochs on
  ``--synthetic 8 --input-size 128``: the loss is finite and the msgpack
  loads into the JAX ``FaceDetector``; ``--save`` inside the committed
  weights directory is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepfake_vit_tpu.data.synth_faces import render_scene
from deepfake_vit_tpu.models import hog_detector as jh
from deepfake_vit_tpu.models.refine_net import RefineNet as JaxRefineNet
from deepfake_vit_tpu.ops.anchors import all_anchor_centers
from deepfake_vit_tpu.preprocessing.detector import FaceDetector as JaxFaceDetector
from deepfake_vit_tpu.preprocessing.detector import build_detection_net as jax_net
from deepfake_vit_tpu.training import create_optimizer as jax_optimizer
from deepfake_vit_tpu.training import detection as jdt
from deepfake_vit_tpu.training import refinement as jrf
from deepfake_vit_tpu_torch import train_detector
from deepfake_vit_tpu_torch.models import hog_detector as th
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables, to_numpy_tree
from deepfake_vit_tpu_torch.models.layers import init_weights
from deepfake_vit_tpu_torch.models.refine_net import RefineNet
from deepfake_vit_tpu_torch.preprocessing.detector import build_detection_net
from deepfake_vit_tpu_torch.training import create_optimizer
from deepfake_vit_tpu_torch.training import detection as tdt
from deepfake_vit_tpu_torch.training import refinement as trf

torch.set_num_threads(1)
SIZE = 128


@pytest.fixture(scope="module")
def det_batch():
    """4 drawn 128² scenes, ground truths padded to 8 faces."""
    rng = np.random.default_rng(12)
    B, G = 4, 8
    batch = {"image": np.zeros((B, SIZE, SIZE, 3), np.float32),
             "boxes": np.zeros((B, G, 4), np.float32), "kps": np.zeros((B, G, 5, 2), np.float32),
             "valid": np.zeros((B, G), np.float32)}
    for b in range(B):
        img, boxes, kps = render_scene(rng, size=SIZE, max_faces=3, min_face=20, max_face=80,
                                       p_empty=0.0)
        batch["image"][b] = img
        batch["boxes"][b, :len(boxes)] = boxes
        batch["kps"][b, :len(boxes)] = kps
        batch["valid"][b, :len(boxes)] = 1.0
    assert batch["valid"].sum() >= 4
    return batch


def _anchors(dev="cpu"):
    c, s = all_anchor_centers((SIZE, SIZE))
    return c, s, torch.as_tensor(c, device=dev), torch.as_tensor(s, device=dev)


def test_assign_targets_matches_jax(det_batch):
    c, s, tc, ts = _anchors()
    want = jax.device_get(jax.vmap(lambda b, k, v: jdt.assign_targets(
        jnp.asarray(c), jnp.asarray(s), b, k, v))(
        jnp.asarray(det_batch["boxes"]), jnp.asarray(det_batch["kps"]),
        jnp.asarray(det_batch["valid"])))
    got = tdt.assign_targets(tc, ts, *(torch.from_numpy(det_batch[k])
                                       for k in ("boxes", "kps", "valid")))
    assert want["pos"].sum() > 0
    for k in ("cls", "box", "kps", "pos"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_losses_match_jax(det_batch):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 100)).astype(np.float32)
    labels = (rng.uniform(size=(4, 100)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tdt.sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(jdt.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-5, atol=1e-7)
    err = rng.normal(0, 2, (50, 10)).astype(np.float32)
    np.testing.assert_allclose(tdt.huber_loss(torch.from_numpy(err), 1.0).numpy(),
                               np.asarray(optax.huber_loss(jnp.asarray(err), delta=1.0)),
                               rtol=1e-6, atol=1e-7)
    a = np.sort(rng.uniform(0, 50, (30, 2, 2)), axis=1).reshape(30, 4)[:, [0, 2, 1, 3]]
    b = np.sort(rng.uniform(0, 50, (30, 2, 2)), axis=1).reshape(30, 4)[:, [0, 2, 1, 3]]
    np.testing.assert_allclose(
        tdt.iou_loss(torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))),
        np.asarray(jdt.iou_loss(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))),
        rtol=1e-5, atol=1e-6)

    c, s, tc, ts = _anchors()
    n = [len(c) * f // 21 for f in (16, 4, 1)]  # anchors per level at strides 8, 16, 32
    outs = {st: {"scores": rng.normal(-2, 1, (4, k)).astype(np.float32),
                 "bbox": rng.uniform(0.5, 3, (4, k, 4)).astype(np.float32),
                 "kps": rng.normal(0, 1, (4, k, 10)).astype(np.float32)}
            for st, k in zip((8, 16, 32), n)}
    gt = [det_batch[k] for k in ("boxes", "kps", "valid")]
    want = jdt.detection_loss(jax.tree.map(jnp.asarray, outs), jnp.asarray(c), jnp.asarray(s),
                              *map(jnp.asarray, gt))
    got = tdt.detection_loss(jax.tree.map(torch.from_numpy, outs), tc, ts,
                             *map(torch.from_numpy, gt))
    for k in ("total", "cls", "box", "kps", "num_pos"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _adam_mu(state):
    """The first moment of optax's Adam inside the optimizer's state."""
    if hasattr(state, "mu"):
        return state.mu
    for sub in (getattr(state, "inner_state", None), *(state if isinstance(state, tuple) else ())):
        mu = None if sub is None else _adam_mu(sub)
        if mu is not None:
            return mu
    return None


def _compare_steps(net, variables, jax_out, model, optimizer, lr):
    """The port's step against JAX's: the first moments (0.1 · the clipped
    gradient) within 1e-2 of the largest (JAX's float32 convolution
    gradients on the CPU are 3.7e-3 of the largest from a float64 step of
    the refiner, the port's 6.5e-7); the parameters after the step
    within 1e-5 lr plus one float32 spacing of the parameter, where the
    gradient is at least 2e-2 of the largest (Adam's first step moves
    every element by about ±lr whatever its gradient's size, so a
    gradient that JAX's error can flip moves 2 lr the other way); the
    running statistics within 1e-5 of the largest."""
    params, stats, opt_state = jax_out

    def as_port(tree):  # a flax params tree in the port's layout
        m = init_weights(net(), 0)
        load_flax_variables(m, to_numpy_tree({"params": tree, "batch_stats": stats}))
        return dict(m.named_parameters()), dict(m.named_buffers())

    mu, _ = as_port(_adam_mu(opt_state))
    after, stats_j = as_port(params)
    mine = dict(model.named_parameters())
    gmax = max(float(v.abs().max()) for v in mu.values())
    worst_mu = max(float((optimizer.state[mine[k]]["exp_avg"] - v).abs().max()) for k, v in mu.items())
    assert worst_mu <= 1e-2 * gmax, (worst_mu, gmax)
    for k, v in after.items():
        big = (mu[k].abs() >= 2e-2 * gmax).numpy()
        want = v.detach().numpy()[big]
        gap = np.abs(mine[k].detach().numpy()[big] - want)
        assert (gap <= 1e-5 * lr + np.spacing(np.abs(want))).all(), (k, gap.max())
    bufs = dict(model.named_buffers())
    smax = max(float(v.abs().max()) for v in stats_j.values())
    assert max(float((bufs[k] - v).abs().max()) for k, v in stats_j.items()) <= 1e-5 * smax


def test_detector_step_matches_jax(det_batch):
    lr = 1e-3
    net = jax_net("mtcnn")
    variables = jax.device_get(net.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    opt = jax_optimizer({"type": "AdamW", "lr": lr}, gradient_clip=5.0)
    step = jdt.make_detector_train_step(net, opt, (SIZE, SIZE))
    params, stats, opt_state, losses = jax.device_get(step(
        variables["params"], variables["batch_stats"], opt.init(variables["params"]),
        jax.tree.map(jnp.asarray, det_batch)))

    model = init_weights(build_detection_net("mtcnn"), 0)
    load_flax_variables(model, to_numpy_tree(variables))
    optimizer = create_optimizer(model.parameters(), {"type": "AdamW", "lr": lr},
                                 gradient_clip=5.0)
    got = tdt.make_detector_train_step(model, optimizer, (SIZE, SIZE))(det_batch)
    for k in ("total", "cls", "box", "kps"):
        np.testing.assert_allclose(float(got[k]), float(losses[k]), rtol=1e-5, err_msg=k)
    _compare_steps(lambda: build_detection_net("mtcnn"), variables, (params, stats, opt_state),
                   model, optimizer, lr)


def test_refine_sampler_and_step_match_jax(det_batch):
    want = jrf.sample_refine_targets(det_batch, np.random.default_rng(3))
    got = trf.sample_refine_targets(det_batch, np.random.default_rng(3))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["cls"].sum() > 0 and (got["cls"] == 0).any()

    lr = 1e-3
    net = JaxRefineNet()
    variables = jax.device_get(net.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))))
    opt = jax_optimizer({"type": "AdamW", "lr": lr}, gradient_clip=5.0)
    step = jrf.make_refiner_train_step(net, opt)
    params, stats, opt_state, losses = jax.device_get(step(
        variables["params"], variables["batch_stats"], opt.init(variables["params"]),
        jax.tree.map(jnp.asarray, want)))

    model = init_weights(RefineNet(), 0)
    load_flax_variables(model, to_numpy_tree(variables))
    optimizer = create_optimizer(model.parameters(), {"type": "AdamW", "lr": lr},
                                 gradient_clip=5.0)
    out = trf.make_refiner_train_step(model, optimizer)(got)
    for k in ("total", "cls", "box", "kps", "num_pos"):
        np.testing.assert_allclose(float(out[k]), float(losses[k]), rtol=1e-5, err_msg=k)
    _compare_steps(RefineNet, variables, (params, stats, opt_state), model, optimizer, lr)


def test_fit_hog_template_without_mining_matches_jax():
    """200 Adam steps: the template within 1e-4 of its largest weight. The
    bias is not compared: class balancing makes its gradient zero but for
    float noise while the margins are small, so each implementation's Adam
    (g / (|g| + eps)) walks it by noise-driven fractions of lr (here -0.25
    in JAX, -0.135 in the port, the template equal to 1.1e-5). After 600
    steps the two bias walks have moved the templates 2.4e-2 apart, so the
    fit is held at 200 and by the HOG acceptance bars on the card."""
    kw = dict(n_scenes=4, scene_size=160, seed=5, mining_rounds=0, steps=200)
    want = jh.fit_hog_template(**kw)
    got = th.fit_hog_template(**kw, device="cpu")
    tj = np.asarray(want["template"])
    assert got["template"].shape == tj.shape == (9, 9, 36)
    np.testing.assert_allclose(got["template"], tj, rtol=0, atol=1e-4 * np.abs(tj).max())
    assert np.isfinite(got["bias"])


def test_train_detector_cli(tmp_path):
    save = tmp_path / "mtcnn.msgpack"
    common = ["--synthetic", "8", "--input-size", "128", "--batch-size", "4", "--model", "mtcnn",
              "--synthetic-dir", str(tmp_path / "scenes"), "--device", "cpu"]
    assert train_detector.main([*common, "--epochs", "2", "--save", str(save),
                                "--save-every", "1"]) == 0
    det = JaxFaceDetector(model_name="mtcnn", input_size=(128, 128), pretrained=False)
    det.load_weights(str(save))
    frames = np.zeros((1, 128, 128, 3), np.float32)
    assert np.isfinite(jax.device_get(det.detect_batch_raw(frames))["scores"]).all()
    resumed = tmp_path / "resumed.msgpack"
    assert train_detector.main([*common, "--epochs", "1", "--save", str(resumed),
                                "--resume", str(save)]) == 0
    assert resumed.exists()
    with pytest.raises(SystemExit):
        train_detector.main(["--synthetic", "8", "--save",
                             str(train_detector.shipped_weights_dir() / "x.msgpack")])
