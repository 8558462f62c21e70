"""The port's losses, metrics, optimizers and schedulers vs the JAX
package's, on the same seeded numpy inputs, on the CPU.

- Each criterion within 1e-6 relative (float32 both sides).
- The metric suite (a copy) gives the same dict.
- One optimizer update on identical gradients against optax (Adam, AdamW,
  SGD-Nesterov, clipping on and off, the param-group AdamW with a frozen
  mask): every parameter within 1e-6 relative to its leaf's scale. torch
  and optax order the Adam arithmetic differently (``lerp`` vs a weighted
  sum, the bias corrections folded into the step size), a few float32
  ulps apart.
- The scheduler classes (copies) give the JAX classes' learning rates over
  60 epochs exactly; ``set_learning_rate`` changes a plain optimizer's rate
  and, as in the JAX package, not a param-group optimizer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepfake_vit_tpu.models.efficientnet import EfficientNetBackbone as JBackbone
from deepfake_vit_tpu.models.efficientnet import frozen_stage_mask as jfrozen
from deepfake_vit_tpu.models.efficientnet import param_group_labels as jlabels
from deepfake_vit_tpu.ops import metrics as jmetrics
from deepfake_vit_tpu.training import losses as jl
from deepfake_vit_tpu.training import optim as jo
from deepfake_vit_tpu_torch.models.bridge import export_flax_variables, load_flax_variables
from deepfake_vit_tpu_torch.models.efficientnet import EfficientNetBackbone
from deepfake_vit_tpu_torch.models.efficientnet import frozen_stage_mask, param_group_labels
from deepfake_vit_tpu_torch.ops import metrics as tmetrics
from deepfake_vit_tpu_torch.training import losses as tl
from deepfake_vit_tpu_torch.training import optim as to

torch.set_num_threads(1)


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(0)
    B = 9  # odd: the contrastive pairing drops the last sample
    return dict(logits=rng.normal(0, 2, (B, 2)).astype(np.float32),
                labels=rng.integers(0, 2, B).astype(np.int32),
                feats=rng.normal(0, 1, (B, 16)).astype(np.float32),
                cw=np.array([0.7, 1.6], np.float32))


def _both(fn_j, fn_t, *arrays, **kw):
    return (np.asarray(fn_j(*map(jnp.asarray, arrays), **kw)),
            fn_t(*map(torch.from_numpy, arrays), **kw).numpy())


@pytest.mark.parametrize("case", ["ce", "ce_weighted", "ce_none", "focal", "focal_alpha",
                                  "smoothing", "contrastive", "contrastive_cos", "triplet",
                                  "triplet_cos"])
def test_losses_match(loss_inputs, case):
    li = loss_inputs
    lo, la, f, cw = li["logits"], li["labels"], li["feats"], li["cw"]
    pair = (la[:4] == la[4:8]).astype(np.float32)
    calls = {
        "ce": (lambda m: m.cross_entropy_loss, (lo, la), {}),
        "ce_weighted": (lambda m: m.cross_entropy_loss, (lo, la, cw), {}),
        "ce_none": (lambda m: m.cross_entropy_loss, (lo, la, cw), {"reduction": "none"}),
        "focal": (lambda m: m.focal_loss, (lo, la), {"gamma": 2.0}),
        "focal_alpha": (lambda m: m.focal_loss, (lo, la), {"gamma": 1.5}),
        "smoothing": (lambda m: m.label_smoothing_loss, (lo, la), {"smoothing": 0.1}),
        "contrastive": (lambda m: m.contrastive_loss, (f[:4], f[4:8], pair), {"margin": 3.0}),
        "contrastive_cos": (lambda m: m.contrastive_loss, (f[:4], f[4:8], pair),
                            {"distance": "cosine"}),
        "triplet": (lambda m: m.triplet_loss, (f[:3], f[3:6], f[6:9]), {"margin": 1.0}),
        "triplet_cos": (lambda m: m.triplet_loss, (f[:3], f[3:6], f[6:9]),
                        {"distance": "cosine"}),
    }
    pick, args, kw = calls[case]
    if case == "focal_alpha":
        kw = {**kw, "alpha": None}
        ref = np.asarray(jl.focal_loss(jnp.asarray(lo), jnp.asarray(la), 1.5, jnp.asarray(cw)))
        port = tl.focal_loss(torch.from_numpy(lo), torch.from_numpy(la), 1.5,
                             torch.from_numpy(cw)).numpy()
    else:
        ref, port = _both(pick(jl), pick(tl), *args, **kw)
    assert port.shape == ref.shape
    assert _rel(port, ref) <= 1e-6


@pytest.mark.parametrize("cfg", [
    {"type": "CombinedLoss"},
    {"type": "CombinedLoss", "weights": {"ce": 1.0, "focal": 0.0, "contrastive": 0.5},
     "class_weights": [2.0, 0.5]},
    {"type": "CrossEntropy"}, {"type": "FocalLoss", "focal_gamma": 3.0},
    {"type": "LabelSmoothing", "smoothing": 0.2},
])
def test_make_criterion_matches(loss_inputs, cfg):
    li = loss_inputs
    ref = jl.make_criterion(cfg, jnp.asarray(li["cw"]))(
        jnp.asarray(li["logits"]), jnp.asarray(li["labels"]), jnp.asarray(li["feats"]))
    port = tl.make_criterion(cfg, torch.from_numpy(li["cw"]))(
        torch.from_numpy(li["logits"]), torch.from_numpy(li["labels"]),
        torch.from_numpy(li["feats"]))
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert _rel(port[k].numpy(), np.asarray(ref[k])) <= 1e-6, k


def test_metrics_copy_matches():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 50)
    scores = np.round(rng.uniform(0, 1, 50), 1)  # ties
    preds = (scores > 0.5).astype(int)
    assert (tmetrics.binary_classification_metrics(labels, preds, scores)
            == jmetrics.binary_classification_metrics(labels, preds, scores))


# ---------------------------------------------------------------------------
# One optimizer update on identical gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def backbone_tree():
    """A b0 backbone's flax params (top keys stem_*, block_*, head_*) and
    seeded gradients of the same tree."""
    x = jnp.zeros((1, 32, 32, 3))
    v = jax.jit(JBackbone(variant="b0").init)(jax.random.PRNGKey(0), x)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)
    return {"params": params, "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                     v["batch_stats"])}, grads


def _port_backbone(variables):
    return load_flax_variables(EfficientNetBackbone(variant="b0"), variables)


def _set_grads(module, grads_tree):
    """Copy a flax-layout gradient tree into the module's .grad fields."""
    shadow = load_flax_variables(EfficientNetBackbone(variant="b0"),
                                 {"params": grads_tree,
                                  "batch_stats": export_flax_variables(module)["batch_stats"]})
    for (_, p), (_, g) in zip(module.named_parameters(), shadow.named_parameters()):
        p.grad = g.detach().clone()


def _flat(tree):
    return {jax.tree_util.keystr(kp): np.asarray(x) for kp, x in
            jax.tree_util.tree_leaves_with_path(tree)}


def _assert_params_close(module, ref_params, rel=1e-6):
    port, ref = _flat(export_flax_variables(module)["params"]), _flat(ref_params)
    assert set(port) == set(ref)
    worst = max((_rel(port[k], ref[k]), k) for k in ref)
    assert worst[0] <= rel, worst


@pytest.mark.parametrize("kind,clip", [("Adam", None), ("AdamW", None), ("AdamW", 1.0),
                                       ("SGD", None), ("SGD", 5.0)])
def test_one_update_matches_optax(backbone_tree, kind, clip):
    variables, grads = backbone_tree
    cfg = {"type": kind, "lr": 1e-2, "weight_decay": 0.05, "betas": [0.9, 0.99],
           "momentum": 0.8, "nesterov": True}
    tx = jo.create_optimizer(cfg, gradient_clip=clip)
    params = variables["params"]
    updates, _ = jax.jit(tx.update)(grads, jax.jit(tx.init)(params), params)
    ref = jax.jit(optax.apply_updates)(params, updates)

    module = _port_backbone(variables)
    opt = to.create_optimizer(module.parameters(), cfg, gradient_clip=clip)
    _set_grads(module, grads)
    norm = to.clip_and_step(opt, list(module.parameters()))
    assert abs(float(norm) - float(jax.jit(optax.global_norm)(grads))) <= 1e-5 * float(norm)
    if clip:
        assert float(norm) > clip  # the clip acted
    _assert_params_close(module, ref)


def test_param_group_update_with_frozen_mask_matches_optax(backbone_tree):
    variables, grads = backbone_tree
    params = variables["params"]
    jmask = jfrozen(params, 2, "b0")
    tx = jo.create_optimizer_with_param_groups(params, base_lr=1e-2, weight_decay=0.05,
                                               gradient_clip=1.0, frozen_mask=jmask)
    state = jax.jit(tx.init)(params)
    ref = params
    module = _port_backbone(variables)
    mask = frozen_stage_mask(module, 2, "b0")
    opt = to.create_optimizer_with_param_groups(module, base_lr=1e-2, weight_decay=0.05,
                                                gradient_clip=1.0, frozen_mask=mask)
    assert [g["name"] for g in opt.param_groups] == ["blocks", "head"]  # the stem is frozen
    updates, state = jax.jit(tx.update)(grads, state, ref)
    ref = jax.jit(optax.apply_updates)(ref, updates)
    _set_grads(module, grads)
    to.clip_and_step(opt, list(module.parameters()))
    _assert_params_close(module, ref)
    frozen = _flat(params)
    for k, trainable in _flat(jmask).items():
        if not trainable:
            np.testing.assert_array_equal(_flat(export_flax_variables(module)["params"])[k],
                                          frozen[k])


def test_param_labels_and_frozen_mask_match(backbone_tree):
    variables, _ = backbone_tree
    module = _port_backbone(variables)

    def by_module(d):  # port names 'block_3.bn0.weight' → 'block_3.bn0'
        out = {}
        for name, v in d.items():
            out.setdefault(name.rsplit(".", 1)[0], set()).add(v)
        return out

    def by_module_j(tree):
        out = {}
        for kp, v in jax.tree_util.tree_leaves_with_path(tree):
            out.setdefault(".".join(k.key for k in kp[:-1]), set()).add(v)
        return out

    assert by_module(param_group_labels(module)) == by_module_j(jlabels(variables["params"]))
    for stages in (0, 1, 3, 7):
        assert (by_module(frozen_stage_mask(module, stages, "b0"))
                == by_module_j(jfrozen(variables["params"], stages, "b0")))


def test_set_learning_rate_reaches_plain_optimizers_only(backbone_tree):
    variables, _ = backbone_tree
    params = variables["params"]
    # JAX: the injected rate moves in a plain chain and stays in a param-group one.
    jplain = jo.create_optimizer({"type": "AdamW", "lr": 1e-3}, gradient_clip=1.0)
    st = jo.set_learning_rate(jplain.init(params), 5e-4)
    assert jo.get_learning_rate(st) == pytest.approx(5e-4)
    jgroups = jo.create_optimizer_with_param_groups(params, base_lr=1e-3, gradient_clip=1.0)
    gst = jgroups.init(params)
    def group_rates(state):  # chain(clip, multi_transform): each group's masked AdamW
        return [float(s.inner_state.hyperparams["learning_rate"])
                for s in state[1].inner_states.values()]

    before = group_rates(gst)
    gst = jo.set_learning_rate(gst, 5e-4)
    after = group_rates(gst)
    assert before == after and jo.get_learning_rate(gst) is None

    module = _port_backbone(variables)
    plain = to.create_optimizer(module.parameters(), {"type": "AdamW", "lr": 1e-3}, 1.0)
    to.set_learning_rate(plain, 5e-4)
    assert to.get_learning_rate(plain) == 5e-4
    groups = to.create_optimizer_with_param_groups(module, base_lr=1e-3, gradient_clip=1.0)
    rates = [g["lr"] for g in groups.param_groups]
    to.set_learning_rate(groups, 5e-4)
    assert [g["lr"] for g in groups.param_groups] == rates == pytest.approx([1e-4, 5e-4, 1e-3])
    assert to.get_learning_rate(groups) is None


@pytest.mark.parametrize("cfg", [
    None, {"type": "StepLR", "step_size": 7, "gamma": 0.5},
    {"type": "CosineAnnealingLR", "T_max": 13, "eta_min": 1e-6},
    {"type": "CosineAnnealingWarmRestarts", "T_0": 10, "T_mult": 2, "eta_min_restart": 1e-6},
    {"type": "CosineAnnealingWarmRestarts", "T_0": 4, "T_mult": 1},
    {"type": "ReduceLROnPlateau", "patience": 2, "factor": 0.5},
])
def test_scheduler_sequences_match(cfg):
    js, ts = jo.create_scheduler(cfg, 1e-4), to.create_scheduler(cfg, 1e-4)
    rng = np.random.default_rng(3)
    losses = np.cumsum(rng.normal(0, 0.1, 60)) + 5
    ref = [js.step(e + 1, float(losses[e])) for e in range(60)]
    port = [ts.step(e + 1, float(losses[e])) for e in range(60)]
    assert port == ref
    again = to.create_scheduler(cfg, 1e-4)
    again.load_state_dict(js.state_dict())
    assert again.step(61, 1.0) == js.step(61, 1.0)
