"""The port's stand-alone classification heads against the JAX package's
``models/classifier.py``, float32 on the CPU, within 1e-5.

Each head is seeded by the port, exported to its flax tree (whose keys
and shapes equal ``jax.eval_shape`` of the JAX init) and applied by both
packages to the same numpy features:

- eval mode (running statistics, no dropout): ``MLPClassifier``,
  ``AttentionClassifier`` on (B, N, D) and on (B, D) with its pooling
  weights, ``EnsembleClassifier`` with soft and with hard voting (three
  classes, so that some samples' votes tie: the winner is the first
  class, as ``jnp.argmax`` picks it);
- train mode (batch statistics, the running statistics moved with
  momentum 0.9): the same heads with dropout off on both sides (the JAX
  ensemble's rates are fixed, so the test replaces flax's ``Dropout`` by
  the identity; the package is untouched): outputs and moved statistics.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfake_vit_tpu.models import classifier as jclf
from deepfake_vit_tpu_torch.models.bridge import export_flax_variables, load_flax_variables
from deepfake_vit_tpu_torch.models.classifier import (AttentionClassifier, EnsembleClassifier,
                                                      MLPClassifier)
from deepfake_vit_tpu_torch.models.layers import init_weights

torch.set_num_threads(1)

B, N, D = 16, 5, 24
TOL = 1e-5


def _heads(kind, train):
    """(port module, JAX module, input) for one head configuration."""
    rate = 0.0 if train else 0.4
    if kind == "mlp":
        return (MLPClassifier(D, (32, 16), 2, dropout_rate=rate),
                jclf.MLPClassifier(hidden_dims=(32, 16), num_classes=2, dropout_rate=rate), 2)
    if kind.startswith("attention"):
        return (AttentionClassifier(D, 32, 2, dropout_rate=rate),
                jclf.AttentionClassifier(hidden_dim=32, num_classes=2, dropout_rate=rate),
                3 if kind == "attention" else 2)
    voting = kind.split("_")[1]
    port = EnsembleClassifier(D, num_classes=3, voting=voting)
    if train:
        for i in range(3):
            getattr(port, f"member_{i}").dropout.rate = 0.0
    return port, jclf.EnsembleClassifier(num_classes=3, voting=voting), 2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _features(ndim, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (B, N, D) if ndim == 3 else (B, D)).astype(np.float32)


def _seeded(port, jm, x, seed):
    port = init_weights(port, seed)
    tree = export_flax_variables(port)
    # Non-trivial running statistics, so that eval mode reads them.
    rng = np.random.default_rng(seed + 100)
    tree["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (rng.uniform(0.5, 1.5, s.shape) if s.min() == 1.0
                   else rng.normal(0, 0.2, s.shape)).astype(np.float32), tree["batch_stats"])
    load_flax_variables(port, tree)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    got = {k: v.shape for k, v in _flat({c: tree[c] for c in shapes}).items()}
    want = {jax.tree_util.keystr(kp, simple=True, separator="/"): v.shape
            for kp, v in jax.tree_util.tree_leaves_with_path(dict(shapes))}
    assert got == want
    return tree


@pytest.mark.parametrize("kind", ["mlp", "attention", "attention_2d", "ensemble_soft",
                                  "ensemble_hard"])
def test_heads_eval_mode_match_jax(kind):
    port, jm, ndim = _heads(kind, train=False)
    x = _features(ndim, seed=len(kind))
    tree = _seeded(port, jm, x, seed=3)
    port.eval()
    with torch.no_grad():
        if kind == "attention_2d":
            got, weights = port(torch.from_numpy(x), return_attention=True)
            ref, ref_w = jm.apply(tree, jnp.asarray(x), return_attention=True)
            assert weights.shape == (B, 1)
            np.testing.assert_allclose(weights.numpy(), np.asarray(ref_w), atol=TOL)
        else:
            got = port(torch.from_numpy(x))
            ref = jm.apply(tree, jnp.asarray(x))
    ref = np.asarray(ref)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    if kind == "ensemble_hard":
        np.testing.assert_array_equal(got.numpy(), ref)
        members = np.stack([np.asarray(jclf.MLPClassifier(
            hidden_dims=jclf._ENSEMBLE_HIDDENS[i], num_classes=3).apply(
                {c: tree[c][f"member_{i}"] for c in tree}, jnp.asarray(x))).argmax(-1)
            for i in range(3)])
        tied = [b for b in range(B) if len(set(members[:, b])) == 3]  # votes 1, 1, 1
        assert tied, "no sample's votes tie"
        assert (ref[tied].argmax(-1) == 0).all()
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["mlp", "attention", "ensemble_soft", "ensemble_hard"])
def test_heads_train_mode_match_jax(kind, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
    port, jm, ndim = _heads(kind, train=True)
    x = _features(ndim, seed=7)
    tree = _seeded(port, jm, x, seed=5)
    port.train()
    got = port(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    ref, mutated = jm.apply(tree, jnp.asarray(x), train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(0)})
    if kind == "ensemble_hard":
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    stats, ref_stats = _flat(export_flax_variables(port)["batch_stats"]), _flat(
        jax.device_get(mutated["batch_stats"]))
    assert set(stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(stats[k], ref_stats[k], atol=TOL, rtol=TOL, err_msg=k)
