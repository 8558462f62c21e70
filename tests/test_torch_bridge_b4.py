"""The headline classifier at full width: the JAX package's EfficientNet-B4
tree (initialized with PRNGKey(0), as bench.py does) carried into the
port's module, every tensor checked; and the port's config dict held equal
to the YAML config it replaces."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from deepfake_vit_tpu.models.feature_extractor import create_model_from_config as jcreate
from deepfake_vit_tpu_torch.configs import MODEL_CONFIG
from deepfake_vit_tpu_torch.models.bridge import load_flax_variables, to_numpy_tree
from deepfake_vit_tpu_torch.models.feature_extractor import create_model_from_config
from deepfake_vit_tpu_torch.utils.msgpack import tree_shapes

torch.set_num_threads(1)


def test_config_dict_matches_yaml():
    with open("deepfake_vit_tpu/configs/model_config.yaml") as f:
        cfg = yaml.safe_load(f)
    assert MODEL_CONFIG["model"] == cfg["model"]


def test_full_b4_tree_carries_across():
    jm = jcreate(MODEL_CONFIG["model"])
    # Parameter shapes do not depend on the face size: init at 32² to keep
    # the CPU trace small.
    variables = to_numpy_tree(jax.jit(jm.init)(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 5, 2))))
    shapes = tree_shapes(variables)
    assert shapes["params/feature_extractor/backbone/head_conv/kernel"] == (1, 1, 448, 1792)
    assert shapes["params/head_0/dense/kernel"] == (1792, 512)
    assert sum(1 for k in shapes if k.startswith("params/feature_extractor/backbone/block_")
               and k.endswith("depthwise_conv/kernel")) == 32

    port = load_flax_variables(create_model_from_config(MODEL_CONFIG["model"]), variables)
    state = port.state_dict()
    n_params = sum(int(np.prod(s)) for k, s in shapes.items() if k.startswith("params/"))
    assert n_params == sum(p.numel() for p in port.parameters())

    def flax_view(path):
        """The flax leaf a port tensor came from, in the port's layout."""
        *mods, leaf = path.split(".")
        coll, key = {"weight": ("params", None), "bias": ("params", "bias"),
                     "running_mean": ("batch_stats", "mean"),
                     "running_var": ("batch_stats", "var"),
                     "attention_weights": ("params", "attention_weights")}[leaf]
        node = variables[coll]
        for m in mods:
            node = node[m]
        if key is not None:
            return node[key]
        if "kernel" not in node:  # BatchNorm weight
            return node["scale"]
        k = node["kernel"]
        return k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1)

    for path, tensor in state.items():
        np.testing.assert_array_equal(tensor.numpy(), flax_view(path), err_msg=path)
    # Depthwise (k, k, 1, C) kernels land as (C, 1, k, k).
    assert tuple(port.feature_extractor.backbone.block_31.depthwise_conv.weight.shape) == (
        shapes["params/feature_extractor/backbone/block_31/depthwise_conv/kernel"][3], 1, 3, 3)
