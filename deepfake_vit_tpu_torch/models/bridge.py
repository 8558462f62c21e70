"""Carry the JAX package's variable trees into the port's modules.

A variable tree is ``{"params": {...}, "batch_stats": {...}}`` of nested
dicts whose leaves are arrays (as ``flax.serialization.to_state_dict`` or
``utils/msgpack.py`` give them). The port's submodules carry the flax tree
keys as their names, so the walk is mechanical: each tree node names a
child module, and at a leaf layer (``Conv``, ``Dense``, ``BatchNorm``,
``LandmarkAttention``) the layer converts its own subtree — HWIO conv
kernels to OIHW, depthwise (k, k, 1, C) to (C, 1, k, k), Dense (in, out)
to (out, in), BN scale/bias/mean/var to parameters and buffers.

A module that is not a layer may hold parameters of its own that flax
keeps as bare arrays beside its submodules (the ViT's ``cls_token`` and
``pos_embed``): it names them in ``FLAX_PARAMS``, and they are copied as
they are, shape checked. A layer whose subtree holds nodes names
its keys in ``FLAX_KEYS`` (the attention's ``query``/``key``/``value``/
``out``).

Loading is strict: every leaf of the tree must land in the module and
every parameter and buffer of the module must be set.
``export_flax_variables`` is the inverse walk: each leaf layer writes its
own subtree back (``export_flax``), with the same strictness — every
parameter and buffer of the module must be written.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn


_LAYER_LEAVES = {"kernel", "bias", "scale", "attention_weights"}


def _is_tree(x: Any) -> bool:
    return isinstance(x, Mapping)


def _load(module: nn.Module, params: Mapping, stats: Mapping, path: str, loaded: set) -> None:
    if hasattr(module, "load_flax"):
        extra = set(params) - getattr(module, "FLAX_KEYS", _LAYER_LEAVES)
        if extra:
            raise KeyError(f"unexpected flax leaves under {path}: {sorted(extra)}")
        module.load_flax(params, stats)
        loaded.update(f"{path}{k}" for k, _ in module.named_parameters(recurse=False))
        loaded.update(f"{path}{k}" for k, _ in module.named_buffers(recurse=False))
        return
    for key, sub in params.items():
        if not _is_tree(sub):
            own = getattr(module, key) if key in getattr(module, "FLAX_PARAMS", ()) else None
            if own is None:
                raise KeyError(f"flax leaf {path}{key} has no layer in {type(module).__name__}")
            value = torch.from_numpy(np.array(sub, dtype=np.float32))
            if tuple(value.shape) != tuple(own.shape):
                raise ValueError(f"{path}{key}: shape {tuple(value.shape)} does not match "
                                 f"{tuple(own.shape)}")
            with torch.no_grad():
                own.copy_(value.to(own.device, own.dtype))
            loaded.add(f"{path}{key}")
            continue
        child = getattr(module, key, None)
        if not isinstance(child, nn.Module):
            raise KeyError(f"flax node {path}{key} has no submodule in {type(module).__name__}")
        _load(child, sub, stats.get(key, {}), f"{path}{key}.", loaded)
    extra = set(stats) - set(params)
    if extra:
        raise KeyError(f"batch_stats without params under {path or '<root>'}: {sorted(extra)}")


def load_flax_variables(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Copy a flax variable tree into ``module`` in place; returns it."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections: {sorted(unknown)}")
    loaded: set = set()
    _load(module, variables["params"], variables.get("batch_stats", {}), "", loaded)
    expected = {k for k, _ in module.named_parameters()} | {k for k, _ in module.named_buffers()}
    missing = expected - loaded
    if missing:
        raise KeyError(f"{len(missing)} tensors not set by the tree, e.g. {sorted(missing)[:5]}")
    return module


def _export(module: nn.Module, path: str, written: set):
    if hasattr(module, "export_flax"):
        params, stats = module.export_flax()
        written.update(f"{path}{k}" for k, _ in module.named_parameters(recurse=False))
        written.update(f"{path}{k}" for k, _ in module.named_buffers(recurse=False))
        return params, stats
    params: dict = {k: getattr(module, k).detach().float().cpu().numpy()
                    for k in getattr(module, "FLAX_PARAMS", ())}
    written.update(f"{path}{k}" for k in params)
    stats: dict = {}
    for key, child in module.named_children():
        p, s = _export(child, f"{path}{key}.", written)
        if p:
            params[key] = p
        if s:
            stats[key] = s
    return params, stats


def export_flax_variables(module: nn.Module) -> dict:
    """``module``'s variables as a flax tree ``{"params", "batch_stats"}``
    of nested dicts with numpy float32 leaves (the layout
    ``load_flax_variables`` reads)."""
    written: set = set()
    params, stats = _export(module, "", written)
    expected = {k for k, _ in module.named_parameters()} | {k for k, _ in module.named_buffers()}
    missing = expected - written
    if missing:
        raise KeyError(f"{len(missing)} tensors have no flax layer, e.g. {sorted(missing)[:5]}")
    return {"params": params, "batch_stats": stats}


def to_numpy_tree(tree: Any) -> Any:
    """Nested mapping of array-likes → nested dict of numpy arrays."""
    import numpy as np

    if _is_tree(tree):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


__all__ = ["export_flax_variables", "load_flax_variables", "to_numpy_tree"]

