"""Flax parameter tree -> the port's state_dict.

``flax_to_state_dict`` takes the JAX package's variables as a nested dict of
numpy arrays (``jax.tree.map(np.asarray, variables)``), so this module never
imports JAX. The port names its submodules after the Flax scopes, so a
parameter's path is its state_dict key with '/' replaced by '.'; what changes
on the way:

  * conv kernels HWIO / DHWIO become OIHW / OIDHW;
  * transposed-conv kernels (scope ``ConvTranspose_*``) are flipped in space
    and become (I, O, *k), the layout under which torch's conv_transpose
    reproduces flax's dilated-input geometry (nn.blocks.ConvTranspose);
  * BatchNorm statistics are stored debiased: acc / (1 - 0.9**count), and
    identity statistics (mean 0, var 1) when count == 0, as the JAX modules
    read them in eval mode (mvs_tpu.nn.blocks.Norm); ``count`` is carried
    across, so train-mode updates continue the JAX EMA.

``load_flax_npz`` reads the JAX variables from an ``.npz`` whose keys are
'/'-joined Flax paths (``params/...``, ``batch_stats/...``), the form a JAX
checkpoint is exported to (README.md); ``load_weights`` reads either that
or the port's own ``torch.save``d state_dict (``.pt``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "load_flax_npz", "load_weights"]

_MOMENTUM = np.float32(0.9)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _kernel(path, k: np.ndarray) -> np.ndarray:
    rank = k.ndim - 2
    if len(path) > 1 and path[-2].startswith("ConvTranspose"):
        k = np.flip(k, axis=tuple(range(rank)))
        return k.transpose(rank, rank + 1, *range(rank))
    return k.transpose(rank + 1, rank, *range(rank))


def flax_to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of numpy arrays -> state_dict."""
    state = {}
    for path, value in _flatten(variables.get("params", {})):
        if path[-1] == "kernel":
            value = _kernel(path, value)
        state[".".join(path)] = value
    stats: dict[tuple, dict] = {}
    for path, value in _flatten(variables.get("batch_stats", {})):
        stats.setdefault(path[:-1], {})[path[-1]] = value
    for scope, s in stats.items():
        count = np.float32(s["count"])
        denom = np.maximum(np.float32(1.0) - _MOMENTUM ** count,
                           np.float32(1e-8))
        never = count < 0.5
        mean = np.zeros_like(s["mean"]) if never else s["mean"] / denom
        var = np.ones_like(s["var"]) if never else s["var"] / denom
        state[".".join(scope + ("mean",))] = mean
        state[".".join(scope + ("var",))] = var
        state[".".join(scope + ("count",))] = count
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in state.items()}


def load_flax_npz(path) -> dict:
    """An .npz of '/'-joined Flax paths -> the nested variables dict."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *scopes, leaf = key.split("/")
            node = tree
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = data[key]
    return tree


def load_weights(path) -> dict[str, torch.Tensor]:
    """A state_dict from a JAX-variables .npz or a torch .pt file."""
    if Path(path).suffix == ".npz":
        return flax_to_state_dict(load_flax_npz(path))
    return torch.load(path, map_location="cpu", weights_only=True)
