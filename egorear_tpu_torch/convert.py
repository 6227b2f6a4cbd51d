"""Weight bridge: the JAX package's flax variables -> this port's state dict.

Input: ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays, e.g. ``jax.device_get(variables)``, or a params-only ``{"params"}``
tree: a BN-folded model's variables, or gradients (``{"params": grads}``),
which then map onto the port's parameter names.
The port's modules carry the flax module names, so a leaf's path maps to a
state-dict key one to one; only the leaf itself changes:

  * Dense / LinearParams ``kernel`` (in, out)  -> ``weight`` (out, in)
  * Conv ``kernel`` HWIO                       -> ``weight`` OIHW
  * LayerNorm / BatchNorm ``scale``            -> ``weight``
  * BatchNorm stats ``mean`` / ``var``          -> ``running_mean`` /
    ``running_var`` (plus ``num_batches_tracked``)
  * anything else (``bias``, embeddings)       -> as is

The JAX package stacks the V per-view refiners along a leading axis
(``refiners/.../kernel`` of shape (V, ...)); each slice becomes refiner
``refiners.<v>``. This module never imports JAX.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

STACKED = "refiners"  # flax subtree whose leaves carry a leading view axis


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _param(name: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 4:
            return "weight", x.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {x.ndim} has no torch layout")
    if name == "scale":
        return "weight", x
    return name, x


def _stat(name: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    return {"mean": "running_mean", "var": "running_var"}[name], x


def _unstack(path: tuple, x: np.ndarray):
    """Split a leaf under a stacked subtree into per-view (path, leaf)."""
    if STACKED not in path[:-1]:
        return [(path, x)]
    i = path.index(STACKED) + 1
    return [(path[:i] + (str(v),) + path[i:], x[v]) for v in range(x.shape[0])]


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """State dict of the port's model for the JAX package's ``variables``."""
    sd: Dict[str, torch.Tensor] = {}
    for col, leaf_fn in (("params", _param), ("batch_stats", _stat)):
        for path, x in _leaves(variables.get(col, {})):
            for p, xv in _unstack(path, x):
                name, y = leaf_fn(p[-1], xv)
                key = ".".join(p[:-1] + (name,))
                sd[key] = torch.from_numpy(np.array(y))  # a writable copy
                if name == "running_mean":
                    sd[".".join(p[:-1] + ("num_batches_tracked",))] = torch.tensor(0)
    return sd


def flax_path(model: nn.Module, key: str) -> str:
    """The JAX package's flax path (``"a/b/kernel"``) of the port's
    parameter ``key`` (``"a.b.weight"``): the inverse of :func:`from_flax`'s
    renaming, with the per-view refiner index folded back into the stacked
    ``refiners`` subtree."""
    *mods, leaf = key.split(".")
    module = model.get_submodule(".".join(mods))
    if leaf == "weight":
        if isinstance(module, (nn.LayerNorm, nn.BatchNorm2d)):
            leaf = "scale"
        elif isinstance(module, (nn.Linear, nn.Conv2d)):
            leaf = "kernel"
    if STACKED in mods[:-1]:
        i = mods.index(STACKED) + 1
        mods = mods[:i] + mods[i + 1:]
    return "/".join(mods + [leaf])


def load_flax(model: nn.Module, variables) -> nn.Module:
    """Load the JAX package's ``variables`` into ``model`` (strict: every key
    on both sides must match); values are copied into the model's dtype and
    device."""
    model.load_state_dict(from_flax(variables), strict=True)
    return model
