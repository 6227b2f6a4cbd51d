"""The tensor-parallel placement rule: the port's copy of the JAX package's
``parallel/mesh.py`` (``make_mesh``, ``leaf_sharding``), over ranks
instead of devices.

W ranks form a (W/M data) x (M model) grid with the model axis minor, as
``make_mesh`` reshapes its devices to ``(n // M, M)``: rank r sits at
``(d, m) = (r // M, r % M)``. The few wide weights (the proposal MLP's
32768-wide input, the JQA heatmap projections' 4096-wide input at 256 px)
are sharded over the model axis on their widest dimension; everything else
is replicated.

The rule is a function of a leaf's shape in the JAX package's flax tree,
where a Dense kernel is (in, out) and the V per-view refiners are stacked
along a leading axis. :func:`param_placements` maps each parameter of the
port (``nn.Linear.weight`` is (out, in); refiner v is its own module) to
its flax path and shape, applies the rule there and maps the chosen axis
back to the port's tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch.nn as nn

from egorear_tpu_torch.convert import STACKED, flax_path

# Leaves at least this wide are sharded over the model axis.
TP_MIN_DIM = 2048


def grid_position(rank: int, model_parallel: int) -> Tuple[int, int]:
    """(data index, model index) of ``rank`` on the grid: the model axis
    is minor."""
    return rank // model_parallel, rank % model_parallel


def leaf_axis(shape: Sequence[int], model_parallel: int,
              min_dim: int = TP_MIN_DIM, shard_stacked: bool = True
              ) -> Optional[int]:
    """The axis of a flax leaf of ``shape`` that the model axis shards, or
    None (replicated): ``leaf_sharding``'s rule. Only 2-D leaves shard, and
    3-D ones with ``shard_stacked``; a 3-D leaf never shards its leading
    axis. The candidate axes are taken widest first by a stable sort (on a
    tie the earlier axis, a kernel's input, wins); the first that is at
    least ``min_dim`` and divisible by ``model_parallel`` is sharded."""
    ndims = (2, 3) if shard_stacked else (2,)
    if model_parallel <= 1 or len(shape) not in ndims:
        return None
    lead = len(shape) - 2
    for axis in sorted(range(lead, len(shape)), key=lambda a: -shape[a]):
        if shape[axis] >= min_dim and shape[axis] % model_parallel == 0:
            return axis
    return None


def _flax_leaf(model: nn.Module, key: str, shape: Sequence[int]
              ) -> Tuple[str, Tuple[int, ...], bool, bool]:
    """The flax path and shape of the port's parameter ``key`` of torch
    ``shape``, whether the leaf is stacked over the refiners' views (its
    flax shape then leads with V) and whether it is a kernel (transposed
    between the two layouts)."""
    *mods, leaf = key.split(".")
    module = model.get_submodule(".".join(mods))
    shape = tuple(shape)
    kernel = leaf == "weight" and isinstance(module, (nn.Linear, nn.Conv2d))
    if kernel:
        # Dense (out, in) -> (in, out); Conv OIHW -> HWIO.
        shape = shape[::-1] if len(shape) == 2 else shape[2:] + shape[1::-1]
    stacked = STACKED in mods[:-1]
    if stacked:
        i = mods.index(STACKED)
        views = len(model.get_submodule(".".join(mods[:i + 1])))
        shape = (views,) + shape
    return flax_path(model, key), shape, stacked, kernel


def param_placements(model: nn.Module, model_parallel: int,
                     min_dim: int = TP_MIN_DIM, shard_stacked: bool = True
                     ) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dimension the model axis shards, or
    None} for every parameter of ``model``, by :func:`leaf_axis` on its
    flax leaf. A stacked refiner leaf sharded on flax axis a shards each
    view's tensor on axis a - 1; a Dense kernel's flax axis 0 (in) is
    torch dim 1. Raises ``ValueError`` when the rule would shard the view
    axis of a stacked leaf (a ``min_dim`` no wider than V)."""
    out: Dict[str, Optional[int]] = {}
    for key, p in model.named_parameters():
        path, shape, stacked, kernel = _flax_leaf(model, key, p.shape)
        axis = leaf_axis(shape, model_parallel, min_dim, shard_stacked)
        if axis is not None and stacked:
            if axis == 0:
                raise ValueError(
                    f"tp_min_dim={min_dim} shards the view axis of {path} "
                    f"{shape}: each view's refiner must stay whole")
            axis -= 1
        if axis is not None and kernel:  # only a 2-D kernel shards
            axis = 1 - axis
        out[key] = axis
    return out
