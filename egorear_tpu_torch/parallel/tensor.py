"""Tensor parallelism over the model axis: the port's counterpart of the
JAX package's ``param_shardings`` placements under ``--trainer.
model_parallel M`` (``parallel/mesh.py``, ``train/trainer.py``).

:func:`shard_model` keeps, on each rank of a model group, only its 1/M
slice of every parameter that :func:`~egorear_tpu_torch.parallel.mesh.
param_placements` shards; the parameter keeps its name, so the optimizer,
its moments and the gradients hold slices too. The full model is built (or
loaded) on every rank first, so the slices are the one process's bits.

  * An ``nn.Linear`` (or :class:`~egorear_tpu_torch.models.layers.
    PointwiseConv`) whose input axis is sharded is row-parallel: its input
    is scattered over the model group, each rank multiplies its slice, the
    partial products are summed (:func:`~egorear_tpu_torch.parallel.dist.
    reduce_from_model`) and the bias is added once.
  * One whose output axis is sharded is column-parallel: the input is
    copied to every rank (the backward sums its gradient), each rank
    computes its block of outputs with its bias slice, and the blocks are
    gathered.
  * Any other sharded parameter (a refiner's stacked LayerNorm scale or
    bias, ``joint_query_embed``, a bias whose kernel is row-parallel, a
    kernel that the lazy sampling reads raw) is gathered where it is read:
    the module's attribute returns the full tensor through
    :func:`~egorear_tpu_torch.parallel.dist.gather_from_model`, whose
    backward keeps this rank's slice of the gradient.

Every rank of a model group runs the same rows, so every replicated leaf
and every activation outside the sharded products is the same on each.
:func:`full_state_dict` and :func:`load_full_state_dict` convert between
the slices and the one-process state dict (collectives over the model
group: every rank of it calls them).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from egorear_tpu_torch.models.layers import PointwiseConv
from egorear_tpu_torch.parallel import dist
from egorear_tpu_torch.parallel.mesh import TP_MIN_DIM, param_placements


class _ShardedParams:
    """Mixed into a module that holds sharded parameters: reading one of
    them as an attribute returns the full tensor, gathered over the model
    group (``_parameters`` keeps the slice, or under ``functional_call``
    what stands in for it)."""

    def __getattr__(self, name):
        dims = self.__dict__.get("_tp_dims")
        if dims is not None and name in dims:
            return dist.gather_from_model(self._parameters[name], dims[name],
                                          self._tp_shard)
        return super().__getattr__(name)


class _ParallelLinear(_ShardedParams):
    """A Linear (or PointwiseConv) whose weight is sharded: row-parallel
    when its input axis (torch dim 1) is, column-parallel when its output
    axis (dim 0) is."""

    def forward(self, x):
        shard, dims = self._tp_shard, self._tp_dims
        conv = isinstance(self, PointwiseConv)
        channel = 1 if conv else -1
        w = self._parameters["weight"]
        if conv:
            w = w[:, :, None, None]

        def product(inp, bias=None):
            return (F.conv2d(inp, w, bias) if conv else F.linear(inp, w, bias))

        def add_bias(y, b):
            if b is None:
                return y
            return y + (b[:, None, None] if conv else b)

        if dims["weight"] == 1:  # row-parallel
            y = dist.reduce_from_model(
                product(dist.scatter_to_model(x, channel, shard)), shard)
            return add_bias(y, self.bias)
        x = dist.copy_to_model(x, shard)  # column-parallel
        if "bias" in dims:
            return dist.gather_from_model(product(x, self._parameters["bias"]),
                                          channel, shard)
        return add_bias(dist.gather_from_model(product(x), channel, shard), self.bias)


_CLASSES: Dict[tuple, type] = {}


def _sharded_class(cls: type, base: type) -> type:
    key = (cls, base)
    if key not in _CLASSES:
        _CLASSES[key] = type(f"TP{cls.__name__}", (base, cls), {})
    return _CLASSES[key]


def placements(model: nn.Module) -> Dict[str, int]:
    """{parameter name: sharded torch dim} of a model that
    :func:`shard_model` sharded; empty for any other."""
    return getattr(model, "tp_placements", {})


def shard_model(model: nn.Module, shard: "dist.DataShard",
                min_dim: int = TP_MIN_DIM, shard_stacked: bool = True
                ) -> Dict[str, int]:
    """Shard ``model`` in place over ``shard``'s model group (see the
    module's docstring): each sharded parameter is replaced by a new
    parameter holding this rank's slice, under the same name. Call it
    before the optimizer is made. Returns {name: sharded torch dim}."""
    if placements(model):
        raise RuntimeError("the model is already sharded")
    dims = {k: d for k, d in param_placements(
        model, shard.model_world, min_dim, shard_stacked).items() if d is not None}
    by_module: Dict[str, Dict[str, int]] = {}
    for key, d in dims.items():
        mod, _, leaf = key.rpartition(".")
        by_module.setdefault(mod, {})[leaf] = d
    for mod_name, leaves in by_module.items():
        module = model.get_submodule(mod_name)
        for leaf, d in leaves.items():
            full = module._parameters[leaf]
            module._parameters[leaf] = nn.Parameter(
                dist.model_slice(full.detach(), d, shard),
                requires_grad=full.requires_grad)
        linear = isinstance(module, nn.Linear) and "weight" in leaves
        module.__class__ = _sharded_class(
            type(module), _ParallelLinear if linear else _ShardedParams)
        module._tp_dims = leaves
        module._tp_shard = shard
    model.tp_placements = dims
    model.tp_shard = shard
    return dims


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter gathered whole:
    the one-process state dict (a collective over the model group)."""
    sd = model.state_dict()
    dims = placements(model)
    if not dims:
        return sd
    return {k: dist.model_all_gather(v, dims[k], model.tp_shard) if k in dims else v
            for k, v in sd.items()}


def load_full_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor],
                         strict: bool = True):
    """Load a one-process state dict into a sharded (or any) model: the
    sharded entries are cut to this rank's slices."""
    dims = placements(model)
    return model.load_state_dict(
        {k: dist.model_slice(v, dims[k], model.tp_shard) if k in dims else v
         for k, v in sd.items()}, strict=strict)


def optimizer_dims(model: nn.Module, optimizer: torch.optim.Optimizer
                   ) -> Dict[int, int]:
    """{index in the optimizer's state dict: sharded dim} of the sharded
    parameters (the state dict numbers parameters in param-group order)."""
    dims = placements(model)
    if not dims:
        return {}
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: dims[names[id(p)]] for i, p in enumerate(params)
            if names.get(id(p)) in dims}


def _moments(opt_state: dict, dims: Dict[int, int], fn) -> dict:
    """``opt_state`` (an optimizer state dict) with ``fn(tensor, dim)``
    applied to the moments of the sharded parameters; the optimizer's own
    per-parameter dicts are left untouched."""
    state = dict(opt_state["state"])
    for i, d in dims.items():
        if i in state:
            state[i] = {k: fn(v, d) if torch.is_tensor(v) and v.ndim else v
                        for k, v in state[i].items()}
    return {**opt_state, "state": state}


@torch.no_grad()
def full_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer
                         ) -> dict:
    """``optimizer.state_dict()`` with the sharded parameters' moments
    gathered whole (a collective over the model group)."""
    shard: Optional[dist.DataShard] = getattr(model, "tp_shard", None)
    return _moments(optimizer.state_dict(), optimizer_dims(model, optimizer),
                    lambda v, d: dist.model_all_gather(v, d, shard))


def slice_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                          opt_state: dict) -> dict:
    """A one-process optimizer state dict cut to this rank's slices."""
    shard: Optional[dist.DataShard] = getattr(model, "tp_shard", None)
    return _moments(opt_state, optimizer_dims(model, optimizer),
                    lambda v, d: dist.model_slice(v, d, shard))
