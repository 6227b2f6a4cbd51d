"""What the ranks of the tensor-parallel tests run (``tests/test_torch_port_
tp.py``), in processes that ``egorear_tpu_torch.parallel.dist.spawn``
starts: JAX-free, so that each rank imports only torch and the port.

A step spec is ``ddp_ranks``'s (task, model config, constructor keywords,
start state, global batch, optimizer settings, fp64) plus ``clip`` (the
trainer's ``gradient_clip_val``) and ``parallel`` (``model_parallel``,
``tp_min_dim``, ``tp_shard_stacked``, ``remat``: :class:`TrainerConfig`
fields).
"""

from __future__ import annotations

import copy
import hashlib
import os

import numpy as np
import torch
import torch.nn as nn

from egorear_tpu_torch.models.layers import PointwiseConv, layer_norm
from egorear_tpu_torch.parallel import dist, tensor
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.tasks import TASKS
from egorear_tpu_torch.train.trainer import Trainer, TrainerConfig

import ddp_ranks

# -- the layers ---------------------------------------------------------------

LAYER_MIN_DIM = 8


class Block(nn.Module):
    """One 'refiner': its leaves are stacked in the flax tree, so a (8,)
    bias or LayerNorm scale is a 2-D (1, 8) leaf there and shards."""

    def __init__(self):
        super().__init__()
        self.col = nn.Linear(4, 8)  # kernel (1, 4, 8): output axis; bias too
        self.row = nn.Linear(8, 8)  # (1, 8, 8): a tie, the input axis; bias gathered
        self.norm = layer_norm(8)  # scale and bias gathered
        self.embed = nn.Parameter(torch.empty(3, 8))  # (1, 3, 8): gathered


class LayerNet(nn.Module):
    """Every kind of sharded leaf at ``tp_min_dim`` LAYER_MIN_DIM."""

    def __init__(self):
        super().__init__()
        self.lin_row = nn.Linear(8, 4)  # kernel (8, 4): row-parallel
        self.conv_row = PointwiseConv(8, 4)  # row-parallel on channels
        self.conv_col = PointwiseConv(4, 8)  # column-parallel, bias replicated
        self.refiners = nn.ModuleList([Block()])

    def forward(self, x, fmap):
        blk = self.refiners[0]
        y = blk.col(self.lin_row(x))  # (N, 8)
        y = blk.norm(blk.row(torch.tanh(y))) + blk.embed.sum(0)
        return y, self.conv_col(torch.tanh(self.conv_row(fmap)))


LAYER_PLACEMENTS = {"lin_row.weight": 1, "conv_row.weight": 1, "conv_col.weight": 0,
                    "refiners.0.col.weight": 0, "refiners.0.col.bias": 0,
                    "refiners.0.row.weight": 1, "refiners.0.row.bias": 0,
                    "refiners.0.norm.weight": 0, "refiners.0.norm.bias": 0,
                    "refiners.0.embed": 1}


def layer_case(seed: int = 0):
    """LayerNet in fp64 with random weights, its inputs and the upstream
    gradients of its two outputs."""
    gen = torch.Generator().manual_seed(seed)
    net = LayerNet().double()
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float64))
    x = torch.randn(5, 8, generator=gen, dtype=torch.float64)
    fmap = torch.randn(2, 8, 3, 3, generator=gen, dtype=torch.float64)
    ups = (torch.randn(5, 8, generator=gen, dtype=torch.float64),
           torch.randn(2, 8, 3, 3, generator=gen, dtype=torch.float64))
    return net, x, fmap, ups


def layer_pass(net, x, fmap, ups) -> dict:
    """Outputs, the inputs' gradients and every parameter's gradient (the
    sharded ones gathered whole) of one forward and backward."""
    x, fmap = x.clone().requires_grad_(), fmap.clone().requires_grad_()
    outs = net(x, fmap)
    sum((o * u).sum() for o, u in zip(outs, ups)).backward()
    dims = tensor.placements(net)
    shard = getattr(net, "tp_shard", None)
    grads = {n: dist.model_all_gather(p.grad, dims[n], shard) if n in dims else p.grad
             for n, p in net.named_parameters()}
    return dict(outs=[o.detach() for o in outs], dx=x.grad, dfmap=fmap.grad,
                grads=grads, placements=dict(dims),
                slices={n: tuple(p.shape) for n, p in net.named_parameters()})


# -- the steps ----------------------------------------------------------------


def build(spec: dict, **cfg_kw):
    """The spec's task (on the CPU, its full start state loaded, fp64 if
    asked) and its trainer (sharded by ``spec["parallel"]``), state
    initialised."""
    task = TASKS[spec["task"]](copy.deepcopy(spec["cfg"]), device="cpu",
                               **spec.get("kw", {}))
    task.model.load_state_dict(torch.load(spec["state"], weights_only=True))
    if spec.get("fp64"):
        task.model.double()
    config = TrainerConfig(precision="32", gradient_clip_val=spec["clip"],
                           **spec.get("parallel", {}), **cfg_kw)
    trainer = Trainer(task, spec["lr"], spec["wd"], spec["decay"], spec["warmup"],
                      no_decay_mask=spec["task"] == "pose_3d_mvf_ex",
                      batch_size=spec["batch_size"], workers=1, config=config)
    trainer.init_state(steps_per_epoch=1)
    return task, trainer


def local_hash(model: nn.Module, sharded: bool) -> str:
    """sha256 of this rank's replicated entries of the state dict (or, with
    ``sharded``, of its slices), in key order."""
    dims = tensor.placements(model)
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if (k in dims) == sharded:
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def take_step(spec: dict, trainer) -> dict:
    """One step on this rank's rows of the spec's batch: the loss terms,
    the hashes of the replicated entries and of the slices, and (numpy)
    the step's clipped gradients, the updated parameters and BN running
    stats, the sharded ones gathered whole."""
    task = trainer.task
    dtype = torch.float64 if spec.get("fp64") else torch.float32
    rows = trainer.shard.rows(spec["batch_size"])
    batch = {k: torch.from_numpy(np.asarray(v[rows])) for k, v in spec["batch"].items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    metrics = trainer.train_step(batch)
    model = task.model
    dims = tensor.placements(model)
    grads = {n: dist.model_all_gather(p.grad, dims[n], trainer.shard) if n in dims
             else p.grad for n, p in model.named_parameters()}
    full = tensor.full_state_dict(model)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        replicated=local_hash(model, False), slices=local_hash(model, True),
        placements=dict(dims),
        grads={k: g.numpy().copy() for k, g in grads.items()},
        params={k: full[k].numpy().copy() for k, _ in model.named_parameters()},
        stats={k: v.numpy().copy() for k, v in full.items()
               if "running" in k or "num_batches" in k})


def _slices(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()}


def _equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def ranks(plan: dict) -> dict:
    """A rank of a tensor-parallel test group: the grid that a global batch
    of 1 shrinks to (``plan["shrink"]``), the layers (``plan["layers"]``),
    then each step of ``plan["steps"]`` (rank 0 writes its arrays to a file
    under ``plan["out"]``; every rank returns its loss terms, hashes and
    grid place). With ``plan["checkpoint"]`` (a step spec), after one step:
    ``state_dict`` written as ``epoch=0.pt`` by rank 0, loaded back into a
    fresh trainer (its slices bitwise the stepped trainer's) and restored
    by ``fit`` with ``auto_resume`` (the same slices, no step taken)."""
    torch.set_num_threads(1)
    rank = dist.rank()
    out = {"steps": {}}
    if plan.get("shrink"):  # global batch 1 on a (W/2 x 2) grid: one data rank
        s = dist.data_shard(1, 2)
        out["shrink"] = (s.rank, s.world, s.active, s.model_rank, s.model_world)
    if plan.get("layers"):
        net, x, fmap, ups = layer_case()
        tensor.shard_model(net, dist.data_shard(1, dist.world_size()), LAYER_MIN_DIM)
        out["layers"] = layer_pass(net, x, fmap, ups)
    for name, spec in plan["steps"].items():
        task, trainer = build(spec)
        res = take_step(spec, trainer)
        res["grid"] = (trainer.shard.rank, trainer.shard.world,
                       trainer.shard.model_rank, trainer.shard.model_world)
        arrays = {k: res.pop(k) for k in ("grads", "params", "stats")}
        if rank == 0:
            res["file"] = ddp_ranks._saved(arrays, os.path.join(plan["out"], f"{name}.pt"))
        out["steps"][name] = res
        del task, trainer
    spec = plan.get("checkpoint")
    if spec:
        task, trainer = build(spec)
        take_step(spec, trainer)
        want = _slices(task.model)
        want_opt = copy.deepcopy(trainer.optimizer.state_dict()["state"])
        state = trainer.state_dict()
        root = os.path.join(plan["out"], "ckpt")
        ckpt_dir = os.path.join(root, "lightning_logs", "version_0", "checkpoints")
        if rank == 0:
            out["ckpt"] = ckpt_lib.save(ckpt_dir, 0, state)
        dist.barrier()
        task2, fresh = build(spec)
        fresh.load_state_dict(ckpt_lib.restore(os.path.join(ckpt_dir, "epoch=0.pt")))
        opt = fresh.optimizer.state_dict()["state"]
        out["loaded_bitwise"] = _equal(_slices(task2.model), want) and all(
            _equal({k: v for k, v in opt[i].items()},
                   {k: v for k, v in want_opt[i].items()}) for i in want_opt)
        task3, resumed = build(spec, auto_resume=True, save_dir=root, max_epochs=1)
        resumed.fit(ddp_ranks.ArrayDataset(spec["batch"]))
        out["resumed"] = dict(step=resumed.step,
                              bitwise=_equal(_slices(task3.model), want))
    return out
