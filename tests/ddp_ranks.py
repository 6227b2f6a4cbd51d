"""What the ranks of the data-parallel tests run (``tests/test_torch_port_
ddp.py``), in processes that ``egorear_tpu_torch.parallel.dist.spawn``
starts: JAX-free, so that each rank imports only torch and the port.

A spec is a dict: the task name, its model config and constructor
keywords, the path of the port state dict it starts from, the global batch
(numpy) or a dataset's arrays, the trainer's settings (``batch_size`` the
global batch), and whether the step runs in fp64.
"""

from __future__ import annotations

import copy
import hashlib
import logging
import os

import numpy as np
import torch

from egorear_tpu_torch.data.loader import DataLoader
from egorear_tpu_torch.models.layers import Dropout
from egorear_tpu_torch.parallel import dist
from egorear_tpu_torch.train.tasks import TASKS
from egorear_tpu_torch.train.trainer import Trainer


def build(spec: dict):
    """The spec's task (on the CPU, its state loaded, fp64 if asked) and
    its trainer, state initialised; ``batch_size`` is the global batch."""
    task = TASKS[spec["task"]](copy.deepcopy(spec["cfg"]), device="cpu",
                               **spec.get("kw", {}))
    task.model.load_state_dict(torch.load(spec["state"], weights_only=True))
    if spec.get("fp64"):
        task.model.double()
    trainer = Trainer(task, spec["lr"], spec["wd"], spec["decay"], spec["warmup"],
                      precision="32", gradient_clip_val=5.0,
                      no_decay_mask=spec["task"] == "pose_3d_mvf_ex",
                      batch_size=spec["batch_size"],
                      workers=1, **spec.get("trainer_kw", {}))
    trainer.init_state(steps_per_epoch=1)
    return task, trainer


def state_hash(model: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in key order."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def take_step(spec: dict, trainer, rows=slice(None)) -> dict:
    """One train step on ``rows`` of the spec's batch. Returns the loss
    terms, the state's hash, the masks of every dropout call (True where
    an element was dropped) and, as numpy, the step's (averaged, clipped)
    gradients, the updated parameters and the BN running stats."""
    task = trainer.task
    dtype = torch.float64 if spec.get("fp64") else torch.float32
    batch = {k: torch.from_numpy(np.asarray(v[rows])) for k, v in spec["batch"].items()}
    batch = {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}
    masks = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: masks.append((out == 0).numpy()))
        for m in task.model.modules() if isinstance(m, Dropout) and m.p > 0]
    metrics = trainer.train_step(batch)
    for h in hooks:
        h.remove()
    named = dict(task.model.named_parameters())
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        hash=state_hash(task.model), masks=masks,
        grads={k: p.grad.numpy().copy() for k, p in named.items()},
        params={k: p.detach().numpy().copy() for k, p in named.items()},
        stats={k: v.numpy().copy() for k, v in task.model.state_dict().items()
               if "running" in k or "num_batches" in k})


class ArrayDataset:
    """Items ``{k: arrays[k][i]}``; records every index it loads."""

    def __init__(self, arrays: dict):
        self.arrays = arrays
        self.loaded = []

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, i):
        self.loaded.append(int(i))
        return {k: v[i] for k, v in self.arrays.items()}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _saved(out: dict, path: str) -> str:
    """``out`` pickled to ``path`` (a rank's large results go by file)."""
    torch.save(out, path)
    return path


def two_ranks(plan: dict) -> dict:
    """A rank of the two-rank test group: each step of ``plan["steps"]``
    (rank 0 keeps the arrays, in a file under ``plan["out"]``; every rank
    its masks, loss terms and state hash), the loader's rows, a one-epoch
    ``fit`` of ``plan["fit"]`` on its dataset (indices loaded, the final
    state's hash) and ``evaluate`` of ``plan["eval"]``."""
    torch.set_num_threads(1)
    rank = dist.rank()
    out = {"steps": {}}
    for name, spec in plan["steps"].items():
        task, trainer = build(spec)
        res = take_step(spec, trainer, trainer.shard.rows(trainer.batch_size))
        if rank == 0:
            res["file"] = _saved({k: res.pop(k) for k in ("grads", "params", "stats")},
                                 os.path.join(plan["out"], f"{name}.pt"))
        else:
            for k in ("grads", "params", "stats"):
                res.pop(k)
        out["steps"][name] = res

    # The loader: the global index sequence, this rank's rows of each batch.
    spec = plan["loader"]
    ds = ArrayDataset(spec["arrays"])
    loader = DataLoader(ds, spec["batch_size"], shuffle=True, drop_last=True,
                        num_workers=2, seed=spec["seed"],
                        shard=dist.data_shard(spec["batch_size"]))
    loader.set_epoch(spec["epoch"])
    out["loader"] = dict(batches=[b["idx"].reshape(-1).tolist() for b in loader],
                         loaded=sorted(ds.loaded))

    spec = plan["fit"]
    task, trainer = build(spec)
    trainer.cfg.max_epochs, trainer.cfg.save_dir = 1, spec["save_dir"]
    trainer.cfg.log_every_n_steps = 1
    ds = ArrayDataset(spec["dataset"])
    trainer.fit(ds)
    out["fit"] = dict(loaded=len(ds.loaded), hash=state_hash(task.model),
                      step=trainer.step,
                      log_dir=trainer.logger.dir)
    if rank == 0:
        out["fit"]["file"] = _saved(
            {k: v.clone() for k, v in task.model.state_dict().items()},
            os.path.join(plan["out"], "fit_state.pt"))

    spec = plan["eval"]
    task, trainer = build(spec)
    out["eval"] = trainer.evaluate(ArrayDataset(spec["dataset"]), mode="test")
    return out


def three_ranks(plan: dict) -> dict:
    """A rank of the three-rank group at global batch 4: the data group it
    gets (and the warning), one step on rank 0 (the data group's only
    rank, on the whole batch), ``fit`` (idle ranks return at once) and
    ``evaluate`` (every rank returns rank 0's dict)."""
    torch.set_num_threads(1)
    records = _Records()
    logging.getLogger("egorear_torch.parallel").addHandler(records)
    task, trainer = build(plan["step"])
    shard = trainer.shard
    out = dict(shard=(shard.rank, shard.world, shard.active),
               warnings=list(records.messages))
    if shard.active:
        out["step"] = take_step(plan["step"], trainer)["hash"]
    else:
        try:
            trainer.train_step({})
        except RuntimeError as e:
            out["step"] = str(e)
        trainer.fit(ArrayDataset(plan["step"]["batch"]))
        out["fit_step"] = trainer.step
    task, trainer = build(plan["eval"])
    out["eval"] = trainer.evaluate(ArrayDataset(plan["eval"]["dataset"]), mode="test")
    return out
