"""Data parallelism over processes: the port's counterpart of the JAX
package's ``data`` mesh axis (``parallel/mesh.py``, ``train/trainer.py``).

The JAX package shards one jitted step over its devices, so a step at
global batch B on W devices is the one-device step at B: BatchNorm
statistics, dropout bits and losses are the global batch's. The port runs
one process per rank (``torch.distributed``: NCCL on CUDA, gloo on the
CPU) and keeps that contract by hand: each rank loads and runs its
contiguous B/W rows of every global batch, BatchNorm takes the global
statistics through a differentiable all-reduce (``models/backbone.py``),
dropout draws the global batch's masks and keeps its rows
(``models/layers.py``), and the trainer averages the gradients over the
ranks (``train/trainer.py``). Collectives are ``all_reduce``,
``broadcast`` and ``barrier`` only: a gather is an all-reduce into a zero
buffer, which gloo also does on CUDA tensors.

A group comes from ``torchrun``'s environment (:func:`torchrun_group`) or
from :func:`spawn`, which starts N local ranks (``--trainer.devices N``).
Rank r runs on card ``LOCAL_RANK`` (spawned: r modulo the card count).
NCCL needs a card per rank and raises otherwise; gloo lets ranks share one.

Tensor parallelism (the JAX package's ``model`` mesh axis,
``--trainer.model_parallel M``): W ranks form a (W/M data) x (M model)
grid, the model axis minor (``parallel/mesh.py``). The ranks of one data
index form a model group, which holds one replica of the model with its
wide weights sharded over it (``parallel/tensor.py``) and runs the same
rows; the ranks of one model index form a data group, over which the
batch is split and BatchNorm, dropout and the sharded leaves' gradients
are global. The model-axis collectives are the four autograd functions at
the end of this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pickle
import socket
from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from egorear_tpu_torch.utils.logging import get_logger

logger = get_logger("parallel")

# Elements per all-reduce of the flat gradients (64 MB in fp32); a larger
# gradient is reduced in place on its own.
BUCKET_NUMEL = 1 << 24


@dataclasses.dataclass(frozen=True)
class DataShard:
    """This process's place on the grid. On the data axis: ``rank`` of
    ``world`` ranks in ``group`` (None: the default group). ``active`` is
    False on a rank that the batch left idle (:func:`data_shard`);
    ``collective`` whether a process group is up, so that the trainer's
    reductions run (at world 1 too, where they are exact). On the model
    axis: ``model_rank`` of ``model_world`` ranks in ``model_group``;
    ``grid_group`` holds every active rank (None: the default group)."""

    rank: int = 0
    world: int = 1
    group: Optional[object] = None
    active: bool = True
    collective: bool = False
    model_rank: int = 0
    model_world: int = 1
    model_group: Optional[object] = None
    grid_group: Optional[object] = None

    @property
    def process_group(self):
        return dist.group.WORLD if self.group is None else self.group

    @property
    def grid_process_group(self):
        """Every active rank: the data group when there is no model axis."""
        if self.model_world == 1:
            return self.process_group
        return dist.group.WORLD if self.grid_group is None else self.grid_group

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``: the contiguous
        ``rank``-th of ``world`` equal blocks."""
        if n % self.world:
            raise ValueError(f"global batch size {n} not divisible by the "
                             f"{self.world} data-parallel ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def is_main() -> bool:
    """Rank 0, which owns the metrics, checkpoints and traces."""
    return rank() == 0


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def data_shard(batch_size: int, model_parallel: int = 1) -> DataShard:
    """This rank's place on the grid of the default group's W ranks as
    (W/M data) x (M model), M = ``model_parallel``, for a global batch of
    ``batch_size``. When the W/M data ranks do not divide the batch, the
    data axis shrinks to the first gcd(W/M, B) with the JAX package's
    warning, and the ranks past them sit idle. Every rank must call it:
    the groups are new. Raises ``ValueError`` when M does not divide W
    (one process without a group counts as W = 1)."""
    world, r = world_size(), rank()
    m_ = max(1, int(model_parallel))
    if world % m_:
        raise ValueError(f"model_parallel={m_} does not divide {world} devices")
    if not is_initialized():
        return DataShard()
    data_n = world // m_
    n = math.gcd(data_n, batch_size) if batch_size else data_n
    if n < data_n:
        logger.warning(f"data group shrunk to {n}/{data_n} ranks: global batch "
                       f"{batch_size} is not divisible by the world size; "
                       f"{(data_n - n) * m_} ranks will sit idle")
    if m_ == 1:
        if n == world:
            return DataShard(r, world, None, True, True)
        group = dist.new_group(ranks=list(range(n)))
        return DataShard(r if r < n else 0, n, group, r < n, True)
    from egorear_tpu_torch.parallel.mesh import grid_position

    # Every rank makes every group, in one order, as new_group requires.
    data_groups = [dist.new_group(ranks=[d * m_ + m for d in range(n)])
                   for m in range(m_)]
    model_groups = [dist.new_group(ranks=[d * m_ + m for m in range(m_)])
                    for d in range(n)]
    grid = None if n * m_ == world else dist.new_group(ranks=list(range(n * m_)))
    if r >= n * m_:
        return DataShard(0, n, None, False, True, 0, m_, None, grid)
    d, m = grid_position(r, m_)
    logger.info(f"grid: data={n} x model={m_}; rank {r} at ({d}, {m})")
    return DataShard(d, n, data_groups[m], True, True, m, m_, model_groups[d], grid)


def barrier(group=None) -> None:
    if is_initialized():
        dist.barrier(group=group)


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the gradient is the sum of the upstream ones."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


def all_reduce(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """The sum of ``x`` over the shard's ranks, differentiable: the
    gradient of each rank's input is the sum of every rank's upstream
    gradient (so the ranks' losses add up)."""
    return _AllReduce.apply(x, shard.process_group)


def gather(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x`` in rank order, the same on
    every rank, through an all-reduce of a zero buffer holding ``x`` in
    this rank's slot; differentiable as :func:`all_reduce`."""
    slots = [torch.zeros_like(x)[None]] * shard.world
    slots[shard.rank] = x[None]
    return all_reduce(torch.cat(slots), shard)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], shard: DataShard,
                     grid: bool = False) -> None:
    """Average ``tensors`` over the shard's data group (with ``grid``, over
    every active rank of the grid) in place, in buckets of up to
    :data:`BUCKET_NUMEL` elements of one dtype; every rank of the group
    ends with the same bits."""
    group = shard.grid_process_group if grid else shard.process_group
    n = shard.world * shard.model_world if grid else shard.world
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
        bucket.clear()

    for t in tensors:
        if t.numel() >= BUCKET_NUMEL:
            dist.all_reduce(t, group=group)
            t.div_(n)
            continue
        if bucket and (bucket[0].dtype != t.dtype or
                       sum(b.numel() for b in bucket) + t.numel() > BUCKET_NUMEL):
            flush()
        bucket.append(t)
    flush()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank of the default
    group; ``obj`` itself without a group."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _check_cards(backend: str, device_type: str, ranks_here: int) -> None:
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if backend == "nccl" and ranks_here > cards:
        raise ValueError(
            f"NCCL needs one CUDA card per rank: {ranks_here} ranks on this "
            f"host, {cards} card(s). Ask for at most {cards} devices, or "
            f"pass backend='gloo' to let ranks share a card")


def _init(backend: str, init_method: str, world: int, rank_: int,
          device: Optional[torch.device]) -> None:
    kwargs = {}
    if device is not None:
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_, **kwargs)


def torchrun_env() -> bool:
    """Whether the environment is a launcher's (``torchrun``): ``RANK``
    and ``WORLD_SIZE`` set."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


@contextlib.contextmanager
def torchrun_group(device_type: str, backend: Optional[str] = None):
    """The process group of a ``torchrun`` rank, from ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``, on
    card ``LOCAL_RANK``, for the block; destroyed after it."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    backend = backend or default_backend(device_type)
    device = None
    if device_type == "cuda":
        _check_cards(backend, device_type, local + 1)
        device = torch.device("cuda", local % torch.cuda.device_count())
    _init(backend, "env://", int(os.environ["WORLD_SIZE"]),
          int(os.environ["RANK"]), device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(index: int, nprocs: int, port: int, backend: str,
             device_type: str, fn: Callable, args: tuple, queue) -> None:
    device = None
    if device_type == "cuda":
        device = torch.device("cuda", index % torch.cuda.device_count())
    _init(backend, f"tcp://localhost:{port}", nprocs, index, device)
    try:
        # Pickled by value here: the tensors in a result outlive this process.
        queue.put((index, pickle.dumps(fn(*args))))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device: str = "cpu",
          backend: Optional[str] = None) -> list:
    """Run ``fn(*args)`` as rank r of a new ``nprocs``-rank group, one
    process each (start method ``spawn``; ``fn`` and ``args`` are pickled,
    so ``fn`` is a module-level function), on ``device``'s type, over
    ``backend`` (by default NCCL on CUDA, gloo on the CPU). Returns each
    rank's return value, in rank order; a rank's exception is raised here.
    Raises before starting anything when NCCL would put two ranks on one
    card."""
    device_type = torch.device(device).type
    backend = backend or default_backend(device_type)
    _check_cards(backend, device_type, nprocs)
    queue = mp.get_context("spawn").SimpleQueue()
    procs = mp.start_processes(
        _spawned, args=(nprocs, _free_port(), backend, device_type, fn, args,
                        queue),
        nprocs=nprocs, join=False, start_method="spawn")
    results = {}

    def drain():
        while not queue.empty():
            r, blob = queue.get()
            results[r] = pickle.loads(blob)

    while not procs.join(timeout=0.5):
        drain()
    drain()
    return [results[r] for r in range(nprocs)]


# -- the model axis -----------------------------------------------------------
#
# Within a model group every rank holds the same rows and the same
# replicated leaves, so activations outside the sharded products are
# identical across it. The four functions move activations between the
# replicated and the sharded form; a gather is an all-reduce into a zero
# buffer, as :func:`gather` does. 16-bit tensors travel in fp32 (a gather
# is exact either way; a sum is then rounded once).


def _model_all_reduce(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    wide = x.dtype in (torch.bfloat16, torch.float16)
    out = (x.float() if wide else x.clone()).contiguous()
    dist.all_reduce(out, group=shard.model_group)
    return out.to(x.dtype) if wide else out


def model_slice(x: torch.Tensor, dim: int, shard: DataShard) -> torch.Tensor:
    """This rank's contiguous 1/M block of ``x`` along ``dim``."""
    n = x.shape[dim]
    if n % shard.model_world:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} is not divisible "
                         f"by model_parallel={shard.model_world}")
    per = n // shard.model_world
    return x.narrow(dim, shard.model_rank * per, per).contiguous()


def model_all_gather(x: torch.Tensor, dim: int, shard: DataShard) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order,
    the same bits on each (not differentiable; see :func:`gather_from_model`)."""
    dim = dim % x.ndim
    slots = [torch.zeros_like(x)] * shard.model_world
    slots[shard.model_rank] = x
    return _model_all_reduce(torch.cat(slots, dim), shard)


class _CopyToModel(torch.autograd.Function):
    """Identity; the gradient is summed over the model group (each rank's
    sharded product contributes its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_all_reduce(grad, ctx.shard), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group; the gradient passes unchanged (it is the
    same on every rank). :func:`all_reduce`, the data axis's, sums the
    gradients as well, which here would scale them by M."""

    @staticmethod
    def forward(ctx, x, shard):
        return _model_all_reduce(x, shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; the gradient is this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return model_all_gather(x, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return model_slice(grad, ctx.dim, ctx.shard), None, None


class _ScatterToModel(torch.autograd.Function):
    """This rank's slice along ``dim``; the gradient is all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.dim, ctx.shard = dim, shard
        return model_slice(x, dim, shard)

    @staticmethod
    def backward(ctx, grad):
        return model_all_gather(grad, ctx.dim, ctx.shard), None, None


def copy_to_model(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    return _CopyToModel.apply(x, shard)


def reduce_from_model(x: torch.Tensor, shard: DataShard) -> torch.Tensor:
    return _ReduceFromModel.apply(x, shard)


def gather_from_model(x: torch.Tensor, dim: int, shard: DataShard) -> torch.Tensor:
    return _GatherFromModel.apply(x, dim, shard)


def scatter_to_model(x: torch.Tensor, dim: int, shard: DataShard) -> torch.Tensor:
    return _ScatterToModel.apply(x, dim, shard)
