"""One training step and one eval step (the JAX package's
``train/trainer.py``, ``init_state`` and ``train_step``/``eval_step``).

A train step: the task's loss on the batch in train mode (BN takes batch
statistics and updates its fp32 running stats), backward, global-norm
clipping, AdamW with the scheduled lr, ``step += 1``.

``precision``, read as the JAX package's trainer reads it:
  * ``"32"`` and ``"32-true"``: fp32 throughout.
  * every string that starts with ``"bf16"`` (``"bf16-mixed"``, ``"bf16"``,
    ``"bf16-true"``): the JAX package's explicit casts. The forward and
    backward run on bf16 copies of the parameters (cast inside the graph, so
    the gradients arrive on the fp32 masters in fp32) and of the batch's
    fp32 tensors; BN running stats stay fp32 buffers; the optimizer state
    and the master weights are fp32. ``torch.autocast`` is not used: it
    would keep other ops in fp32 than JAX does.
  * anything else raises. A conscious fix: the JAX package trains fp32
    for every other string, so ``"16-mixed"``, ``"16"`` or ``"64"`` would
    run in another precision than the name says.

The trainer is generic over the three tasks (``train/tasks.py``): it calls
``task.loss(batch, params, generator)``, ``task.eval_metrics`` and
``task.predict_outputs``. Its :meth:`~Trainer.state_dict` (model, optimizer,
step) is what the port's checkpoints hold (``train/checkpoint.py``).

The loops (the JAX package's ``fit``, ``evaluate`` and ``predict``) run on
datasets through :class:`~egorear_tpu_torch.data.loader.DataLoader`, on the
device of the task's model, with the settings of a :class:`TrainerConfig`
(:meth:`Trainer.from_config`): an epoch loop with the schedule placed by
the loader's length, ``train/<k>`` rows in a Lightning-layout
``metrics.csv`` (:class:`CSVLogger`), validation and ``epoch=N.pt``
checkpoints at their cadences, resume, a non-finite guard
(``debug_nans``) and a ``torch.profiler`` trace of the first
``profile_steps`` steps, with the program's spans of those steps
(:mod:`egorear_tpu_torch.utils.trace`).

Dropout (``ffn_drop``, ``mlp_dropout``) draws its masks in each step from a
generator on the model's device seeded from ``seed + 1`` and the step count
(:func:`dropout_seed`, the counterpart of the JAX package's
``fold_in(PRNGKey(seed + 1), step)``): deterministic, and a resumed run
continues the same stream. The bits differ from JAX's threefry.

Data-parallel over a process group (:mod:`egorear_tpu_torch.parallel.dist`,
the JAX package's ``data`` mesh axis): a W-rank step at global batch B is
the one-process step at B up to reduction order. Each rank runs its B/W
rows (``batch_size`` is the global batch; W ranks that do not divide it
shrink to gcd(W, B), the others idle, as the JAX mesh shrinks), BatchNorm
and dropout act on the global batch (:func:`~egorear_tpu_torch.models.
layers.data_parallel`), and the gradients, zero-filled, are averaged over
the ranks in buckets before clipping, so every rank's replica stays
bitwise the same. The logged loss terms are averaged over the ranks.
Rank 0 owns ``metrics.csv``, the checkpoints and the profiler trace; the
others wait for each checkpoint at a barrier. ``evaluate`` gathers the
per-sample metrics into global order and returns the same dict on every
rank; ``predict`` runs on rank 0 alone.

Tensor-parallel over the model axis (``model_parallel`` M > 1, the JAX
package's ``--trainer.model_parallel``): the ranks form a (W/M data) x (M
model) grid (:func:`~egorear_tpu_torch.parallel.dist.data_shard`); the
``data`` axis above is the data group's, and each model group holds one
replica with the leaves of :func:`~egorear_tpu_torch.parallel.mesh.
param_placements` (``tp_min_dim``, ``tp_shard_stacked``) sharded over it
(:func:`~egorear_tpu_torch.parallel.tensor.shard_model`, before the
optimizer exists, so the moments are slices too). A step averages the
sharded leaves' gradients over the data group and the replicated ones over
the whole grid (so that the replicas stay bitwise the same across a model
group even where a card's kernels sum in a varying order), and clips by
the norm of the whole parameter: the slices' squares are summed over the
model group, the replicated leaves count once. :meth:`Trainer.state_dict`
gathers the sharded leaves and moments whole, so ``epoch=N.pt`` is the
one-process format; :meth:`Trainer.load_state_dict` slices it.
``evaluate`` runs each data group's rows on its model group; ``predict``
runs on rank 0's model group and rank 0 writes.

``remat`` (the JAX package's ``jax.checkpoint(loss_fn)``) runs the task's
loss under ``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward. The recompute replays the forward exactly:
BatchNorm does not update its running stats a second time and dropout
draws from the generator's state at the forward's start
(:func:`remat_contexts`), so a step with ``remat`` is the step without.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import functools
import glob
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from egorear_tpu_torch.data.loader import DataLoader
from egorear_tpu_torch.models.backbone import BatchNorm2d
from egorear_tpu_torch.models.layers import data_parallel
from egorear_tpu_torch.parallel import dist, tensor
from egorear_tpu_torch.parallel.mesh import TP_MIN_DIM
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.optim import (
    clip_by_global_norm_,
    make_lr_schedule,
    make_optimizer,
)
from egorear_tpu_torch.utils import trace
from egorear_tpu_torch.utils.logging import get_logger

logger = get_logger("trainer")

# The fp32 strings; every string that starts with "bf16" trains bf16-mixed.
FP32_PRECISIONS = ("32", "32-true")


def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed for ``step`` of a run seeded ``seed``:
    one 64-bit word of numpy's SeedSequence of ``(seed + 1, step)``."""
    words = np.random.SeedSequence([seed + 1, step]).generate_state(2, np.uint32)
    return int(words[0]) << 32 | int(words[1])


@dataclasses.dataclass
class TrainerConfig:
    """The trainer settings of a config (the JAX package's
    ``TrainerConfig``). ``devices`` is the number of ranks that
    ``run.main`` starts (None: one per card, as the JAX package takes every
    device); ``model_parallel`` the size of the model axis that shards the
    leaves of at least ``tp_min_dim`` (with ``tp_shard_stacked``, the
    stacked refiner kernels too; ``parallel/mesh.py``)."""

    max_epochs: int = 12
    check_val_every_n_epoch: int = 1
    log_every_n_steps: int = 400
    gradient_clip_val: Optional[float] = 5.0
    precision: str = "32"
    seed: int = 42
    save_dir: str = "./logs/default"
    ckpt_every_n_epochs: int = 1
    devices: Optional[int] = None  # None: every card
    model_parallel: int = 1
    tp_min_dim: int = TP_MIN_DIM
    tp_shard_stacked: bool = True
    profile_steps: int = 0  # torch.profiler trace of the first N steps
    debug_nans: bool = False  # stop at the first non-finite loss
    auto_resume: bool = False  # resume from the newest checkpoint in save_dir
    remat: bool = False
    encoder_lr_scale: float = 1.0  # update scale of the encoder subtrees

    def __post_init__(self):
        self.precision = str(self.precision)
        if not (self.precision in FP32_PRECISIONS or self.mixed):
            raise ValueError(f"precision must be one of {FP32_PRECISIONS} or "
                             f"start with 'bf16', got {self.precision!r}")

    @property
    def mixed(self) -> bool:
        """bf16-mixed training, as the JAX package's trainer decides it."""
        return self.precision.startswith("bf16")


class _NullLogger:
    """The metric sink of ranks other than 0."""

    dir = None

    def log(self, metrics, step, epoch):
        pass


class CSVLogger:
    """Lightning-CSVLogger-layout metric sink:
    ``<save_dir>/lightning_logs/version_<n>/metrics.csv`` with the first free
    ``n``; columns ``epoch``, ``step`` and every metric in order of first
    appearance. Rows are appended; the file is rewritten whole only when a
    new metric widens the header."""

    def __init__(self, save_dir: str):
        base = os.path.join(save_dir, "lightning_logs")
        os.makedirs(base, exist_ok=True)
        n = 0
        while os.path.exists(os.path.join(base, f"version_{n}")):
            n += 1
        self.dir = os.path.join(base, f"version_{n}")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fieldnames = ["epoch", "step"]
        self._rows = []
        self._flushed = 0  # rows already on disk

    def log(self, metrics: Dict[str, float], step: int, epoch: int):
        row = {"epoch": epoch, "step": step}
        row.update({k: float(v) for k, v in metrics.items()})
        new_fields = [k for k in row if k not in self._fieldnames]
        self._fieldnames.extend(new_fields)
        self._rows.append(row)
        self._flush(rewrite=bool(new_fields) and self._flushed > 0)

    def _flush(self, rewrite: bool = False):
        if rewrite or self._flushed == 0:
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                w.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writerows(self._rows[self._flushed:])
        self._flushed = len(self._rows)


def _array_batch(batch: dict) -> dict:
    """``batch`` without its host-only fields (lists, strings and
    ``__valid_n__``)."""
    return {k: v for k, v in batch.items()
            if not isinstance(v, (list, str)) and k != "__valid_n__"}


def _sorted(metrics: dict) -> dict:
    """``metrics`` in key order: the order of the JAX package's metric
    dicts (a pytree's), so the CSV columns and the printed JSON match."""
    return dict(sorted(metrics.items()))


def remat_contexts(model: torch.nn.Module, gen: torch.Generator):
    """``context_fn`` of the rematerialised loss: the forward records the
    dropout generator's state; the recompute restores it, so that dropout
    draws the same masks, and sets every BatchNorm's ``replay``, so that
    the running stats are updated once (the generator's state after the
    forward and the flags are restored after it)."""
    start = {}

    @contextlib.contextmanager
    def forward():
        start["gen"] = gen.get_state()
        yield

    @contextlib.contextmanager
    def recompute():
        bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
        after = gen.get_state()
        gen.set_state(start["gen"])
        for m in bns:
            m.replay = True
        try:
            yield
        finally:
            for m in bns:
                del m.replay
            gen.set_state(after)

    return forward(), recompute()


def no_decay_mask_for(task_name: str, encoder_lr_scale: float = 1.0) -> bool:
    """Whether norms and biases are exempt from weight decay: for the
    stage-3 task at ``encoder_lr_scale`` 1 only, as the JAX package's
    ``run.py`` builds its trainer."""
    return task_name == "pose_3d_mvf_ex" and encoder_lr_scale == 1.0


class Trainer:
    def __init__(self, task, lr: float, weight_decay: float,
                 lr_decay_epochs: Sequence[int], warmup_iters: int,
                 precision: str = "32",
                 gradient_clip_val: Optional[float] = 5.0,
                 no_decay_mask: bool = False, encoder_lr_scale: float = 1.0,
                 batch_size: int = 32, workers: int = 8,
                 config: Optional[TrainerConfig] = None):
        # The one home of the trainer's settings: ``config`` (from_config's)
        # or the defaults with the arguments above.
        self.cfg = config or TrainerConfig(precision=precision,
                                           gradient_clip_val=gradient_clip_val,
                                           encoder_lr_scale=encoder_lr_scale)
        self.task = task
        self.lr = lr
        self.weight_decay = weight_decay
        self.lr_decay_epochs = tuple(lr_decay_epochs or ())
        self.warmup_iters = warmup_iters
        self.no_decay_mask = no_decay_mask
        self.batch_size = batch_size
        self.workers = workers
        self.optimizer = None
        self.lr_schedule = None
        self.step = 0
        # This rank's place on the grid and share of the global batch (the
        # one process: all of it).
        mp = max(1, int(self.cfg.model_parallel or 1))
        self.shard = dist.data_shard(batch_size, mp)
        if mp > 1:
            if self.cfg.tp_shard_stacked:
                logger.info(f"tp_shard_stacked with model_parallel={mp}: 3-D "
                            f"stacked refiner kernels shard over the 'model' axis")
            if self.shard.active:
                dims = tensor.shard_model(task.model, self.shard,
                                          self.cfg.tp_min_dim,
                                          self.cfg.tp_shard_stacked)
                logger.info(f"{len(dims)} leaves sharded over the model axis")
        self._dropout_gen = None
        self.logger = None
        # (epoch, steps, seconds) of each epoch that fit ran.
        self.epoch_times = []

    @classmethod
    def from_config(cls, task, cfg: TrainerConfig, **kwargs) -> "Trainer":
        """A trainer whose settings, loops' included, are ``cfg``'s;
        ``kwargs`` are the constructor's optimizer and loader arguments."""
        return cls(task, config=cfg, **kwargs)

    @property
    def precision(self) -> str:
        return self.cfg.precision

    @property
    def gradient_clip_val(self) -> Optional[float]:
        return self.cfg.gradient_clip_val

    @property
    def encoder_lr_scale(self) -> float:
        return self.cfg.encoder_lr_scale

    @property
    def mixed(self) -> bool:
        return self.cfg.mixed

    @property
    def is_main(self) -> bool:
        """Rank 0 (the one process included): metrics, checkpoints, traces."""
        return dist.is_main()

    @property
    def device(self) -> torch.device:
        """The device of the task's model, where the loops put batches."""
        return next(self.task.model.parameters()).device

    def init_state(self, steps_per_epoch: int) -> None:
        """Optimizer and schedule for ``steps_per_epoch``; step counter 0.
        The parameters are the task model's (fp32 masters)."""
        self.lr_schedule = make_lr_schedule(
            self.lr, self.warmup_iters, self.lr_decay_epochs, steps_per_epoch)
        self.optimizer = make_optimizer(
            self.task.model, self.lr, self.weight_decay,
            no_decay_mask=self.no_decay_mask,
            encoder_lr_scale=self.encoder_lr_scale)
        self.step = 0

    def state_dict(self) -> dict:
        """Model (parameters and BN buffers), optimizer state and step, in
        the one-process format: tensor-parallel, the sharded leaves and
        their moments are gathered whole (every rank of the model group
        calls it)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) first")
        model = self.task.model
        return {"model": tensor.full_state_dict(model),
                "optimizer": tensor.full_optimizer_state(model, self.optimizer),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output, from any device, into the
        live model and optimizer, strictly: the model's tensors are copied
        in place, the moments land on their parameter's device and AdamW's
        step counts on the host, where the optimizer keeps them.
        Tensor-parallel, each rank keeps its slices of the sharded leaves
        and moments."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) first")
        model = self.task.model
        tensor.load_full_state_dict(model, state["model"], strict=True)
        opt = tensor.slice_optimizer_state(model, self.optimizer,
                                           state["optimizer"])
        self.optimizer.load_state_dict({
            "state": {i: {k: v.cpu() if torch.is_tensor(v) else v
                          for k, v in s.items()} for i, s in opt["state"].items()},
            "param_groups": opt["param_groups"]})
        self.step = int(state["step"])

    def _cast(self, batch: dict) -> dict:
        if not self.mixed:
            return batch
        return {k: v.to(torch.bfloat16)
                if torch.is_tensor(v) and v.dtype == torch.float32 else v
                for k, v in batch.items()}

    def dropout_generator(self) -> torch.Generator:
        """The generator of this step's dropout masks, on the model's device,
        seeded by :func:`dropout_seed` from the config's seed and the step."""
        if self._dropout_gen is None or self._dropout_gen.device != self.device:
            self._dropout_gen = torch.Generator(device=self.device)
        return self._dropout_gen.manual_seed(dropout_seed(self.cfg.seed, self.step))

    def train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (data-parallel: this rank's rows
        of the global batch); returns the loss terms of this step's forward
        (data-parallel: averaged over the data group) and the lr it used
        (0-d tensors, not synchronised). The step is the program's
        ``train.step`` span (its item the step count) with the children
        ``forward``, ``train.backward``, ``train.reduce`` (the zero-fill
        and the all-reduce), ``train.clip`` and ``train.optimizer``."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) first")
        if not self.shard.active:
            raise RuntimeError("this rank is idle: the global batch leaves it "
                               "no rows")
        with trace.span("train.step", item=self.step):
            return self._train_step(batch)

    def _train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        model = self.task.model.train()
        named = dict(model.named_parameters())
        gen = self.dropout_generator()

        def loss_fn(batch):
            params = None
            if self.mixed:
                params = {n: p.to(torch.bfloat16) for n, p in named.items()}
            return self.task.loss(self._cast(batch), params, gen)

        self.optimizer.zero_grad(set_to_none=True)
        # The backward too: a rematerialised forward runs again inside it.
        with data_parallel(model, self.shard if self.shard.world > 1 else None):
            if self.cfg.remat:
                loss, metrics = checkpoint(
                    loss_fn, batch, use_reentrant=False,
                    context_fn=functools.partial(remat_contexts, model, gen))
            else:
                loss, metrics = loss_fn(batch)
            with trace.span("train.backward"):
                loss.float().backward()
        # A parameter that no path reaches gets grad None, and AdamW would
        # then skip its moments and its weight decay; optax sees a zero grad.
        # Zero-filled before the average, so every rank reduces the same
        # buffers (a zero averages to zero).
        with trace.span("train.reduce"):
            sharded = tensor.placements(model)
            grads, slices = [], []
            for n, p in named.items():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                (slices if n in sharded else grads).append(p.grad)
            if self.shard.collective:
                dist.all_reduce_mean_(grads, self.shard, grid=True)
                dist.all_reduce_mean_(slices, self.shard)
        with trace.span("train.clip"):
            clip_by_global_norm_(grads, self.gradient_clip_val, slices,
                                 self.shard.model_group)
        with trace.span("train.optimizer"):
            lr = self.lr_schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group["lr_scale"]
            self.optimizer.step()
        self.step += 1
        out = {k: v.detach().float() for k, v in metrics.items()}
        if self.shard.collective:  # the global batch's loss terms
            terms = torch.stack(list(out.values()))
            dist.all_reduce_mean_([terms], self.shard)
            out = dict(zip(out, terms.unbind()))
        out["lr"] = torch.tensor(lr, dtype=torch.float32)
        return out

    def eval_step(self, batch: dict, test_mode: bool = False
                  ) -> Dict[str, torch.Tensor]:
        """Per-sample eval metrics with the fp32 master weights, BN in eval
        mode (running stats)."""
        return self.task.eval_metrics(batch, test_mode=test_mode)

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def _loader(self, dataset, **kwargs) -> DataLoader:
        return DataLoader(dataset, self.batch_size, num_workers=self.workers,
                          **kwargs)

    def _barrier(self) -> None:
        """Wait for the other active ranks."""
        if self.shard.collective:
            dist.barrier(self.shard.grid_process_group)

    def _save(self, subdir: str, epoch: int) -> None:
        """Rank 0 writes ``epoch=N.pt`` under the log directory's
        ``subdir``; tensor-parallel, every rank first gathers its model
        group's state (:meth:`state_dict`). The active ranks then meet."""
        if self.is_main or tensor.placements(self.task.model):
            state = self.state_dict()
            if self.is_main:
                ckpt_lib.save(os.path.join(self.logger.dir, subdir), epoch, state)
        self._barrier()

    def _resume_dir(self, resume_dir: Optional[str]) -> Optional[str]:
        """``resume_dir``, or with ``auto_resume`` the newest
        ``lightning_logs/version_*/checkpoints`` under ``save_dir``."""
        if resume_dir is None and self.cfg.auto_resume:
            candidates = sorted(glob.glob(os.path.join(
                self.cfg.save_dir, "lightning_logs", "version_*", "checkpoints")))
            resume_dir = candidates[-1] if candidates else None
        return resume_dir

    def _profiler(self):
        """A started ``torch.profiler`` session for the first
        ``profile_steps`` steps (the CPU and, on a card, CUDA activities);
        None when not asked for."""
        if not self.cfg.profile_steps:
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        logger.info(f"profiling {self.cfg.profile_steps} steps -> "
                    f"{os.path.join(self.logger.dir, 'profile')}")
        return prof

    def _stop_profiler(self, prof) -> None:
        """Stop the session; write its ``trace.json`` and the program's
        spans (``spans.json``) under ``profile/`` and log their table."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        out = os.path.join(self.logger.dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        spans = trace.collected()
        trace.write(os.path.join(out, "spans.json"), spans)
        logger.info("profiler trace captured; the program's spans:\n"
                    + trace.report(spans))

    def fit(self, train_dataset, val_dataset=None, resume_dir=None):
        """Train for ``max_epochs`` over shuffled ``drop_last`` batches
        (the loader's ``seed`` is the config's, reshuffled each epoch).

        Logs ``train/<k>`` (the step's loss terms and lr) every
        ``log_every_n_steps`` steps and after each epoch's last, validates
        (:meth:`evaluate`, mode ``val``) every ``check_val_every_n_epoch``
        epochs, and saves ``epoch=N.pt`` every ``ckpt_every_n_epochs``
        epochs and after the last, in ``<version dir>/checkpoints``.
        Resumes after the newest checkpoint of ``resume_dir`` (or, with
        ``auto_resume``, of the newest version under ``save_dir``). With
        ``debug_nans`` a non-finite first loss term saves the state to
        ``checkpoints-nan`` and raises ``FloatingPointError``.

        Data-parallel, rank 0 writes the metrics, checkpoints and trace,
        and the active ranks meet at a barrier after each checkpoint; a rank
        that the batch leaves idle returns at once.
        """
        cfg = self.cfg
        if not self.shard.active:
            return self
        self.logger = self.logger or (CSVLogger(cfg.save_dir) if self.is_main
                                      else _NullLogger())
        loader = self._loader(train_dataset, shuffle=True, drop_last=True,
                              seed=cfg.seed, device=self.device,
                              shard=self.shard)
        steps_per_epoch = len(loader)
        if steps_per_epoch == 0:
            raise ValueError("train dataset smaller than one batch")
        if self.optimizer is None:
            self.init_state(steps_per_epoch)

        start_epoch = 0
        resume_dir = self._resume_dir(resume_dir)
        if resume_dir:
            state, epoch0 = ckpt_lib.restore_latest(resume_dir,
                                                    map_location=self.device)
            if state is not None:
                self.load_state_dict(state)
                start_epoch = epoch0 + 1
                logger.info(f"resumed from epoch {epoch0}")

        prof = self._profiler() if self.is_main else None
        profile_left = cfg.profile_steps
        for epoch in range(start_epoch, cfg.max_epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            running = {}
            steps = 0
            for batch in self._waited(loader):
                metrics = _sorted(self.train_step(_array_batch(batch)))
                steps += 1
                if prof is not None:
                    profile_left -= 1
                    if profile_left == 0:
                        self._stop_profiler(prof)
                        prof = None
                if cfg.debug_nans:
                    first_loss = next(iter(metrics.values()))
                    if not bool(torch.isfinite(first_loss)):
                        self._save("checkpoints-nan", epoch)
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}; state saved")
                if self.step % cfg.log_every_n_steps == 0:
                    with trace.span("fit.log", item=self.step):
                        self._log_train(metrics, epoch)
                running = metrics
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.epoch_times.append((epoch, steps, dt))
            if self.is_main:
                logger.info(f"epoch {epoch} done in {dt:.1f}s "
                            f"({steps / max(dt, 1e-9):.2f} it/s)")
            if running:
                self._log_train(running, epoch, quiet=True)

            if val_dataset is not None and (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                with trace.span("fit.val", item=self.step):
                    val_metrics = self._evaluate(val_dataset, mode="val")
                self.logger.log(val_metrics, self.step, epoch)
                if self.is_main:
                    logger.info(f"epoch {epoch} val: " + " ".join(
                        f"{k}={v:.4f}" for k, v in list(val_metrics.items())[:8]))

            if ((epoch + 1) % cfg.ckpt_every_n_epochs == 0
                    or epoch == cfg.max_epochs - 1):
                with trace.span("fit.ckpt", item=self.step):
                    self._save("checkpoints", epoch)
        if prof is not None:  # fewer steps than profile_steps
            self._stop_profiler(prof)
        return self

    def _waited(self, loader):
        """The loader's batches, each wait for one the program's top-level
        ``fit.wait`` span (its item the step the batch feeds)."""
        batches = iter(loader)
        while True:
            with trace.span("fit.wait", item=self.step):
                batch = next(batches, None)
            if batch is None:
                return
            yield batch

    def _log_train(self, metrics: Dict[str, torch.Tensor], epoch: int,
                   quiet: bool = False) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        self.logger.log({f"train/{k}": v for k, v in values.items()},
                        self.step, epoch)
        if not quiet and self.is_main:
            logger.info(f"epoch {epoch} step {self.step}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in values.items()))

    def evaluate(self, dataset, mode: str = "test") -> Dict[str, float]:
        """The task's per-sample metrics averaged over ``dataset``, as
        ``{mode}/{k}``. The last batch is padded to the batch size by
        repeating its last sample (static shapes, as the JAX package); only
        its first ``__valid_n__`` samples count. ``mode == "test"`` turns on
        the task's test-mode metrics. Data-parallel, each rank evaluates its
        rows (tensor-parallel, each model group its data rank's rows), the
        per-sample metrics are gathered over the data group into the global
        batch's order, and every rank returns the same dict (an idle rank
        gets rank 0's)."""
        metrics = self._evaluate(dataset, mode) if self.shard.active else None
        if self.shard.world < dist.world_size():
            metrics = dist.broadcast_object(metrics)
        return metrics

    def _gather(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The per-sample metrics of the global batch, in its order, from
        every rank's rows (a 0-d metric counts as the same value for each of
        this rank's rows)."""
        n = max(v.shape[0] for v in metrics.values() if v.ndim)
        rows = torch.stack([v.float().expand(n) if v.ndim == 0 else v.float()
                            for v in metrics.values()])
        every = dist.gather(rows, self.shard)  # (world, metrics, n)
        return dict(zip(metrics, every.transpose(0, 1).reshape(len(metrics), -1)))

    def _evaluate(self, dataset, mode: str) -> Dict[str, float]:
        loader = self._loader(dataset, shuffle=False, drop_last=False,
                              pad_last=True, device=self.device,
                              shard=self.shard)
        sums: Dict[str, float] = {}
        count = 0
        for batch in loader:
            n = batch["__valid_n__"]
            metrics = _sorted(self.eval_step(_array_batch(batch),
                                             test_mode=mode == "test"))
            if self.shard.collective:
                metrics = self._gather(metrics)
            for k, v in metrics.items():
                v = v.float().cpu().numpy()
                if v.ndim == 0:  # a scalar: weighted by the true count
                    sums[k] = sums.get(k, 0.0) + float(v) * n
                else:
                    sums[k] = sums.get(k, 0.0) + float(v[:n].sum())
            count += n
        return {f"{mode}/{k}": v / max(count, 1) for k, v in sums.items()}

    def predict(self, dataset, out_dir: str, save_obj: bool = False) -> str:
        """Run the task's ``predict_outputs`` over ``dataset`` and save
        ``<out_dir>/predictions.npz``: its outputs (pose3d: ``final`` and
        ``proposal`` poses; the heatmap stages: heatmaps and decoded 2D
        anchors) with the samples' ``frame_path``. The last batch is padded
        to the batch size and cut back. With ``save_obj`` each ``final``
        pose is also written as a skeleton mesh ``pose_<i>.obj``.
        Data-parallel, rank 0 predicts the whole dataset and writes; the
        other ranks return None at once. Tensor-parallel, rank 0's model
        group predicts together and rank 0 writes."""
        if not (self.is_main or (self.shard.active and self.shard.rank == 0
                                 and self.shard.model_world > 1)):
            return None
        loader = self._loader(dataset, shuffle=False, drop_last=False)
        collected: Dict[str, list] = {}
        paths = []
        for batch in loader:
            arr = _array_batch(batch)
            n = next(iter(arr.values())).shape[0]
            if n < self.batch_size:
                arr = {k: torch.cat([v, v[-1:].expand(self.batch_size - n,
                                                      *v.shape[1:])])
                       for k, v in arr.items()}
            arr = {k: v.to(self.device) for k, v in arr.items()}
            for k, v in self.task.predict_outputs(arr).items():
                collected.setdefault(k, []).append(v.cpu().numpy()[:n])
            paths.extend(batch.get("frame_path", [""] * n)[:n])
        if not self.is_main:
            return None
        os.makedirs(out_dir, exist_ok=True)
        stacked = {k: np.concatenate(v) for k, v in collected.items()}
        if not stacked and hasattr(self.task, "rig"):  # pose3d on no data
            stacked = {"final": np.zeros((0, 16, 3)),
                       "proposal": np.zeros((0, 16, 3))}
        out_path = os.path.join(out_dir, "predictions.npz")
        np.savez(out_path, frame_path=np.array(paths, dtype=object), **stacked)
        if save_obj and "final" in stacked:
            from egorear_tpu_torch.utils.skeleton import export_pose_obj

            for i, pose in enumerate(stacked["final"]):
                export_pose_obj(os.path.join(out_dir, f"pose_{i:06d}.obj"), pose)
        n_saved = len(next(iter(stacked.values()))) if stacked else 0
        logger.info(f"saved {n_saved} predictions to {out_path}")
        return out_path
