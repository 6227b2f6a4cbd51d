"""One training step and one eval step (the JAX package's
``train/trainer.py``, ``init_state`` and ``train_step``/``eval_step``).

A train step: the task's loss on the batch in train mode (BN takes batch
statistics and updates its fp32 running stats), backward, global-norm
clipping, AdamW with the scheduled lr, ``step += 1``.

``precision``:
  * ``"32"``: fp32 throughout.
  * ``"bf16-mixed"``: the JAX package's explicit casts. The forward and
    backward run on bf16 copies of the parameters (cast inside the graph, so
    the gradients arrive on the fp32 masters in fp32) and of the batch's
    fp32 tensors; BN running stats stay fp32 buffers; the optimizer state
    and the master weights are fp32. ``torch.autocast`` is not used: it
    would keep other ops in fp32 than JAX does.

The trainer is generic over the three tasks (``train/tasks.py``): it calls
``task.loss(batch, params)``, ``task.eval_metrics`` and
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
``profile_steps`` steps.

Not ported: ``remat``, more than one device, and dropout at a non-zero
rate (all raise).
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from egorear_tpu_torch.data.loader import DataLoader
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.optim import (
    clip_by_global_norm_,
    make_lr_schedule,
    make_optimizer,
)
from egorear_tpu_torch.utils.logging import get_logger

logger = get_logger("trainer")

PRECISIONS = ("32", "bf16-mixed")


@dataclasses.dataclass
class TrainerConfig:
    """The trainer settings of a config (the JAX package's
    ``TrainerConfig``, less its TPU mesh knobs). One device only:
    ``devices`` > 1, ``model_parallel`` > 1 and ``remat`` raise."""

    max_epochs: int = 12
    check_val_every_n_epoch: int = 1
    log_every_n_steps: int = 400
    gradient_clip_val: Optional[float] = 5.0
    precision: str = "32"
    seed: int = 42
    save_dir: str = "./logs/default"
    ckpt_every_n_epochs: int = 1
    devices: Optional[int] = None  # None: the one device
    model_parallel: int = 1
    profile_steps: int = 0  # torch.profiler trace of the first N steps
    debug_nans: bool = False  # stop at the first non-finite loss
    auto_resume: bool = False  # resume from the newest checkpoint in save_dir
    remat: bool = False
    encoder_lr_scale: float = 1.0  # update scale of the encoder subtrees

    def __post_init__(self):
        self.precision = str(self.precision)
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{self.precision!r}")
        if self.devices is not None and self.devices > 1:
            raise NotImplementedError(
                f"devices={self.devices}: data parallelism over several GPUs "
                f"(DDP) is not ported (ROADMAP Queue A, DDP over NCCL)")
        if self.model_parallel > 1:
            raise NotImplementedError(
                f"model_parallel={self.model_parallel}: tensor parallelism is "
                f"not ported (ROADMAP Queue A, DDP over NCCL: the model "
                f"axis is not queued)")
        if self.remat:
            raise NotImplementedError(
                "remat: activation rematerialisation is not ported (ROADMAP "
                "Queue A, tools and leftovers)")


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
                 batch_size: int = 32, workers: int = 8):
        # The one home of the trainer's settings; from_config replaces it.
        self.cfg = TrainerConfig(precision=precision,
                                 gradient_clip_val=gradient_clip_val,
                                 encoder_lr_scale=encoder_lr_scale)
        dropouts = [m.p for m in task.model.modules()
                    if isinstance(m, nn.Dropout) and m.p > 0]
        if dropouts:
            raise NotImplementedError(f"dropout rates {dropouts} > 0 are not "
                                      f"ported for training")
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
        self.logger = None
        # (epoch, steps, seconds) of each epoch that fit ran.
        self.epoch_times = []

    @classmethod
    def from_config(cls, task, cfg: TrainerConfig, **kwargs) -> "Trainer":
        """A trainer whose settings, loops' included, are ``cfg``'s;
        ``kwargs`` are the constructor's optimizer and loader arguments."""
        trainer = cls(task, precision=cfg.precision,
                      gradient_clip_val=cfg.gradient_clip_val,
                      encoder_lr_scale=cfg.encoder_lr_scale, **kwargs)
        trainer.cfg = cfg
        return trainer

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
        return self.precision == "bf16-mixed"

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
        """Model (parameters and BN buffers), optimizer state and step."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) first")
        return {"model": self.task.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s output, from any device, into the
        live model and optimizer, strictly: the model's tensors are copied
        in place, the moments land on their parameter's device and AdamW's
        step counts on the host, where the optimizer keeps them."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) first")
        self.task.model.load_state_dict(state["model"], strict=True)
        opt = state["optimizer"]
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

    def train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; returns the loss terms of this
        step's forward and the lr it used (0-d tensors, not synchronised)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state(steps_per_epoch) first")
        model = self.task.model.train()
        named = dict(model.named_parameters())
        params = None
        if self.mixed:
            params = {n: p.to(torch.bfloat16) for n, p in named.items()}
        loss, metrics = self.task.loss(self._cast(batch), params)
        self.optimizer.zero_grad(set_to_none=True)
        loss.float().backward()
        # A parameter that no path reaches gets grad None, and AdamW would
        # then skip its moments and its weight decay; optax sees a zero grad.
        grads = []
        for p in named.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        clip_by_global_norm_(grads, self.gradient_clip_val)
        lr = self.lr_schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.optimizer.step()
        self.step += 1
        out = {k: v.detach().float() for k, v in metrics.items()}
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
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        out = os.path.join(self.logger.dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("profiler trace captured")

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
        """
        cfg = self.cfg
        self.logger = self.logger or CSVLogger(cfg.save_dir)
        loader = self._loader(train_dataset, shuffle=True, drop_last=True,
                              seed=cfg.seed, device=self.device)
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

        prof = self._profiler()
        profile_left = cfg.profile_steps
        for epoch in range(start_epoch, cfg.max_epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            running = {}
            steps = 0
            for batch in loader:
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
                        ckpt_lib.save(os.path.join(self.logger.dir, "checkpoints-nan"),
                                      epoch, self.state_dict())
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}; state saved")
                if self.step % cfg.log_every_n_steps == 0:
                    self._log_train(metrics, epoch)
                running = metrics
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.epoch_times.append((epoch, steps, dt))
            logger.info(f"epoch {epoch} done in {dt:.1f}s "
                        f"({steps / max(dt, 1e-9):.2f} it/s)")
            if running:
                self._log_train(running, epoch, quiet=True)

            if val_dataset is not None and (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                val_metrics = self.evaluate(val_dataset, mode="val")
                self.logger.log(val_metrics, self.step, epoch)
                logger.info(f"epoch {epoch} val: " + " ".join(
                    f"{k}={v:.4f}" for k, v in list(val_metrics.items())[:8]))

            if ((epoch + 1) % cfg.ckpt_every_n_epochs == 0
                    or epoch == cfg.max_epochs - 1):
                ckpt_lib.save(os.path.join(self.logger.dir, "checkpoints"), epoch,
                              self.state_dict())
        if prof is not None:  # fewer steps than profile_steps
            self._stop_profiler(prof)
        return self

    def _log_train(self, metrics: Dict[str, torch.Tensor], epoch: int,
                   quiet: bool = False) -> None:
        values = {k: float(v) for k, v in metrics.items()}
        self.logger.log({f"train/{k}": v for k, v in values.items()},
                        self.step, epoch)
        if not quiet:
            logger.info(f"epoch {epoch} step {self.step}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in values.items()))

    def evaluate(self, dataset, mode: str = "test") -> Dict[str, float]:
        """The task's per-sample metrics averaged over ``dataset``, as
        ``{mode}/{k}``. The last batch is padded to the batch size by
        repeating its last sample (static shapes, as the JAX package); only
        its first ``__valid_n__`` samples count. ``mode == "test"`` turns on
        the task's test-mode metrics."""
        loader = self._loader(dataset, shuffle=False, drop_last=False,
                              pad_last=True, device=self.device)
        sums: Dict[str, float] = {}
        count = 0
        for batch in loader:
            n = batch["__valid_n__"]
            metrics = _sorted(self.eval_step(_array_batch(batch),
                                             test_mode=mode == "test"))
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
        pose is also written as a skeleton mesh ``pose_<i>.obj``."""
        loader = self._loader(dataset, shuffle=False, drop_last=False)
        os.makedirs(out_dir, exist_ok=True)
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
