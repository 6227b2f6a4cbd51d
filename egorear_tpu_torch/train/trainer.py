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
``task.loss(batch, params)`` and ``task.eval_metrics``. Its
:meth:`~Trainer.state_dict` (model, optimizer, step) is what the port's
checkpoints hold (``train/checkpoint.py``).

Not ported yet: ``fit``, CSV logging, the non-finite guard, ``remat``, and
dropout at a non-zero rate (which raises).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from egorear_tpu_torch.train.optim import (
    clip_by_global_norm_,
    make_lr_schedule,
    make_optimizer,
)

PRECISIONS = ("32", "bf16-mixed")


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
                 no_decay_mask: bool = False, encoder_lr_scale: float = 1.0):
        if str(precision) not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
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
        self.precision = str(precision)
        self.gradient_clip_val = gradient_clip_val
        self.no_decay_mask = no_decay_mask
        self.encoder_lr_scale = encoder_lr_scale
        self.optimizer = None
        self.lr_schedule = None
        self.step = 0

    @property
    def mixed(self) -> bool:
        return self.precision == "bf16-mixed"

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
