"""What the tools share: the device rule, the card's name, and the JAX
tools' train step (``profile_train``, ``overfit_probe``)."""

from __future__ import annotations

import functools
import subprocess
from typing import Dict, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from egorear_tpu_torch.ops.metrics import mpjpe_loss
from egorear_tpu_torch.train.optim import clip_by_global_norm_
from egorear_tpu_torch.train.tasks import resolve_device
from egorear_tpu_torch.train.trainer import remat_contexts
from egorear_tpu_torch.utils import trace


def tool_device(device: Optional[str], tool: str) -> torch.device:
    """``device`` (the card when None); raises without CUDA unless the CPU
    is asked for: a tool never falls back to it."""
    return resolve_device(device, f"{tool} (--device cpu)")


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``cpu`` on the CPU), for every line that states a time."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[device.index if device.index is not None
               else torch.cuda.current_device()].strip()


class ProbeStep:
    """The JAX tools' train step on the cascade ``model`` (train mode, BN
    running stats updated): loss ``0.1 * sum_i mpjpe_loss(preds_3d[i]) +
    10 * sum_i mean((heatmaps[i] - gt_heatmap)^2)``, gradients clipped to a
    global norm of 5, then AdamW at a constant ``lr`` with optax's defaults
    (betas 0.9/0.999, eps 1e-8, weight decay 1e-4 on every parameter), as
    ``optax.chain(clip_by_global_norm(5.0), adamw(lr))``.

    With a ``precision`` that starts with ``bf16`` the forward and backward
    run on bf16 copies of the parameters and the image, as the JAX tools
    cast them (fp32 masters, optimizer state and BN running stats; the
    targets stay fp32). The step opens the program's spans as
    :meth:`~egorear_tpu_torch.train.trainer.Trainer.train_step` does
    (``train.step`` with ``train.backward``, ``train.reduce``, ``train.clip``
    and ``train.optimizer``). ``remat`` recomputes the loss's activations in
    the backward (the JAX tool's ``jax.checkpoint``).
    """

    def __init__(self, model, rig, lr: float = 1e-3,
                 precision: str = "bf16-mixed", remat: bool = False):
        self.model, self.rig = model, rig
        self.mixed = str(precision).startswith("bf16")
        self.remat = remat
        self.params = dict(model.named_parameters())
        self.optimizer = torch.optim.AdamW(
            self.params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4)

    def loss(self, img, gt_pose, gt_heatmap):
        """(total, {hm_loss, mpjpe_final, mpjpe_proposal}) of one
        train-mode forward."""
        params = None
        if self.mixed:
            params = {n: p.to(torch.bfloat16) for n, p in self.params.items()}
            img = img.to(torch.bfloat16)
        args = (img, self.rig)
        preds, hms = (self.model(*args) if params is None
                      else functional_call(self.model, params, args))
        l_pose = sum(mpjpe_loss(p, gt_pose) for p in preds) * 0.1
        l_hm = sum(((h - gt_heatmap) ** 2).mean() for h in hms) * 10.0
        aux = {"hm_loss": l_hm, "mpjpe_final": mpjpe_loss(preds[-1], gt_pose),
               "mpjpe_proposal": mpjpe_loss(preds[0], gt_pose)}
        return (l_pose + l_hm).float(), aux

    def __call__(self, img, gt_pose, gt_heatmap) -> Dict[str, torch.Tensor]:
        """One step; returns the loss and the :meth:`loss` terms (0-d,
        detached, not synchronised)."""
        with trace.span("train.step"):
            return self._step(img, gt_pose, gt_heatmap)

    def _step(self, img, gt_pose, gt_heatmap):
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if self.remat:  # BN stats updated once, as jax.checkpoint's
            gen = torch.Generator(device=img.device)
            loss, aux = checkpoint(
                self.loss, img, gt_pose, gt_heatmap, use_reentrant=False,
                context_fn=functools.partial(remat_contexts, self.model, gen))
        else:
            loss, aux = self.loss(img, gt_pose, gt_heatmap)
        with trace.span("train.backward"):
            loss.backward()
        with trace.span("train.reduce"):
            grads = []
            for p in self.params.values():
                if p.grad is None:  # optax sees a zero gradient
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
        with trace.span("train.clip"):
            clip_by_global_norm_(grads, 5.0)
        with trace.span("train.optimizer"):
            self.optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach().float() for k, v in aux.items()}}
