"""The plain reference of a training step: EgoRear's losses, global-norm
clipping, AdamW with decoupled weight decay and the linear warm-up
schedule, written out in plain ``torch`` over a reference module
(:mod:`portbench.reference.model`). Imports nothing of the program.

* Stage 2 (``heatmap_mvf_ex``): ``w_heatmap`` x the per-view mean squared
  error, summed over views, of every heatmap stage.
* Stage 3 (``pose_3d_mvf_ex``): that plus ``w_mpjpe`` x the mean joint
  distance of every 3D stage.
* Clipping as optax's ``clip_by_global_norm``: scale by max/norm when the
  norm reaches max. A parameter that no loss reaches has a zero gradient
  (it still decays).
* AdamW (0.9, 0.999, 1e-8): p <- p - lr * wd * p - lr * m_hat / (sqrt(v_hat) + eps);
  with ``exempt_norms_and_biases``, norm parameters and biases do not decay.
* lr(t) = base * min(1, (t + 1) / warmup) * 0.1 ** (decay epochs passed).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn


def per_view_mse_sum(pred, gt):
    d2 = (pred - gt) ** 2
    return d2.mean(dim=(0,) + tuple(range(2, d2.dim()))).sum()


def mpjpe_loss(pred, gt):
    return torch.linalg.vector_norm(gt - pred, dim=-1).mean()


def loss(task: str, model: nn.Module, batch: Dict[str, torch.Tensor],
         w_heatmap: float, w_mpjpe: float) -> torch.Tensor:
    """The task's loss of ``model`` (train mode is the caller's) on ``batch``."""
    if task == "heatmap_mvf_ex":
        hms, _ = model(batch["img"])
        preds = []
    elif task == "pose_3d_mvf_ex":
        preds, hms = model(batch["img"])
    else:
        raise ValueError(task)
    total = sum(per_view_mse_sum(hm, batch["gt_heatmap"]) * w_heatmap for hm in hms)
    for p in preds:
        total = total + mpjpe_loss(p, batch["gt_pose"]) * w_mpjpe
    return total


def lr_at(step: int, base: float, warmup: int, decay_epochs: Sequence[int],
          steps_per_epoch: int) -> float:
    warm = min(1.0, (step + 1) / max(1, warmup))
    passed = sum(step >= int(e) * steps_per_epoch for e in decay_epochs)
    return base * warm * 0.1 ** passed


def decays(model: nn.Module, exempt_norms_and_biases: bool) -> Dict[str, bool]:
    """{parameter name: whether weight decay applies}."""
    out = {}
    for mname, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            key = f"{mname}.{name}" if mname else name
            exempt = isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)) or name == "bias"
            out[key] = not (exempt_norms_and_biases and exempt)
    return out


class AdamW:
    """Plain AdamW over named parameters, its moments in fp32."""

    def __init__(self, named: Dict[str, torch.Tensor], weight_decay: float,
                 decay: Dict[str, bool], betas=(0.9, 0.999), eps=1e-8):
        self.params = named
        self.wd = {k: weight_decay if decay[k] else 0.0 for k in named}
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(p) for k, p in named.items()}
        self.v = {k: torch.zeros_like(p) for k, p in named.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - lr * self.wd[k])
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if max_norm is not None and float(norm) >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm
