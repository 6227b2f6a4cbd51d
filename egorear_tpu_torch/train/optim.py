"""Optimizer and LR schedule (the JAX package's ``train/optim.py``).

  * AdamW (betas 0.9/0.999, eps 1e-8) with decoupled weight decay scaled by
    the learning rate, as optax's ``adamw`` does: torch's ``AdamW`` computes
    the same update, p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p).
  * lr(t) = base * min(1, (t + 1) / warmup) * gamma^(milestones passed),
    from step 0 (PARITY.md's warmup fix: no post-step rescale).
  * Optionally no weight decay for norm/bn/ln/bias parameters, decided on
    the flax path of each parameter, and an update scale for the encoders.
  * Global-norm clipping at optax's threshold (no epsilon on the norm).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from egorear_tpu_torch.convert import flax_path


def make_lr_schedule(base_lr: float, warmup_iters: int,
                     lr_decay_epochs: Sequence[int], steps_per_epoch: int,
                     gamma: float = 0.1):
    """lr(step) = base * min(1, (step+1)/warmup) * gamma^(#milestones passed)."""
    milestones = [int(e) * steps_per_epoch for e in lr_decay_epochs]

    def schedule(step: int) -> float:
        warm = min(1.0, (step + 1) / max(1, warmup_iters))
        return base_lr * warm * gamma ** sum(step >= m for m in milestones)

    return schedule


def _decays(path: str) -> bool:
    """True (apply decay) for a flax path that does NOT match the norm/bn/ln/
    bias name filter of the JAX package's ``_no_decay_mask``."""
    low = path.lower()
    no_decay = ("norm" in low or "bn" in low or "ln" in low or "bias" in low
                or low.endswith("/scale") or "batchnorm" in low)
    return not no_decay


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: apply weight decay}, decided on the flax path: a
    norm's torch ``weight`` is flax's ``scale``, so the torch key alone
    cannot say."""
    return {name: _decays(flax_path(model, name))
            for name, _ in model.named_parameters()}


def make_optimizer(model: nn.Module, base_lr: float, weight_decay: float,
                   no_decay_mask: bool = False,
                   encoder_lr_scale: float = 1.0) -> torch.optim.AdamW:
    """AdamW over ``model``'s parameters in groups of (decay, lr scale).

    Each group carries ``lr_scale``: the trainer sets ``lr`` to
    ``schedule(step) * lr_scale``. With ``encoder_lr_scale != 1`` every
    parameter under an ``encoder`` module has its whole update (Adam step
    and decay) scaled, as optax's ``scale`` after ``adamw`` does.
    """
    mask = decay_mask(model) if no_decay_mask else None
    groups: Dict[tuple, List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        decay = mask[name] if mask is not None else True
        scale = encoder_lr_scale if "encoder" in name.split(".") else 1.0
        groups.setdefault((decay, scale), []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "weight_decay": weight_decay if decay else 0.0,
          "lr_scale": scale, "lr": base_lr * scale}
         for (decay, scale), ps in groups.items()],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: Optional[float],
                         sharded: Sequence[torch.Tensor] = (),
                         model_group=None) -> torch.Tensor:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``,
    as optax's ``clip_by_global_norm``: by ``max_norm / norm`` when
    ``norm >= max_norm``, else not at all (``clip_grad_norm_`` would add 1e-6
    to the norm). ``sharded`` are a tensor-parallel rank's gradient slices:
    their squares are summed over ``model_group`` (every rank of it calls
    this), so the norm is the whole parameter's and every rank clips by the
    same factor; they are scaled too. Returns the norm before clipping; no
    host synchronisation."""
    norm = nn.utils.get_total_norm(grads, norm_type=2.0)
    if sharded:
        import torch.distributed as dist

        sq = nn.utils.get_total_norm(sharded, norm_type=2.0) ** 2
        dist.all_reduce(sq, group=model_group)
        norm = torch.sqrt(norm ** 2 + sq)
        grads = list(grads) + list(sharded)
    if max_norm is not None:
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        torch._foreach_mul_(list(grads), factor)
    return norm
