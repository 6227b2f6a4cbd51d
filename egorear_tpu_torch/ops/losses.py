"""Auxiliary heatmap and keypoint losses (the JAX package's
``ops/losses.py``, after the reference's ``pose_estimation/utils/loss.py``).
The shipped configs train with plain MSE; these are the alternatives the
reference ships beside it:

  * :func:`joints_mse_loss`: 0.5 x the per-joint MSE, averaged over the
    joints, with optional per-joint target weights;
  * :func:`joints_ohkm_mse_loss`: online hard keypoint mining, the mean of
    each sample's top-k per-joint losses;
  * :func:`joints_coordinate_loss`: smooth-L1 on soft-argmax coordinates;
  * :func:`wing_loss`: the log-shaped wing loss on soft-argmax coordinates.

All are differentiable torch functions of their tensor inputs.
"""

from __future__ import annotations

import math

import torch

from egorear_tpu_torch.ops.heatmap import soft_argmax_2d


def _weighted(pred, target, target_weight):
    """(B, J, H*W) views of ``pred`` and ``target``, each times its joint's
    weight when ``target_weight`` is given."""
    B, J = pred.shape[:2]
    p = pred.reshape(B, J, -1)
    t = target.reshape(B, J, -1)
    if target_weight is not None:
        w = target_weight.reshape(B, J, 1)
        p = p * w
        t = t * w
    return p, t


def joints_mse_loss(pred, target, target_weight=None):
    """(B, J, H, W) heatmaps -> scalar: 0.5 x the mean squared error of each
    joint over the batch and the map, averaged over the joints."""
    p, t = _weighted(pred, target, target_weight)
    per_joint = 0.5 * ((p - t) ** 2).mean(dim=(0, 2))  # (J,)
    return per_joint.mean()


def joints_ohkm_mse_loss(pred, target, target_weight=None, topk: int = 8):
    """Online hard keypoint mining: each sample's ``topk`` largest per-joint
    losses summed, averaged over the batch, over ``topk``."""
    p, t = _weighted(pred, target, target_weight)
    per = 0.5 * ((p - t) ** 2).mean(dim=2)  # (B, J)
    top = torch.topk(per, topk, dim=1).values
    return top.sum(dim=1).mean() / topk


def _normalized_points(pred_hm, target_pts, image_size):
    """Soft-argmax points of ``pred_hm`` and ``target_pts``, each over the
    (W, H) of ``image_size`` (H, W)."""
    pts, _ = soft_argmax_2d(pred_hm)
    size = torch.tensor([image_size[1], image_size[0]], dtype=pts.dtype,
                        device=pts.device)
    return pts / size, target_pts / size


def joints_coordinate_loss(pred_hm, target_pts, image_size=(64, 64)):
    """Smooth-L1 between the soft-argmax decode of ``pred_hm`` and
    ``target_pts`` (..., 2), both over the image size."""
    pts, tgt = _normalized_points(pred_hm, target_pts, image_size)
    d = pts - tgt
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d ** 2, ad - 0.5).mean()


def wing_loss(pred_hm, target_pts, width=5.0, curvature=0.5,
              image_size=(64, 64)):
    """Wing loss on soft-argmax coordinates: ``width * log(1 + d /
    curvature)`` below ``width``, ``d - C`` above it (C joins the pieces)."""
    pts, tgt = _normalized_points(pred_hm, target_pts, image_size)
    diff = (tgt - pts).abs()
    C = width - width * math.log(1.0 + width / curvature)
    loss = torch.where(diff < width, width * torch.log(1.0 + diff / curvature),
                       diff - C)
    return loss.mean()
