"""Heatmap decoding and target rendering (the JAX package's
``ops/heatmap.py``: ``argmax_2d``, ``render_gaussian_targets`` and its
numpy twin)."""

from __future__ import annotations

import numpy as np
import torch


def argmax_2d(heatmaps: torch.Tensor, threshold: float = 0.5,
              normalize: bool = False):
    """Decode per-channel peak locations from heatmaps.

    Args:
      heatmaps: (..., H, W).
      threshold: validity threshold on the peak value.
      normalize: divide x by W and y by H.

    Returns:
      pts2d: (..., 2) float32 (x, y); ties go to the first maximum in
        row-major order, as the reference's flat-argmax decode.
      maxvals: (...,) peak values, in the heatmaps' dtype.
      valid: (...,) bool, maxvals >= threshold.
    """
    *lead, H, W = heatmaps.shape
    flat = heatmaps.reshape(*lead, H * W)
    # torch.max returns the index of the first maximal value.
    maxvals, idx = flat.max(dim=-1)
    x = (idx % W).to(torch.float32)
    y = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    if normalize:
        x = x / W
        y = y / H
    pts2d = torch.stack([x, y], dim=-1)
    valid = maxvals >= threshold
    return pts2d, maxvals, valid


def render_gaussian_targets(joints_2d: torch.Tensor, image_size: int = 872,
                            heatmap_size: int = 64, sigma: float = 1.0):
    """Per-joint Gaussian target heatmaps (the JAX package's
    ``ops/heatmap.render_gaussian_targets``, the contract of the reference's
    ``generate_heatmap.py``).

    Args:
      joints_2d: (..., J, 2) pixel coordinates in the original image frame.
      image_size / heatmap_size / sigma: grid geometry; the stride is
        image_size / heatmap_size.

    Returns:
      targets: (..., J, heatmap_size, heatmap_size) float32: a
        (6 sigma + 1)^2 stamp around the joint's cell, zero outside it. The
        cell is ``int(v + 0.5)`` of the grid coordinate, truncated toward
        zero as the reference's Python ``int`` does (not floor: it differs
        for negative, out-of-view joints).
      weights: (..., J) float32 in {0, 1}; 0, and an all-zero map, where
        the stamp box lies wholly off the grid.
    """
    joints_2d = torch.as_tensor(joints_2d, dtype=torch.float32)
    device = joints_2d.device
    tmp = int(sigma * 3)
    # A one-element divisor, not a Python scalar: ATen turns division by a
    # CPU scalar into a product with its reciprocal, which rounds otherwise.
    stride = torch.full((1,), image_size / heatmap_size, dtype=torch.float32,
                        device=device)
    mu = torch.trunc(joints_2d / stride + 0.5).to(torch.int32)
    mu_x, mu_y = mu[..., 0], mu[..., 1]
    valid = ~((mu_x - tmp >= heatmap_size) | (mu_y - tmp >= heatmap_size)
              | (mu_x + tmp + 1 < 0) | (mu_y + tmp + 1 < 0))

    cells = torch.arange(heatmap_size, dtype=torch.int32, device=device)
    two_var = torch.full((1,), 2.0 * sigma ** 2, dtype=torch.float32,
                         device=device)

    def gauss(d):
        g = torch.exp(-(d.to(torch.float32) ** 2) / two_var)
        return torch.where(d.abs() <= tmp, g, torch.zeros_like(g))

    gx = gauss(cells - mu_x[..., None])  # (..., J, W)
    gy = gauss(cells - mu_y[..., None])  # (..., J, H)
    weights = valid.to(torch.float32)
    target = gy[..., :, None] * gx[..., None, :] * weights[..., None, None]
    return target, weights


def render_gaussian_targets_np(joints_2d, image_size: int = 872,
                               heatmap_size: int = 64, sigma: float = 1.0):
    """NumPy twin of :func:`render_gaussian_targets` (on the CPU), for the
    datasets and the synthetic tree."""
    t, w = render_gaussian_targets(
        torch.from_numpy(np.asarray(joints_2d, dtype=np.float32)),
        image_size, heatmap_size, sigma)
    return t.numpy(), w.numpy()
