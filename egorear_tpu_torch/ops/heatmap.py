"""Heatmap decoding: per-channel peak locations (the JAX package's
``ops/heatmap.argmax_2d``)."""

from __future__ import annotations

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
