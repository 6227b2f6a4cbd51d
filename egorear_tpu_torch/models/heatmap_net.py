"""Stage-1 per-view feature extractor (the JAX package's
``models/heatmap_net.py``, the ``backbone_features`` path the flagship runs).

Images arrive as the reference's public (B, V, 3, H, W) NCHW contract and
are folded VIEW-MAJOR, sample index ``v * B + b``: the MVFex refiners sample
every view's features with per-view position tables in block mode, and the
pose3d proposal flattens per sample with views outermost, both of which read
that order directly.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from egorear_tpu_torch.models.backbone import BackboneWithFPN


def fold_views(img: torch.Tensor) -> torch.Tensor:
    """(B, V, 3, H, W) -> (V*B, 3, H, W), view-major."""
    B, V = img.shape[:2]
    if img.shape[2] != 3:
        raise ValueError(f"not an NCHW image batch: {tuple(img.shape)}")
    return img.transpose(0, 1).reshape(V * B, *img.shape[2:])


class HeatmapNet(nn.Module):
    """Backbone + FPN of one stereo pair. The 1x1 heatmap head that the
    reference attaches here belongs to the ``use_1by1_conv`` branch, which
    this port does not carry."""

    def __init__(self, out_stride: int = 4, fpn_channels: int = 128,
                 bn_folded: bool = False):
        super().__init__()
        self.encoder = BackboneWithFPN(out_stride, fpn_channels, bn_folded)

    def backbone_features(self, img: torch.Tensor
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """img (B, V, 3, H, W) -> fpn (V*B, C, h, w) + pyramid
        [(V*B, C_i, h_i, w_i)], all folded view-major."""
        return self.encoder(fold_views(img))
