"""Stage-1 per-view 2D joint-heatmap estimator (the JAX package's
``models/heatmap_net.py``): ResNet-18 + FPN over view-folded batches, then a
1x1 conv head emitting ``num_heatmap`` (15) channels, with an optional
stop-gradient between features and head (``detach_heatmap_feat_init``).

Images arrive as the reference's public (B, V, 3, H, W) NCHW contract and
are folded VIEW-MAJOR, sample index ``v * B + b``: the MVFex refiners sample
every view's features with per-view position tables in block mode, and the
pose3d proposal flattens per sample with views outermost, both of which read
that order directly. Heatmaps come out batch-major (B, V, J, h, w).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from egorear_tpu_torch.models.backbone import BackboneWithFPN
from egorear_tpu_torch.utils import trace


def fold_views(img: torch.Tensor) -> torch.Tensor:
    """(B, V, 3, H, W) -> (V*B, 3, H, W), view-major."""
    B, V = img.shape[:2]
    if img.shape[2] != 3:
        raise ValueError(f"not an NCHW image batch: {tuple(img.shape)}")
    return img.transpose(0, 1).reshape(V * B, *img.shape[2:])


class HeatmapNet(nn.Module):
    """Backbone + FPN of one stereo pair and, when ``num_heatmap`` is given,
    the 1x1 ``conv_heatmap`` head of stage 1.

    ``num_heatmap=None`` builds no head: the estimators inside the MVFex
    cascade run only :meth:`backbone_features` when their heatmaps come from
    the cascade's conv-stack heads, and the JAX package never creates the
    head's parameters there; with ``use_1by1_conv`` they keep the head.
    """

    def __init__(self, out_stride: int = 4, fpn_channels: int = 128,
                 bn_folded: bool = False, num_heatmap: Optional[int] = None,
                 detach_heatmap_feat_init: bool = False):
        super().__init__()
        self.encoder = BackboneWithFPN(out_stride, fpn_channels, bn_folded)
        self.detach_heatmap_feat_init = detach_heatmap_feat_init
        if num_heatmap is not None:
            self.conv_heatmap = nn.Conv2d(fpn_channels, num_heatmap, 1)

    def backbone_features(self, img: torch.Tensor
                          ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """img (B, V, 3, H, W) -> fpn (V*B, C, h, w) + pyramid
        [(V*B, C_i, h_i, w_i)], all folded view-major."""
        return self.encoder(fold_views(img))

    def head(self, feats: torch.Tensor, batch: int) -> torch.Tensor:
        """View-major FPN features (V*B, C, h, w) of ``batch`` samples ->
        heatmaps, batch-major (B, V, J, h, w)."""
        if self.detach_heatmap_feat_init:
            feats = feats.detach()
        hm = self.conv_heatmap(feats)
        return hm.reshape(-1, batch, *hm.shape[1:]).transpose(0, 1)

    def forward(self, img: torch.Tensor, return_feat: bool = False):
        """img (B, V, 3, H, W) -> heatmaps (B, V, J, h, w); with
        ``return_feat`` also the view-major features and pyramid (the
        program's ``stage1.encoder`` and ``stage1.head`` spans)."""
        with trace.span("stage1.encoder"):
            feats, pyramid = self.backbone_features(img)
        with trace.span("stage1.head"):
            heatmap = self.head(feats, img.shape[0])
        if return_feat:
            return heatmap, feats, pyramid
        return heatmap
