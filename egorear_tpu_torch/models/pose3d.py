"""Stage 3: 3D pose lifting by fisheye reprojection, and the full cascade
(the JAX package's ``models/pose3d.py``, flagship branch).

``Pose3DLifter``: a conv-downsample MLP proposes 3D joints; the rig projects
them (``CameraRig.project``: the reference's chained offsets on the
synthetic rig, the per-sample ``coord_trans_mat`` on the real-world one)
into every view; ``num_former_layers`` deformable transformer layers (lazy or
reference order, per ``lazy_deform``) attend at those anchors and each regresses a 3D offset from the mutated anchor state.
The avgpool / heatmap proposals and the normalized-MLP output are not
ported and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from egorear_tpu_torch.models.configs import EgoRearNetCfg, Pose3DCfg
from egorear_tpu_torch.models.layers import add_modules, conv3x3, layer_norm
from egorear_tpu_torch.models.mvfex import (
    HeatmapMVFexNet,
    MultiViewTransformerLayer,
    to_tokens,
)
from egorear_tpu_torch.ops.camera import CameraRig


def _proposal_side(n: int) -> int:
    """Side of the proposal map: 3x3/s2 conv, 2x2 max-pool, 3x3/s2 conv."""
    return ((n + 1) // 2 // 2 + 1) // 2


class Pose3DLifter(nn.Module):
    def __init__(self, num_views: int, image_size, use_pred_heatmap_init: bool,
                 cfg: Pose3DCfg):
        super().__init__()
        if cfg.use_mlp_avgpool or cfg.use_mlp_heatmap:
            raise NotImplementedError("only the conv-downsample 3D proposal "
                                      "is ported")
        if cfg.norm_mlp_pred:
            raise NotImplementedError("norm_mlp_pred is not ported")
        self.cfg = cfg
        self.num_views = num_views
        self.use_pred_heatmap_init = use_pred_heatmap_init
        h, w = (image_size[0] // cfg.feat_down_stride,
                image_size[1] // cfg.feat_down_stride)
        self.feat_shape = (h, w)
        Cin, C, J = cfg.input_dims, cfg.embed_dims, cfg.num_joints

        # The memory projection: folded post-sampling in the lazy order, on
        # the grid in the reference order.
        self.feat_proj = nn.Linear(Cin, C)
        self.conv_ff_0 = nn.Conv2d(Cin, Cin // 2, 1)
        self.conv_ff_1 = conv3x3(Cin // 2, Cin, stride=2)
        self.maxpool = nn.MaxPool2d(2, 2)
        self.conv_ff_2 = nn.Conv2d(Cin, Cin // 2, 1)
        self.conv_ff_3 = conv3x3(Cin // 2, Cin, stride=2)
        in_dims = num_views * _proposal_side(h) * _proposal_side(w) * Cin
        for i in range(cfg.num_mlp_layers):
            add_modules(self, **{f"mlp_pred_{i}": nn.Linear(in_dims, in_dims // 16)})
            in_dims //= 16
        self.mlp_pred_out = nn.Linear(in_dims, 3 * J)
        self.mlp_drop = nn.Dropout(cfg.mlp_dropout)

        self.query_gen_0 = nn.Linear(4, C)
        self.query_gen_1 = nn.Linear(C, C)
        self.query_gen_2 = nn.Linear(C, C)
        for idx in range(cfg.num_former_layers):
            add_modules(self, **{
                f"transformer_{idx}": MultiViewTransformerLayer(
                    num_views, C, self.feat_shape, cfg.transformer,
                    lazy=cfg.lazy_deform),
                f"post_norm_{idx}": layer_norm(C),
                f"reg_mlp_{idx}_out": nn.Linear(C, 3),
            })
            for i in range(cfg.num_pred_mlp_layers - 1):
                add_modules(self, **{f"reg_mlp_{idx}_{i}": nn.Linear(C, C)})

    def _proposal(self, frame_feats_final):
        """Conv-downsample MLP proposal: (V*B, Cin, h, w) -> (B, J, 3)."""
        V = self.num_views
        B = frame_feats_final.shape[0] // V
        y = F.relu(self.conv_ff_0(frame_feats_final))
        y = F.relu(self.conv_ff_1(y))
        y = self.maxpool(y)
        y = F.relu(self.conv_ff_2(y))
        y = F.relu(self.conv_ff_3(y))  # (V*B, Cin, h/8, w/8)
        # Flatten each sample as (V, h/8, w/8, Cin): views outermost, channels
        # last -- the order mlp_pred_0's rows follow in the JAX package and
        # the reference.
        y = y.permute(0, 2, 3, 1).reshape(V, B, -1).transpose(0, 1).reshape(B, -1)
        for i in range(self.cfg.num_mlp_layers):
            y = self.mlp_drop(F.gelu(getattr(self, f"mlp_pred_{i}")(y)))
        return self.mlp_pred_out(y).reshape(B, self.cfg.num_joints, 3)

    def forward(self, frame_feats_init, frame_feats_final, rig: CameraRig,
                coord_trans_mat: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """frame_feats_* (V*B, Cin, h, w), view-major; ``coord_trans_mat``
        (B, V, 4, 4) the real-world rig's device-to-camera transforms.
        Returns [proposal, refined_0, ..., refined_{L-1}], each (B, J, 3)
        cm."""
        cfg = self.cfg
        J = cfg.num_joints
        frame_feats = frame_feats_init if self.use_pred_heatmap_init else frame_feats_final
        feat_tokens = to_tokens(frame_feats)
        mem_kernel = self.feat_proj.weight.t()
        mem_bias = self.feat_proj.bias
        if cfg.lazy_deform:
            memory, mem = feat_tokens, dict(mem_kernel=mem_kernel, mem_bias=mem_bias)
        else:  # the reference order: the memory on the grid, no pos table
            dt = feat_tokens.dtype
            memory = torch.matmul(feat_tokens, mem_kernel.to(dt)) + mem_bias.to(dt)
            mem = {}

        mlp_pred = self._proposal(frame_feats_final)
        B = mlp_pred.shape[0]

        anchors_2d, anchors_valid, anchors_mut = rig.project(
            mlp_pred.detach(), coord_trans_mat)
        dtype = feat_tokens.dtype
        anchors_2d = anchors_2d.to(dtype)  # sampling positions in the activation dtype

        joint_inds = (torch.arange(1, J + 1, dtype=dtype, device=mlp_pred.device)
                      .reshape(1, J, 1) / float(J)).expand(B, J, 1)
        q = torch.cat([joint_inds, anchors_mut.to(dtype)], dim=-1)
        q = F.relu(self.query_gen_0(q))
        q = F.relu(self.query_gen_1(q))
        x = self.query_gen_2(q)

        preds = [mlp_pred]
        anchors_base = anchors_mut.detach()
        for idx in range(cfg.num_former_layers):
            x = getattr(self, f"transformer_{idx}")(
                x, anchors_2d, anchors_valid, memory, **mem)
            o = getattr(self, f"post_norm_{idx}")(x)
            for i in range(cfg.num_pred_mlp_layers - 1):
                o = F.gelu(getattr(self, f"reg_mlp_{idx}_{i}")(o))
            preds.append(getattr(self, f"reg_mlp_{idx}_out")(o) + anchors_base)
        return preds


class EgoRearNet(nn.Module):
    """Full cascade: stereo backbones and initial heatmaps -> MVFex
    refinement -> 3D lifting. ``forward(img, rig, coord_trans_mat=None)``
    returns ``(preds_3d, list_heatmap)``."""

    def __init__(self, cfg: EgoRearNetCfg):
        super().__init__()
        if not cfg.heatmap_mvf.use_pred_heatmap_init:
            # The stage-2 network takes this branch; the cascade's lifting
            # on the refined features is not held to the JAX package yet
            # (every shipped stage-3 config sets the flag).
            raise NotImplementedError("stage 3 with use_pred_heatmap_init: "
                                      "false is not ported")
        self.cfg = cfg
        self.heatmap_estimator = HeatmapMVFexNet(cfg.heatmap_mvf)
        self.pose3d_estimator = Pose3DLifter(
            cfg.num_views, cfg.image_size, cfg.heatmap_mvf.use_pred_heatmap_init,
            cfg.pose3d)

    def forward(self, img, rig: CameraRig,
                coord_trans_mat: Optional[torch.Tensor] = None):
        """img (B, V, 3, H, W), and on the real-world rig its (B, V, 4, 4)
        ``coord_trans_mat`` -> (preds_3d [(B, J, 3)], heatmaps
        [(B, V, J_hm, h, w)])."""
        if rig.num_views != self.cfg.num_views:
            raise ValueError(f"rig has {rig.num_views} views, model "
                             f"{self.cfg.num_views}")
        list_heatmap, list_feat = self.heatmap_estimator(img)
        preds_3d = self.pose3d_estimator(list_feat[0], list_feat[-1], rig,
                                         coord_trans_mat)
        return preds_3d, list_heatmap
