"""Stage 3: 3D pose lifting by fisheye reprojection, and the full cascade
(the JAX package's ``models/pose3d.py``), every branch of it.

``Pose3DLifter``: an MLP proposes 3D joints from the final frame features,
pooled (``use_mlp_avgpool``), from the final heatmaps through per-view conv
stacks (``use_mlp_heatmap``) or through a conv-downsample stack (the
flagship), optionally unnormalised from [-1, 1] (``norm_mlp_pred``); the
rig projects them (``CameraRig.project``: the reference's chained offsets on
the synthetic rig, the per-sample ``coord_trans_mat`` on the real-world one)
into every view; ``num_former_layers`` transformer layers (deformable in the
lazy or reference order, per ``lazy_deform``, or dense) attend at those
anchors in the initial (``use_pred_heatmap_init``) or final features and
each regresses a 3D offset from the mutated anchor state.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from egorear_tpu_torch.models.configs import EgoRearNetCfg, Pose3DCfg
from egorear_tpu_torch.models.layers import Dropout, add_modules, conv3x3, layer_norm
from egorear_tpu_torch.models.mvfex import (
    HeatmapMVFexNet,
    MultiViewTransformerLayer,
    materialised,
    to_tokens,
)
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.utils import trace
from egorear_tpu_torch.utils.constants import device_constant

HEATMAP_CONV_DIMS = 32  # the heatmap proposal's conv width (fixed, as in JAX)


def _proposal_side(n: int) -> int:
    """Side of the proposal map: 3x3/s2 conv, 2x2 max-pool, 3x3/s2 conv."""
    return ((n + 1) // 2 // 2 + 1) // 2


class Pose3DLifter(nn.Module):
    def __init__(self, num_views: int, image_size, use_pred_heatmap_init: bool,
                 cfg: Pose3DCfg, num_heatmap: int = 15):
        super().__init__()
        if cfg.norm_mlp_pred and (cfg.coor_norm_min is None
                                  or cfg.coor_norm_max is None):
            raise ValueError("norm_mlp_pred needs coor_norm_min and coor_norm_max")
        self.cfg = cfg
        self.num_views = num_views
        self.use_pred_heatmap_init = use_pred_heatmap_init
        h, w = (image_size[0] // cfg.feat_down_stride,
                image_size[1] // cfg.feat_down_stride)
        self.feat_shape = (h, w)
        Cin, C, J = cfg.input_dims, cfg.embed_dims, cfg.num_joints
        side = _proposal_side(h) * _proposal_side(w)

        # The memory projection: folded post-sampling in the lazy order, on
        # the grid in the reference order and for dense attention.
        self.feat_proj = nn.Linear(Cin, C)
        self.maxpool = nn.MaxPool2d(2, 2)
        if cfg.use_mlp_avgpool:
            in_dims = num_views * Cin
        elif cfg.use_mlp_heatmap:
            d = HEATMAP_CONV_DIMS
            for v in range(num_views):
                add_modules(self, **{
                    f"conv_heatmap_view{v}_0": conv3x3(num_heatmap, d, stride=2),
                    f"conv_heatmap_view{v}_1": conv3x3(d, 2 * d, stride=2)})
            in_dims = num_views * side * 2 * d
        else:
            self.conv_ff_0 = nn.Conv2d(Cin, Cin // 2, 1)
            self.conv_ff_1 = conv3x3(Cin // 2, Cin, stride=2)
            self.conv_ff_2 = nn.Conv2d(Cin, Cin // 2, 1)
            self.conv_ff_3 = conv3x3(Cin // 2, Cin, stride=2)
            in_dims = num_views * side * Cin
        for i in range(cfg.num_mlp_layers):
            out = cfg.mlp_dims if cfg.use_mlp_avgpool else in_dims // 16
            add_modules(self, **{f"mlp_pred_{i}": nn.Linear(in_dims, out)})
            in_dims = out
        self.mlp_pred_out = nn.Linear(in_dims, 3 * J)
        self.mlp_drop = Dropout(cfg.mlp_dropout)

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

    def _proposal_input(self, frame_feats_final, heatmap_final):
        """The proposal MLP's (B, features) input, flattened per sample with
        views outermost and channels last, the order ``mlp_pred_0``'s rows
        follow in the JAX package and the reference."""
        cfg, V = self.cfg, self.num_views
        B = frame_feats_final.shape[0] // V
        if cfg.use_mlp_avgpool:
            pooled = frame_feats_final.mean(dim=(2, 3))  # (V*B, Cin)
            return pooled.reshape(V, B, -1).transpose(0, 1).reshape(B, -1)
        if cfg.use_mlp_heatmap:  # per-view conv stacks over the heatmaps
            feats = []
            for v in range(V):
                y = F.relu(getattr(self, f"conv_heatmap_view{v}_0")(heatmap_final[:, v]))
                y = self.maxpool(y)
                y = F.relu(getattr(self, f"conv_heatmap_view{v}_1")(y))
                feats.append(y.permute(0, 2, 3, 1))
            return torch.stack(feats, dim=1).reshape(B, -1)
        y = F.relu(self.conv_ff_0(frame_feats_final))
        y = F.relu(self.conv_ff_1(y))
        y = self.maxpool(y)
        y = F.relu(self.conv_ff_2(y))
        y = F.relu(self.conv_ff_3(y))  # (V*B, Cin, h/8, w/8)
        return y.permute(0, 2, 3, 1).reshape(V, B, -1).transpose(0, 1).reshape(B, -1)

    def _proposal(self, frame_feats_final, heatmap_final):
        """The proposal MLP: (B, J, 3), unnormalised with ``norm_mlp_pred``."""
        cfg = self.cfg
        y = self._proposal_input(frame_feats_final, heatmap_final)
        B = y.shape[0]
        for i in range(cfg.num_mlp_layers):
            y = self.mlp_drop(F.gelu(getattr(self, f"mlp_pred_{i}")(y)))
        pred = self.mlp_pred_out(y).reshape(B, cfg.num_joints, 3)
        if cfg.norm_mlp_pred:
            # The reference computes this and drops the result (PARITY.md):
            # the JAX package, and the port, apply it.
            lo = device_constant(tuple(cfg.coor_norm_min), pred.dtype, pred.device)
            hi = device_constant(tuple(cfg.coor_norm_max), pred.dtype, pred.device)
            pred = (hi - lo) * (pred + 1.0) / 2.0 + lo
        return pred

    def forward(self, frame_feats_init, frame_feats_final, heatmap_final,
                rig: CameraRig, coord_trans_mat: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        """frame_feats_* (V*B, Cin, h, w), view-major; heatmap_final
        (B, V, J_hm, h, w) the last refined heatmaps (read by the heatmap
        proposal only); ``coord_trans_mat`` (B, V, 4, 4) the real-world
        rig's device-to-camera transforms. Returns [proposal, refined_0, ...,
        refined_{L-1}], each (B, J, 3) cm. The proposal, the projection and
        each layer are the program's ``stage3.proposal``, ``stage3.project``
        and ``stage3.layer`` spans."""
        cfg = self.cfg
        J = cfg.num_joints
        frame_feats = frame_feats_init if self.use_pred_heatmap_init else frame_feats_final
        feat_tokens = to_tokens(frame_feats)
        mem_kernel = self.feat_proj.weight.t()
        mem_bias = self.feat_proj.bias
        if not materialised(cfg.transformer, cfg.lazy_deform):
            memory, mem = feat_tokens, dict(mem_kernel=mem_kernel, mem_bias=mem_bias)
        else:  # the memory on the grid, no pos table
            dt = feat_tokens.dtype
            memory = torch.matmul(feat_tokens, mem_kernel.to(dt)) + mem_bias.to(dt)
            mem = {}

        with trace.span("stage3.proposal"):
            mlp_pred = self._proposal(frame_feats_final, heatmap_final)
        B = mlp_pred.shape[0]

        with trace.span("stage3.project"):
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
            with trace.span("stage3.layer", layer=idx):
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
        self.cfg = cfg
        self.heatmap_estimator = HeatmapMVFexNet(cfg.heatmap_mvf)
        self.pose3d_estimator = Pose3DLifter(
            cfg.num_views, cfg.image_size, cfg.heatmap_mvf.use_pred_heatmap_init,
            cfg.pose3d, cfg.heatmap_mvf.num_heatmap)

    def forward(self, img, rig: CameraRig,
                coord_trans_mat: Optional[torch.Tensor] = None):
        """img (B, V, 3, H, W), and on the real-world rig its (B, V, 4, 4)
        ``coord_trans_mat`` -> (preds_3d [(B, J, 3)], heatmaps
        [(B, V, J_hm, h, w)])."""
        if rig.num_views != self.cfg.num_views:
            raise ValueError(f"rig has {rig.num_views} views, model "
                             f"{self.cfg.num_views}")
        list_heatmap, list_feat = self.heatmap_estimator(img)
        preds_3d = self.pose3d_estimator(list_feat[0], list_feat[-1],
                                         list_heatmap[-1], rig, coord_trans_mat)
        return preds_3d, list_heatmap
