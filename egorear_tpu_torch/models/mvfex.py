"""MVFex: multi-view feature-exchange heatmap refinement with joint-query
adaptation (the JAX package's ``models/mvfex.py``, flagship branch).

Ported branch: any number of views (the 4-view rig: a stereo-front and a
stereo-back estimator and head; the front stereo pair alone, V = 2: the
front estimator and head only); JQA joint queries; deformable cross-attention into
every view's features, in the lazy order (``lazy_deform``, the flagship:
raw features sampled, projected after) or the reference order (the memory
materialised on the grid); the conv-stack heatmap heads
(``use_1by1_conv`` off); refinement from the predicted initial heatmaps
(``use_pred_heatmap_init``, stage 3) or from the initial heads' own output
(stage 2). Every other branch raises NotImplementedError.

Layout: NCHW maps; multi-view stacks folded VIEW-MAJOR (index ``v * B + b``),
so the per-view position tables are matched to the batch in block mode.
Heatmaps keep the public batch-major (B, V, J, h, w) contract. The V
refiners are V modules with their own weights, run in a loop.

``.detach()`` marks every place where the JAX package stops gradients; the
serving path runs under ``torch.inference_mode()``, the training slice will
need them.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from egorear_tpu_torch.models.configs import MVFCfg, MVFexNetCfg, TransformerLayerCfg
from egorear_tpu_torch.models.heatmap_net import HeatmapNet
from egorear_tpu_torch.models.layers import (
    FFN,
    MSDeformAttn,
    MSDeformAttnLazy,
    MultiheadAttention,
    PointwiseConv,
    add_modules,
    conv3x3,
    layer_norm,
    resize_align_corners,
    upsample2x_align_corners,
)
from egorear_tpu_torch.ops.heatmap import argmax_2d

BFB_DIMS = 512  # channels of the ResNet-18 stride-32 map


def to_tokens(feat: torch.Tensor) -> torch.Tensor:
    """(N, C, h, w) -> contiguous (N, h*w, C) raw memory tokens."""
    N, C = feat.shape[:2]
    return feat.permute(0, 2, 3, 1).reshape(N, -1, C).contiguous()


class MultiViewTransformerLayer(nn.Module):
    """Cross-view deformable attention + spatial MHA + FFN, each with a
    residual and a post-LayerNorm.

    The memory is view-major, row ``v * B + b``. In the lazy order
    (``lazy``, the flagship) it is the raw features (V*B, HW, Cin), projected
    after sampling through ``mem_kernel``/``mem_bias``, and a (V, HW, C)
    ``mem_pos`` is sampled in block mode. In the reference order it is the
    materialised memory (V*B, HW, C). Either way the attention is the
    submodule ``cross_attn``, with the same parameters. Per-view results at
    invalid anchors are zeroed before the fuse.
    """

    def __init__(self, num_views: int, embed_dims: int, feat_shape,
                 cfg: TransformerLayerCfg = TransformerLayerCfg(),
                 lazy: bool = True):
        super().__init__()
        if cfg.use_normal_cross_attn:
            raise NotImplementedError("use_normal_cross_attn is not ported")
        self.num_views = num_views
        self.feat_shape = tuple(feat_shape)
        self.lazy = lazy
        heads = cfg.cross_attn.num_heads
        self.cross_attn = (MSDeformAttnLazy(embed_dims, heads, 16, pos_block=True)
                           if lazy else MSDeformAttn(embed_dims, heads, 16))
        self.fuse_mlp = nn.Linear(num_views * embed_dims, embed_dims)
        self.norm_cross = layer_norm(embed_dims)
        self.spatial_attn = MultiheadAttention(embed_dims, cfg.spatial_attn.num_heads)
        self.norm_spatial = layer_norm(embed_dims)
        self.ffn = FFN(embed_dims, cfg.ffn.feedforward_dims, cfg.ffn.num_fcs,
                       cfg.ffn.ffn_drop)
        self.norm_ffn = layer_norm(embed_dims)

    def forward(self, query, anchors_2d, anchors_valid, memory,
                mem_kernel=None, mem_bias=None, mem_pos=None):
        """query (B, J, C); anchors_2d (B, V, J, 2) in [0, 1]; anchors_valid
        (B, V, J) bool; memory view-major, the raw (V*B, HW, Cin) features
        (lazy order) or the materialised (V*B, HW, C) memory (reference
        order, which takes no ``mem_*``)."""
        B, J, C = query.shape
        V = self.num_views
        q_folded = query[None].expand(V, B, J, C).reshape(V * B, J, C)
        anchors = anchors_2d.detach().transpose(0, 1).reshape(V * B, J, 2)
        valid = anchors_valid.transpose(0, 1)  # (V, B, J)

        if self.lazy:
            per_view = self.cross_attn(q_folded, anchors, memory, self.feat_shape,
                                       mem_kernel=mem_kernel, mem_bias=mem_bias,
                                       mem_pos=mem_pos)
        elif mem_kernel is None and mem_bias is None and mem_pos is None:
            per_view = self.cross_attn(q_folded, anchors, memory, self.feat_shape)
        else:
            raise ValueError("the reference order takes the materialised "
                             "memory, not a memory projection")
        pv = per_view.reshape(V, B, J, C)
        pv = torch.where(valid[..., None], pv, torch.zeros_like(pv))
        fused = self.fuse_mlp(pv.permute(1, 2, 0, 3).reshape(B, J, V * C))
        x = self.norm_cross(query + fused)
        x = self.norm_spatial(x + self.spatial_attn(x, x, x))
        return self.norm_ffn(x + self.ffn(x))


class TransformerHeadLayer(nn.Module):
    """Joint-token maps (B, J, h, w) -> upsampled features (B, 128, 2h, 2w)
    (the reference's 128-channel variant)."""

    def __init__(self, in_dims: int, output_dims: int = 128):
        super().__init__()
        if output_dims != 128:
            raise NotImplementedError("only the 128-channel head is ported")
        self.Conv_0 = PointwiseConv(in_dims, output_dims // 2)
        self.Conv_1 = PointwiseConv(output_dims // 2, output_dims)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        return F.relu(self.Conv_1(upsample2x_align_corners(x)))


class MVFexRefiner(nn.Module):
    """Per-view heatmap refiner (reference HeatmapMVF), JQA query mode."""

    def __init__(self, num_views: int, num_heatmap: int, feat_shape,
                 detach_heatmap_feat: bool, cfg: MVFCfg):
        super().__init__()
        if not cfg.joint_query_adaptation or cfg.joint_query_adaptation_multi_view:
            raise NotImplementedError(
                "only the joint_query_adaptation query mode is ported")
        if cfg.use_1by1_conv:
            raise NotImplementedError("use_1by1_conv is not ported")
        h, w = feat_shape
        C, Cin, J, V = cfg.embed_dims, cfg.input_dims, num_heatmap, num_views
        side = int(C**0.5)
        if side * side != C:
            raise ValueError(f"embed_dims {C} must be a square (token maps)")
        self.cfg = cfg
        self.num_views, self.num_heatmap = V, J
        self.feat_shape = (h, w)
        self.detach_heatmap_feat = detach_heatmap_feat

        self.heatmap_proj_0 = nn.Linear(h * w, C)
        self.heatmap_proj_1 = nn.Linear(C, C)
        self.fc_bfb = nn.Linear(BFB_DIMS, C)
        self.joint_query_embed = nn.Parameter(torch.empty(J, C))
        self.fc_query = nn.Linear(C, C)
        # The 1x1 memory projection: in the lazy order never applied to the
        # grid, folded into the post-sampling projections by MSDeformAttnLazy.
        self.frame_feat_multi_view_proj = nn.Linear(Cin, C)
        self.frame_feat_multi_view_pos_embed = nn.Parameter(torch.empty(1, V, h * w, C))
        self.ff_proj_0 = PointwiseConv(Cin, 2 * Cin)
        self.ff_proj_1 = conv3x3(2 * Cin, 4 * Cin, stride=2)
        self.ff_proj_2 = PointwiseConv(4 * Cin, Cin)
        for i in range(cfg.num_former_layers):
            add_modules(self, **{
                f"transformer_{i}": MultiViewTransformerLayer(
                    V, C, feat_shape, cfg.transformer, lazy=cfg.lazy_deform),
                f"post_norm_{i}": layer_norm(C),
                f"head_{i}": TransformerHeadLayer(J, Cin),
                f"ff_refined_proj_{i}_0": PointwiseConv(Cin, Cin),
                f"ff_refined_proj_{i}_1": PointwiseConv(Cin, Cin),
                f"conv_hm_{i}_0": conv3x3(Cin, 2 * Cin, stride=2),
                f"conv_hm_{i}_1": PointwiseConv(2 * Cin, 2 * Cin),
                f"conv_hm_{i}_2": PointwiseConv(2 * Cin, Cin),
                f"conv_hm_{i}_3": PointwiseConv(Cin, J),
            })

    def reset_parameters_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.joint_query_embed.normal_(0.0, 1.0, generator=gen)
            self.frame_feat_multi_view_pos_embed.zero_()

    def forward(self, heatmap, frame_feat, feat_tokens, anchors_2d,
                anchors_valid, bfb) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """heatmap (B, J, h, w) this view's initial heatmaps; frame_feat
        (B, Cin, h, w) this view's FPN features; feat_tokens (V*B, h*w, Cin)
        every view's features as view-major tokens; anchors_2d (B, V, J, 2);
        anchors_valid (B, V, J); bfb (B, 512) this view's pooled backbone
        bottom. Returns per-layer heatmaps (B, J, h, w) and refined features
        (B, Cin, h, w)."""
        B = heatmap.shape[0]
        J = self.num_heatmap
        h, w = self.feat_shape

        # ---- joint queries (JQA) ----
        hm_embed = self.heatmap_proj_1(F.relu(self.heatmap_proj_0(
            heatmap.reshape(B, J, h * w))))
        bfb_embed = self.fc_bfb(bfb)[:, None]
        x = F.relu(self.fc_query(self.joint_query_embed[None] + bfb_embed + hm_embed))

        mem_kernel = self.frame_feat_multi_view_proj.weight.t()  # (Cin, C)
        mem_bias = self.frame_feat_multi_view_proj.bias
        mem_pos = self.frame_feat_multi_view_pos_embed[0]  # (V, HW, C)
        if self.cfg.lazy_deform:
            memory, mem = feat_tokens, dict(mem_kernel=mem_kernel,
                                            mem_bias=mem_bias, mem_pos=mem_pos)
        else:
            # The reference order: the memory on the grid, view-major, each
            # view block of tokens plus its own (HW, C) table, added in the
            # JAX package's order so that bf16 rounds the same way.
            V, dt = self.num_views, feat_tokens.dtype
            tokens = feat_tokens.reshape(V, -1, *feat_tokens.shape[1:])
            memory = (torch.matmul(tokens, mem_kernel.to(dt)) + mem_bias.to(dt)
                      + mem_pos[:, None].to(dt)).flatten(0, 1)
            mem = {}

        # ---- downsampled frame features for the residual head ----
        f = F.relu(self.ff_proj_0(frame_feat))
        f = F.relu(self.ff_proj_1(f))
        f = F.relu(self.ff_proj_2(f))  # (B, Cin, h/2, w/2)

        list_heatmap, list_feat = [], []
        for i in range(self.cfg.num_former_layers):
            x = getattr(self, f"transformer_{i}")(
                x, anchors_2d, anchors_valid, memory, **mem)
            # The post-normed (B, J, C) tokens read as J maps of side x side:
            # in NCHW that is a plain reshape, channels = joints.
            _x = getattr(self, f"post_norm_{i}")(x)
            side = int(_x.shape[-1] ** 0.5)
            offset = getattr(self, f"head_{i}")(_x.reshape(B, J, side, side))
            # A no-op at 256 px (2 * side == h / 2); makes other sizes work.
            offset = resize_align_corners(offset, f.shape[-2:])

            refined = offset + f.detach()
            refined = F.relu(getattr(self, f"ff_refined_proj_{i}_0")(refined))
            refined = upsample2x_align_corners(refined)
            refined = F.relu(getattr(self, f"ff_refined_proj_{i}_1")(refined))
            list_feat.append(refined)

            y = refined.detach() if self.detach_heatmap_feat else refined
            y = F.relu(getattr(self, f"conv_hm_{i}_0")(y))
            y = F.relu(getattr(self, f"conv_hm_{i}_1")(y))
            y = upsample2x_align_corners(y)
            y = F.relu(getattr(self, f"conv_hm_{i}_2")(y))
            list_heatmap.append(getattr(self, f"conv_hm_{i}_3")(y))
        return list_heatmap, list_feat


class ConvHeatmapHead(nn.Module):
    """Conv-stack heatmap head used when ``use_1by1_conv`` is off:
    (N, Cin, h, w) -> (N, J, h, w)."""

    def __init__(self, input_dims: int, num_heatmap: int):
        super().__init__()
        d = input_dims
        self.Conv_0 = nn.Conv2d(d, d, 1)
        self.Conv_1 = conv3x3(d, 2 * d, stride=2)
        self.Conv_2 = nn.Conv2d(2 * d, 2 * d, 1)
        self.Conv_3 = nn.Conv2d(2 * d, d, 1)
        self.Conv_4 = nn.Conv2d(d, num_heatmap, 1)

    def forward(self, x):
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.relu(self.Conv_2(x))
        x = upsample2x_align_corners(x)
        x = F.relu(self.Conv_3(x))
        return self.Conv_4(x)


class HeatmapMVFexNet(nn.Module):
    """Stage 2: the stereo estimators' backbones, conv-stack initial
    heatmaps, argmax anchors and the V refiners.

    With V >= 3 views the first two are the front stereo pair and the rest
    the back one, each with its own estimator and head (the 4-view rig);
    with fewer (the front pair alone, V = 2) every view goes through the
    front estimator and head, and the back ones are not built.

    ``forward`` returns ``(list_heatmap, list_feat)``: heatmaps batch-major
    (B, V, J, h, w); frame features view-major folded (V*B, Cin, h, w).
    """

    def __init__(self, cfg: MVFexNetCfg):
        super().__init__()
        if cfg.mvf.use_1by1_conv:
            raise NotImplementedError("use_1by1_conv is not ported")
        self.cfg = cfg
        enc = cfg.encoder
        V = cfg.num_views
        self.has_back = V >= 3
        self.heatmap_estimator_stereo_front = HeatmapNet(
            enc.out_stride, enc.fpn_channels, enc.bn_folded)
        if self.has_back:
            self.heatmap_estimator_stereo_back = HeatmapNet(
                enc.out_stride, enc.fpn_channels, enc.bn_folded)
        self.refiners = nn.ModuleList(
            MVFexRefiner(V, cfg.num_heatmap, cfg.feat_shape,
                         cfg.detach_heatmap_feat, cfg.mvf)
            for _ in range(V))
        self.conv_heatmap_head_front = ConvHeatmapHead(cfg.mvf.input_dims,
                                                       cfg.num_heatmap)
        if self.has_back:
            self.conv_heatmap_head_back = ConvHeatmapHead(cfg.mvf.input_dims,
                                                          cfg.num_heatmap)

    def _estimator_features(self, img):
        """Backbone features: the view-major (V*B, C, h, w) stack, the pooled
        (B, V, 512) backbone bottoms and the per-estimator halves (the back
        one None without a back pair)."""
        B = img.shape[0]

        def pooled(p):  # (n*B, 512, h, w) -> (B, n, 512)
            return p.mean(dim=(2, 3)).reshape(-1, B, p.shape[1]).transpose(0, 1)

        if not self.has_back:  # every view through the front estimator
            feat_f, pyr_f = self.heatmap_estimator_stereo_front.backbone_features(img)
            return feat_f, pooled(pyr_f[-1]), (feat_f, None)
        feat_f, pyr_f = self.heatmap_estimator_stereo_front.backbone_features(img[:, 0:2])
        feat_b, pyr_b = self.heatmap_estimator_stereo_back.backbone_features(img[:, 2:])
        feat = torch.cat([feat_f, feat_b], dim=0)
        bfb = torch.cat([pooled(pyr_f[-1]), pooled(pyr_b[-1])], dim=1)
        return feat, bfb, (feat_f, feat_b)

    def _heatmaps_from_feat(self, feat_f, feat_b):
        """Conv-stack heads on the view-major halves (the back one None
        without a back pair) -> (B, V, J, h, w)."""
        B = feat_f.shape[0] // (2 if self.has_back else self.cfg.num_views)
        hms = [self.conv_heatmap_head_front(feat_f)]
        if feat_b is not None:
            hms.append(self.conv_heatmap_head_back(feat_b))
        hm = torch.cat([h.reshape(-1, B, *h.shape[1:]) for h in hms], dim=0)
        return hm.transpose(0, 1)

    def get_anchors_2d(self, heatmap):
        """Per-view argmax anchors in [0, 1] and their validity."""
        pts2d, _, valid = argmax_2d(heatmap.detach(),
                                    threshold=self.cfg.heatmap_threshold,
                                    normalize=True)
        return pts2d, valid

    def forward(self, img):
        """img (B, V, 3, H, W).

        The detach policy of the JAX package: with ``full_training`` off the
        backbones get no gradient (they run without autograd; train-mode BN
        still updates their running stats). With ``use_pred_heatmap_init``
        the initial heads see detached features and the refiners detached
        initial heatmaps; without it (stage 2 as configured) the refiners'
        gradient reaches the initial heads through the heatmaps.
        """
        cfg = self.cfg
        B, V = img.shape[:2]
        if V != cfg.num_views:
            raise ValueError(f"expected {cfg.num_views} views, got {V}")
        with torch.set_grad_enabled(cfg.full_training and torch.is_grad_enabled()):
            feat_init, bfb_init, (feat_f, feat_b) = self._estimator_features(img)
        if cfg.use_pred_heatmap_init:
            hm_init = self._heatmaps_from_feat(
                feat_f.detach(), None if feat_b is None else feat_b.detach())
            hm_for_refine = hm_init.detach()
            if cfg.no_detach_feat_init:
                feat, bfb = feat_init, bfb_init
            else:
                feat, bfb = feat_init.detach(), bfb_init.detach()
        else:
            hm_init = self._heatmaps_from_feat(feat_f, feat_b)
            hm_for_refine, feat, bfb = hm_init, feat_init, bfb_init

        anchors_2d, anchors_valid = self.get_anchors_2d(hm_init)
        tokens = to_tokens(feat)  # shared by every refiner's sampling
        per_view = [
            refiner(hm_for_refine[:, v], feat[v * B:(v + 1) * B], tokens,
                    anchors_2d, anchors_valid, bfb[:, v])
            for v, refiner in enumerate(self.refiners)
        ]
        list_heatmap, list_feat = [hm_init], [feat_init]
        for layer in range(cfg.mvf.num_former_layers):
            list_heatmap.append(torch.stack([hms[layer] for hms, _ in per_view], dim=1))
            list_feat.append(torch.cat([feats[layer] for _, feats in per_view], dim=0))
        return list_heatmap, list_feat
