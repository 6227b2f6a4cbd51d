"""MVFex: multi-view feature-exchange heatmap refinement (the JAX package's
``models/mvfex.py``), every branch of it:

* any number of views (the 4-view rig: a stereo-front and a stereo-back
  estimator; the front stereo pair alone, V = 2: the front estimator only);
* the four joint-query modes: JQA (the pooled backbone bottom of the view),
  JQA multi-view (of every view), joint queries only, and heatmap embedding
  plus a learned ``query_pos_embed``;
* cross-attention into every view's features, deformable in the lazy order
  (``lazy_deform``, the flagship: raw features sampled, projected after) or
  the reference order (the memory materialised on the grid), or dense
  (``use_normal_cross_attn``: 4-head attention into the materialised memory,
  no invalid-anchor masking);
* the 128- and 512-channel token heads (``input_dims``);
* the conv-stack heatmap heads, or with ``use_1by1_conv`` a 1x1
  ``conv_heatmap`` shared by each refiner's layers and the initial
  heatmaps from the stage-1 estimators' own heads;
* refinement from the predicted initial heatmaps (``use_pred_heatmap_init``)
  or from the initial heads' own output.

Layout: NCHW maps; multi-view stacks folded VIEW-MAJOR (index ``v * B + b``),
so the per-view position tables are matched to the batch in block mode.
Heatmaps keep the public batch-major (B, V, J, h, w) contract. The V
refiners are V modules with their own weights, run in a loop.

``.detach()`` marks every place where the JAX package stops gradients.
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


def materialised(cfg: TransformerLayerCfg, lazy_deform: bool) -> bool:
    """Whether a stage's transformer layers take the memory on the grid:
    in the reference order, and for dense cross-attention in either."""
    return cfg.use_normal_cross_attn or not lazy_deform


class MultiViewTransformerLayer(nn.Module):
    """Cross-view attention + spatial MHA + FFN, each with a residual and a
    post-LayerNorm.

    The memory is view-major, row ``v * B + b``. In the lazy order
    (``lazy``, the flagship) it is the raw features (V*B, HW, Cin), projected
    after sampling through ``mem_kernel``/``mem_bias``, and a (V, HW, C)
    ``mem_pos`` is sampled in block mode. In the reference order it is the
    materialised memory (V*B, HW, C). Either way the attention is the
    deformable submodule ``cross_attn``, with the same parameters, and
    per-view results at invalid anchors are zeroed before the fuse. With
    ``use_normal_cross_attn`` the attention is ``cross_attn_dense``, 4 heads
    whatever ``cross_attn.num_heads`` says, over every cell of the
    materialised memory, and nothing is masked (as the JAX package).
    """

    def __init__(self, num_views: int, embed_dims: int, feat_shape,
                 cfg: TransformerLayerCfg = TransformerLayerCfg(),
                 lazy: bool = True):
        super().__init__()
        self.num_views = num_views
        self.feat_shape = tuple(feat_shape)
        self.dense = cfg.use_normal_cross_attn
        self.lazy = lazy and not self.dense
        heads = cfg.cross_attn.num_heads
        if self.dense:
            self.cross_attn_dense = MultiheadAttention(embed_dims, 4)
        else:
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
        order and dense attention, which take no ``mem_*``)."""
        B, J, C = query.shape
        V = self.num_views
        q_folded = query[None].expand(V, B, J, C).reshape(V * B, J, C)
        anchors = anchors_2d.detach().transpose(0, 1).reshape(V * B, J, 2)
        valid = anchors_valid.transpose(0, 1)  # (V, B, J)

        if not self.lazy and not (mem_kernel is None and mem_bias is None
                                  and mem_pos is None):
            raise ValueError("the reference order and dense attention take "
                             "the materialised memory, not a memory projection")
        if self.dense:
            per_view = self.cross_attn_dense(q_folded, memory, memory)
        elif self.lazy:
            per_view = self.cross_attn(q_folded, anchors, memory, self.feat_shape,
                                       mem_kernel=mem_kernel, mem_bias=mem_bias,
                                       mem_pos=mem_pos)
        else:
            per_view = self.cross_attn(q_folded, anchors, memory, self.feat_shape)
        pv = per_view.reshape(V, B, J, C)
        if not self.dense:  # the JAX package masks the deformable results only
            pv = torch.where(valid[..., None], pv, torch.zeros_like(pv))
        fused = self.fuse_mlp(pv.permute(1, 2, 0, 3).reshape(B, J, V * C))
        x = self.norm_cross(query + fused)
        x = self.norm_spatial(x + self.spatial_attn(x, x, x))
        return self.norm_ffn(x + self.ffn(x))


class TransformerHeadLayer(nn.Module):
    """Joint-token maps (B, J, h, w) -> upsampled features (B, D, 2h, 2w),
    the reference's 128- and 512-channel variants (``output_dims`` D)."""

    def __init__(self, in_dims: int, output_dims: int = 128):
        super().__init__()
        if output_dims == 128:
            widths = [in_dims, 64, 128]
        elif output_dims == 512:
            widths = [in_dims, in_dims, 64, 128, 512]
        else:
            raise ValueError(f"unsupported output_dims {output_dims}")
        self.n_convs = len(widths) - 1
        for i in range(self.n_convs):
            self.add_module(f"Conv_{i}", PointwiseConv(widths[i], widths[i + 1]))

    def forward(self, x):
        up = self.n_convs // 2 - 1  # the conv after which the map is upsampled
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            if i == up:
                x = upsample2x_align_corners(x)
        return x


def query_mode(cfg: MVFCfg) -> str:
    """The refiner's joint-query mode, in the JAX package's order of
    precedence: ``"jqa"``, ``"jqa_multi_view"``, ``"query_only"`` or
    ``"heatmap_embed"``."""
    if cfg.joint_query_adaptation:
        return "jqa"
    if cfg.joint_query_adaptation_multi_view:
        return "jqa_multi_view"
    return "query_only" if cfg.joint_query_only else "heatmap_embed"


class MVFexRefiner(nn.Module):
    """Per-view heatmap refiner (reference HeatmapMVF)."""

    def __init__(self, num_views: int, num_heatmap: int, feat_shape,
                 detach_heatmap_feat: bool, cfg: MVFCfg):
        super().__init__()
        h, w = feat_shape
        C, Cin, J, V = cfg.embed_dims, cfg.input_dims, num_heatmap, num_views
        side = int(C**0.5)
        if side * side != C:
            raise ValueError(f"embed_dims {C} must be a square (token maps)")
        self.cfg = cfg
        self.num_views, self.num_heatmap = V, J
        self.feat_shape = (h, w)
        self.detach_heatmap_feat = detach_heatmap_feat
        self.query_mode = query_mode(cfg)

        if self.query_mode != "query_only":
            self.heatmap_proj_0 = nn.Linear(h * w, C)
            self.heatmap_proj_1 = nn.Linear(C, C)
        if self.query_mode == "heatmap_embed":
            self.query_pos_embed = nn.Parameter(torch.empty(1, J, C))
        else:
            if self.query_mode != "query_only":
                pooled = BFB_DIMS * (V if self.query_mode == "jqa_multi_view" else 1)
                self.fc_bfb = nn.Linear(pooled, C)
            self.joint_query_embed = nn.Parameter(torch.empty(J, C))
            self.fc_query = nn.Linear(C, C)
        # The 1x1 memory projection: in the lazy order never applied to the
        # grid, folded into the post-sampling projections by MSDeformAttnLazy.
        self.frame_feat_multi_view_proj = nn.Linear(Cin, C)
        self.frame_feat_multi_view_pos_embed = nn.Parameter(torch.empty(1, V, h * w, C))
        self.ff_proj_0 = PointwiseConv(Cin, 2 * Cin)
        self.ff_proj_1 = conv3x3(2 * Cin, 4 * Cin, stride=2)
        self.ff_proj_2 = PointwiseConv(4 * Cin, Cin)
        if cfg.use_1by1_conv:  # one head, shared by every layer
            self.conv_heatmap = PointwiseConv(Cin, J)
        for i in range(cfg.num_former_layers):
            add_modules(self, **{
                f"transformer_{i}": MultiViewTransformerLayer(
                    V, C, feat_shape, cfg.transformer, lazy=cfg.lazy_deform),
                f"post_norm_{i}": layer_norm(C),
                f"head_{i}": TransformerHeadLayer(J, Cin),
                f"ff_refined_proj_{i}_0": PointwiseConv(Cin, Cin),
                f"ff_refined_proj_{i}_1": PointwiseConv(Cin, Cin),
            })
            if not cfg.use_1by1_conv:
                add_modules(self, **{
                    f"conv_hm_{i}_0": conv3x3(Cin, 2 * Cin, stride=2),
                    f"conv_hm_{i}_1": PointwiseConv(2 * Cin, 2 * Cin),
                    f"conv_hm_{i}_2": PointwiseConv(2 * Cin, Cin),
                    f"conv_hm_{i}_3": PointwiseConv(Cin, J),
                })

    def reset_parameters_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            if hasattr(self, "joint_query_embed"):
                self.joint_query_embed.normal_(0.0, 1.0, generator=gen)
            if hasattr(self, "query_pos_embed"):
                self.query_pos_embed.zero_()
            self.frame_feat_multi_view_pos_embed.zero_()

    def _queries(self, heatmap, bfb_mv, view: int):
        """The (B, J, C) joint queries of the configured mode."""
        B, J = heatmap.shape[0], self.num_heatmap
        h, w = self.feat_shape
        if self.query_mode == "query_only":
            return F.relu(self.fc_query(self.joint_query_embed[None].expand(B, -1, -1)))
        hm_embed = self.heatmap_proj_1(F.relu(self.heatmap_proj_0(
            heatmap.reshape(B, J, h * w))))
        if self.query_mode == "heatmap_embed":
            return hm_embed + self.query_pos_embed
        pooled = bfb_mv[:, view] if self.query_mode == "jqa" else bfb_mv.reshape(B, -1)
        bfb_embed = self.fc_bfb(pooled)[:, None]
        return F.relu(self.fc_query(self.joint_query_embed[None] + bfb_embed + hm_embed))

    def _heatmap(self, i: int, y):
        """Layer ``i``'s heatmaps (B, J, h, w) from its refined features."""
        if self.cfg.use_1by1_conv:
            return self.conv_heatmap(y)
        y = F.relu(getattr(self, f"conv_hm_{i}_0")(y))
        y = F.relu(getattr(self, f"conv_hm_{i}_1")(y))
        y = upsample2x_align_corners(y)
        y = F.relu(getattr(self, f"conv_hm_{i}_2")(y))
        return getattr(self, f"conv_hm_{i}_3")(y)

    def forward(self, heatmap, frame_feat, feat_tokens, anchors_2d,
                anchors_valid, bfb_mv, view: int
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """heatmap (B, J, h, w) this view's initial heatmaps; frame_feat
        (B, Cin, h, w) this view's FPN features; feat_tokens (V*B, h*w, Cin)
        every view's features as view-major tokens; anchors_2d (B, V, J, 2);
        anchors_valid (B, V, J); bfb_mv (B, V, 512) every view's pooled
        backbone bottom; ``view`` this refiner's view. Returns per-layer
        heatmaps (B, J, h, w) and refined features (B, Cin, h, w)."""
        B, J = heatmap.shape[0], self.num_heatmap
        x = self._queries(heatmap, bfb_mv, view)

        mem_kernel = self.frame_feat_multi_view_proj.weight.t()  # (Cin, C)
        mem_bias = self.frame_feat_multi_view_proj.bias
        mem_pos = self.frame_feat_multi_view_pos_embed[0]  # (V, HW, C)
        if not materialised(self.cfg.transformer, self.cfg.lazy_deform):
            memory, mem = feat_tokens, dict(mem_kernel=mem_kernel,
                                            mem_bias=mem_bias, mem_pos=mem_pos)
        else:
            # The memory on the grid, view-major, each view block of tokens
            # plus its own (HW, C) table, added in the JAX package's order
            # so that bf16 rounds the same way.
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
            list_heatmap.append(self._heatmap(
                i, refined.detach() if self.detach_heatmap_feat else refined))
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
    """Stage 2: the stereo estimators' backbones, the initial heatmaps,
    argmax anchors and the V refiners.

    With V >= 3 views the first two are the front stereo pair and the rest
    the back one, each with its own estimator and head (the 4-view rig);
    with fewer (the front pair alone, V = 2) every view goes through the
    front estimator and head, and the back ones are not built. The initial
    heatmaps come from the MVFex-level conv-stack heads, or with
    ``use_1by1_conv`` from the estimators' own 1x1 ``conv_heatmap``.

    ``forward`` returns ``(list_heatmap, list_feat)``: heatmaps batch-major
    (B, V, J, h, w); frame features view-major folded (V*B, Cin, h, w).
    """

    def __init__(self, cfg: MVFexNetCfg):
        super().__init__()
        self.cfg = cfg
        enc = cfg.encoder
        V = cfg.num_views
        self.has_back = V >= 3
        self.use_1by1_conv = cfg.mvf.use_1by1_conv
        head = (dict(num_heatmap=cfg.num_heatmap,
                     detach_heatmap_feat_init=cfg.detach_heatmap_feat_init)
                if self.use_1by1_conv else {})
        self.heatmap_estimator_stereo_front = HeatmapNet(
            enc.out_stride, enc.fpn_channels, enc.bn_folded, **head)
        if self.has_back:
            self.heatmap_estimator_stereo_back = HeatmapNet(
                enc.out_stride, enc.fpn_channels, enc.bn_folded, **head)
        self.refiners = nn.ModuleList(
            MVFexRefiner(V, cfg.num_heatmap, cfg.feat_shape,
                         cfg.detach_heatmap_feat, cfg.mvf)
            for _ in range(V))
        if not self.use_1by1_conv:
            self.conv_heatmap_head_front = ConvHeatmapHead(cfg.mvf.input_dims,
                                                           cfg.num_heatmap)
            if self.has_back:
                self.conv_heatmap_head_back = ConvHeatmapHead(cfg.mvf.input_dims,
                                                              cfg.num_heatmap)

    def _estimators(self):
        """The estimators that exist, front first, with their view slices."""
        if not self.has_back:
            return [(self.heatmap_estimator_stereo_front, slice(None))]
        return [(self.heatmap_estimator_stereo_front, slice(0, 2)),
                (self.heatmap_estimator_stereo_back, slice(2, None))]

    def _estimator_features(self, img):
        """Backbone features: the view-major (V*B, C, h, w) stack, the pooled
        (B, V, 512) backbone bottoms and the per-estimator halves (the back
        one None without a back pair)."""
        B = img.shape[0]

        def pooled(p):  # (n*B, 512, h, w) -> (B, n, 512)
            return p.mean(dim=(2, 3)).reshape(-1, B, p.shape[1]).transpose(0, 1)

        halves, bfbs = [], []
        for est, views in self._estimators():
            feat, pyr = est.backbone_features(img[:, views])
            halves.append(feat)
            bfbs.append(pooled(pyr[-1]))
        feat = halves[0] if len(halves) == 1 else torch.cat(halves, dim=0)
        return feat, torch.cat(bfbs, dim=1), (halves + [None])[:2]

    def _heatmaps_from_feat(self, feat_f, feat_b):
        """Conv-stack heads on the view-major halves (the back one None
        without a back pair) -> (B, V, J, h, w)."""
        B = feat_f.shape[0] // (2 if self.has_back else self.cfg.num_views)
        hms = [self.conv_heatmap_head_front(feat_f)]
        if feat_b is not None:
            hms.append(self.conv_heatmap_head_back(feat_b))
        hm = torch.cat([h.reshape(-1, B, *h.shape[1:]) for h in hms], dim=0)
        return hm.transpose(0, 1)

    def _estimator_heatmaps(self, halves, batch: int):
        """The estimators' own 1x1 heads on their halves -> (B, V, J, h, w)
        (``use_1by1_conv``)."""
        return torch.cat([est.head(half, batch) for (est, _), half
                          in zip(self._estimators(), halves)], dim=1)

    def get_anchors_2d(self, heatmap):
        """Per-view argmax anchors in [0, 1] and their validity."""
        pts2d, _, valid = argmax_2d(heatmap.detach(),
                                    threshold=self.cfg.heatmap_threshold,
                                    normalize=True)
        return pts2d, valid

    def _initial(self, img):
        """``(hm_init, feat_init, hm_for_refine, feat, bfb)`` under the JAX
        package's detach policy.

        With ``full_training`` off the estimators get no gradient (they run
        without autograd; train-mode BN still updates their running stats),
        with ``use_1by1_conv`` their heads included. With
        ``use_pred_heatmap_init`` the refiners see detached initial
        heatmaps, and the conv-stack heads detached features (the
        estimators' 1x1 heads keep theirs, as in the JAX package); without
        it (stage 2 as configured) the refiners' gradient reaches the
        initial heads through the heatmaps.
        """
        cfg = self.cfg
        B = img.shape[0]
        with torch.set_grad_enabled(cfg.full_training and torch.is_grad_enabled()):
            feat_init, bfb_init, halves = self._estimator_features(img)
            if self.use_1by1_conv:
                hm_init = self._estimator_heatmaps(halves[:len(self._estimators())], B)
        if not self.use_1by1_conv:
            if cfg.use_pred_heatmap_init:
                halves = [None if h is None else h.detach() for h in halves]
            hm_init = self._heatmaps_from_feat(*halves)
        if not cfg.use_pred_heatmap_init:
            return hm_init, feat_init, hm_init, feat_init, bfb_init
        if cfg.no_detach_feat_init:
            return hm_init, feat_init, hm_init.detach(), feat_init, bfb_init
        return (hm_init, feat_init, hm_init.detach(), feat_init.detach(),
                bfb_init.detach())

    def forward(self, img):
        """img (B, V, 3, H, W); see :meth:`_initial` for what gets
        gradients."""
        cfg = self.cfg
        B, V = img.shape[:2]
        if V != cfg.num_views:
            raise ValueError(f"expected {cfg.num_views} views, got {V}")
        hm_init, feat_init, hm_for_refine, feat, bfb = self._initial(img)

        anchors_2d, anchors_valid = self.get_anchors_2d(hm_init)
        tokens = to_tokens(feat)  # shared by every refiner's sampling
        per_view = [
            refiner(hm_for_refine[:, v], feat[v * B:(v + 1) * B], tokens,
                    anchors_2d, anchors_valid, bfb, v)
            for v, refiner in enumerate(self.refiners)
        ]
        list_heatmap, list_feat = [hm_init], [feat_init]
        for layer in range(cfg.mvf.num_former_layers):
            list_heatmap.append(torch.stack([hms[layer] for hms, _ in per_view], dim=1))
            list_feat.append(torch.cat([feats[layer] for _, feats in per_view], dim=0))
        return list_heatmap, list_feat
