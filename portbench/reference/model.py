"""The plain reference of the benchmark's two configurations: EgoRear's
stage-2 network (``EgoPoseFormerHeatmapMVFEX``) and its full cascade
(``EgoPoseFormerMVFEX``), in plain ``torch``, fp32, with the sampling done
by ``grid_sample``.

Frozen copy of ``tests/torch_ref.py`` at commit 6e4c43b (its
``BasicBlock``, ``Backbone``, ``Neck``, ``FFN``, ``SpatialMHA``,
``MSDeformAttnTorch``, ``MVTLayerTorch``, ``HeatmapMVFTorch``,
``MVFEXTorch``, ``FishEyeCameraTorch``, ``Pose3DTorch`` and
``EgoRearTorch``). State-dict keys are EgoRear's own (the layout its
Lightning checkpoints carry). Changes to the copy, each for the published
yamls the benchmark runs:

* the conv-stack heatmap heads (``use_1by1_conv: false``, the yamls'
  default): the MVFex-level ``conv_heatmap_layers_stereo_{front,back}``
  and each refiner layer's ``conv_heatmap_layers.<i>``; the stage-1
  estimators then carry no ``conv_heatmap``;
* the training flags of the yamls (``full_training``,
  ``use_pred_heatmap_init``, ``detach_heatmap_feat``), with the stops of
  gradient they place, so that the forward serves a training step too;
* every constant is made on the input's device;
* LayerNorm epsilon 1e-6 (see ``LN_EPS``);
* the proposal MLP reads its input channels last (``Pose3DTorch.forward``).

It imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# The port (and the JAX package it follows) normalise with flax's epsilon;
# EgoRear's modules use torch's default, 1e-5. The port's choice is the one
# the benchmark holds it to; PERF.md lists the difference.
LN_EPS = 1e-6

VIEWS = ("front_left", "front_right", "back_left", "back_right")


def layer_norm(dims):
    return nn.LayerNorm(dims, eps=LN_EPS)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + idt)


class Backbone(nn.Module):
    """torchvision-resnet18 split into stride stages (resnet.py:6-74)."""

    def __init__(self):
        super().__init__()
        self.layer_s2 = nn.Sequential(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64), nn.ReLU())
        self.layer_s4 = nn.Sequential(
            nn.MaxPool2d(3, 2, 1), nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64)))
        self.layer_s8 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer_s16 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer_s32 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x):
        s4 = self.layer_s4(self.layer_s2(x))
        s8 = self.layer_s8(s4)
        s16 = self.layer_s16(s8)
        return [s4, s8, s16, self.layer_s32(s16)]


class Neck(nn.Module):
    """EfficientFPN (resnet.py:77-137)."""

    def __init__(self, in_channels=(64, 128, 256, 512), out_channels=128):
        super().__init__()
        self.updample = nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)
        self.lateral_convs = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, out_channels, 1), nn.ReLU()) for c in in_channels])
        self.fuse_convs = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(out_channels * 2, out_channels, 1), nn.ReLU())
             for _ in in_channels[1:]])
        self.fpn_convs = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(out_channels, out_channels, 3, padding=1), nn.ReLU())
             for _ in in_channels[1:]])

    def forward(self, feats):
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = self.fpn_convs[i - 1](self.fuse_convs[i - 1](
                torch.cat((laterals[i - 1], self.updample(laterals[i])), dim=1)))
        return laterals[0]


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = Backbone()
        self.neck = Neck()

    def forward(self, x):
        feats = self.backbone(x)
        return self.neck(feats), feats


class HeatmapModel(nn.Module):
    """EgoPoseFormerHeatmap (egoposeformer_heatmap.py:9-44), one view
    folded into the batch; without ``num_heatmap`` no 1x1 head (inside the
    MVFex network with its conv-stack heads)."""

    def __init__(self, num_heatmap=None):
        super().__init__()
        self.encoder = Encoder()
        if num_heatmap is not None:
            self.conv_heatmap = nn.Conv2d(128, num_heatmap, 1)

    def forward(self, x):
        return self.encoder(x)


def conv_stack_head(d, num_heatmap):
    """The MVFex-level conv-stack heatmap head (Sequential indices 0, 2, 4,
    7, 9 hold the convs)."""
    return nn.Sequential(
        nn.Conv2d(d, d, 1), nn.ReLU(),
        nn.Conv2d(d, 2 * d, 3, 2, 1), nn.ReLU(),
        nn.Conv2d(2 * d, 2 * d, 1), nn.ReLU(),
        nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
        nn.Conv2d(2 * d, d, 1), nn.ReLU(),
        nn.Conv2d(d, num_heatmap, 1))


def refiner_heatmap_head(d, num_heatmap):
    """A refiner layer's conv-stack heatmap head (convs at 0, 2, 5, 7)."""
    return nn.Sequential(
        nn.Conv2d(d, 2 * d, 3, 2, 1), nn.ReLU(),
        nn.Conv2d(2 * d, 2 * d, 1), nn.ReLU(),
        nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
        nn.Conv2d(2 * d, d, 1), nn.ReLU(),
        nn.Conv2d(d, num_heatmap, 1))


class FFN(nn.Module):
    """transformer.py:8-33."""

    def __init__(self, embed_dims, feedforward_dims, num_fcs=2):
        super().__init__()
        layers, cin = [], embed_dims
        for _ in range(num_fcs - 1):
            layers.append(nn.Sequential(nn.Linear(cin, feedforward_dims), nn.GELU(),
                                        nn.Dropout(0.0)))
            cin = feedforward_dims
        layers += [nn.Linear(feedforward_dims, embed_dims), nn.Dropout(0.0)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class SpatialMHA(nn.Module):
    """CustomMultiheadAttention + SpatialMHA forward (transformer.py:36-108)."""

    def __init__(self, embed_dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.head_dims = embed_dim // num_heads
        self.scale = self.head_dims ** -0.5
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v):
        B, J, C = q.shape

        def heads(x):
            return x.reshape(B, J, self.num_heads, self.head_dims).permute(0, 2, 1, 3)

        attn = (heads(self.q_proj(q)) @ heads(self.k_proj(k)).transpose(-2, -1)) * self.scale
        x = (attn.softmax(dim=-1) @ heads(self.v_proj(v))).permute(0, 2, 1, 3)
        return self.out_proj(x.reshape(B, J, C))


class MSDeformAttnTorch(nn.Module):
    """deform_attn.py:25-168 with the CUDA kernel replaced by grid_sample
    (bilinear, zeros padding, align_corners=False)."""

    def __init__(self, d_model, n_heads, n_points, H, W):
        super().__init__()
        self.nh, self.np_, self.H, self.W = n_heads, n_points, H, W
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, ref_pts, value_flat):
        B, Q, C = query.shape
        nh, P, H, W = self.nh, self.np_, self.H, self.W
        v = self.value_proj(value_flat).reshape(B, H * W, nh, C // nh)
        off = self.sampling_offsets(query).reshape(B, Q, nh, P, 2)
        w = self.attention_weights(query).reshape(B, Q, nh, P).softmax(-1)
        loc = ref_pts[:, :, None, None, :] + off / torch.tensor(
            [W, H], dtype=query.dtype, device=query.device)
        vmap = v.permute(0, 2, 3, 1).reshape(B * nh, C // nh, H, W)
        grid = (2.0 * loc - 1.0).permute(0, 2, 1, 3, 4).reshape(B * nh, Q, P, 2)
        samp = F.grid_sample(vmap, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False).reshape(B, nh, C // nh, Q, P)
        out = (samp * w.permute(0, 2, 1, 3)[:, :, None]).sum(-1)
        return self.output_proj(out.permute(0, 3, 1, 2).reshape(B, Q, C))


class MVTLayerTorch(nn.Module):
    """MultiViewTransformerLayer (egoposeformer_heatmap_mvf_ex.py:820-935)."""

    def __init__(self, num_views, embed_dims, H, W, num_heads=4, ffn_dims=512):
        super().__init__()
        self.cross_attn = MSDeformAttnTorch(embed_dims, num_heads, 16, H, W)
        self.fuse_mlp = nn.Linear(num_views * embed_dims, embed_dims)
        self.norm_cross = layer_norm(embed_dims)
        self.spatial_attn = SpatialMHA(embed_dims, num_heads)
        self.norm_spatial = layer_norm(embed_dims)
        self.ffn = FFN(embed_dims, ffn_dims)
        self.norm_ffn = layer_norm(embed_dims)

    def forward(self, q, memory, anchors_2d, anchors_valid):
        feats = []
        for i in range(memory.shape[1]):
            r = self.cross_attn(q, anchors_2d[:, i], memory[:, i])
            feats.append(r.masked_fill(~anchors_valid[:, i][..., None].expand_as(r), 0.0))
        x = self.norm_cross(q + self.fuse_mlp(torch.cat(feats, dim=-1)))
        x = self.norm_spatial(x + self.spatial_attn(x, x, x))
        return self.norm_ffn(x + self.ffn(x))


class HeatmapMVFTorch(nn.Module):
    """HeatmapMVF in JQA mode with the conv-stack heads
    (egoposeformer_heatmap_mvf_ex.py:442-731)."""

    GRID_PROJ = "frame_feat_multi_view_proj"  # read by the cross-attention alone

    def __init__(self, num_views=4, num_heatmap=15, input_dims=128, embed_dims=256,
                 num_layers=1, feat=64, detach_hm=False):
        super().__init__()
        self.J, self.V, self.feat, self.detach_hm = num_heatmap, num_views, feat, detach_hm
        self.heatmap_proj = nn.Sequential(
            nn.Linear(feat * feat, embed_dims), nn.ReLU(), nn.Linear(embed_dims, embed_dims))
        self.fc_bfb = nn.Linear(512, embed_dims)
        self.fc_query = nn.Sequential(nn.Linear(embed_dims, embed_dims), nn.ReLU())
        self.joint_query_embed = nn.Embedding(num_heatmap, embed_dims)
        self.frame_feat_multi_view_proj = nn.Conv2d(input_dims, embed_dims, 1)
        self.frame_feat_multi_view_pos_embed = nn.Parameter(
            torch.zeros(1, num_views, feat * feat, embed_dims))
        self.frame_feat_proj_layers = nn.Sequential(
            nn.Conv2d(input_dims, input_dims * 2, 1), nn.ReLU(),
            nn.Conv2d(input_dims * 2, input_dims * 4, 3, 2, 1), nn.ReLU(),
            nn.Conv2d(input_dims * 4, input_dims, 1), nn.ReLU())
        self.transformer_layers = nn.ModuleList(
            [MVTLayerTorch(num_views, embed_dims, feat, feat) for _ in range(num_layers)])
        self.post_norm = nn.ModuleList([layer_norm(embed_dims) for _ in range(num_layers)])
        self.head_layers = nn.ModuleList()
        for _ in range(num_layers):
            wrapper = nn.Module()
            wrapper.head = nn.Sequential(
                nn.Conv2d(num_heatmap, input_dims // 2, 1), nn.ReLU(),
                nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
                nn.Conv2d(input_dims // 2, input_dims, 1), nn.ReLU())
            self.head_layers.append(wrapper)
        self.frame_feat_refined_proj_layers = nn.ModuleList([
            nn.Sequential(nn.Conv2d(input_dims, input_dims, 1), nn.ReLU(),
                          nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
                          nn.Conv2d(input_dims, input_dims, 1), nn.ReLU())
            for _ in range(num_layers)])
        self.conv_heatmap_layers = nn.ModuleList(
            [refiner_heatmap_head(input_dims, num_heatmap) for _ in range(num_layers)])

    def forward(self, heatmap, frame_feat, frame_feat_mv, anchors_2d, anchors_valid, bfb):
        B, V, C, H, W = frame_feat_mv.shape
        hm_embed = self.heatmap_proj(heatmap.reshape(B, self.J, -1))
        bfb_e = self.fc_bfb(F.adaptive_avg_pool2d(bfb, (1, 1)).reshape(B, -1)).unsqueeze(1)
        jq = self.joint_query_embed.weight.unsqueeze(0).repeat(B, 1, 1)
        x = self.fc_query(jq + bfb_e + hm_embed)

        mv = self.frame_feat_multi_view_proj(frame_feat_mv.reshape(B * V, C, H, W))
        mv = mv.reshape(B, V, -1, H * W).permute(0, 1, 3, 2) + self.frame_feat_multi_view_pos_embed
        f = self.frame_feat_proj_layers(frame_feat)

        hms, feats = [], []
        for i, layer in enumerate(self.transformer_layers):
            x = layer(x, mv, anchors_2d, anchors_valid)
            _x = self.post_norm[i](x)
            side = int(math.sqrt(_x.shape[-1]))
            off = self.head_layers[i].head(_x.reshape(B, self.J, side, side))
            if off.shape[-2:] != f.shape[-2:]:  # never at the published 256 px
                off = F.interpolate(off, size=f.shape[-2:], mode="bilinear",
                                    align_corners=True)
            refined = self.frame_feat_refined_proj_layers[i](off + f.detach())
            feats.append(refined)
            hms.append(self.conv_heatmap_layers[i](refined.detach() if self.detach_hm
                                                   else refined))
        return hms, feats


def argmax_anchors(hm, th):
    """Per-map argmax in [0, 1] (x / W, y / H) and whether the peak reaches
    ``th``; ties go to the first maximum in row-major order."""
    B, V, J, H, W = hm.shape
    maxv, idx = hm.reshape(B, V, J, -1).max(dim=-1)
    x = (idx % W).float() / W
    y = torch.div(idx, W, rounding_mode="floor").float() / H
    return torch.stack([x, y], -1), maxv >= th


class MVFEXTorch(nn.Module):
    """EgoPoseFormerHeatmapMVFEX, 4 views, JQA, conv-stack heads
    (egoposeformer_heatmap_mvf_ex.py:27-437). ``full_training`` lets the
    estimators learn; ``use_pred_heatmap_init`` feeds the refiners (and the
    initial heads) detached inputs; ``detach_hm`` stops the refined
    features' gradient at the refiners' heads."""

    def __init__(self, num_heatmap=15, threshold=0.5, feat=64, full_training=False,
                 use_pred_heatmap_init=False, detach_hm=False):
        super().__init__()
        self.J, self.th, self.feat = num_heatmap, threshold, feat
        self.full_training = full_training
        self.use_pred_heatmap_init = use_pred_heatmap_init
        self.heatmap_estimator_stereo_front = HeatmapModel()
        self.heatmap_estimator_stereo_back = HeatmapModel()
        self.conv_heatmap_layers_stereo_front = conv_stack_head(128, num_heatmap)
        self.conv_heatmap_layers_stereo_back = conv_stack_head(128, num_heatmap)
        for n in VIEWS:
            setattr(self, f"heatmap_refiner_{n}", HeatmapMVFTorch(feat=feat, detach_hm=detach_hm))

    def _estimate(self, img):  # img (B, 4, 3, H, W)
        B = img.shape[0]
        feats, pyrs = [], []
        for est, sl in ((self.heatmap_estimator_stereo_front, slice(0, 2)),
                        (self.heatmap_estimator_stereo_back, slice(2, 4))):
            feat, pyr = est(img[:, sl].reshape(B * 2, *img.shape[2:]))
            feats.append(feat)
            pyrs.append(pyr[-1])
        return feats, pyrs

    def forward(self, img):
        B = img.shape[0]
        with torch.set_grad_enabled(self.full_training and torch.is_grad_enabled()):
            feats, pyrs = self._estimate(img)
        heads_in = [f.detach() for f in feats] if self.use_pred_heatmap_init else feats
        hm_init = torch.cat([
            head(f).reshape(B, 2, self.J, *f.shape[-2:])
            for head, f in zip((self.conv_heatmap_layers_stereo_front,
                                self.conv_heatmap_layers_stereo_back), heads_in)], 1)
        feat = torch.cat([f.reshape(B, 2, *f.shape[1:]) for f in feats], 1)
        bfb = torch.cat([p.reshape(B, 2, *p.shape[1:]) for p in pyrs], 1)
        anchors, valid = argmax_anchors(hm_init.detach(), self.th)
        hm_r, feat_r, bfb_r = hm_init, feat, bfb
        if self.use_pred_heatmap_init:
            hm_r, feat_r, bfb_r = hm_init.detach(), feat.detach(), bfb.detach()
        per_view = [getattr(self, f"heatmap_refiner_{n}")(
            hm_r[:, v], feat_r[:, v], feat_r, anchors, valid, bfb_r[:, v])
            for v, n in enumerate(VIEWS)]
        hms_all, feats_all = [hm_init], [feat]
        for i in range(len(per_view[0][0])):
            hms_all.append(torch.stack([hms[i] for hms, _ in per_view], 1))
            feats_all.append(torch.stack([fs[i] for _, fs in per_view], 1))
        return hms_all, feats_all


class FishEyeCameraTorch:
    """utils/camera_models.py:14-104 (syn mode), including the in-place
    offset/flip mutation of the shared anchor tensor (:57-63)."""

    OFFSETS = {"camera_front_left": (6.0, 0.0, 0.0), "camera_front_right": (-6.0, 0.0, 0.0),
               "camera_back_left": (-6.0, 37.0, 0.0), "camera_back_right": (6.0, 37.0, 0.0)}

    def __init__(self, calib, name):
        self.calib = calib
        self.offset = self.OFFSETS[name]
        self.flip = name in ("camera_back_left", "camera_back_right")

    def world2camera(self, pts3d):
        """Projects ``pts3d`` (B, J, 3), mutating it as the reference does;
        returns the clamped points (B, 1, J, 2), the in-view mask and the
        unclamped points (the last for the benchmark's conditioning check)."""
        with torch.no_grad():
            if self.flip:
                pts3d[..., 0:2] *= -1
            pts3d += torch.tensor(self.offset, dtype=pts3d.dtype, device=pts3d.device)
            p = pts3d[:, None]
            x, y, z = p[..., 0], p[..., 1], p[..., 2]
            norm = torch.sqrt(x * x + y * y)
            theta = torch.atan(-z / norm)
            rho = sum(a * theta ** i for i, a in enumerate(self.calib["poly_world2cam"]))
            u = (x / norm * rho + self.calib["center_xy"][0]) / self.calib["image_size_hw"][1]
            v = (y / norm * rho + self.calib["center_xy"][1]) / self.calib["image_size_hw"][0]
            pt = torch.stack((u, v), dim=-1)
            fov = (u > 0) & (v > 0) & (u < 1) & (v < 1)
            return pt.clamp(0.0, 1.0), fov, pt


class Pose3DTorch(nn.Module):
    """EgoPoseFormerPose3D, conv-downsample proposal head, memory from the
    initial features (``use_pred_heatmap_init``) (egoposeformer_mvf_ex.py:62-452)."""

    CAMERAS = ("camera_front_left", "camera_front_right", "camera_back_left",
               "camera_back_right")
    GRID_PROJ = "feat_proj"  # read by the cross-attention alone

    def __init__(self, calibs, num_views=4, num_joints=16, input_dims=128,
                 embed_dims=128, num_layers=3, feat=64):
        super().__init__()
        self.J, self.V, self.feat = num_joints, num_views, feat
        self.cameras = [FishEyeCameraTorch(calibs[n], n) for n in self.CAMERAS[:num_views]]
        self.feat_proj = nn.Conv2d(input_dims, embed_dims, 1)
        self.layers = nn.ModuleList(
            [MVTLayerTorch(num_views, embed_dims, feat, feat) for _ in range(num_layers)])
        self.query_gen_mlp = nn.Sequential(
            nn.Linear(4, embed_dims), nn.ReLU(), nn.Linear(embed_dims, embed_dims), nn.ReLU(),
            nn.Linear(embed_dims, embed_dims))
        self.conv_frame_feat = nn.Sequential(
            nn.Conv2d(input_dims, input_dims // 2, 1), nn.ReLU(),
            nn.Conv2d(input_dims // 2, input_dims, 3, 2, 1), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(input_dims, input_dims // 2, 1), nn.ReLU(),
            nn.Conv2d(input_dims // 2, input_dims, 3, 2, 1), nn.ReLU())
        mlp, in_dims = [], num_views * 128 * (feat // 8) * (feat // 8)
        for _ in range(2):
            mlp.append(nn.Sequential(nn.Linear(in_dims, in_dims // 16), nn.GELU(),
                                     nn.Dropout(0.0)))
            in_dims //= 16
        mlp.append(nn.Linear(in_dims, 3 * num_joints))
        self.mlp_pred = nn.Sequential(*mlp)
        self.reg_mlp = nn.ModuleList([nn.Sequential(
            nn.Linear(embed_dims, embed_dims), nn.GELU(), nn.Linear(embed_dims, 3))
            for _ in range(num_layers)])
        self.post_norm = nn.ModuleList([layer_norm(embed_dims) for _ in range(num_layers)])
        self.last_projection = None  # unclamped (B, V, J, 2) of the last call

    def forward(self, feats_init, feats_final):
        B, V, C, H, W = feats_final.shape
        ff = self.feat_proj(feats_init.reshape(B * V, C, H, W))
        memory = ff.reshape(B, V, -1, H * W).permute(0, 1, 3, 2)
        y = self.conv_frame_feat(feats_final.reshape(B * V, C, H, W))
        # Views outermost, then rows, columns and channels: the order the
        # JAX package and the port give mlp_pred's rows (tests/torch_ref.py
        # flattens channels before rows; PERF.md lists the question).
        y = y.permute(0, 2, 3, 1).reshape(B, -1)
        mlp_pred = self.mlp_pred(y).reshape(B, self.J, 3)

        anchors = mlp_pred.clone().detach()
        pts, fovs, raw = [], [], []
        for cam in self.cameras:  # mutates ``anchors`` in place
            pt, fov, unclamped = cam.world2camera(anchors)
            pts.append(pt)
            fovs.append(fov)
            raw.append(unclamped)
        self.last_projection = torch.cat(raw, dim=1)
        anchors_2d, anchors_valid = torch.cat(pts, dim=1), torch.cat(fovs, dim=1)

        joint_inds = (torch.arange(1, self.J + 1, dtype=memory.dtype, device=memory.device)
                      .reshape(1, self.J, 1).repeat(B, 1, 1)) / float(self.J)
        x = self.query_gen_mlp(torch.cat((joint_inds, anchors), dim=-1))
        preds = [mlp_pred]
        for i, layer in enumerate(self.layers):
            x = layer(x, memory, anchors_2d, anchors_valid)
            preds.append(self.reg_mlp[i](self.post_norm[i](x)) + anchors.detach())
        return preds


class EgoRearTorch(nn.Module):
    """EgoPoseFormerMVFEX full cascade (egoposeformer_mvf_ex.py:22-59)."""

    def __init__(self, calibs, feat=64, num_layers=3, **mvfex_flags):
        super().__init__()
        self.heatmap_estimator = MVFEXTorch(feat=feat, **mvfex_flags)
        self.pose3d_estimator = Pose3DTorch(calibs, feat=feat, num_layers=num_layers)

    def forward(self, img):
        hms, feats = self.heatmap_estimator(img)
        return self.pose3d_estimator(feats[0], feats[-1]), hms
