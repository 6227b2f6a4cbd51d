"""Frozen model-config dataclasses.

The port's own copy of the JAX package's ``models/configs.py``: the same
frozen dataclasses and the same ``from_dict`` grammar, so the flagship config
dict parses unchanged. ``from_dict`` accepts the reference YAML key spelling
verbatim (including keys the reference silently swallows, like
``batch_first`` and ``anchor_2d_update``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class EncoderCfg:
    model_name: str = "resnet18"
    out_stride: int = 4
    use_imagenet_pretrain: bool = True
    fpn_channels: int = 128
    # Serving-only: build the ResNet with BN pre-folded into conv weights
    # (see models/backbone.fold_batchnorm). Not a reference YAML key.
    bn_folded: bool = False

    @staticmethod
    def from_dict(d: Optional[dict]) -> "EncoderCfg":
        if d is None:
            return EncoderCfg()
        resnet = d.get("resnet_cfg", {})
        neck = d.get("neck_cfg", {})
        return EncoderCfg(
            model_name=resnet.get("model_name", "resnet18"),
            out_stride=resnet.get("out_stride", 4),
            use_imagenet_pretrain=resnet.get("use_imagenet_pretrain", True),
            fpn_channels=neck.get("out_channels", 128),
            bn_folded=resnet.get("bn_folded", False),
        )


@dataclass(frozen=True)
class AttnCfg:
    num_heads: int = 4

    @staticmethod
    def from_dict(d: Optional[dict]) -> "AttnCfg":
        if d is None:
            return AttnCfg()
        return AttnCfg(num_heads=d.get("num_heads", 4))


@dataclass(frozen=True)
class FFNCfg:
    feedforward_dims: int = 512
    num_fcs: int = 2
    ffn_drop: float = 0.0

    @staticmethod
    def from_dict(d: Optional[dict]) -> "FFNCfg":
        if d is None:
            return FFNCfg()
        return FFNCfg(
            feedforward_dims=d.get("feedforward_dims", 512),
            num_fcs=d.get("num_fcs", 2),
            ffn_drop=d.get("ffn_drop", 0.0),
        )


@dataclass(frozen=True)
class TransformerLayerCfg:
    cross_attn: AttnCfg = AttnCfg()
    spatial_attn: AttnCfg = AttnCfg()
    ffn: FFNCfg = FFNCfg()
    use_normal_cross_attn: bool = False

    @staticmethod
    def from_dict(d: Optional[dict]) -> "TransformerLayerCfg":
        if d is None:
            return TransformerLayerCfg()
        return TransformerLayerCfg(
            cross_attn=AttnCfg.from_dict(d.get("cross_attn_cfg")),
            spatial_attn=AttnCfg.from_dict(d.get("spatial_attn_cfg")),
            ffn=FFNCfg.from_dict(d.get("ffn_cfg")),
            use_normal_cross_attn=d.get("use_normal_cross_attn", False),
        )


@dataclass(frozen=True)
class MVFCfg:
    """HeatmapMVF refiner config (egoposeformer_heatmap_mvf_ex.py:442-520)."""

    input_dims: int = 128
    embed_dims: int = 256
    num_former_layers: int = 1
    joint_query_adaptation: bool = False
    joint_query_adaptation_multi_view: bool = False
    joint_query_only: bool = False
    use_1by1_conv: bool = False
    lazy_deform: bool = True  # sample raw memory, project post-sampling
    transformer: TransformerLayerCfg = TransformerLayerCfg()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "MVFCfg":
        if d is None:
            return MVFCfg()
        return MVFCfg(
            input_dims=d.get("input_dims", 128),
            embed_dims=d.get("embed_dims", 256),
            num_former_layers=d.get("num_former_layers", 1),
            joint_query_adaptation=d.get("joint_query_adaptation", False),
            joint_query_adaptation_multi_view=d.get(
                "joint_query_adaptation_multi_view", False
            ),
            joint_query_only=d.get("joint_query_only", False),
            use_1by1_conv=d.get("use_1by1_conv", False),
            lazy_deform=d.get("lazy_deform", True),
            transformer=TransformerLayerCfg.from_dict(d.get("mvf_transformer_cfg")),
        )


@dataclass(frozen=True)
class MVFexNetCfg:
    """EgoPoseFormerHeatmapMVFEX config (egoposeformer_heatmap_mvf_ex.py:27-126)."""

    num_views: int = 4
    image_size: Tuple[int, int] = (256, 256)
    num_heatmap: int = 15
    feat_down_stride: int = 4
    heatmap_threshold: float = 0.5
    camera_model: str = "ego4view_syn"
    full_training: bool = False
    detach_heatmap_feat: bool = False
    detach_heatmap_feat_init: bool = False
    use_pred_heatmap_init: bool = False
    no_detach_feat_init: bool = False
    encoder: EncoderCfg = EncoderCfg()
    mvf: MVFCfg = MVFCfg()

    @staticmethod
    def from_dict(d: dict) -> "MVFexNetCfg":
        return MVFexNetCfg(
            num_views=d.get("num_views", 4),
            image_size=tuple(d.get("image_size", (256, 256))),
            num_heatmap=d.get("num_heatmap", 15),
            feat_down_stride=d.get("feat_down_stride", 4),
            heatmap_threshold=d.get("heatmap_threshold", 0.5),
            camera_model=d.get("camera_model", "ego4view_syn"),
            full_training=d.get("full_training", False),
            detach_heatmap_feat=d.get("detach_heatmap_feat", False),
            detach_heatmap_feat_init=d.get("detach_heatmap_feat_init", False),
            use_pred_heatmap_init=d.get("use_pred_heatmap_init", False),
            no_detach_feat_init=d.get("no_detach_feat_init", False),
            encoder=EncoderCfg.from_dict(d.get("encoder_cfg")),
            mvf=MVFCfg.from_dict(d.get("mvf_cfg")),
        )

    @property
    def feat_shape(self) -> Tuple[int, int]:
        return (
            self.image_size[0] // self.feat_down_stride,
            self.image_size[1] // self.feat_down_stride,
        )


@dataclass(frozen=True)
class Pose3DCfg:
    """EgoPoseFormerPose3D config (egoposeformer_mvf_ex.py:62-270)."""

    num_joints: int = 16
    input_dims: int = 128
    embed_dims: int = 128
    mlp_dims: int = 1024
    mlp_dropout: float = 0.0
    num_mlp_layers: int = 2
    num_former_layers: int = 3
    num_pred_mlp_layers: int = 2
    feat_down_stride: int = 4
    norm_mlp_pred: bool = False
    coor_norm_max: Optional[Tuple[float, ...]] = None
    coor_norm_min: Optional[Tuple[float, ...]] = None
    conv_heatmap_dim_init: int = 32
    use_mlp_avgpool: bool = False
    use_mlp_heatmap: bool = False
    lazy_deform: bool = True  # sample raw memory, project post-sampling
    transformer: TransformerLayerCfg = TransformerLayerCfg()

    @staticmethod
    def from_dict(d: Optional[dict]) -> "Pose3DCfg":
        if d is None:
            return Pose3DCfg()
        tup = lambda v: tuple(v) if v is not None else None
        return Pose3DCfg(
            num_joints=d.get("num_joints", 16),
            input_dims=d.get("input_dims", 128),
            embed_dims=d.get("embed_dims", 128),
            mlp_dims=d.get("mlp_dims", 1024),
            mlp_dropout=d.get("mlp_dropout", 0.0),
            num_mlp_layers=d.get("num_mlp_layers", 2),
            num_former_layers=d.get("num_former_layers", 3),
            num_pred_mlp_layers=d.get("num_pred_mlp_layers", 2),
            feat_down_stride=d.get("feat_down_stride", 4),
            norm_mlp_pred=d.get("norm_mlp_pred", False),
            coor_norm_max=tup(d.get("coor_norm_max")),
            coor_norm_min=tup(d.get("coor_norm_min")),
            conv_heatmap_dim_init=d.get("conv_heatmap_dim_init", 32),
            use_mlp_avgpool=d.get("use_mlp_avgpool", False),
            use_mlp_heatmap=d.get("use_mlp_heatmap", False),
            lazy_deform=d.get("lazy_deform", True),
            transformer=TransformerLayerCfg.from_dict(d.get("transformer_cfg")),
        )


@dataclass(frozen=True)
class EgoRearNetCfg:
    """Top-level EgoPoseFormerMVFEX config (egoposeformer_mvf_ex.py:22-48)."""

    num_views: int = 4
    image_size: Tuple[int, int] = (256, 256)
    camera_model: str = "ego4view_syn"
    heatmap_mvf: MVFexNetCfg = MVFexNetCfg()
    pose3d: Pose3DCfg = Pose3DCfg()
    camera_calib_path: Optional[str] = None

    @staticmethod
    def from_dict(d: dict) -> "EgoRearNetCfg":
        num_views = d.get("num_views", 4)
        image_size = tuple(d.get("image_size", (256, 256)))
        camera_model = d.get("camera_model", "ego4view_syn")
        hm = dict(d.get("heatmap_mvf_cfg", {}))
        hm.update(
            num_views=num_views, image_size=image_size, camera_model=camera_model
        )
        p3d = d.get("pose3d_cfg", {})
        return EgoRearNetCfg(
            num_views=num_views,
            image_size=image_size,
            camera_model=camera_model,
            heatmap_mvf=MVFexNetCfg.from_dict(hm),
            pose3d=Pose3DCfg.from_dict(p3d),
            camera_calib_path=p3d.get("camera_calib_file_dir_path_override")
            if p3d else None,
        )
