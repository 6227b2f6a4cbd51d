"""Entry point of the port: the flagship 4-view model on the card.

Counterpart of the JAX package's ``__graft_entry__.py``:
``FLAGSHIP_CFG`` (4 views, 256 px, ResNet18 + FPN, one MVFex/JQA layer, the
conv-downsample 3D proposal, 3 lifting layers) and :func:`build`.

    model, rig = build()                          # on cuda, fp32
    model, rig = build(bn_folded=True, dtype=torch.bfloat16)   # serving
    with torch.inference_mode():
        preds_3d, heatmaps = model(img, rig)      # img (B, 4, 3, 256, 256)
"""

from __future__ import annotations

import copy

import torch

from egorear_tpu_torch.models.backbone import fold_batchnorm
from egorear_tpu_torch.models.configs import EgoRearNetCfg
from egorear_tpu_torch.models.layers import init_weights
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.ops.camera import CameraRig

FLAGSHIP_CFG = {
    "num_views": 4,
    "image_size": [256, 256],
    "camera_model": "ego4view_syn",
    "pose3d_cfg": {
        "num_joints": 16, "input_dims": 128, "embed_dims": 128,
        "mlp_dims": 1024, "mlp_dropout": 0.0, "num_mlp_layers": 2,
        "num_former_layers": 3, "num_pred_mlp_layers": 2,
        "feat_down_stride": 4,
        "transformer_cfg": {
            "cross_attn_cfg": {"num_heads": 4},
            "spatial_attn_cfg": {"num_heads": 4},
            "ffn_cfg": {"feedforward_dims": 512, "num_fcs": 2, "ffn_drop": 0.0},
        },
    },
    "heatmap_mvf_cfg": {
        "num_heatmap": 15, "feat_down_stride": 4, "heatmap_threshold": 0.5,
        "full_training": True, "detach_heatmap_feat": True,
        "detach_heatmap_feat_init": True, "use_pred_heatmap_init": True,
        "encoder_cfg": {
            "resnet_cfg": {"model_name": "resnet18", "out_stride": 4,
                           "use_imagenet_pretrain": False},
            "neck_cfg": {"in_channels": [64, 128, 256, 512],
                         "out_channels": 128},
        },
        "mvf_cfg": {
            "input_dims": 128, "embed_dims": 256, "num_former_layers": 1,
            "joint_query_adaptation": True,
            "mvf_transformer_cfg": {
                "cross_attn_cfg": {"num_heads": 4},
                "spatial_attn_cfg": {"num_heads": 4},
                "ffn_cfg": {"feedforward_dims": 512, "num_fcs": 2,
                            "ffn_drop": 0.0},
            },
        },
    },
}


def flagship_cfg(image_size=(256, 256), bn_folded: bool = False) -> EgoRearNetCfg:
    """The flagship config at ``image_size`` (optionally BN-folded)."""
    d = copy.deepcopy(dict(FLAGSHIP_CFG, image_size=list(image_size)))
    if bn_folded:
        d["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["bn_folded"] = True
    return EgoRearNetCfg.from_dict(d)


def build(image_size=(256, 256), device=None, dtype=torch.float32,
          bn_folded: bool = False, seed: int = 0):
    """Build the flagship model with random weights from ``seed``.

    ``device=None`` means ``cuda``; without CUDA this raises, it never falls
    back to the CPU (pass ``device="cpu"`` explicitly). With ``bn_folded``
    the model is the serving variant: the same seeded weights with eval-mode
    BatchNorm folded into the convs in fp32, before the cast to ``dtype``.
    Returns ``(model, rig)``, the model in eval mode.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build: CUDA is not available; pass device='cpu' "
                           "to build on the CPU")
    cfg = flagship_cfg(image_size)
    model = init_weights(EgoRearNet(cfg), torch.Generator().manual_seed(seed))
    if bn_folded:
        folded = EgoRearNet(flagship_cfg(image_size, bn_folded=True))
        folded.load_state_dict(fold_batchnorm(model.state_dict()), strict=True)
        model = folded
    model = model.to(device=device, dtype=dtype).eval()
    rig = CameraRig.from_calib_file(cfg.camera_model, device=device)
    return model, rig
