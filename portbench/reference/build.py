"""The reference network of a configuration file, and what it is checked
on: the forward that a cell's comparison reads, with the margins that say
which samples fp32 rounding can decide."""

from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.nn as nn

from portbench.reference.model import EgoRearTorch, MVFEXTorch

CALIB = Path(__file__).with_name("ego4view_rig.json")


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"the reference does not implement {what}")


def _check_mvfex(cfg: dict) -> None:
    mvf = cfg.get("mvf_cfg", {})
    _need(cfg.get("num_views", 4) == 4, "a rig of other than 4 views")
    _need(not mvf.get("use_1by1_conv", False), "use_1by1_conv")
    _need(mvf.get("joint_query_adaptation", False), "refiners without JQA")
    _need(mvf.get("input_dims", 128) == 128 and mvf.get("embed_dims", 256) == 256,
          "other refiner widths")
    _need(mvf.get("num_former_layers", 1) == 1, "more than one refiner layer")
    _need(cfg.get("encoder_cfg", {}).get("resnet_cfg", {}).get("model_name") == "resnet18",
          "another backbone")


def build_reference(task: str, model_cfg: dict) -> nn.Module:
    """The reference module of ``task`` (``heatmap_mvf_ex`` or
    ``pose_3d_mvf_ex``) for a yaml's ``model_cfg``, on the current default
    device, with torch's own initial weights."""
    image = model_cfg.get("image_size", [256, 256])
    _need(image[0] == image[1], "non-square images")
    feat = image[0] // 4
    if task == "heatmap_mvf_ex":
        _check_mvfex(model_cfg)
        return MVFEXTorch(model_cfg.get("num_heatmap", 15), model_cfg.get("heatmap_threshold", 0.5),
                          feat=feat, full_training=model_cfg.get("full_training", False),
                          use_pred_heatmap_init=model_cfg.get("use_pred_heatmap_init", False),
                          detach_hm=model_cfg.get("detach_heatmap_feat", False))
    if task == "pose_3d_mvf_ex":
        hm = dict(model_cfg["heatmap_mvf_cfg"], num_views=model_cfg.get("num_views", 4))
        _check_mvfex(hm)
        p3d = model_cfg["pose3d_cfg"]
        _need(model_cfg.get("camera_model") == "ego4view_syn", "another rig")
        _need(hm.get("use_pred_heatmap_init", False), "memory from the final features")
        _need(not (p3d.get("use_mlp_avgpool") or p3d.get("use_mlp_heatmap")
                   or p3d.get("norm_mlp_pred")), "another proposal")
        _need(p3d.get("num_pred_mlp_layers", 2) == 2 and p3d.get("num_mlp_layers", 2) == 2,
              "other MLP depths")
        with open(CALIB) as f:
            calibs = json.load(f)["cameras"]
        return EgoRearTorch(calibs, feat=feat, num_layers=p3d.get("num_former_layers", 3),
                            threshold=hm.get("heatmap_threshold", 0.5),
                            full_training=hm.get("full_training", False),
                            use_pred_heatmap_init=True,
                            detach_hm=hm.get("detach_heatmap_feat", False))
    raise ValueError(f"no reference for task {task!r}")


def forward(task: str, model: nn.Module, img: torch.Tensor):
    """``(preds_3d, heatmaps)`` of the reference (no 3D stages for stage 2)."""
    if task == "heatmap_mvf_ex":
        hms, _ = model(img)
        return [], hms
    return model(img)


def margins(task: str, model: nn.Module, heatmaps, threshold: float):
    """Per sample (B,), the least distance of the reference's last forward
    from a decision that rounding could flip: the gap between the two
    largest values of each initial heatmap and between its peak and the
    validity threshold, relative to the batch's largest initial heatmap
    value; and (stage 3) the least distance of a projected anchor from an
    image border, in image widths."""
    hm0 = heatmaps[0]
    B = hm0.shape[0]
    top = hm0.reshape(B, -1, hm0.shape[-2] * hm0.shape[-1]).topk(2, dim=-1).values
    scale = hm0.abs().max().clamp_min(1e-30)
    m_hm = torch.minimum(top[..., 0] - top[..., 1], (top[..., 0] - threshold).abs())
    m_hm = (m_hm / scale).amin(dim=-1)
    if task == "heatmap_mvf_ex":
        return m_hm, torch.full_like(m_hm, float("inf"))
    uv = model.pose3d_estimator.last_projection
    m_fov = torch.minimum(uv.abs(), (1 - uv).abs()).reshape(B, -1).amin(dim=-1)
    return m_hm, m_fov
