"""Training tasks: model + loss + eval metrics (the JAX package's
``train/tasks.py``). Ported: the stage-3 :class:`Pose3DTask` for the
synthetic rig, with the loss helpers and the pose metric suite. Metric names
follow the JAX package (``mpjpe_loss_{i}``, ``heatmap_loss_{i}``,
``loss_total``; ``{prefix}_mpjpe`` ...).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from egorear_tpu_torch.models.configs import EgoRearNetCfg
from egorear_tpu_torch.models.layers import init_weights
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.metrics import (
    auc_3d,
    mpjpe,
    mpjpe_loss,
    pck_3d,
    procrustes_align,
)

CM2MM = 10.0

Metrics = Dict[str, torch.Tensor]


def prepare_batch(batch: dict) -> dict:
    """Host-prepared batches pass through. The uint8 device path of the JAX
    package (``img_u8``: normalisation and Gaussian target rendering on the
    device) is not ported yet and raises."""
    if "img_u8" in batch:
        raise NotImplementedError("uint8 batches (img_u8) need the data "
                                  "slice's device preprocessing")
    return batch


def _per_view_mse_sum(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Sum over views of the per-view mean squared error: the mean over every
    axis but the view axis (1), then the sum."""
    d2 = (pred - gt) ** 2
    return d2.mean(dim=(0,) + tuple(range(2, d2.dim()))).sum()


def pose_eval_metrics(pred: torch.Tensor, gt: torch.Tensor,
                      prefix: str) -> Metrics:
    """Per-sample MPJPE / PA-MPJPE (mm) and PCK3D / AUC3D (%), cm inputs."""
    aligned = procrustes_align(pred, gt)
    return {
        f"{prefix}_mpjpe": mpjpe(pred, gt) * CM2MM,
        f"{prefix}_pa_mpjpe": mpjpe(aligned, gt) * CM2MM,
        f"{prefix}_pck_3d": pck_3d(pred * CM2MM, gt * CM2MM) * 100.0,
        f"{prefix}_auc_3d": auc_3d(pred * CM2MM, gt * CM2MM) * 100.0,
    }


class Pose3DTask:
    """Stage 3: the full cascade with 3D supervision.

    The model is built with random weights from ``seed`` on ``device``
    (``cuda`` when None). The loss is ``w_mpjpe`` x MPJPE of every 3D stage
    (proposal and lifting layers) plus ``w_heatmap`` x the per-view MSE sum
    of every heatmap stage (initial and refined).
    """

    name = "pose_3d_mvf_ex"

    def __init__(self, model_cfg: dict, w_mpjpe: float = 0.1,
                 w_heatmap: float = 10.0,
                 dataset_type: str = "ego4view_syn_pose3d",
                 device=None, seed: int = 0):
        if dataset_type.startswith("ego4view_rw"):
            raise NotImplementedError("the real-world rig is not ported")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Pose3DTask: CUDA is not available; pass "
                               "device='cpu' to build on the CPU")
        self.cfg = EgoRearNetCfg.from_dict(copy.deepcopy(model_cfg))
        if self.cfg.heatmap_mvf.encoder.use_imagenet_pretrain:
            raise NotImplementedError(
                "use_imagenet_pretrain needs the torchvision ResNet-18 "
                "weights, which the repository does not hold")
        model = init_weights(EgoRearNet(self.cfg), torch.Generator().manual_seed(seed))
        self.model = model.to(device)
        self.rig = CameraRig.from_calib_file(self.cfg.camera_model, device=device)
        self.w_mpjpe = w_mpjpe
        self.w_heatmap = w_heatmap
        self.dataset_type = dataset_type

    def forward(self, img: torch.Tensor,
                params: Optional[Dict[str, torch.Tensor]] = None):
        """The cascade on ``img``, with the model's own parameters or, given
        ``params``, with those in their place (``torch.func.functional_call``;
        the model's buffers, e.g. BN running stats, are used and updated)."""
        if params is None:
            return self.model(img, self.rig)
        return functional_call(self.model, params, (img, self.rig))

    def loss(self, batch: dict, params: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        """``(total, metrics)`` of one batch; the model's train/eval mode is
        the caller's (the trainer's step sets train mode)."""
        batch = prepare_batch(batch)
        preds3d, hms = self.forward(batch["img"], params)
        metrics = {}
        total = 0.0
        for i, p in enumerate(preds3d):
            li = mpjpe_loss(p, batch["gt_pose"]) * self.w_mpjpe
            metrics[f"mpjpe_loss_{i}"] = li
            total = total + li
        for i, hm in enumerate(hms):
            li = _per_view_mse_sum(hm, batch["gt_heatmap"]) * self.w_heatmap
            metrics[f"heatmap_loss_{i}"] = li
            total = total + li
        metrics["loss_total"] = total
        return total, metrics

    @torch.no_grad()
    def eval_metrics(self, batch: dict, test_mode: bool = False) -> Metrics:
        """Per-sample (B,) metrics of the final and proposal 3D stages, the
        model in eval mode (BN on its running stats)."""
        del test_mode
        batch = prepare_batch(batch)
        self.model.eval()
        preds3d, _ = self.forward(batch["img"])
        gt = batch["gt_pose"].float()
        out = {}
        out.update(pose_eval_metrics(preds3d[-1].float(), gt, "final"))
        out.update(pose_eval_metrics(preds3d[0].float(), gt, "proposal"))
        return out

    @torch.no_grad()
    def predict_outputs(self, batch: dict) -> Metrics:
        """Final and proposal 3D poses (B, J, 3) cm, the model in eval mode."""
        batch = prepare_batch(batch)
        self.model.eval()
        preds3d, _ = self.forward(batch["img"])
        return {"final": preds3d[-1], "proposal": preds3d[0]}

