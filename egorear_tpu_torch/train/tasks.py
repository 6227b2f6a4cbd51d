"""Training tasks: model + loss + eval metrics for the three training stages
(the JAX package's ``train/tasks.py``): :class:`HeatmapTask` (stage 1, one
stereo pair), :class:`MVFexTask` (stage 2, the multi-view refinement) and
:class:`Pose3DTask` (stage 3, the cascade on the synthetic or the real-world
rig), with the
loss helpers and the heatmap and pose metric suites. Metric names follow the
JAX package (``heatmap_loss``, ``heatmap_loss_{i}``, ``mpjpe_loss_{i}``,
``loss_total``; ``{prefix}_mpjpe``, ``{prefix}_mse_heatmap`` ...).

Every task builds its model with random weights from ``seed``, grafts the
ImageNet ResNet-18 into its backbones when the config sets
``use_imagenet_pretrain``, and only then moves it to ``device`` (``cuda``
when None; without CUDA that raises). ``forward(img, params)`` and
``loss(batch, params)`` run with the model's own parameters or, given
``params``, with those in their place (``torch.func.functional_call``; the
model's buffers, e.g. BN running stats, are used and updated); the model's
train/eval mode is the caller's. Both take a ``generator`` from which
dropout in train mode draws its masks (the trainer's, seeded per step).
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from egorear_tpu_torch.data.preprocess import preprocess_batch_device
from egorear_tpu_torch.models.configs import EgoRearNetCfg, EncoderCfg, MVFexNetCfg
from egorear_tpu_torch.models.heatmap_net import HeatmapNet
from egorear_tpu_torch.models.layers import dropout_generator, init_weights
from egorear_tpu_torch.models.mvfex import HeatmapMVFexNet
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.heatmap import argmax_2d
from egorear_tpu_torch.ops.metrics import (
    auc_3d,
    mpjpe,
    mpjpe_loss,
    pck_3d,
    procrustes_align,
)
from egorear_tpu_torch.parallel import dist
from egorear_tpu_torch.train.imagenet import (
    graft_imagenet_backbones,
    load_imagenet_resnet18,
)

CM2MM = 10.0

Metrics = Dict[str, torch.Tensor]


def prepare_batch(batch: dict) -> dict:
    """The on-device preprocessing of a uint8 batch (the datasets'
    ``device_preprocess`` items): ``img_u8`` (B, V, H, W, 3) becomes the
    normalised 256-px ``img`` and, unless the batch has a ``gt_heatmap``,
    the 15 Gaussian targets without Head are rendered from ``joints_2d``,
    all on the batch's device (:mod:`egorear_tpu_torch.data.preprocess`).
    Host-prepared batches pass through untouched."""
    if "img_u8" not in batch:
        return batch
    out = {k: v for k, v in batch.items() if k not in ("img_u8", "joints_2d")}
    out.update(preprocess_batch_device(
        batch["img_u8"], None if "gt_heatmap" in batch else batch.get("joints_2d")))
    return out


def _per_view_mse_sum(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Sum over views of the per-view mean squared error: the mean over every
    axis but the view axis (1), then the sum."""
    d2 = (pred - gt) ** 2
    return d2.mean(dim=(0,) + tuple(range(2, d2.dim()))).sum()


def heatmap_eval_metrics(pred_hm: torch.Tensor, gt_hm: torch.Tensor,
                         prefix: str) -> Metrics:
    """Per-sample (B,) heatmap metrics of (B, V, J, h, w) maps: L1, L1 where
    the ground truth is positive, MSE, and the MSE of the argmax points
    (pixels) over the joints whose ground-truth peak reaches 1."""
    B, V = pred_hm.shape[:2]
    p = pred_hm.reshape(B, V, -1)
    g = gt_hm.reshape(B, V, -1)
    err = (p - g).abs()
    pos = (g > 0).to(p.dtype)
    pred_pts, _, _ = argmax_2d(pred_hm, threshold=1.0, normalize=False)
    gt_pts, _, gt_valid = argmax_2d(gt_hm, threshold=1.0, normalize=False)
    m = gt_valid[..., None].to(pred_pts.dtype)
    return {
        f"{prefix}_l1_error_heatmap": err.sum(dim=(1, 2)),
        f"{prefix}_pos_l1_error_heatmap": (err * pos).sum(dim=(1, 2)),
        f"{prefix}_mse_heatmap": ((pred_hm - gt_hm) ** 2).mean(dim=(1, 2, 3, 4)),
        f"{prefix}_mse_pts2d": ((pred_pts * m - gt_pts * m) ** 2).mean(dim=(1, 2, 3)),
    }


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


def resolve_device(device, who: str) -> torch.device:
    """``device`` (``cuda`` when None); raises without CUDA, never falls
    back to the CPU. In a data-parallel rank an unnumbered ``cuda`` is the
    rank's card (the current device, which the group's set-up chose)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available; pass device='cpu' "
                           f"to build on the CPU")
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _maybe_imagenet_init(model: nn.Module, use_imagenet_pretrain: bool) -> nn.Module:
    """Graft the ImageNet ResNet-18 into every backbone of ``model`` when the
    config asks for it; raises ``FileNotFoundError`` when the weights are
    nowhere (:func:`~egorear_tpu_torch.train.imagenet.load_imagenet_resnet18`):
    training the backbones from scratch under the flag would be silent."""
    if use_imagenet_pretrain:
        graft_imagenet_backbones(model, load_imagenet_resnet18())
    return model


def _build(model: nn.Module, seed: int, use_imagenet_pretrain: bool,
           device: torch.device) -> nn.Module:
    """Seeded init, then ImageNet, then the move to ``device``: the graft
    lands before any device or dtype change."""
    init_weights(model, torch.Generator().manual_seed(seed))
    return _maybe_imagenet_init(model, use_imagenet_pretrain).to(device)


def resolve_calib_path(model_cfg: dict, camera_calib_path: Optional[str]
                       ) -> Optional[str]:
    """The stage-3 calibration source, as the JAX package resolves it: the
    explicit path, else the config's ``pose3d_cfg.camera_calib_file_dir_path``
    if it exists on disk, else None (the repository's rig file)."""
    if camera_calib_path is None:
        ref = (model_cfg.get("pose3d_cfg") or {}).get("camera_calib_file_dir_path")
        if ref and os.path.exists(ref):
            camera_calib_path = ref
    return camera_calib_path


class _Task:
    """What the three tasks share: ``forward`` with optional parameters."""

    model: nn.Module

    def _args(self, img, coord_trans_mat):
        return (img,)

    def forward(self, img: torch.Tensor,
                params: Optional[Dict[str, torch.Tensor]] = None,
                coord_trans_mat: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The model on ``img``, with its own parameters or ``params``
        (stage 3 on the real-world rig also takes the batch's
        ``coord_trans_mat``); dropout in train mode draws its masks from
        ``generator``."""
        args = self._args(img, coord_trans_mat)
        with dropout_generator(self.model, generator):
            if params is None:
                return self.model(*args)
            return functional_call(self.model, params, args)

    def _forward_args(self, batch: dict) -> tuple:
        return (batch["img"],)

    def _batch_forward(self, batch: dict, params=None, generator=None):
        """``(prepared batch, model outputs)``: every path that reads a
        batch's ``img`` or ``gt_heatmap`` takes it from here, after
        :func:`prepare_batch`."""
        batch = prepare_batch(batch)
        img, *ctm = self._forward_args(batch)
        ctm = ctm[0] if ctm else None
        return batch, self.forward(img, params, ctm, generator)

    @torch.no_grad()
    def _eval_forward(self, batch: dict):
        self.model.eval()
        return self._batch_forward(batch)


class HeatmapTask(_Task):
    """Stage 1: per-view heatmap regression of one stereo pair.

    The loss is ``w_heatmap`` x the per-view MSE sum of the heatmaps. The
    other keyword arguments of the JAX constructors (dataset and rig
    settings) are taken and not used, so one call builds any task.
    """

    name = "heatmap"

    def __init__(self, model_cfg: dict, w_heatmap: float = 10.0,
                 device=None, seed: int = 0, **_):
        device = resolve_device(device, "HeatmapTask")
        ec = EncoderCfg.from_dict(model_cfg.get("encoder_cfg", {}))
        self.model = _build(
            HeatmapNet(ec.out_stride, ec.fpn_channels,
                       num_heatmap=model_cfg.get("num_heatmap", 15)),
            seed, ec.use_imagenet_pretrain, device)
        self.w_heatmap = w_heatmap

    def loss(self, batch: dict, params: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        batch, pred = self._batch_forward(batch, params, generator)
        loss = _per_view_mse_sum(pred, batch["gt_heatmap"]) * self.w_heatmap
        return loss, {"heatmap_loss": loss}

    def eval_metrics(self, batch: dict, test_mode: bool = False) -> Metrics:
        """Per-sample (B,) heatmap metrics, the model in eval mode."""
        del test_mode
        batch, pred = self._eval_forward(batch)
        return heatmap_eval_metrics(pred, batch["gt_heatmap"], "proposal")

    def predict_outputs(self, batch: dict) -> Metrics:
        """Per-view heatmaps and their decoded 2D anchors in [0, 1]."""
        _, pred = self._eval_forward(batch)
        pts2d, conf, valid = argmax_2d(pred, threshold=0.5, normalize=True)
        return {"heatmap": pred, "pts2d": pts2d, "pts2d_conf": conf,
                "pts2d_valid": valid}


class MVFexTask(_Task):
    """Stage 2: MVFex refinement with deep supervision.

    The loss is ``w_heatmap`` x the per-view MSE sum of every heatmap stage,
    the initial heads' and each refiner layer's (``heatmap_loss_{i}``).
    The other keyword arguments of the JAX constructors are taken and not
    used.
    """

    name = "heatmap_mvf_ex"

    def __init__(self, model_cfg: dict, w_heatmap: float = 10.0,
                 device=None, seed: int = 0, **_):
        device = resolve_device(device, "MVFexTask")
        self.cfg = MVFexNetCfg.from_dict(copy.deepcopy(model_cfg))
        self.model = _build(HeatmapMVFexNet(self.cfg), seed,
                            self.cfg.encoder.use_imagenet_pretrain, device)
        self.w_heatmap = w_heatmap

    def loss(self, batch: dict, params: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        batch, (hms, _) = self._batch_forward(batch, params, generator)
        metrics = {}
        total = 0.0
        for i, hm in enumerate(hms):
            li = _per_view_mse_sum(hm, batch["gt_heatmap"]) * self.w_heatmap
            metrics[f"heatmap_loss_{i}"] = li
            total = total + li
        metrics["loss_total"] = total
        return total, metrics

    def eval_metrics(self, batch: dict, test_mode: bool = False) -> Metrics:
        """Per-sample (B,) heatmap metrics of the initial (``proposal``) and
        last refined (``final``) stages, per stereo pair (the back pair only
        with V >= 3 views); ``test_mode`` adds the intermediate refiner
        layers (``mid_{i}``)."""
        batch, (hms, _) = self._eval_forward(batch)
        gt = batch["gt_heatmap"]
        pairs = [("stereo_front", slice(0, 2))]
        if gt.shape[1] >= 3:
            pairs.append(("stereo_back", slice(2, None)))
        stages = [("proposal", hms[0]), ("final", hms[-1])]
        if test_mode:
            stages += [(f"mid_{i}", hm) for i, hm in enumerate(hms[1:-1])]
        out = {}
        for stage, hm in stages:
            for pair, views in pairs:
                out.update(heatmap_eval_metrics(hm[:, views], gt[:, views],
                                                f"{stage}_{pair}"))
        return out

    def predict_outputs(self, batch: dict) -> Metrics:
        """Initial and final refined heatmaps, and the final stage's decoded
        2D anchors in [0, 1]."""
        _, (hms, _) = self._eval_forward(batch)
        pts2d, conf, valid = argmax_2d(hms[-1], threshold=self.cfg.heatmap_threshold,
                                       normalize=True)
        return {"heatmap": hms[-1], "heatmap_init": hms[0], "pts2d": pts2d,
                "pts2d_conf": conf, "pts2d_valid": valid}


class Pose3DTask(_Task):
    """Stage 3: the full cascade with 3D supervision.

    The loss is ``w_mpjpe`` x MPJPE of every 3D stage (proposal and lifting
    layers) plus ``w_heatmap`` x the per-view MSE sum of every heatmap stage
    (initial and refined). The rig is the config's ``camera_model`` from
    :func:`resolve_calib_path`'s source, chained as the reference unless
    ``chained_cameras`` is False. On ``ego4view_rw*`` data every forward
    (loss, evaluation, prediction) takes the batch's ``coord_trans_mat``.
    """

    name = "pose_3d_mvf_ex"

    def __init__(self, model_cfg: dict, w_mpjpe: float = 0.1,
                 w_heatmap: float = 10.0,
                 dataset_type: str = "ego4view_syn_pose3d",
                 pose_relative_type: str = "device",
                 camera_calib_path: Optional[str] = None,
                 chained_cameras: bool = True,
                 device=None, seed: int = 0, **_):
        device = resolve_device(device, "Pose3DTask")
        self.cfg = EgoRearNetCfg.from_dict(copy.deepcopy(model_cfg))
        self.model = _build(EgoRearNet(self.cfg), seed,
                            self.cfg.heatmap_mvf.encoder.use_imagenet_pretrain,
                            device)
        self.rig = CameraRig.from_calib_file(
            self.cfg.camera_model, resolve_calib_path(model_cfg, camera_calib_path),
            chained=chained_cameras, device=device)
        self.w_mpjpe = w_mpjpe
        self.w_heatmap = w_heatmap
        self.dataset_type = dataset_type
        self.is_rw = dataset_type.startswith("ego4view_rw")
        # Only the reference's UnrealEgo pelvis-relative eval reads it; the
        # network ignores the origin either way.
        self.pose_relative_type = pose_relative_type

    def _args(self, img, coord_trans_mat):
        return (img, self.rig, coord_trans_mat)

    def _forward_args(self, batch: dict) -> tuple:
        return batch["img"], batch.get("coord_trans_mat") if self.is_rw else None

    def loss(self, batch: dict, params: Optional[Dict[str, torch.Tensor]] = None,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Metrics]:
        """``(total, metrics)`` of one batch; the model's train/eval mode is
        the caller's (the trainer's step sets train mode)."""
        batch, (preds3d, hms) = self._batch_forward(batch, params, generator)
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

    def eval_metrics(self, batch: dict, test_mode: bool = False) -> Metrics:
        """Per-sample (B,) metrics of the final and proposal 3D stages, the
        model in eval mode (BN on its running stats)."""
        del test_mode
        batch, (preds3d, _) = self._eval_forward(batch)
        gt = batch["gt_pose"].float()
        out = {}
        out.update(pose_eval_metrics(preds3d[-1].float(), gt, "final"))
        out.update(pose_eval_metrics(preds3d[0].float(), gt, "proposal"))
        return out

    def predict_outputs(self, batch: dict) -> Metrics:
        """Final and proposal 3D poses (B, J, 3) cm, the model in eval mode."""
        _, (preds3d, _) = self._eval_forward(batch)
        return {"final": preds3d[-1], "proposal": preds3d[0]}


TASKS = {
    HeatmapTask.name: HeatmapTask,
    MVFexTask.name: MVFexTask,
    Pose3DTask.name: Pose3DTask,
}
