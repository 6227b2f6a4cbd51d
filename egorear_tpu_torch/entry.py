"""Entry point of the port: the flagship 4-view model on the card.

Counterpart of the JAX package's ``__graft_entry__.py``:
``FLAGSHIP_CFG`` (4 views, 256 px, ResNet18 + FPN, one MVFex/JQA layer, the
conv-downsample 3D proposal, 3 lifting layers) and :func:`build`.

    model, rig = build()                          # on cuda, fp32
    model, rig = build(bn_folded=True, dtype=torch.bfloat16)   # serving
    model, rig = build(lazy_deform=False)         # the reference order
    with torch.inference_mode():
        preds_3d, heatmaps = model(img, rig)      # img (B, 4, 3, 256, 256)

    task, trainer = build_train(steps_per_epoch=n)  # stage-3 training
    metrics = trainer.train_step({"img": img, "gt_pose": ..., "gt_heatmap": ...})

The three training stages as ``configs/ego4view_syn_*.yaml`` chain them
(ImageNet weights from ``EGOREAR_IMAGENET_RESNET18`` or the torch hub cache):

    task, trainer = build_stage1(steps_per_epoch=n)   # one stereo pair
    checkpoint.save(dir_front, epoch, trainer.state_dict())
    task, trainer = build_stage2(steps_per_epoch=n, pretrained={
        "heatmap_estimator_pretrained_stereo_front": front_ckpt,
        "heatmap_estimator_pretrained_stereo_back": back_ckpt})
    task, trainer = build_train(steps_per_epoch=n, precision="32",
        pretrained={"heatmap_estimator_mvf_pretrained": ckpt})

Each builder starts the backbones from the ImageNet ResNet-18, as every
yaml asks; ``imagenet=False`` keeps them random (from ``seed``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from egorear_tpu_torch.models.backbone import fold_batchnorm
from egorear_tpu_torch.models.configs import EgoRearNetCfg
from egorear_tpu_torch.models.layers import init_weights
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.train.checkpoint import apply_pretrained
from egorear_tpu_torch.train.tasks import HeatmapTask, MVFexTask, Pose3DTask
from egorear_tpu_torch.train.trainer import Trainer, TrainerConfig, no_decay_mask_for

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


def flagship_cfg_dict(image_size=(256, 256), bn_folded: bool = False,
                      lazy_deform: bool = True) -> dict:
    """The flagship config as a dict at ``image_size`` (optionally BN-folded;
    with ``lazy_deform=False`` the reference computation order, i.e. the
    yaml keys ``mvf_cfg.lazy_deform`` and ``pose3d_cfg.lazy_deform`` off)."""
    d = copy.deepcopy(dict(FLAGSHIP_CFG, image_size=list(image_size)))
    if bn_folded:
        d["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["bn_folded"] = True
    if not lazy_deform:
        d["heatmap_mvf_cfg"]["mvf_cfg"]["lazy_deform"] = False
        d["pose3d_cfg"]["lazy_deform"] = False
    return d


def _merged(cfg: dict, overrides: dict) -> dict:
    """``cfg`` with ``overrides`` (a dict of the same nesting) laid over it,
    in place."""
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            _merged(cfg[key], value)
        else:
            cfg[key] = copy.deepcopy(value)
    return cfg


def flagship_cfg(image_size=(256, 256), bn_folded: bool = False,
                 lazy_deform: bool = True) -> EgoRearNetCfg:
    """The flagship config at ``image_size``; see :func:`flagship_cfg_dict`."""
    return EgoRearNetCfg.from_dict(flagship_cfg_dict(image_size, bn_folded,
                                                     lazy_deform))


def build(image_size=(256, 256), device=None, dtype=torch.float32,
          bn_folded: bool = False, seed: int = 0, lazy_deform: bool = True):
    """Build the flagship model with random weights from ``seed``.

    ``device=None`` means ``cuda``; without CUDA this raises, it never falls
    back to the CPU (pass ``device="cpu"`` explicitly). With ``bn_folded``
    the model is the serving variant: the same seeded weights with eval-mode
    BatchNorm folded into the convs in fp32, before the cast to ``dtype``.
    ``lazy_deform=False`` builds the reference computation order (the same
    parameters, so the same seed gives the same weights). Returns
    ``(model, rig)``, the model in eval mode.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build: CUDA is not available; pass device='cpu' "
                           "to build on the CPU")
    cfg = flagship_cfg(image_size, lazy_deform=lazy_deform)
    model = init_weights(EgoRearNet(cfg), torch.Generator().manual_seed(seed))
    if bn_folded:
        folded = EgoRearNet(flagship_cfg(image_size, bn_folded=True,
                                         lazy_deform=lazy_deform))
        folded.load_state_dict(fold_batchnorm(model.state_dict()), strict=True)
        model = folded
    model = model.to(device=device, dtype=dtype).eval()
    rig = CameraRig.from_calib_file(cfg.camera_model, device=device)
    return model, rig


# configs/ego4view_syn_pose3d.yaml: optimizer, schedule and clipping. The
# no-decay mask follows the task and encoder_lr_scale (no_decay_mask_for).
FLAGSHIP_OPTIM = dict(lr=1e-3, weight_decay=5e-4, lr_decay_epochs=(8, 10),
                      warmup_iters=500, gradient_clip_val=5.0,
                      encoder_lr_scale=1.0)

_ENCODER_CFG = {
    "resnet_cfg": {"model_name": "resnet18", "out_stride": 4,
                   "use_imagenet_pretrain": True},
    "neck_cfg": {"in_channels": [64, 128, 256, 512], "out_channels": 128},
}
# The model_cfg of configs/ego4view_syn_heatmap_stereo_{front,back}.yaml
# (one stereo pair; the two differ only in their data).
STAGE1_CFG = {"num_heatmap": 15, "encoder_cfg": _ENCODER_CFG}
# The model_cfg of configs/ego4view_syn_heatmap_mvfex-n1_jqa.yaml.
STAGE2_CFG = {
    "num_heatmap": 15, "num_joints": 16, "num_views": 4,
    "camera_model": "ego4view_syn", "image_size": [256, 256],
    "feat_down_stride": 4, "heatmap_threshold": 0.5, "anchor_2d_update": True,
    "encoder_cfg": _ENCODER_CFG,
    "mvf_cfg": {
        "input_dims": 128, "embed_dims": 256, "num_former_layers": 1,
        "joint_query_adaptation": True,
        "mvf_transformer_cfg": {
            "cross_attn_cfg": {"num_heads": 4, "batch_first": True},
            "spatial_attn_cfg": {"num_heads": 4, "batch_first": True},
            "ffn_cfg": {"feedforward_dims": 512, "num_fcs": 2, "ffn_drop": 0.0},
        },
    },
}
# Stages 1 and 2 (all four yamls): optimizer, schedule, clipping, precision
# and batch.
STAGE_OPTIM = dict(lr=1e-3, weight_decay=5e-3, lr_decay_epochs=(8, 10),
                   warmup_iters=500, gradient_clip_val=5.0,
                   encoder_lr_scale=1.0)
STAGE_PRECISION, STAGE_BATCH = "32", 64


def _trainer(task, precision, defaults, optim, steps_per_epoch, pretrained,
             parallel=None):
    """The task's trainer with ``defaults`` overridden by ``optim`` (the
    no-decay mask, unless given, as the JAX package's ``run.py`` sets it),
    its state initialised, then the ``pretrained`` stages grafted into the
    model (the optimizer holds the model's parameters and keeps its state).
    ``parallel`` holds :class:`TrainerConfig`'s tensor-parallel settings
    (``model_parallel``, ``tp_min_dim``, ``tp_shard_stacked``): the model
    is then sharded over the process group's model axis."""
    unknown = set(optim) - set(defaults) - {"no_decay_mask"}
    if unknown:
        raise TypeError(f"unknown optimizer settings {sorted(unknown)}")
    settings = {**defaults, **optim}
    settings.setdefault("no_decay_mask", no_decay_mask_for(
        task.name, settings["encoder_lr_scale"]))
    config = TrainerConfig(precision=precision,
                           gradient_clip_val=settings.pop("gradient_clip_val"),
                           encoder_lr_scale=settings["encoder_lr_scale"],
                           **(parallel or {}))
    trainer = Trainer(task, config=config, **settings)
    trainer.init_state(steps_per_epoch)
    if pretrained:
        apply_pretrained(task.model, task.name, pretrained)
    return trainer


def build_train(image_size=(256, 256), device=None,
                precision: str = "bf16-mixed", seed: int = 0, *,
                steps_per_epoch: int, lazy_deform: bool = True,
                imagenet: bool = True, pretrained=None,
                overrides: Optional[dict] = None, parallel: Optional[dict] = None,
                **optim):
    """The flagship stage-3 training set-up: ``(Pose3DTask, Trainer)``.

    Random weights from ``seed``, on ``cuda`` unless ``device`` says
    otherwise (without CUDA this raises); ``lazy_deform=False`` trains the
    reference computation order; ``overrides`` (nested as the config dict)
    is laid over the config, e.g. ``{"pose3d_cfg": {"use_mlp_avgpool":
    True}}`` for another model branch. The backbones start from the ImageNet
    ResNet-18, as ``configs/ego4view_syn_pose3d.yaml`` asks, unless
    ``imagenet=False``;
    ``pretrained`` maps graft keys (``train/checkpoint.PRETRAINED_GRAFTS``,
    e.g. ``heatmap_estimator_mvf_pretrained``) to checkpoints. The optimizer
    follows the yaml (:data:`FLAGSHIP_OPTIM`); ``optim`` overrides any of its
    keys. ``steps_per_epoch`` (the loader's length) places the lr milestones.
    ``parallel`` (e.g. ``{"model_parallel": 2}``, inside a process group)
    shards the model over the model axis, as :class:`TrainerConfig`'s
    fields of those names do. The trainer's state is initialised.
    """
    device = torch.device("cuda" if device is None else device)
    cfg = _merged(flagship_cfg_dict(image_size, lazy_deform=lazy_deform),
                  overrides or {})
    cfg["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = imagenet
    task = Pose3DTask(cfg, device=device, seed=seed)
    return task, _trainer(task, precision, FLAGSHIP_OPTIM, optim,
                          steps_per_epoch, pretrained, parallel)


def build_stage1(device=None, precision: str = STAGE_PRECISION, seed: int = 0, *,
                 steps_per_epoch: int, imagenet: bool = True, **optim):
    """Stage 1 of one stereo pair as the yamls train it: ``(HeatmapTask,
    Trainer)`` with :data:`STAGE1_CFG` (size-agnostic) and
    :data:`STAGE_OPTIM`, on ``cuda`` unless ``device`` says otherwise
    (without CUDA this raises). ``imagenet=False`` drops the ImageNet
    initialisation; the rest as :func:`build_train`."""
    cfg = copy.deepcopy(STAGE1_CFG)
    cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = imagenet
    task = HeatmapTask(cfg, device=device, seed=seed)
    return task, _trainer(task, precision, STAGE_OPTIM, optim, steps_per_epoch,
                          None)


def build_stage2(image_size=(256, 256), device=None,
                 precision: str = STAGE_PRECISION, seed: int = 0, *,
                 steps_per_epoch: int, imagenet: bool = True, pretrained=None,
                 parallel: Optional[dict] = None, **optim):
    """Stage 2 as the yaml trains it: ``(MVFexTask, Trainer)`` with
    :data:`STAGE2_CFG` at ``image_size`` and :data:`STAGE_OPTIM`.
    ``pretrained`` takes the stage-1 checkpoints under
    ``heatmap_estimator_pretrained_stereo_{front,back}``; the rest as
    :func:`build_stage1`."""
    cfg = copy.deepcopy(dict(STAGE2_CFG, image_size=list(image_size)))
    cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = imagenet
    task = MVFexTask(cfg, device=device, seed=seed)
    return task, _trainer(task, precision, STAGE_OPTIM, optim, steps_per_epoch,
                          pretrained, parallel)
