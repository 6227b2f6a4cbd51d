"""Experiment runner of the port (the JAX package's ``run.py``), on the
shipped yamls unchanged:

    python -m egorear_tpu_torch.run fit      --config configs/ego4view_syn_heatmap_stereo_front.yaml
    python -m egorear_tpu_torch.run test     --config configs/ego4view_syn_pose3d.yaml \\
                                             --ckpt_path logs/.../checkpoints/epoch=11.pt
    python -m egorear_tpu_torch.run predict  --config ... --ckpt_path ...
    python -m egorear_tpu_torch.run validate --config ... --ckpt_path ...

plus dot-overrides (``--model.batch_size 4 --trainer.max_epochs 1``). It runs
on the card (``cuda``) unless ``--device cpu`` is given; without CUDA and
without the flag it raises. ``fit`` grafts the stage checkpoints the config
names (``heatmap_estimator_pretrained_stereo_{front,back}``,
``heatmap_estimator_mvf_pretrained``, ``network_pretrained``) and resumes
from ``--ckpt_path``'s directory when given; the other subcommands load the
model state of the checkpoint at ``--ckpt_path``. Every checkpoint argument
takes the port's ``epoch=N.pt`` or an EgoRear Lightning ``.ckpt`` (imported
through ``train/torch_convert.py``). All 12 yamls run, the stereo-pair
(V = 2) and real-world (``ego4view_rw*``) ones included.
Precision ``32`` (``32-true``) runs fp32 with TF32 off for matmuls and
cuDNN convs; every ``bf16*`` string trains bf16-mixed.
Prints the metrics (``test``/``validate``) or ``{"predictions": path}``
(``predict``) as JSON on stdout (rank 0).

Data-parallel (the JAX package's ``data`` mesh axis;
:mod:`egorear_tpu_torch.parallel.dist`): ``--trainer.devices N`` starts N
local ranks (start method ``spawn``, NCCL on CUDA, one card each; unset,
one rank per card, as the JAX package takes every device), and under
``torchrun --nproc_per_node N -m egorear_tpu_torch.run ...`` each process
is the rank its environment names, on card ``LOCAL_RANK`` (the launcher's
world size wins over ``devices``). The kernels are built once before the
ranks start.

Tensor-parallel (the JAX package's ``model`` mesh axis): with
``--trainer.model_parallel M`` the N ranks (N divisible by M, else
``ValueError``) form a (N/M data) x (M model) grid, and the wide leaves
(``--trainer.tp_min_dim``, ``--trainer.tp_shard_stacked``) are sharded
over each model group (:mod:`egorear_tpu_torch.parallel.tensor`). Every
rank builds the full seeded model, or loads the full checkpoint, and keeps
its slices; ``epoch=N.pt`` holds the full leaves.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from egorear_tpu_torch import kernels
from egorear_tpu_torch.config.loader import load_config
from egorear_tpu_torch.data.datasets import get_dataset
from egorear_tpu_torch.parallel import dist, tensor
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.tasks import TASKS, resolve_device
from egorear_tpu_torch.train.trainer import FP32_PRECISIONS, Trainer, no_decay_mask_for
from egorear_tpu_torch.utils.logging import get_logger

logger = get_logger("run")


def set_matmul_precision(precision: str) -> None:
    """Precision ``32`` (or ``32-true``) is fp32 throughout: TF32 off for
    cuBLAS matmuls and cuDNN convs (``bf16*`` leaves PyTorch's defaults)."""
    if str(precision) in FP32_PRECISIONS:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logger.info(f"precision {precision}: TF32 matmul "
                f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
                f"{torch.backends.cudnn.allow_tf32}")


def build_task(cfg, device):
    """The config's task on ``device``, its model seeded with the config's
    seed; returns ``(task, init_args)``."""
    args = dict(cfg.init_args)
    if cfg.task_name == "pose_3d_mvf_ex" and args.get("test_on_rw"):
        # The reference rewrites these in its constructor.
        args["model_cfg"]["pose3d_cfg"]["camera_model"] = "ego4view_rw"
        args["model_cfg"]["camera_model"] = "ego4view_rw"
        args["dataset_type"] = "ego4view_rw_pose3d"
    task = TASKS[cfg.task_name](
        model_cfg=args.get("model_cfg", {}),
        w_heatmap=args.get("w_heatmap", 10.0),
        w_mpjpe=args.get("w_mpjpe", 0.1),
        dataset_type=args.get("dataset_type", ""),
        camera_calib_path=args.get("camera_calib_path"),
        device=device, seed=cfg.seed,
    )
    return task, args


def build_trainer(cfg, task, args) -> Trainer:
    return Trainer.from_config(
        task, cfg.trainer,
        lr=args.get("lr", 1e-3),
        weight_decay=args.get("weight_decay", 5e-4),
        lr_decay_epochs=args.get("lr_decay_epochs", (8, 10)),
        warmup_iters=args.get("warmup_iters", 500),
        batch_size=args.get("batch_size", 32),
        workers=args.get("workers", 8),
        no_decay_mask=no_decay_mask_for(cfg.task_name,
                                        cfg.trainer.encoder_lr_scale),
    )


def _apply_encoder_lr(cfg, args):
    """``encoder_lr_scale`` lives in the model's init_args (the reference's
    place) and as ``--trainer.encoder_lr_scale``. Precedence, most explicit
    first (every shipped yaml carries a literal 1.0, which must not undo a
    trainer-level setting): a CLI ``--model.encoder_lr_scale`` (any value),
    a yaml model-level value other than 1.0, the trainer-level value."""
    if "encoder_lr_scale" not in args:
        return
    model_scale = float(args["encoder_lr_scale"])
    from_cli = "model.init_args.encoder_lr_scale" in cfg.cli_keys
    if from_cli or model_scale != 1.0 or cfg.trainer.encoder_lr_scale == 1.0:
        cfg.trainer.encoder_lr_scale = model_scale


def _datasets(args, splits):
    kwargs = dict(args.get("dataset_kwargs", {}) or {})
    kwargs.setdefault("render_missing_heatmaps",
                      args.get("render_missing_heatmaps", False))
    return [get_dataset(args["dataset_type"], args["data_root"], s, **kwargs)
            for s in splits]


def apply_pretrained(task, cfg, args) -> None:
    """Graft the stage checkpoints that ``args`` names into the task's model
    in place (``checkpoint.apply_pretrained``)."""
    for key in ckpt_lib.apply_pretrained(task.model, cfg.task_name, args):
        path = ckpt_lib.PRETRAINED_GRAFTS[key][0]
        logger.info(f"grafted {key} from {args[key]} into '{path or '<root>'}'")


def load_eval_ckpt(task, cfg, ckpt_path: str) -> None:
    """The model state of the checkpoint at ``ckpt_path`` into the task's
    model: the port's ``.pt``, or an EgoRear ``.ckpt`` of the config's task
    (imported strictly; a checkpoint without BN statistics keeps the
    model's). Both hold the full model; a tensor-parallel rank keeps its
    slices."""
    if ckpt_path.endswith(".ckpt"):
        sd = ckpt_lib.load_pretrained(ckpt_path, tensor.full_state_dict(task.model),
                                      cfg.task_name)
    else:
        sd = ckpt_lib.restore(ckpt_path, map_location=next(
            task.model.parameters()).device)["model"]
    tensor.load_full_state_dict(task.model, sd, strict=True)
    logger.info(f"loaded eval checkpoint {ckpt_path}")


def ranks_asked(devices: Optional[int], device_type: str,
                model_parallel: int = 1) -> int:
    """The ranks ``devices`` asks for: every card when it is unset (the
    JAX package's ``None = all``), one on the CPU. Raises ``ValueError``,
    as the JAX package's trainer does, when ``model_parallel`` does not
    divide them."""
    n = devices or (torch.cuda.device_count() if device_type == "cuda" else 1)
    if n % max(1, model_parallel):
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n} devices")
    return n


def main(argv=None, backend: Optional[str] = None):
    """Run one subcommand. Returns the fitted trainer (``fit``), the
    metrics (``test``, ``validate``) or the predictions' path
    (``predict``); when this call starts several ranks, the list of their
    results (None for ``fit``, and for ``predict`` but on rank 0).
    ``backend`` is the process group's when this call makes one (NCCL on
    CUDA, gloo on the CPU by default; gloo lets ranks share a card)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("subcommand", choices=["fit", "test", "predict", "validate"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; cpu runs the plain "
                             "versions of the kernels)")
    args_ns, overrides = parser.parse_known_args(argv)
    cfg = load_config(args_ns.config, overrides)
    device_type = torch.device(args_ns.device or "cuda").type
    if dist.is_initialized():
        return _run(args_ns, cfg)
    if dist.torchrun_env():
        with dist.torchrun_group(device_type, backend):
            if cfg.trainer.devices and cfg.trainer.devices != dist.world_size():
                logger.warning(f"trainer.devices={cfg.trainer.devices}: the "
                               f"launcher's {dist.world_size()} ranks run")
            if device_type == "cuda":
                if int(os.environ.get("LOCAL_RANK", 0)) == 0:
                    kernels.build()  # once per host, before any rank loads
                dist.barrier()
            return _run(args_ns, cfg)
    n = ranks_asked(cfg.trainer.devices, device_type, cfg.trainer.model_parallel)
    if n > 1:
        if device_type == "cuda":
            kernels.build()  # once, before the ranks start
        return dist.spawn(_rank_main, n, argv, device=device_type, backend=backend)
    return _run(args_ns, cfg)


def _rank_main(argv):
    """:func:`main` in a rank that :func:`dist.spawn` started."""
    out = main(argv)
    return None if isinstance(out, Trainer) else out


def _run(args_ns, cfg):
    """The subcommand in this process (a rank, or the one process)."""
    device = resolve_device(args_ns.device, "run (pass --device cpu for the CPU)")
    set_matmul_precision(cfg.trainer.precision)
    np.random.seed(cfg.seed)
    task, args = build_task(cfg, device)
    _apply_encoder_lr(cfg, args)
    trainer = build_trainer(cfg, task, args)

    if args_ns.subcommand == "fit":
        train_ds, val_ds = _datasets(args, ("train", "validation"))
        logger.info(f"train data = {len(train_ds)}; val data = {len(val_ds)}")
        trainer.init_state(max(1, len(train_ds) // trainer.batch_size))
        apply_pretrained(task, cfg, args)
        return trainer.fit(train_ds, val_ds, resume_dir=args_ns.ckpt_path)

    split = "test" if args_ns.subcommand in ("test", "predict") else "validation"
    (ds,) = _datasets(args, (split,))
    logger.info(f"{split} data = {len(ds)}")
    if args_ns.ckpt_path:
        load_eval_ckpt(task, cfg, args_ns.ckpt_path)
    if args_ns.subcommand == "predict":
        path = trainer.predict(ds, os.path.join(cfg.trainer.save_dir, "predictions"),
                               save_obj=bool(args.get("save_result")))
        if trainer.is_main:
            print(json.dumps({"predictions": path}))
        return path
    metrics = trainer.evaluate(ds, mode="test" if args_ns.subcommand == "test" else "val")
    if trainer.is_main:
        print(json.dumps({k: round(float(v), 6) for k, v in metrics.items()},
                         indent=1))
    return metrics


if __name__ == "__main__":
    main()
