"""The experiment yamls, read as the JAX package's ``config/loader.py``
reads them.

Takes the reference's Lightning-CLI schema unchanged (``seed_everything``,
``model.class_path`` / ``model.init_args``, ``trainer``, with its
``logger`` and ``callbacks`` blocks) and maps it onto a task name, the
model's ``init_args`` and a :class:`~egorear_tpu_torch.train.trainer.TrainerConfig`.
Dot-overrides (``--model.batch_size 1 --trainer.max_epochs 2``) apply as the
reference CLI's do; :attr:`ExperimentConfig.cli_keys` records which keys they
set. Unknown trainer keys (``benchmark``, ...) are ignored with a log line;
the TPU-only tensor-parallel knobs (``tp_min_dim``, ``tp_shard_stacked``)
are refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import yaml

from egorear_tpu_torch.train.trainer import TrainerConfig
from egorear_tpu_torch.utils.logging import get_logger

logger = get_logger("config")

CLASS_PATH_TO_TASK = {
    "pose_estimation.pl_wrappers.egoposeformer.PoseHeatmapLightningModel": "heatmap",
    "pose_estimation.pl_wrappers.egoposeformer.PoseHeatmapMVFEXLightningModel": "heatmap_mvf_ex",
    "pose_estimation.pl_wrappers.egoposeformer.Pose3DMVFEXLightningModel": "pose_3d_mvf_ex",
    "egorear_tpu.train.tasks.HeatmapTask": "heatmap",
    "egorear_tpu.train.tasks.MVFexTask": "heatmap_mvf_ex",
    "egorear_tpu.train.tasks.Pose3DTask": "pose_3d_mvf_ex",
    "egorear_tpu_torch.train.tasks.HeatmapTask": "heatmap",
    "egorear_tpu_torch.train.tasks.MVFexTask": "heatmap_mvf_ex",
    "egorear_tpu_torch.train.tasks.Pose3DTask": "pose_3d_mvf_ex",
    "heatmap": "heatmap",
    "heatmap_mvf_ex": "heatmap_mvf_ex",
    "pose_3d_mvf_ex": "pose_3d_mvf_ex",
}

# Trainer keys the JAX package reads for its TPU mesh only.
TPU_ONLY_KEYS = ("tp_min_dim", "tp_shard_stacked")


@dataclasses.dataclass
class ExperimentConfig:
    task_name: str
    init_args: Dict[str, Any]
    trainer: TrainerConfig
    seed: int = 42
    # Dotted keys set by CLI overrides (e.g. "model.init_args.
    # encoder_lr_scale"): an explicit choice, told apart from a yaml value.
    cli_keys: frozenset = frozenset()

    @property
    def model_cfg(self) -> dict:
        return self.init_args.get("model_cfg", {})


def _deep_set(d: dict, dotted: str, value):
    keys = dotted.split(".")
    node = d
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _parse_scalar(s: str):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def apply_overrides(raw: dict, overrides: List[str],
                    seen: Optional[set] = None) -> dict:
    """Apply ``--model.batch_size 1`` / ``--trainer.devices=1`` style
    dot-overrides to the parsed yaml ``raw``; ``--model.<k>`` addresses
    ``model.init_args.<k>``. ``seen``, if given, collects the resolved
    dotted keys."""
    i = 0
    while i < len(overrides):
        tok = overrides[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected CLI token {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(overrides):
                raise ValueError(f"missing value for {tok}")
            val = overrides[i + 1]
            i += 2
        if key.startswith("model."):
            key = "model.init_args." + key[len("model."):]
            _deep_set(raw, key, _parse_scalar(val))
        elif key == "ckpt_path":
            raw["ckpt_path"] = val
        else:
            _deep_set(raw, key, _parse_scalar(val))
        if seen is not None:
            seen.add(key)
    return raw


def _coerce(name: str, value, typ):
    """``value`` as the trainer knob's declared type; a clear error when it
    is not one."""
    if isinstance(value, typ) and not (typ is not bool and isinstance(value, bool)):
        return value
    try:
        if typ is bool:
            if isinstance(value, str):
                low = value.strip().lower()
                if low in ("true", "1", "yes", "on"):
                    return True
                if low in ("false", "0", "no", "off"):
                    return False
                raise ValueError(low)
            return bool(value)
        return typ(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"trainer.{name} expects {typ.__name__}, got {value!r}") from None


def _trainer_config(traw: dict, save_dir: Optional[str], seed: int) -> TrainerConfig:
    refused = [k for k in TPU_ONLY_KEYS if k in traw]
    if refused:
        raise ValueError(f"trainer.{refused[0]}: a TPU-only tensor-parallel "
                         f"setting, which the GPU port does not take")
    known = dict(
        max_epochs=traw.get("max_epochs", 12),
        check_val_every_n_epoch=traw.get("check_val_every_n_epoch", 1),
        log_every_n_steps=traw.get("log_every_n_steps", 400),
        gradient_clip_val=traw.get("gradient_clip_val", 5.0),
        precision=str(traw.get("precision", "32")),
        seed=seed,
        devices=(None if traw.get("devices") in (None, "auto") else int(traw["devices"])),
        model_parallel=int(traw.get("model_parallel", 1)),
    )
    # The framework's own knobs, addressable as --trainer.<field>, coerced
    # to their declared types here so that a quoted yaml value fails early.
    aux_types = {"profile_steps": int, "debug_nans": bool, "auto_resume": bool,
                 "remat": bool, "encoder_lr_scale": float}
    for aux, typ in aux_types.items():
        if aux in traw:
            known[aux] = _coerce(aux, traw[aux], typ)
    # Lightning logger / callback blocks: the CSV logger's save_dir and the
    # checkpoint cadence.
    for lg in traw.get("logger", []) or []:
        if isinstance(lg, dict) and "CSVLogger" in str(lg.get("class_path", "")):
            save_dir = lg.get("init_args", {}).get("save_dir", save_dir)
    # Explicit trainer-level output dirs win over the logger block.
    save_dir = traw.get("save_dir") or traw.get("default_root_dir") or save_dir
    ckpt_every = 1
    for cb in traw.get("callbacks", []) or []:
        if isinstance(cb, dict) and "ModelCheckpoint" in str(cb.get("class_path", "")):
            ckpt_every = cb.get("init_args", {}).get("every_n_epochs", 1)
    ckpt_every = int(traw.get("ckpt_every_n_epochs", ckpt_every))
    ignored = set(traw) - {
        "max_epochs", "check_val_every_n_epoch", "log_every_n_steps",
        "gradient_clip_val", "gradient_clip_algorithm", "precision", "devices",
        "logger", "callbacks", "benchmark", "save_dir", "default_root_dir",
        "model_parallel", "ckpt_every_n_epochs", *aux_types,
    }
    if ignored:
        logger.info(f"ignoring trainer keys: {sorted(ignored)}")
    return TrainerConfig(save_dir=save_dir or "./logs/default",
                         ckpt_every_n_epochs=ckpt_every, **known)


def load_config(path: str, overrides: Optional[List[str]] = None) -> ExperimentConfig:
    """The experiment of the yaml at ``path`` with ``overrides`` applied."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    cli_keys: set = set()
    if overrides:
        raw = apply_overrides(raw, list(overrides), seen=cli_keys)

    seed = int(raw.get("seed_everything", 42))
    model = raw.get("model", {})
    class_path = model.get("class_path", "heatmap")
    if class_path not in CLASS_PATH_TO_TASK:
        raise ValueError(f"unknown model class_path {class_path!r}")
    init_args = dict(model.get("init_args", {}))
    trainer = _trainer_config(dict(raw.get("trainer", {}) or {}), None, seed)
    cfg = ExperimentConfig(task_name=CLASS_PATH_TO_TASK[class_path],
                           init_args=init_args, trainer=trainer, seed=seed,
                           cli_keys=frozenset(cli_keys))
    if raw.get("ckpt_path"):
        cfg.init_args["ckpt_path"] = raw["ckpt_path"]
    return cfg
