"""What the benchmark takes from the program under test,
``egorear_tpu_torch``: the task and trainer as its CLI builds them, the
import of EgoRear-layout weights, and the hook that sees the sampling
kernels' inputs. The reference (:mod:`portbench.reference`) never imports
this module."""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from egorear_tpu_torch import run as port_run
from egorear_tpu_torch.config.loader import load_config
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.models import layers as port_layers
from egorear_tpu_torch.train.torch_convert import convert_state_dict
from portbench.reference import build as ref_build
from portbench.reference import weights


def build(config_path: str, device: torch.device, trainer: bool):
    """``(task, trainer or None)`` as ``egorear_tpu_torch.run._run`` builds
    them for a subcommand: the config's precision set first, numpy seeded
    with the config's seed, the encoder's learning-rate scale resolved."""
    cfg = load_config(config_path)
    port_run.set_matmul_precision(cfg.trainer.precision)
    np.random.seed(cfg.seed)
    task, args = port_run.build_task(cfg, device)
    port_run._apply_encoder_lr(cfg, args)
    return task, (port_run.build_trainer(cfg, task, args) if trainer else None)


def set_up(r, trainer: bool):
    """A run's program as the CLI builds it, with the run's seeded weights
    loaded through the port's import, and its pool of inputs:
    ``(task, trainer or None, pool)``."""
    conf, p, dev = r.cell.config, r.params, r.device
    task_name, model_cfg = conf["task"], conf["model"]["init_args"]["model_cfg"]
    task, trainer = build(str(r.cell.config_path), dev, trainer)
    r.lap("program built")
    # The layout on the host (a first use of the meta device costs seconds).
    sd = weights.seeded_state_dict(ref_build.build_reference(task_name, model_cfg), r.seed, dev)
    r.lap("weights drawn")
    load_egorear(task, task_name, sd)
    del sd
    r.lap("weights loaded")
    size = model_cfg["image_size"][0]
    pool = weights.seeded_batches(r.seed, dev, p["pool"], p["batch"], image_size=size,
                                  heatmap_size=size // 4)
    r.lap("inputs made")
    return task, trainer, pool


def egorear_to_port(sd: Dict[str, torch.Tensor], task_name: str) -> Dict[str, torch.Tensor]:
    """An EgoRear-layout state dict as the port's, through the port's
    checkpoint import (``train.torch_convert``), on the host."""
    host = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    return from_flax(convert_state_dict(host, task_name, 4))


@torch.no_grad()
def load_egorear(task, task_name: str, sd: Dict[str, torch.Tensor]) -> None:
    """Load EgoRear-layout weights into the task's model (strict)."""
    task.model.load_state_dict(egorear_to_port(sd, task_name), strict=True)


def leaf_map(task_name: str, egorear_keys_shapes) -> Dict[str, str]:
    """{port parameter name: EgoRear key}: each EgoRear leaf filled with its
    own index and imported, then read back."""
    keys = [k for k, _ in egorear_keys_shapes]
    marked = {k: torch.full(tuple(s), float(i)) for i, (k, s) in enumerate(egorear_keys_shapes)}
    out = {}
    for name, v in egorear_to_port(marked, task_name).items():
        if v.is_floating_point() and v.numel():
            out[name] = keys[int(v.reshape(-1)[0])]
    return out


@contextlib.contextmanager
def sampling_calls(calls: list):
    """Inside the block every call of the lazy sampling op appends its
    inputs' shapes, its fp32 locations and weights and whether a backward
    will want its features' gradient."""
    original = port_layers.lazy_deform_sample

    def recorded(feat, loc, attn_w, pos=None, pos_block=False, plain=False):
        calls.append(dict(
            feat_shape=tuple(feat.shape), elem=feat.element_size(),
            loc=loc.detach().float(), attn_w=attn_w.detach().float(),
            pos_shape=None if pos is None else tuple(pos.shape), pos_block=pos_block,
            grad=torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (feat, loc, attn_w, pos)),
            need_feat=feat.requires_grad))
        return original(feat, loc, attn_w, pos, pos_block, plain=plain)

    port_layers.lazy_deform_sample = recorded
    try:
        yield
    finally:
        port_layers.lazy_deform_sample = original
