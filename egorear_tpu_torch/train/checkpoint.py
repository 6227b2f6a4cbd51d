"""Checkpoints in the port's own format, and the stage grafts (the JAX
package's ``train/checkpoint.py`` and ``run.py``'s ``PRETRAINED_GRAFTS`` /
``apply_pretrained``).

A checkpoint is ``<dir>/epoch=<N>.pt``, a ``torch.save`` of
``{"model": state dict (parameters and BN buffers), "optimizer": the
optimizer's state dict, "step": int, "epoch": int}``, read back with
``weights_only=True``. Each training stage starts from the previous stage's
checkpoint grafted into a submodule: a graft copies parameters and BN running
stats into the live model in place, so the optimizer keeps holding the
model's own parameters and its state is kept, as in the JAX package.

A graft or evaluation may also start from a reference EgoRear ``.ckpt`` (a
Lightning checkpoint), imported through the key grammar of
:mod:`egorear_tpu_torch.train.torch_convert` as strictly as the JAX package
imports it.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

StateDict = Dict[str, torch.Tensor]

# Stage-pretrained init_args key -> (submodule graft path, task name of the
# checkpoint's own stage; None: the task being trained).
PRETRAINED_GRAFTS = {
    "network_pretrained": ("", None),
    "heatmap_estimator_pretrained_stereo_front": (
        "heatmap_estimator_stereo_front", "heatmap"),
    "heatmap_estimator_pretrained_stereo_back": (
        "heatmap_estimator_stereo_back", "heatmap"),
    "heatmap_estimator_mvf_pretrained": ("heatmap_estimator", "heatmap_mvf_ex"),
}


def _pt(path: str) -> str:
    return path if path.endswith(".pt") else path + ".pt"


def save(ckpt_dir: str, epoch: int, state: Mapping) -> str:
    """Write ``state`` (:meth:`Trainer.state_dict`) and ``epoch`` to
    ``<ckpt_dir>/epoch=<epoch>.pt``; returns the path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"epoch={epoch}.pt"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({**state, "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    return path


def restore(path: str, map_location=None) -> dict:
    """A checkpoint written by :func:`save` (``path`` with or without its
    ``.pt``), its tensors on ``map_location``."""
    path = _pt(os.path.abspath(path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_latest(ckpt_dir: str, map_location=None
                   ) -> Tuple[Optional[dict], int]:
    """The highest-epoch checkpoint in ``ckpt_dir`` and its epoch; (None, -1)
    when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None, -1
    epochs = [int(m.group(1)) for m in
              (re.fullmatch(r"epoch=(\d+)\.pt", n) for n in os.listdir(ckpt_dir))
              if m]
    if not epochs:
        return None, -1
    best = max(epochs)
    return restore(os.path.join(ckpt_dir, f"epoch={best}"), map_location), best


def _check_same_structure(got: Mapping[str, torch.Tensor],
                          want: Mapping[str, torch.Tensor], where: str) -> None:
    errs = [f"missing {k}" for k in sorted(set(want) - set(got))]
    errs += [f"extra {k}" for k in sorted(set(got) - set(want))]
    errs += [f"shape mismatch {k}: {tuple(got[k].shape)} vs {tuple(v.shape)}"
             for k, v in want.items() if k in got and got[k].shape != v.shape]
    if errs:
        raise ValueError(f"structure mismatch at {where or '<root>'}:\n"
                         + "\n".join(errs[:10]))


def sub_state(sd: Mapping[str, torch.Tensor], sub_path: str) -> StateDict:
    """The entries of ``sd`` under the module path ``sub_path`` (dotted),
    with that prefix removed; all of ``sd`` for an empty path."""
    if not sub_path:
        return dict(sd)
    prefix = sub_path + "."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def graft(base: Mapping[str, torch.Tensor], sub_path: str,
          sub: Mapping[str, torch.Tensor]) -> StateDict:
    """``base`` with the entries under ``sub_path`` replaced by ``sub``.
    Strict: ``sub`` has exactly the keys and shapes that it replaces."""
    old = sub_state(base, sub_path)
    if not old:
        raise KeyError(f"graft path {sub_path!r} not in the state dict")
    _check_same_structure(sub, old, sub_path)
    prefix = sub_path + "." if sub_path else ""
    out = {k: v for k, v in base.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in sub.items()})
    return out


def prune_to_structure(target: Mapping[str, torch.Tensor],
                       sd: Mapping[str, torch.Tensor], where: str = "") -> StateDict:
    """Exactly ``target``'s keys, taken from ``sd``: extra keys are dropped
    (a stage-1 checkpoint's ``conv_heatmap`` head, which the stage-2
    estimators do not have), a missing key raises ``ValueError``."""
    missing = sorted(set(target) - set(sd))
    if missing:
        raise ValueError(f"checkpoint {where} is missing {missing[:8]}")
    return {k: sd[k] for k in target}


def load_pretrained(path: str, target: Mapping[str, torch.Tensor],
                    task_name: str) -> StateDict:
    """The model state of checkpoint ``path`` with ``target``'s keys and
    shapes. The port's ``.pt`` is pruned to ``target`` (a stage-1 head the
    target lacks is dropped); an EgoRear ``.ckpt`` of stage ``task_name``
    is imported strictly (:func:`~egorear_tpu_torch.train.torch_convert.
    import_lightning_ckpt`: an entry the target lacks, as a stage-1
    checkpoint's ``conv_heatmap`` head in a stage-2 estimator, raises
    ``ValueError``, as in the JAX package)."""
    if path.endswith(".ckpt"):
        from egorear_tpu_torch.train.torch_convert import import_lightning_ckpt

        return import_lightning_ckpt(path, target, task_name)
    sd = prune_to_structure(target, restore(path, map_location="cpu")["model"], path)
    _check_same_structure(sd, target, path)
    return sd


@torch.no_grad()
def apply_pretrained(model: nn.Module, task_name: str,
                     args: Mapping[str, Optional[str]]) -> list:
    """Graft the pretrained stages named in ``args`` (a config's init_args:
    the keys of :data:`PRETRAINED_GRAFTS` with checkpoint paths) into
    ``model``, in place: parameters and BN buffers are copied into the
    existing tensors, in their dtype and on their device, so an optimizer
    built on ``model`` keeps its parameters and its state. A tensor-parallel
    model (``parallel/tensor.py``) is grafted as the full tree, then each
    rank keeps its slices (every rank of a model group calls this). Returns
    the keys grafted."""
    from egorear_tpu_torch.parallel import tensor

    done = []
    for key, (sub_path, sub_task) in PRETRAINED_GRAFTS.items():
        ckpt = args.get(key)
        if not ckpt:
            continue
        sd = tensor.full_state_dict(model)
        loaded = load_pretrained(ckpt, sub_state(sd, sub_path), sub_task or task_name)
        tensor.load_full_state_dict(model, graft(sd, sub_path, loaded), strict=True)
        done.append(key)
    return done
