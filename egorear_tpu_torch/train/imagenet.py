"""ImageNet initialisation of the ResNet-18 backbones (the JAX package's
``train/torch_convert.py``: ``convert_torchvision_resnet18``,
``load_imagenet_resnet18`` and ``graft_imagenet_backbones``).

The reference builds its backbones from torchvision's ImageNet-pretrained
ResNet-18 whenever ``use_imagenet_pretrain`` is set, which every shipped
config does. Nothing is downloaded: the weights are looked up on disk, and a
missing file raises rather than training the backbone from scratch.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from egorear_tpu_torch.models.backbone import BackboneWithFPN

ENV_VAR = "EGOREAR_IMAGENET_RESNET18"
_CONV_LEAVES = ("weight", "bias")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _leaf(kind: str, name: str, key: str) -> Optional[str]:
    """The port's leaf name of a torchvision conv or BN leaf; None for a
    leaf that is dropped (``num_batches_tracked``)."""
    if kind == "bn" and name == "num_batches_tracked":
        return None
    if name not in (_BN_LEAVES if kind == "bn" else _CONV_LEAVES):
        raise KeyError(f"unrecognized torchvision key {key}")
    return name


def convert_torchvision_resnet18(sd: Mapping[str, object]
                                 ) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet18`` state dict -> the state dict of the port's
    :class:`~egorear_tpu_torch.models.backbone.ResNet18` (parameters and BN
    running stats).

    The classifier ``fc.*`` and every ``num_batches_tracked`` are dropped;
    ``layer{L}.{i}`` becomes ``layer{L}_{i}`` and ``downsample.0``/``.1``
    become ``downsample_conv``/``downsample_bn``. An unknown key raises
    ``KeyError``. Values may be tensors or numpy arrays.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if key.startswith("fc."):
            continue
        m = re.fullmatch(r"(conv1|bn1)\.(\w+)", key)
        if m:
            prefix, kind, name = m.group(1), m.group(1)[:-1], m.group(2)
        else:
            m = re.fullmatch(r"layer([1-4])\.([01])\.(conv1|conv2|bn1|bn2|"
                             r"downsample\.0|downsample\.1)\.(\w+)", key)
            if not m:
                raise KeyError(f"unrecognized torchvision key {key}")
            mod = {"downsample.0": "downsample_conv",
                   "downsample.1": "downsample_bn"}.get(m.group(3), m.group(3))
            prefix = f"layer{m.group(1)}_{m.group(2)}.{mod}"
            kind, name = ("bn" if "bn" in mod else "conv"), m.group(4)
        leaf = _leaf(kind, name, key)
        if leaf is not None:
            out[f"{prefix}.{leaf}"] = torch.as_tensor(np.asarray(v)).clone()
    return out


def load_imagenet_resnet18(path: Optional[str] = None
                           ) -> Dict[str, torch.Tensor]:
    """Locate and convert ImageNet ResNet-18 weights.

    Looked up in order: ``path``, the ``EGOREAR_IMAGENET_RESNET18``
    environment variable, then torchvision's hub cache
    (``~/.cache/torch/hub/checkpoints/resnet18-*.pth``). A ``.pth``/``.pt``
    torch state dict (optionally under ``"state_dict"``) or an ``.npz`` with
    the same keys. Raises ``FileNotFoundError`` when none exists.
    """
    candidates = [c for c in (path, os.environ.get(ENV_VAR)) if c]
    hub = os.path.expanduser("~/.cache/torch/hub/checkpoints")
    candidates += sorted(glob.glob(os.path.join(hub, "resnet18-*.pth")))
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        raise FileNotFoundError(
            "use_imagenet_pretrain=true but no resnet18 ImageNet weights "
            f"found. Provide them via the {ENV_VAR} env var or "
            "~/.cache/torch/hub/checkpoints/resnet18-*.pth (torchvision's "
            "cache location), or set "
            "encoder_cfg.resnet_cfg.use_imagenet_pretrain=false.")
    if found.endswith(".npz"):
        with np.load(found) as z:
            sd = {k: z[k] for k in z.files}
    else:
        raw = torch.load(found, map_location="cpu", weights_only=True)
        sd = raw.get("state_dict", raw)
    return convert_torchvision_resnet18(sd)


@torch.no_grad()
def graft_imagenet_backbones(model: nn.Module,
                             weights: Mapping[str, torch.Tensor]) -> int:
    """Copy ``weights`` (from :func:`convert_torchvision_resnet18`) into the
    ``encoder.resnet`` of every backbone of ``model``, in place and in each
    leaf's own dtype and device; the FPNs and heads keep their values.

    Returns the number of backbones grafted (1 in stage 1, 2 in stages 2-3).
    Raises ``ValueError`` when the keys or shapes differ from a backbone's,
    or when the model has no backbone.
    """
    n = 0
    for name, module in model.named_modules():
        if not isinstance(module, BackboneWithFPN):
            continue
        target = {k: v for k, v in module.resnet.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
        errs = [f"missing {k}" for k in sorted(set(target) - set(weights))]
        errs += [f"extra {k}" for k in sorted(set(weights) - set(target))]
        errs += [f"shape mismatch {k}: {tuple(weights[k].shape)} vs "
                 f"{tuple(v.shape)}" for k, v in target.items()
                 if k in weights and weights[k].shape != v.shape]
        if errs:
            raise ValueError(f"ImageNet resnet18 weights do not match the "
                             f"model's {name}.resnet:\n" + "\n".join(errs[:10]))
        for k, v in target.items():
            v.copy_(weights[k])
        n += 1
    if n == 0:
        raise ValueError("no encoder.resnet found to graft ImageNet weights into")
    return n
