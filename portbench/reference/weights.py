"""Seeded weights and inputs in EgoRear's layout, made on the device.

The weights of a reference module are drawn in one call of ``torch.randn``
from a generator on ``device`` seeded with the run's seed, then shifted
and scaled per leaf by its kind (:func:`leaf_scales`). Both sides get
them: the reference as they are, the program through its own import of
EgoRear checkpoints. The inputs of a batch are drawn the same way.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


# Two leaves drawn as a trained network has them, so that the mechanisms
# the configurations gate do work: the initial heatmap heads' last conv at
# 4x LeCun, so that about half of the heatmap peaks reach the 0.5 validity
# threshold of the refiners' anchors (LeCun alone leaves every one below),
# and the proposal's output bias N(0, 30 cm), the spread of the poses, so
# that the projected anchors spread over the views.
EMPHASIS = ((re.compile(r"conv_heatmap_layers_stereo_(front|back)\.9\.weight$"), 4.0, None),
            (re.compile(r"^pose3d_estimator\.mlp_pred\.\d+\.bias$"), None, 30.0))


def leaf_scales(model: nn.Module) -> List[Tuple[str, torch.Size, float, float]]:
    """(key, shape, mean, std) of every float entry of ``model``'s state
    dict: conv and linear kernels LeCun normal (std 1/sqrt(fan_in)), their
    biases N(0, 0.02); norm scales N(1, 0.1), norm shifts N(0, 0.1);
    BatchNorm running means N(0, 0.1) and variances N(1, 0.1); embeddings
    N(0, 1); position tables N(0, 0.02); then :data:`EMPHASIS`."""
    out = []
    for mname, mod in model.named_modules():
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if not t.is_floating_point():
                continue
            key = f"{mname}.{name}" if mname else name
            if isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mean, std = {"weight": (1.0, 0.1), "bias": (0.0, 0.1),
                             "running_mean": (0.0, 0.1), "running_var": (1.0, 0.1)}[name]
            elif isinstance(mod, nn.Embedding):
                mean, std = 0.0, 1.0
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                if name == "weight":
                    mean, std = 0.0, 1.0 / math.sqrt(t[0].numel())
                else:
                    mean, std = 0.0, 0.02
            else:
                mean, std = 0.0, 0.02
            for pattern, factor, fixed in EMPHASIS:
                if pattern.search(key):
                    std = fixed if fixed else std * factor
            out.append((key, t.shape, mean, std))
    return out


def seeded_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """``model``'s state dict drawn from ``seed`` on ``device``: one draw,
    one affine map, then views (integer entries are zeros)."""
    scales = leaf_scales(model)
    numels = torch.tensor([math.prod(s) for _, s, _, _ in scales], device=device)
    mean = torch.repeat_interleave(
        torch.tensor([m for _, _, m, _ in scales], device=device), numels)
    std = torch.repeat_interleave(
        torch.tensor([s for _, _, _, s in scales], device=device), numels)
    flat = torch.randn(int(numels.sum()), generator=generator(seed, device),
                       device=device) * std + mean
    sd, offset = {}, 0
    for key, shape, _, _ in scales:
        n = math.prod(shape)
        sd[key] = flat[offset:offset + n].view(shape)
        offset += n
    for key, t in model.state_dict().items():
        if key not in sd:
            sd[key] = torch.zeros_like(t, device=device)
    return sd


def seeded_batches(seed: int, device, count: int, batch: int, views: int = 4,
                   image_size: int = 256, heatmap_size: int = 64,
                   num_heatmap: int = 15, num_joints: int = 16) -> List[Dict[str, torch.Tensor]]:
    """``count`` batches, every row different: images (normalised pixels: a
    smooth field plus noise), Gaussian 2D targets (sigma 2 px) at random
    points, and 3D poses N(0, 30 cm). Drawn after the weights' stream, from
    a generator of its own."""
    g = generator(seed ^ 0x5EED, device)
    n = count * batch
    coarse = torch.randn(n * views, 3, image_size // 16, image_size // 16, generator=g,
                         device=device)
    img = F.interpolate(coarse, size=(image_size, image_size), mode="bilinear",
                        align_corners=False)
    img = img + 0.25 * torch.randn(img.shape, generator=g, device=device)
    img = img.reshape(n, views, 3, image_size, image_size)
    centre = torch.rand(n, views, num_heatmap, 2, generator=g, device=device) * heatmap_size
    ax = torch.arange(heatmap_size, device=device, dtype=torch.float32)
    dx = (ax - centre[..., 0:1]) ** 2
    dy = (ax - centre[..., 1:2]) ** 2
    hm = torch.exp(-(dy[..., :, None] + dx[..., None, :]) / (2 * 2.0 ** 2))
    pose = torch.randn(n, num_joints, 3, generator=g, device=device) * 30.0
    return [{"img": img[i * batch:(i + 1) * batch],
             "gt_heatmap": hm[i * batch:(i + 1) * batch],
             "gt_pose": pose[i * batch:(i + 1) * batch]} for i in range(count)]
