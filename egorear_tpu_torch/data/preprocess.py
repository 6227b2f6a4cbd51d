"""On-device preprocessing of uint8 views (the JAX package's
``data/preprocess.py``).

The host only decodes JPEG/PNG files to uint8 HWC; the antialiased bicubic
resize to 256 px, the ImageNet normalisation and the Gaussian target
heatmaps are computed on the device that holds the batch (the card for a
CUDA batch, the CPU for a CPU one):

  * the resize is two matmuls with PIL's antialiased BICUBIC coefficients
    (separable Keys a = -0.5, the support scaled by the downscale ratio),
    H first, then W, in full fp32 whatever the caller's TF32 setting (JAX
    pins ``Precision.HIGHEST``), then rounded half to even, clipped to
    [0, 255] and scaled by 1/255;
  * the targets come from :func:`~egorear_tpu_torch.ops.heatmap.render_gaussian_targets`,
    the renderer of the offline precompute, so the heatmap NPYs are not
    read.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from egorear_tpu_torch.ops.heatmap import render_gaussian_targets

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# XLA computes a division by a constant as the product with the constant's
# fp32 reciprocal, and on the CPU contracts ``x * (1/255) - mean`` into one
# fused multiply-add. The port computes the same: the reciprocals below, and
# that one rounding from an exact fp64 intermediate, so its values are
# bitwise JAX's on the CPU wherever the resampled values agree.
_INV_255 = np.float32(1.0) / np.float32(255.0)
_INV_STD = np.float32(1.0) / IMAGENET_STD

_FILTER_CACHE = {}


def _const(value, device) -> torch.Tensor:
    """``value`` as a float32 tensor of at least one element on ``device``
    (not a 0-d CPU scalar, which ATen would treat as a Python number)."""
    return torch.as_tensor(np.atleast_1d(value), dtype=torch.float32, device=device)


def pil_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix equal to PIL's
    antialiased BICUBIC coefficients (Keys a = -0.5, support
    2 max(in/out, 1)); cached."""
    key = (in_size, out_size)
    if key in _FILTER_CACHE:
        return _FILTER_CACHE[key]

    def keys(x):
        a = -0.5
        x = np.abs(x)
        return np.where(
            x < 1.0,
            ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
        )

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    m = np.zeros((out_size, in_size), np.float32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax)
        w = keys((xs - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        m[xx, xmin:xmax] = w
    _FILTER_CACHE[key] = m
    return m


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """Full fp32 matmul products on every backend for the block (TF32 and
    bf16 off), the caller's settings restored after it, whichever API set
    them."""
    backends = [b for b in (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
                if hasattr(b, "fp32_precision")]
    saved = [b.fp32_precision for b in backends]
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # only the per-backend API was used
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        for b, value in zip(backends, saved):
            b.fp32_precision = value


def _resample_levels(images_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 (..., 3, out, out): the resampled
    values rounded half to even and clipped to [0, 255], as PIL's 8-bit
    output. The second product writes channels-first, so no copy moves the
    channels."""
    *lead, H, W, C = images_u8.shape
    device = images_u8.device
    My = torch.from_numpy(pil_bicubic_matrix(H, out_size)).to(device)
    MxT = torch.from_numpy(pil_bicubic_matrix(W, out_size)).to(device).t()
    # One pass converts to fp32 and lays the channels first.
    x = images_u8.reshape(-1, H, W, C).permute(0, 3, 1, 2).to(
        torch.float32, memory_format=torch.contiguous_format)
    with _ieee_fp32_matmul():
        x = torch.matmul(My, x)    # contract H: (N, C, out, W)
        x = torch.matmul(x, MxT)   # then W: (N, C, out, out)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x.reshape(*lead, C, out_size, out_size)


def resize_bicubic_device(images_u8: torch.Tensor, out_size: int = 256) -> torch.Tensor:
    """uint8 (..., H, W, 3) -> float32 (..., out, out, 3) in [0, 1], on the
    tensor's device. Matches PIL ``Image.resize(BICUBIC)`` with a float
    intermediate (PIL's own 8-bit intermediate differs by <= 1 LSB)."""
    x = _resample_levels(images_u8, out_size) * _const(_INV_255, images_u8.device)
    return torch.movedim(x, -3, -1)


def preprocess_images_device(images_u8: torch.Tensor, out_size: int = 256) -> torch.Tensor:
    """uint8 (B, V, H, W, 3) -> ImageNet-normalised float32 (B, V, 3, out,
    out), on the tensor's device."""
    levels = _resample_levels(images_u8, out_size)
    device = levels.device
    # (levels * (1/255) - mean) with one rounding: the product of an 8-bit
    # level and a float32 and the difference are exact in float64.
    x = (levels.double() * float(_INV_255)
         - torch.from_numpy(IMAGENET_MEAN).double().to(device)[:, None, None]).float()
    return x * _const(_INV_STD, device)[:, None, None]


def preprocess_batch_device(
    images_u8: torch.Tensor,  # (B, V, H, W, 3) uint8
    joints_2d: Optional[torch.Tensor] = None,  # (B, V, J, 2) px, source frame
    image_size: int = 872,
    heatmap_size: int = 64,
    sigma: float = 1.0,
    drop_head: bool = True,
) -> dict:
    """Images and, given ``joints_2d``, target heatmaps, on the images'
    device: ``{"img": (B, V, 3, 256, 256) float32, "gt_heatmap": (B, V, J',
    64, 64)}`` with J' = J - 1 when ``drop_head`` (the reference drops the
    Head channel)."""
    out = {"img": preprocess_images_device(images_u8, 256)}
    if joints_2d is not None:
        targets, _ = render_gaussian_targets(
            torch.as_tensor(joints_2d, device=images_u8.device),
            image_size=image_size, heatmap_size=heatmap_size, sigma=sigma)
        if drop_head:
            targets = targets[..., 1:, :, :]
        out["gt_heatmap"] = targets
    return out
