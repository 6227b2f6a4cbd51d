"""ResNet-18 + EfficientFPN backbone, NCHW, stride-4 output (the JAX
package's ``models/backbone.py``).

Convolutions use torch-style explicit symmetric padding; BatchNorm is
:class:`BatchNorm2d`, flax's BatchNorm of the JAX package (eps 1e-5, flax
momentum 0.9, which is torch's 0.1). With ``bn_folded`` the convs carry the
bias that :func:`fold_batchnorm` absorbs and there is no BN.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from egorear_tpu_torch.models.layers import upsample2x_align_corners
from egorear_tpu_torch.utils import trace

BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's (flax) train-mode semantics.

    In training the output is normalised with the biased batch statistics,
    as ``nn.BatchNorm2d`` does, but the running variance follows flax: its
    EMA takes the BIASED batch variance, where torch takes the unbiased one
    (a factor n/(n-1), 4/3 on the 2x2 stride-32 maps of a 64 px batch of 2
    views). The statistics are computed in fp32 whatever the input dtype, as
    flax's ``force_float32_reductions`` does, and the running stats stay
    fp32. Eval mode is ``nn.BatchNorm2d``'s.

    With ``shard`` (a :class:`~egorear_tpu_torch.parallel.dist.DataShard`
    of more than one rank, set by :func:`~egorear_tpu_torch.models.layers.
    data_parallel`) the statistics are the global batch's, as under the JAX
    package's sharded jit: each rank's (count, mean, M2) is gathered over
    the shard's data group (never the whole grid: a model group's ranks
    hold the same rows, and counting them M times would scale the
    backward by M) by a differentiable all-reduce and combined in rank
    order (Chan's formula),
    in fp32 or the input's wider dtype, so the backward flows through the
    global statistics and every rank updates the same running stats. With
    ``replay`` (a rematerialised forward's second run) the running stats
    are not updated again. Every call is the program's ``norm`` span.
    """

    shard = None
    replay = False

    def forward(self, x):
        with trace.span("norm"):
            if not self.training:
                return super().forward(x)
            if self.shard is not None and self.shard.world > 1:
                return self._global_forward(x)
            if not self.replay:
                with torch.no_grad():
                    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
                    self._update(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                                self.eps)

    def _update(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x):
        from egorear_tpu_torch.parallel import dist

        dt = torch.promote_types(x.dtype, torch.float32)
        var, mean = torch.var_mean(x.to(dt), dim=(0, 2, 3), unbiased=False)
        n = torch.full_like(mean, x.numel() // x.shape[1])
        count, means, m2 = dist.gather(torch.stack([n, mean, var * n]),
                                       self.shard).unbind(1)
        total = count.sum(0)
        mean = (count * means).sum(0) / total
        var = (m2 + count * (means - mean) ** 2).sum(0) / total
        if not self.replay:
            with torch.no_grad():
                self._update(mean.to(self.running_mean.dtype),
                             var.to(self.running_var.dtype))
        scale = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        shift = self.bias.to(dt) - mean * scale
        return (x.to(dt) * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def _bn(channels: int, folded: bool) -> nn.Module:
    return nn.Identity() if folded else BatchNorm2d(channels, eps=BN_EPS)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, channels: int, stride: int = 1,
                 bn_folded: bool = False):
        super().__init__()
        bias = bn_folded
        self.conv1 = nn.Conv2d(cin, channels, 3, stride, 1, bias=bias)
        self.bn1 = _bn(channels, bn_folded)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=bias)
        self.bn2 = _bn(channels, bn_folded)
        self.has_downsample = stride != 1 or cin != channels
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(cin, channels, 1, stride, bias=bias)
            self.downsample_bn = _bn(channels, bn_folded)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet18(nn.Module):
    """Stride-pyramid ResNet-18: (N, 3, H, W) -> [s4, s8, s16, s32] (or a
    suffix of it per ``out_stride``), channels (64, 128, 256, 512)."""

    def __init__(self, out_stride: int = 4, bn_folded: bool = False):
        super().__init__()
        self.out_stride = out_stride
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=bn_folded)
        self.bn1 = _bn(64, bn_folded)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for layer, (channels, strides) in enumerate(
                ((64, (1, 1)), (128, (2, 1)), (256, (2, 1)), (512, (2, 1))), 1):
            for i, stride in enumerate(strides):
                self.add_module(f"layer{layer}_{i}",
                                BasicBlock(cin, channels, stride, bn_folded))
                cin = channels

    def forward(self, x) -> List[torch.Tensor]:
        out = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        feats = []
        for layer in range(1, 5):
            for i in range(2):
                out = getattr(self, f"layer{layer}_{i}")(out)
            feats.append(out)
        start = {4: 0, 8: 1, 16: 2, 32: 3}[self.out_stride]
        return feats[start:]


class EfficientFPN(nn.Module):
    """Top-down FPN: lateral 1x1 -> x2 align-corners upsample -> concat ->
    fuse 1x1 -> 3x3, emitting the finest level."""

    def __init__(self, in_channels: Sequence[int] = (64, 128, 256, 512),
                 out_channels: int = 128):
        super().__init__()
        n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral_{i}", nn.Conv2d(c, out_channels, 1))
        for i in range(n - 1):
            self.add_module(f"fuse_{i}", nn.Conv2d(2 * out_channels, out_channels, 1))
            self.add_module(f"fpn_{i}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.n = n

    def forward(self, feats):
        laterals = [F.relu(getattr(self, f"lateral_{i}")(f))
                    for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            up = upsample2x_align_corners(laterals[i])
            fused = F.relu(getattr(self, f"fuse_{i - 1}")(
                torch.cat([laterals[i - 1], up], dim=1)))
            laterals[i - 1] = F.relu(getattr(self, f"fpn_{i - 1}")(fused))
        return laterals[0]


class BackboneWithFPN(nn.Module):
    """ResNet-18 + FPN over view-folded batches: (N, 3, H, W) ->
    (fpn (N, C, H/4, W/4), pyramid list)."""

    def __init__(self, out_stride: int = 4, fpn_channels: int = 128,
                 bn_folded: bool = False):
        super().__init__()
        self.resnet = ResNet18(out_stride, bn_folded)
        in_channels = (64, 128, 256, 512)[{4: 0, 8: 1, 16: 2, 32: 3}[out_stride]:]
        self.fpn = EfficientFPN(in_channels, fpn_channels)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        pyramid = self.resnet(x)
        return self.fpn(pyramid), pyramid


# -- eval-mode BatchNorm folding (serving path) ------------------------------

_BN_PAIRS = (("conv1", "bn1"), ("conv2", "bn2"),
             ("downsample_conv", "downsample_bn"))


def fold_batchnorm(state_dict: Dict[str, torch.Tensor], eps: float = BN_EPS
                   ) -> Dict[str, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding conv weights.

    Input: the state dict of a model built on :class:`ResNet18` with BN.
    Output: the state dict of the SAME model built with ``bn_folded=True``:
    every (conv, bn) pair becomes a biased conv with

        weight' = weight * gamma / sqrt(var + eps)
        bias'   = beta - mean * gamma / sqrt(var + eps)

    computed in fp32, then stored in the conv weight's dtype. Fold before
    any bf16 cast, so the absorbed scale rounds once.
    """
    out = dict(state_dict)
    for key in state_dict:
        for conv, bn in _BN_PAIRS:
            suffix = f".{bn}.running_mean"
            if not key.endswith(suffix) and key != suffix[1:]:
                continue
            prefix = key[: -len(suffix) + 1]  # "" or "...parent."
            w_key = f"{prefix}{conv}.weight"
            if w_key not in state_dict:
                continue
            gamma = state_dict[f"{prefix}{bn}.weight"].float()
            beta = state_dict[f"{prefix}{bn}.bias"].float()
            mean = state_dict[f"{prefix}{bn}.running_mean"].float()
            var = state_dict[f"{prefix}{bn}.running_var"].float()
            scale = gamma * torch.rsqrt(var + eps)
            w = state_dict[w_key]
            out[w_key] = (w.float() * scale[:, None, None, None]).to(w.dtype)
            out[f"{prefix}{conv}.bias"] = (beta - mean * scale).to(w.dtype)
            for leaf in ("weight", "bias", "running_mean", "running_var",
                         "num_batches_tracked"):
                out.pop(f"{prefix}{bn}.{leaf}", None)
    return out
