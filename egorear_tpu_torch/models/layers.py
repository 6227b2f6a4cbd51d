"""Transformer building blocks shared by the MVFex and Pose3D stages (the JAX
package's ``models/layers.py``): dropout, FFN, MultiheadAttention, the
deformable attention in both computation orders (reference and lazy), the
align-corners resizes, and the weight init.

Layout: feature maps are NCHW; token sequences are (B, L, C). A flax
``Dense`` that the JAX package applies to an NHWC map becomes a
:class:`PointwiseConv` here, which keeps Linear's (out, in) weight so the
weight bridge (``convert.from_flax``) treats every Dense alike. LayerNorms
use flax's epsilon, 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from egorear_tpu_torch.ops.deform_attn import deformable_sampling, lazy_deform_sample

LN_EPS = 1e-6  # flax nn.LayerNorm default


def layer_norm(dims: int) -> nn.LayerNorm:
    return nn.LayerNorm(dims, eps=LN_EPS)


class PointwiseConv(nn.Linear):
    """A Linear applied along the channel axis of an NCHW map (a 1x1 conv
    whose weight keeps Linear's (out, in) shape)."""

    def forward(self, x):
        return F.conv2d(x, self.weight[:, :, None, None], self.bias)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    """3x3 conv with torch-style explicit symmetric padding 1."""
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def add_modules(parent: nn.Module, **modules: nn.Module) -> None:
    """Register submodules under the JAX package's parameter names (e.g.
    ``transformer_0``), so the weight bridge maps paths one to one."""
    for name, m in modules.items():
        parent.add_module(name, m)


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode at rate ``p`` > 0 each element is
    kept where a uniform draw is below ``1 - p`` and scaled by
    ``1 / (1 - p)``, else zeroed. The draws come from the module's
    ``generator`` (set by :func:`dropout_generator`), never from the global
    RNG; in train mode without one this raises. In eval mode, or at rate 0,
    the identity.

    With ``shard`` (a :class:`~egorear_tpu_torch.parallel.dist.DataShard`
    of W > 1 data ranks, set by :func:`data_parallel`) the module draws the
    global batch's (W n, ...) uniforms and keeps this data rank's n rows,
    so W ranks drop bitwise what one process drops on the whole batch (the
    ranks of a model group, which hold the same rows, draw the same). The
    leading axis must be the batch's, in global order, a rank holding a
    contiguous block of it: true at every call site (the FFNs' (B, J, C)
    tokens in the refiners and the lifting layers, the proposal MLP's
    (B, features)).
    """

    shard = None

    def __init__(self, p: float = 0.0):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout rate {p} is not in [0, 1]")
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def extra_repr(self) -> str:
        return f"p={self.p}"

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError(f"dropout at rate {self.p} in train mode needs a "
                               f"generator: run the model under "
                               f"dropout_generator(model, gen)")
        keep = 1.0 - self.p
        if self.shard is not None and self.shard.world > 1:
            n = x.shape[0]
            u = torch.rand((n * self.shard.world,) + x.shape[1:],
                           generator=self.generator, device=x.device)
            u = u[self.shard.rank * n:(self.shard.rank + 1) * n]
        else:
            u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


@contextlib.contextmanager
def dropout_generator(model: nn.Module,
                      gen: Optional[torch.Generator]) -> Iterator[None]:
    """Within the block, every :class:`Dropout` of ``model`` in train mode
    draws its masks from ``gen`` (a generator on the activations' device),
    in call order: the V refiners, each layer's FFN and the proposal MLP
    each draw their own. ``None`` changes nothing."""
    drops = ([m for m in model.modules() if isinstance(m, Dropout)]
             if gen is not None else [])
    saved = [m.generator for m in drops]
    for m in drops:
        m.generator = gen
    try:
        yield
    finally:
        for m, g in zip(drops, saved):
            m.generator = g


@contextlib.contextmanager
def data_parallel(model: nn.Module, shard) -> Iterator[None]:
    """Within the block, every BatchNorm and :class:`Dropout` of ``model``
    in train mode acts on the global batch of the data-parallel ``shard``
    (a :class:`~egorear_tpu_torch.parallel.dist.DataShard`; see each
    class). ``None`` changes nothing."""
    from egorear_tpu_torch.models.backbone import BatchNorm2d

    mods = ([m for m in model.modules() if isinstance(m, (BatchNorm2d, Dropout))]
            if shard is not None else [])
    for m in mods:
        m.shard = shard
    try:
        yield
    finally:
        for m in mods:
            del m.shard


class FFN(nn.Module):
    """(num_fcs - 1) x [Linear -> GELU -> Dropout], then Linear -> Dropout
    (no residual inside)."""

    def __init__(self, embed_dims: int, feedforward_dims: int,
                 num_fcs: int = 2, ffn_drop: float = 0.0):
        super().__init__()
        self.num_fcs = num_fcs
        dims = [embed_dims] + [feedforward_dims] * (num_fcs - 1) + [embed_dims]
        for i in range(num_fcs):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.drop = Dropout(ffn_drop)

    def forward(self, x):
        for i in range(self.num_fcs - 1):
            x = self.drop(F.gelu(getattr(self, f"Dense_{i}")(x)))
        return self.drop(getattr(self, f"Dense_{self.num_fcs - 1}")(x))


class MultiheadAttention(nn.Module):
    """Batch-first multi-head attention over short token sequences (J = 15
    or 16): separate q/k/v/out projections, plain softmax attention."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def reset_parameters_(self, gen: torch.Generator) -> None:
        for lin in (self.q_proj, self.k_proj, self.v_proj, self.out_proj):
            xavier_uniform_(lin.weight, gen)
            nn.init.zeros_(lin.bias)

    def forward(self, q, k, v):
        B, Lq, C = q.shape
        H = self.num_heads
        hd = C // H

        def heads(x):
            return x.reshape(B, -1, H, hd).transpose(1, 2)

        _q, _k, _v = heads(self.q_proj(q)), heads(self.k_proj(k)), heads(self.v_proj(v))
        attn = torch.softmax((_q @ _k.transpose(-2, -1)) * hd**-0.5, dim=-1)
        out = (attn @ _v).transpose(1, 2).reshape(B, Lq, C)
        return self.out_proj(out)


def deform_offset_bias(n_heads: int, n_points: int) -> torch.Tensor:
    """Directional ring bias for the sampling offsets (head h points along
    angle 2*pi*h/n_heads, point p at ring radius p + 1)."""
    thetas = torch.arange(n_heads, dtype=torch.float32) * (2.0 * math.pi / n_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], dim=-1)  # (H, 2)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    grid = grid[:, None, :].repeat(1, n_points, 1)  # (H, P, 2)
    ring = torch.arange(1, n_points + 1, dtype=torch.float32)[None, :, None]
    return (grid * ring).reshape(-1)


class MSDeformAttn(nn.Module):
    """Single-level multi-head deformable attention in the reference
    computation order (mmcv MSDA; the JAX package's ``MSDeformAttn``):
    ``value_proj`` on every grid cell, per-head bilinear sampling of the
    projected value map at ``reference_points + offsets / (W, H)``, weighted
    by softmaxed attention weights, then ``output_proj``.

    The attribute ``impl`` is ``"kernel"``: sample through
    :func:`deformable_sampling` (the CUDA kernels forward and backward on a
    card, the plain versions on the CPU). Checks of the kernels set it to
    ``"plain"`` to run the plain versions on the card.
    """

    def __init__(self, d_model: int = 256, n_heads: int = 8, n_points: int = 16):
        super().__init__()
        self.d_model, self.n_heads, self.n_points = d_model, n_heads, n_points
        self.impl = "kernel"
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def reset_parameters_(self, gen: torch.Generator) -> None:
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(
                deform_offset_bias(self.n_heads, self.n_points))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        for lin in (self.value_proj, self.output_proj):
            xavier_uniform_(lin.weight, gen)
            nn.init.zeros_(lin.bias)

    def _plain(self) -> bool:
        if self.impl not in ("kernel", "plain"):
            raise ValueError(f"unknown sampling impl {self.impl!r}")
        return self.impl == "plain"

    def _locations(self, query, reference_points, spatial_shape):
        """Sampling locations (B, Q, nh, P, 2) in the activation dtype and
        softmaxed attention weights (B, Q, nh, P)."""
        B, Q, _ = query.shape
        H, W = spatial_shape
        nh, P = self.n_heads, self.n_points
        offsets = self.sampling_offsets(query).reshape(B, Q, nh, P, 2)
        weights = self.attention_weights(query).reshape(B, Q, nh, P)
        weights = torch.softmax(weights, dim=-1)
        normalizer = torch.tensor([W, H], dtype=offsets.dtype,
                                  device=offsets.device)
        return reference_points[:, :, None, None, :] + offsets / normalizer, weights

    def forward(self, query, reference_points, value_flat, spatial_shape):
        """query (B, Q, C); reference_points (B, Q, 2) in [0, 1] (x, y);
        value_flat (B, H*W, C) the memory on the grid, row-major."""
        plain = self._plain()
        H, W = spatial_shape
        value = self.value_proj(value_flat).reshape(
            query.shape[0], H, W, self.n_heads, -1)
        loc, weights = self._locations(query, reference_points, spatial_shape)
        out = deformable_sampling(value, loc, weights, plain=plain)
        return self.output_proj(out)


class MSDeformAttnLazy(MSDeformAttn):
    """Deformable attention that samples RAW memory and projects afterwards.

    Identical in value to :class:`MSDeformAttn` over
    ``memory = feat @ mem_kernel + mem_bias (+ pos)``: linear maps and
    additive position tables commute with attention-weighted bilinear
    sampling, so the memory and value projections run on the ~Q*heads
    sampled vectors instead of the H*W grid. Zero-padded corners mean
    constants do not sample to themselves at borders, so a ones channel is
    sampled alongside and scales every constant term (mem_bias, value bias).
    The parameters are :class:`MSDeformAttn`'s, so one state dict loads into
    either order.

    The attribute ``impl`` is ``"kernel"``: sample through
    :func:`lazy_deform_sample` (the CUDA kernels forward and backward on a
    card, the plain versions on the CPU). Checks of the kernels set it to
    ``"plain"`` to run the plain versions on the card.
    """

    def __init__(self, d_model: int = 256, n_heads: int = 8, n_points: int = 16,
                 pos_block: bool = False):
        super().__init__(d_model, n_heads, n_points)
        # Layout of per-group mem_pos tables along the folded batch: False =
        # INTERLEAVED (element i uses table i % G); True = contiguous BLOCKS
        # (view-major fold, table i // (N/G)).
        self.pos_block = pos_block

    def forward(self, query, reference_points, feat_raw, spatial_shape,
                mem_kernel: Optional[torch.Tensor] = None,
                mem_bias: Optional[torch.Tensor] = None,
                mem_pos: Optional[torch.Tensor] = None):
        """query (B, Q, C); reference_points (B, Q, 2) in [0, 1] (x, y);
        feat_raw (B, H*W, Cin) raw memory, contiguous; mem_kernel (Cin, C)
        and mem_bias (C,) the memory projection; mem_pos (H*W, C) shared or
        (G, H*W, C) per group, laid out per ``pos_block``. value_proj is
        applied post-sampling, through its weights only."""
        plain = self._plain()
        B, Q, C = query.shape
        nh = self.n_heads
        ch = C // nh
        Cin = feat_raw.shape[-1]
        loc, weights = self._locations(query, reference_points, spatial_shape)

        wv = self.value_proj.weight.t().to(query.dtype)  # (C, C) as x @ wv
        bv = self.value_proj.bias.to(query.dtype)

        pos = mem_pos.to(feat_raw.dtype) if mem_pos is not None else None
        s_feat, s_pos, s_one = lazy_deform_sample(
            feat_raw, loc, weights, pos, self.pos_block, plain=plain)

        wv_h = wv.reshape(C, nh, ch)
        const = bv.reshape(nh, ch)
        if mem_kernel is not None:
            km = (mem_kernel.to(query.dtype) @ wv).reshape(Cin, nh, ch)
            v = torch.einsum("bqnc,cnd->bqnd", s_feat, km)
            if mem_bias is not None:
                const = const + (mem_bias.to(query.dtype) @ wv).reshape(nh, ch)
        else:
            v = torch.einsum("bqnc,cnd->bqnd", s_feat, wv_h)
        if s_pos is not None:
            v = v + torch.einsum("bqnc,cnd->bqnd", s_pos, wv_h)
        v = v + s_one * const
        return self.output_proj(v.reshape(B, Q, C))


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n: int, out_n: int) -> np.ndarray:
    """(out_n, n) align-corners interpolation rows, weights computed in
    float64 then stored as float32 (as the JAX package builds them)."""
    m = np.zeros((out_n, n), np.float32)
    if n == 1 or out_n == 1:
        m[:, 0] = 1.0
    else:
        pos = np.arange(out_n) * (n - 1) / (out_n - 1)
        lo = np.floor(pos).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        w = (pos - lo).astype(np.float32)
        m[np.arange(out_n), lo] += 1.0 - w
        m[np.arange(out_n), hi] += w
    m.setflags(write=False)
    return m


@functools.lru_cache(maxsize=64)
def _interp_matrix(n: int, out_n: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    # A normal (not inference-mode) tensor, so a cached matrix first made
    # under torch.inference_mode() still serves autograd later.
    with torch.inference_mode(False):
        return torch.tensor(_interp_matrix_np(n, out_n), dtype=dtype, device=device)


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear align_corners=True resize of an NCHW map to ``out_hw``.

    Two matmuls with the interpolation matrices, as in the JAX package:
    the weights are exact float64 fractions rounded once to ``x.dtype``,
    where ``F.interpolate`` computes source positions in float32 and drifts
    by ~1e-5 on larger maps.
    """
    H, W = x.shape[-2:]
    oh, ow = out_hw
    if (oh, ow) == (H, W):
        return x
    My = _interp_matrix(H, oh, x.dtype, x.device)
    Mx = _interp_matrix(W, ow, x.dtype, x.device)
    return torch.matmul(torch.matmul(My, x), Mx.t())


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample with align_corners=True (NCHW)."""
    H, W = x.shape[-2:]
    return resize_align_corners(x, (2 * H, 2 * W))


# -- weight init (random weights from a generator) ---------------------------


def xavier_uniform_(w: torch.Tensor, gen: torch.Generator) -> None:
    fan_out, fan_in = w.shape[0], w.shape[1] * w[0][0].numel()
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=gen)


def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Random weights in the JAX package's init scheme, drawn from ``gen``.

    Linear and conv kernels: LeCun normal (std 1/sqrt(fan_in)), zero bias;
    norms: unit scale, zero shift, unit running variance; modules with a
    ``reset_parameters_(gen)`` method (attention, deformable attention, the
    refiner's embeddings) then apply their own scheme. The numbers differ from
    flax's for the same seed: weights are carried across by ``convert``.
    """
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in**-0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        for m in model.modules():
            if hasattr(m, "reset_parameters_"):
                m.reset_parameters_(gen)
    return model
