"""The yardstick's peaks and its least-time arithmetic of the lazy sampling
kernels.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity, at the full
700 W): 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM.

:func:`corner_rows`, :func:`lazy_sample_bound_ms` and
:func:`lazy_sample_backward_bound_ms` are a frozen copy of
``chip_smoke.py:528-592`` at commit 6e4c43b, taking the feature and
position tables by shape (the benchmark keeps the sampling positions and
weights of each call, not its feature maps).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
PEAK_FLOPS = {"fp32": FP32_FLOPS_PER_S}


def corner_rows(feat_shape, loc, pos_shape, pos_block):
    """For these sampling locations: the number of distinct feature rows and
    pos rows that an in-range corner touches, and of in-range corners."""
    B, HW, _ = feat_shape
    H = W = int(HW ** 0.5)
    C = pos_shape[-1] if pos_shape is not None else 0
    G = pos_shape[0] if pos_shape is not None else 1
    x = loc[..., 0].float() * W - 0.5
    y = loc[..., 1].float() * H - 0.5
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    g = b // (B // G) if pos_block else b % G
    feat_rows, pos_rows, n_corners = [], [], 0
    for dy in (0, 1):
        for dx in (0, 1):
            xc, yc = x0 + dx, y0 + dy
            ok = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            cell = (yc * W + xc).clamp(0, HW - 1)
            n_corners += int(ok.sum())
            feat_rows.append((b * HW + cell)[ok])
            pos_rows.append((g * HW + cell)[ok])
    n_feat = int(torch.unique(torch.cat(feat_rows)).numel())
    n_pos = int(torch.unique(torch.cat(pos_rows)).numel()) if C else 0
    return n_feat, n_pos, n_corners


def _bound(nbytes, flops):
    return max(nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3)


def lazy_sample_bound_ms(feat_shape, elem, loc, attn_w, pos_shape, pos_block):
    """Least time for one lazy_deform_sample call on these inputs.

    Bytes: each distinct feature row and pos row that an in-range corner
    touches, read once; loc and attn_w (fp32) read once; s_feat, s_pos and
    s_one written once. Operations: one multiply-add (2 flops) per channel
    per in-range corner, fp32 outside the tensor cores. The larger of the
    two times at the published H100 peaks."""
    Cin = feat_shape[-1]
    C = pos_shape[-1] if pos_shape is not None else 0
    n_feat, n_pos, n_corners = corner_rows(feat_shape, loc, pos_shape, pos_block)
    rows_out = attn_w.numel() // attn_w.shape[-1]
    nbytes = (n_feat * Cin * elem + n_pos * C * elem + loc.numel() * 4
              + attn_w.numel() * 4 + rows_out * (Cin + C + 1) * elem)
    return _bound(nbytes, 2 * n_corners * (Cin + C + 1))


def lazy_sample_backward_bound_ms(feat_shape, elem, loc, attn_w, pos_shape, pos_block,
                                  need_feat):
    """Least time for one lazy_deform_sample backward on these inputs.

    Bytes: the upstream gradients read once; the distinct feature and pos
    rows that an in-range corner touches, loc and attn_w (fp32) read once;
    d_feat written once in full when it is wanted, d_pos in full, d_loc and
    d_attn_w (fp32) once. Operations: per in-range corner and channel one
    multiply-add for the adjoint and one for each wanted scatter, fp32."""
    B, HW, Cin = feat_shape
    C = pos_shape[-1] if pos_shape is not None else 0
    G = pos_shape[0] if pos_shape is not None else 0
    n_feat, n_pos, n_corners = corner_rows(feat_shape, loc, pos_shape, pos_block)
    rows = attn_w.numel() // attn_w.shape[-1]
    nbytes = (rows * (Cin + C + 1) * elem + n_feat * Cin * elem + n_pos * C * elem
              + loc.numel() * 4 + attn_w.numel() * 4
              + (B * HW * Cin * elem if need_feat else 0) + G * HW * C * elem
              + loc.numel() * 4 + attn_w.numel() * 4)
    flops = 2 * n_corners * (Cin + C + (Cin if need_feat else 0) + C)
    return _bound(nbytes, flops)
