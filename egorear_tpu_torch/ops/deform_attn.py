"""Lazy deformable sampling: raw memory (plus an optional per-group position
table and an implicit ones channel) sampled at deformable locations.

Counterpart of ``lazy_deform_sample`` in the JAX package's
``ops/deform_attn.py``. Semantics (``grid_sample(align_corners=False,
padding_mode='zeros')``): for each (batch b, query q, head n) row,

    x = loc_x * W - 0.5,  y = loc_y * H - 0.5
    s[b, q, n] = sum_p attn_w[b, q, n, p] * bilinear(buf[b], y, x)

with corners outside the grid contributing zero, where ``buf`` is
``[feat | pos | 1]``. The ones-sample ``s_one`` is the border-clipped
bilinear mass that rescales additive constants (see
``models.layers.MSDeformAttnLazy``).

Two versions of one contract:
  * :func:`lazy_deform_sample_plain` -- PyTorch (``F.grid_sample``). Used for
    CPU tensors and as the kernel's oracle.
  * the CUDA kernel ``csrc/lazy_deform_sample.cu``, which :func:`lazy_deform_sample`
    launches for CUDA tensors. There is no fallback: a CUDA tensor the kernel
    does not take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from egorear_tpu_torch import kernels

Samples = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _grid_side(HW: int) -> int:
    side = math.isqrt(HW)
    if side * side != HW:
        raise ValueError(f"lazy_deform_sample needs a square grid, got HW={HW}")
    return side


def _pos_groups(pos: torch.Tensor, B: int) -> torch.Tensor:
    """(HW, C) or (G, HW, C) -> (G, HW, C), checking that G divides B."""
    pos3 = pos[None] if pos.dim() == 2 else pos
    if pos3.dim() != 3 or B % pos3.shape[0]:
        raise ValueError(f"pos must be (HW, C) or (G, HW, C) with B % G == 0; "
                         f"got {tuple(pos.shape)} for B={B}")
    return pos3


def lazy_deform_sample_plain(feat, loc, attn_w, pos=None,
                             pos_block: bool = False) -> Samples:
    """Plain PyTorch version: ``F.grid_sample`` over ``[feat | pos | ones]``.

    feat (B, HW, Cin); loc (B, Q, nh, P, 2) in [0, 1], (x, y); attn_w
    (B, Q, nh, P); pos None, (HW, C) or (G, HW, C) with the G tables laid out
    along the batch INTERLEAVED (b -> b % G, batch-major fold) or, with
    ``pos_block``, in contiguous BLOCKS (b -> b // (B/G), view-major fold).
    Computes in fp32 and returns ``(s_feat, s_pos | None, s_one)`` in
    ``feat.dtype``, each (B, Q, nh, channels).
    """
    B, HW, Cin = feat.shape
    Q, nh, P = attn_w.shape[1:]
    side = _grid_side(HW)
    parts = [feat.float()]
    if pos is not None:
        pos3 = _pos_groups(pos, B).float()
        G = pos3.shape[0]
        if pos_block:
            parts.append(pos3.repeat_interleave(B // G, dim=0))
        else:
            parts.append(pos3.repeat(B // G, 1, 1))
    parts.append(feat.new_ones(B, HW, 1, dtype=torch.float32))
    buf = torch.cat(parts, dim=-1).reshape(B, side, side, -1).permute(0, 3, 1, 2)
    grid = (2.0 * loc.float() - 1.0).reshape(B, Q * nh, P, 2)
    s = F.grid_sample(buf, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)  # (B, Cin + C + 1, Q*nh, P)
    s = (s * attn_w.float().reshape(B, 1, Q * nh, P)).sum(-1)
    s = s.permute(0, 2, 1).reshape(B, Q, nh, -1).to(feat.dtype)
    s_pos = s[..., Cin:-1] if pos is not None else None
    return s[..., :Cin], s_pos, s[..., -1:]


def _check_cuda_inputs(feat, loc, attn_w, pos):
    if feat.dtype not in _DTYPE_CODES:
        raise TypeError(f"lazy_deform_sample kernel takes float32 or bfloat16 "
                        f"feat, got {feat.dtype}")
    if feat.dim() != 3 or loc.dim() != 5 or attn_w.dim() != 4:
        raise ValueError("expected feat (B, HW, Cin), loc (B, Q, nh, P, 2), "
                         "attn_w (B, Q, nh, P)")
    B = feat.shape[0]
    if loc.shape[:4] != attn_w.shape or loc.shape[0] != B or loc.shape[-1] != 2:
        raise ValueError(f"loc {tuple(loc.shape)} and attn_w "
                         f"{tuple(attn_w.shape)} do not match feat "
                         f"{tuple(feat.shape)}")
    tensors = [feat, loc, attn_w] + ([pos] if pos is not None else [])
    for t in tensors:
        if t.device != feat.device:
            raise ValueError("lazy_deform_sample inputs must share one device")
    for name, t in (("feat", feat), ("pos", pos)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"lazy_deform_sample kernel needs a contiguous {name}")
        if t.shape[-1] % 4 or t.data_ptr() % 16:
            raise ValueError(f"lazy_deform_sample kernel needs {name} channels "
                             f"in multiples of 4 and a 16-byte aligned base")
        if t.dtype != feat.dtype:
            raise TypeError("pos must have feat's dtype")
    if pos is not None and pos.shape[-2] != feat.shape[1]:
        raise ValueError(f"pos {tuple(pos.shape)} is not on feat's grid of "
                         f"{feat.shape[1]} cells")
    nh, P = attn_w.shape[2:]
    if nh * P * 4 * 8 > 48 * 1024:
        raise ValueError(f"nh * P = {nh * P} corners exceed the kernel's "
                         f"shared memory")


def lazy_deform_sample(feat, loc, attn_w, pos=None,
                       pos_block: bool = False) -> Samples:
    """Lazy deformable sampling; see :func:`lazy_deform_sample_plain` for the
    contract.

    On CPU tensors this is the plain version. On CUDA tensors it launches the
    hand-written kernel (``csrc/lazy_deform_sample.cu``) or raises; ``loc``
    and ``attn_w`` are cast to fp32 first, as in the JAX package, so bf16
    sampling positions are not rounded again. Each launch adds one to
    ``lazy_deform_sample.launches``.
    """
    if feat.device.type == "cpu":
        return lazy_deform_sample_plain(feat, loc, attn_w, pos, pos_block)
    if feat.device.type != "cuda":
        raise ValueError(f"lazy_deform_sample runs on cpu or cuda tensors, "
                         f"got {feat.device}")
    _check_cuda_inputs(feat, loc, attn_w, pos)
    B, HW, Cin = feat.shape
    Q, nh, P = attn_w.shape[1:]
    side = _grid_side(HW)
    loc = loc.to(torch.float32).contiguous()
    attn_w = attn_w.to(torch.float32).contiguous()
    pos3 = _pos_groups(pos, B) if pos is not None else None
    G, C = (pos3.shape[0], pos3.shape[2]) if pos3 is not None else (1, 0)

    s_feat = torch.empty(B, Q, nh, Cin, device=feat.device, dtype=feat.dtype)
    s_pos = (torch.empty(B, Q, nh, C, device=feat.device, dtype=feat.dtype)
             if pos3 is not None else None)
    s_one = torch.empty(B, Q, nh, 1, device=feat.device, dtype=feat.dtype)

    lib = kernels.load("lazy_deform_sample")
    fn = lib.egorear_lazy_deform_sample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(ptr(feat), ptr(pos3), ptr(loc), ptr(attn_w), ptr(s_feat),
                ptr(s_pos), ptr(s_one), B, side, side, Cin, C, G,
                int(bool(pos_block)), Q, nh, P, _DTYPE_CODES[feat.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"lazy_deform_sample kernel launch failed: CUDA "
                           f"error {rc}")
    lazy_deform_sample.launches += 1
    return s_feat, s_pos, s_one


lazy_deform_sample.launches = 0
