"""Deformable sampling, the two ops of the JAX package's ``ops/deform_attn.py``.

* Per-head sampling of a value map, :func:`deformable_sampling` (the mmcv
  MSDA contract; the reference computation order, ``lazy_deform: false``),
  and its head-shared form :func:`deformable_sampling_shared`: see the
  section "Per-head deformable sampling" below.
* Lazy deformable sampling, :func:`lazy_deform_sample`: raw memory (plus an
  optional per-group position table and an implicit ones channel) sampled
  at deformable locations (the flagship order, ``lazy_deform: true``).

Lazy deformable sampling is the counterpart of ``lazy_deform_sample`` in
the JAX package. Semantics (``grid_sample(align_corners=False,
padding_mode='zeros')``): for each (batch b, query q, head n) row,

    x = loc_x * W - 0.5,  y = loc_y * H - 0.5
    s[b, q, n] = sum_p attn_w[b, q, n, p] * bilinear(buf[b], y, x)

with corners outside the grid contributing zero, where ``buf`` is
``[feat | pos | 1]``. The ones-sample ``s_one`` is the border-clipped
bilinear mass that rescales additive constants (see
``models.layers.MSDeformAttnLazy``).

Two versions of one contract, forward and backward:
  * :func:`lazy_deform_sample_plain` and
    :func:`lazy_deform_sample_backward_plain` -- PyTorch. Used for CPU
    tensors and as the kernels' oracles.
  * the CUDA kernels ``csrc/lazy_deform_sample.cu`` and
    ``csrc/lazy_deform_sample_bwd.cu``, which :class:`LazyDeformSample`
    launches for CUDA tensors. There is no fallback: a CUDA tensor the
    kernels do not take raises.

:func:`lazy_deform_sample` is differentiable on every device: it goes
through :class:`LazyDeformSample`, whose backward is the analytic VJP of the
JAX package's ``_lazy_bwd_rule`` (border masks piecewise constant).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from egorear_tpu_torch import kernels
from egorear_tpu_torch.utils import trace

Samples = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]
Grads = Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_OPTIN_LIMIT = 232448  # an H100 block's dynamic shared memory after opt-in
_BWD_TILE_BYTES = 64 * 1024  # the lazy backward's d_feat band tile, at most
# (b, q, head) rows a block of either forward kernel (lazy and per-head)
# serves, one warp each: 960 blocks of 128 threads for the MVFex call at
# batch 16, all resident at once.
_FWD_ROWS_PER_BLOCK = 4


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


def _group_of(B: int, G: int, pos_block: bool, device) -> torch.Tensor:
    """(B,) pos table index of each batch element."""
    b = torch.arange(B, device=device)
    return b // (B // G) if pos_block else b % G


def _corner_terms(loc, H: int, W: int):
    """The 4 bilinear corners of every sampling point, in the order (y0, x0),
    (y0, x1), (y1, x0), (y1, x1), each (..., 4): the flat cell index (clamped
    into the grid), the weight ``w_c = wy_c * wx_c`` and its x and y factors
    for the location gradient, ``wy_c * dwx_c`` and ``dwy_c * wx_c``, with
    ``dwx_c, dwy_c = -1 | +1``. Out-of-grid corners have zero weight and
    zero derivatives (border masks are piecewise constant; ``floor`` has no
    gradient)."""
    x = loc[..., 0].float() * W - 0.5
    y = loc[..., 1].float() * H - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    cy = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=-1)
    cx = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=-1)
    ok = ((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)).float()
    wy = torch.stack([1 - ly, 1 - ly, ly, ly], dim=-1) * ok
    wx = torch.stack([1 - lx, lx, 1 - lx, lx], dim=-1) * ok
    sign = torch.tensor([-1.0, 1.0], device=loc.device)
    dwy = sign.repeat_interleave(2) * ok  # (-1, -1, +1, +1)
    dwx = sign.repeat(2) * ok  # (-1, +1, -1, +1)
    cell = (cy * W + cx).clamp(0, H * W - 1)
    return cell, wy * wx, wy * dwx, dwy * wx


def _loc_weight_grads(aw, wb, gx, gy, A, H: int, W: int):
    """``(d_attn_w, d_loc)`` from the corner adjoints ``A`` (..., 4)."""
    d_w = (wb * A).sum(-1)
    d_x = aw * W * (gx * A).sum(-1)
    d_y = aw * H * (gy * A).sum(-1)
    return d_w, torch.stack([d_x, d_y], dim=-1)


def lazy_deform_sample_backward_plain(feat, loc, attn_w, pos, pos_block,
                                      g_feat, g_pos, g_one,
                                      need_feat: bool = True,
                                      need_pos: bool = True) -> Grads:
    """Plain PyTorch VJP of :func:`lazy_deform_sample_plain` (the JAX
    package's ``_lazy_bwd_rule``), written with gathers and ``index_add_``.

    With the corners c of each point (b, q, n, p), their bilinear weights
    ``w_c = wy_c * wx_c`` (zero out of the grid), ``a = attn_w`` and the
    adjoint ``A_c = feat[c] . g_feat + pos[c] . g_pos + g_one``:

        d_feat[b, c] += a * w_c * g_feat[b, q, n]
        d_pos[g(b), c] += a * w_c * g_pos[b, q, n]   (summed over the group)
        d_attn_w = sum_c w_c * A_c
        d_loc = (a * W * sum_c wy_c * dwx_c * A_c, a * H * sum_c dwy_c * wx_c * A_c)

    with ``dwx_c, dwy_c = -1 | +1`` the derivatives of the corner factors.
    All in fp32; ``d_feat`` returns in ``feat.dtype``, ``d_pos`` in
    ``pos.dtype`` and ``pos``'s shape, ``d_loc`` and ``d_attn_w`` in fp32.
    ``d_feat`` is None unless ``need_feat``, ``d_pos`` None unless ``pos``
    is given and ``need_pos``.
    """
    B, HW, Cin = feat.shape
    H = W = _grid_side(HW)
    dev = feat.device
    aw = attn_w.float()
    cell, wb, gx, gy = _corner_terms(loc, H, W)

    def gathered_dot(table, rows, g):
        # table (R, X) fp32; rows (B, Q, nh, P, 4); g (B, Q, nh, X).
        return (table[rows] * g[:, :, :, None, None, :]).sum(-1)

    gf = g_feat.float()
    feat_rows = torch.arange(B, device=dev).view(B, 1, 1, 1, 1) * HW + cell
    A = gathered_dot(feat.float().reshape(B * HW, Cin), feat_rows, gf)
    pos_rows = gp = None
    if pos is not None:
        pos3 = _pos_groups(pos, B)
        G, C = pos3.shape[0], pos3.shape[2]
        grp = _group_of(B, G, pos_block, dev).view(B, 1, 1, 1, 1)
        pos_rows = grp * HW + cell
        gp = g_pos.float()
        A = A + gathered_dot(pos3.float().reshape(G * HW, C), pos_rows, gp)
    A = A + g_one.float()[..., None]  # (B, Q, nh, 1, 1): the ones channel

    d_w, d_loc = _loc_weight_grads(aw, wb, gx, gy, A, H, W)
    sw = aw[..., None] * wb  # scatter weight of each corner

    def scatter(n_rows, rows, g):
        X = g.shape[-1]
        src = (sw[..., None] * g[:, :, :, None, None, :]).reshape(-1, X)
        out = torch.zeros(n_rows, X, device=dev, dtype=torch.float32)
        return out.index_add_(0, rows.reshape(-1), src)

    d_feat = d_pos = None
    if need_feat:
        d_feat = scatter(B * HW, feat_rows, gf).reshape(B, HW, Cin).to(feat.dtype)
    if pos is not None and need_pos:
        d_pos = scatter(G * HW, pos_rows, gp).reshape(pos.shape).to(pos.dtype)
    return d_feat, d_loc, d_w, d_pos


# -- CUDA kernels -------------------------------------------------------------


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
    P = attn_w.shape[3]
    if _fwd_smem_bytes(P) > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"P = {P} points need {_fwd_smem_bytes(P)} bytes of "
                         f"the forward kernel's shared memory; a block takes "
                         f"at most {_SMEM_OPTIN_LIMIT}")


def _fwd_smem_bytes(P: int) -> int:
    """Shared memory of a forward block of ``csrc/lazy_deform_sample.cu``,
    which the wrapper passes to the kernel: for each of its
    ``_FWD_ROWS_PER_BLOCK`` warps (one (b, q, head) row each) a list of up
    to 4 * P in-grid corners, 8 bytes a record (cell index, fp32 weight)."""
    return _FWD_ROWS_PER_BLOCK * 4 * P * 8


def _bwd_smem_bytes(HW: int, Q: int, nh: int, P: int, Cin: int, C: int,
                    need_feat: bool, elem: int) -> Tuple[int, int]:
    """Shared memory of the two backward kernels, as
    ``csrc/lazy_deform_sample_bwd.cu`` sizes it (``adjoint_smem``,
    ``dfeat_smem``), for ``elem``-byte features; the second is 0 when
    ``d_feat`` is not wanted.

    Adjoint kernel: the fp32 upstream-gradient rows of every head, 4 corner
    records of 16 bytes and one weight per point. ``d_feat`` kernel: an
    fp32 tile of a band of cells (at most 64 KB, one cell at least), a list
    entry of 8 bytes for each corner of the batch element, its ``g_feat``
    rows as stored, and the counting sort's offsets (8 bands by 16 warps, 9
    band starts).
    """
    NP = nh * P
    adjoint = 4 * nh * (Cin + C) + NP * (4 * 16 + 4)
    if not need_feat:
        return adjoint, 0
    band = min(HW, max(1, _BWD_TILE_BYTES // (4 * Cin)))
    return adjoint, (4 * band * Cin + 32 * Q * NP + elem * Q * nh * Cin
                     + 4 * (8 * 16 + 8 + 1))


def _check_backward_inputs(feat, loc, attn_w, pos, g_feat, g_pos, g_one,
                           need_feat: bool = True):
    _check_cuda_inputs(feat, loc, attn_w, pos)
    B, HW, Cin = feat.shape
    Q, nh, P = attn_w.shape[1:]
    C = pos.shape[-1] if pos is not None else 0
    want = {"g_feat": (g_feat, (B, Q, nh, Cin)), "g_one": (g_one, (B, Q, nh, 1))}
    if pos is not None:
        want["g_pos"] = (g_pos, (B, Q, nh, C))
    elif g_pos is not None:
        raise ValueError("g_pos given without pos")
    for name, (g, shape) in want.items():
        if g is None or tuple(g.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{None if g is None else tuple(g.shape)}")
        if g.dtype != feat.dtype:
            raise TypeError(f"{name} must have feat's dtype {feat.dtype}, "
                            f"got {g.dtype}")
        if g.device != feat.device:
            raise ValueError("lazy_deform_sample gradients must be on feat's device")
        if name != "g_one" and (not g.is_contiguous() or g.data_ptr() % 16):
            raise ValueError(f"the backward kernel needs a contiguous {name} "
                             f"with a 16-byte aligned base")
    adjoint, dfeat = _bwd_smem_bytes(HW, Q, nh, P, Cin, C, need_feat,
                                     feat.element_size())
    if need_feat and (HW > 1 << 16 or Q * nh >= 1 << 15):
        raise ValueError(f"the d_feat kernel packs a cell below 2^16 and a "
                         f"query row below 2^15 into one key; got HW={HW}, "
                         f"Q*nh={Q * nh}")
    if max(adjoint, dfeat) > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"Q={Q}, nh={nh}, P={P}, {Cin}+{C} channels need "
                         f"{adjoint} and {dfeat} bytes of shared memory; the "
                         f"backward kernels take at most {_SMEM_OPTIN_LIMIT}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` contiguous with a 16-byte aligned base, copied if need be: an
    upstream gradient or ``loc`` may be a view into a larger buffer, and the
    kernels read gradient rows 16 bytes and ``loc`` points 8 bytes at a
    time."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_kernel(feat, loc, attn_w, pos, pos_block: bool) -> Samples:
    """Launch ``csrc/lazy_deform_sample.cu`` on CUDA tensors."""
    _check_cuda_inputs(feat, loc, attn_w, pos)
    B, HW, Cin = feat.shape
    Q, nh, P = attn_w.shape[1:]
    side = _grid_side(HW)
    loc = _aligned16(loc.to(torch.float32))  # read as float2
    attn_w = attn_w.to(torch.float32).contiguous()
    pos3 = _pos_groups(pos, B) if pos is not None else None
    G, C = (pos3.shape[0], pos3.shape[2]) if pos3 is not None else (1, 0)

    s_feat = torch.empty(B, Q, nh, Cin, device=feat.device, dtype=feat.dtype)
    s_pos = (torch.empty(B, Q, nh, C, device=feat.device, dtype=feat.dtype)
             if pos3 is not None else None)
    s_one = torch.empty(B, Q, nh, 1, device=feat.device, dtype=feat.dtype)

    fn = kernels.load("lazy_deform_sample").egorear_lazy_deform_sample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = fn(_ptr(feat), _ptr(pos3), _ptr(loc), _ptr(attn_w), _ptr(s_feat),
                _ptr(s_pos), _ptr(s_one), B, side, side, Cin, C, G,
                int(bool(pos_block)), Q, nh, P, _DTYPE_CODES[feat.dtype],
                _FWD_ROWS_PER_BLOCK, _fwd_smem_bytes(P), stream)
    if rc != 0:
        raise RuntimeError(f"lazy_deform_sample kernel launch failed: CUDA "
                           f"error {rc}")
    lazy_deform_sample.launches += 1
    return s_feat, s_pos, s_one


def _backward_kernel(feat, loc, attn_w, pos, pos_block, g_feat, g_pos, g_one,
                     need_feat: bool, need_pos: bool) -> Grads:
    """Launch ``csrc/lazy_deform_sample_bwd.cu`` on CUDA tensors."""
    loc = loc.to(torch.float32).contiguous()
    attn_w = attn_w.to(torch.float32).contiguous()
    g_feat, g_pos = _aligned16(g_feat), _aligned16(g_pos)
    g_one = g_one.contiguous()
    _check_backward_inputs(feat, loc, attn_w, pos, g_feat, g_pos, g_one,
                           need_feat)
    B, HW, Cin = feat.shape
    Q, nh, P = attn_w.shape[1:]
    side = _grid_side(HW)
    pos3 = _pos_groups(pos, B) if pos is not None else None
    G, C = (pos3.shape[0], pos3.shape[2]) if pos3 is not None else (1, 0)
    dev, f32 = feat.device, torch.float32

    # d_feat is written in full by the kernel that owns each band of cells;
    # d_pos is an fp32 table the atomics add into, zeroed, cast at the end.
    d_feat = torch.empty_like(feat) if need_feat else None
    d_pos = (torch.zeros(G, HW, C, device=dev, dtype=f32)
             if pos3 is not None and need_pos else None)
    d_loc = torch.empty(B, Q, nh, P, 2, device=dev, dtype=f32)
    d_w = torch.empty(B, Q, nh, P, device=dev, dtype=f32)

    fn = kernels.load("lazy_deform_sample_bwd").egorear_lazy_deform_sample_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_ptr(feat), _ptr(pos3), _ptr(loc), _ptr(attn_w), _ptr(g_feat),
                _ptr(g_pos), _ptr(g_one), _ptr(d_feat), _ptr(d_pos),
                _ptr(d_loc), _ptr(d_w), B, side, side, Cin, C, G,
                int(bool(pos_block)), Q, nh, P, _DTYPE_CODES[feat.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"lazy_deform_sample backward kernel launch failed: "
                           f"CUDA error {rc}")
    lazy_deform_sample_backward.launches += 1
    if d_pos is not None:
        d_pos = d_pos.reshape(pos.shape).to(pos.dtype)
    return d_feat, d_loc, d_w, d_pos


def _check_device(x, op: str = "lazy_deform_sample"):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cpu or cuda tensors, got {x.device}")


def lazy_deform_sample_backward(feat, loc, attn_w, pos, pos_block, g_feat,
                                g_pos, g_one, need_feat: bool = True,
                                need_pos: bool = True) -> Grads:
    """VJP of :func:`lazy_deform_sample`; see
    :func:`lazy_deform_sample_backward_plain` for the contract.

    On CPU tensors this is the plain version. On CUDA tensors it launches the
    hand-written kernel (``csrc/lazy_deform_sample_bwd.cu``) or raises. Each
    launch adds one to ``lazy_deform_sample_backward.launches``.
    """
    _check_device(feat)
    fn = (_backward_kernel if feat.device.type == "cuda"
          else lazy_deform_sample_backward_plain)
    return fn(feat, loc, attn_w, pos, pos_block, g_feat, g_pos, g_one,
              need_feat, need_pos)


lazy_deform_sample_backward.launches = 0


class LazyDeformSample(torch.autograd.Function):
    """Autograd node of lazy deformable sampling.

    ``forward(feat, loc, attn_w, pos, pos_block, plain)``: with ``plain`` or
    on CPU tensors the plain versions run forward and backward; on CUDA
    tensors otherwise the two kernels. ``loc`` and ``attn_w`` arrive in
    fp32 (the caller casts them inside the graph, so autograd casts their
    gradients back). Gradients are computed only for the inputs that need
    them: the MVFex refiners sample detached features, and their backward
    then computes no ``d_feat``.
    """

    @staticmethod
    def forward(ctx, feat, loc, attn_w, pos, pos_block, plain):
        use_kernel = feat.device.type == "cuda" and not plain
        fn = _forward_kernel if use_kernel else lazy_deform_sample_plain
        out = fn(feat, loc, attn_w, pos, pos_block)
        ctx.save_for_backward(feat, loc, attn_w, pos)
        ctx.pos_block, ctx.use_kernel = pos_block, use_kernel
        return out

    @staticmethod
    def backward(ctx, g_feat, g_pos, g_one):
        feat, loc, attn_w, pos = ctx.saved_tensors
        need_feat, need_loc, need_w, need_pos = ctx.needs_input_grad[:4]
        fn = _backward_kernel if ctx.use_kernel else lazy_deform_sample_backward_plain
        d_feat, d_loc, d_w, d_pos = fn(feat, loc, attn_w, pos, ctx.pos_block,
                                       g_feat, g_pos, g_one, need_feat,
                                       need_pos)
        return (d_feat, d_loc if need_loc else None, d_w if need_w else None,
                d_pos, None, None)


def lazy_deform_sample(feat, loc, attn_w, pos=None, pos_block: bool = False,
                       plain: bool = False) -> Samples:
    """Lazy deformable sampling; see :func:`lazy_deform_sample_plain` for the
    contract. Differentiable in ``feat``, ``loc``, ``attn_w`` and ``pos``.

    On CPU tensors (or with ``plain``) this runs the plain versions forward
    and backward. On CUDA tensors it launches the hand-written kernels
    (``csrc/lazy_deform_sample.cu`` forward, ``csrc/lazy_deform_sample_bwd.cu``
    backward) or raises. ``loc`` and ``attn_w`` are cast to fp32 first, as
    in the JAX package, so bf16 sampling positions are not rounded again.
    Each forward launch adds one to ``lazy_deform_sample.launches``. The
    call is the program's ``sample`` span, with ``feat``'s and ``loc``'s
    shapes.
    """
    _check_device(feat)
    with trace.span("sample", feat=feat, loc=loc):
        return LazyDeformSample.apply(feat, loc.to(torch.float32),
                                      attn_w.to(torch.float32), pos, pos_block,
                                      plain)


lazy_deform_sample.launches = 0


# -- Per-head deformable sampling (the reference computation order) ---------------
#
# Counterpart of ``deformable_sampling`` in the JAX package (its ``gather``,
# ``onehot`` and ``pallas`` implementations; the Pallas kernel is
# ``_make_deform_kernel``). For each (batch b, query q, head h),
#
#     out[b, q, h*ch:(h+1)*ch] = sum_p attn_w[b, q, h, p] * bilinear(value[b, :, :, h], loc[b, q, h, p])
#
# with the pixel mapping and border rule of lazy deformable sampling above.
# Two versions of one contract, forward and backward:
#   * :func:`deformable_sampling_plain` and
#     :func:`deformable_sampling_backward_plain` -- PyTorch, for CPU tensors
#     and as the kernels' oracles;
#   * ``csrc/deform_sample.cu`` and ``csrc/deform_sample_bwd.cu``, which
#     :class:`DeformableSampling` launches for CUDA tensors, or raises.

def deformable_sampling_plain(value, loc, attn_w) -> torch.Tensor:
    """Plain PyTorch version: ``F.grid_sample`` per head.

    value (B, H, W, nh, ch); loc (B, Q, nh, P, 2) in [0, 1], (x, y); attn_w
    (B, Q, nh, P). Computes in fp32 and returns (B, Q, nh*ch) in
    ``value.dtype`` (the contract of the JAX package's ``_sample_gather``).
    """
    B, H, W, nh, ch = value.shape
    Q, P = attn_w.shape[1], attn_w.shape[3]
    v = value.float().permute(0, 3, 4, 1, 2).reshape(B * nh, ch, H, W)
    grid = (2.0 * loc.float() - 1.0).transpose(1, 2).reshape(B * nh, Q, P, 2)
    s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)  # (B*nh, ch, Q, P)
    aw = attn_w.float().transpose(1, 2).reshape(B * nh, 1, Q, P)
    s = (s * aw).sum(-1).reshape(B, nh, ch, Q)
    return s.permute(0, 3, 1, 2).reshape(B, Q, nh * ch).to(value.dtype)


def deformable_sampling_backward_plain(value, loc, attn_w, g,
                                       need_value: bool = True):
    """Plain PyTorch VJP of :func:`deformable_sampling_plain`: the analytic
    VJP of the JAX package's ``_sample_onehot`` (which ``_pallas_bwd_rule``
    differentiates), written with gathers and ``index_add_``.

    With the corners c of each point (b, q, h, p), their bilinear weights
    ``w_c = wy_c * wx_c`` (zero out of the grid; border masks are piecewise
    constant and ``floor`` has no gradient), ``a = attn_w`` and the adjoint
    ``A_c = value[b, c, h] . g[b, q, h]``:

        d_value[b, c, h] += a * w_c * g[b, q, h]
        d_attn_w = sum_c w_c * A_c
        d_loc = (a * W * sum_c wy_c * dwx_c * A_c, a * H * sum_c dwy_c * wx_c * A_c)

    g is (B, Q, nh*ch). All in fp32; returns ``(d_value | None, d_loc,
    d_attn_w)`` with ``d_value`` in ``value.dtype`` (None unless
    ``need_value``), ``d_loc`` and ``d_attn_w`` in fp32.
    """
    B, H, W, nh, ch = value.shape
    Q = attn_w.shape[1]
    dev = value.device
    aw = attn_w.float()
    cell, wb, gx, gy = _corner_terms(loc, H, W)  # (B, Q, nh, P, 4)
    # Row of (b, cell, h) in value viewed as (B*H*W*nh, ch).
    rows = ((torch.arange(B, device=dev).view(B, 1, 1, 1, 1) * (H * W) + cell) * nh
            + torch.arange(nh, device=dev).view(1, 1, nh, 1, 1))
    gh = g.float().reshape(B, Q, nh, 1, 1, ch)
    A = (value.float().reshape(-1, ch)[rows] * gh).sum(-1)  # (B, Q, nh, P, 4)

    d_w, d_loc = _loc_weight_grads(aw, wb, gx, gy, A, H, W)
    d_value = None
    if need_value:
        src = ((aw[..., None] * wb)[..., None] * gh).reshape(-1, ch)
        d_value = torch.zeros(B * H * W * nh, ch, device=dev, dtype=torch.float32)
        d_value.index_add_(0, rows.reshape(-1), src)
        d_value = d_value.reshape(value.shape).to(value.dtype)
    return d_value, d_loc, d_w


def _check_sampling_inputs(value, loc, attn_w):
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"deformable_sampling kernel takes float32 or bfloat16 "
                        f"value, got {value.dtype}")
    if value.dim() != 5 or loc.dim() != 5 or attn_w.dim() != 4:
        raise ValueError("expected value (B, H, W, nh, ch), loc (B, Q, nh, P, 2), "
                         "attn_w (B, Q, nh, P)")
    B, _, _, nh, _ = value.shape
    if (loc.shape[:4] != attn_w.shape or loc.shape[-1] != 2
            or attn_w.shape[0] != B or attn_w.shape[2] != nh):
        raise ValueError(f"loc {tuple(loc.shape)} and attn_w "
                         f"{tuple(attn_w.shape)} do not match value "
                         f"{tuple(value.shape)}")
    for t in (loc, attn_w):
        if t.device != value.device:
            raise ValueError("deformable_sampling inputs must share one device")
    if not value.is_contiguous():
        raise ValueError("deformable_sampling kernel needs a contiguous value")
    P = attn_w.shape[3]
    if _sampling_fwd_smem_bytes(P) > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"P = {P} points need {_sampling_fwd_smem_bytes(P)} "
                         f"bytes of the forward kernel's shared memory; a "
                         f"block takes at most {_SMEM_OPTIN_LIMIT}")


def _sampling_fwd_smem_bytes(P: int) -> int:
    """Shared memory of a block of ``csrc/deform_sample.cu``, which the
    wrapper passes to the kernel: for each of its ``_FWD_ROWS_PER_BLOCK``
    warps (one (b, q, head) row each) a list of up to 4 * P in-grid corners,
    8 bytes a record (cell index, fp32 weight)."""
    return _FWD_ROWS_PER_BLOCK * 4 * P * 8


# The per-head backward's d_value kernel (csrc/deform_sample_bwd.cu): a
# block owns as many cells as fill this many times 64 KB in fp32; its tile
# holds at most this many bytes of fp32 slices; its block scan takes this
# many ints (16 warp totals and their sum, rounded up to 4).
_SAMPLING_BWD_SPAN_ROWS = 4
_SAMPLING_BWD_TILE_BYTES = 32 * 1024
_SAMPLING_BWD_SCAN_INTS = 20


def _sampling_bwd_layout(HW: int, Q: int, nh: int, ch: int, P: int,
                         elem: int) -> Tuple[int, int, int]:
    """``(span, cap, bytes)`` of the d_value kernel of
    ``csrc/deform_sample_bwd.cu``, which the wrapper passes to it: the
    cells a block owns (4 times the cells whose fp32 rows fill 64 KB, one
    at least, at most the grid), the (cell, head) slices its fp32 tile
    holds at a time (a multiple of 16, the kernel's warps), and the block's
    shared memory, in the kernel's order: the tile (cap, ch), a list key
    and a scale of 4 bytes each for every corner of a batch element
    (4 * Q * nh * P), the block scan, a bit for each slice of the span and
    a rank for each word of bits (each in 16-byte runs), the slice of each
    rank (one for each corner at most, or for each slice), and the
    element's upstream-gradient rows (Q, nh * ch) as stored (``elem`` bytes
    a value). Its other kernel, for ``d_loc`` and ``d_attn_w``, takes none.
    Within the opt-in limit a batch element has fewer than 7,300 points, so
    a list key's g row (q * nh + h) fits its 14 bits and a slice its 18."""
    rowlen = nh * ch
    span = min(HW, _SAMPLING_BWD_SPAN_ROWS * max(1, 16 * 1024 // rowlen))
    cap = max(16, _SAMPLING_BWD_TILE_BYTES // (4 * ch) // 16 * 16)
    corners = 4 * Q * nh * P
    words = 16 * -(-span * nh // 128)
    ranks = 4 * -(-min(corners, span * nh) // 4)
    return span, cap, (4 * cap * ch + 8 * corners + 4 * _SAMPLING_BWD_SCAN_INTS
                       + 2 * words + 4 * ranks + elem * Q * rowlen)


def _check_sampling_backward_inputs(value, loc, attn_w, g, need_value: bool = True):
    _check_sampling_inputs(value, loc, attn_w)
    B, H, W, nh, ch = value.shape
    Q, P = attn_w.shape[1], attn_w.shape[3]
    if g is None or tuple(g.shape) != (B, Q, nh * ch):
        raise ValueError(f"g must be {(B, Q, nh * ch)}, got "
                         f"{None if g is None else tuple(g.shape)}")
    if g.dtype != value.dtype:
        raise TypeError(f"g must have value's dtype {value.dtype}, got {g.dtype}")
    if g.device != value.device:
        raise ValueError("deformable_sampling gradients must be on value's device")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("the backward kernel needs a contiguous g with a "
                         "16-byte aligned base")
    if not need_value:
        return
    smem = _sampling_bwd_layout(H * W, Q, nh, ch, P, value.element_size())[2]
    if smem > _SMEM_OPTIN_LIMIT:
        raise ValueError(f"Q={Q}, nh={nh}, ch={ch}, P={P} need {smem} bytes of "
                         f"the d_value kernel's shared memory; a block takes "
                         f"at most {_SMEM_OPTIN_LIMIT}")


def _vector_width(value) -> int:
    """Channels a load of the forward kernel, so that every head slice
    starts on a load boundary: 16 bytes (4 fp32, 8 bf16) where ch and
    value's base allow, else 8 bytes (4 bf16), else 1 (its scalar path)."""
    ch, es, base = value.shape[-1], value.element_size(), value.data_ptr()
    for nbytes in (16, 8) if es == 2 else (16,):
        if (ch * es) % nbytes == 0 and base % nbytes == 0:
            return nbytes // es
    return 1


def _sampling_kernel(value, loc, attn_w) -> torch.Tensor:
    """Launch ``csrc/deform_sample.cu`` on CUDA tensors."""
    _check_sampling_inputs(value, loc, attn_w)
    B, H, W, nh, ch = value.shape
    Q, P = attn_w.shape[1], attn_w.shape[3]
    loc = _aligned16(loc.to(torch.float32))  # read as float2
    attn_w = attn_w.to(torch.float32).contiguous()
    out = torch.empty(B, Q, nh * ch, device=value.device, dtype=value.dtype)

    fn = kernels.load("deform_sample").egorear_deform_sample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = fn(_ptr(value), _ptr(loc), _ptr(attn_w), _ptr(out), B, H, W, Q, nh,
                ch, P, _vector_width(value), _DTYPE_CODES[value.dtype],
                _FWD_ROWS_PER_BLOCK, _sampling_fwd_smem_bytes(P), stream)
    if rc != 0:
        raise RuntimeError(f"deformable_sampling kernel launch failed: CUDA "
                           f"error {rc}")
    deformable_sampling.launches += 1
    return out


def _sampling_backward_kernel(value, loc, attn_w, g, need_value: bool):
    """Launch ``csrc/deform_sample_bwd.cu`` on CUDA tensors."""
    loc = loc.to(torch.float32).contiguous()
    attn_w = attn_w.to(torch.float32).contiguous()
    g = _aligned16(g)
    _check_sampling_backward_inputs(value, loc, attn_w, g, need_value)
    B, H, W, nh, ch = value.shape
    Q, P = attn_w.shape[1], attn_w.shape[3]
    dev, f32 = value.device, torch.float32
    span, cap, smem = _sampling_bwd_layout(H * W, Q, nh, ch, P,
                                           value.element_size())
    # d_value is written in full, in value's dtype, by the blocks that own
    # its cells.
    d_value = torch.empty_like(value) if need_value else None
    d_loc = torch.empty(B, Q, nh, P, 2, device=dev, dtype=f32)
    d_w = torch.empty(B, Q, nh, P, device=dev, dtype=f32)

    fn = kernels.load("deform_sample_bwd").egorear_deform_sample_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_ptr(value), _ptr(loc), _ptr(attn_w), _ptr(g), _ptr(d_value),
                _ptr(d_loc), _ptr(d_w), B, H, W, Q, nh, ch, P, span, cap,
                smem, _DTYPE_CODES[value.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"deformable_sampling backward kernel launch failed: "
                           f"CUDA error {rc}")
    deformable_sampling_backward.launches += 1
    return d_value, d_loc, d_w


def deformable_sampling_backward(value, loc, attn_w, g, need_value: bool = True):
    """VJP of :func:`deformable_sampling`; see
    :func:`deformable_sampling_backward_plain` for the contract.

    On CPU tensors this is the plain version. On CUDA tensors it launches the
    hand-written kernel (``csrc/deform_sample_bwd.cu``) or raises. Each launch
    adds one to ``deformable_sampling_backward.launches``.
    """
    _check_device(value, "deformable_sampling")
    fn = (_sampling_backward_kernel if value.device.type == "cuda"
          else deformable_sampling_backward_plain)
    return fn(value, loc, attn_w, g, need_value)


deformable_sampling_backward.launches = 0


class DeformableSampling(torch.autograd.Function):
    """Autograd node of per-head deformable sampling.

    ``forward(value, loc, attn_w, plain)``: with ``plain`` or on CPU tensors
    the plain versions run forward and backward; on CUDA tensors otherwise
    the two kernels. ``loc`` and ``attn_w`` arrive in fp32 (the caller casts
    them inside the graph, as ``_sample_pallas_fwd`` does, so autograd casts
    their gradients back). Gradients are computed only for the inputs that
    need them; ``d_value`` only when ``value`` needs one. On the card every
    gradient is summed in a fixed order, so runs are bitwise reproducible.
    """

    @staticmethod
    def forward(ctx, value, loc, attn_w, plain):
        use_kernel = value.device.type == "cuda" and not plain
        fn = _sampling_kernel if use_kernel else deformable_sampling_plain
        out = fn(value, loc, attn_w)
        ctx.save_for_backward(value, loc, attn_w)
        ctx.use_kernel = use_kernel
        return out

    @staticmethod
    def backward(ctx, g):
        value, loc, attn_w = ctx.saved_tensors
        need_value, need_loc, need_w = ctx.needs_input_grad[:3]
        fn = (_sampling_backward_kernel if ctx.use_kernel
              else deformable_sampling_backward_plain)
        d_value, d_loc, d_w = fn(value, loc, attn_w, g, need_value)
        return d_value, d_loc if need_loc else None, d_w if need_w else None, None


def deformable_sampling(value, loc, attn_w, plain: bool = False) -> torch.Tensor:
    """Attention-weighted bilinear sampling of per-head value maps; see
    :func:`deformable_sampling_plain` for the contract. Differentiable in
    ``value``, ``loc`` and ``attn_w``.

    On CPU tensors (or with ``plain``) this runs the plain versions forward
    and backward. On CUDA tensors it launches the hand-written kernels
    (``csrc/deform_sample.cu`` forward, ``csrc/deform_sample_bwd.cu``
    backward) or raises. ``loc`` and ``attn_w`` are cast to fp32 first, as in
    the JAX package's Pallas path, so bf16 sampling positions are not rounded
    again. Each forward launch adds one to ``deformable_sampling.launches``.
    The call is the program's ``sample`` span, with ``value``'s and
    ``loc``'s shapes.
    """
    _check_device(value, "deformable_sampling")
    with trace.span("sample", value=value, loc=loc):
        return DeformableSampling.apply(value, loc.to(torch.float32),
                                        attn_w.to(torch.float32), plain)


deformable_sampling.launches = 0


def deformable_sampling_shared(value, loc, attn_w, plain: bool = False) -> torch.Tensor:
    """Attention-weighted bilinear sampling of one value map shared by every
    head (the JAX package's ``deformable_sampling_shared``).

    value (B, H, W, Cs); loc (B, Q, nh, P, 2); attn_w (B, Q, nh, P). Returns
    (B, Q, nh, Cs). The heads are folded into the queries against a
    single-head value map, as the JAX package's Pallas path does
    (``_sample_shared_pallas_fwd_impl``), so this is the same autograd node
    and, on a card, the same two kernels as :func:`deformable_sampling`.
    """
    B, H, W, Cs = value.shape
    Q, nh, P = loc.shape[1:4]
    locf = loc.transpose(1, 2).reshape(B, nh * Q, 1, P, 2)
    wf = attn_w.transpose(1, 2).reshape(B, nh * Q, 1, P)
    out = deformable_sampling(value.reshape(B, H, W, 1, Cs), locf, wf, plain)
    return out.reshape(B, nh, Q, Cs).transpose(1, 2)
