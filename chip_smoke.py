#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root with one CUDA card: ``python3 chip_smoke.py``
(``--profile FILE`` adds a device-time breakdown of the serving forward and
of the training step, in both computation orders, and writes their tables
to FILE). It imports nothing of JAX and
nothing of the JAX package. Phases, one line each or more, every number
beside the card's name and power limit:

  1. build the hand-written kernels from ``egorear_tpu_torch/csrc/`` (nvcc,
     sm_90a) and report the build time;
  2. hold the forward kernel against its plain PyTorch version on the card
     at the flagship shapes, fp32 and bf16, with uniform locations and with
     the model's own (those the flagship's first MVFex and first pose3d
     call sample at batch 16, :func:`model_locations`), check that each
     bf16 call gives bitwise equal outputs in two runs, and time kernel,
     plain version and the library yardstick;
  2b. hold the backward kernels against their plain version at the same
     shapes and locations, fp32 and bf16, with and without ``d_feat``,
     check that ``d_feat`` is bitwise equal in two runs, and time kernels,
     plain version and the library yardstick, and the bf16 main-path sum
     of one step;
  3. run the flagship forward (256 px, batch 2, fp32, TF32 off) once through
     the kernels and once through the plain versions, same weights and input;
  4. serve the flagship (256 px, BN folded, bf16, batch 16) through
     ``entry.build`` and check that the main path launched the forward
     kernel 7 times per forward;
  5. take one fp32 training step (256 px, batch 2, TF32 off) through the
     plain versions and one through the kernels from the same state, the
     kernel step's ReLUs on the plain step's side of their kink
     (:func:`pinned_relus`), and compare gradients, parameters and BN
     running stats;
  6. train the flagship as users would (``entry.build_train``, bf16-mixed,
     batch 32, the configured schedule) and check that every step launched
     the forward and the backward kernel 7 times each and that the loss
     falls over the timed steps.

The reference computation order (``lazy_deform=False``: the memory on the
grid, per-head sampling through ``deform_sample.cu`` and
``deform_sample_bwd.cu``) adds:

  2c. the per-head sampling kernel against its plain version at the MVFex
     and pose3d shapes of batch 16, fp32 and bf16, and the head-shared form
     at one shape, with uniform locations and with the model's own, every
     output bitwise equal over two runs; times of kernel, plain version and
     ``F.grid_sample``;
  2d. the same for its backward (``d_value``, ``d_loc``, ``d_attn_w``), with
     uniform locations and with the model's own, all three gradients bitwise
     equal over two runs, and the bf16 main-path sum of a step;
  3b. phase 3 in the reference order, and against the lazy order on the
     same weights;
  4b. phase 4 in the reference order: 7 launches of the per-head kernel per
     forward and none of the lazy one;
  5b. phase 5 in the reference order;
  6b. phase 6 in the reference order: 7 + 7 launches of the per-head
     kernels per step, none of the lazy ones.

Every phase that drives the main path sets the launch counts of all four
kernels to 0 just before it and reads them just after.

It exits non-zero, without the last line, when there is no card or any phase
fails. Its last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# MVFex refiner call and pose3d lifting call at the flagship, batch 16:
# views folded into the batch (4 x 16), 4 heads, 16 points, a 64x64 grid of
# 128 raw channels; the refiners also sample the (V, HW, 256) pos tables.
SHAPES = {
    "mvfex": dict(B=64, Q=15, nh=4, P=16, H=64, Cin=128, G=4, C=256),
    "pose3d": dict(B=64, Q=16, nh=4, P=16, H=64, Cin=128, G=0, C=0),
}
# Kernel launches per flagship forward: 4 MVFex refiners run as a loop of
# 4 modules (one launch each), then 3 lifting layers.
LAUNCHES_MVFEX, LAUNCHES_POSE3D = 4, 3
LAUNCHES_PER_FORWARD = LAUNCHES_MVFEX + LAUNCHES_POSE3D
SERVE_BATCH, SERVE_WARMUP, SERVE_TIMED = 16, 3, 10
E2E_BATCH, E2E_HM_TOL, E2E_P3D_TOL = 2, 1e-4, 1e-2
# Backward kernel vs plain version: max-abs error of each gradient over that
# gradient's largest plain value (fp32: sums in another order, atomics in a
# varying order; bf16: bf16 inputs read by both, one bf16 rounding of d_feat
# and d_pos).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# Phase 5: per-leaf gradient error over the leaf's largest plain value.
TRAIN_GRAD_TOL, TRAIN_GRAD_FLOOR, TRAIN_BATCH = 1e-3, 1e-8, 2
TRAIN_STAT_TOL = 1e-4  # BN running stats after the step, max-abs
TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 32, 3, 10
TRAIN_SIZE, TRAIN_DEVICE = 256, "cuda"  # a CPU rehearsal may shrink them

# Per-head sampling (the reference order) at the flagship, batch 16: value
# (B, 64, 64, nh, ch) = value_proj of the (4 x 16, 4096, C) memory; MVFex
# C = 256, pose3d C = 128, 4 heads. The head-shared form at one shape: one
# map of Cs = ch = 128 raw channels sampled by 4 heads of 16 queries.
MSDA_SHAPES = {
    "mvfex": dict(B=64, H=64, nh=4, ch=64, Q=15, P=16),
    "pose3d": dict(B=64, H=64, nh=4, ch=32, Q=16, P=16),
}
SHARED_SHAPE = dict(B=64, H=64, nh=4, ch=128, Q=16, P=16)
# Forward kernel vs plain version: max-abs error over the largest plain value.
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# 3b: the reference order vs the lazy order on the same weights (fp32).
ORDERS_HM_TOL, ORDERS_P3D_TOL = 1e-4, 1e-2

# The four kernels, by source name, and which computation order runs them.
KERNELS = {
    "lazy_deform_sample": ("lazy", "egorear_tpu/ops/deform_attn.py:497"),
    "lazy_deform_sample_bwd": ("lazy", "egorear_tpu/ops/deform_attn.py:758"),
    "deform_sample": ("reference", "egorear_tpu/ops/deform_attn.py:174"),
    "deform_sample_bwd": ("reference", "egorear_tpu/ops/deform_attn.py:276"),
}


def _counters():
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    from egorear_tpu_torch.ops import deform_attn as da

    return {"lazy_deform_sample": da.lazy_deform_sample,
            "lazy_deform_sample_bwd": da.lazy_deform_sample_backward,
            "deform_sample": da.deformable_sampling,
            "deform_sample_bwd": da.deformable_sampling_backward}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def expected_launches(lazy: bool, forwards: int, backwards: int) -> dict:
    """Launch counts of a main-path run of ``forwards`` forwards and
    ``backwards`` backwards in one computation order: the other order's
    kernels never launch."""
    fwd, bwd = (("lazy_deform_sample", "lazy_deform_sample_bwd") if lazy
                else ("deform_sample", "deform_sample_bwd"))
    want = dict.fromkeys(KERNELS, 0)
    want[fwd] = forwards * LAUNCHES_PER_FORWARD
    want[bwd] = backwards * LAUNCHES_PER_FORWARD
    return want


def order_tag(phase: int, lazy: bool) -> str:
    return f"[{phase}{'' if lazy else 'b'}]"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def time_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` in ms over ``n`` runs.

    CUDA events around each run; a GPU sleep enqueued first keeps the device
    busy while the host enqueues ``fn``'s launches, so the events time the
    device work back to back and not the host's launch overhead.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms at H100 clocks
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def model_locations(batch: int = SERVE_BATCH, size: int = 256,
                    dev: str = "cuda") -> dict:
    """Sampling locations and attention weights of the flagship's own lazy
    sampling calls: the first MVFex refiner call and the first pose3d
    lifting call of one fp32 forward at ``batch`` (4 views folded in), with
    random weights from a seed moved off the init by :func:`perturb_` and a
    seeded image. Each head's points lie on a ray from its anchor (a 2D
    heatmap argmax, or a 3D proposal projected into the view), 1 to 16
    cells out (``deform_offset_bias``), moved by query-dependent offsets.
    Returns ``{"mvfex": (loc, attn_w), "pose3d": (loc, attn_w)}``, fp32."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.models.layers import MSDeformAttnLazy

    model, rig = entry.build((size, size), device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    img = torch.randn(batch, 4, 3, size, size, generator=gen, device=dev)
    perturb_(model, img, gen)
    got = {}
    for name, part in (("mvfex", model.heatmap_estimator),
                       ("pose3d", model.pose3d_estimator)):
        for m in part.modules():
            if isinstance(m, MSDeformAttnLazy):
                def keep(*args, _locations=m._locations, _name=name):
                    out = _locations(*args)
                    got.setdefault(_name, out)
                    return out
                m._locations = keep
    with torch.inference_mode():
        model(img, rig)
    return {name: tuple(t.float().clone() for t in out)
            for name, out in got.items()}


def corner_shares(loc, H: int):
    """Of the 4 bilinear corners of every point on an H x H grid: the share
    that lies in the grid, and the share of those that repeat a cell that
    another corner of the same (b, q), any head, already took."""
    B, Q = loc.shape[:2]
    x0 = torch.floor(loc[..., 0].float() * H - 0.5).long()
    y0 = torch.floor(loc[..., 1].float() * H - 0.5).long()
    bq = torch.arange(B * Q, device=loc.device).view(B, Q, 1, 1)
    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            xc, yc = x0 + dx, y0 + dy
            ok = (xc >= 0) & (xc < H) & (yc >= 0) & (yc < H)
            keys.append((bq * H * H + yc * H + xc)[ok])
    keys = torch.cat(keys)
    in_grid = keys.numel() / (4 * x0.numel())
    return in_grid, 1 - torch.unique(keys).numel() / max(keys.numel(), 1)


def sample_inputs(shape, dtype, gen, locations=None):
    """Seeded inputs for one lazy_deform_sample call: locations in
    [-0.3, 1.3] so corners fall outside on every side and softmaxed
    weights, or the given ``(loc, attn_w)``."""
    B, Q, nh, P, H, Cin, G, C = (shape[k] for k in
                                 ("B", "Q", "nh", "P", "H", "Cin", "G", "C"))
    dev = "cuda"
    feat = torch.randn(B, H * H, Cin, generator=gen, device=dev).to(dtype)
    loc = torch.rand(B, Q, nh, P, 2, generator=gen, device=dev) * 1.6 - 0.3
    attn_w = torch.randn(B, Q, nh, P, generator=gen, device=dev).softmax(-1)
    if locations is not None:
        loc, attn_w = locations
        if loc.shape != (B, Q, nh, P, 2):
            raise AssertionError(f"locations {tuple(loc.shape)} do not fit {shape}")
    pos = (torch.randn(G, H * H, C, generator=gen, device=dev).to(dtype)
           if C else None)
    return feat, loc, attn_w, pos


def corner_rows(feat, loc, pos, pos_block):
    """For these sampling locations: the number of distinct feature rows and
    pos rows that an in-range corner touches, and of in-range corners."""
    B, HW, Cin = feat.shape
    H = W = int(HW ** 0.5)
    C = pos.shape[-1] if pos is not None else 0
    G = pos.shape[0] if pos is not None else 1
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lazy_sample_bound_ms(feat, loc, attn_w, pos, pos_block):
    """Least time for one lazy_deform_sample call on these inputs.

    Bytes: each distinct feature row and pos row that an in-range corner
    touches, read once; loc and attn_w (fp32, as the kernel reads them) read
    once; s_feat, s_pos and s_one written once. Operations: one multiply-add
    (2 flops) per channel per in-range corner, fp32 outside the tensor cores.
    The larger of the two times at the published H100 peaks.
    """
    Cin, es = feat.shape[-1], feat.element_size()
    C = pos.shape[-1] if pos is not None else 0
    n_feat, n_pos, n_corners = corner_rows(feat, loc, pos, pos_block)
    rows_out = attn_w.numel() // attn_w.shape[-1]
    nbytes = (n_feat * Cin * es + n_pos * C * es + loc.numel() * 4
              + attn_w.numel() * 4 + rows_out * (Cin + C + 1) * es)
    return _bound(nbytes, 2 * n_corners * (Cin + C + 1))


def lazy_sample_backward_bound_ms(feat, loc, attn_w, pos, pos_block,
                                  need_feat):
    """Least time for one lazy_deform_sample backward on these inputs.

    Bytes: the upstream gradients g_feat, g_pos, g_one read once; the
    distinct feature and pos rows that an in-range corner touches, loc and
    attn_w (fp32) read once; d_feat written once in full when it is wanted,
    d_pos in full, d_loc and d_attn_w (fp32) once. Operations: per in-range
    corner and channel one multiply-add for the adjoint A and one for each
    wanted scatter (d_feat, d_pos), fp32.
    """
    B, HW, Cin = feat.shape
    es = feat.element_size()
    C = pos.shape[-1] if pos is not None else 0
    G = pos.shape[0] if pos is not None else 0
    n_feat, n_pos, n_corners = corner_rows(feat, loc, pos, pos_block)
    rows = attn_w.numel() // attn_w.shape[-1]
    nbytes = (rows * (Cin + C + 1) * es + n_feat * Cin * es + n_pos * C * es
              + loc.numel() * 4 + attn_w.numel() * 4
              + (B * HW * Cin * es if need_feat else 0) + G * HW * C * es
              + loc.numel() * 4 + attn_w.numel() * 4)
    flops = 2 * n_corners * (Cin + C + (Cin if need_feat else 0) + C)
    return _bound(nbytes, flops)


def max_err(got, want):
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want) if w is not None]
    scale = max(float(w.float().abs().max()) for w in want if w is not None)
    return max(errs), scale


def phase_kernels(card, model_locs):
    """Kernel vs plain version on the card at both flagship shapes, fp32 and
    bf16, with uniform locations and with the model's own; each bf16 call
    must give bitwise equal outputs in two runs."""
    from egorear_tpu_torch.ops.deform_attn import (
        lazy_deform_sample, lazy_deform_sample_plain)
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    record = None
    cases = [(name, shape, dtype, locs) for name, shape in SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)
             for locs in ("uniform", "model")]
    for name, shape, dtype, locs in cases:
        feat, loc, attn_w, pos = sample_inputs(
            shape, dtype, gen, model_locs[name] if locs == "model" else None)
        in_grid, repeated = corner_shares(loc, shape["H"])
        block = pos is not None
        got = lazy_deform_sample(feat, loc, attn_w, pos, block)
        torch.cuda.synchronize()
        # The oracle runs in fp32 on the same (possibly bf16) inputs.
        want = lazy_deform_sample_plain(
            feat.float(), loc, attn_w,
            pos.float() if pos is not None else None, block)
        if (got[1] is None) != (want[1] is None):
            raise AssertionError("kernel and plain version disagree on s_pos")
        err, scale = max_err(got, want)
        tol = 1e-4 if dtype == torch.float32 else 1e-2 * scale
        if not err <= tol:
            raise AssertionError(
                f"lazy_deform_sample {name} {dtype} {locs}: max-abs {err:.3e} "
                f"> {tol:.3e}")
        bitwise = ""
        if dtype == torch.bfloat16:
            again = lazy_deform_sample(feat, loc, attn_w, pos, block)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                raise AssertionError(f"lazy_deform_sample {name} {dtype} "
                                     f"{locs}: outputs differ between two runs")
            bitwise = "; bitwise equal in 2 runs"
        ms = time_ms(lambda: lazy_deform_sample(feat, loc, attn_w, pos, block))
        plain_ms = time_ms(lambda: lazy_deform_sample_plain(
            feat, loc, attn_w, pos, block))
        # Library yardstick: one grid_sample over the concatenated
        # [feat | pos | ones] buffer (no weighting, no sum over points).
        B, HW, Cin = feat.shape
        side = int(HW ** 0.5)
        parts = [feat]
        if pos is not None:
            parts.append(pos.repeat_interleave(B // pos.shape[0], dim=0))
        parts.append(feat.new_ones(B, HW, 1))
        buf = torch.cat(parts, -1).reshape(B, side, side, -1).permute(
            0, 3, 1, 2).contiguous()
        grid = (2 * loc - 1).reshape(B, -1, shape["P"], 2).to(dtype)
        library_ms = time_ms(lambda: F.grid_sample(
            buf, grid, mode="bilinear", padding_mode="zeros",
            align_corners=False))
        bound_ms, bound_by = lazy_sample_bound_ms(feat, loc, attn_w, pos, block)
        print(f"[2] lazy_deform_sample {name} {str(dtype)[6:]} {locs} "
              f"B={shape['B']} Q={shape['Q']} nh={shape['nh']} "
              f"P={shape['P']} {side}x{side} Cin={Cin} C={shape['C']}: "
              f"corners in grid {in_grid:.4f}, repeated in a (b, q) "
              f"{repeated:.4f}: max_abs_err={err:.3e} (tol {tol:.1e}{bitwise}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) | {card}", flush=True)
        if name == "mvfex" and dtype == torch.bfloat16 and locs == "uniform":
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    return record


def grad_inputs(feat, loc, pos, gen):
    """Seeded upstream gradients of one lazy_deform_sample call."""
    B, Q, nh = loc.shape[:3]
    dev, dtype = feat.device, feat.dtype
    g_feat = torch.randn(B, Q, nh, feat.shape[-1], generator=gen, device=dev).to(dtype)
    g_pos = (torch.randn(B, Q, nh, pos.shape[-1], generator=gen, device=dev).to(dtype)
             if pos is not None else None)
    g_one = torch.randn(B, Q, nh, 1, generator=gen, device=dev).to(dtype)
    return g_feat, g_pos, g_one


def grid_sample_backward_ms(feat, loc, pos, shape):
    """Library yardstick of the backward: the autograd backward of one
    F.grid_sample over [feat | pos | ones] with gradients on the input and
    the grid; only the backward is timed."""
    import torch.nn.functional as F

    B, HW, Cin = feat.shape
    side = int(HW ** 0.5)
    parts = [feat]
    if pos is not None:
        parts.append(pos.repeat_interleave(B // pos.shape[0], dim=0))
    parts.append(feat.new_ones(B, HW, 1))
    buf = torch.cat(parts, -1).reshape(B, side, side, -1).permute(
        0, 3, 1, 2).contiguous().requires_grad_()
    grid = (2 * loc - 1).reshape(B, -1, shape["P"], 2).to(feat.dtype).requires_grad_()
    out = F.grid_sample(buf, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    g_out = torch.randn_like(out)
    return time_ms(lambda: torch.autograd.grad(out, (buf, grid), g_out,
                                               retain_graph=True))


def phase_backward_kernels(card, model_locs):
    """Backward kernels vs plain version on the card at both flagship
    shapes, fp32 and bf16, with uniform locations and with the model's own,
    with and without d_feat; d_feat must come out bitwise equal from two
    runs."""
    from egorear_tpu_torch.ops.deform_attn import (
        lazy_deform_sample_backward, lazy_deform_sample_backward_plain)

    gen = torch.Generator(device="cuda").manual_seed(3)
    record = None
    names = ("d_feat", "d_loc", "d_attn_w", "d_pos")
    main_path = {}  # locations -> ms of the bf16 main-path calls of one step
    cases = [(name, shape, dtype, locs) for name, shape in SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)
             for locs in ("uniform", "model")]
    for name, shape, dtype, locs in cases:
        feat, loc, attn_w, pos = sample_inputs(
            shape, dtype, gen, model_locs[name] if locs == "model" else None)
        in_grid, repeated = corner_shares(loc, shape["H"])
        g_feat, g_pos, g_one = grad_inputs(feat, loc, pos, gen)
        block = pos is not None
        library_ms = grid_sample_backward_ms(feat, loc, pos, shape)
        f32 = lambda t: t.float() if t is not None else None  # noqa: E731
        for need_feat in (True, False):
            args = (feat, loc, attn_w, pos, block, g_feat, g_pos, g_one,
                    need_feat)
            got = lazy_deform_sample_backward(*args)
            again = lazy_deform_sample_backward(*args)
            torch.cuda.synchronize()
            if need_feat and not torch.equal(got[0], again[0]):
                raise AssertionError(f"lazy_deform_sample backward {name} "
                                     f"{dtype} {locs}: d_feat differs between "
                                     f"two runs")
            del again
            # The oracle runs in fp32 on the same (possibly bf16) inputs.
            want = lazy_deform_sample_backward_plain(
                feat.float(), loc, attn_w, f32(pos), block, g_feat.float(),
                f32(g_pos), g_one.float(), need_feat)
            errs, abs_errs = {}, []
            for n, g, w in zip(names, got, want):
                if (g is None) != (w is None):
                    raise AssertionError(f"backward {n}: kernel and plain "
                                         f"version disagree on presence")
                if w is None:
                    continue
                scale = float(w.abs().max())
                err = float((g.float() - w).abs().max())
                errs[n] = err / max(scale, 1e-30)
                abs_errs.append(err)
                if not err <= BWD_TOL[dtype] * scale:
                    raise AssertionError(
                        f"lazy_deform_sample backward {name} {dtype} {locs} "
                        f"{n}: max-abs {err:.3e} > {BWD_TOL[dtype]:g} x "
                        f"{scale:.3e}")
            del got, want
            ms = time_ms(lambda: lazy_deform_sample_backward(*args))
            plain_ms = time_ms(lambda: lazy_deform_sample_backward_plain(*args))
            bound_ms, bound_by = lazy_sample_backward_bound_ms(
                feat, loc, attn_w, pos, block, need_feat)
            err_txt = " ".join(f"{n}={e:.2e}" for n, e in errs.items())
            print(f"[2b] lazy_deform_sample_bwd {name} {str(dtype)[6:]} {locs} "
                  f"B={shape['B']} d_feat={'yes' if need_feat else 'no'} "
                  f"corners in grid {in_grid:.4f}, repeated in a (b, q) "
                  f"{repeated:.4f}: max-abs/scale {err_txt} (tol {BWD_TOL[dtype]:g}"
                  f"{'; d_feat bitwise equal in 2 runs' if need_feat else ''}) "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"({bound_by}) | {card}", flush=True)
            # The main path of a bf16 step: 4 MVFex calls without d_feat,
            # 3 pose3d calls with it.
            if dtype == torch.bfloat16 and need_feat == (name == "pose3d"):
                main_path[locs] = main_path.get(locs, 0.0) + (
                    LAUNCHES_MVFEX if name == "mvfex" else LAUNCHES_POSE3D) * ms
            # The record: the refiner call of the bf16 training step.
            if (name == "mvfex" and dtype == torch.bfloat16 and not need_feat
                    and locs == "uniform"):
                record = dict(max_abs_err=max(abs_errs), ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
    print(f"[2b] lazy_deform_sample_bwd main path of a bf16 step "
          f"({LAUNCHES_MVFEX} x MVFex without d_feat + {LAUNCHES_POSE3D} x "
          f"pose3d with it, kernel times above): "
          + ", ".join(f"{locs} {ms:.4f} ms" for locs, ms in main_path.items())
          + f" | {card}", flush=True)
    return record


def msda_inputs(shape, dtype, gen):
    """Seeded inputs for one deformable_sampling call: value (B, H, H, nh,
    ch), locations in [-0.3, 1.3] so corners fall outside on every side,
    softmaxed weights, and an upstream gradient of the output."""
    B, H, nh, ch, Q, P = (shape[k] for k in ("B", "H", "nh", "ch", "Q", "P"))
    dev = "cuda"
    value = torch.randn(B, H, H, nh, ch, generator=gen, device=dev).to(dtype)
    loc = torch.rand(B, Q, nh, P, 2, generator=gen, device=dev) * 1.6 - 0.3
    attn_w = torch.randn(B, Q, nh, P, generator=gen, device=dev).softmax(-1)
    g = torch.randn(B, Q, nh * ch, generator=gen, device=dev).to(dtype)
    return value, loc, attn_w, g


def msda_corner_slices(value, loc):
    """For these sampling locations: the number of distinct (b, cell, head)
    value slices that an in-range corner touches, and of in-range corners."""
    B, H, W, nh, _ = value.shape
    x = loc[..., 0].float() * W - 0.5
    y = loc[..., 1].float() * H - 0.5
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    h = torch.arange(nh, device=loc.device).view(1, 1, nh, 1)
    slices, n_corners = [], 0
    for dy in (0, 1):
        for dx in (0, 1):
            xc, yc = x0 + dx, y0 + dy
            ok = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            n_corners += int(ok.sum())
            slices.append((((b * H * W + yc * W + xc) * nh + h)[ok]))
    return int(torch.unique(torch.cat(slices)).numel()), n_corners


def msda_bound_ms(value, loc, attn_w, backward: bool = False):
    """Least time for one deformable_sampling call (or its backward) on
    these inputs.

    Forward bytes: each distinct (b, cell, head) value slice that an
    in-range corner touches read once; loc and attn_w (fp32, as the kernel
    reads them) read once; the (B, Q, nh*ch) output written once. The
    backward adds the upstream gradient g read once (output-sized), d_value
    written in full (value-sized) and d_loc and d_attn_w (fp32) written
    once. Operations: one multiply-add per channel per in-range corner, and
    in the backward one more for the d_value scatter, fp32 outside the
    tensor cores. The larger of the two times at the published H100 peaks.
    """
    ch, es = value.shape[-1], value.element_size()
    n_slices, n_corners = msda_corner_slices(value, loc)
    out_bytes = (attn_w.numel() // attn_w.shape[-1]) * ch * es
    nbytes = n_slices * ch * es + (loc.numel() + attn_w.numel()) * 4 + out_bytes
    flops = 2 * n_corners * ch
    if backward:
        nbytes += value.numel() * es + (loc.numel() + attn_w.numel()) * 4
        flops *= 2
    return _bound(nbytes, flops)


def _grid_sample_operands(value, loc, requires_grad=False):
    """value as (B*nh, ch, H, W) and the grid (B*nh, Q, P, 2) of one
    per-head F.grid_sample (no weighting, no sum over points)."""
    B, H, W, nh, ch = value.shape
    Q, P = loc.shape[1], loc.shape[3]
    v = value.permute(0, 3, 4, 1, 2).reshape(B * nh, ch, H, W).contiguous()
    grid = (2 * loc - 1).transpose(1, 2).reshape(B * nh, Q, P, 2).to(value.dtype)
    return v.requires_grad_(requires_grad), grid.contiguous().requires_grad_(requires_grad)


def phase_msda_kernels(card, model_locs):
    """2c: the per-head sampling kernel vs its plain version at both
    flagship shapes, fp32 and bf16, and the head-shared form in bf16 (with
    pose3d's locations, which fit its shape), each with uniform locations
    and with the model's own; every output must come out bitwise equal
    from two runs. Each case also times the call with every point moved off
    the grid (no gathers: the launch, the corner lists and the store), and
    the phase an empty one-block launch (``torch.cuda._sleep(0)``), the
    floor of ``time_ms``. Each case prints its line, then the phase fails
    if any check failed."""
    import torch.nn.functional as F

    from egorear_tpu_torch.ops.deform_attn import (
        deformable_sampling, deformable_sampling_plain,
        deformable_sampling_shared)

    gen = torch.Generator(device="cuda").manual_seed(6)
    record = None
    failures = []
    empty_ms = time_ms(lambda: torch.cuda._sleep(0))
    print(f"[2c] an empty one-block launch: {empty_ms:.4f} ms | {card}", flush=True)
    cases = [(name, shape, dtype, locs) for name, shape in MSDA_SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)
             for locs in ("uniform", "model")]
    cases += [("shared", SHARED_SHAPE, torch.bfloat16, locs)
              for locs in ("uniform", "model")]
    for name, shape, dtype, locs in cases:
        value, loc, attn_w, _ = msda_inputs(shape, dtype, gen)
        if locs == "model":
            loc, attn_w = model_locs["pose3d" if name == "shared" else name]
            if attn_w.shape != (shape["B"], shape["Q"], shape["nh"], shape["P"]):
                raise AssertionError(f"locations {tuple(loc.shape)} do not fit {shape}")
        case = f"deform_sample {name} {str(dtype)[6:]} {locs}"
        if name == "shared":
            value = value[:, :, :, 0].contiguous()  # (B, H, W, Cs), one map
            call = lambda where: deformable_sampling_shared(  # noqa: E731
                value, where, attn_w)
            plain = lambda: deformable_sampling_shared(  # noqa: E731
                value, loc, attn_w, plain=True)
            want = deformable_sampling_shared(value.float(), loc, attn_w, plain=True)
            # The kernel's call: the heads folded into the queries of one map.
            B, Q, nh, P = attn_w.shape
            kernel_args = (value[..., None, :],
                           loc.transpose(1, 2).reshape(B, nh * Q, 1, P, 2),
                           attn_w.transpose(1, 2).reshape(B, nh * Q, 1, P))
        else:
            call = lambda where: deformable_sampling(value, where, attn_w)  # noqa: E731
            plain = lambda: deformable_sampling_plain(value, loc, attn_w)  # noqa: E731
            want = deformable_sampling_plain(value.float(), loc, attn_w)
            kernel_args = (value, loc, attn_w)
        fn = lambda: call(loc)  # noqa: E731
        off_grid = loc + 2.0  # loc >= 1.7, so every corner lies past the grid
        n_slices, n_corners = msda_corner_slices(*kernel_args[:2])
        in_grid = n_corners / (4 * kernel_args[2].numel())
        got, again = fn(), fn()
        torch.cuda.synchronize()
        bitwise = torch.equal(got, again)
        if not bitwise:
            failures.append(f"{case}: outputs differ between two runs")
        scale = float(want.abs().max())
        err = float((got.float() - want).abs().max())
        if not err <= FWD_TOL[dtype] * scale:
            failures.append(f"{case}: max-abs {err:.3e} > {FWD_TOL[dtype]:g} x "
                            f"{scale:.3e}")
        if bool(call(off_grid).any()):
            failures.append(f"{case}: points off the grid give non-zero outputs")
        del got, again, want
        ms, plain_ms = time_ms(fn), time_ms(plain)
        off_ms = time_ms(lambda: call(off_grid))
        v, grid = _grid_sample_operands(*kernel_args[:2])
        library_ms = time_ms(lambda: F.grid_sample(
            v, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
        del v, grid
        bound_ms, bound_by = msda_bound_ms(*kernel_args)
        print(f"[2c] deform_sample {name} {str(dtype)[6:]} {locs} "
              f"{'x'.join(str(n) for n in value.shape)} Q={loc.shape[1]} "
              f"P={loc.shape[3]}: corners in grid {in_grid:.4f}, in-grid "
              f"corners per (b, cell, head) slice "
              f"{n_corners / max(n_slices, 1):.4f}: max-abs/scale "
              f"{err / scale:.3e} (tol {FWD_TOL[dtype]:g}; "
              f"{'' if bitwise else 'NOT '}bitwise equal in 2 runs) "
              f"ms={ms:.4f} (every point off the grid {off_ms:.4f}) "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) | {card}", flush=True)
        if name == "mvfex" and dtype == torch.bfloat16 and locs == "uniform":
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    if failures:
        raise AssertionError("; ".join(failures))
    return record


def phase_msda_backward_kernels(card, model_locs):
    """2d: the per-head sampling backward kernels vs their plain version at
    both flagship shapes, fp32 and bf16, with uniform locations and with the
    model's own, with d_value (every call of the main path needs it); all
    three gradients must come out bitwise equal from two runs. Each case
    prints its line, then the phase fails if any check failed; and the bf16
    main-path sum of one step."""
    import torch.nn.functional as F

    from egorear_tpu_torch.ops.deform_attn import (
        deformable_sampling_backward, deformable_sampling_backward_plain)

    gen = torch.Generator(device="cuda").manual_seed(7)
    record = None
    failures = []
    main_path = {}  # locations -> ms of the bf16 main-path calls of one step
    names = ("d_value", "d_loc", "d_attn_w")
    cases = [(name, shape, dtype, locs) for name, shape in MSDA_SHAPES.items()
             for dtype in (torch.float32, torch.bfloat16)
             for locs in ("uniform", "model")]
    for name, shape, dtype, locs in cases:
        value, loc, attn_w, g = msda_inputs(shape, dtype, gen)
        if locs == "model":
            loc, attn_w = model_locs[name]
            if attn_w.shape != (shape["B"], shape["Q"], shape["nh"], shape["P"]):
                raise AssertionError(f"locations {tuple(loc.shape)} do not fit {shape}")
        case = f"deform_sample backward {name} {str(dtype)[6:]} {locs}"
        n_slices, n_corners = msda_corner_slices(value, loc)
        in_grid = n_corners / (4 * attn_w.numel())
        got = deformable_sampling_backward(value, loc, attn_w, g)
        again = deformable_sampling_backward(value, loc, attn_w, g)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        if not bitwise:
            failures.append(f"{case}: outputs differ between two runs")
        del again
        # The oracle runs in fp32 on the same (possibly bf16) inputs.
        want = deformable_sampling_backward_plain(value.float(), loc, attn_w,
                                                  g.float())
        errs, abs_errs = {}, []
        for n, a, b in zip(names, got, want):
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            errs[n] = err / max(scale, 1e-30)
            abs_errs.append(err)
            if not err <= BWD_TOL[dtype] * scale:
                failures.append(f"{case} {n}: max-abs {err:.3e} > "
                                f"{BWD_TOL[dtype]:g} x {scale:.3e}")
        del got, want
        ms = time_ms(lambda: deformable_sampling_backward(value, loc, attn_w, g))
        # Without d_value only the adjoint kernel runs: the difference is
        # the d_value kernel, and d_value's bytes over it its write rate.
        adjoint_ms = time_ms(lambda: deformable_sampling_backward(
            value, loc, attn_w, g, need_value=False))
        write_tbs = value.numel() * value.element_size() / max(ms - adjoint_ms, 1e-9) / 1e9
        plain_ms = time_ms(lambda: deformable_sampling_backward_plain(
            value, loc, attn_w, g))
        # Library yardstick: the autograd backward of one per-head
        # F.grid_sample, grads on input and grid; the backward only.
        v, grid = _grid_sample_operands(value, loc, requires_grad=True)
        out = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
        g_out = torch.randn_like(out)
        library_ms = time_ms(lambda: torch.autograd.grad(
            out, (v, grid), g_out, retain_graph=True))
        del out, v, grid, g_out
        bound_ms, bound_by = msda_bound_ms(value, loc, attn_w, backward=True)
        err_txt = " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        print(f"[2d] deform_sample_bwd {name} {str(dtype)[6:]} {locs} "
              f"{'x'.join(str(n) for n in value.shape)} Q={shape['Q']}: "
              f"corners in grid {in_grid:.4f}, in-grid corners per (b, cell, "
              f"head) slice {n_corners / max(n_slices, 1):.4f}: max-abs/scale "
              f"{err_txt} (tol {BWD_TOL[dtype]:g}; "
              f"{'' if bitwise else 'NOT '}bitwise equal in 2 runs) "
              f"ms={ms:.4f} (without d_value {adjoint_ms:.4f}: d_value "
              f"{write_tbs:.2f} TB/s) plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}) | {card}", flush=True)
        if dtype == torch.bfloat16:
            main_path[locs] = main_path.get(locs, 0.0) + (
                LAUNCHES_MVFEX if name == "mvfex" else LAUNCHES_POSE3D) * ms
        if name == "mvfex" and dtype == torch.bfloat16 and locs == "uniform":
            record = dict(max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    print(f"[2d] deform_sample_bwd main path of a bf16 step ({LAUNCHES_MVFEX} "
          f"x MVFex + {LAUNCHES_POSE3D} x pose3d, kernel times above): "
          + ", ".join(f"{locs} {ms:.4f} ms" for locs, ms in main_path.items())
          + f" | {card}", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return record


def deform_attns(model):
    """Every deformable attention of the model, in either computation order
    (``MSDeformAttnLazy`` is an ``MSDeformAttn``)."""
    from egorear_tpu_torch.models.layers import MSDeformAttn

    return [m for m in model.modules() if isinstance(m, MSDeformAttn)]


@torch.no_grad()
def perturb_(model, img, gen):
    """Move the weights away from the init where it makes sampling trivial.

    Sampling offsets and attention weights get query-dependent kernels (a few
    pixels of spread), the refiners' position tables random values, the 3D
    proposal a random pose spread over the rig's field of view, and the
    initial heatmap heads a bias that puts the median peak at the 0.5
    validity threshold, so about half the 2D anchors are valid.
    """
    for m in deform_attns(model):
        fan_in = m.sampling_offsets.weight.shape[1]
        m.sampling_offsets.weight.normal_(0.0, 2.0 * fan_in**-0.5, generator=gen)
        m.attention_weights.weight.normal_(0.0, fan_in**-0.5, generator=gen)
    hm_net = model.heatmap_estimator
    for r in hm_net.refiners:
        r.frame_feat_multi_view_pos_embed.normal_(0.0, 0.5, generator=gen)
    bias = model.pose3d_estimator.mlp_pred_out.bias
    u = torch.rand(bias.numel() // 3, 3, generator=gen, device=bias.device)
    lo = torch.tensor([-60.0, -60.0, -20.0], device=bias.device)
    hi = torch.tensor([60.0, 60.0, 80.0], device=bias.device)
    bias.copy_((lo + u * (hi - lo)).reshape(-1))
    _, _, (feat_f, feat_b) = hm_net._estimator_features(img)
    peaks = hm_net._heatmaps_from_feat(feat_f, feat_b).amax(dim=(-2, -1))
    shift = 0.5 - float(peaks.median())
    for head in (hm_net.conv_heatmap_head_front, hm_net.conv_heatmap_head_back):
        head.Conv_4.bias.add_(shift)


def phase_end_to_end(card, lazy: bool = True):
    """The flagship forward through the kernels vs through the plain
    versions; in the reference order also vs the lazy order on the same
    weights."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    tag = order_tag(3, lazy)
    model, rig = entry.build((256, 256), dtype=torch.float32, seed=0,
                             lazy_deform=lazy)
    gen = torch.Generator(device="cuda").manual_seed(1)
    img = torch.randn(E2E_BATCH, 4, 3, 256, 256, generator=gen, device="cuda")
    perturb_(model, img, gen)
    attns = deform_attns(model)
    with torch.inference_mode():
        reset_launches()
        got_p3d, got_hm = model(img, rig)
        torch.cuda.synchronize()
        launched = read_launches()
        for m in attns:
            m.impl = "plain"
        want_p3d, want_hm = model(img, rig)
        for m in attns:
            m.impl = "kernel"
    if launched != expected_launches(lazy, 1, 0):
        raise AssertionError(f"kernel run launched {launched}, expected "
                             f"{expected_launches(lazy, 1, 0)}")
    valid_2d = float(argmax_2d(want_hm[0], 0.5, normalize=True)[2].float().mean())
    valid_3d = float(rig.project(want_p3d[0])[1].float().mean())
    if not (valid_2d > 0 and valid_3d > 0):
        raise AssertionError(f"no valid anchors (2D {valid_2d}, 3D {valid_3d}): "
                             f"the check would not see the kernel")
    hm_errs = [float((g - w).abs().max()) for g, w in zip(got_hm, want_hm)]
    p3d_errs = [float((g - w).abs().max()) for g, w in zip(got_p3d, want_p3d)]
    print(f"{tag} flagship 256px B={E2E_BATCH} fp32 "
          f"{'lazy' if lazy else 'reference'} order kernel vs plain: heatmap "
          f"stages max-abs {hm_errs} (tol {E2E_HM_TOL:g}), preds_3d stages "
          f"max-abs cm {p3d_errs} (tol {E2E_P3D_TOL:g}); valid anchors 2D "
          f"{valid_2d:.3f} 3D {valid_3d:.3f} | {card}", flush=True)
    if len(got_hm) != 2 or len(got_p3d) != 4:
        raise AssertionError("unexpected number of output stages")
    if not (max(hm_errs) <= E2E_HM_TOL and max(p3d_errs) <= E2E_P3D_TOL):
        raise AssertionError("end-to-end kernel run disagrees with the plain run")
    if lazy:
        return
    # Two independent kernels computing one function by different algebra.
    other, _ = entry.build((256, 256), dtype=torch.float32, seed=0)
    other.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        lazy_p3d, lazy_hm = other(img, rig)
    hm_errs = [float((g - w).abs().max()) for g, w in zip(got_hm, lazy_hm)]
    p3d_errs = [float((g - w).abs().max()) for g, w in zip(got_p3d, lazy_p3d)]
    print(f"{tag} flagship 256px B={E2E_BATCH} fp32 reference order vs lazy "
          f"order, both through their kernels, same weights: heatmap stages "
          f"max-abs {hm_errs} (tol {ORDERS_HM_TOL:g}), preds_3d stages max-abs "
          f"cm {p3d_errs} (tol {ORDERS_P3D_TOL:g}) | {card}", flush=True)
    if not (max(hm_errs) <= ORDERS_HM_TOL and max(p3d_errs) <= ORDERS_P3D_TOL):
        raise AssertionError("the reference order disagrees with the lazy order")


def phase_serve(card, profile: str | None, lazy: bool = True):
    """Serve the flagship as users would; returns the kernel launch counts
    of the main path."""
    from egorear_tpu_torch import entry

    tag = order_tag(4, lazy)
    model, rig = entry.build((256, 256), dtype=torch.bfloat16, bn_folded=True,
                             seed=0, lazy_deform=lazy)
    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.randn(SERVE_BATCH, 4, 3, 256, 256, generator=gen,
                      device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_launches()
        for _ in range(SERVE_WARMUP):
            model(img, rig)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_TIMED):
            preds_3d, heatmaps = model(img, rig)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SERVE_TIMED
        launches = read_launches()
    forwards = SERVE_WARMUP + SERVE_TIMED
    want = expected_launches(lazy, forwards, 0)
    if launches != want:
        raise AssertionError(f"{forwards} forwards launched {launches}, "
                             f"expected {want}")
    B, J = SERVE_BATCH, 16
    if [tuple(p.shape) for p in preds_3d] != [(B, J, 3)] * 4:
        raise AssertionError(f"preds_3d shapes {[p.shape for p in preds_3d]}")
    if [tuple(h.shape) for h in heatmaps] != [(B, 4, 15, 64, 64)] * 2:
        raise AssertionError(f"heatmap shapes {[h.shape for h in heatmaps]}")
    if not all(bool(torch.isfinite(x).all()) for x in (*preds_3d, *heatmaps)):
        raise AssertionError("non-finite serving output")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    name = "lazy_deform_sample" if lazy else "deform_sample"
    print(f"{tag} serve flagship 256px bf16 BN-folded "
          f"{'lazy' if lazy else 'reference'} order B={B}: "
          f"{dt * 1e3:.3f} ms/forward (host clock, {SERVE_TIMED} forwards "
          f"after {SERVE_WARMUP} warm-up), {B / dt:.1f} samples/s "
          f"({4 * B / dt:.1f} images/s), peak {peak_gib:.2f} GiB; {name} "
          f"launches {launches[name]} = {forwards} x {LAUNCHES_PER_FORWARD} "
          f"(4 refiners looped + 3 lifting layers), other kernels 0 | {card}",
          flush=True)
    if profile:
        profile_serving(model, rig, img, card, profile, lazy)
    return launches


# The __global__ functions of each csrc source, as the profiler names them:
# a symbol that starts at a word boundary and matches the pattern (the
# backward sources may launch several kernels, all named <source>_*kernel).
KERNEL_SYMBOLS = {
    "lazy_deform_sample": r"lazy_deform_sample_kernel\b",
    "lazy_deform_sample_bwd": r"lazy_deform_sample_bwd_\w*kernel\b",
    "deform_sample": r"deform_sample_kernel\b",
    "deform_sample_bwd": r"deform_sample_bwd_\w*kernel\b",
}


def kernel_time(events, name: str) -> float:
    """Device time (us) of the __global__ functions of csrc source ``name``
    in the profiler's events: ``deform_sample`` does not count the lazy
    kernels, nor a forward key its backward's."""
    pattern = re.compile(r"(?<![A-Za-z0-9_])" + KERNEL_SYMBOLS[name])
    return sum(e.self_device_time_total for e in events if pattern.search(e.key))


def profile_serving(model, rig, img, card, path: str, lazy: bool = True,
                    n: int = 3):
    """Device time by kernel over ``n`` serving forwards (torch.profiler);
    the table goes to ``path`` (the lazy order's first, then appended)."""
    from torch.profiler import ProfilerActivity, profile

    tag = order_tag(4, lazy)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            model(img, rig)
        torch.cuda.synchronize()
    events, total = _device_table(prof, f"{card} serving {tag}", path,
                                  "w" if lazy else "a")
    if total <= 0:
        print(f"{tag} profile: the profiler saw no device time | {card}")
        return
    name = "lazy_deform_sample" if lazy else "deform_sample"
    t = kernel_time(events, name)
    print(f"{tag} profile over {n} forwards: device busy {total / n / 1e3:.3f} "
          f"ms/forward, {name} {t / n / 1e3:.4f} ms/forward "
          f"({100 * t / total:.2f}% of device time) | {card}", flush=True)


def train_batch(B, size, gen, dtype=torch.float32):
    """A seeded stage-3 batch of the reference's pose3d contract: 4 views of
    ``size`` px, the 16-joint 3D pose in cm and 15-joint per-view heatmaps
    at 1/4 resolution."""
    h = size // 4
    img = torch.randn(B, 4, 3, size, size, generator=gen, device=TRAIN_DEVICE)
    u = torch.rand(B, 16, 3, generator=gen, device=TRAIN_DEVICE)
    lo = torch.tensor([-60.0, -60.0, -20.0], device=TRAIN_DEVICE)
    hi = torch.tensor([60.0, 60.0, 80.0], device=TRAIN_DEVICE)
    gt_hm = torch.rand(B, 4, 15, h, h, generator=gen, device=TRAIN_DEVICE)
    return {"img": img.to(dtype), "gt_pose": lo + u * (hi - lo),
            "gt_heatmap": gt_hm}


def _adam_param_check(name, got, want, grad, grad_tol, lr, eps=1e-8):
    """Parameters after one AdamW step from the same state, whose gradients
    differ by at most ``grad_tol``. The first step moves each element by
    lr * g / (|g| + eps) (plus the same decay in both runs): where |g| is
    well above ``grad_tol`` that is lr * sign(g) in both runs, but an element
    whose gradient lies within ``grad_tol`` of zero may move by up to 2 lr
    more in one run. The bound per element is lr times the largest change
    of g / (|g| + eps) over the gradient's tolerance interval, plus fp32
    rounding. Returns the largest difference where the gradient is
    determined (|g| > 10 grad_tol) and where it is not."""
    diff = (got - want).abs()
    gmin = (grad.abs() - grad_tol).clamp_min(0.0)
    bound = (lr * (eps * grad_tol / (gmin + eps) ** 2).clamp(max=2.0)
             + 1e-6 * (1.0 + want.abs()))
    if not bool((diff <= bound * (1 + 1e-3)).all()):
        i = int(torch.argmax(diff - bound))
        raise AssertionError(f"{name}: params after the step differ by "
                             f"{float(diff.flatten()[i]):.3e} > bound "
                             f"{float(bound.flatten()[i]):.3e} (gradient "
                             f"{float(grad.flatten()[i]):.3e})")
    determined = grad.abs() > 10 * grad_tol
    tight = float(diff[determined].max()) if bool(determined.any()) else 0.0
    loose = float(diff[~determined].max()) if bool((~determined).any()) else 0.0
    return tight, loose


@contextlib.contextmanager
def pinned_relus(masks: list, flips: list | None = None):
    """With ``flips`` None, records the mask (input > 0) of every ``F.relu``
    call inside, in call order, into ``masks``. Otherwise the i-th call
    takes ``masks[i]``: where its input's sign agrees with the mask it is
    ``F.relu``, and where it does not it gives ``torch.where(mask, x, 0)``,
    whose gradient follows the mask, and appends (inputs that disagree,
    their largest |input| over the call's largest) to ``flips``.

    ReLU's gradient jumps at 0, so an input that two runs round to either
    side of it changes a gradient by a whole path, however small the input.
    Pinning the kernel step's ReLUs to the plain step's side compares both
    gradients on the same linear piece, where they are continuous in the
    kernel's rounding; the caller requires every input that changed sides
    to lie within FWD_TOL[fp32] of the call's scale of zero."""
    import torch.nn.functional as F

    relu, calls = F.relu, [0]

    def relu_pinned(x, inplace=False):
        if flips is None:
            masks.append(x.detach() > 0)
            return relu(x, inplace)
        mask = masks[calls[0]]
        calls[0] += 1
        if mask.shape != x.shape:
            raise AssertionError(f"ReLU call {calls[0] - 1}: shape {tuple(x.shape)}"
                                 f", the recorded step's {tuple(mask.shape)}")
        differ = (x.detach() > 0) != mask
        if not bool(differ.any()):
            return relu(x, inplace)
        scale = float(x.detach().abs().max())
        flips.append((int(differ.sum()),
                       float(x.detach()[differ].abs().max()) / max(scale, 1e-30)))
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))

    F.relu = relu_pinned
    try:
        yield
    finally:
        F.relu = relu
    if flips is not None and calls[0] != len(masks):
        raise AssertionError(f"{calls[0]} ReLU calls, the recorded step made "
                             f"{len(masks)}")


def phase_train_check(card, lazy: bool = True):
    """One fp32 train step through the plain versions vs one through the
    kernels, from the same state on the same batch, the kernel step's ReLUs
    pinned to the plain step's masks (:func:`pinned_relus`)."""
    import copy

    from egorear_tpu_torch import entry
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    task, trainer = entry.build_train((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32",
                                      seed=0, steps_per_epoch=1,
                                      warmup_iters=1, lazy_deform=lazy)
    model = task.model
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(4)
    batch = train_batch(TRAIN_BATCH, TRAIN_SIZE, gen)
    # Perturb in train mode, so that the median initial heatmap peak of the
    # training forward (BN on batch statistics) sits at the threshold.
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    perturb_(model, batch["img"], gen)
    model.load_state_dict(stats, strict=False)
    start = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        preds, hms = task.forward(batch["img"])
    model.load_state_dict(start)
    valid_2d = float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean())
    valid_3d = float(task.rig.project(preds[0])[1].float().mean())
    if not (0 < valid_2d < 1 and 0 < valid_3d < 1):
        raise AssertionError(f"anchors not partly valid (2D {valid_2d}, 3D "
                             f"{valid_3d}): the check would not see the kernel")

    runs, masks, flips = {}, [], []
    for impl in ("plain", "kernel"):
        for m in deform_attns(model):
            m.impl = impl
        model.load_state_dict(start)
        trainer.init_state(steps_per_epoch=1)
        reset_launches()
        with pinned_relus(masks, flips if impl == "kernel" else None):
            metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        launched = read_launches()
        runs[impl] = dict(
            launched=launched, loss=float(metrics["loss_total"]),
            lr=float(metrics["lr"]),
            grads={n: p.grad.detach().clone() for n, p in model.named_parameters()},
            params={n: p.detach().clone() for n, p in model.named_parameters()},
            stats={k: v.clone() for k, v in model.state_dict().items()
                   if "running" in k})
    for m in deform_attns(model):
        m.impl = "kernel"
    if runs["kernel"]["launched"] != expected_launches(lazy, 1, 1):
        raise AssertionError(f"kernel step launched {runs['kernel']['launched']}"
                             f", expected {expected_launches(lazy, 1, 1)}")
    if any(runs["plain"]["launched"].values()):
        raise AssertionError("the plain step launched a kernel")
    kink = max((f[1] for f in flips), default=0.0)
    if not kink <= FWD_TOL[torch.float32]:
        raise AssertionError(f"a ReLU input {kink:.3e} of its call's scale from "
                             f"zero changed sides (tol {FWD_TOL[torch.float32]:g})")
    fwd_name, bwd_name = (("lazy_deform_sample", "lazy_deform_sample_bwd") if lazy
                          else ("deform_sample", "deform_sample_bwd"))
    k, pl = runs["kernel"], runs["plain"]
    # A leaf whose largest gradient is below TRAIN_GRAD_FLOOR of the model's
    # largest is zero in exact arithmetic (the key-projection biases, to
    # which softmax attention is invariant) and holds rounding only: both
    # runs must keep it below that floor.
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in pl["grads"].values())
    worst_grad, worst_name, n_floor = 0.0, "", 0
    worst_tight = worst_loose = 0.0
    for n, want in pl["grads"].items():
        scale = float(want.abs().max())
        got = k["grads"][n]
        err = float((got - want).abs().max())
        if scale < floor:
            n_floor += 1
            if not float(got.abs().max()) <= floor:
                raise AssertionError(f"gradient of {n}: {float(got.abs().max()):.3e}"
                                     f" above the rounding floor {floor:.3e}")
            grad_tol = floor
        else:
            if err / scale > worst_grad:
                worst_grad, worst_name = err / scale, n
            if not err <= TRAIN_GRAD_TOL * scale:
                raise AssertionError(f"gradient of {n}: max-abs {err:.3e} > "
                                     f"{TRAIN_GRAD_TOL:g} x {scale:.3e}")
            grad_tol = TRAIN_GRAD_TOL * scale
        tight, loose = _adam_param_check(n, k["params"][n], pl["params"][n],
                                         want, grad_tol, pl["lr"])
        worst_tight, worst_loose = max(worst_tight, tight), max(worst_loose, loose)
    stat_err = max(float((k["stats"][n] - v).abs().max())
                   for n, v in pl["stats"].items())
    if not stat_err <= TRAIN_STAT_TOL:
        raise AssertionError(f"BN running stats differ by {stat_err:.3e}")
    print(f"{order_tag(5, lazy)} flagship {TRAIN_SIZE}px B={TRAIN_BATCH} fp32 "
          f"{'lazy' if lazy else 'reference'} order train step kernel vs plain: "
          f"loss {k['loss']:.6f} vs {pl['loss']:.6f}; worst leaf gradient "
          f"max-abs/scale {worst_grad:.3e} ({worst_name}, tol "
          f"{TRAIN_GRAD_TOL:g}; {n_floor} leaves below the rounding floor "
          f"{floor:.1e}); params after the step {worst_tight:.3e} where "
          f"the gradient is determined, {worst_loose:.3e} elsewhere (Adam "
          f"bound 2 lr = {2 * pl['lr']:.1e}); BN running stats "
          f"{stat_err:.3e} (tol {TRAIN_STAT_TOL:g}); ReLU inputs pinned across "
          f"the kink {sum(f[0] for f in flips)} in {len(flips)} of {len(masks)} "
          f"calls (largest {kink:.3e} of its call's scale, tol "
          f"{FWD_TOL[torch.float32]:g}); launches (fwd, bwd) "
          f"({k['launched'][fwd_name]}, {k['launched'][bwd_name]}); valid "
          f"anchors 2D {valid_2d:.3f} 3D "
          f"{valid_3d:.3f} | {card}", flush=True)


def phase_train(card, profile: str | None, lazy: bool = True):
    """Train the flagship as users would; returns the kernel launch counts
    of the main path."""
    from egorear_tpu_torch import entry

    # The flagship schedule as configured, warmup 500 included: without the
    # warmup, lr 1e-3 from step 1 overshoots on one fixed random batch (the
    # loss fell for 2 steps, then rose to 1.9x its start on the H100).
    task, trainer = entry.build_train((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE,
                                      "bf16-mixed", seed=0,
                                      steps_per_epoch=1000, lazy_deform=lazy)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(5)
    batch = train_batch(TRAIN_B, TRAIN_SIZE, gen)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(trainer.train_step(batch)["loss_total"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        losses.append(trainer.train_step(batch)["loss_total"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    launches = read_launches()
    steps = TRAIN_WARMUP + TRAIN_TIMED
    want = expected_launches(lazy, steps, steps)
    if launches != want:
        raise AssertionError(f"{steps} train steps launched {launches}, "
                             f"expected {want}")
    fwd_name, bwd_name = (("lazy_deform_sample", "lazy_deform_sample_bwd") if lazy
                          else ("deform_sample", "deform_sample_bwd"))
    losses = [float(x) for x in losses]
    first, last = losses[TRAIN_WARMUP], losses[-1]  # over the timed steps
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"loss not finite and falling: {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{order_tag(6, lazy)} train flagship {TRAIN_SIZE}px bf16-mixed "
          f"{'lazy' if lazy else 'reference'} order B={TRAIN_B}: "
          f"{dt * 1e3:.3f} ms/step (host clock, {TRAIN_TIMED} steps after "
          f"{TRAIN_WARMUP} warm-up, one fixed batch, lr {trainer.lr:g} warmed "
          f"over {trainer.warmup_iters} steps), {TRAIN_B / dt:.2f} samples/s, "
          f"peak {peak_gib:.2f} GiB; "
          f"loss {first:.4f} -> {last:.4f}; launches {fwd_name} "
          f"{launches[fwd_name]}, {bwd_name} {launches[bwd_name]} = {steps} x "
          f"{LAUNCHES_PER_FORWARD}, other kernels 0 | {card}", flush=True)
    if profile:
        profile_train(trainer, batch, card, profile, lazy)
    return launches


def _device_table(prof, card, path, mode):
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events)
    if total > 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, mode) as f:
            f.write(f"{card}\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=40))
            f.write("\n")
    return events, total


def profile_train(trainer, batch, card, path: str, lazy: bool = True,
                  n: int = 3):
    """Device time by kernel over ``n`` train steps (torch.profiler), and the
    device's idle share against the host clock; the table is appended to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    tag = order_tag(6, lazy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            trainer.train_step(batch)
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / n * 1e3
    events, total = _device_table(prof, f"{card} training {tag}", path, "a")
    if total <= 0:
        print(f"{tag} profile: the profiler saw no device time | {card}")
        return
    busy = total / n / 1e3
    names = (("lazy_deform_sample", "lazy_deform_sample_bwd") if lazy
             else ("deform_sample", "deform_sample_bwd"))
    fwd, bwd = (kernel_time(events, name) / n / 1e3 for name in names)
    print(f"{tag} profile over {n} train steps: host {host:.3f} ms/step under "
          f"the profiler, device busy {busy:.3f} ms/step (idle "
          f"{100 * (1 - busy / host):.1f} %); {names[0]}.cu "
          f"{fwd:.4f} ms/step, {names[1]}.cu (all its kernels) {bwd:.4f} "
          f"ms/step ({100 * (fwd + bwd) / busy:.2f} % of device time) | {card}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write a device-time breakdown of the serving "
                         "forward and of the training step, in both "
                         "computation orders, to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    from egorear_tpu_torch import kernels

    print(f"[1] device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda} | {card}", flush=True)
    seconds = {}

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    logs = timed("1", kernels.build)
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[1] built {name} in {seconds['1']:.1f} s: {' | '.join(ptxas)}",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model_locs = timed("locs", model_locations)
    records = {
        "lazy_deform_sample": timed("2", phase_kernels, card, model_locs),
        "lazy_deform_sample_bwd": timed("2b", phase_backward_kernels, card,
                                        model_locs),
        "deform_sample": timed("2c", phase_msda_kernels, card, model_locs),
        "deform_sample_bwd": timed("2d", phase_msda_backward_kernels, card,
                                   model_locs)}
    serve, train = {}, {}
    for lazy in (True, False):
        b = "" if lazy else "b"
        timed(f"3{b}", phase_end_to_end, card, lazy)
        serve[lazy] = timed(f"4{b}", phase_serve, card, args.profile, lazy)
        timed(f"5{b}", phase_train_check, card, lazy)
        train[lazy] = timed(f"6{b}", phase_train, card, args.profile, lazy)
    print(f"[7] main-path launches: serving forward lazy_deform_sample "
          f"{serve[True]['lazy_deform_sample']}, deform_sample "
          f"{serve[False]['deform_sample']}; training lazy_deform_sample "
          f"{train[True]['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{train[True]['lazy_deform_sample_bwd']}, deform_sample "
          f"{train[False]['deform_sample']}, deform_sample_bwd "
          f"{train[False]['deform_sample_bwd']} | {card}", flush=True)
    print("[7] seconds by phase: "
          + " ".join(f"{k}={v:.1f}" for k, v in seconds.items())
          + f"; total {time.perf_counter() - t0:.1f} | {card}", flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"egorear_tpu_torch/csrc/{name}.cu", replaces=replaces,
             launches=train[order == "lazy"][name], **records[name])
        for name, (order, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
