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
     falls over the timed steps; then one more step whose launches are kept
     and each held against its plain version on the inputs the step gave
     it, at the main path's shapes (:func:`kept_step`).

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
     kernels per step, none of the lazy ones, and the kept step.

The training stages as ``configs/ego4view_syn_*.yaml`` chain them (the
ImageNet weights are a seeded random ResNet-18 in torchvision's key layout,
written to a temporary file that ``EGOREAR_IMAGENET_RESNET18`` names for
these phases only):

  8. stage 1 of the front and the back pair (``entry.build_stage1``): the
     ImageNet leaves bitwise the file's and every other leaf the seeded
     init's, b64 fp32 training with the yamls' schedule and clipping (the
     loss must fall), ms/step, samples/s, peak memory and the device's idle
     share (its busy time under torch.profiler over a few more steps against
     the timed steps' ms/step), a checkpoint each;
  9. one fp32 stage-2 step (256 px, b2) through the kernels vs the plain
     versions from the same state, as phase 5 (4 + 4 lazy launches);
  10. stage 2 as users train it (``entry.build_stage2``): the ImageNet init,
     then both stage-1 checkpoints grafted (the grafted leaves bitwise the
     checkpoints', every other leaf unchanged), b64 fp32 training in which
     every step launches the lazy forward and backward 4 times each and the
     per-head kernels never, the same numbers as phase 8, a kept step (its
     4 + 4 launches at kernel batch 256 held against the plain versions), a
     checkpoint;
  11. the stage-2 checkpoint grafted into stage 3 (``entry.build_train``):
     ``heatmap_estimator`` bitwise the checkpoint's, one b32 fp32 kept step
     with 7 + 7 lazy launches (each held against its plain version) and a
     finite loss.

The CLI (``python -m egorear_tpu_torch.run``, called as ``run.main(argv)``)
on the shipped yamls, full width, overrides only for the data root, the log
directory, one epoch and the stage checkpoints:

  12. a synthetic syn tree at the dataset's geometry (872-px JPEGs with the
     joints drawn in, precomputed heatmaps; 128 train frames, 6 validation
     and 6 test frames) and the loader's decode rate over it; ``fit`` of
     stage 1 (both pairs, from the seeded "ImageNet" weights), stage 2
     (grafted from both) and stage 3 (grafted from stage 2), each at its
     yaml's batch for one epoch of at least 2 steps, with its metrics.csv,
     finite losses, ``epoch=0.pt`` and exactly the expected lazy launches
     (4 + 4 a stage-2 step, 7 + 7 a stage-3 step, 4 or 7 an eval batch);
     each stage's samples/s through the loader beside its step on one
     batch on the card and phases 8/10's; then ``test`` and ``validate``
     (the JAX metric names, printed as JSON) and ``predict`` (b4, the last
     batch padded) on the stage-3 checkpoint, ``predict`` also with
     ``--device cpu`` (the plain versions) and held to the card's within
     phase 3's ``preds_3d`` tolerance.

The stereo-pair (V = 2) and real-world yamls through the CLI, the same way:

  13. a: ``fit`` of the V = 2 stage 2 (``*_mvfex-n1_jqa_stereo_front``, b64,
     grafted from phase 12's stage-1 front checkpoint: 2 + 2 lazy launches
     a step, kernel batch 2 B) and stage 3 (``ego4view_syn_pose3d_stereo_front``,
     b32, grafted from it: 5 + 5) on phase 12's tree, a kept step of each,
     ``test`` (5 launches a batch); b: a real-world tree (872-px PNGs, 64
     train and 6 + 6 eval frames, each sequence's device-to-camera
     transforms), ``fit`` of ``ego4view_rw_pose3d`` (b32, 7 + 7) and
     ``ego4view_rw_pose3d_stereo_front`` (5 + 5), each taking its stage-2
     checkpoint (phase 12's, 13a's) as an EgoRear Lightning ``.ckpt``
     (:func:`write_egorear_ckpt`; the grafted leaves bitwise the
     checkpoint's), a kept step each, ``test`` from the stage-3 result as
     ``.pt`` and as ``.ckpt`` (identical metrics), and ``predict`` of the
     V = 2 yaml on the card vs ``--device cpu``.

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
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# Kernel launches per forward: the V MVFex refiners run as a loop of V
# modules, one launch each for their one layer (models/mvfex.py), then the 3
# lifting layers one each (models/pose3d.py). A CPU rehearsal, where no
# kernel launches, sets both constants to 0.
LAUNCHES_PER_REFINER, LAUNCHES_POSE3D = 1, 3


def launches_mvfex(views: int = 4) -> int:
    """Sampling-kernel launches of one forward of the V-view refiners."""
    return views * LAUNCHES_PER_REFINER


def launches_per_forward(views: int = 4) -> int:
    """Sampling-kernel launches of one V-view cascade forward."""
    return launches_mvfex(views) + LAUNCHES_POSE3D


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
PROFILED_STEPS = 3  # steps under torch.profiler after a timed run
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


def kernel_names(lazy: bool) -> tuple:
    """The forward and the backward kernel of one computation order."""
    return (("lazy_deform_sample", "lazy_deform_sample_bwd") if lazy
            else ("deform_sample", "deform_sample_bwd"))


def expected_launches(lazy: bool, forwards: int, backwards: int) -> dict:
    """Launch counts of a main-path run of ``forwards`` forwards and
    ``backwards`` backwards in one computation order: the other order's
    kernels never launch."""
    fwd, bwd = kernel_names(lazy)
    want = dict.fromkeys(KERNELS, 0)
    want[fwd] = forwards * launches_per_forward()
    want[bwd] = backwards * launches_per_forward()
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
                    launches_mvfex() if name == "mvfex" else LAUNCHES_POSE3D) * ms
            # The record: the refiner call of the bf16 training step.
            if (name == "mvfex" and dtype == torch.bfloat16 and not need_feat
                    and locs == "uniform"):
                record = dict(max_abs_err=max(abs_errs), ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
    print(f"[2b] lazy_deform_sample_bwd main path of a bf16 step "
          f"({launches_mvfex()} x MVFex without d_feat + {LAUNCHES_POSE3D} x "
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
                launches_mvfex() if name == "mvfex" else LAUNCHES_POSE3D) * ms
        if name == "mvfex" and dtype == torch.bfloat16 and locs == "uniform":
            record = dict(max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    print(f"[2d] deform_sample_bwd main path of a bf16 step ({launches_mvfex()} "
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
    proposal (of the cascade; ``model`` may be the stage-2 network alone) a
    random pose spread over the rig's field of view, and the initial heatmap
    heads a bias that puts the median peak at the 0.5 validity threshold, so
    about half the 2D anchors are valid.
    """
    for m in deform_attns(model):
        fan_in = m.sampling_offsets.weight.shape[1]
        m.sampling_offsets.weight.normal_(0.0, 2.0 * fan_in**-0.5, generator=gen)
        m.attention_weights.weight.normal_(0.0, fan_in**-0.5, generator=gen)
    hm_net = getattr(model, "heatmap_estimator", model)
    for r in hm_net.refiners:
        r.frame_feat_multi_view_pos_embed.normal_(0.0, 0.5, generator=gen)
    if hm_net is not model:
        bias = model.pose3d_estimator.mlp_pred_out.bias
        u = torch.rand(bias.numel() // 3, 3, generator=gen, device=bias.device)
        lo = torch.tensor([-60.0, -60.0, -20.0], device=bias.device)
        hi = torch.tensor([60.0, 60.0, 80.0], device=bias.device)
        bias.copy_((lo + u * (hi - lo)).reshape(-1))
    _, _, (feat_f, feat_b) = hm_net._estimator_features(img)
    peaks = hm_net._heatmaps_from_feat(feat_f, feat_b).amax(dim=(-2, -1))
    shift = 0.5 - float(peaks.median())
    for head in (m for n, m in hm_net.named_children()
                 if n.startswith("conv_heatmap_head_")):
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
          f"launches {launches[name]} = {forwards} x {launches_per_forward()} "
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


def profiled(fn, n: int):
    """torch.profiler over ``n`` calls of ``fn``: the profiler's events and
    the device's busy time per call in ms (0 when it saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return events, sum(e.self_device_time_total for e in events) / n / 1e3


def _device_table(events, busy, title, path, mode):
    """Append (or, with ``mode`` "w", write) the profiler's table by device
    time to ``path``, when the profiler saw device time."""
    if busy > 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, mode) as f:
            f.write(f"{title}\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=40))
            f.write("\n")


def profile_serving(model, rig, img, card, path: str, lazy: bool = True,
                    n: int = 3):
    """Device time by kernel over ``n`` serving forwards (torch.profiler);
    the table goes to ``path`` (the lazy order's first, then appended)."""
    tag = order_tag(4, lazy)
    with torch.inference_mode():
        events, busy = profiled(lambda: model(img, rig), n)
    _device_table(events, busy, f"{card} serving {tag}", path,
                  "w" if lazy else "a")
    if busy <= 0:
        print(f"{tag} profile: the profiler saw no device time | {card}")
        return
    name = "lazy_deform_sample" if lazy else "deform_sample"
    t = kernel_time(events, name) / n / 1e3
    print(f"{tag} profile over {n} forwards: device busy {busy:.3f} "
          f"ms/forward, {name} {t:.4f} ms/forward "
          f"({100 * t / busy:.2f}% of device time) | {card}", flush=True)


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


def compare_kernel_step(model, trainer, batch, start, want_launches):
    """One fp32 train step through the plain versions and one through the
    kernels, from the state dict ``start`` on ``batch``, the kernel step's
    ReLUs pinned to the plain step's masks (:func:`pinned_relus`); checks
    the kernel step's launches against ``want_launches``, every leaf
    gradient against TRAIN_GRAD_TOL of its scale (a leaf below the rounding
    floor against the floor), the parameters against AdamW's bound and the
    BN running stats against TRAIN_STAT_TOL. Returns both runs and the
    worst numbers."""
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
    if runs["kernel"]["launched"] != want_launches:
        raise AssertionError(f"kernel step launched {runs['kernel']['launched']}"
                             f", expected {want_launches}")
    if any(runs["plain"]["launched"].values()):
        raise AssertionError("the plain step launched a kernel")
    kink = max((f[1] for f in flips), default=0.0)
    if not kink <= FWD_TOL[torch.float32]:
        raise AssertionError(f"a ReLU input {kink:.3e} of its call's scale from "
                             f"zero changed sides (tol {FWD_TOL[torch.float32]:g})")
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
    return dict(kernel=k, plain=pl, flips=flips, masks=masks, kink=kink,
                floor=floor, n_floor=n_floor, worst_grad=worst_grad,
                worst_name=worst_name, worst_tight=worst_tight,
                worst_loose=worst_loose, stat_err=stat_err)


def perturb_train_(model, batch, gen) -> None:
    """:func:`perturb_` in train mode, so that the median initial heatmap
    peak of the training forward (BN on batch statistics) sits at the
    threshold; the BN running stats stay as they were."""
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    perturb_(model, batch["img"], gen)
    model.load_state_dict(stats, strict=False)


def perturbed_start(task, batch, gen):
    """The task's model moved off its init (:func:`perturb_train_`): the
    state dict that compared steps start from and the model's no-grad
    forward on the batch."""
    import copy

    model = task.model
    perturb_train_(model, batch, gen)
    start = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        out = task.forward(batch["img"])
    model.load_state_dict(start)
    return start, out


def partly_valid(shares: dict) -> str:
    """Fails unless every anchor share lies strictly between 0 and 1: a
    kernel-vs-plain step must cross both paths of the sampling."""
    if not all(0 < v < 1 for v in shares.values()):
        raise AssertionError(f"anchors not partly valid ({shares}): the check "
                             f"would not see the kernel")
    return " ".join(f"{k} {v:.3f}" for k, v in shares.items())


def kernel_step_text(r: dict, lazy: bool) -> str:
    """What :func:`compare_kernel_step` measured, for a phase's line."""
    k, pl = r["kernel"], r["plain"]
    fwd, bwd = kernel_names(lazy)
    return (f"loss {k['loss']:.6f} vs {pl['loss']:.6f}; worst leaf gradient "
            f"max-abs/scale {r['worst_grad']:.3e} ({r['worst_name']}, tol "
            f"{TRAIN_GRAD_TOL:g}; {r['n_floor']} leaves below the rounding "
            f"floor {r['floor']:.1e}); params after the step "
            f"{r['worst_tight']:.3e} where the gradient is determined, "
            f"{r['worst_loose']:.3e} elsewhere (Adam bound 2 lr = "
            f"{2 * pl['lr']:.1e}); BN running stats {r['stat_err']:.3e} (tol "
            f"{TRAIN_STAT_TOL:g}); ReLU inputs pinned across the kink "
            f"{sum(f[0] for f in r['flips'])} in {len(r['flips'])} of "
            f"{len(r['masks'])} calls (largest {r['kink']:.3e} of its call's "
            f"scale, tol {FWD_TOL[torch.float32]:g}); launches (fwd, bwd) "
            f"({k['launched'][fwd]}, {k['launched'][bwd]})")


def phase_train_check(card, lazy: bool = True):
    """One fp32 train step through the plain versions vs one through the
    kernels, from the same state on the same batch, the kernel step's ReLUs
    pinned to the plain step's masks (:func:`pinned_relus`)."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    task, trainer = entry.build_train((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32",
                                      seed=0, steps_per_epoch=1, warmup_iters=1,
                                      lazy_deform=lazy, imagenet=False)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(4)
    batch = train_batch(TRAIN_BATCH, TRAIN_SIZE, gen)
    start, (preds, hms) = perturbed_start(task, batch, gen)
    anchors = partly_valid({
        "2D": float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean()),
        "3D": float(task.rig.project(preds[0])[1].float().mean())})
    r = compare_kernel_step(task.model, trainer, batch, start,
                            expected_launches(lazy, 1, 1))
    print(f"{order_tag(5, lazy)} flagship {TRAIN_SIZE}px B={TRAIN_BATCH} fp32 "
          f"{'lazy' if lazy else 'reference'} order train step kernel vs plain: "
          f"{kernel_step_text(r, lazy)}; valid anchors {anchors} | {card}",
          flush=True)


# The launch function behind each kernel's wrapper in
# egorear_tpu_torch.ops.deform_attn (the autograd nodes look it up at every
# call), and the names of its outputs.
LAUNCHERS = {"lazy_deform_sample": "_forward_kernel",
             "lazy_deform_sample_bwd": "_backward_kernel",
             "deform_sample": "_sampling_kernel",
             "deform_sample_bwd": "_sampling_backward_kernel"}
OUTPUTS = {"lazy_deform_sample": ("s_feat", "s_pos", "s_one"),
           "lazy_deform_sample_bwd": ("d_feat", "d_loc", "d_attn_w", "d_pos"),
           "deform_sample": ("out",),
           "deform_sample_bwd": ("d_value", "d_loc", "d_attn_w")}


@contextlib.contextmanager
def kept_kernel_calls(calls: list):
    """Inside the block every kernel launch also appends (kernel, a copy of
    its arguments, a copy of its outputs) to ``calls``; the launch is the
    same call and counts as before. Copies, because an argument may be a
    parameter that the optimizer then updates in place (the refiners' pos
    tables) and an output may become a ``.grad`` that clipping scales; an
    argument that several launches share is copied once."""
    from egorear_tpu_torch.ops import deform_attn as da

    launchers = {name: getattr(da, fn) for name, fn in LAUNCHERS.items()}
    copies = {}  # id -> (tensor, copy): holding the tensor keeps its id unique

    def copy_of(t):
        if not isinstance(t, torch.Tensor):
            return t
        if id(t) not in copies:
            copies[id(t)] = (t, t.detach().clone())
        return copies[id(t)][1]

    def keep(name, launch):
        def kept(*args):
            out = launch(*args)
            outs = out if isinstance(out, tuple) else (out,)
            calls.append((name, tuple(copy_of(a) for a in args),
                          tuple(o.detach().clone() if o is not None else None
                                for o in outs)))
            return out
        return kept

    for name, launch in launchers.items():
        setattr(da, LAUNCHERS[name], keep(name, launch))
    try:
        yield
    finally:
        for name, launch in launchers.items():
            setattr(da, LAUNCHERS[name], launch)


def plain_call(name: str, args: tuple) -> tuple:
    """The plain version of kernel ``name`` on the arguments its launch
    took, in fp32 on the same (possibly bf16) inputs; outputs in the
    kernel's order (:data:`OUTPUTS`)."""
    from egorear_tpu_torch.ops import deform_attn as da

    f32 = lambda t: t.float() if t is not None else None  # noqa: E731
    if name == "lazy_deform_sample":
        feat, loc, attn_w, pos, block = args
        return da.lazy_deform_sample_plain(feat.float(), loc, attn_w, f32(pos),
                                           block)
    if name == "lazy_deform_sample_bwd":
        feat, loc, attn_w, pos, block, g_feat, g_pos, g_one, need_feat, need_pos = args
        return da.lazy_deform_sample_backward_plain(
            feat.float(), loc, attn_w, f32(pos), block, g_feat.float(), f32(g_pos),
            g_one.float(), need_feat, need_pos)
    if name == "deform_sample":
        value, loc, attn_w = args
        return (da.deformable_sampling_plain(value.float(), loc, attn_w),)
    value, loc, attn_w, g, need_value = args
    return da.deformable_sampling_backward_plain(value.float(), loc, attn_w,
                                                 g.float(), need_value)


def call_shape(name: str, args: tuple) -> str:
    """The shape of one launch, as the kernel phases print it."""
    if name.startswith("lazy"):
        feat, attn_w, pos = args[0], args[2], args[3]
        B, Q, nh, P = attn_w.shape
        side = int(feat.shape[1] ** 0.5)
        text = (f"B={B} Q={Q} nh={nh} P={P} {side}x{side} Cin={feat.shape[2]} "
                f"C={pos.shape[-1] if pos is not None else 0}")
        return text + (f" d_feat={'yes' if args[8] else 'no'}"
                       if name.endswith("_bwd") else "")
    value, attn_w = args[0], args[2]
    return (f"{'x'.join(str(n) for n in value.shape)} Q={attn_w.shape[1]} "
            f"P={attn_w.shape[3]}")


def hold_kept_calls(calls: list, tag: str, card: str) -> None:
    """Each kept launch (:func:`kept_kernel_calls`) against its plain
    version on the same inputs (:func:`plain_call`): every output within
    FWD_TOL (forward kernels) or BWD_TOL (backward kernels) of its dtype
    times that output's largest plain value. Prints one line per kernel,
    shape and dtype; fails at the first output out of tolerance, and when
    an output is zero in every launch of a line (the check would not see
    the kernel)."""
    worst = {}  # (name, shape, dtype) -> [launches, worst max-abs/scale, tol,
    #                                   largest scale of each output]
    for name, args, got in calls:
        dtype, shape = args[0].dtype, call_shape(name, args)
        tol = (BWD_TOL if name.endswith("_bwd") else FWD_TOL)[dtype]
        want = plain_call(name, args)
        row = worst.setdefault((name, shape, dtype), [0, 0.0, tol, {}])
        row[0] += 1
        for out, g, w in zip(OUTPUTS[name], got, want, strict=True):
            if (g is None) != (w is None):
                raise AssertionError(f"{tag} {name} {shape}: {out} from only one "
                                     f"of kernel and plain version")
            if w is None:
                continue
            scale = float(w.float().abs().max())
            err = float((g.float() - w.float()).abs().max())
            if not err <= tol * scale:
                raise AssertionError(f"{tag} {name} {str(dtype)[6:]} {shape}: "
                                     f"{out} max-abs {err:.3e} > {tol:g} x "
                                     f"{scale:.3e}")
            row[1] = max(row[1], err / scale if scale > 0 else 0.0)
            row[3][out] = max(row[3].get(out, 0.0), scale)
        del want
    for (name, shape, dtype), (n, rel, tol, scales) in worst.items():
        print(f"{tag} {name} {str(dtype)[6:]} {shape}: {n} launches of the "
              f"step vs the plain version on their inputs, worst "
              f"max-abs/scale {rel:.3e} (tol {tol:g}; largest plain value "
              + ", ".join(f"{out} {v:.2e}" for out, v in scales.items())
              + f") | {card}", flush=True)
        zero = [out for out, v in scales.items() if not v > 0]
        if zero:
            raise AssertionError(f"{tag} {name} {shape}: {zero} zero in every "
                                 f"launch: the check would not see the kernel")


def kept_step(task, trainer, batch, gen, want: dict, tag: str, card: str) -> dict:
    """One train step of the model moved off its init
    (:func:`perturb_train_`: at the init the anchors are invalid and the
    refiners' sampling gets no gradient), its launches counted from 0 (they
    must equal ``want``) and kept, each then held against its plain version
    at the shapes and on the values the step gave it
    (:func:`hold_kept_calls`). Returns the step's metrics."""
    perturb_train_(task.model, batch, gen)
    calls = []
    reset_launches()
    with kept_kernel_calls(calls):
        metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    launched = read_launches()
    if launched != want:
        raise AssertionError(f"{tag} the step launched {launched}, expected {want}")
    kept = {name: sum(c[0] == name for c in calls) for name in KERNELS}
    if kept != launched:
        raise AssertionError(f"{tag} kept {kept} of the launches {launched}")
    hold_kept_calls(calls, tag, card)
    return metrics


def train_run(trainer, batch, loss_key: str, warmup: int, timed: int,
              n_profiled: int = 0) -> dict:
    """``warmup`` + ``timed`` steps on one fixed batch, the launch counts
    from 0 over these, then ``n_profiled`` steps under torch.profiler
    (:func:`profiled`). Fails unless the loss is finite and falls over the
    timed steps."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [trainer.train_step(batch)[loss_key] for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(trainer.train_step(batch)[loss_key])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / timed * 1e3
    launches = read_launches()
    losses = [float(x) for x in losses]
    first, last = losses[warmup], losses[-1]
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"loss not finite and falling: {losses}")
    run = dict(ms=ms, first=first, last=last, launches=launches,
               warmup=warmup, timed=timed, steps=warmup + timed,
               peak=torch.cuda.max_memory_allocated() / 2**30,
               profiled=n_profiled, events=None, busy=0.0)
    if n_profiled:
        run["events"], run["busy"] = profiled(lambda: trainer.train_step(batch),
                                              n_profiled)
    return run


def run_line(run: dict, B: int, kernels: tuple = ()) -> str:
    """A timed run (:func:`train_run`) for a phase's line: host-clock
    ms/step and samples/s, peak memory, and when it was profiled the
    device's busy time per step, its idle share against the timed steps'
    own ms/step, and the time of ``kernels`` (all __global__ functions of
    each source)."""
    ms = run["ms"]
    busy = ""
    if run["profiled"] and run["busy"] <= 0:
        busy = ", device busy not measured (the profiler saw no device time)"
    elif run["profiled"]:
        idle = 1 - run["busy"] / ms
        busy = (f", device busy {run['busy']:.3f} ms/step over {run['profiled']} "
                f"steps under the profiler: idle "
                + (f"{100 * idle:.1f} %" if idle >= 0 else
                   f"0 % (busy {-100 * idle:.1f} % above the timed step: "
                   f"device-bound)")
                + " of the timed step")
        for name in kernels:
            t = kernel_time(run["events"], name) / run["profiled"] / 1e3
            busy += (f", {name}.cu {t:.4f} ms/step ({100 * t / run['busy']:.2f} "
                     f"% of device time)")
    return (f"{ms:.3f} ms/step (host clock, {run['timed']} steps after "
            f"{run['warmup']} warm-up, one fixed batch), {B * 1e3 / ms:.2f} "
            f"samples/s, peak {run['peak']:.2f} GiB{busy}; loss "
            f"{run['first']:.4f} -> {run['last']:.4f}")


def phase_train(card, profile: str | None, lazy: bool = True):
    """Train the flagship as users would, then hold one more step's kernel
    launches against their plain versions (:func:`kept_step`); returns the
    kernel launch counts of the main path."""
    from egorear_tpu_torch import entry

    # The flagship schedule as configured, warmup 500 included: without the
    # warmup, lr 1e-3 from step 1 overshoots on one fixed random batch (the
    # loss fell for 2 steps, then rose to 1.9x its start on the H100).
    task, trainer = entry.build_train((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE,
                                      "bf16-mixed", seed=0, steps_per_epoch=1000,
                                      lazy_deform=lazy, imagenet=False)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(5)
    batch = train_batch(TRAIN_B, TRAIN_SIZE, gen)
    run = train_run(trainer, batch, "loss_total", TRAIN_WARMUP, TRAIN_TIMED,
                    PROFILED_STEPS if profile else 0)
    launches, steps = run["launches"], run["steps"]
    want = expected_launches(lazy, steps, steps)
    if launches != want:
        raise AssertionError(f"{steps} train steps launched {launches}, "
                             f"expected {want}")
    tag = order_tag(6, lazy)
    fwd, bwd = kernel_names(lazy)
    print(f"{tag} train flagship {TRAIN_SIZE}px bf16-mixed "
          f"{'lazy' if lazy else 'reference'} order B={TRAIN_B} (lr "
          f"{trainer.lr:g} warmed over {trainer.warmup_iters} steps): "
          f"{run_line(run, TRAIN_B, (fwd, bwd))}; launches {fwd} "
          f"{launches[fwd]}, {bwd} {launches[bwd]} = {steps} x "
          f"{launches_per_forward()}, other kernels 0 | {card}", flush=True)
    if profile:
        _device_table(run["events"], run["busy"], f"{card} training {tag}",
                      profile, "a")
    kept_step(task, trainer, batch, gen, expected_launches(lazy, 1, 1), tag, card)
    return launches


# Stages 1 and 2 as configs/ego4view_syn_heatmap_*.yaml train them: 256 px,
# batch 64, fp32 (TF32 off, as every phase here), the yamls' schedule; then
# one b32 fp32 stage-3 step after the stage-2 graft. Each timed run is
# followed by a few steps under torch.profiler for the device's busy time.
STAGE_B, STAGE3_B = 64, 32
IMAGENET_ENV = "EGOREAR_IMAGENET_RESNET18"
GRAFT_KEYS = {"front": "heatmap_estimator_pretrained_stereo_front",
              "back": "heatmap_estimator_pretrained_stereo_back"}


@contextlib.contextmanager
def env_var(name: str, value: str):
    """``os.environ[name] = value`` inside the block only."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def write_imagenet_weights(path: str, seed: int = 0) -> None:
    """Seeded random ResNet-18 weights in torchvision's key layout (with its
    classifier and BN counters), saved as a ``.pth`` state dict: the stand-in
    for the ImageNet weights, which the repository does not hold."""
    from egorear_tpu_torch.models.backbone import ResNet18

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, v in ResNet18().state_dict().items():
        leaf = key.rsplit(".", 1)[1]
        k = re.sub(r"^layer(\d)_(\d)\.", r"layer\1.\2.", key)
        k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                 "downsample.1")
        if leaf == "num_batches_tracked":
            sd[k] = torch.tensor(0)
        elif leaf == "running_var":
            sd[k] = 0.5 + torch.rand(v.shape, generator=gen)
        elif v.dim() == 4:  # conv kernels: LeCun normal
            sd[k] = torch.randn(v.shape, generator=gen) * v[0].numel() ** -0.5
        else:  # BN: scale near 1, shift and running mean near 0
            sd[k] = (torch.randn(v.shape, generator=gen) * 0.1
                     + (1.0 if leaf == "weight" else 0.0))
    sd["fc.weight"] = torch.randn(1000, 512, generator=gen) * 512 ** -0.5
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)


# EgoRear's module paths for the port's: (the start of the port's key, the
# reference's, whether the port holds the reference's 1x1 conv (out, in, 1,
# 1) as a Linear (out, in) weight), tried in order within a subtree.
_EGOREAR_BLOCK = [(r"(conv|bn)([12])\.", r"\1\2.", False),
                  (r"downsample_conv\.", "downsample.0.", False),
                  (r"downsample_bn\.", "downsample.1.", False)]
_EGOREAR_HEATMAP_NET = [
    (r"encoder\.resnet\.conv1\.", "encoder.backbone.layer_s2.0.", False),
    (r"encoder\.resnet\.bn1\.", "encoder.backbone.layer_s2.1.", False),
    (r"encoder\.fpn\.(lateral|fuse|fpn)_(\d+)\.", r"encoder.neck.\1_convs.\2.0.", False),
    (r"conv_heatmap\.", "conv_heatmap.", False),
]
_EGOREAR_TRANSFORMER = [(r"(cross_attn|spatial_attn)\.(\w+)\.", r"\1.\2.", False),
                        (r"(fuse_mlp|norm_cross|norm_spatial|norm_ffn)\.", r"\1.", False)]
_EGOREAR_REFINER = [
    (r"heatmap_proj_0\.", "heatmap_proj.0.", False),
    (r"heatmap_proj_1\.", "heatmap_proj.2.", False),
    (r"fc_bfb\.", "fc_bfb.", False),
    (r"fc_query\.", "fc_query.0.", False),
    (r"joint_query_embed$", "joint_query_embed.weight", False),
    (r"frame_feat_multi_view_pos_embed$", "frame_feat_multi_view_pos_embed", False),
    (r"frame_feat_multi_view_proj\.", "frame_feat_multi_view_proj.", True),
    (r"ff_proj_0\.", "frame_feat_proj_layers.0.", True),
    (r"ff_proj_1\.", "frame_feat_proj_layers.2.", False),
    (r"ff_proj_2\.", "frame_feat_proj_layers.4.", True),
    (r"post_norm_(\d+)\.", r"post_norm.\1.", False),
    (r"head_(\d+)\.Conv_0\.", r"head_layers.\1.head.0.", True),
    (r"head_(\d+)\.Conv_1\.", r"head_layers.\1.head.3.", True),
    (r"ff_refined_proj_(\d+)_0\.", r"frame_feat_refined_proj_layers.\1.0.", True),
    (r"ff_refined_proj_(\d+)_1\.", r"frame_feat_refined_proj_layers.\1.3.", True),
    (r"conv_hm_(\d+)_0\.", r"conv_heatmap_layers.\1.0.", False),
    (r"conv_hm_(\d+)_1\.", r"conv_heatmap_layers.\1.2.", True),
    (r"conv_hm_(\d+)_2\.", r"conv_heatmap_layers.\1.5.", True),
    (r"conv_hm_(\d+)_3\.", r"conv_heatmap_layers.\1.7.", True),
]
_EGOREAR_POSE3D = [
    (r"feat_proj\.", "feat_proj.", True),
    (r"post_norm_(\d+)\.", r"post_norm.\1.", False),
    (r"query_gen_(\d)\.", lambda m: f"query_gen_mlp.{2 * int(m[1])}.", False),
    (r"conv_ff_(\d)\.", lambda m: f"conv_frame_feat.{(0, 2, 5, 7)[int(m[1])]}.", False),
    (r"mlp_pred_(\d+)\.", r"mlp_pred.\1.0.", False),
    (r"reg_mlp_(\d+)_(\d+)\.", lambda m: f"reg_mlp.{m[1]}.{2 * int(m[2])}.", False),
]
EGOREAR_REFINERS = ("heatmap_refiner_front_left", "heatmap_refiner_front_right",
                    "heatmap_refiner_back_left", "heatmap_refiner_back_right")


def _egorear_rule(rules, key: str):
    """The reference's key of ``key`` by the first rule whose pattern
    matches its start, and whether the rule adds the 1x1 conv axes."""
    for pattern, repl, conv1x1 in rules:
        m = re.match(pattern, key)
        if m:
            head = repl(m) if callable(repl) else m.expand(repl)
            return head + key[m.end():], conv1x1
    raise KeyError(key)


def egorear_state_dict(sd: dict, task_name: str) -> dict:
    """The port's state dict ``sd`` of a ``task_name`` network
    (``heatmap``, ``heatmap_mvf_ex`` or ``pose_3d_mvf_ex``) under EgoRear's
    module paths and layouts, as a reference Lightning checkpoint holds it
    (before its ``network.`` prefix): the inverse of the key grammar of
    ``egorear_tpu_torch/train/torch_convert.py``. Test scaffolding: it
    stands in for EgoRear's released checkpoints, which the repository does
    not hold."""

    def count(pattern):  # entries of sd whose key matches ``pattern``
        return sum(1 for k in sd if re.fullmatch(pattern, k))

    def heatmap_net(key):
        m = re.match(r"encoder\.resnet\.layer(\d)_(\d)\.", key)
        if m:
            stage = ("layer_s4.1", "layer_s8", "layer_s16", "layer_s32")[int(m[1]) - 1]
            rest, _ = _egorear_rule(_EGOREAR_BLOCK, key[m.end():])
            return f"encoder.backbone.{stage}.{m[2]}.{rest}", False
        return _egorear_rule(_EGOREAR_HEATMAP_NET, key)

    def module(base, key, rules, layers):
        """A refiner's or the lifter's key (``base`` + ``key``): its
        transformer layers, the Sequentials whose last Linear has no ``.0``,
        then ``rules``."""
        m = re.match(r"transformer_(\d+)\.ffn\.Dense_(\d+)\.", key)
        if m:
            last = count(re.escape(f"{base}transformer_{m[1]}.ffn.") + r"Dense_\d+\.weight") - 1
            inner = "" if int(m[2]) == last else "0."
            return f"{layers}.{m[1]}.ffn.layers.{m[2]}.{inner}{key[m.end():]}", False
        m = re.match(r"transformer_(\d+)\.", key)
        if m:
            rest, _ = _egorear_rule(_EGOREAR_TRANSFORMER, key[m.end():])
            return f"{layers}.{m[1]}.{rest}", False
        if key.startswith("mlp_pred_out."):
            n = count(re.escape(base) + r"mlp_pred_\d+\.weight")
            return f"mlp_pred.{n}.{key[len('mlp_pred_out.'):]}", False
        m = re.match(r"reg_mlp_(\d+)_out\.", key)
        if m:
            n = count(re.escape(base) + rf"reg_mlp_{m[1]}_\d+\.weight")
            return f"reg_mlp.{m[1]}.{2 * n}.{key[m.end():]}", False
        return _egorear_rule(rules, key)

    def mvfex_key(base, key):
        m = re.match(r"heatmap_estimator_stereo_(front|back)\.", key)
        if m:
            rest, conv1x1 = heatmap_net(key[m.end():])
            return m[0] + rest, conv1x1
        m = re.match(r"conv_heatmap_head_(front|back)\.Conv_(\d)\.", key)
        if m:
            idx = (0, 2, 4, 7, 9)[int(m[2])]
            return f"conv_heatmap_layers_stereo_{m[1]}.{idx}.{key[m.end():]}", False
        m = re.match(r"refiners\.(\d+)\.", key)
        if m:
            rest, conv1x1 = module(f"{base}{m[0]}", key[m.end():], _EGOREAR_REFINER,
                                   "transformer_layers")
            return f"{EGOREAR_REFINERS[int(m[1])]}.{rest}", conv1x1
        raise KeyError(base + key)

    out = {}
    for key, v in sd.items():
        if task_name == "heatmap":
            new, conv1x1 = heatmap_net(key)
        elif task_name == "heatmap_mvf_ex":
            new, conv1x1 = mvfex_key("", key)
        elif task_name == "pose_3d_mvf_ex" and key.startswith("heatmap_estimator."):
            new, conv1x1 = mvfex_key("heatmap_estimator.", key[len("heatmap_estimator."):])
            new = "heatmap_estimator." + new
        elif task_name == "pose_3d_mvf_ex" and key.startswith("pose3d_estimator."):
            base = "pose3d_estimator."
            new, conv1x1 = module(base, key[len(base):], _EGOREAR_POSE3D, "layers")
            new = base + new
        else:
            raise KeyError(f"{task_name}: {key}")
        out[new] = v[:, :, None, None] if conv1x1 and new.endswith(".weight") else v
    return out


def write_egorear_ckpt(path: str, sd: dict, task_name: str,
                       prefix: str = "network._orig_mod.") -> str:
    """Write the port's state dict ``sd`` as an EgoRear Lightning checkpoint
    (:func:`egorear_state_dict` under ``prefix``, in ``{"state_dict":
    ...}``, CPU tensors); returns ``path``."""
    ref = egorear_state_dict({k: v.detach().cpu() for k, v in sd.items()}, task_name)
    torch.save({"state_dict": {prefix + k: v.contiguous() for k, v in ref.items()},
                "epoch": 0, "global_step": 0}, path)
    return path


def stage_batch(B, views, size, gen):
    """A seeded stage-1/2 batch: ``views`` views of ``size`` px and 15-joint
    per-view heatmaps at 1/4 resolution."""
    h = size // 4
    return {"img": torch.randn(B, views, 3, size, size, generator=gen,
                               device=TRAIN_DEVICE),
            "gt_heatmap": torch.rand(B, views, 15, h, h, generator=gen,
                                     device=TRAIN_DEVICE)}


def phase_stage1(card, workdir: str, weights: dict, rates: dict) -> dict:
    """Stage 1 of each stereo pair as the yamls train it: the ImageNet
    initialisation checked leaf by leaf, b64 fp32 training, a checkpoint.
    Returns the checkpoint of each pair; puts each pair's samples/s in
    ``rates``."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.train import checkpoint

    ckpts = {}
    for pair, seed in (("front", 1), ("back", 2)):
        task, trainer = entry.build_stage1(TRAIN_DEVICE, seed=seed,
                                           steps_per_epoch=1000)
        seeded, _ = entry.build_stage1(TRAIN_DEVICE, seed=seed, steps_per_epoch=1000,
                                       imagenet=False)
        base = seeded.model.state_dict()
        n_resnet = 0
        for k, v in task.model.state_dict().items():
            if k.startswith("encoder.resnet.") and "num_batches" not in k:
                want = weights[k[len("encoder.resnet."):]]
                n_resnet += 1
            else:
                want = base[k]
            if not torch.equal(v, want.to(v.device)):
                raise AssertionError(f"stage 1 {pair}: {k} is not the "
                                     f"{'ImageNet file' if 'resnet' in k else 'seeded init'}'s")
        if n_resnet != len(weights):
            raise AssertionError(f"{n_resnet} ImageNet leaves, the file has {len(weights)}")
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(10 + seed)
        run = train_run(trainer, stage_batch(STAGE_B, 2, TRAIN_SIZE, gen),
                        "heatmap_loss", TRAIN_WARMUP, TRAIN_TIMED, PROFILED_STEPS)
        if any(run["launches"].values()):
            raise AssertionError(f"stage 1 launched a sampling kernel: {run['launches']}")
        ckpts[pair] = checkpoint.save(os.path.join(workdir, f"stage1_{pair}"), 0,
                                      trainer.state_dict())
        rates[f"stage1_{pair}"] = STAGE_B * 1e3 / run["ms"]
        print(f"[8] stage 1 stereo {pair} {TRAIN_SIZE}px B={STAGE_B} fp32: "
              f"ImageNet init {n_resnet} resnet leaves bitwise the file's, the "
              f"FPN and head the seeded init's; {run_line(run, STAGE_B)}; "
              f"checkpoint saved | {card}", flush=True)
    return ckpts


def stage2_launches(steps: int) -> dict:
    """Launch counts of ``steps`` stage-2 steps: the lazy forward and its
    backward once per refiner (4 views, one layer), nothing else."""
    want = dict.fromkeys(KERNELS, 0)
    want["lazy_deform_sample"] = want["lazy_deform_sample_bwd"] = steps * launches_mvfex()
    return want


def phase_stage2_check(card):
    """One fp32 stage-2 step (256 px, b2) through the kernels vs one through
    the plain versions from the same state, ReLUs pinned as in phase 5."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    task, trainer = entry.build_stage2((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE,
                                       seed=0, steps_per_epoch=1, warmup_iters=1,
                                       imagenet=False)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(6)
    batch = stage_batch(TRAIN_BATCH, 4, TRAIN_SIZE, gen)
    start, (hms, _) = perturbed_start(task, batch, gen)
    anchors = partly_valid({
        "2D": float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean())})
    r = compare_kernel_step(task.model, trainer, batch, start, stage2_launches(1))
    print(f"[9] stage 2 {TRAIN_SIZE}px B={TRAIN_BATCH} fp32 train step kernel vs "
          f"plain: {kernel_step_text(r, True)}; valid anchors {anchors} | {card}",
          flush=True)


def phase_stage2(card, workdir: str, stage1: dict, rates: dict):
    """Stage 2 as the yaml trains it: the ImageNet initialisation, then both
    stage-1 checkpoints grafted (checked leaf by leaf), b64 fp32 training
    with 4 + 4 lazy launches a step, one more step whose launches are held
    against their plain versions at B = 256 (:func:`kept_step`), a
    checkpoint. Returns the checkpoint and the launch counts; puts the
    samples/s in ``rates``."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.train import checkpoint

    task, trainer = entry.build_stage2((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE,
                                       seed=3, steps_per_epoch=1000)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    done = checkpoint.apply_pretrained(
        task.model, task.name, {GRAFT_KEYS[p]: stage1[p] for p in ("front", "back")})
    if done != [GRAFT_KEYS["front"], GRAFT_KEYS["back"]]:
        raise AssertionError(f"grafted {done}")
    after = task.model.state_dict()
    n_grafted = 0
    for pair in ("front", "back"):
        saved = checkpoint.restore(stage1[pair], map_location=TRAIN_DEVICE)["model"]
        got = checkpoint.sub_state(after, f"heatmap_estimator_stereo_{pair}")
        if sorted(got) != sorted(k for k in saved if not k.startswith("conv_heatmap.")):
            raise AssertionError(f"stage-2 {pair} estimator keys differ from the "
                                 f"stage-1 checkpoint's")
        for k, v in got.items():
            if not torch.equal(v, saved[k]):
                raise AssertionError(f"grafted {pair} {k} differs from the checkpoint")
        n_grafted += len(got)
    for k, v in after.items():
        if not k.startswith("heatmap_estimator_stereo_") and not torch.equal(v, before[k]):
            raise AssertionError(f"the graft changed {k}")
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(13)
    batch = stage_batch(STAGE_B, 4, TRAIN_SIZE, gen)
    run = train_run(trainer, batch, "loss_total", TRAIN_WARMUP, TRAIN_TIMED,
                    PROFILED_STEPS)
    want = stage2_launches(run["steps"])
    if run["launches"] != want:
        raise AssertionError(f"{run['steps']} stage-2 steps launched "
                             f"{run['launches']}, expected {want}")
    print(f"[10] stage 2 {TRAIN_SIZE}px B={STAGE_B} fp32 (kernel batch "
          f"{4 * STAGE_B}): ImageNet init, then both stage-1 checkpoints grafted "
          f"({n_grafted} leaves bitwise, every other leaf unchanged); "
          f"{run_line(run, STAGE_B, kernel_names(True))}; launches "
          f"lazy_deform_sample {run['launches']['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {run['launches']['lazy_deform_sample_bwd']} = "
          f"{run['steps']} x {launches_mvfex()}, per-head kernels 0; checkpoint "
          f"saved | {card}", flush=True)
    ckpt = checkpoint.save(os.path.join(workdir, "stage2"), 0, trainer.state_dict())
    rates["stage2"] = STAGE_B * 1e3 / run["ms"]
    kept_step(task, trainer, batch, gen, stage2_launches(1), "[10]", card)
    return ckpt, run["launches"]


def phase_stage3_graft(card, stage2: str):
    """The stage-2 checkpoint grafted into stage 3 (ImageNet init first, as
    the pose3d yaml asks), checked leaf by leaf; one b32 fp32 step with 7 + 7
    launches, each held against its plain version (:func:`kept_step`), and
    a finite loss."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.train import checkpoint

    task, trainer = entry.build_train(
        (TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32", seed=4, steps_per_epoch=1000,
        pretrained={"heatmap_estimator_mvf_pretrained": stage2})
    saved = checkpoint.restore(stage2, map_location=TRAIN_DEVICE)["model"]
    got = checkpoint.sub_state(task.model.state_dict(), "heatmap_estimator")
    if sorted(got) != sorted(saved):
        raise AssertionError("stage-3 heatmap_estimator keys differ from the "
                             "stage-2 checkpoint's")
    for k, v in got.items():
        if not torch.equal(v, saved[k]):
            raise AssertionError(f"grafted heatmap_estimator.{k} differs")
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(14)
    batch = train_batch(STAGE3_B, TRAIN_SIZE, gen)
    want = expected_launches(True, 1, 1)
    loss = float(kept_step(task, trainer, batch, gen, want, "[11]",
                           card)["loss_total"])
    if not math.isfinite(loss):
        raise AssertionError(f"stage-3 loss {loss}")
    print(f"[11] stage 3 {TRAIN_SIZE}px B={STAGE3_B} fp32 from the stage-2 "
          f"checkpoint: heatmap_estimator {len(got)} leaves bitwise the "
          f"checkpoint's; one step, loss {loss:.4f}, launches lazy_deform_sample "
          f"{want['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{want['lazy_deform_sample_bwd']} | {card}", flush=True)


# Phase 12: the CLI (``egorear_tpu_torch.run.main``) on the shipped yamls,
# at full width, on a synthetic syn tree at the dataset's geometry (872-px
# JPEGs with the joints drawn in, precomputed heatmaps): 128 train frames
# (stage 1: 256 items, 4 steps at b64; stage 2: 2 steps at b64; stage 3: 4
# steps at b32) and 6 validation and test frames (one padded batch).
CLI_TRAIN_FRAMES, CLI_EVAL_FRAMES, CLI_PREDICT_B = 128, 6, 4
CLI_IMAGE_SIZE = 872
CLI_FIXED_STEPS = 3  # steps on one batch already on the card, per stage
CLI_OVERRIDES: list = []  # a CPU rehearsal may add --model.batch_size
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
POSE_METRICS = [f"{s}_{m}" for s in ("final", "proposal")
                for m in ("auc_3d", "mpjpe", "pa_mpjpe", "pck_3d")]


def cli_run(argv: list):
    """``run.main(argv)`` with the kernel launch counts from 0 over it;
    returns its result, the counts and what it printed."""
    import io

    from egorear_tpu_torch import run

    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        result = run.main(argv)
    torch.cuda.synchronize()
    return result, read_launches(), out.getvalue()


def cli_launches(forwards: int, backwards: int, per: int) -> dict:
    want = dict.fromkeys(KERNELS, 0)
    want["lazy_deform_sample"] = forwards * per
    want["lazy_deform_sample_bwd"] = backwards * per
    return want


def fixed_batch_rate(trainer, batch: dict) -> float:
    """Samples/s of ``CLI_FIXED_STEPS`` train steps on one batch already on
    the card (no loader), after the fit: the same trainer's step alone."""
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CLI_FIXED_STEPS):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    n = next(iter(batch.values())).shape[0]
    return n * CLI_FIXED_STEPS / (time.perf_counter() - t0)


def cli_fit(card, name: str, root: str, workdir: str, n_items: int,
            per: int, extra: list, synthetic: float | None, tag: str = "[12]"):
    """``fit`` of one yaml for one epoch over ``n_items`` train items: its
    metrics.csv, finite losses, ``epoch=0.pt``, at least 2 steps, the lazy
    launches (``per`` each way a step, ``per`` forwards for the one
    validation batch); prints the epoch's samples/s through the loader
    beside the same step's on one batch on the card (their ratio is the
    loader-bound share) and ``synthetic`` (the phase-8/10 rate). Returns the
    checkpoint, the launch counts, the trainer and that batch."""
    import csv

    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.data.loader import DataLoader

    yaml_path = os.path.join(CONFIGS, f"{name}.yaml")
    overrides = ["--model.data_root", root, "--trainer.max_epochs", "1",
                 "--trainer.save_dir", os.path.join(workdir, "cli", name),
                 "--device", TRAIN_DEVICE] + extra + CLI_OVERRIDES
    trainer, launched, _ = cli_run(["fit", "--config", yaml_path] + overrides)
    (_, steps, seconds), = trainer.epoch_times
    want_steps = n_items // trainer.batch_size
    want = cli_launches(steps + 1, steps, per)
    if steps != want_steps or steps < 2 or launched != want:
        raise AssertionError(f"{tag} {name}: {steps} steps launched {launched}, "
                             f"expected {want_steps} >= 2 steps and {want}")
    with open(trainer.logger.path) as f:
        rows = list(csv.DictReader(f))
    key = "train/loss_total" if "train/loss_total" in rows[0] else "train/heatmap_loss"
    losses = [float(r[key]) for r in rows if r[key]]
    ckpt = os.path.join(trainer.logger.dir, "checkpoints", "epoch=0.pt")
    if not (losses and all(math.isfinite(x) for x in losses)
            and any(v for k, v in rows[-1].items() if k.startswith("val/"))
            and os.path.exists(ckpt)):
        raise AssertionError(f"{tag} {name}: losses {losses}, rows {len(rows)}, "
                             f"checkpoint {os.path.exists(ckpt)}")
    B = trainer.batch_size
    (train_ds,) = run._datasets(load_config(yaml_path, overrides).init_args,
                                ("train",))
    batch = {k: v for k, v in next(iter(DataLoader(train_ds, B, device=TRAIN_DEVICE))
                                   ).items() if torch.is_tensor(v)}
    fixed = fixed_batch_rate(trainer, batch)
    through = steps * B / seconds
    # Phase 8's stage-1 samples hold both views of a pair; the dataset's
    # items hold one, so the share is taken against the same step here.
    against = (f", phase 8/10's synthetic b64 {synthetic:.1f} samples/s"
               if synthetic else "")
    print(f"{tag} fit {name} B={B}: {steps} steps in {seconds:.3f} s through the "
          f"loader ({through:.1f} samples/s, {1e3 * seconds / steps:.1f} ms/step, "
          f"first step included), one batch on the card {fixed:.1f} samples/s "
          f"({B * 1e3 / fixed:.1f} ms/step){against}; loader-bound share "
          f"{100 * max(0.0, 1 - through / fixed):.1f} %; launches lazy_deform_sample "
          f"{launched['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{launched['lazy_deform_sample_bwd']} = ({steps} steps + 1 val batch) "
          f"x {per}, {steps} x {per}; {key} at the epoch's end {losses[-1]:.4f} "
          f"| {card}", flush=True)
    return ckpt, launched, trainer, batch


def phase_cli(card, workdir: str, rates: dict) -> dict:
    """The CLI chain on the card: a synthetic tree, stage 1 ``fit`` of both
    pairs (from the seeded "ImageNet" weights), stage 2 grafted from both,
    stage 3 grafted from stage 2, then ``test``, ``validate`` and
    ``predict`` on the stage-3 checkpoint, ``predict`` also with ``--device
    cpu`` (the plain versions) and held to the card's within phase 3's
    tolerance; every run's lazy launches exact. Returns the launch counts
    summed over the chain."""
    import numpy as np

    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.data.datasets import get_dataset
    from egorear_tpu_torch.data.loader import DataLoader
    from egorear_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    root = make_synthetic_dataset(
        os.path.join(workdir, "ego4view_syn"), frames_per_seq=CLI_TRAIN_FRAMES,
        eval_frames_per_seq=CLI_EVAL_FRAMES, image_size=CLI_IMAGE_SIZE,
        write_heatmaps=True,
        draw_pose=True, seed=0)
    t_tree = time.perf_counter() - t0

    # Decode rate: one pass of the stage-2/3 train set (4 views a frame)
    # through the loader with the yamls' 16 workers, pinned to the card.
    ds = get_dataset("ego4view_syn_heatmap_mvf", root, "train")
    t1 = time.perf_counter()
    n_img = sum(b["img"].shape[0] * b["img"].shape[1]
                for b in DataLoader(ds, 64, num_workers=16, device=TRAIN_DEVICE))
    torch.cuda.synchronize()
    decode = n_img / (time.perf_counter() - t1)
    print(f"[12] synthetic tree {CLI_TRAIN_FRAMES} + 2 x {CLI_EVAL_FRAMES} frames "
          f"x 4 views of {CLI_IMAGE_SIZE}-px JPEGs with heatmaps in {t_tree:.1f} s; the "
          f"loader decodes, resizes to 256 px and pins {decode:.1f} images/s "
          f"({n_img} images, 16 workers, {os.cpu_count()} CPUs) | {card}",
          flush=True)

    total = dict.fromkeys(KERNELS, 0)

    def add(launched):
        for k, v in launched.items():
            total[k] += v

    stage1 = {}
    for pair in ("front", "back"):
        stage1[pair], launched, _, _ = cli_fit(
            card, f"ego4view_syn_heatmap_stereo_{pair}", root, workdir,
            2 * CLI_TRAIN_FRAMES, 0, [], rates.get(f"stage1_{pair}"))
        add(launched)
    grafts = []
    for pair in ("front", "back"):
        grafts += [f"--model.{GRAFT_KEYS[pair]}", stage1[pair]]
    stage2, launched, _, _ = cli_fit(card, "ego4view_syn_heatmap_mvfex-n1_jqa", root,
                               workdir, CLI_TRAIN_FRAMES, launches_mvfex(), grafts,
                               rates.get("stage2"))
    add(launched)
    stage3, launched, _, _ = cli_fit(card, "ego4view_syn_pose3d", root, workdir,
                               CLI_TRAIN_FRAMES, launches_per_forward(),
                               ["--model.heatmap_estimator_mvf_pretrained", stage2],
                               None)
    add(launched)

    evals = ["--config", os.path.join(CONFIGS, "ego4view_syn_pose3d.yaml"),
             "--model.data_root", root, "--ckpt_path", stage3]
    for sub in ("test", "validate"):
        _, launched = cli_eval(card, "[12]", sub, evals, workdir, 4, CLI_EVAL_FRAMES)
        add(launched)
    add(cli_predict_vs_cpu(card, "[12]", evals, workdir, 4, CLI_EVAL_FRAMES))
    print(f"[12] CLI chain {time.perf_counter() - t0:.1f} s (tree {t_tree:.1f} s) "
          f"| {card}", flush=True)
    return dict(launches=total, root=root, stage1=stage1, stage2=stage2)


def cli_eval(card, tag: str, sub: str, evals: list, workdir: str, views: int,
             n_eval: int, label: str = ""):
    """``test`` or ``validate`` (``sub``) of a stage-3 yaml through the CLI
    (``evals``: its config, data root and checkpoint) on ``n_eval`` frames:
    the JAX metric names, printed as JSON, finite, and exactly
    ``launches_per_forward(views)`` lazy launches a batch. Returns the
    metrics and the launch counts."""
    from egorear_tpu_torch.config.loader import load_config

    mode = "test" if sub == "test" else "val"
    argv = [sub] + evals + ["--trainer.save_dir", os.path.join(
        workdir, "cli", f"{tag[1:-1]}_{sub}{label}"), "--device", TRAIN_DEVICE
        ] + CLI_OVERRIDES
    metrics, launched, printed = cli_run(argv)
    B = load_config(argv[2], argv[3:]).init_args["batch_size"]
    want = cli_launches(-(-n_eval // B), 0, launches_per_forward(views))
    names = [f"{mode}/{m}" for m in POSE_METRICS]
    if (launched != want or list(metrics) != names
            or json.loads(printed) != {k: round(float(v), 6) for k, v in metrics.items()}
            or not all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"{tag} {sub}: launched {launched} (expected {want}), "
                             f"printed {printed!r}")
    print(f"{tag} {sub} {os.path.basename(evals[1])} on {os.path.basename(evals[-1])} "
          f"({n_eval} frames in batches of {B}, the last padded): " + ", ".join(
              f"{k} {v:.4f}" for k, v in metrics.items())
          + f"; launches lazy_deform_sample {launched['lazy_deform_sample']} = "
          f"{-(-n_eval // B)} x {launches_per_forward(views)} | {card}", flush=True)
    return metrics, launched


def cli_predict_vs_cpu(card, tag: str, evals: list, workdir: str, views: int,
                       n_frames: int) -> dict:
    """``predict`` (b4, the last batch padded) of a stage-3 yaml on the card
    and with ``--device cpu`` (the plain versions), held to each other
    within phase 3's ``preds_3d`` tolerance; the card's lazy launches exact.
    Returns the launch counts of both runs."""
    import numpy as np

    preds, seconds = {}, {}
    total = dict.fromkeys(KERNELS, 0)
    for device in ("cuda", "cpu"):
        argv = (["predict"] + evals + CLI_OVERRIDES
                + ["--model.batch_size", str(CLI_PREDICT_B), "--trainer.save_dir",
                   os.path.join(workdir, "cli", f"predict_{device}_{tag[1:-1]}")]
                + ["--device", TRAIN_DEVICE if device == "cuda" else "cpu"])
        n_batches = -(-n_frames // CLI_PREDICT_B)
        t1 = time.perf_counter()
        path, launched, printed = cli_run(argv)
        seconds[device] = time.perf_counter() - t1
        want = cli_launches(n_batches if device == "cuda" else 0, 0,
                            launches_per_forward(views))
        if launched != want or json.loads(printed) != {"predictions": path}:
            raise AssertionError(f"{tag} predict on {device}: launched {launched}, "
                                 f"expected {want}; printed {printed!r}")
        for k, v in launched.items():
            total[k] += v
        preds[device] = np.load(path, allow_pickle=True)
    got, want = preds["cuda"], preds["cpu"]
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in ("final", "proposal")}
    print(f"{tag} predict {os.path.basename(evals[1])} B={CLI_PREDICT_B} on the card "
          f"({seconds['cuda']:.1f} s, {n_batches} batches, the last padded) vs "
          f"--device cpu (plain versions, {seconds['cpu']:.1f} s): preds_3d max-abs "
          f"cm {errs} (tol {E2E_P3D_TOL:g}), {got['final'].shape} each | {card}",
          flush=True)
    if not (list(got["frame_path"]) == list(want["frame_path"])
            and got["final"].shape == (n_frames, 16, 3)
            and np.isfinite(got["final"]).all()
            and max(errs.values()) <= E2E_P3D_TOL):
        raise AssertionError(f"{tag} predict on the card disagrees with the CPU")
    return total


# Phase 13: the stereo-pair (V = 2) and real-world yamls through the CLI, at
# full width: 13a on phase 12's syn tree, 13b on a real-world tree of
# 872-px PNGs (64 train frames: 2 steps at the stage-3 yamls' b32; 6
# validation and 6 test frames) whose sequences carry their device-to-camera
# transforms. The stage-2 checkpoints reach stage 3 as EgoRear Lightning
# ``.ckpt`` files (write_egorear_ckpt).
RW_TRAIN_FRAMES, RW_EVAL_FRAMES = 64, 6


def check_ckpt_graft(tag: str, name: str, root: str, ckpt: str, source: str) -> int:
    """``heatmap_estimator_mvf_pretrained`` of yaml ``name`` taken as the
    EgoRear ``.ckpt`` ``ckpt`` (as ``run.main fit`` grafts it): the grafted
    leaves bitwise those of ``source``, the port checkpoint the file was
    written from (``num_batches_tracked``, which the import sets to 0 as the
    JAX package drops it, aside). Returns the number of leaves."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.train import checkpoint

    cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml"),
                      ["--model.data_root", root, "--model.heatmap_estimator_mvf_pretrained",
                       ckpt] + CLI_OVERRIDES)
    task, args = run.build_task(cfg, TRAIN_DEVICE)
    run.apply_pretrained(task, cfg, args)
    want = checkpoint.restore(source, map_location=TRAIN_DEVICE)["model"]
    got = checkpoint.sub_state(task.model.state_dict(), "heatmap_estimator")
    if sorted(got) != sorted(want):
        raise AssertionError(f"{tag} {name}: the .ckpt graft's keys differ from "
                             f"{source}'s")
    leaves = [k for k in got if not k.endswith("num_batches_tracked")]
    for k in leaves:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{tag} {name}: grafted heatmap_estimator.{k} "
                                 f"differs from the checkpoint")
    return len(leaves)


def phase_cli_rigs(card, workdir: str, cli: dict) -> dict:
    """The stereo-pair and real-world yamls through the CLI on the card.

    13a: ``fit`` of the V = 2 stage 2 (grafted from phase 12's stage-1 front
    checkpoint; 2 + 2 lazy launches a step) and stage 3 (grafted from it;
    5 + 5), a kept step of each (every launch held against its plain
    version, kernel batch 2 B), ``test`` on the stage-3 checkpoint (5 a
    batch). 13b: a real-world tree; ``fit`` of ``ego4view_rw_pose3d`` (7 +
    7, from phase 12's stage-2 checkpoint) and ``ego4view_rw_pose3d_stereo_front``
    (5 + 5, from 13a's), each taking the stage-2 checkpoint as an EgoRear
    ``.ckpt`` (the grafted leaves bitwise), with a kept step; ``test`` from
    the stage-3 result as ``.pt`` and as ``.ckpt`` (identical metrics);
    ``predict`` of the V = 2 yaml on the card vs ``--device cpu``. Returns
    the launch counts summed over the phase."""
    from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
    from egorear_tpu_torch.train import checkpoint

    total = dict.fromkeys(KERNELS, 0)

    def add(launched):
        for k, v in launched.items():
            total[k] += v

    def fit(tag, name, root, n_items, views, per, extra, seed):
        ckpt, launched, trainer, batch = cli_fit(card, name, root, workdir, n_items,
                                                 per, extra, None, tag)
        add(launched)
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(seed)
        kept_step(trainer.task, trainer, batch, gen, cli_launches(1, 1, per), tag, card)
        print(f"{tag} kept step of {name}: {per} + {per} launches at kernel batch "
              f"{views} x {batch['img'].shape[0]} held against the plain versions "
              f"| {card}", flush=True)
        return ckpt

    t0 = time.perf_counter()
    syn = cli["root"]
    stage2 = fit("[13a]", "ego4view_syn_heatmap_mvfex-n1_jqa_stereo_front", syn,
                 CLI_TRAIN_FRAMES, 2, launches_mvfex(2),
                 [f"--model.{GRAFT_KEYS['front']}", cli["stage1"]["front"]], 21)
    stage3 = fit("[13a]", "ego4view_syn_pose3d_stereo_front", syn, CLI_TRAIN_FRAMES,
                 2, launches_per_forward(2),
                 ["--model.heatmap_estimator_mvf_pretrained", stage2], 22)
    _, launched = cli_eval(card, "[13a]", "test", [
        "--config", os.path.join(CONFIGS, "ego4view_syn_pose3d_stereo_front.yaml"),
        "--model.data_root", syn, "--ckpt_path", stage3], workdir, 2, CLI_EVAL_FRAMES)
    add(launched)
    print(f"[13a] V = 2 chain {time.perf_counter() - t0:.1f} s | {card}", flush=True)

    t1 = time.perf_counter()
    rw = make_synthetic_dataset(
        os.path.join(workdir, "ego4view_rw"), "rw", frames_per_seq=RW_TRAIN_FRAMES,
        eval_frames_per_seq=RW_EVAL_FRAMES, image_size=CLI_IMAGE_SIZE,
        write_heatmaps=True, draw_pose=True, seed=1)
    print(f"[13b] real-world tree {RW_TRAIN_FRAMES} + 2 x {RW_EVAL_FRAMES} frames x 4 "
          f"views of {CLI_IMAGE_SIZE}-px PNGs with heatmaps and each sequence's "
          f"transforms in {time.perf_counter() - t1:.1f} s | {card}", flush=True)
    for name, views, source, seed in (("ego4view_rw_pose3d", 4, cli["stage2"], 23),
                                      ("ego4view_rw_pose3d_stereo_front", 2, stage2, 24)):
        mvf = write_egorear_ckpt(os.path.join(workdir, f"{name}_stage2.ckpt"),
                                 checkpoint.restore(source)["model"], "heatmap_mvf_ex")
        n = check_ckpt_graft("[13b]", name, rw, mvf, source)
        print(f"[13b] {name}: heatmap_estimator_mvf_pretrained as an EgoRear .ckpt, "
              f"{n} grafted leaves bitwise the stage-2 checkpoint's | {card}", flush=True)
        result = fit("[13b]", name, rw, RW_TRAIN_FRAMES, views,
                     launches_per_forward(views),
                     ["--model.heatmap_estimator_mvf_pretrained", mvf], seed)
        as_ckpt = write_egorear_ckpt(os.path.join(workdir, f"{name}_stage3.ckpt"),
                                     checkpoint.restore(result)["model"], "pose_3d_mvf_ex")
        evals = ["--config", os.path.join(CONFIGS, f"{name}.yaml"),
                 "--model.data_root", rw, "--ckpt_path"]
        metrics = {}
        for path, label in ((result, "_pt"), (as_ckpt, "_ckpt")):
            metrics[label], launched = cli_eval(card, "[13b]", "test", evals + [path],
                                                workdir, views, RW_EVAL_FRAMES, label)
            add(launched)
        if metrics["_pt"] != metrics["_ckpt"]:
            raise AssertionError(f"[13b] {name}: test from the .ckpt {metrics['_ckpt']} "
                                 f"differs from the .pt's {metrics['_pt']}")
        print(f"[13b] {name}: test from the stage-3 result as .ckpt identical to the "
              f".pt's | {card}", flush=True)
    add(cli_predict_vs_cpu(card, "[13b]", evals + [as_ckpt], workdir, 2, RW_EVAL_FRAMES))
    print(f"[13b] real-world chain {time.perf_counter() - t1:.1f} s; phase 13 "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return total


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
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        weights_path = os.path.join(workdir, "resnet18-seeded.pth")
        write_imagenet_weights(weights_path)
        with env_var(IMAGENET_ENV, weights_path):
            from egorear_tpu_torch.train.imagenet import load_imagenet_resnet18

            weights = load_imagenet_resnet18()
            rates = {}
            stage1 = timed("8", phase_stage1, card, workdir, weights, rates)
            timed("9", phase_stage2_check, card)
            stage2, stage2_launched = timed("10", phase_stage2, card, workdir,
                                            stage1, rates)
            timed("11", phase_stage3_graft, card, stage2)
            cli = timed("12", phase_cli, card, workdir, rates)
            rigs_launched = timed("13", phase_cli_rigs, card, workdir, cli)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[7] main-path launches: serving forward lazy_deform_sample "
          f"{serve[True]['lazy_deform_sample']}, deform_sample "
          f"{serve[False]['deform_sample']}; training lazy_deform_sample "
          f"{train[True]['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{train[True]['lazy_deform_sample_bwd']}, deform_sample "
          f"{train[False]['deform_sample']}, deform_sample_bwd "
          f"{train[False]['deform_sample_bwd']}; stage-2 training "
          f"lazy_deform_sample {stage2_launched['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {stage2_launched['lazy_deform_sample_bwd']}; "
          f"CLI chain lazy_deform_sample {cli['launches']['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {cli['launches']['lazy_deform_sample_bwd']}; "
          f"V = 2 and real-world CLI lazy_deform_sample "
          f"{rigs_launched['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{rigs_launched['lazy_deform_sample_bwd']} | {card}", flush=True)
    # Each main path's counts, zeroed before and read after its own run;
    # ``launches`` is their sum.
    by_path = {"serving_lazy": serve[True], "serving_reference": serve[False],
               "training_lazy": train[True], "training_reference": train[False],
               "stage2_training": stage2_launched, "cli_chain": cli["launches"],
               "cli_v2_and_real_world": rigs_launched}
    print("[7] seconds by phase: "
          + " ".join(f"{k}={v:.1f}" for k, v in seconds.items())
          + f"; total {time.perf_counter() - t0:.1f} | {card}", flush=True)

    print(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"egorear_tpu_torch/csrc/{name}.cu", replaces=replaces,
             launches=sum(r[name] for r in by_path.values()),
             launches_by_path={p: r[name] for p, r in by_path.items()},
             **records[name])
        for name, (_, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
