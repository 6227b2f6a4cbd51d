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
     kernel step's ReLUs and max-pools on the plain step's side of their
     kink (:func:`pinned_relus`) and its anchors the plain step's
     (:func:`pinned_anchors`), and compare gradients, parameters and BN
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

The uint8 on-device preprocessing (``device_preprocess``) through the CLI:

  14. a: one stage-2 batch of phase 12's tree by the device path (uint8
     872-px views; resize, normalisation and targets on the card) and by the
     host path: ``img`` within one LSB after normalisation (the share one
     LSB off printed), the targets within 1e-6 of the NPYs, and bitwise the
     same with TF32 matmuls allowed; b: the device path's loader rate with
     the port's collation (the workers copy into pinned rows) and, in
     turns, with a stack-then-pin collation (the iterating thread stacks
     and pins each batch, :func:`stacking_loader`), each batch's copy ms, the host path's rate,
     the preprocessing's device time and transient memory, ``fit`` of stage
     2 (b64, 4 + 4 launches a step) and stage 3 (b32, 7 + 7) with
     ``device_preprocess`` at 872 px beside phase 12's rates and
     loader-bound shares, peak memory, a kept step of stage 3 on a uint8
     batch; c: a two-epoch stage-2 ``fit`` on the host path with
     ``cache_in_memory``, each epoch's rate and loader-bound share and the
     cache's resident bytes.

The model branches that no shipped yaml sets (:data:`BRANCHES`: the MVFex
query modes, ``use_1by1_conv``, the 512-channel head, dense
cross-attention in either stage, stage 3 without ``use_pred_heatmap_init``,
the avgpool and heatmap 3D proposals, ``norm_mlp_pred``), at full width:

  15. a: the lazy forward and backward kernels at the 512-channel head's
     shapes (Cin = 512; the pose3d ``d_feat`` block takes 229,924 of the
     232,448 bytes of shared memory) against their plain versions, as
     phases 2 and 2b; b: for each branch, in the lazy order and (but for
     dense cross-attention) the reference order, on one seeded build per
     order, phase 3's forward and phase 5's train step kernels vs plain,
     the step with every dropout at 0.1 (both sides draw the same masks),
     and b16 bf16 serving forwards of the same weights BN-folded
     (:data:`BRANCH_SERVE`); the launches exact, none in a dense stage
     (:func:`launches_per_forward` of the branch's config); c: ``fit`` of
     stage 2 with ``use_1by1_conv`` and ``ffn_drop`` 0.1, and of stage 3
     with the heatmap proposal and without ``use_pred_heatmap_init``,
     through the CLI on phase 12's tree.

Data-parallel training (``egorear_tpu_torch.parallel``, the JAX package's
``data`` mesh axis) and ``remat``:

  16. a: stage 2 (b64) and stage 3 (b32), fp32, at full width, on two ranks
     sharing the one card over gloo (``parallel.dist.spawn``; B/2 rows a
     rank) and in one process, from the same state on the same global
     batch, the anchors pinned to the one process's (:func:`pinned_anchors`):
     the first step's gradients within TRAIN_GRAD_TOL of scale (or within
     NOISE_FACTOR times how far ulp noise on the parameters moves the one
     process's own gradient, where that is larger), parameters within
     AdamW's bound, BN running stats within TRAIN_STAT_TOL, the ranks'
     states bitwise equal after two steps, 4 + 4 and 7 + 7 launches a rank
     and step, samples/s of both (not a speed result on one card); b: the
     stage-2 yaml through the CLI on phase 12's tree: ``--trainer.devices
     2`` refused over NCCL on one card, ``fit`` as rank 0 of a one-rank
     NCCL group (``torchrun``'s environment) and on two gloo ranks (each
     running ``run.main``; the same launches a rank, states bitwise equal,
     rank 0's checkpoint), with two cards or more also over NCCL, then
     ``validate`` of that checkpoint with ``--trainer.devices 2`` (the same
     metrics on both ranks, within DP_EVAL_TOL of one process's); c: one
     b32 fp32 stage-3 step with ``remat`` and one without, held to each
     other as phase 5's, the forward kernels launched twice with ``remat``,
     both peaks.

Tensor parallelism over the model axis (``--trainer.model_parallel``,
``egorear_tpu_torch.parallel.tensor``; ranks share the one card over gloo,
so these are checks and memory, not speed across cards):

  17. a: stage 3 b32 fp32 at the default ``tp_min_dim`` 2048 on a (1 data x
     2 model) grid against phase 16a's one-process step from the same state
     on the same batch (held by 16a's rule, the anchors pinned): the sharded
     leaves with their axes, three steps with 7 + 7 launches a rank and
     step (the first step's launches kept and held against their plain
     versions as the kept-call phases), the replicated leaves bitwise equal
     across the model group, the peaks, and one bf16-mixed step's loss terms
     within TP_BF16_TOL of one process's; b: stage 2 b64 fp32 at
     ``tp_min_dim`` 256 (row- and column-parallel and gathered leaves) on a
     (2 x 2) grid of four ranks against 16a's stage-2 step; c: the stage-3
     yaml through the CLI on phase 12's tree with ``--trainer.devices 2
     --trainer.model_parallel 2``: refused over NCCL on one card; ``fit``
     (2 steps at b64, grafted from phase 12's stage 2), ``validate`` and
     ``predict`` in a two-rank gloo group, the last two within TP_EVAL_TOL
     of one process from the same checkpoint, which loads into one process
     with the same keys and shapes, bitwise the ranks' gathered state; d:
     the 512-channel head, one b2 fp32 step at M = 2, its build time and
     per-rank peak beside phase 15b's one-process step.

The tools that drive the main path (``egorear_tpu_torch/tools/``), each
through its own function, the launch counts from 0 over each:

  18. a: ``profile_fwd`` (b64 bf16: ms/forward, frames/s, a torch.profiler
     trace of 3 forwards): its kernel table names the lazy forward kernel,
     the launches are 7 a forward, and its scope buckets sum to the
     profiler's device total within TOOL_SUM_TOL; b: ``profile_train`` (b32
     bf16-mixed, the JAX tools' step): 7 + 7 launches a step, a finite
     loss, the forward / backward / optimizer split within TOOL_SUM_TOL of
     the device total; c: ``overfit_probe`` on phase 12's tree (256 px, b8,
     OVERFIT_STEPS fp32 steps, 7 + 7 launches each): ``final_mpjpe`` falls,
     then one kept step of the perturbed model held against the plain
     versions (:func:`kept_step`'s hold); d: ``run_curriculum`` in a
     subprocess (CURRICULUM_ARGS: both stage-1 pairs, stage 2, its test
     and its occlusion split on the train and validation frames, stage 3
     and its test, each a CLI subprocess on the card): both test JSONs
     parse and both occlusion-split JSONs hold the 8 ``_mse_pts2d`` keys
     (its launches are the subprocesses'; phase 12 holds the CLI's).

The native decoder (``egorear_tpu_torch/native/``, the datasets' default,
which phases 12-18 use but for the host path of 14a-14b):

  19. a: the build in use (compiled with g++ from the checkout at first
     use, its time) and the libjpeg and libpng it links (paths, NEEDED
     sonames, what the process maps); b: phase 12's 872-px JPEGs and phase
     13's 872-px PNGs (NATIVE_FRAMES frames of each, 4 views) decoded by it
     against PIL: uint8 at 872 px bitwise, uint8 at 256 px within one LSB
     and float32 within one LSB after normalisation, the differing pixels
     counted; c: the loader's images/s with the yamls' 16 workers, native
     and PIL in turns, on the ``device_preprocess`` path (uint8 at 872 px)
     and the host path (float32 at 256 px), and each decoder alone on the
     same files; d: phase 14's stage-2 ``fit`` (b64, ``device_preprocess``
     at 872 px) over NATIVE_REPEAT names for each train sequence (8 steps),
     NATIVE_FITS runs: each run's loader-bound share without the wait for
     the first batch beside phase 14's, its lazy launches a step as phase
     14's.

Every phase that drives the main path sets the launch counts of all four
kernels to 0 just before it and reads them just after.

It exits non-zero, without the last line, when there is no card or any phase
fails. Its last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import functools
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

from egorear_tpu_torch.tools.profile_fwd import device_table, kernel_time, profiled

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
# Sampling-kernel launches per deformable cross-attention layer and call:
# the V MVFex refiners run as a loop of V modules (models/mvfex.py), and
# each refiner layer and each lifting layer (models/pose3d.py) launches
# once. A CPU rehearsal, where no kernel launches, sets it to 0.
LAUNCHES_PER_LAYER = 1


def flagship_cfg():
    """The flagship's ``EgoRearNetCfg``, which the launch counts below
    take when given no config."""
    from egorear_tpu_torch import entry

    return entry.flagship_cfg()


def launches_mvfex(views: int = 4, cfg=None) -> int:
    """Sampling-kernel launches of one forward of the V-view refiners of
    ``cfg`` (an ``EgoRearNetCfg``, by default the flagship's): one a layer
    each, none where the refiners attend densely."""
    mvf = (cfg or flagship_cfg()).heatmap_mvf.mvf
    dense = mvf.transformer.use_normal_cross_attn
    return 0 if dense else views * mvf.num_former_layers * LAUNCHES_PER_LAYER


def launches_pose3d(cfg=None) -> int:
    """Sampling-kernel launches of one forward of the lifting layers of
    ``cfg`` (by default the flagship's): one a layer, none where they
    attend densely."""
    p = (cfg or flagship_cfg()).pose3d
    dense = p.transformer.use_normal_cross_attn
    return 0 if dense else p.num_former_layers * LAUNCHES_PER_LAYER


def launches_per_forward(views: int = 4, cfg=None) -> int:
    """Sampling-kernel launches of one V-view cascade forward of ``cfg``."""
    return launches_mvfex(views, cfg) + launches_pose3d(cfg)


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
# Phase 16a: a leaf may differ by NOISE_FACTOR times the largest max-abs
# move of the one-process step's gradient over NOISE_DRAWS draws of
# NOISE_ULPS fp32 ulps of noise on every parameter, where that exceeds
# TRAIN_GRAD_TOL of its scale: the step's conditioning, as
# tests/test_torch_port_rigs.py measures JAX's at one ulp. At these batches
# thousands of sampling points lie within a rounding of a grid line, where
# bilinear sampling's gradient jumps. The ranks perturb the step as much:
# convolutions at half the batch take other cuDNN algorithms (other fp32
# sums over up to 4608 terms) and BatchNorm combines two halves' statistics.
NOISE_FACTOR, NOISE_ULPS, NOISE_DRAWS = 4.0, 8, 4
TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 32, 3, 10
PROFILED_STEPS = 3  # steps under torch.profiler after a timed run
TRAIN_SIZE, TRAIN_DEVICE = 256, "cuda"  # a CPU rehearsal may shrink them
ANCHOR_SEEDS = 8  # seeds phase 5 (and 15b) may try for partly valid anchors

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


def refiners_backward(cfg=None) -> bool:
    """Whether a stage-3 step's loss reaches the refiners' sampling in the
    cascade ``cfg`` (by default the flagship's): through their heatmaps
    unless ``detach_heatmap_feat``, or through their features, which the
    lifter reads for its memory without ``use_pred_heatmap_init`` and for
    the proposal unless that reads the (then detached) heatmaps."""
    cfg = cfg or flagship_cfg()
    hm = cfg.heatmap_mvf
    return (not hm.detach_heatmap_feat or not hm.use_pred_heatmap_init
            or not cfg.pose3d.use_mlp_heatmap)


def expected_launches(lazy: bool, forwards: int, backwards: int,
                      cfg=None) -> dict:
    """Launch counts of a main-path run of ``forwards`` forwards and
    ``backwards`` backwards of ``cfg`` (by default the flagship's) in one
    computation order: the other order's kernels never launch, and the
    refiners' backward only where the loss reaches them."""
    fwd, bwd = kernel_names(lazy)
    want = dict.fromkeys(KERNELS, 0)
    want[fwd] = forwards * launches_per_forward(cfg=cfg)
    want[bwd] = backwards * (launches_pose3d(cfg) + (
        launches_mvfex(cfg=cfg) if refiners_backward(cfg) else 0))
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


def phase_kernels(card, model_locs, shapes=None, tag="[2]"):
    """Kernel vs plain version on the card at both flagship shapes (or
    ``shapes``), fp32 and bf16, with uniform locations and with the model's
    own; each bf16 call must give bitwise equal outputs in two runs."""
    from egorear_tpu_torch.ops.deform_attn import (
        lazy_deform_sample, lazy_deform_sample_plain)
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    record = None
    cases = [(name, shape, dtype, locs) for name, shape in (shapes or SHAPES).items()
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
        print(f"{tag} lazy_deform_sample {name} {str(dtype)[6:]} {locs} "
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


def phase_backward_kernels(card, model_locs, shapes=None, tag="[2b]"):
    """Backward kernels vs plain version on the card at both flagship
    shapes (or ``shapes``), fp32 and bf16, with uniform locations and with the model's own,
    with and without d_feat; d_feat must come out bitwise equal from two
    runs."""
    from egorear_tpu_torch.ops.deform_attn import (
        lazy_deform_sample_backward, lazy_deform_sample_backward_plain)

    gen = torch.Generator(device="cuda").manual_seed(3)
    record = None
    names = ("d_feat", "d_loc", "d_attn_w", "d_pos")
    main_path = {}  # locations -> ms of the bf16 main-path calls of one step
    cases = [(name, shape, dtype, locs) for name, shape in (shapes or SHAPES).items()
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
            print(f"{tag} lazy_deform_sample_bwd {name} {str(dtype)[6:]} {locs} "
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
                    launches_mvfex() if name == "mvfex" else launches_pose3d()) * ms
            # The record: the refiner call of the bf16 training step.
            if (name == "mvfex" and dtype == torch.bfloat16 and not need_feat
                    and locs == "uniform"):
                record = dict(max_abs_err=max(abs_errs), ms=ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
    print(f"{tag} lazy_deform_sample_bwd main path of a bf16 step "
          f"({launches_mvfex()} x MVFex without d_feat + {launches_pose3d()} x "
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
                launches_mvfex() if name == "mvfex" else launches_pose3d()) * ms
        if name == "mvfex" and dtype == torch.bfloat16 and locs == "uniform":
            record = dict(max_abs_err=max(abs_errs), ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    print(f"[2d] deform_sample_bwd main path of a bf16 step ({launches_mvfex()} "
          f"x MVFex + {launches_pose3d()} x pose3d, kernel times above): "
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
    pixels of spread), the refiners' position tables (the query table too,
    where there is one) random values, the 3D proposal (of the cascade;
    ``model`` may be the stage-2 network alone) a random pose spread over the
    rig's field of view (through the inverse of ``norm_mlp_pred``'s map
    where that is set), and the initial heatmap heads (the conv-stack heads
    or, with ``use_1by1_conv``, the estimators' own) a bias that puts the
    median peak at the 0.5 validity threshold, so about half the 2D anchors
    are valid.
    """
    for m in deform_attns(model):
        fan_in = m.sampling_offsets.weight.shape[1]
        m.sampling_offsets.weight.normal_(0.0, 2.0 * fan_in**-0.5, generator=gen)
        m.attention_weights.weight.normal_(0.0, fan_in**-0.5, generator=gen)
    hm_net = getattr(model, "heatmap_estimator", model)
    for r in hm_net.refiners:
        r.frame_feat_multi_view_pos_embed.normal_(0.0, 0.5, generator=gen)
        if hasattr(r, "query_pos_embed"):
            r.query_pos_embed.normal_(0.0, 0.5, generator=gen)
    if hm_net is not model:
        lifter = model.pose3d_estimator
        bias = lifter.mlp_pred_out.bias
        u = torch.rand(bias.numel() // 3, 3, generator=gen, device=bias.device)
        lo = torch.tensor([-60.0, -60.0, -20.0], device=bias.device)
        hi = torch.tensor([60.0, 60.0, 80.0], device=bias.device)
        pose = lo + u * (hi - lo)
        if lifter.cfg.norm_mlp_pred:
            box_lo, box_hi = (torch.tensor(b, device=bias.device) for b in
                              (lifter.cfg.coor_norm_min, lifter.cfg.coor_norm_max))
            pose = 2.0 * (pose - box_lo) / (box_hi - box_lo) - 1.0
        bias.copy_(pose.reshape(-1))
    _, _, halves = hm_net._estimator_features(img)
    if hm_net.use_1by1_conv:
        peaks = hm_net._estimator_heatmaps(halves[:len(hm_net._estimators())],
                                           img.shape[0])
        heads = [est.conv_heatmap for est, _ in hm_net._estimators()]
    else:
        peaks = hm_net._heatmaps_from_feat(*halves)
        heads = [m.Conv_4 for n, m in hm_net.named_children()
                 if n.startswith("conv_heatmap_head_")]
    shift = 0.5 - float(peaks.amax(dim=(-2, -1)).median())
    for head in heads:
        head.bias.add_(shift)


def phase_end_to_end(card, lazy: bool = True):
    """The flagship forward through the kernels vs through the plain
    versions (:func:`check_forward`); in the reference order also vs the
    lazy order on the same weights."""
    from egorear_tpu_torch import entry

    model, rig = entry.build((256, 256), dtype=torch.float32, seed=0,
                             lazy_deform=lazy)
    img, got_p3d, got_hm = check_forward(card, model, rig, lazy, "flagship",
                                         order_tag(3, lazy))
    if lazy:
        return
    # Two independent kernels computing one function by different algebra.
    other, _ = entry.build((256, 256), dtype=torch.float32, seed=0)
    other.load_state_dict(model.state_dict(), strict=True)
    with torch.inference_mode():
        lazy_p3d, lazy_hm = other(img, rig)
    hm_errs = [float((g - w).abs().max()) for g, w in zip(got_hm, lazy_hm)]
    p3d_errs = [float((g - w).abs().max()) for g, w in zip(got_p3d, lazy_p3d)]
    print(f"{order_tag(3, lazy)} flagship 256px B={E2E_BATCH} fp32 reference "
          f"order vs lazy order, both through their kernels, same weights: "
          f"heatmap stages max-abs {hm_errs} (tol {ORDERS_HM_TOL:g}), preds_3d "
          f"stages max-abs cm {p3d_errs} (tol {ORDERS_P3D_TOL:g}) | {card}",
          flush=True)
    if not (max(hm_errs) <= ORDERS_HM_TOL and max(p3d_errs) <= ORDERS_P3D_TOL):
        raise AssertionError("the reference order disagrees with the lazy order")


def check_forward(card, model, rig, lazy: bool, name: str, tag: str):
    """The eval-mode fp32 b2 forward of ``model`` (moved off its init by
    :func:`perturb_`) through the kernels vs through the plain versions, the
    launches exact; returns the images and the kernel run's outputs."""
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    size = model.cfg.image_size[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    img = torch.randn(E2E_BATCH, 4, 3, size, size, generator=gen, device="cuda")
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
    want = expected_launches(lazy, 1, 0, model.cfg)
    if launched != want:
        raise AssertionError(f"kernel run launched {launched}, expected {want}")
    valid_2d = float(argmax_2d(want_hm[0], 0.5, normalize=True)[2].float().mean())
    valid_3d = float(rig.project(want_p3d[0])[1].float().mean())
    if not (valid_2d > 0 and valid_3d > 0):
        raise AssertionError(f"no valid anchors (2D {valid_2d}, 3D {valid_3d}): "
                             f"the check would not see the kernel")
    hm_errs = [float((g - w).abs().max()) for g, w in zip(got_hm, want_hm)]
    p3d_errs = [float((g - w).abs().max()) for g, w in zip(got_p3d, want_p3d)]
    fwd = kernel_names(lazy)[0]
    print(f"{tag} {name} {size}px B={E2E_BATCH} fp32 "
          f"{'lazy' if lazy else 'reference'} order kernel vs plain: heatmap "
          f"stages max-abs {hm_errs} (tol {E2E_HM_TOL:g}), preds_3d stages "
          f"max-abs cm {p3d_errs} (tol {E2E_P3D_TOL:g}); valid anchors 2D "
          f"{valid_2d:.3f} 3D {valid_3d:.3f}; {fwd} launches {launched[fwd]} "
          f"| {card}", flush=True)
    if len(got_hm) != 2 or len(got_p3d) != 4:
        raise AssertionError("unexpected number of output stages")
    if not (max(hm_errs) <= E2E_HM_TOL and max(p3d_errs) <= E2E_P3D_TOL):
        raise AssertionError("end-to-end kernel run disagrees with the plain run")
    return img, got_p3d, got_hm


def phase_serve(card, profile: str | None, lazy: bool = True):
    """Serve the flagship as users would (:func:`serve`); returns the
    kernel launch counts of the main path."""
    from egorear_tpu_torch import entry

    model, rig = entry.build((256, 256), dtype=torch.bfloat16, bn_folded=True,
                             seed=0, lazy_deform=lazy)
    return serve(card, model, rig, lazy, "flagship", order_tag(4, lazy),
                 profile=profile)


def serve(card, model, rig, lazy: bool, name: str, tag: str,
          forwards: tuple = (SERVE_WARMUP, SERVE_TIMED), profile=None) -> dict:
    """``forwards`` = (warm-up, timed) b16 forwards of the bf16 BN-folded
    ``model`` at 256 px, timed, their launches exact and their outputs
    finite; returns the launch counts."""
    warmup, timed = forwards
    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.randn(SERVE_BATCH, 4, 3, 256, 256, generator=gen,
                      device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_launches()
        for _ in range(warmup):
            model(img, rig)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            preds_3d, heatmaps = model(img, rig)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / timed
        launches = read_launches()
    n = warmup + timed
    want = expected_launches(lazy, n, 0, model.cfg)
    if launches != want:
        raise AssertionError(f"{n} forwards launched {launches}, expected {want}")
    B, J = SERVE_BATCH, 16
    if [tuple(p.shape) for p in preds_3d] != [(B, J, 3)] * 4:
        raise AssertionError(f"preds_3d shapes {[p.shape for p in preds_3d]}")
    if [tuple(h.shape) for h in heatmaps] != [(B, 4, 15, 64, 64)] * 2:
        raise AssertionError(f"heatmap shapes {[h.shape for h in heatmaps]}")
    if not all(bool(torch.isfinite(x).all()) for x in (*preds_3d, *heatmaps)):
        raise AssertionError("non-finite serving output")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fwd = kernel_names(lazy)[0]
    print(f"{tag} serve {name} 256px bf16 BN-folded "
          f"{'lazy' if lazy else 'reference'} order B={B}: "
          f"{dt * 1e3:.3f} ms/forward (host clock, {timed} forwards "
          f"after {warmup} warm-up), {B / dt:.1f} samples/s "
          f"({4 * B / dt:.1f} images/s), peak {peak_gib:.2f} GiB; {fwd} "
          f"launches {launches[fwd]} = {n} x "
          f"{launches_per_forward(cfg=model.cfg)} ({launches_mvfex(cfg=model.cfg)}"
          f" refiner + {launches_pose3d(model.cfg)} lifting layer launches), "
          f"other kernels 0 | {card}", flush=True)
    if profile:
        profile_serving(model, rig, img, card, profile, lazy)
    return launches


def profile_serving(model, rig, img, card, path: str, lazy: bool = True,
                    n: int = 3):
    """Device time by kernel over ``n`` serving forwards (torch.profiler);
    the table goes to ``path`` (the lazy order's first, then appended)."""
    tag = order_tag(4, lazy)
    with torch.inference_mode():
        events, busy = profiled(lambda: model(img, rig), n)
    device_table(events, busy, f"{card} serving {tag}", path,
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
    # masked_fill, not boolean indexing: the 512-channel head's mlp_pred_0
    # holds 1.07 G elements, whose index lists would take 17 GB.
    determined = grad.abs() > 10 * grad_tol
    tight = float(diff.masked_fill(~determined, 0).max())
    loose = float(diff.masked_fill(determined, 0).max())
    return tight, loose


@contextlib.contextmanager
def pinned_relus(masks: list, flips: list | None = None):
    """With ``flips`` None, records the mask (input > 0) of every ``F.relu``
    call inside and the argmax indices of every ``F.max_pool2d`` call, in
    call order, into ``masks``. Otherwise the i-th call takes ``masks[i]``:
    a ReLU whose input's sign agrees with the mask is ``F.relu``, and where
    it does not it gives ``torch.where(mask, x, 0)``, whose gradient follows
    the mask; a max-pool whose argmax agrees is ``F.max_pool2d``, and where
    it does not it gives the input at the recorded indices, where its
    gradient then goes. Each disagreeing call appends (elements that
    disagree, their largest distance from the kink, |input| or max minus
    the recorded element, over the call's largest |input|) to ``flips``.

    ReLU's gradient jumps at 0 and a max-pool's at a tie, so an input that
    two runs round to either side of one changes a gradient by a whole
    path, however small the difference. Pinning the kernel step's ReLUs and
    max-pools to the plain step's side compares both gradients on the same
    piece, where they are continuous in the kernel's rounding; the caller
    requires every input that changed sides to lie within FWD_TOL[fp32] of
    the call's scale of the kink."""
    import torch.nn.functional as F

    relu, pool, calls = F.relu, F.max_pool2d, [0]

    def recorded(kind, shape):
        if calls[0] >= len(masks):
            raise AssertionError(f"call {calls[0]}: more ReLU and max-pool "
                                 f"calls than the recorded step made")
        got_kind, m = masks[calls[0]]
        calls[0] += 1
        if got_kind != kind or m.shape != shape:
            raise AssertionError(f"call {calls[0] - 1}: {kind} {tuple(shape)}, the "
                                 f"recorded step's {got_kind} {tuple(m.shape)}")
        return m

    def relu_pinned(x, inplace=False):
        if flips is None:
            masks.append(("relu", x.detach() > 0))
            return relu(x, inplace)
        mask = recorded("relu", x.shape)
        differ = (x.detach() > 0) != mask
        if not bool(differ.any()):
            return relu(x, inplace)
        scale = float(x.detach().abs().max())
        flips.append((int(differ.sum()),
                       float(x.detach()[differ].abs().max()) / max(scale, 1e-30)))
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))

    def pool_pinned(x, *args, return_indices=False, **kwargs):
        out, idx = pool(x, *args, return_indices=True, **kwargs)
        if flips is None:
            masks.append(("max_pool", idx))
        else:
            want = recorded("max_pool", idx.shape)
            differ = idx != want
            if bool(differ.any()):
                picked = x.flatten(2).gather(2, want.flatten(2)).view_as(out)
                scale = float(x.detach().abs().max())
                flips.append((int(differ.sum()), float(
                    (out - picked).detach()[differ].abs().max()) / max(scale, 1e-30)))
                out, idx = picked, want
        return (out, idx) if return_indices else out

    F.relu, F.max_pool2d = relu_pinned, pool_pinned
    try:
        yield
    finally:
        F.relu, F.max_pool2d = relu, pool
    if flips is not None and calls[0] != len(masks):
        raise AssertionError(f"{calls[0]} ReLU and max-pool calls, the "
                             f"recorded step made {len(masks)}")


def compare_kernel_step(model, trainer, batch, start, want_launches):
    """One fp32 train step through the plain versions and one through the
    kernels, from the state dict ``start`` on ``batch``, the kernel step's
    ReLUs and max-pools pinned to the plain step's (:func:`pinned_relus`)
    and its argmax and projected anchors to the plain step's
    (:func:`pinned_anchors`);
    checks the kernel step's launches against ``want_launches``, every leaf
    gradient against TRAIN_GRAD_TOL of its scale (a leaf below the rounding
    floor against the floor), the parameters against AdamW's bound and the
    BN running stats against TRAIN_STAT_TOL. Returns both runs and the
    worst numbers, and the kernel step's peak device memory less the plain
    run's copies that it holds (``step_peak``, bytes)."""
    runs, masks, flips, anchors, anchor_flips = {}, [], [], [], []
    for impl in ("plain", "kernel"):
        for m in deform_attns(model):
            m.impl = impl
        model.load_state_dict(start)
        trainer.init_state(steps_per_epoch=1)
        reset_launches()
        if impl == "kernel" and torch.cuda.is_available():
            import gc

            gc.collect()  # the plain step's optimizer state, if a cycle holds it
            torch.cuda.reset_peak_memory_stats()
        pin = (pinned_anchors(anchors) if impl == "plain"
               else pinned_anchors(anchors, slice(None), anchor_flips))
        with pinned_relus(masks, flips if impl == "kernel" else None), pin:
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
    held = sum(t.numel() * t.element_size() for part in ("grads", "params", "stats")
               for t in pl[part].values() if t.is_cuda)
    step_peak = (torch.cuda.max_memory_allocated() - held
                 if torch.cuda.is_available() else 0)
    return dict(kernel=k, plain=pl, flips=flips, masks=masks, kink=kink,
                anchor_flips=anchor_flips, step_peak=step_peak, **hold_step(k, pl))


def hold_step(got: dict, want: dict, noise: dict | None = None) -> dict:
    """One train step's ``got`` against ``want`` from the same state (each
    a dict of ``grads``, ``params`` and ``stats`` by name and the step's
    ``lr``): every leaf gradient within TRAIN_GRAD_TOL of its scale, or
    within NOISE_FACTOR times ``noise[leaf]`` (how far NOISE_ULPS ulps of
    parameter noise move ``want``'s own gradient) where that is larger (a leaf below the
    rounding floor against the floor), the parameters within AdamW's bound
    over that tolerance, the BN running stats within TRAIN_STAT_TOL.
    Raises listing the worst leaves; returns the worst numbers."""
    # A leaf whose largest gradient is below TRAIN_GRAD_FLOOR of the model's
    # largest is zero in exact arithmetic (the key-projection biases, to
    # which softmax attention is invariant) and holds rounding only: both
    # runs must keep it below that floor.
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in want["grads"].values())
    worst_grad, worst_name, n_floor, n_noise = 0.0, "", 0, 0
    worst_tight = worst_loose = 0.0
    failed = []
    for n, w in want["grads"].items():
        scale = float(w.abs().max())
        g = got["grads"][n]
        err = float((g - w).abs().max())
        if scale < floor:
            n_floor += 1
            if not float(g.abs().max()) <= floor:
                failed.append((float("inf"), f"gradient of {n}: "
                               f"{float(g.abs().max()):.3e} above the rounding "
                               f"floor {floor:.3e}"))
            grad_tol = floor
        else:
            grad_tol = TRAIN_GRAD_TOL * scale
            if noise is not None and NOISE_FACTOR * noise[n] > grad_tol:
                grad_tol, n_noise = NOISE_FACTOR * noise[n], n_noise + 1
            elif err / scale > worst_grad:
                worst_grad, worst_name = err / scale, n
            if not err <= grad_tol:
                failed.append((err / grad_tol, f"gradient of {n}: max-abs "
                               f"{err:.3e} > {grad_tol:.3e} (scale {scale:.3e})"))
                continue
        try:
            tight, loose = _adam_param_check(n, got["params"][n], want["params"][n],
                                             w, grad_tol, want["lr"])
        except AssertionError as e:
            failed.append((1.0, str(e)))
            continue
        worst_tight, worst_loose = max(worst_tight, tight), max(worst_loose, loose)
    stat_err = max(float((got["stats"][n] - v).abs().max())
                   for n, v in want["stats"].items())
    if not stat_err <= TRAIN_STAT_TOL:
        failed.append((stat_err / TRAIN_STAT_TOL,
                       f"BN running stats differ by {stat_err:.3e}"))
    if failed:
        failed.sort(key=lambda f: -f[0])
        raise AssertionError(f"{len(failed)} checks failed, the worst: "
                             + "; ".join(m for _, m in failed[:6]))
    return dict(floor=floor, n_floor=n_floor, n_noise=n_noise,
                worst_grad=worst_grad, worst_name=worst_name,
                worst_tight=worst_tight, worst_loose=worst_loose, stat_err=stat_err)


def perturb_train_(model, batch, gen) -> None:
    """:func:`perturb_` in train mode, so that the median initial heatmap
    peak of the training forward (BN on batch statistics) sits at the
    threshold; the BN running stats stay as they were."""
    from egorear_tpu_torch.train.tasks import prepare_batch

    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k or "num_batches" in k}
    perturb_(model, prepare_batch(batch)["img"], gen)
    model.load_state_dict(stats, strict=False)


def perturbed_start(task, batch, gen):
    """The task's model moved off its init (:func:`perturb_train_`): the
    state dict that compared steps start from and the model's no-grad
    forward on the batch."""
    model = task.model
    perturb_train_(model, batch, gen)
    start = {k: v.to("cpu", copy=True)  # on the host
             for k, v in model.state_dict().items()}
    with torch.no_grad():  # train mode: any dropout draws from a seeded stream
        out = task.forward(batch["img"], generator=torch.Generator(
            device=batch["img"].device).manual_seed(0))
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
            f"{TRAIN_STAT_TOL:g}); ReLU and max-pool inputs pinned across the kink "
            f"{sum(f[0] for f in r['flips'])} in {len(r['flips'])} of "
            f"{len(r['masks'])} calls (largest {r['kink']:.3e} of its call's "
            f"scale, tol {FWD_TOL[torch.float32]:g}); anchors pinned to the plain "
            f"step's: {sum(r['anchor_flips'])} elements differed in "
            f"{sum(1 for f in r['anchor_flips'] if f)} of {len(r['anchor_flips'])} "
            f"calls; launches (fwd, bwd) "
            f"({k['launched'][fwd]}, {k['launched'][bwd]})")


def phase_train_check(card, lazy: bool = True):
    """The flagship's kernel-vs-plain train step (:func:`check_train_step`)."""
    from egorear_tpu_torch import entry

    task, trainer = entry.build_train(
        (TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32", seed=0, steps_per_epoch=1,
        warmup_iters=1, lazy_deform=lazy, imagenet=False)
    check_train_step(card, task, trainer, lazy, "flagship", order_tag(5, lazy))


def check_train_step(card, task, trainer, lazy: bool, name: str, tag: str,
                     init: dict | None = None, dropout: float = 0.0):
    """One fp32 train step through the plain versions vs one through the
    kernels, from the same state on the same batch, the kernel step's ReLUs
    pinned to the plain step's masks (:func:`pinned_relus`), from the
    model's state ``init`` (by default its present one; on the host). Any
    dropout, at rate ``dropout``, draws the same masks in both steps: the
    trainer seeds its generator from the step, which each starts at 0."""
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    # The first seed from 4 (the flagship's) whose perturbed state has
    # partly valid anchors, so that the step crosses both sampling paths
    # (the state to retry from kept on the host).
    if init is None:
        init = {k: v.to("cpu", copy=True) for k, v in task.model.state_dict().items()}
    for seed in range(4, 4 + ANCHOR_SEEDS):
        task.model.load_state_dict(init)
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(seed)
        batch = train_batch(TRAIN_BATCH, TRAIN_SIZE, gen)
        start, (preds, hms) = perturbed_start(task, batch, gen)
        shares = {
            "2D": float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean()),
            "3D": float(task.rig.project(preds[0])[1].float().mean())}
        if all(0 < v < 1 for v in shares.values()):
            break
    anchors = partly_valid(shares) + (f" (seed {seed})" if seed != 4 else "")
    r = compare_kernel_step(task.model, trainer, batch, start,
                            expected_launches(lazy, 1, 1, task.cfg))
    STEP_PEAKS[(name, lazy)] = r["step_peak"]
    print(f"{tag} {name} {TRAIN_SIZE}px B={TRAIN_BATCH} fp32 "
          f"{'lazy' if lazy else 'reference'} order"
          f"{f', dropout {dropout:g},' if dropout else ''} train step kernel vs "
          f"plain: {kernel_step_text(r, lazy)}; valid anchors {anchors} | {card}",
          flush=True)


# {(model name, lazy order): bytes} of check_train_step's kernel steps:
# phase 17d sets the sharded 512-channel head's step beside phase 15b's.
STEP_PEAKS: dict = {}

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
        device_table(run["events"], run["busy"], f"{card} training {tag}",
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
    (r"(query_pos_embed|frame_feat_multi_view_pos_embed)$", r"\1", False),
    (r"conv_heatmap\.", "conv_heatmap.", True),
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
    # the heatmap proposal's per-view convs (Sequential indices 0, 3); the
    # reference names the back views' conv_frame_feat_*
    (r"conv_heatmap_view(\d)_(\d)\.", lambda m: (
        ("conv_heatmap_front_left", "conv_heatmap_front_right",
         "conv_frame_feat_back_left", "conv_frame_feat_back_right")[int(m[1])]
        + f".{(0, 3)[int(m[2])]}."), False),
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
    the plain versions from the same state, ReLUs and max-pools pinned as
    in phase 5."""
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


@contextlib.contextmanager
def batch_clock():
    """While open, every pass over a :class:`DataLoader` appends to the
    yielded list its ``time.perf_counter()`` times: its start, then the
    hand-over of each batch."""
    from egorear_tpu_torch.data import loader as loader_mod

    passes, it = [], loader_mod.DataLoader.__iter__

    def timed(self):
        times = [time.perf_counter()]
        passes.append(times)
        for batch in it(self):
            times.append(time.perf_counter())
            yield batch

    loader_mod.DataLoader.__iter__ = timed
    try:
        yield passes
    finally:
        loader_mod.DataLoader.__iter__ = it


def cli_fit(card, name: str, root: str, workdir: str, n_items: int,
            per: int, extra: list, synthetic: float | None, tag: str = "[12]",
            rates: dict | None = None):
    """``fit`` of one yaml for one epoch over ``n_items`` train items: its
    metrics.csv, finite losses, ``epoch=0.pt``, at least 2 steps, the lazy
    launches (``per`` each way a step, ``per`` forwards for the one
    validation batch); prints the epoch's samples/s through the loader
    beside the same step's on one batch on the card (their ratio is the
    loader-bound share) and ``synthetic`` (the phase-8/10 rate), and puts
    both rates, the share and the launch counts in ``rates[name]``. The
    share is also taken without the wait for the first batch
    (``steady_share``): every step, from the first batch's hand-over to the
    epoch's end. Returns the checkpoint, the launch counts, the trainer and
    that batch."""
    import csv

    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.data.loader import DataLoader

    yaml_path = os.path.join(CONFIGS, f"{name}.yaml")
    overrides = ["--model.data_root", root, "--trainer.max_epochs", "1",
                 "--trainer.save_dir", os.path.join(workdir, "cli", name),
                 "--device", TRAIN_DEVICE] + extra + CLI_OVERRIDES
    with batch_clock() as passes:
        trainer, launched, _ = cli_run(["fit", "--config", yaml_path] + overrides)
    (_, steps, seconds), = trainer.epoch_times
    times = passes[0]  # the epoch's pass; validation's come after
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
    share = 100 * max(0.0, 1 - through / fixed)
    steady = steps * B / (times[0] + seconds - times[1])
    steady_share = 100 * max(0.0, 1 - steady / fixed)
    if rates is not None:
        rates[name] = dict(through=through, fixed=fixed, share=share, steady=steady,
                           steady_share=steady_share, steps=steps, launched=launched)
    # Phase 8's stage-1 samples hold both views of a pair; the dataset's
    # items hold one, so the share is taken against the same step here.
    against = (f", phase 8/10's synthetic b64 {synthetic:.1f} samples/s"
               if synthetic else "")
    print(f"{tag} fit {name} B={B}: {steps} steps in {seconds:.3f} s through the "
          f"loader ({through:.1f} samples/s, {1e3 * seconds / steps:.1f} ms/step, "
          f"first step included), one batch on the card {fixed:.1f} samples/s "
          f"({B * 1e3 / fixed:.1f} ms/step){against}; loader-bound share "
          f"{share:.1f} %; without the wait for the first batch "
          f"({1e3 * (times[1] - times[0]):.1f} ms) {steady:.1f} samples/s, share "
          f"{steady_share:.1f} %; ms between hand-overs "
          f"{ms_list([1e3 * (b - a) for a, b in zip(times[1:], times[2:])])}; "
          f"launches lazy_deform_sample "
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
    cli_rates = {}
    stage2, launched, _, _ = cli_fit(card, "ego4view_syn_heatmap_mvfex-n1_jqa", root,
                               workdir, CLI_TRAIN_FRAMES, launches_mvfex(), grafts,
                               rates.get("stage2"), rates=cli_rates)
    add(launched)
    stage3, launched, _, _ = cli_fit(card, "ego4view_syn_pose3d", root, workdir,
                               CLI_TRAIN_FRAMES, launches_per_forward(),
                               ["--model.heatmap_estimator_mvf_pretrained", stage2],
                               None, rates=cli_rates)
    add(launched)

    evals = ["--config", os.path.join(CONFIGS, "ego4view_syn_pose3d.yaml"),
             "--model.data_root", root, "--ckpt_path", stage3]
    for sub in ("test", "validate"):
        _, launched = cli_eval(card, "[12]", sub, evals, workdir, 4, CLI_EVAL_FRAMES)
        add(launched)
    add(cli_predict_vs_cpu(card, "[12]", evals, workdir, 4, CLI_EVAL_FRAMES))
    print(f"[12] CLI chain {time.perf_counter() - t0:.1f} s (tree {t_tree:.1f} s) "
          f"| {card}", flush=True)
    return dict(launches=total, root=root, stage1=stage1, stage2=stage2,
                grafts=grafts, rates=cli_rates, decode=decode)


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
    the launch counts summed over the phase, and puts the real-world tree's
    root in ``cli["rw_root"]``."""
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
    cli["rw_root"] = rw  # phase 19 decodes it again
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


# Phase 14: the uint8 on-device preprocessing through the CLI on phase 12's
# syn tree (872-px JPEGs, the JSONs' 2D joints): the host only decodes; the
# card resizes 872 -> 256, normalises and renders the targets
# (egorear_tpu_torch/data/preprocess.py). 14c: cache_in_memory on the host
# path over two epochs.
DP_HM_TOL = 1e-6  # the card's targets vs the heatmap NPYs


def stacking_loader():
    """A yardstick loader with the stack-then-pin collation: the workers
    return samples, and the iterating thread stacks each batch
    (``np.stack``) and pins it (``pin_memory``) before the copy to the
    card; the seconds of each batch's stack and pin go to its ``times``."""
    import concurrent.futures as cf

    import numpy as np

    from egorear_tpu_torch.data.loader import PREFETCH, DataLoader

    class StackThenPin(DataLoader):
        times: list

        def _host_batches(self):
            self.times = []
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                pending = collections.deque()

                def finish():
                    samples = [f.result() for f in pending.popleft()]
                    t = time.perf_counter()
                    batch = {k: [s[k] for s in samples] for k in samples[0]}
                    batch = {k: torch.from_numpy(np.stack(v)).pin_memory()
                             if isinstance(v[0], np.ndarray) else v
                             for k, v in batch.items()}
                    self.times.append(time.perf_counter() - t)
                    return batch

                for idxs, _ in self._batch_indices():
                    pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                    for i in idxs])
                    if len(pending) > PREFETCH:
                        yield finish()
                while pending:
                    yield finish()

    return StackThenPin


def loader_pass(ds, B: int, key: str, loader_cls=None) -> dict:
    """One pass of ``ds`` through the loader (the yamls' 16 workers, pinned
    to the card): images/s and, per batch, the milliseconds of the copies
    into its pinned rows summed over the workers (the port's loader) or of
    the stack and pin on the iterating thread (:func:`stacking_loader`),
    and the first batch's tensors."""
    from egorear_tpu_torch.data import loader as loader_mod

    copy_s = collections.defaultdict(float)
    put = loader_mod._Batch.put

    def timed_put(batch, j, sample):
        t = time.perf_counter()
        put(batch, j, sample)
        copy_s[id(batch)] += time.perf_counter() - t

    loader = (loader_cls or loader_mod.DataLoader)(ds, B, num_workers=16,
                                                   device=TRAIN_DEVICE)
    first, n_img = None, 0
    loader_mod._Batch.put = timed_put
    try:
        t = time.perf_counter()
        for b in loader:
            n_img += b[key].shape[0] * b[key].shape[1]
            if first is None:
                first = {k: v for k, v in b.items() if torch.is_tensor(v)}
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        loader_mod._Batch.put = put
    per_batch = getattr(loader, "times", None) or list(copy_s.values())
    return dict(rate=n_img / seconds, n_img=n_img, batch=first,
                ms=[1e3 * x for x in per_batch])


def ms_list(values: list) -> str:
    return " / ".join(f"{v:.1f}" for v in values)


def phase_device_preprocess(card, workdir: str, cli: dict) -> dict:
    """The uint8 on-device preprocessing on the card, through the CLI.

    14a: one stage-2 batch of the same frames by the device path (uint8
    views, ``prepare_batch`` on the card) and by the host path (PIL resize
    and normalisation, the NPYs): ``img`` within one LSB after
    normalisation, the targets within ``DP_HM_TOL`` of the NPYs, and the
    same again, bitwise, with TF32 matmuls allowed for the call. 14b:
    the device path's loader rate with the port's collation and with the
    stack-then-pin one (:func:`stacking_loader`), in turns, and each
    batch's copy times; the host path's rate; the preprocessing's device
    time and memory; ``fit`` of stage 2 (b64) and stage 3 (b32) with
    ``device_preprocess`` at 872 px, beside phase 12's rates; a kept step
    of stage 3. 14c: a two-epoch stage-2 ``fit`` on the host path with
    ``cache_in_memory``: each epoch's rate and the cache's resident bytes.
    The host path of 14a-14b decodes with PIL, every other dataset with the
    native loader (the default). Returns each path's launch counts and
    14b's ``fit`` rates by yaml (:func:`cli_fit`'s)."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.data.datasets import get_dataset
    from egorear_tpu_torch.data.preprocess import IMAGENET_STD
    from egorear_tpu_torch.train.tasks import prepare_batch

    t0 = time.perf_counter()
    root, dpdir = cli["root"], os.path.join(workdir, "dp")
    stage2_yaml = os.path.join(CONFIGS, "ego4view_syn_heatmap_mvfex-n1_jqa.yaml")
    B = load_config(stage2_yaml, CLI_OVERRIDES).init_args["batch_size"]
    dev_ds = get_dataset("ego4view_syn_heatmap_mvf", root, "train",
                         device_preprocess=True, image_size=CLI_IMAGE_SIZE)
    # 14a holds the card's resize to PIL's: the host path decodes with PIL.
    host_ds = get_dataset("ego4view_syn_heatmap_mvf", root, "train",
                          use_native_loader=False)
    stacking = stacking_loader()
    # The device path through the stack-then-pin collation and the port's,
    # in turns.
    passes = {}
    for label, ds, key, cls in (
            ("device path, stack-then-pin collation", dev_ds, "img_u8", stacking),
            ("device path", dev_ds, "img_u8", None),
            ("device path, again", dev_ds, "img_u8", None),
            ("device path, stack-then-pin collation, again", dev_ds, "img_u8",
             stacking),
            ("host path, PIL decode", host_ds, "img", None)):
        passes[label] = loader_pass(ds, B, key, cls)
    dev, host = passes["device path"]["batch"], passes["host path, PIL decode"]["batch"]

    # 14a: the card's preprocessing against the host path, TF32 off and on.
    std = torch.as_tensor(IMAGENET_STD, device=TRAIN_DEVICE)[:, None, None]
    img_tol = (1.0 / 255.0) / float(IMAGENET_STD.min()) + 1e-4
    legacy = torch.get_float32_matmul_precision()
    imgs = {}
    for setting in (legacy, "high"):
        torch.set_float32_matmul_precision(setting)
        try:
            prepared = prepare_batch(dev)
            torch.cuda.synchronize()
        finally:
            torch.set_float32_matmul_precision(legacy)
        img, hm = prepared["img"], prepared["gt_heatmap"]
        err = (img - host["img"]).abs()
        lsb = torch.round(err * std * 255.0)
        hm_err = float((hm - host["gt_heatmap"]).abs().max())
        print(f"[14a] matmul precision {setting!r}: {tuple(dev['img_u8'].shape)} uint8 "
              f"on the card -> img {tuple(img.shape)} vs the host path's PIL resize: "
              f"max-abs {float(err.max()):.3e} (tol {img_tol:.4g}, one LSB), values one "
              f"LSB off {float((lsb >= 1).float().mean()):.4e}, more than one "
              f"{int((lsb > 1).sum())}; targets vs the NPYs max-abs {hm_err:.3e} (tol "
              f"{DP_HM_TOL:g}), {tuple(hm.shape)} | {card}", flush=True)
        if (img.shape != host["img"].shape or hm.shape != host["gt_heatmap"].shape
                or float(err.max()) > img_tol or hm_err > DP_HM_TOL
                or img.device.type != TRAIN_DEVICE):
            raise AssertionError(f"[14a] the card's preprocessing disagrees with the "
                                 f"host path under matmul precision {setting!r}")
        imgs[setting] = img
    if not torch.equal(imgs[legacy], imgs["high"]):
        raise AssertionError("[14a] TF32 matmuls changed the card's resize")

    # 14b: the two loader paths, the preprocessing alone, the CLI fits.
    for label, p in passes.items():
        what = ("stack and pin on the iterating thread" if "stack" in label else
                "copies into the pinned rows, summed over the workers")
        print(f"[14b] {label} through the loader: {p['rate']:.1f} images/s "
              f"({p['n_img']} images, 16 workers, {os.cpu_count()} CPUs; phase 12's "
              f"host path {cli['decode']:.1f}); per batch of {B}, {what}: "
              f"{ms_list(p['ms'])} ms | {card}", flush=True)
    ms = time_ms(lambda: prepare_batch(dev), n=10, warmup=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prepare_batch(dev)
    torch.cuda.synchronize()
    extra_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    N, V, H, W, C = dev["img_u8"].shape
    flops = 2 * N * V * C * 256 * (H * W + W * 256)
    print(f"[14b] device preprocessing of one batch ({N} x {V} views of {H} px): "
          f"{ms:.3f} ms (CUDA events), {flops / ms / 1e9:.1f} TFLOP/s in the two fp32 "
          f"products, {extra_gib:.2f} GiB transient | {card}", flush=True)

    total = {p: dict.fromkeys(KERNELS, 0) for p in ("device_preprocess",
                                                    "cache_in_memory")}

    def add(path, launched):
        for k, v in launched.items():
            total[path][k] += v

    rates = {}
    for name, per, extra in (
            ("ego4view_syn_heatmap_mvfex-n1_jqa", launches_mvfex(), cli["grafts"]),
            ("ego4view_syn_pose3d", launches_per_forward(),
             ["--model.heatmap_estimator_mvf_pretrained", cli["stage2"]])):
        torch.cuda.reset_peak_memory_stats()
        _, launched, trainer, batch = cli_fit(
            card, name, root, dpdir, CLI_TRAIN_FRAMES, per,
            extra + ["--model.dataset_kwargs.device_preprocess", "true",
                     "--model.dataset_kwargs.image_size", str(CLI_IMAGE_SIZE)],
            None, "[14b]", rates)
        peak = torch.cuda.max_memory_allocated() / 2**30
        add("device_preprocess", launched)
        got, was = rates[name], cli["rates"][name]
        print(f"[14b] {name} with device_preprocess at {CLI_IMAGE_SIZE} px: through "
              f"the loader {got['through']:.1f} samples/s (phase 12 {was['through']:.1f}),"
              f" one batch on the card {got['fixed']:.1f} ({was['fixed']:.1f}); "
              f"loader-bound share {got['share']:.1f} % (phase 12 {was['share']:.1f} %); "
              f"peak {peak:.2f} GiB | {card}", flush=True)
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(25)
    kept_step(trainer.task, trainer, batch, gen, cli_launches(1, 1, per), "[14b]", card)
    print(f"[14b] kept step of ego4view_syn_pose3d on a uint8 batch: {per} + {per} "
          f"launches held against the plain versions | {card}", flush=True)

    # 14c: cache_in_memory on the host path, two epochs.
    made = []
    get = run.get_dataset

    def keep(*args, **kwargs):
        made.append(get(*args, **kwargs))
        return made[-1]

    run.get_dataset = keep
    try:
        trainer, launched, _ = cli_run(
            ["fit", "--config", stage2_yaml, "--model.data_root", root,
             "--trainer.max_epochs", "2", "--trainer.save_dir",
             os.path.join(dpdir, "cache_in_memory"), "--device", TRAIN_DEVICE,
             "--model.dataset_kwargs.cache_in_memory", "true"]
            + cli["grafts"] + CLI_OVERRIDES)
    finally:
        run.get_dataset = get
    add("cache_in_memory", launched)
    (_, s1, t1), (_, s2, t2) = trainer.epoch_times
    n_val = 2 * -(-CLI_EVAL_FRAMES // B)
    want = cli_launches(s1 + s2 + n_val, s1 + s2, launches_mvfex())
    if launched != want or s1 != s2 or s1 < 2:
        raise AssertionError(f"[14c] 2 epochs of {s1}, {s2} steps launched {launched}, "
                             f"expected {want}")
    fixed = fixed_batch_rate(trainer, host)
    for e, (steps, seconds) in enumerate(((s1, t1), (s2, t2)), 1):
        through = steps * B / seconds
        print(f"[14c] cache_in_memory stage 2 B={B}, epoch {e}: {steps} steps in "
              f"{seconds:.3f} s ({through:.1f} samples/s) vs one batch on the card "
              f"{fixed:.1f}; loader-bound share {100 * max(0.0, 1 - through / fixed):.1f} %"
              f" | {card}", flush=True)

    def cache_bytes(ds):
        return sum(v.nbytes for item in ds._cache.values() for v in item.values()
                   if hasattr(v, "nbytes"))

    train = made[0]  # run._datasets makes the train split first
    print(f"[14c] the train cache holds {len(train._cache)} samples in "
          f"{cache_bytes(train) / 2**20:.1f} MiB "
          f"({cache_bytes(train) / max(1, len(train._cache)) / 2**20:.2f} MiB a "
          f"sample; all {len(made)} datasets {sum(map(cache_bytes, made)) / 2**20:.1f} "
          f"MiB); launches lazy_deform_sample {launched['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {launched['lazy_deform_sample_bwd']} | {card}",
          flush=True)
    print(f"[14] phase 14 {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return total, rates


# Phase 15: the model branches that no shipped yaml sets, each as its
# overrides of the flagship config's keys (a dotted path each). The JAX
# package builds all of them; ``norm_mlp_pred`` needs a box to unnormalise
# into, here one of 2 m around the device (x, y) and from -0.5 to 1.5 m
# along its axis (z).
BRANCHES = {
    "1by1": {"heatmap_mvf_cfg.mvf_cfg.use_1by1_conv": True},
    "jqa_mv": {"heatmap_mvf_cfg.mvf_cfg.joint_query_adaptation": False,
               "heatmap_mvf_cfg.mvf_cfg.joint_query_adaptation_multi_view": True},
    "query_only": {"heatmap_mvf_cfg.mvf_cfg.joint_query_adaptation": False,
                   "heatmap_mvf_cfg.mvf_cfg.joint_query_only": True},
    "hm_embed": {"heatmap_mvf_cfg.mvf_cfg.joint_query_adaptation": False},
    "normal_mvf": {
        "heatmap_mvf_cfg.mvf_cfg.mvf_transformer_cfg.use_normal_cross_attn": True},
    "normal_p3d": {"pose3d_cfg.transformer_cfg.use_normal_cross_attn": True},
    "no_pred_init": {"heatmap_mvf_cfg.use_pred_heatmap_init": False},
    "avgpool": {"pose3d_cfg.use_mlp_avgpool": True},
    "mlp_heatmap": {"pose3d_cfg.use_mlp_heatmap": True},
    "norm_mlp_pred": {"pose3d_cfg.norm_mlp_pred": True,
                      "pose3d_cfg.coor_norm_min": [-100.0, -100.0, -50.0],
                      "pose3d_cfg.coor_norm_max": [100.0, 100.0, 150.0]},
    "head512": {"heatmap_mvf_cfg.encoder_cfg.neck_cfg.out_channels": 512,
                "heatmap_mvf_cfg.mvf_cfg.input_dims": 512,
                "pose3d_cfg.input_dims": 512},
}
# Every dropout of a branch's train step at this rate (the three keys).
BRANCH_DROPOUT = 0.1
DROPOUT_KEYS = ("heatmap_mvf_cfg.mvf_cfg.mvf_transformer_cfg.ffn_cfg.ffn_drop",
                "pose3d_cfg.transformer_cfg.ffn_cfg.ffn_drop",
                "pose3d_cfg.mlp_dropout")
BRANCH_SERVE = (2, 5)  # warm-up and timed b16 bf16 forwards per branch
# The lazy sampling at the 512-channel head's shapes: 512 raw channels.
SHAPES_512 = {name: dict(shape, Cin=512) for name, shape in SHAPES.items()}
# The CLI runs of the branches on phase 12's tree: yaml -> its model_cfg
# keys to override (the stage-2 yaml's model_cfg is the flagship's
# ``heatmap_mvf_cfg``).
BRANCH_CLI = {
    "ego4view_syn_heatmap_mvfex-n1_jqa": {
        "mvf_cfg.use_1by1_conv": True,
        "mvf_cfg.mvf_transformer_cfg.ffn_cfg.ffn_drop": 0.1},
    "ego4view_syn_pose3d": {"pose3d_cfg.use_mlp_heatmap": True,
                            "heatmap_mvf_cfg.use_pred_heatmap_init": False},
}


def set_keys(cfg: dict, overrides: dict) -> dict:
    """``cfg`` with each dotted key of ``overrides`` set, in place."""
    for path, value in overrides.items():
        node = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = copy.deepcopy(value)
    return cfg


def branch_overrides(name: str, dropout: float = 0.0) -> dict:
    """The branch ``name`` with every dropout at ``dropout``, as the
    nested overrides that ``entry.build`` and ``entry.build_train`` take."""
    return set_keys({}, {**BRANCHES[name], **dict.fromkeys(DROPOUT_KEYS, dropout)})


def branch_orders(name: str) -> tuple:
    """The computation orders phase 15 runs a branch in: both, but the
    lazy one alone where the branch takes a stage off the sampling kernels
    (dense cross-attention), whose other stage phases 3b-6b cover."""
    dense = any(k.endswith("use_normal_cross_attn") for k in BRANCHES[name])
    return (True,) if dense else (True, False)


def branch_run(card, name: str, lazy: bool) -> dict:
    """One branch in one order on one seeded build: its eval-mode forward
    (:func:`check_forward`) and its train step with every dropout at
    :data:`BRANCH_DROPOUT` (:func:`check_train_step`), kernels vs plain;
    in the lazy order also the b16 bf16 serving forwards of the same weights
    BN-folded (:func:`serve`). Returns the serving run's launch counts (none
    in the reference order)."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.models.backbone import fold_batchnorm
    from egorear_tpu_torch.models.configs import EgoRearNetCfg
    from egorear_tpu_torch.models.pose3d import EgoRearNet

    tag = f"[15b{'' if lazy else ' reference'}]"
    task, trainer = entry.build_train(
        (TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32", seed=0, steps_per_epoch=1,
        warmup_iters=1, lazy_deform=lazy, imagenet=False,
        overrides=branch_overrides(name, BRANCH_DROPOUT))
    init = {k: v.to("cpu", copy=True) for k, v in task.model.state_dict().items()}
    task.model.eval()
    check_forward(card, task.model, task.rig, lazy, name, tag)
    check_train_step(card, task, trainer, lazy, name, tag, init, BRANCH_DROPOUT)
    if not lazy:
        return dict.fromkeys(KERNELS, 0)
    rig = task.rig
    del task, trainer
    cfg = set_keys(entry.flagship_cfg_dict((TRAIN_SIZE, TRAIN_SIZE), bn_folded=True),
                   BRANCHES[name])
    with torch.device(TRAIN_DEVICE):  # the module's own init on the card
        model = EgoRearNet(EgoRearNetCfg.from_dict(cfg))
    model.load_state_dict(fold_batchnorm(init), strict=True)
    model = model.to(device=TRAIN_DEVICE, dtype=torch.bfloat16).eval()
    return serve(card, model, rig, True, name, tag, BRANCH_SERVE)


def phase_branches(card, model_locs, workdir: str, cli: dict) -> dict:
    """Phase 15: the lazy kernels at the 512-channel head's shapes (fp32 and
    bf16, uniform and model locations) against their plain versions; each
    branch of :data:`BRANCHES` at full width in each of its orders
    (:func:`branch_run`); the CLI ``fit`` of stage 2 with ``use_1by1_conv``
    and dropout and of stage 3 with the heatmap proposal from the refined
    features, on phase 12's tree. Every run's launches exact. Returns the
    launch counts of the serving and CLI runs."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.models.configs import EgoRearNetCfg

    t0 = time.perf_counter()
    phase_kernels(card, model_locs, SHAPES_512, "[15a]")
    phase_backward_kernels(card, model_locs, SHAPES_512, "[15a]")
    total = dict.fromkeys(KERNELS, 0)
    for name in BRANCHES:
        t = time.perf_counter()
        for lazy in branch_orders(name):
            for k, v in branch_run(card, name, lazy).items():
                total[k] += v
        print(f"[15b] {name} {time.perf_counter() - t:.1f} s | {card}", flush=True)
    t1 = time.perf_counter()
    for name, keys in BRANCH_CLI.items():
        stage2 = name.endswith("jqa")
        cfg = EgoRearNetCfg.from_dict(set_keys(entry.flagship_cfg_dict(), {
            ("heatmap_mvf_cfg." if stage2 else "") + k: v for k, v in keys.items()}))
        # Each step's backward reaches every layer its forward launched in.
        per = launches_mvfex(cfg=cfg) if stage2 else launches_per_forward(cfg=cfg)
        extra = [a for k, v in keys.items()
                 for a in (f"--model.model_cfg.{k}", json.dumps(v))]
        graft = cli["grafts"] if stage2 else [
            "--model.heatmap_estimator_mvf_pretrained", cli["stage2"]]
        _, launched, _, _ = cli_fit(card, name, cli["root"],
                                    os.path.join(workdir, "branches"),
                                    CLI_TRAIN_FRAMES, per, graft + extra, None,
                                    tag=f"[15c] {' '.join(extra[::2])}:")
        for k, v in launched.items():
            total[k] += v
    print(f"[15] phase 15 {time.perf_counter() - t0:.1f} s (CLI "
          f"{time.perf_counter() - t1:.1f} s) | {card}", flush=True)
    return total


# Phase 16: data-parallel training (the JAX package's ``data`` mesh axis,
# ``egorear_tpu_torch.parallel``) and ``remat``. One card holds both ranks
# of 16a over gloo (NCCL needs a card per rank, and refuses otherwise).
DP_RANKS = 2
DP_TIMED = 1  # timed steps after the checked first one, on each side
DP_EVAL_TOL = 1e-5  # validate: two ranks vs one process, each metric


def _sync() -> None:
    if torch.cuda.is_available():  # a CPU rehearsal has nothing to wait for
        torch.cuda.synchronize()


def _release_cache() -> None:
    """Hand this process's cached, unused device memory back to the card,
    for ranks in other processes to allocate (earlier phases leave tens of
    GiB in PyTorch's cache)."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak_gib() -> float:
    return (torch.cuda.max_memory_allocated() / 2**30
            if torch.cuda.is_available() else 0.0)


def state_hash(model, keep=lambda key: True) -> str:
    """sha256 of the bytes of every parameter and buffer whose key ``keep``
    takes, in key order; ``model`` may also be a state dict."""
    import hashlib

    h = hashlib.sha256()
    sd = model if isinstance(model, dict) else model.state_dict()
    for k, v in sd.items():
        if keep(k):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_task(stage: str, parallel: dict | None = None):
    """Stage 2 or the stage-3 cascade at the yamls' width and depth, fp32,
    lazy order, lr warmed over one step (so that AdamW's first step moves
    the parameters), no ImageNet (the start state is loaded); ``parallel``
    shards it over the model axis (``entry.build_train``'s)."""
    from egorear_tpu_torch import entry

    if stage == "stage2":
        return entry.build_stage2((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, seed=0,
                                  steps_per_epoch=1, warmup_iters=1, imagenet=False,
                                  parallel=parallel)
    return entry.build_train((TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32", seed=0,
                             steps_per_epoch=1, warmup_iters=1, imagenet=False,
                             parallel=parallel)


def dp_batch(stage: str, gen) -> dict:
    """The stage's seeded global batch (b64 stage 2, b32 stage 3)."""
    if stage == "stage2":
        return stage_batch(STAGE_B, 4, TRAIN_SIZE, gen)
    return train_batch(STAGE3_B, TRAIN_SIZE, gen)


def dp_launches(stage: str, steps: int) -> dict:
    """Lazy launches of ``steps`` steps of a stage, in each rank as in one
    process: 4 + 4 a stage-2 step, 7 + 7 a stage-3 step."""
    return stage2_launches(steps) if stage == "stage2" else expected_launches(
        True, steps, steps)


@contextlib.contextmanager
def pinned_anchors(anchors: list, rows: slice | None = None,
                   flips: list | None = None):
    """With ``rows`` None, records the outputs of every
    ``HeatmapMVFexNet.get_anchors_2d`` (the refiners' argmax anchors and
    their validity) and ``CameraRig.project`` (the lifter's projected
    anchors, in-view flags and mutated anchors) call inside, in call order,
    into ``anchors``. Otherwise the i-th call returns the i-th record's
    ``rows`` (every output is batch-major) and appends to ``flips`` how many
    of its own elements differed. An argmax near a tie or a point near the
    0.5 threshold or a view's edge moves a whole sampling path under a
    rounding-sized change, as a ReLU near its kink does (:func:`pinned_relus`);
    gradients then differ by a large share of their scale."""
    from egorear_tpu_torch.models.mvfex import HeatmapMVFexNet
    from egorear_tpu_torch.ops.camera import CameraRig

    originals = {HeatmapMVFexNet: HeatmapMVFexNet.get_anchors_2d,
                 CameraRig: CameraRig.project}
    calls = [0]

    def pin(fn):
        @functools.wraps(fn)
        def pinned(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            if rows is None:
                anchors.append(tuple(t.detach().clone() for t in out))
                return out
            want = tuple(t[rows] for t in anchors[calls[0]])
            calls[0] += 1
            flips.append(sum(int((o != w).sum()) for o, w in zip(out, want)))
            return want
        return pinned

    HeatmapMVFexNet.get_anchors_2d = pin(originals[HeatmapMVFexNet])
    CameraRig.project = pin(originals[CameraRig])
    try:
        yield
    finally:
        HeatmapMVFexNet.get_anchors_2d = originals[HeatmapMVFexNet]
        CameraRig.project = originals[CameraRig]


def first_step(trainer, batch, pin=contextlib.nullcontext) -> dict:
    """One step on ``batch`` inside ``pin()``: its lr, and its gradients,
    updated parameters and BN running stats copied to the host."""
    model = trainer.task.model
    with pin():
        lr = float(trainer.train_step(batch)["lr"])
    return dict(lr=lr, grads={n: p.grad.to("cpu", copy=True)
                              for n, p in model.named_parameters()},
                params={n: p.detach().to("cpu", copy=True)
                        for n, p in model.named_parameters()},
                stats={k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
                       if "running" in k})


def dp_steps(trainer, batch, pin=contextlib.nullcontext) -> dict:
    """:func:`first_step`, then DP_TIMED timed steps; the launch counts
    over all of them, the final state's hash, the peak memory."""
    model = trainer.task.model
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first = first_step(trainer, batch, pin)
    _sync()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        trainer.train_step(batch)
    _sync()
    ms = (time.perf_counter() - t0) / DP_TIMED * 1e3
    return dict(first=first, ms=ms, launched=read_launches(),
                hash=state_hash(model), peak=_peak_gib())


def dp_rank(spec: dict) -> dict:
    """A rank of phase 16a: for each stage, the start state the parent
    wrote, the parent's seeded global batch regenerated on this rank's card
    and this rank's rows of it, :func:`dp_steps` with the first step's
    anchors pinned to the parent's rows; rank 0 writes its first step to
    the parent's file."""
    from egorear_tpu_torch.parallel import dist

    globals().update(spec["globals"])  # the parent's settings (a rehearsal's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for stage, (start, seed, path, anchor_path) in spec["stages"].items():
        task, trainer = dp_task(stage)
        task.model.load_state_dict(torch.load(start, map_location=TRAIN_DEVICE,
                                              weights_only=True))
        batch = dp_batch(stage, torch.Generator(device=TRAIN_DEVICE).manual_seed(seed))
        rows = trainer.shard.rows(batch["img"].shape[0])
        anchors = torch.load(anchor_path, map_location=TRAIN_DEVICE, weights_only=True)
        flips = []
        out[stage] = dp_steps(trainer, {k: v[rows] for k, v in batch.items()},
                              functools.partial(pinned_anchors, anchors, rows, flips))
        out[stage]["flips"] = flips
        first = out[stage].pop("first")
        if dist.rank() == 0:
            torch.save(first, path)
        del task, trainer, batch
    return out


def phase_data_parallel(card, workdir: str) -> dict:
    """16a: stage 2 (b64) and stage 3 (b32), fp32, lazy order, at full
    width: two ranks on the one card over gloo (``parallel.dist.spawn``)
    and one process, from the same state on the same global batch: the
    first step's gradients, parameters and BN running stats against each
    other (:func:`hold_step`, the anchors of all three pinned to the one
    process's, :func:`pinned_anchors`; a leaf's noise is how far NOISE_ULPS
    ulps of parameter noise move the one-process gradient), the ranks' states
    bitwise equal after
    1 + DP_TIMED steps, each rank's launches exact. Every stage is checked
    before any failure is raised. Returns the ranks' launch counts,
    summed, and each stage's one-process reference (start state, batch
    seed, recorded anchors, first step, noise, peak), which phase 17 holds
    its ranks to."""
    from egorear_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    spec = dict(globals={k: globals()[k] for k in (
        "TRAIN_DEVICE", "TRAIN_SIZE", "STAGE_B", "STAGE3_B", "LAUNCHES_PER_LAYER",
        "DP_TIMED")}, stages={})
    one, noise = {}, {}
    for stage, seed in (("stage2", 16), ("stage3", 17)):
        task, trainer = dp_task(stage)
        gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(seed)
        batch = dp_batch(stage, gen)
        perturb_train_(task.model, batch, gen)  # valid anchors: the refiners learn
        start = os.path.join(workdir, f"dp_{stage}_start.pt")
        torch.save(task.model.state_dict(), start)
        # The one process's step, its anchors recorded; then from the same
        # state with NOISE_ULPS ulps of noise on every parameter, the anchors
        # pinned, NOISE_DRAWS times: how far its gradients move is the
        # step's conditioning.
        anchors, flips = [], []
        one[stage] = dp_steps(trainer, batch, functools.partial(pinned_anchors, anchors))
        noise[stage] = dict.fromkeys(one[stage]["first"]["grads"], 0.0)
        for draw in range(NOISE_DRAWS):
            task.model.load_state_dict(torch.load(start, map_location=TRAIN_DEVICE,
                                                  weights_only=True))
            signs = torch.Generator(device=TRAIN_DEVICE).manual_seed(draw)
            with torch.no_grad():
                for p in task.model.parameters():
                    flip = torch.randint(0, 2, p.shape, generator=signs, device=p.device)
                    p.mul_(1 + (2 * flip - 1).to(p.dtype) * NOISE_ULPS * 2.0**-23)
            trainer.init_state(steps_per_epoch=1)
            jittered = first_step(trainer, batch, functools.partial(
                pinned_anchors, anchors, slice(None), flips))
            for n, g in one[stage]["first"]["grads"].items():
                noise[stage][n] = max(noise[stage][n],
                                      float((g - jittered["grads"][n]).abs().max()))
        one[stage]["flips"] = flips
        anchor_path = os.path.join(workdir, f"dp_{stage}_anchors.pt")
        torch.save(anchors, anchor_path)
        spec["stages"][stage] = (start, seed, os.path.join(workdir, f"dp_{stage}_rank0.pt"),
                                 anchor_path)
        del task, trainer, batch, jittered
    _release_cache()
    t1 = time.perf_counter()
    ranks = dist.spawn(dp_rank, DP_RANKS, spec, device=TRAIN_DEVICE, backend="gloo")
    t_ranks = time.perf_counter() - t1
    total, failed = dict.fromkeys(KERNELS, 0), []
    for stage, B in (("stage2", STAGE_B), ("stage3", STAGE3_B)):
        want = dp_launches(stage, 1 + DP_TIMED)
        got = [r[stage] for r in ranks]
        if one[stage]["launched"] != want or any(g["launched"] != want for g in got):
            failed.append(f"{stage} launched {one[stage]['launched']} (one "
                          f"process), {[g['launched'] for g in got]} (ranks), "
                          f"expected {want} each")
        if len({g["hash"] for g in got}) != 1:
            failed.append(f"{stage}: the ranks' states differ after "
                          f"{1 + DP_TIMED} steps")
        for k, v in got[0]["launched"].items():
            total[k] += v * DP_RANKS
        ms = max(g["ms"] for g in got)
        rank0 = torch.load(spec["stages"][stage][2], weights_only=True)
        grads = one[stage]["first"]["grads"]
        floor = TRAIN_GRAD_FLOOR * max(float(w.abs().max()) for w in grads.values())
        leaves = sorted(((float((rank0["grads"][n] - w).abs().max()), noise[stage][n],
                          float(w.abs().max()), n)
                         for n, w in grads.items() if float(w.abs().max()) >= floor),
                        key=lambda t: -t[0] / t[2])
        worst = "; ".join(f"{n} {e / sc:.2e} vs {j / sc:.2e}" for e, j, sc, n in leaves[:4])
        print(f"[16a] {stage} {TRAIN_SIZE}px B={B} fp32: {B * 1e3 / ms:.1f} samples/s "
              f"on {DP_RANKS} ranks x B={B // DP_RANKS} sharing one card over gloo "
              f"({ms:.1f} ms/step, {DP_TIMED} steps, host clock, the slower rank; "
              f"peak {max(g['peak'] for g in got):.2f} GiB a rank) vs "
              f"{B * 1e3 / one[stage]['ms']:.1f} in one process ({one[stage]['ms']:.1f}"
              f" ms/step, peak {one[stage]['peak']:.2f} GiB): not a speed result; "
              f"anchor elements pinned that differed: {one[stage]['flips']} (one "
              f"process, {NOISE_ULPS}-ulp noise), {[g['flips'] for g in got]} (ranks); the "
              f"leaves furthest off, max-abs/scale, ranks vs {NOISE_ULPS}-ulp noise's move: "
              f"{worst} | {card}", flush=True)
        try:
            r = hold_step(rank0, one[stage]["first"], noise[stage])
        except AssertionError as e:
            failed.append(f"{stage}: {e}")
            continue
        print(f"[16a] {stage} {TRAIN_SIZE}px B={B} fp32 lazy order, {DP_RANKS} ranks "
              f"x B={B // DP_RANKS} on one card over gloo vs one process: worst leaf "
              f"gradient max-abs/scale {r['worst_grad']:.3e} ({r['worst_name']}, tol "
              f"{TRAIN_GRAD_TOL:g}; {r['n_floor']} leaves below the floor "
              f"{r['floor']:.1e}; {r['n_noise']} held at {NOISE_FACTOR:g}x their "
              f"move under {NOISE_ULPS}-ulp noise); params after the first "
              f"step {r['worst_tight']:.3e} "
              f"where the gradient is determined, {r['worst_loose']:.3e} elsewhere "
              f"(Adam bound 2 lr = {2 * one[stage]['first']['lr']:.1e}); BN running "
              f"stats {r['stat_err']:.3e} (tol {TRAIN_STAT_TOL:g}); the ranks' "
              f"states bitwise equal after {1 + DP_TIMED} steps; launches a rank "
              f"lazy_deform_sample {got[0]['launched']['lazy_deform_sample']}, "
              f"lazy_deform_sample_bwd {got[0]['launched']['lazy_deform_sample_bwd']} "
              f"= {1 + DP_TIMED} steps x {want['lazy_deform_sample'] // (1 + DP_TIMED)}"
              f" at kernel batch {4 * B // DP_RANKS} | {card}", flush=True)
    print(f"[16a] {time.perf_counter() - t0:.1f} s (ranks {t_ranks:.1f} s) | {card}",
          flush=True)
    if failed:
        raise AssertionError("[16a] " + " | ".join(failed))
    refs = {stage: dict(start=start, seed=seed, anchors=anchors, first=one[stage]["first"],
                        noise=noise[stage], peak=one[stage]["peak"])
            for stage, (start, seed, _, anchors) in spec["stages"].items()}
    return total, refs


def cli_rank(argv: list) -> dict:
    """A rank of 16b: ``run.main(argv)`` (the group is up, as under
    ``torchrun``) with the launch counts from 0 over it; a ``fit`` returns
    the epoch's steps, the state's hash and rank 0's version directory, the
    others their metrics."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.train.trainer import Trainer

    reset_launches()
    result = run.main(argv)
    _sync()
    out = dict(launched=read_launches())
    if isinstance(result, Trainer):
        out.update(steps=result.epoch_times[0][1], hash=state_hash(result.task.model),
                   log_dir=result.logger.dir)
    else:
        out["metrics"] = result
    return out


@contextlib.contextmanager
def torchrun_env(world: int = 1):
    """The environment ``torchrun`` gives rank 0 of ``world``, on this host."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with contextlib.ExitStack() as stack:
        for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world),
                         LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                         MASTER_PORT=str(port)).items():
            stack.enter_context(env_var(k, v))
        yield


def phase_cli_data_parallel(card, workdir: str, cli: dict) -> dict:
    """16b: stage 2 through the CLI on phase 12's tree (grafted from its
    stage-1 checkpoints): ``--trainer.devices 2`` with NCCL refused on one
    card; ``fit`` as rank 0 of a one-rank NCCL group (``torchrun``'s
    environment); ``fit`` on two ranks over gloo on the one card, each
    running ``run.main`` in a group of ``parallel.dist.spawn``, as
    ``--trainer.devices 2`` starts it; with two cards or more also ``fit``
    with ``--trainer.devices 2`` over NCCL. Every rank's launches exact,
    the ranks' states bitwise equal, rank 0's checkpoint. Then
    ``validate`` of that checkpoint with ``--trainer.devices 2`` (gloo,
    ``run.main``'s own spawn): the same metrics on both ranks, within
    DP_EVAL_TOL of the one-process ``validate``. Returns the launch counts
    of the in-process runs and the ranks, summed."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    yaml_path = os.path.join(CONFIGS, "ego4view_syn_heatmap_mvfex-n1_jqa.yaml")
    base = ["--config", yaml_path, "--model.data_root", cli["root"],
            "--device", TRAIN_DEVICE] + CLI_OVERRIDES
    B = int(load_config(yaml_path, base[2:]).init_args["batch_size"])
    steps, per = CLI_TRAIN_FRAMES // B, launches_mvfex()
    want = cli_launches(steps + 1, steps, per)  # each rank: every step, one val batch

    def fit(name, devices):
        return (["fit"] + base + cli["grafts"] + [
            "--trainer.max_epochs", "1", "--trainer.devices", str(devices),
            "--trainer.save_dir", os.path.join(workdir, "cli_dp", name)])

    total = dict.fromkeys(KERNELS, 0)

    def add(launched, n=1):
        for k, v in launched.items():
            total[k] += n * v

    cards = torch.cuda.device_count()
    if TRAIN_DEVICE == "cuda" and cards < DP_RANKS:
        try:
            run.main(fit("nccl_refused", DP_RANKS))
        except ValueError as e:
            if "NCCL needs one CUDA card per rank" not in str(e):
                raise
            refused = str(e).split(".")[0]
        else:
            raise AssertionError("[16b] NCCL took two ranks on one card")
    with torchrun_env(1):
        trainer, launched, _ = cli_run(fit("nccl_1", 1))
    if dist.is_initialized() or trainer.epoch_times[0][1] != steps or launched != want:
        raise AssertionError(f"[16b] NCCL world 1: {trainer.epoch_times} launched "
                             f"{launched}, expected {steps} steps, {want}")
    add(launched)
    del trainer
    _release_cache()
    ranks = dist.spawn(cli_rank, DP_RANKS, fit("gloo_2", DP_RANKS),
                       device=TRAIN_DEVICE, backend="gloo")
    for r in ranks:
        if r["steps"] != steps or r["launched"] != want:
            raise AssertionError(f"[16b] gloo rank: {r['steps']} steps launched "
                                 f"{r['launched']}, expected {steps}, {want}")
        add(r["launched"])
    ckpt = os.path.join(ranks[0]["log_dir"], "checkpoints", "epoch=0.pt")
    if (len({r["hash"] for r in ranks}) != 1 or ranks[1]["log_dir"] is not None
            or not os.path.exists(ckpt)
            or not os.path.exists(os.path.join(ranks[0]["log_dir"], "metrics.csv"))):
        raise AssertionError(f"[16b] gloo ranks: states equal "
                             f"{len({r['hash'] for r in ranks}) == 1}, log dirs "
                             f"{[r['log_dir'] for r in ranks]}, checkpoint "
                             f"{os.path.exists(ckpt)}")
    nccl2 = ""
    if cards >= DP_RANKS:
        run.main(fit("nccl_2", DP_RANKS))
        if not glob_one(os.path.join(workdir, "cli_dp", "nccl_2", "lightning_logs",
                                     "version_*", "checkpoints", "epoch=0.pt")):
            raise AssertionError("[16b] NCCL on two cards wrote no checkpoint")
        nccl2 = f"; fit over NCCL on {DP_RANKS} of the {cards} cards"
    val = ["validate"] + base + ["--ckpt_path", ckpt]
    import io

    with contextlib.redirect_stdout(io.StringIO()):  # the ranks' own prints go through
        per_rank = run.main(val + ["--trainer.devices", str(DP_RANKS)], backend="gloo")
    one, launched, _ = cli_run(val + ["--trainer.devices", "1"])
    add(launched)
    if any(m != per_rank[0] for m in per_rank[1:]):
        raise AssertionError(f"[16b] validate differs between ranks: {per_rank}")
    worst = max(abs(per_rank[0][k] - v) / max(1.0, abs(v)) for k, v in one.items())
    if sorted(one) != sorted(per_rank[0]) or not worst <= DP_EVAL_TOL:
        raise AssertionError(f"[16b] validate on {DP_RANKS} ranks vs one process: "
                             f"{worst:.3e} (tol {DP_EVAL_TOL:g})")
    print(f"[16b] CLI stage 2 B={B} on phase 12's tree: "
          + (f"--trainer.devices {DP_RANKS} over NCCL refused ({refused}); "
             if TRAIN_DEVICE == "cuda" and cards < DP_RANKS else "")
          + f"fit as rank 0 of a one-rank NCCL group ({steps} steps, launches "
          f"lazy_deform_sample {want['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{want['lazy_deform_sample_bwd']}); fit on {DP_RANKS} ranks over gloo on "
          f"one card, each rank the same launches at B={B // DP_RANKS}, their "
          f"states bitwise equal, rank 0's epoch=0.pt and metrics.csv{nccl2}; "
          f"validate on {DP_RANKS} ranks: the same {len(one)} metrics on each, "
          f"{worst:.3e} from the one process's (tol {DP_EVAL_TOL:g}); "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return total


def glob_one(pattern: str) -> bool:
    import glob

    return len(glob.glob(pattern)) == 1


def phase_remat(card) -> dict:
    """16c: one b32 fp32 stage-3 step with ``remat`` and one without, from
    the same state on the same batch: held to each other as phase 5's
    steps (:func:`hold_step`); the rematerialised step launches the
    forward kernels twice (its forward runs again in the backward). Prints
    both peaks. Returns the launch counts of both steps."""
    task, trainer = dp_task("stage3")
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(18)
    batch = train_batch(STAGE3_B, TRAIN_SIZE, gen)
    perturb_train_(task.model, batch, gen)
    start = {k: v.to("cpu", copy=True) for k, v in task.model.state_dict().items()}
    runs, total = {}, dict.fromkeys(KERNELS, 0)
    for remat in (False, True):
        task.model.load_state_dict(start)
        trainer.init_state(steps_per_epoch=1)
        trainer.cfg.remat = remat
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        lr = float(trainer.train_step(batch)["lr"])
        _sync()
        launched = read_launches()
        want = expected_launches(True, 2 if remat else 1, 1)
        if launched != want:
            raise AssertionError(f"[16c] remat={remat} launched {launched}, "
                                 f"expected {want}")
        for k, v in launched.items():
            total[k] += v
        model = task.model
        runs[remat] = dict(
            lr=lr, peak=_peak_gib(), launched=launched,
            grads={n: p.grad.detach().clone() for n, p in model.named_parameters()},
            params={n: p.detach().clone() for n, p in model.named_parameters()},
            stats={k: v.clone() for k, v in model.state_dict().items() if "running" in k})
    r = hold_step(runs[True], runs[False])
    print(f"[16c] stage 3 {TRAIN_SIZE}px B={STAGE3_B} fp32 step with remat vs "
          f"without: worst leaf gradient max-abs/scale {r['worst_grad']:.3e} "
          f"({r['worst_name']}, tol {TRAIN_GRAD_TOL:g}); params "
          f"{r['worst_tight']:.3e} where the gradient is determined, "
          f"{r['worst_loose']:.3e} elsewhere; BN running stats {r['stat_err']:.3e} "
          f"(tol {TRAIN_STAT_TOL:g}); peak {runs[True]['peak']:.2f} GiB with remat, "
          f"{runs[False]['peak']:.2f} GiB without; launches lazy_deform_sample "
          f"{runs[True]['launched']['lazy_deform_sample']} (forward and recompute) "
          f"vs {runs[False]['launched']['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {runs[True]['launched']['lazy_deform_sample_bwd']}"
          f" | {card}", flush=True)
    return total

# Phase 17: tensor parallelism over the model axis (the JAX package's
# ``model`` mesh axis; ``egorear_tpu_torch.parallel.tensor``). Both groups
# share the one card over gloo.
TP_M = 2  # the model axis of every part
TP_GRID_B = (2, 2)  # 17b: (data, model)
TP_MIN_DIM_B = 256  # 17b: row-, column-parallel and gathered leaves at full width
TP_STEPS = 3  # 17a, 17b: the checked first step and two more
TP_BF16_TOL = 1e-2  # 17a: a bf16-mixed step's loss terms, relative
TP_EVAL_TOL = 1e-6  # 17c: validate and predict, over max(1, |value|)
TP_CLI_B = 64  # 17c: 2 steps on phase 12's 128 frames


def replica_hashes(model) -> tuple:
    """(hash of the replicated entries, hash of the slices) of a rank's
    state dict."""
    from egorear_tpu_torch.parallel import tensor

    dims = tensor.placements(model)
    return (state_hash(model, lambda k: k not in dims),
            state_hash(model, lambda k: k in dims))


def gathered_step(trainer) -> dict:
    """The last step's gradients, parameters and BN running stats on the
    host, the sharded leaves gathered whole (a collective of the model
    group)."""
    from egorear_tpu_torch.parallel import dist, tensor

    model = trainer.task.model
    dims = tensor.placements(model)
    grads = {n: (dist.model_all_gather(p.grad, dims[n], trainer.shard) if n in dims
                 else p.grad).to("cpu", copy=True) for n, p in model.named_parameters()}
    sd = tensor.full_state_dict(model)
    return dict(grads=grads,
                params={n: sd[n].to("cpu", copy=True) for n in grads},
                stats={k: v.to("cpu", copy=True) for k, v in sd.items() if "running" in k})


def tp_steps(trainer, batch, anchors, rows, kept: bool, tag: str, card: str) -> dict:
    """A rank's TP_STEPS steps: the first with the anchors pinned to the
    one process's ``rows`` (and, with ``kept``, every launch kept and held
    against its plain version), gathered; then the rest, timed, the peak
    over them. The launch counts over all of them and the final hashes."""
    flips, calls = [], []
    reset_launches()
    with pinned_anchors(anchors, rows, flips), (
            kept_kernel_calls(calls) if kept else contextlib.nullcontext()):
        lr = float(trainer.train_step(batch)["lr"])
    first = dict(lr=lr, **gathered_step(trainer))
    if kept:
        hold_kept_calls(calls, tag, card)
    del calls
    _sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TP_STEPS - 1):
        trainer.train_step(batch)
    _sync()
    ms = (time.perf_counter() - t0) / (TP_STEPS - 1) * 1e3
    return dict(first=first, flips=flips, ms=ms, peak=_peak_gib(),
                launched=read_launches(), hashes=replica_hashes(trainer.task.model))


def tp_stage_rank(part: dict, card: str) -> dict:
    """17a or 17b in a rank: the stage sharded by ``part["parallel"]``,
    16a's start state and batch, :func:`tp_steps`; 17a also one bf16-mixed
    step from the start state. Rank 0 writes its gathered first step to
    ``part["out"]`` and returns the sharded leaves' axes and full shapes."""
    from egorear_tpu_torch.parallel import dist, tensor

    stage, ref = part["stage"], part["ref"]
    task, trainer = dp_task(stage, part["parallel"])
    start = torch.load(ref["start"], map_location=TRAIN_DEVICE, weights_only=True)
    tensor.load_full_state_dict(task.model, start)
    batch = dp_batch(stage, torch.Generator(device=TRAIN_DEVICE).manual_seed(ref["seed"]))
    rows = trainer.shard.rows(batch["img"].shape[0])
    batch = {k: v[rows] for k, v in batch.items()}
    anchors = torch.load(ref["anchors"], map_location=TRAIN_DEVICE, weights_only=True)
    out = tp_steps(trainer, batch, anchors, rows, part["kept"], part["tag"], card)
    first = out.pop("first")
    if dist.rank() == 0:
        torch.save(first, part["out"])
    del first
    out["grid"] = (trainer.shard.rank, trainer.shard.world, trainer.shard.model_rank)
    dims = tensor.placements(task.model)
    out["placements"] = {k: (d, tuple(start[k].shape)) for k, d in dims.items()}
    if part.get("bf16"):
        tensor.load_full_state_dict(task.model, start)
        trainer.init_state(steps_per_epoch=1)
        trainer.cfg.precision = "bf16-mixed"
        reset_launches()
        out["bf16"] = {k: float(v) for k, v in trainer.train_step(batch).items()}
        _sync()
        out["bf16_launched"] = read_launches()
    return out


def tp_cli_rank(argvs: list) -> list:
    """17c in a rank: each ``run.main(argv)`` in the group, with the launch
    counts from 0 over it, an argument ``{ckpt}`` replaced by the last
    ``fit``'s ``epoch=0.pt`` (rank 0's, broadcast): a ``fit`` returns its
    steps, rank 0's version directory and the hash of the gathered state;
    ``validate`` its metrics; ``predict`` rank 0's path."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.parallel import dist, tensor
    from egorear_tpu_torch.train.trainer import Trainer

    out, ckpt = [], None
    for argv in argvs:
        reset_launches()
        result = run.main([ckpt if a == "{ckpt}" else a for a in argv])
        _sync()
        r = dict(launched=read_launches())
        if isinstance(result, Trainer):
            r.update(steps=result.epoch_times[0][1], log_dir=result.logger.dir,
                     hash=state_hash(tensor.full_state_dict(result.task.model)))
            ckpt = dist.broadcast_object(None if r["log_dir"] is None else os.path.join(
                r["log_dir"], "checkpoints", "epoch=0.pt"))
        else:
            r["result"] = result
        out.append(r)
    return out


def tp_head512_rank(card: str) -> dict:
    """17d in a rank: the 512-channel head built (the full seeded model,
    then this rank's slices) and one b2 fp32 step at M = TP_M: the build's
    seconds, the step's peak and launches, the loss."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.parallel import tensor

    t0 = time.perf_counter()
    task, trainer = entry.build_train(
        (TRAIN_SIZE, TRAIN_SIZE), TRAIN_DEVICE, "32", seed=0, steps_per_epoch=1,
        warmup_iters=1, imagenet=False, overrides=branch_overrides("head512"),
        parallel=dict(model_parallel=TP_M))
    _sync()
    build = time.perf_counter() - t0
    batch = train_batch(TRAIN_BATCH, TRAIN_SIZE,
                        torch.Generator(device=TRAIN_DEVICE).manual_seed(19))
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss = float(trainer.train_step(batch)["loss_total"])
    _sync()
    dims = tensor.placements(task.model)
    w = task.model.pose3d_estimator.mlp_pred_0._parameters["weight"]
    return dict(build=build, peak=_peak_gib(), launched=read_launches(), loss=loss,
                slice=tuple(w.shape), dim=dims.get("pose3d_estimator.mlp_pred_0.weight"),
                expected=expected_launches(True, 1, 1, task.cfg))


def tp_rank(spec: dict) -> dict:
    """A rank of phase 17's groups: the parts ``spec["parts"]`` names, in
    order; ranks other than 0 print nothing."""
    import io

    from egorear_tpu_torch.parallel import dist

    globals().update(spec["globals"])  # the parent's settings (a rehearsal's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    quiet = (contextlib.redirect_stdout(io.StringIO()) if dist.rank()
             else contextlib.nullcontext())
    with quiet:
        for name, part in spec["parts"].items():
            if name == "17c":
                out[name] = tp_cli_rank(part)
            elif name == "17d":
                out[name] = tp_head512_rank(spec["card"])
            else:
                out[name] = tp_stage_rank(part, spec["card"])
    return out


def hold_tp_stage(tag: str, stage: str, B: int, grid: tuple, ranks: list,
                  ref: dict, path: str, card: str, failed: list) -> dict:
    """17a/17b in the parent: every rank's launches exact, its grid place,
    the replicated leaves bitwise equal on every rank and each slice equal
    across its data group, rank 0's gathered first step held to the one
    process's by 16a's rule; prints the sharded leaves and the peaks.
    Appends failures to ``failed``; returns the launch counts, summed."""
    D, M = grid
    want = dp_launches(stage, TP_STEPS)
    total = dict.fromkeys(KERNELS, 0)
    for i, r in enumerate(ranks):
        if r["launched"] != want:
            failed.append(f"{tag} rank {i} launched {r['launched']}, expected {want}")
        if r["grid"] != (i // M, D, i % M):
            failed.append(f"{tag} rank {i} at {r['grid']}, expected ({i // M}, {D}, {i % M})")
        for k, v in r["launched"].items():
            total[k] += v
    if len({r["hashes"][0] for r in ranks}) != 1:
        failed.append(f"{tag} the replicated leaves differ between ranks after "
                      f"{TP_STEPS} steps")
    if any(len({ranks[d * M + m]["hashes"][1] for d in range(D)}) != 1
           for m in range(M)) or len({ranks[m]["hashes"][1] for m in range(M)}) != M:
        failed.append(f"{tag} the slices are not the same across each data group "
                      f"and different across the model group")
    shards = ", ".join(f"{k} {tuple(shape)} dim {d}"
                       for k, (d, shape) in sorted(ranks[0]["placements"].items()))
    n = len(ranks[0]["placements"])
    print(f"{tag} {stage} {TRAIN_SIZE}px B={B} fp32 on a {D} x {M} (data x model) grid "
          f"of {D * M} ranks sharing one card over gloo: {n} sharded leaves"
          + (f": {shards}" if n <= 16 else f" (first 12: "
             + ", ".join(shards.split(", ")[:12]) + ")")
          + f" | {card}", flush=True)
    rank0 = torch.load(path, weights_only=True)
    try:
        r = hold_step(rank0, ref["first"], ref["noise"])
    except AssertionError as e:
        failed.append(f"{tag} {stage}: {e}")
        return total
    print(f"{tag} {stage} B={B}, {D} x {M} ranks vs one process (phase 16a's, the same "
          f"state and batch): worst leaf gradient max-abs/scale {r['worst_grad']:.3e} "
          f"({r['worst_name']}, tol {TRAIN_GRAD_TOL:g}; {r['n_floor']} leaves below the "
          f"floor {r['floor']:.1e}; {r['n_noise']} held at {NOISE_FACTOR:g}x their move "
          f"under {NOISE_ULPS}-ulp noise); params {r['worst_tight']:.3e} where the "
          f"gradient is determined, {r['worst_loose']:.3e} elsewhere (Adam bound 2 lr "
          f"= {2 * ref['first']['lr']:.1e}); BN running stats {r['stat_err']:.3e} (tol "
          f"{TRAIN_STAT_TOL:g}); anchor elements pinned that differed "
          f"{[x['flips'] for x in ranks]}; replicated leaves bitwise equal on all "
          f"{D * M} ranks after {TP_STEPS} steps, slices equal across each data group; "
          f"launches a rank lazy_deform_sample {want['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {want['lazy_deform_sample_bwd']} = {TP_STEPS} steps "
          f"x {want['lazy_deform_sample'] // TP_STEPS} at kernel batch "
          f"{4 * B // D}; peak {max(x['peak'] for x in ranks):.2f} GiB a rank "
          f"(steps 2-{TP_STEPS}) vs {ref['peak']:.2f} GiB in one process (16a); "
          f"{max(x['ms'] for x in ranks):.1f} ms/step, host clock, not a speed "
          f"result | {card}", flush=True)
    return total


def phase_tensor_parallel(card, workdir: str, cli: dict, refs: dict) -> dict:
    """Phase 17 (see the module's docstring): the NCCL refusal and the
    one-process bf16 step here, then a two-rank group (17a, 17c's three
    runs, 17d) and a four-rank group (17b), then each part held to its
    one-process reference. Every part is checked before any failure is
    raised. Returns the ranks' launch counts, summed."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    failed = []
    yaml_path = os.path.join(CONFIGS, "ego4view_syn_pose3d.yaml")
    base = ["--config", yaml_path, "--model.data_root", cli["root"],
            "--device", TRAIN_DEVICE] + CLI_OVERRIDES + [
                "--model.batch_size", str(TP_CLI_B)]
    tp_flags = ["--trainer.devices", str(TP_M), "--trainer.model_parallel", str(TP_M)]
    fit = (["fit"] + base + ["--model.heatmap_estimator_mvf_pretrained", cli["stage2"],
                             "--trainer.max_epochs", "1", "--trainer.save_dir",
                             os.path.join(workdir, "cli_tp", "fit")] + tp_flags)
    refused = ""
    if TRAIN_DEVICE == "cuda" and torch.cuda.device_count() < TP_M:
        try:
            run.main(fit)
        except ValueError as e:
            if "NCCL needs one CUDA card per rank" not in str(e):
                raise
            refused = str(e).split(".")[0]
        else:
            raise AssertionError("[17c] NCCL took two ranks on one card")

    # 17a's one-process bf16-mixed step from 16a's start state.
    task, trainer = dp_task("stage3")
    start = torch.load(refs["stage3"]["start"], map_location=TRAIN_DEVICE,
                       weights_only=True)
    task.model.load_state_dict(start)
    trainer.cfg.precision = "bf16-mixed"
    batch = dp_batch("stage3", torch.Generator(device=TRAIN_DEVICE).manual_seed(
        refs["stage3"]["seed"]))
    one_bf16 = {k: float(v) for k, v in trainer.train_step(batch).items()}
    del task, trainer, batch, start
    _release_cache()

    paths = {t: os.path.join(workdir, f"tp_{t}_rank0.pt") for t in ("17a", "17b")}
    settings = {k: globals()[k] for k in (
        "TRAIN_DEVICE", "TRAIN_SIZE", "STAGE_B", "STAGE3_B", "LAUNCHES_PER_LAYER",
        "TRAIN_BATCH", "CLI_OVERRIDES")}
    part_a = dict(stage="stage3", ref={k: refs["stage3"][k] for k in
                                       ("start", "seed", "anchors")},
                  parallel=dict(model_parallel=TP_M), kept=True, bf16=True,
                  tag="[17a]", out=paths["17a"])
    val = ["validate"] + base + tp_flags + ["--ckpt_path", "{ckpt}"]
    pred = ["predict"] + base + tp_flags + ["--ckpt_path", "{ckpt}", "--trainer.save_dir",
                                            os.path.join(workdir, "cli_tp", "predict")]
    t1 = time.perf_counter()
    two = dist.spawn(tp_rank, TP_M, dict(globals=settings, card=card, parts={
        "17a": part_a, "17c": [fit, val, pred], "17d": None}),
        device=TRAIN_DEVICE, backend="gloo")
    t_two = time.perf_counter() - t1
    D, M = TP_GRID_B
    part_b = dict(stage="stage2", ref={k: refs["stage2"][k] for k in
                                       ("start", "seed", "anchors")},
                  parallel=dict(model_parallel=M, tp_min_dim=TP_MIN_DIM_B), kept=False,
                  tag="[17b]", out=paths["17b"])
    t1 = time.perf_counter()
    four = dist.spawn(tp_rank, D * M, dict(globals=settings, card=card,
                                           parts={"17b": part_b}),
                      device=TRAIN_DEVICE, backend="gloo")
    t_four = time.perf_counter() - t1

    total = dict.fromkeys(KERNELS, 0)

    def add(launched):
        for k, v in launched.items():
            total[k] += v

    # 17a
    ranks_a = [r["17a"] for r in two]
    add(hold_tp_stage("[17a]", "stage3", STAGE3_B, (1, TP_M), ranks_a, refs["stage3"],
                      paths["17a"], card, failed))
    want1 = expected_launches(True, 1, 1)
    worst = max(abs(ranks_a[0]["bf16"][k] - v) / abs(v) for k, v in one_bf16.items()
                if k != "lr")
    for r in ranks_a:
        add(r["bf16_launched"])
        if r["bf16_launched"] != want1:
            failed.append(f"[17a] bf16 step launched {r['bf16_launched']}, expected {want1}")
    if not worst <= TP_BF16_TOL or ranks_a[0]["bf16"] != ranks_a[1]["bf16"]:
        failed.append(f"[17a] bf16-mixed loss terms {worst:.3e} from one process's "
                      f"(tol {TP_BF16_TOL:g}), or different between the ranks")
    print(f"[17a] one bf16-mixed step from the same state: loss terms within "
          f"{worst:.3e} of one process's, relative (tol {TP_BF16_TOL:g}), the same on "
          f"both ranks; loss_total {ranks_a[0]['bf16']['loss_total']:.6f} vs "
          f"{one_bf16['loss_total']:.6f} | {card}", flush=True)

    # 17b
    add(hold_tp_stage("[17b]", "stage2", STAGE_B, TP_GRID_B, [r["17b"] for r in four],
                      refs["stage2"], paths["17b"], card, failed))

    # 17c
    fit_r, val_r, pred_r = zip(*[r["17c"] for r in two])
    steps = CLI_TRAIN_FRAMES // TP_CLI_B
    n_eval = -(-CLI_EVAL_FRAMES // TP_CLI_B)
    per = launches_per_forward()
    for got, want in ((fit_r, cli_launches(steps + 1, steps, per)),
                      (val_r, cli_launches(n_eval, 0, per)),
                      (pred_r, cli_launches(n_eval, 0, per))):
        for r in got:
            add(r["launched"])
            if r["launched"] != want:
                failed.append(f"[17c] a rank launched {r['launched']}, expected {want}")
    ckpt = os.path.join(fit_r[0]["log_dir"], "checkpoints", "epoch=0.pt")
    if (any(r["steps"] != steps for r in fit_r) or len({r["hash"] for r in fit_r}) != 1
            or fit_r[1]["log_dir"] is not None or not os.path.exists(ckpt)):
        failed.append(f"[17c] fit: steps {[r['steps'] for r in fit_r]} (expected "
                      f"{steps}), log dirs {[r['log_dir'] for r in fit_r]}")
    one_val, launched, _ = cli_run(["validate"] + base + ["--ckpt_path", ckpt])
    add(launched)
    val_got = [r["result"] for r in val_r]
    val_err = max(abs(val_got[0][k] - v) / max(1.0, abs(v)) for k, v in one_val.items())
    if val_got[0] != val_got[1] or sorted(one_val) != sorted(val_got[0]) or not (
            val_err <= TP_EVAL_TOL):
        failed.append(f"[17c] validate on {TP_M} ranks vs one process: {val_err:.3e} "
                      f"(tol {TP_EVAL_TOL:g})")
    one_pred, launched, _ = cli_run(["predict"] + base + ["--ckpt_path", ckpt,
                                    "--trainer.save_dir", os.path.join(
                                        workdir, "cli_tp", "predict_one")])
    add(launched)
    import numpy as np

    got_p, want_p = np.load(pred_r[0]["result"], allow_pickle=True), np.load(
        one_pred, allow_pickle=True)
    pred_err = max(float(np.abs(got_p[k] - want_p[k]).max())
                   / max(1.0, float(np.abs(want_p[k]).max())) for k in ("final", "proposal"))
    if (pred_r[1]["result"] is not None or list(got_p["frame_path"])
            != list(want_p["frame_path"]) or not pred_err <= TP_EVAL_TOL):
        failed.append(f"[17c] predict on {TP_M} ranks vs one process: {pred_err:.3e} "
                      f"(tol {TP_EVAL_TOL:g})")
    one_task, _ = run.build_task(load_config(yaml_path, base[2:]),
                                 torch.device(TRAIN_DEVICE))
    state = torch.load(ckpt, map_location=TRAIN_DEVICE, weights_only=True)
    one_task.model.load_state_dict(state["model"], strict=True)  # keys and shapes
    same = state_hash(one_task.model) == fit_r[0]["hash"]
    if not same:
        failed.append("[17c] epoch=0.pt loaded into one process differs from the "
                      "ranks' gathered state")
    del one_task, state
    print(f"[17c] CLI stage 3 B={TP_CLI_B} on phase 12's tree, --trainer.devices {TP_M} "
          f"--trainer.model_parallel {TP_M}: "
          + (f"over NCCL refused ({refused}); " if refused else "")
          + f"fit ({steps} steps, grafted from phase 12's stage 2), validate and predict "
          f"in a {TP_M}-rank gloo group on one card, each rank lazy_deform_sample "
          f"{fit_r[0]['launched']['lazy_deform_sample']} + "
          f"{val_r[0]['launched']['lazy_deform_sample']} + "
          f"{pred_r[0]['launched']['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{fit_r[0]['launched']['lazy_deform_sample_bwd']}; validate {val_err:.3e} "
          f"and predict {pred_err:.3e} from one process's on the same checkpoint, over "
          f"max(1, |value|) (tol {TP_EVAL_TOL:g}); epoch=0.pt loads into one process "
          f"strictly, {'bitwise' if same else 'NOT bitwise'} the ranks' gathered state "
          f"| {card}", flush=True)

    # 17d
    d = [r["17d"] for r in two]
    for r in d:
        add(r["launched"])
        if r["launched"] != r["expected"] or not math.isfinite(r["loss"]):
            failed.append(f"[17d] head512 rank launched {r['launched']}, expected "
                          f"{r['expected']}; loss {r['loss']}")
    one = STEP_PEAKS.get(("head512", True))
    one_text = (f"{one / 2**30:.2f} GiB in one process (phase 15b's kernel step, "
                f"less its check's copies of the plain step)" if one
                else "not measured in this run")
    print(f"[17d] head512 {TRAIN_SIZE}px B={TRAIN_BATCH} fp32, one step at M = {TP_M}: "
          f"mlp_pred_0 slice {d[0]['slice']} (dim {d[0]['dim']}) a rank; build (the "
          f"full seeded model, then the slices) {max(r['build'] for r in d):.1f} s; "
          f"step peak {max(r['peak'] for r in d):.2f} GiB a rank vs {one_text}; "
          f"loss {d[0]['loss']:.4f}; launches {d[0]['launched']['lazy_deform_sample']} + "
          f"{d[0]['launched']['lazy_deform_sample_bwd']} | {card}", flush=True)
    print(f"[17] {time.perf_counter() - t0:.1f} s (2 ranks {t_two:.1f} s, 4 ranks "
          f"{t_four:.1f} s) | {card}", flush=True)
    if failed:
        raise AssertionError("[17] " + " | ".join(failed))
    return total



# Phase 18: the tools that drive the main path (egorear_tpu_torch/tools/).
TOOL_FWD_B, TOOL_TRAIN_B = 64, 32  # profile_fwd, profile_train: their defaults
TOOL_TIMED, TOOL_TRACED = 10, 3  # timed calls after one warm-up, traced calls
TOOL_SUM_TOL = 0.05  # the attributed device time against the profiler's total
OVERFIT_B, OVERFIT_STEPS = 8, 50
# run_curriculum: the fewest frames and epochs with which every stage fits
# and tests (a batch of 4: stage 1 takes 2 views of 8 frames, 4 steps).
CURRICULUM_ARGS = ["--frames", "8", "--eval-frames", "4", "--epochs", "1",
                   "--batch-size", "4", "--occlusion", "0.25"]
CURRICULUM_TIMEOUT = 600


def _named_kernel(kernels: dict, name: str) -> bool:
    """Whether a profiler table (kernel name -> us) holds a __global__
    function of csrc source ``name``."""
    from egorear_tpu_torch.tools.profile_fwd import kernel_pattern

    pattern = kernel_pattern(name)
    return any(pattern.search(k) and us > 0 for k, us in kernels.items())


def _attributed(tag: str, part: str, attributed: float, busy: float) -> str:
    """Fails unless ``attributed`` us lie within TOOL_SUM_TOL of the
    profiler's device total ``busy``."""
    if not (busy > 0 and abs(attributed - busy) <= TOOL_SUM_TOL * busy):
        raise AssertionError(f"{tag} {part} {attributed:.1f} us vs the profiler's "
                             f"device total {busy:.1f} us (tol {TOOL_SUM_TOL:g})")
    return f"{part} {attributed / 1e3:.3f} ms = {100 * attributed / busy:.2f} % of {busy / 1e3:.3f} ms"


def phase_tools(card, workdir: str, cli: dict) -> dict:
    """Phase 18: profile_fwd, profile_train and overfit_probe through their
    own functions, each with the launch counts from 0 over it, then
    run_curriculum in a subprocess; returns each in-process tool's counts."""
    from egorear_tpu_torch.tools import overfit_probe, profile_fwd, profile_train
    from egorear_tpu_torch.tools.run_curriculum import test_json

    lazy = kernel_names(True)
    out = {}
    # 18a: the forward, its kernel table and scope buckets.
    reset_launches()
    fwd = profile_fwd.profile_forward(TOOL_FWD_B, "bf16", TRAIN_DEVICE,
                                      timed=TOOL_TIMED, traced=TOOL_TRACED)
    _sync()
    launched = read_launches()
    want = expected_launches(True, fwd["forwards"], 0)
    if launched != want:
        raise AssertionError(f"[18a] {fwd['forwards']} forwards launched {launched}, "
                             f"expected {want}")
    if LAUNCHES_PER_LAYER and not _named_kernel(fwd["kernels"], lazy[0]):
        raise AssertionError(f"[18a] the kernel table names no {lazy[0]}")
    buckets = _attributed("[18a]", "scope buckets", sum(fwd["buckets"].values()),
                          fwd["busy"])
    print(f"[18a] profile_fwd b{TOOL_FWD_B} bf16 256px: {fwd['ms']:.3f} ms/forward, "
          f"{fwd['fps']:.1f} frames/s (host clock, {TOOL_TIMED} forwards); "
          f"{lazy[0]} {launched[lazy[0]]} launches = {fwd['forwards']} forwards x "
          f"{launches_per_forward()}; {buckets}; "
          + ", ".join(f"{k} {v / fwd['traced'] / 1e3:.3f}"
                      for k, v in fwd["buckets"].most_common())
          + f" ms/forward | {card}", flush=True)
    out["profile_fwd"] = launched
    # 18b: the train step, its forward / backward / optimizer split.
    reset_launches()
    train = profile_train.profile_train_step(TOOL_TRAIN_B, "bf16-mixed", TRAIN_DEVICE,
                                             timed=TOOL_TIMED, traced=TOOL_TRACED)
    _sync()
    launched = read_launches()
    want = expected_launches(True, train["steps"], train["steps"])
    if launched != want:
        raise AssertionError(f"[18b] {train['steps']} steps launched {launched}, "
                             f"expected {want}")
    if not all(math.isfinite(x) for x in train["losses"]):
        raise AssertionError(f"[18b] loss not finite: {train['losses']}")
    phases = train["phases"]
    split = _attributed("[18b]", "forward + backward + optimizer",
                        sum(phases[k] for k in ("forward", "backward", "optimizer")),
                        train["busy"])
    print(f"[18b] profile_train b{TOOL_TRAIN_B} bf16-mixed 256px: {train['ms']:.3f} "
          f"ms/step (host clock, {TOOL_TIMED} steps); launches {lazy[0]} "
          f"{launched[lazy[0]]}, {lazy[1]} {launched[lazy[1]]} = {train['steps']} x "
          f"{launches_per_forward()}; {split}; "
          + ", ".join(f"{k} {v / train['traced'] / 1e3:.3f}" for k, v in phases.most_common())
          + f" ms/step; loss {train['losses'][0]:.4f} -> {train['losses'][-1]:.4f} | {card}",
          flush=True)
    out["profile_train"] = launched
    # 18c: the overfit probe on phase 12's tree, then one kept step.
    reset_launches()
    probe = overfit_probe.overfit(cli["root"], 256, OVERFIT_B, OVERFIT_STEPS,
                                  device=TRAIN_DEVICE, every=max(1, OVERFIT_STEPS // 5))
    _sync()
    launched = read_launches()
    want = expected_launches(True, OVERFIT_STEPS, OVERFIT_STEPS)
    if launched != want:
        raise AssertionError(f"[18c] {OVERFIT_STEPS} steps launched {launched}, "
                             f"expected {want}")
    first, last = probe["records"][0], probe["records"][-1]
    if not (math.isfinite(last[2]) and last[2] < first[2]):
        raise AssertionError(f"[18c] final_mpjpe did not fall: {first} -> {last}")
    step, (img, gt_pose, gt_hm) = probe["step"], probe["batch"]
    gen = torch.Generator(device=TRAIN_DEVICE).manual_seed(18)
    perturb_train_(step.model, {"img": img}, gen)
    calls = []
    reset_launches()
    with kept_kernel_calls(calls):
        step(img, gt_pose, gt_hm)
    _sync()
    kept = read_launches()
    if kept != expected_launches(True, 1, 1):
        raise AssertionError(f"[18c] the kept step launched {kept}")
    hold_kept_calls(calls, "[18c]", card)
    del calls
    print(f"[18c] overfit_probe b{OVERFIT_B} fp32 256px on phase 12's tree: "
          f"floor {probe['floor_mm']:.1f} mm; final_mpjpe {first[2]:.1f} -> "
          f"{last[2]:.1f} mm, proposal_mpjpe {first[3]:.1f} -> {last[3]:.1f} mm, "
          f"hm_loss {first[1]:.4f} -> {last[1]:.4f} over {OVERFIT_STEPS} steps; "
          f"launches {lazy[0]} {launched[lazy[0]]}, {lazy[1]} {launched[lazy[1]]} "
          f"= {OVERFIT_STEPS} x {launches_per_forward()} | {card}", flush=True)
    out["overfit_probe"] = launched
    del probe, step
    # 18d: the curriculum, each stage a CLI subprocess on the card.
    _release_cache()
    cur = os.path.join(workdir, "curriculum")
    log = os.path.join(workdir, "curriculum.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "egorear_tpu_torch.tools.run_curriculum",
             "--out", cur, "--device", TRAIN_DEVICE] + CURRICULUM_ARGS,
            stdout=f, stderr=subprocess.STDOUT, timeout=CURRICULUM_TIMEOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[18d] run_curriculum exited {proc.returncode}:\n"
                             + open(log).read()[-4000:])
    tests = {s: test_json(os.path.join(cur, f"{s}.test.log"))
             for s in ("s2_mvfex", "s3_pose3d")}
    if not all(any(k.startswith("test/") for k in t) for t in tests.values()):
        raise AssertionError(f"[18d] a stage test JSON did not parse: {tests}")
    splits = {}
    for short in ("train", "val"):
        with open(os.path.join(cur, f"occlusion_split_s2_{short}.json")) as f:
            splits[short] = json.load(f)
        keys = [k for k in splits[short] if k.endswith("_mse_pts2d")]
        if len(keys) != 8:
            raise AssertionError(f"[18d] occlusion split {short}: keys {keys}")
    if not os.path.exists(os.path.join(cur, "ACCURACY.md")):
        raise AssertionError("[18d] no report")
    print(f"[18d] run_curriculum {' '.join(CURRICULUM_ARGS)} on {TRAIN_DEVICE}: "
          f"{seconds:.1f} s; stage 2 test/final_stereo_front_mse_pts2d "
          f"{tests['s2_mvfex'].get('test/final_stereo_front_mse_pts2d')}, stage 3 "
          f"test/final_mpjpe {tests['s3_pose3d'].get('test/final_mpjpe')} mm; "
          f"occlusion split val front occluded init/final "
          f"{splits['val'].get('front_occluded_init_mse_pts2d')}/"
          f"{splits['val'].get('front_occluded_final_mse_pts2d')} | {card}", flush=True)
    return out


# Phase 19: the native decoder (egorear_tpu_torch/native/) on the host:
# NATIVE_FRAMES frames (4 views each) of phase 12's JPEG tree and of phase
# 13's PNG tree held against PIL; the loader's passes over the stage-2
# train set, each decoder in turns.
NATIVE_FRAMES = 16
NATIVE_TURNS = ("native", "PIL", "PIL", "native")
# 19d's stage-2 fits: NATIVE_REPEAT names for each train sequence of phase
# 12's tree (8 steps at b64), NATIVE_FITS runs.
NATIVE_REPEAT, NATIVE_FITS = 4, 2


def repeated_tree(root: str, out: str, copies: int) -> str:
    """A syn tree at ``out`` whose train character holds ``copies``
    symlinks of each of ``root``'s train sequences (the same files under
    other names, each decoded anew); every other entry of ``root`` is
    symlinked as it is."""
    with open(os.path.join(root, "train.txt")) as f:
        char = f.readline().strip()  # the syn datasets read the first line
    os.makedirs(os.path.join(out, char))
    for entry in os.listdir(root):
        if entry != char:
            os.symlink(os.path.join(root, entry), os.path.join(out, entry))
    for seq in sorted(os.listdir(os.path.join(root, char))):
        for c in range(copies):
            os.symlink(os.path.join(root, char, seq),
                       os.path.join(out, char, f"{seq}_{c}"))
    return out


def phase_native(card, workdir: str, cli: dict, dp_rates: dict) -> dict:
    """Phase 19 (see the module's docstring). ``dp_rates``: phase 14's
    ``fit`` rates, which 19d's stage-2 fits are set beside. Returns 19d's
    launch counts."""
    import concurrent.futures as cf

    import numpy as np

    from egorear_tpu_torch import native
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.data.datasets import get_dataset, load_image, load_image_u8
    from egorear_tpu_torch.data.preprocess import IMAGENET_STD

    t0 = time.perf_counter()
    # 19a: the build in use (made from the checkout's sources at first
    # use, phase 12's decode pass), and what it links.
    info = native.library_info()
    built = ("was already built when this process started" if info["build_s"] is None
             else f"compiled with g++ at first use in {info['build_s']:.1f} s")
    print(f"[19a] image_loader.cc {built}; in use "
          f"{os.path.relpath(info['so'])}; linked libjpeg {info['linked']['jpeg']}, "
          f"libpng {info['linked']['png']}; NEEDED {', '.join(info['needed'])}; "
          f"mapped in this process {', '.join(info['mapped'])}; the libjpeg took the "
          f"jpeg62 struct (load_library checks) | {card}", flush=True)

    # 19b: the native loader's images against PIL's.
    img_tol = (1.0 / 255.0) / float(IMAGENET_STD.min()) + 1e-6
    failed = []
    for label, root, dataset_type in (
            ("syn JPEG", cli["root"], "ego4view_syn_heatmap_mvf"),
            ("rw PNG", cli["rw_root"], "ego4view_rw_heatmap_mvf")):
        ds = get_dataset(dataset_type, root, "train", use_native_loader=False)
        paths = [ds._img_path(f, c) for f in ds.frames[:NATIVE_FRAMES]
                 for c in ds.cameras]
        with cf.ThreadPoolExecutor(os.cpu_count()) as pool:
            pil_full = np.stack(list(pool.map(
                lambda p: load_image_u8(p, CLI_IMAGE_SIZE), paths)))
            pil_u8 = np.stack(list(pool.map(lambda p: load_image_u8(p, 256), paths)))
            pil_f32 = np.stack(list(pool.map(lambda p: load_image(p, 256), paths)))
        full = native.load_u8_batch(paths, CLI_IMAGE_SIZE)
        u8 = native.load_u8_batch(paths, 256)
        f32 = native.load_f32_batch(paths, 256)
        off = np.abs(u8.astype(np.int16) - pil_u8)
        f32_err = float(np.abs(f32 - pil_f32).max())
        full_off = int((full != pil_full).any(-1).sum())
        print(f"[19b] {label}: {len(paths)} images of {CLI_IMAGE_SIZE} px; uint8 at "
              f"{CLI_IMAGE_SIZE} px {full_off} pixels differ from PIL's (bitwise asked); "
              f"uint8 at 256 px max {int(off.max())} LSB (1 allowed), "
              f"{int((off > 0).any(-1).sum())} of {off.shape[0] * 256 * 256} pixels and "
              f"{int((off > 0).sum())} of {off.size} values differ; float32 at 256 px "
              f"max-abs {f32_err:.3e} (tol {img_tol:.4g}) | {card}", flush=True)
        if full.shape != pil_full.shape or full_off or off.max() > 1 or f32_err > img_tol:
            failed.append(label)
    if failed:
        raise AssertionError(f"[19b] the native loader disagrees with PIL on {failed}")

    # 19c: the loader with each decoder, in turns; each decoder alone.
    stage2_yaml = os.path.join(CONFIGS, "ego4view_syn_heatmap_mvfex-n1_jqa.yaml")
    B = load_config(stage2_yaml, CLI_OVERRIDES).init_args["batch_size"]
    root = cli["root"]
    for path_label, kw, key in (
            (f"device_preprocess path (uint8 at {CLI_IMAGE_SIZE} px)",
             dict(device_preprocess=True, image_size=CLI_IMAGE_SIZE), "img_u8"),
            ("host path (float32 at 256 px)", {}, "img")):
        rates = collections.defaultdict(list)
        for decoder in NATIVE_TURNS:
            ds = get_dataset("ego4view_syn_heatmap_mvf", root, "train",
                             use_native_loader=decoder == "native", **kw)
            rates[decoder].append(loader_pass(ds, B, key)["rate"])
        n_img = 4 * len(ds)
        print(f"[19c] {path_label} through the loader (16 workers, B={B}, {n_img} "
              f"images, {os.cpu_count()} CPUs), turns {' / '.join(NATIVE_TURNS)}: native "
              f"{ms_list(rates['native'])} images/s, PIL {ms_list(rates['PIL'])} "
              f"images/s | {card}", flush=True)
    ds = get_dataset("ego4view_syn_heatmap_mvf", root, "train", use_native_loader=False)
    paths = [ds._img_path(f, c) for f in ds.frames for c in ds.cameras]
    alone = {}
    for decoder in NATIVE_TURNS:
        t = time.perf_counter()
        if decoder == "native":
            native.load_u8_batch(paths, CLI_IMAGE_SIZE, n_threads=os.cpu_count())
        else:
            with cf.ThreadPoolExecutor(16) as pool:
                list(pool.map(lambda p: load_image_u8(p, CLI_IMAGE_SIZE), paths))
        alone.setdefault(decoder, []).append(len(paths) / (time.perf_counter() - t))
    print(f"[19c] each decoder alone on the same {len(paths)} JPEGs at {CLI_IMAGE_SIZE} "
          f"px (no loader, no copy to the card), turns {' / '.join(NATIVE_TURNS)}: "
          f"native in one call on {os.cpu_count()} pool threads "
          f"{ms_list(alone['native'])} images/s, PIL on 16 Python threads "
          f"{ms_list(alone['PIL'])} images/s | {card}", flush=True)

    # 19d: phase 14's stage-2 fit over NATIVE_REPEAT times its train set,
    # NATIVE_FITS runs; launches a step as phase 14's.
    name = "ego4view_syn_heatmap_mvfex-n1_jqa"
    tree = repeated_tree(root, os.path.join(workdir, "native_tree"), NATIVE_REPEAT)
    was = dp_rates[name]
    per = was["launched"]["lazy_deform_sample_bwd"] // was["steps"]
    launched = dict.fromkeys(KERNELS, 0)
    for run_i in range(NATIVE_FITS):
        got_rates = {}
        _, got_launched, _, _ = cli_fit(
            card, name, tree, os.path.join(workdir, "native", str(run_i)),
            NATIVE_REPEAT * CLI_TRAIN_FRAMES, per, cli["grafts"] + [
                "--model.dataset_kwargs.device_preprocess", "true",
                "--model.dataset_kwargs.image_size", str(CLI_IMAGE_SIZE)],
            None, "[19d]", got_rates)
        got = got_rates[name]
        print(f"[19d] run {run_i + 1} of {NATIVE_FITS}: {name} with device_preprocess at "
              f"{CLI_IMAGE_SIZE} px, {NATIVE_REPEAT} x phase 12's train frames: "
              f"{got['steps']} steps; without the wait for the first batch "
              f"{got['steady']:.1f} samples/s through the loader, one batch on the "
              f"card {got['fixed']:.1f}, loader-bound share "
              f"{got['steady_share']:.1f} % (epoch with its first "
              f"batch's wait {got['share']:.1f} %); phase 14's {was['steps']}-step epoch: "
              f"{was['steady_share']:.1f} % without that wait, {was['share']:.1f} % "
              f"with it; launches a step {per} + {per}, as phase 14's | {card}",
              flush=True)
        for k, v in got_launched.items():
            launched[k] += v
    print(f"[19] phase 19 {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    return launched


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
            dp_launched, dp_rates = timed("14", phase_device_preprocess, card,
                                          workdir, cli)
            branch_launched = timed("15", phase_branches, card, model_locs,
                                    workdir, cli)
            ddp_launched, dp_refs = timed("16a", phase_data_parallel, card, workdir)
            ddp_cli_launched = timed("16b", phase_cli_data_parallel, card, workdir,
                                     cli)
            remat_launched = timed("16c", phase_remat, card)
            tp_launched = timed("17", phase_tensor_parallel, card, workdir, cli,
                                dp_refs)
            tools_launched = timed("18", phase_tools, card, workdir, cli)
            native_launched = timed("19", phase_native, card, workdir, cli, dp_rates)
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
          f"{rigs_launched['lazy_deform_sample_bwd']}; device_preprocess CLI "
          f"lazy_deform_sample {dp_launched['device_preprocess']['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd "
          f"{dp_launched['device_preprocess']['lazy_deform_sample_bwd']}; "
          f"cache_in_memory CLI lazy_deform_sample "
          f"{dp_launched['cache_in_memory']['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {dp_launched['cache_in_memory']['lazy_deform_sample_bwd']}"
          f"; branches (serving and CLI) lazy_deform_sample "
          f"{branch_launched['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{branch_launched['lazy_deform_sample_bwd']}; data-parallel steps (both "
          f"ranks) lazy_deform_sample {ddp_launched['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {ddp_launched['lazy_deform_sample_bwd']}; "
          f"data-parallel CLI lazy_deform_sample "
          f"{ddp_cli_launched['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{ddp_cli_launched['lazy_deform_sample_bwd']}; remat lazy_deform_sample "
          f"{remat_launched['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{remat_launched['lazy_deform_sample_bwd']}; tensor-parallel (every rank) "
          f"lazy_deform_sample {tp_launched['lazy_deform_sample']}, "
          f"lazy_deform_sample_bwd {tp_launched['lazy_deform_sample_bwd']}; tools "
          + "; ".join(f"{tool} lazy_deform_sample {n['lazy_deform_sample']}, "
                      f"lazy_deform_sample_bwd {n['lazy_deform_sample_bwd']}"
                      for tool, n in tools_launched.items())
          + f"; native-decoder CLI lazy_deform_sample "
          f"{native_launched['lazy_deform_sample']}, lazy_deform_sample_bwd "
          f"{native_launched['lazy_deform_sample_bwd']} | {card}", flush=True)
    # Each main path's counts, zeroed before and read after its own run;
    # ``launches`` is their sum.
    by_path = {"serving_lazy": serve[True], "serving_reference": serve[False],
               "training_lazy": train[True], "training_reference": train[False],
               "stage2_training": stage2_launched, "cli_chain": cli["launches"],
               "cli_v2_and_real_world": rigs_launched,
               "cli_device_preprocess": dp_launched["device_preprocess"],
               "cli_cache_in_memory": dp_launched["cache_in_memory"],
               "branches": branch_launched, "data_parallel": ddp_launched,
               "cli_data_parallel": ddp_cli_launched, "remat": remat_launched,
               "tensor_parallel": tp_launched,
               **{f"tools_{tool}": n for tool, n in tools_launched.items()},
               "cli_native_decode": native_launched}
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
