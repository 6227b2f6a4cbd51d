#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root with one CUDA card: ``python3 chip_smoke.py``
(``--profile FILE`` adds a device-time breakdown of the serving forward and
writes its table to FILE). It imports nothing of JAX and
nothing of the JAX package. Phases, one line each or more, every number
beside the card's name and power limit:

  1. build the hand-written kernels from ``egorear_tpu_torch/csrc/`` (nvcc,
     sm_90a) and report the build time;
  2. hold each kernel against its plain PyTorch version on the card at the
     flagship shapes, fp32 and bf16, and time kernel, plain version and the
     library yardstick;
  3. run the flagship forward (256 px, batch 2, fp32, TF32 off) once through
     the kernels and once through the plain versions, same weights and input;
  4. serve the flagship (256 px, BN folded, bf16, batch 16) through
     ``entry.build`` and check that the main path launched every kernel.

It exits non-zero, without the last line, when there is no card or any phase
fails. Its last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
LAUNCHES_PER_FORWARD = 4 + 3
SERVE_BATCH, SERVE_WARMUP, SERVE_TIMED = 16, 3, 10
E2E_BATCH, E2E_HM_TOL, E2E_P3D_TOL = 2, 1e-4, 1e-2


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


def sample_inputs(shape, dtype, gen):
    """Seeded inputs for one lazy_deform_sample call: locations in
    [-0.3, 1.3] so corners fall outside on every side, softmaxed weights."""
    B, Q, nh, P, H, Cin, G, C = (shape[k] for k in
                                 ("B", "Q", "nh", "P", "H", "Cin", "G", "C"))
    dev = "cuda"
    feat = torch.randn(B, H * H, Cin, generator=gen, device=dev).to(dtype)
    loc = torch.rand(B, Q, nh, P, 2, generator=gen, device=dev) * 1.6 - 0.3
    attn_w = torch.randn(B, Q, nh, P, generator=gen, device=dev).softmax(-1)
    pos = (torch.randn(G, H * H, C, generator=gen, device=dev).to(dtype)
           if C else None)
    return feat, loc, attn_w, pos


def lazy_sample_bound_ms(feat, loc, attn_w, pos, pos_block):
    """Least time for one lazy_deform_sample call on these inputs.

    Bytes: each distinct feature row and pos row that an in-range corner
    touches, read once; loc and attn_w (fp32, as the kernel reads them) read
    once; s_feat, s_pos and s_one written once. Operations: one multiply-add
    (2 flops) per channel per in-range corner, fp32 outside the tensor cores.
    The larger of the two times at the published H100 peaks.
    """
    B, HW, Cin = feat.shape
    H = W = int(HW ** 0.5)
    es = feat.element_size()
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
    rows_out = attn_w.numel() // attn_w.shape[-1]
    nbytes = (n_feat * Cin * es + n_pos * C * es + loc.numel() * 4
              + attn_w.numel() * 4 + rows_out * (Cin + C + 1) * es)
    flops = 2 * n_corners * (Cin + C + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    errs = [float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want) if w is not None]
    scale = max(float(w.float().abs().max()) for w in want if w is not None)
    return max(errs), scale


def phase_kernels(card):
    """Kernel vs plain version on the card at both flagship shapes."""
    from egorear_tpu_torch.ops.deform_attn import (
        lazy_deform_sample, lazy_deform_sample_plain)
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    record = None
    for name, shape in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            feat, loc, attn_w, pos = sample_inputs(shape, dtype, gen)
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
                    f"lazy_deform_sample {name} {dtype}: max-abs {err:.3e} "
                    f"> {tol:.3e}")
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
            print(f"[2] lazy_deform_sample {name} {str(dtype)[6:]} "
                  f"B={shape['B']} Q={shape['Q']} nh={shape['nh']} "
                  f"P={shape['P']} {side}x{side} Cin={Cin} C={shape['C']}: "
                  f"max_abs_err={err:.3e} (tol {tol:.1e}) ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) | {card}", flush=True)
            if name == "mvfex" and dtype == torch.bfloat16:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library_ms)
    return record


def deform_attns(model):
    from egorear_tpu_torch.models.layers import MSDeformAttnLazy

    return [m for m in model.modules() if isinstance(m, MSDeformAttnLazy)]


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


def phase_end_to_end(card):
    """The flagship forward through the kernel vs through the plain version."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.ops.deform_attn import lazy_deform_sample
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    model, rig = entry.build((256, 256), dtype=torch.float32, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    img = torch.randn(E2E_BATCH, 4, 3, 256, 256, generator=gen, device="cuda")
    perturb_(model, img, gen)
    attns = deform_attns(model)
    with torch.inference_mode():
        before = lazy_deform_sample.launches
        got_p3d, got_hm = model(img, rig)
        torch.cuda.synchronize()
        launched = lazy_deform_sample.launches - before
        for m in attns:
            m.impl = "plain"
        want_p3d, want_hm = model(img, rig)
        for m in attns:
            m.impl = "kernel"
    if launched != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"kernel run launched {launched} kernels, "
                             f"expected {LAUNCHES_PER_FORWARD}")
    valid_2d = float(argmax_2d(want_hm[0], 0.5, normalize=True)[2].float().mean())
    valid_3d = float(rig.project(want_p3d[0])[1].float().mean())
    if not (valid_2d > 0 and valid_3d > 0):
        raise AssertionError(f"no valid anchors (2D {valid_2d}, 3D {valid_3d}): "
                             f"the check would not see the kernel")
    hm_errs = [float((g - w).abs().max()) for g, w in zip(got_hm, want_hm)]
    p3d_errs = [float((g - w).abs().max()) for g, w in zip(got_p3d, want_p3d)]
    print(f"[3] flagship 256px B={E2E_BATCH} fp32 kernel vs plain: heatmap "
          f"stages max-abs {hm_errs} (tol {E2E_HM_TOL:g}), preds_3d stages "
          f"max-abs cm {p3d_errs} (tol {E2E_P3D_TOL:g}); valid anchors 2D "
          f"{valid_2d:.3f} 3D {valid_3d:.3f} | {card}", flush=True)
    if len(got_hm) != 2 or len(got_p3d) != 4:
        raise AssertionError("unexpected number of output stages")
    if not (max(hm_errs) <= E2E_HM_TOL and max(p3d_errs) <= E2E_P3D_TOL):
        raise AssertionError("end-to-end kernel run disagrees with the plain run")


def phase_serve(card, profile: str | None):
    """Serve the flagship as users would; returns the kernel launch counts
    of the main path."""
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.ops.deform_attn import lazy_deform_sample

    model, rig = entry.build((256, 256), dtype=torch.bfloat16, bn_folded=True,
                             seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.randn(SERVE_BATCH, 4, 3, 256, 256, generator=gen,
                      device="cuda").to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        lazy_deform_sample.launches = 0
        for _ in range(SERVE_WARMUP):
            model(img, rig)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_TIMED):
            preds_3d, heatmaps = model(img, rig)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SERVE_TIMED
        launches = lazy_deform_sample.launches
    forwards = SERVE_WARMUP + SERVE_TIMED
    want = forwards * LAUNCHES_PER_FORWARD
    if launches != want:
        raise AssertionError(f"{forwards} forwards launched the kernel "
                             f"{launches} times, expected {want}")
    B, J = SERVE_BATCH, 16
    if [tuple(p.shape) for p in preds_3d] != [(B, J, 3)] * 4:
        raise AssertionError(f"preds_3d shapes {[p.shape for p in preds_3d]}")
    if [tuple(h.shape) for h in heatmaps] != [(B, 4, 15, 64, 64)] * 2:
        raise AssertionError(f"heatmap shapes {[h.shape for h in heatmaps]}")
    if not all(bool(torch.isfinite(x).all()) for x in (*preds_3d, *heatmaps)):
        raise AssertionError("non-finite serving output")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[4] serve flagship 256px bf16 BN-folded B={B}: "
          f"{dt * 1e3:.3f} ms/forward (host clock, {SERVE_TIMED} forwards "
          f"after {SERVE_WARMUP} warm-up), {B / dt:.1f} samples/s "
          f"({4 * B / dt:.1f} images/s), peak {peak_gib:.2f} GiB; kernel "
          f"launches {launches} = {forwards} x {LAUNCHES_PER_FORWARD} "
          f"(4 refiners looped + 3 lifting layers) | {card}", flush=True)
    if profile:
        profile_serving(model, rig, img, card, profile)
    return {"lazy_deform_sample": launches}


def profile_serving(model, rig, img, card, path: str, n: int = 3):
    """Device time by kernel over ``n`` serving forwards (torch.profiler);
    the table goes to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            model(img, rig)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        print(f"[4] profile: the profiler saw no device time | {card}")
        return
    lazy = sum(e.self_device_time_total for e in events
               if "lazy_deform_sample" in e.key)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{card}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    print(f"[4] profile over {n} forwards: device busy {total / n / 1e3:.3f} "
          f"ms/forward, lazy_deform_sample {lazy / n / 1e3:.4f} ms/forward "
          f"({100 * lazy / total:.2f}% of device time) | {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="write a device-time breakdown of the serving "
                         "forward to FILE")
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
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[1] built {name} in {build_s:.1f} s: {' | '.join(ptxas)}",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = phase_kernels(card)
    phase_end_to_end(card)
    launches = phase_serve(card, args.profile)

    print(f"card: {card}")
    print(json.dumps({"kernels": [dict(
        name="lazy_deform_sample", route="cuda",
        source="egorear_tpu_torch/csrc/lazy_deform_sample.cu",
        replaces="egorear_tpu/ops/deform_attn.py:497",
        launches=launches["lazy_deform_sample"], **record)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
