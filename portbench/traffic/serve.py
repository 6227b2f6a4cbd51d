"""Traffic kind ``serve``: a closed loop of eval forwards of the stage-3
cascade, ``in_flight`` batches of ``batch`` 4-view frames at once (batch
k + 1 is dispatched before the wait for batch k), each drawn in turn from a
pool of ``pool`` distinct batches made on the device from the seed. A batch
is done when its 3D poses (proposal and final) are in pinned host memory.

Parameters (``traffic/<mix>.json``): ``batch``, ``in_flight``, ``pool``,
``warmup`` (batches before the window), ``traced`` (batches in a traced
window), ``rate_seconds`` (the untraced stretch before it, whose rate
``mfu`` reads), ``sample`` (batches whose every output is compared, drawn
from the seed over the window), ``margin`` (the least relative distance from a
decision, :func:`portbench.reference.build.margins`, at which a sample is
compared; ``margin_fov`` the same for an anchor from an image border).
"""

from __future__ import annotations

import collections
import contextlib
import random
import time

import numpy as np
import torch

from portbench import program, window
from portbench.reference import build as ref_build
from portbench.reference import compare


def serve_loop(task, pool, in_flight, stop, keep, host_bufs, marks=None):
    """Dispatch batches until ``stop(n_dispatched, t)``; returns the
    latencies (s) of all of them, in order. ``keep(k, outputs)`` sees each
    batch's outputs when it is dispatched."""
    pending = collections.deque()
    lat = []
    k = 0
    while True:
        now = time.perf_counter()
        if stop(k, now):
            break
        b = pool[k % len(pool)]
        _, (preds, hms) = task._eval_forward({"img": b["img"]})
        buf = host_bufs[k % len(host_bufs)]
        buf.copy_(torch.stack([preds[0], preds[-1]]), non_blocking=True)
        done = torch.cuda.Event() if buf.is_pinned() else None
        if done is not None:
            done.record()
        keep(k, (preds, hms))
        pending.append((now, done))
        k += 1
        if len(pending) == in_flight:
            _wait(pending.popleft(), lat, marks)
    while pending:
        _wait(pending.popleft(), lat, marks)
    return lat


def _wait(item, lat, marks):
    t0, done = item
    with (marks("wait::batch") if marks else contextlib.nullcontext()):
        if done is not None:
            done.synchronize()
    lat.append(time.perf_counter() - t0)


def run(r):
    p, dev = r.params, r.device
    B = p["batch"]
    conf = r.cell.config
    task_name, model_cfg = conf["task"], conf["model"]["init_args"]["model_cfg"]
    task, _, pool = program.set_up(r, trainer=False)
    pinned = dev.type == "cuda"
    host = [torch.empty((2, B, 16, 3), pin_memory=pinned) for _ in range(p["in_flight"] + 1)]

    # Warm-up holds as many outputs as the window's sample does, so that the
    # window finds the allocator's blocks in place.
    held = collections.deque(maxlen=p["sample"])
    serve_loop(task, pool, p["in_flight"], lambda k, t: k >= p["warmup"],
               lambda k, o: held.append(o), host)
    window.synchronize(dev)
    r.lap(f"{p['warmup']} batches warmed up")
    del held
    setup_s = time.perf_counter() - r.t_start
    setup_peak = window.peak_bytes(dev)
    window.reset_peak(dev)

    rng = random.Random(r.seed)
    kept = {}  # reservoir of (batch index, outputs), drawn from the seed
    seen = [0]

    def keep(k, outputs):
        seen[0] += 1
        if len(kept) < p["sample"]:
            kept[k] = outputs
        else:
            j = rng.randrange(seen[0])
            if j < p["sample"]:
                kept.pop(sorted(kept)[j])
                kept[k] = outputs

    summary = None
    if r.trace:
        # The untraced rate that ``mfu`` reads: the profiler slows the host.
        t0 = time.perf_counter()
        n_rate = len(serve_loop(task, pool, p["in_flight"],
                                lambda k, t: t - t0 >= min(r.seconds, p["rate_seconds"]),
                                lambda k, o: None, host))
        rate = n_rate / (time.perf_counter() - t0)
        calls = []
        with program.sampling_calls(calls), window.Traced(dev, task.model) as tr:
            lat = serve_loop(task, pool, p["in_flight"], lambda k, t: k >= p["traced"],
                             keep, host, marks=tr.mark)
        summary = tr.summary(items=len(lat), rate=rate)
        summary["flops_per_item"] = window.flops_per_sample(task_name, model_cfg, train=False) * B
        summary["peak_flops"] = window.peak_flops(r.cell)
        summary["sampling_bound_ms"] = window.sampling_bound_ms(calls, backward=False)
        window_s = summary["window_s"]
    else:
        t0 = time.perf_counter()
        lat = serve_loop(task, pool, p["in_flight"], lambda k, t: t - t0 >= r.seconds,
                         keep, host)
        window_s = time.perf_counter() - t0
    peak = max(setup_peak, window.peak_bytes(dev))
    n = len(lat)
    r.note(f"serve: {n} batches of {B} in {window_s:.4f} s; p50 "
           f"{np.percentile(lat, 50) * 1e3:.3f} ms, p95 over {n} batches "
           f"({n - int(np.ceil(0.95 * n))} beyond it)")
    e2e = {"serve_frames_per_s": n * B / window_s,
           "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3,
           "setup_s": setup_s}

    # The comparison, after the window, on the program's outputs only.
    outputs = {k: ([t.detach() for t in o[0]], [t.detach() for t in o[1]])
               for k, o in kept.items()}
    del task, kept
    window.release(dev)
    numbers = check(r, task_name, model_cfg, pool, outputs, dev)
    checks = compare.judged(numbers, r.cell.limits)
    return dict(e2e=e2e, summary=summary, checks=checks, attempted=n * B,
                failed=0, peak=peak, numbers=numbers)


def reference_outputs(task_name, model_cfg, seed, dev, imgs, tf32=False):
    """The reference's outputs and margins on each of ``imgs``."""
    ref = window.reference(task_name, model_cfg, seed, dev)
    ref.eval()
    th = model_cfg["heatmap_mvf_cfg"].get("heatmap_threshold", 0.5)
    out = []
    with torch.no_grad(), window.tf32(tf32):
        for img in imgs:
            preds, hms = ref_build.forward(task_name, ref, img)
            out.append((preds, hms, ref_build.margins(task_name, ref, hms, th)))
    return out


def check(r, task_name, model_cfg, pool, outputs, dev, tf32=False):
    """The serve numbers: over the sampled batches' samples whose decisions
    rounding cannot flip, the widest relative gap of the 3D poses (every
    stage) and of the heatmaps (every stage, every view); and the share of
    samples left out as ill-conditioned."""
    p = r.params
    order = sorted(outputs)
    refs = reference_outputs(task_name, model_cfg, r.seed, dev,
                             [pool[k % len(pool)]["img"] for k in order], tf32)
    pose, hm, left_out, total = [], [], 0, 0
    for k, (rp, rh, (m_hm, m_fov)) in zip(order, refs):
        gp, gh = outputs[k]
        ok = (m_hm >= p["margin"]) & (m_fov >= p["margin_fov"])
        total += ok.numel()
        left_out += int((~ok).sum())
        if ok.any():
            pose.append(float(compare.sample_gaps(gp, rp)[ok].max()))
            hm.append(float(compare.sample_gaps(gh, rh)[ok].max()))
    r.note(f"serve check: {len(order)} batches, {total} samples, {left_out} "
           f"left out as ill-conditioned")
    nan = float("nan")  # nothing compared fails
    return {"pose_gap": max(pose, default=nan), "heatmap_gap": max(hm, default=nan),
            "ill_conditioned_share": left_out / max(total, 1)}
