"""Profile the flagship 4-view forward (the JAX package's
``tools/profile_fwd.py``): steady-state ms/forward and frames/s, then a
``torch.profiler`` trace of a few forwards, its device time by kernel
(top-k by share) and by the program's spans.

    python -m egorear_tpu_torch.tools.profile_fwd [batch] [dtype] [--submodules]
        [--image-size 256] [--device cpu]

Defaults: batch 64, bf16 (``fp32`` also), 256 px, on the card (without
CUDA it raises unless ``--device cpu``; on the CPU the times are the CPU's
and the tables its operators' self times). The model is the flagship as
``entry.build`` serves it: seeded random weights, BatchNorm folded, eval
mode. ``--submodules`` times stage 1 (the backbones and the initial heads),
stage 1 + MVFex, and the whole cascade instead, as three separate calls.

The buckets are the program's own spans (``egorear_tpu_torch.utils.trace``,
on while the profiler records, each an ``egorear::<name>`` range in the
trace): ``stage1.encoder``, ``stage1.head`` (the initial conv-stack heads),
``stage2.refiner``, ``sample`` (the deformable sampling calls of the refiners
and the lifting layers), ``stage3.proposal``, ``stage3.project``,
``stage3.layer``, in training also ``norm``, and ``other/unattributed`` (the
argmax anchors and the glue between modules). A device kernel goes to the
innermost span open on the host when it was launched; in a backward
(``profile_train``) to the span of the forward operator whose autograd node
launched it.

This module also holds the trace aggregation that ``chip_smoke.py --profile``
prints (:func:`kernel_time`, :func:`profiled`, :func:`device_table`).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from egorear_tpu_torch.tools.common import card_line, synchronize, tool_device
from egorear_tpu_torch.utils import trace as trace_spans

# The __global__ functions of each csrc source, as the profiler names them:
# a symbol that starts at a word boundary and matches the pattern (the
# backward sources may launch several kernels, all named <source>_*kernel).
KERNEL_SYMBOLS = {
    "lazy_deform_sample": r"lazy_deform_sample_kernel\b",
    "lazy_deform_sample_bwd": r"lazy_deform_sample_bwd_\w*kernel\b",
    "deform_sample": r"deform_sample_kernel\b",
    "deform_sample_bwd": r"deform_sample_bwd_\w*kernel\b",
}


def kernel_pattern(name: str) -> re.Pattern:
    """What matches the __global__ functions of csrc source ``name`` in a
    kernel's name: ``deform_sample`` does not match the lazy kernels, nor a
    forward source its backward's."""
    return re.compile(r"(?<![A-Za-z0-9_])" + KERNEL_SYMBOLS[name])


def kernel_time(events, name: str) -> float:
    """Device time (us) of csrc source ``name``'s kernels in the profiler's
    events (:func:`kernel_pattern`)."""
    pattern = kernel_pattern(name)
    return sum(e.self_device_time_total for e in events if pattern.search(e.key))


def profiled(fn, n: int):
    """torch.profiler over ``n`` calls of ``fn``: the profiler's events and
    the device's busy time per call in ms (0 when it saw no device time)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return events, sum(e.self_device_time_total for e in events) / n / 1e3


def device_table(events, busy, title, path, mode):
    """Append (or, with ``mode`` "w", write) the profiler's table by device
    time to ``path``, when the profiler saw device time."""
    if busy > 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, mode) as f:
            f.write(f"{title}\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=40))
            f.write("\n")


# -- the program's spans ------------------------------------------------------------

# The program's spans (``egorear_tpu_torch.utils.trace``) under a forward,
# and what no such span covers; a kernel goes to the innermost one open
# when it was launched. A training forward adds ``norm``.
UNATTRIBUTED = "other/unattributed"
BUCKETS = ("stage1.encoder", "stage1.head", "stage2.refiner", "sample",
           "stage3.proposal", "stage3.project", "stage3.layer", UNATTRIBUTED)
# The step's spans, each the phase of the operators that start inside it.
PHASES = {"train.step": "forward", "train.backward": "backward",
          "train.reduce": "optimizer", "train.clip": "optimizer",
          "train.optimizer": "optimizer"}
_BACKWARD_NODE = "autograd::engine::evaluate_function"


def trace(fn, n: int, device: torch.device):
    """``torch.profiler`` over ``n`` calls of ``fn`` (host operators, and
    the card's kernels on CUDA)."""
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    synchronize(device)
    with profile(activities=activities) as prof:
        for _ in range(n):
            fn()
        synchronize(device)
    return prof


def _annotation(e) -> bool:
    return e.name.startswith(trace_spans.PREFIX)


def op_work(prof, device: torch.device):
    """[(host operator event, {kernel name: us})]: on CUDA the device time of
    the kernels each operator launched (a span's range itself holds the
    launches made directly under it, as the ctypes-bound sampling kernels'),
    on the CPU each operator's self time."""
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if device.type == "cuda":
            work = collections.Counter()
            for k in e.kernels:
                if not k.name.startswith(trace_spans.PREFIX):  # not a span's device range
                    work[k.name] += k.duration
        elif _annotation(e):
            continue
        else:
            work = collections.Counter({e.name: e.self_cpu_time_total})
        if sum(work.values()) > 0:
            out.append((e, work))
    return out


def _ancestor(e, test):
    while e is not None and not test(e):
        e = e.cpu_parent
    return e


def _span(e):
    """The name of the program's span that ``e`` is the range of, or None."""
    prefix = trace_spans.PREFIX
    return e.name[len(prefix):] if e.name.startswith(prefix) else None


def _scope_of(e):
    """The innermost of the program's spans under a forward that holds
    ``e`` (None where there is none)."""
    hit = _ancestor(e, lambda p: _span(p) not in (None, "forward", *PHASES))
    return _span(hit) if hit is not None else None


def aggregate(prof, device: torch.device) -> dict:
    """The trace by kernel, by span bucket, by phase and by (phase,
    bucket), in us over the whole trace: ``{"total", "busy", "kernels",
    "buckets", "phases", "phase_buckets"}`` (``busy``: :func:`busy_us`). A
    backward operator takes the bucket of the forward operator that made its
    autograd node (the last to start with its sequence number); an operator takes the phase
    of the innermost step span (:data:`PHASES`) whose host interval holds
    its start (the backward may run on another thread); ``unattributed``
    where none does."""
    work = op_work(prof, device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    forward_scope = {}  # the last to start wins: ops before it peek its number
    for e in sorted(events, key=lambda e: e.time_range.start):
        if (e.sequence_nr >= 0 and not _annotation(e)
                and _ancestor(e, lambda p: p.name.startswith(_BACKWARD_NODE)) is None):
            forward_scope[e.sequence_nr] = _scope_of(e)
    steps = sorted((e.time_range.start, e.time_range.end, PHASES[_span(e)])
                   for e in events if _span(e) in PHASES)
    kernels, phase_buckets = collections.Counter(), collections.Counter()
    for e, k in work:
        kernels.update(k)
        scope = _scope_of(e)
        node = _ancestor(e, lambda p: p.name.startswith(_BACKWARD_NODE))
        if scope is None and node is not None:
            scope = forward_scope.get(node.sequence_nr)
        start = e.time_range.start
        phase = next((name for lo, hi, name in reversed(steps) if lo <= start < hi),
                     "unattributed")
        phase_buckets[(phase, scope or UNATTRIBUTED)] += sum(k.values())
    buckets, by_phase = collections.Counter(), collections.Counter()
    for (phase, bucket), us in phase_buckets.items():
        buckets[bucket] += us
        by_phase[phase] += us
    return dict(total=sum(kernels.values()), busy=busy_us(prof, device),
                kernels=kernels, buckets=buckets, phases=by_phase,
                phase_buckets=phase_buckets)


def busy_us(prof, device: torch.device) -> float:
    """The trace's device time summed over the device's own events (CPU:
    the operators' self time), what :func:`aggregate`'s attribution must
    account for. A ``record_function`` range (a span's, or the
    optimizer's ``Optimizer.step#...``) also leaves a span of its name on
    the device's timeline: those are left out."""
    events = prof.events()
    if device.type == "cuda":
        host = {e.name for e in events if e.device_type == DeviceType.CPU}
        return sum(e.time_range.end - e.time_range.start for e in events
                   if e.device_type == DeviceType.CUDA and e.name not in host)
    return sum(e.self_cpu_time_total for e in events
               if e.device_type == DeviceType.CPU and not _annotation(e))


def print_tables(agg: dict, n: int, unit: str, card: str, top: int = 40,
                 min_pct: float = 0.25) -> None:
    """The kernel table (top-k by share, down to ``min_pct`` %) and the span
    buckets, per ``unit`` (``n`` of them in the trace)."""
    total = agg["total"]
    what, rows = (("CPU operator self time", "operator") if card == "cpu"
                  else ("device total", "kernel"))
    print(f"\n{what}: {total / n / 1e3:.3f} ms/{unit} over {n} {unit}s | {card}")
    print(f"{'us/' + unit:>12}  {'%':>5}  {rows}")
    for name, us in agg["kernels"].most_common(top):
        pct = 100.0 * us / total
        if pct < min_pct:
            break
        print(f"{us / n:>12.1f}  {pct:>5.1f}  {name[:110]}")
    print(f"\nspan buckets (us/{unit}):")
    for name, us in agg["buckets"].most_common():
        print(f"{us / n:>12.1f}  {100.0 * us / total:>5.1f}  {name}")


# -- the forward ------------------------------------------------------------------


def flagship(batch: int, dtype: str, image_size: int, device: torch.device):
    """The BN-folded flagship in ``dtype`` and a seeded (B, 4, 3, S, S)
    image on ``device``."""
    from egorear_tpu_torch import entry

    torch_dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    model, rig = entry.build((image_size, image_size), device=device,
                             dtype=torch_dtype, bn_folded=True, seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    img = torch.randn(batch, 4, 3, image_size, image_size, generator=gen,
                      device=device).to(torch_dtype)
    return model, rig, img


def steady_ms(fn, device: torch.device, n: int, warmup: int = 1) -> float:
    """Host-clock ms of one ``fn()`` over ``n`` calls after ``warmup``, each
    side synchronised."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / n * 1e3


def profile_forward(batch: int = 64, dtype: str = "bf16", device=None,
                    image_size: int = 256, timed: int = 10, traced: int = 3,
                    quiet: bool = False) -> dict:
    """Time ``timed`` forwards after one warm-up, then trace ``traced`` more
    (the program's spans on); prints the lines and returns ``{ms, fps,
    forwards, traced, card, total, kernels, buckets, phases}`` (us over the
    trace)."""
    device = tool_device(device, "profile_fwd")
    model, rig, img = flagship(batch, dtype, image_size, device)
    card = card_line(device)

    def forward():
        return model(img, rig)

    with torch.inference_mode():
        ms = steady_ms(forward, device, timed)
        if not quiet:
            print(f"steady state: {ms:.3f} ms/forward  {batch * 1e3 / ms:.1f} "
                  f"frames/s (batch {batch}, {dtype}, {image_size} px) | {card}",
                  flush=True)
        prof = trace(forward, traced, device)
    agg = aggregate(prof, device)
    if not quiet:
        print_tables(agg, traced, "forward", card)
    return dict(ms=ms, fps=batch * 1e3 / ms, forwards=1 + timed + traced,
                traced=traced, card=card, **agg)


def time_submodules(batch: int = 64, dtype: str = "bf16", device=None,
                    image_size: int = 256, n: int = 10) -> dict:
    """Host-clock ms of stage 1 (the backbones and the initial heads),
    stage 1 + MVFex and the whole cascade, each called alone."""
    device = tool_device(device, "profile_fwd")
    model, rig, img = flagship(batch, dtype, image_size, device)
    hm = model.heatmap_estimator
    parts = {"full cascade": lambda: model(img, rig),
             "s1+mvfex": lambda: hm(img),
             "stage-1 only": lambda: hm._initial(img)}
    with torch.inference_mode():
        ms = {k: steady_ms(fn, device, n) for k, fn in parts.items()}
    card = card_line(device)
    print(f"batch {batch} ({dtype}, {image_size} px) | {card}:")
    for k, v in ms.items():
        print(f"  {k:13s}: {v:8.3f} ms  ({batch * 1e3 / v:8.1f} frames/s)")
    print(f"  {'mvfex part':13s}: {ms['s1+mvfex'] - ms['stage-1 only']:8.3f} ms")
    print(f"  {'pose3d part':13s}: {ms['full cascade'] - ms['s1+mvfex']:8.3f} ms")
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=64)
    ap.add_argument("dtype", nargs="?", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--submodules", action="store_true")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    if args.submodules:
        return time_submodules(args.batch, args.dtype, args.device, args.image_size)
    return profile_forward(args.batch, args.dtype, args.device, args.image_size)


if __name__ == "__main__":
    main()
