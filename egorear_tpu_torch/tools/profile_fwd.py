"""Profile the flagship 4-view forward (the JAX package's
``tools/profile_fwd.py``): steady-state ms/forward and frames/s, then a
``torch.profiler`` trace of a few forwards, its device time by kernel
(top-k by share) and by model scope.

    python -m egorear_tpu_torch.tools.profile_fwd [batch] [dtype] [--submodules]
        [--image-size 256] [--device cpu]

Defaults: batch 64, bf16 (``fp32`` also), 256 px, on the card (without
CUDA it raises unless ``--device cpu``; on the CPU the times are the CPU's
and the tables its operators' self times). The model is the flagship as
``entry.build`` serves it: seeded random weights, BatchNorm folded, eval
mode. ``--submodules`` times stage 1 (the backbones and the initial heads),
stage 1 + MVFex, and the whole cascade instead, as three separate calls.

The scope buckets are the JAX tool's: ``backbone.resnet``,
``backbone.fpn``, ``refiner.deform_attn`` (the refiners' deformable
cross-attention), ``refiner.ff+heads`` (the rest of the refiners),
``pose3d.deform_attn``, ``pose3d.other``, ``stage2.conv_heads`` (the
initial conv-stack heads) and ``other/unattributed`` (the argmax anchors
and the glue between modules). The tool opens a ``record_function`` range
(``scope::<bucket>``) from forward hooks on each bucket's modules while it
traces; the model code holds no span. A device kernel goes to the innermost
range open on the host when it was launched; in a backward (``profile_train``)
to the range of the forward operator whose autograd node launched it.

This module also holds the trace aggregation that ``chip_smoke.py --profile``
prints (:func:`kernel_time`, :func:`profiled`, :func:`device_table`).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from egorear_tpu_torch.tools.common import card_line, synchronize, tool_device

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


# -- model scopes ---------------------------------------------------------------

# (module path pattern, bucket); the innermost open range wins.
SCOPES = (
    (r"\.encoder\.resnet$", "backbone.resnet"),
    (r"\.encoder\.fpn$", "backbone.fpn"),
    (r"^heatmap_estimator\.refiners\.\d+$", "refiner.ff+heads"),
    (r"^heatmap_estimator\.refiners\.\d+\..*\.cross_attn$", "refiner.deform_attn"),
    (r"^heatmap_estimator\.conv_heatmap_head_\w+$", "stage2.conv_heads"),
    (r"^pose3d_estimator$", "pose3d.other"),
    (r"^pose3d_estimator\..*\.cross_attn$", "pose3d.deform_attn"),
)
UNATTRIBUTED = "other/unattributed"
BUCKETS = tuple(dict.fromkeys(b for _, b in SCOPES)) + (UNATTRIBUTED,)
SCOPE, PHASE = "scope::", "phase::"
_BACKWARD_NODE = "autograd::engine::evaluate_function"


@contextlib.contextmanager
def scope_ranges(model: torch.nn.Module):
    """Inside the block every module of a bucket (:data:`SCOPES`, on
    ``model``'s module paths) runs its forward in a ``scope::<bucket>``
    ``record_function`` range, opened and closed by forward hooks."""
    handles = []
    for name, module in model.named_modules():
        bucket = next((b for pattern, b in SCOPES if re.search(pattern, name)), None)
        if bucket is None:
            continue
        opened = []

        def enter(mod, args, bucket=bucket, opened=opened):
            rf = record_function(SCOPE + bucket)
            rf.__enter__()
            opened.append(rf)

        def leave(mod, args, out, opened=opened):
            opened.pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave, always_call=True))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


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
    return e.name.startswith((SCOPE, PHASE))


def op_work(prof, device: torch.device):
    """[(host operator event, {kernel name: us})]: on CUDA the device time of
    the kernels each operator launched (a ``scope::`` range itself holds the
    launches made directly under it, as the ctypes-bound sampling kernels'),
    on the CPU each operator's self time."""
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if device.type == "cuda":
            work = collections.Counter()
            for k in e.kernels:
                if not k.name.startswith((SCOPE, PHASE)):  # not a range's device span
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


def _scope_of(e):
    hit = _ancestor(e, lambda p: p.name.startswith(SCOPE))
    return hit.name[len(SCOPE):] if hit is not None else None


def aggregate(prof, device: torch.device) -> dict:
    """The trace by kernel, by scope bucket, by phase and by (phase,
    bucket), in us over the whole trace: ``{"total", "busy", "kernels",
    "buckets", "phases", "phase_buckets"}`` (``busy``: :func:`busy_us`). A backward operator takes the scope of the
    forward operator that made its autograd node (the same sequence
    number); an operator takes the ``phase::`` range whose host interval
    holds its start (the backward may run on another thread);
    ``unattributed`` where none does."""
    work = op_work(prof, device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    forward_scope = {}
    for e in events:
        if (e.sequence_nr >= 0 and not _annotation(e)
                and _ancestor(e, lambda p: p.name.startswith(_BACKWARD_NODE)) is None):
            forward_scope.setdefault(e.sequence_nr, _scope_of(e))
    phases = sorted((e.time_range.start, e.time_range.end, e.name[len(PHASE):])
                    for e in events if e.name.startswith(PHASE))
    kernels, phase_buckets = collections.Counter(), collections.Counter()
    for e, k in work:
        kernels.update(k)
        scope = _scope_of(e)
        node = _ancestor(e, lambda p: p.name.startswith(_BACKWARD_NODE))
        if scope is None and node is not None:
            scope = forward_scope.get(node.sequence_nr)
        start = e.time_range.start
        phase = next((name for lo, hi, name in phases if lo <= start < hi),
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
    account for. A ``record_function`` range (the tool's, or the
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
    """The kernel table (top-k by share, down to ``min_pct`` %) and the scope
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
    print(f"\nscope buckets (us/{unit}):")
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
    in the scope ranges; prints the lines and returns ``{ms, fps,
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
        with scope_ranges(model):
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
