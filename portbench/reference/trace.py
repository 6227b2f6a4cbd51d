"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
metrics read.

Adapted from ``egorear_tpu_torch/tools/profile_fwd.py`` (``scope_ranges``,
``op_work``, ``aggregate``, ``busy_us``, ``KERNEL_SYMBOLS``) and
``tools/profile_train.py`` (the forward / backward / optimizer split) at
commit 6e4c43b. What changed: a kernel counts in every ``scope::`` range
open above the host operator that launched it, not only the innermost; a
backward operator takes the scopes of the forward operator that made its
autograd node (the same sequence number); the phase of a train step comes
from the benchmark's own ``step::`` range: an operator under the autograd
engine is ``backward``, one on the step's thread after the engine's last
operator is ``optimizer``, the rest ``forward``. The device's busy time is
the union of its kernel, copy and set intervals, and the idle gaps are
labelled by the host operator that was running when each began.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

SCOPE, STEP = "scope::", "step::"
_BACKWARD_NODE = "autograd::engine::evaluate_function"

# The __global__ functions of each csrc source, as the profiler names them.
KERNEL_SYMBOLS = {
    "lazy_deform_sample": r"lazy_deform_sample_kernel\b",
    "lazy_deform_sample_bwd": r"lazy_deform_sample_bwd_\w*kernel\b",
}


def kernel_pattern(name: str) -> re.Pattern:
    return re.compile(r"(?<![A-Za-z0-9_])" + KERNEL_SYMBOLS[name])


@contextlib.contextmanager
def scope_ranges(model: torch.nn.Module, scopes):
    """Inside the block every module that a scope selects runs its forward
    in a ``scope::<name>`` range, opened and closed by forward hooks.
    ``scopes`` is [(name, test(module path, module))]."""
    handles = []
    for path, module in model.named_modules():
        for name, test in scopes:
            if not test(path, module):
                continue
            opened = []

            def enter(mod, args, name=name, opened=opened):
                rf = record_function(SCOPE + name)
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


def _ancestors(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _scopes(e):
    return frozenset(p.name[len(SCOPE):] for p in _ancestors(e)
                     if p.name.startswith(SCOPE))


def _node(e):
    return next((p for p in _ancestors(e) if p.name.startswith(_BACKWARD_NODE)), None)


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def summarize(prof, top: int = 10) -> dict:
    """``{"launches", "busy_us", "kernels", "work"}`` of a trace,
    and its ``breakdown``. ``work`` is [(kernel name, us, scopes, phase)]
    for every device kernel, copy and set that a host operator launched."""
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in host}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in host_names]

    forward_scopes = {}
    for e in host:
        if e.sequence_nr >= 0 and not e.name.startswith((SCOPE, STEP)) and _node(e) is None:
            forward_scopes.setdefault(e.sequence_nr, _scopes(e))
    # Each step's end of the backward: the last autograd-engine operator in it.
    steps = sorted((e.time_range.start, e.time_range.end) for e in host
                   if e.name.startswith(STEP))
    bwd_end = {}
    for e in host:
        if e.name.startswith(_BACKWARD_NODE):
            i = bisect.bisect_right(steps, (e.time_range.start, float("inf"))) - 1
            if i >= 0:
                bwd_end[i] = max(bwd_end.get(i, 0), e.time_range.end)

    work = []
    for e in host:
        launched = [k for k in e.kernels if k.name not in host_names]
        if not launched:
            continue
        scopes, node = _scopes(e), _node(e)
        if node is not None:
            scopes = scopes | forward_scopes.get(node.sequence_nr, frozenset())
            phase = "backward"
        else:
            i = bisect.bisect_right(steps, (e.time_range.start, float("inf"))) - 1
            phase = ("optimizer" if i in bwd_end and e.time_range.start >= bwd_end[i]
                     else "forward")
        for k in launched:
            work.append((k.name, k.duration, scopes, phase))

    busy = _merge((k.time_range.start, k.time_range.end) for k in device)
    kernels = collections.Counter()
    for k in device:
        kernels[k.name] += k.time_range.end - k.time_range.start
    return dict(launches=len(device), busy_us=sum(hi - lo for lo, hi in busy),
                kernels=kernels, work=work,
                breakdown=_breakdown(kernels, busy, host, top))


def _breakdown(kernels, busy, host, top):
    """The device operations that took most time, and the idle gaps between
    busy intervals summed by the innermost host operator running (on any
    thread) when each gap began, in seconds."""
    ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in host
                  if not e.name.startswith((SCOPE, STEP))), key=lambda t: t[0])
    starts = [s for s, _, _ in ops]
    gaps = collections.Counter()
    for (_, hi), (lo, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, hi) - 1
        label = "no host operator"
        for j in range(i, max(i - 200, -1), -1):  # the latest-started that covers it
            if ops[j][1] >= hi:
                label = ops[j][2]
                break
        gaps[label] += lo - hi
    return {"device_ops": [[n, us / 1e6] for n, us in kernels.most_common(top)],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps.most_common(top)]}
