"""What every traffic kind's module shares: the device's clock and memory,
the traced window and the summary the per-layer metrics read, the
required work of a forward or a step, and the reference on the device."""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import re
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import build as ref_build
from portbench.reference import roofline, trace, weights
from portbench.reference.model import MSDeformAttnTorch

SCOPES_DIR = Path(__file__).resolve().parent / "scopes"


def synchronize(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0


def reset_peak(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def release(dev) -> None:
    """Hand the program's freed blocks back before the reference runs."""
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for cuBLAS and cuDNN on or off inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference(task_name: str, model_cfg: dict, seed: int, dev):
    """The reference network on ``dev`` with the run's seeded weights."""
    with torch.device(dev):
        ref = ref_build.build_reference(task_name, model_cfg)
    ref.load_state_dict(weights.seeded_state_dict(ref, seed, dev))
    return ref


def scopes():
    """[(name, test(module path, module))] of ``scopes/<name>.json``: a
    ``path`` pattern searched in the module's path, or a ``class`` name
    that the module's class or one of its bases has."""
    out = []
    for f in sorted(SCOPES_DIR.glob("*.json")):
        spec = json.loads(f.read_text())
        if "path" in spec:
            pattern = re.compile(spec["path"])
            out.append((f.stem, lambda path, m, p=pattern: bool(p.search(path))))
        else:
            cls = spec["class"]
            out.append((f.stem, lambda path, m, c=cls: any(
                k.__name__ == c for k in type(m).__mro__)))
    return out


class Traced:
    """The traced window: ``torch.profiler`` (host operators and the card's
    activity) with the benchmark's scope ranges on the program's modules;
    :meth:`mark` opens a range of the benchmark's own, :meth:`summary`
    reduces the trace."""

    def __init__(self, dev, model):
        self.dev, self.model = torch.device(dev), model

    def __enter__(self):
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._scopes = trace.scope_ranges(self.model, scopes())
        self._scopes.__enter__()
        synchronize(self.dev)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self.dev)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        self._scopes.__exit__(*exc)
        return False

    @staticmethod
    def mark(name: str):
        return record_function(name)

    def summary(self, items: int, rate: float) -> dict:
        """The trace reduced, with the window's ``items`` and the untraced
        ``rate`` (items a second) measured before it."""
        s = trace.summarize(self.prof)
        s.update(items=items, rate=rate, window_s=self.window_s,
                 busy_s=s["busy_us"] / 1e6, peak_bytes=peak_bytes(self.dev))
        return s


def flops_per_sample(task_name: str, model_cfg: dict, train: bool) -> float:
    """The matmul, convolution and attention FLOPs one sample needs, counted
    by ``FlopCounterMode`` over the reference on the meta device at batch
    2 (halved): the forward, and for training its backward too (what the
    configuration's stops of gradient leave); nothing recomputed.

    The projections of a value grid are counted as the lazy order needs
    them, since a linear map commutes with the sampling's weighted sum:
    each cross-attention's ``value_proj`` on its queries' rows, and the
    grid projection before it (the module's ``GRID_PROJ``) on the rows its
    calls sample (queries times heads), not on every grid position."""
    with torch.device("meta"):
        ref = ref_build.build_reference(task_name, model_cfg)
        size = model_cfg["image_size"][0]
        img = torch.empty(2, 4, 3, size, size)
        ref.train(train)
        saved, hooks = lazy_savings(ref)
        counter = FlopCounterMode(display=False)
        with counter:
            if train:
                preds, hms = ref_build.forward(task_name, ref, img)
                total = sum(h.sum() for h in hms) + sum(p.sum() for p in preds)
                total.backward()
            else:
                with torch.no_grad():
                    ref_build.forward(task_name, ref, img)
        for h in hooks:
            h.remove()
    return (counter.get_total_flops() - saved()) / 2


def lazy_savings(ref):
    """Hooks on ``ref`` that note, over a forward, the FLOPs of its grid
    projections on the rows that the lazy order does not project: each
    row costs two FLOPs a weight in the forward, and as much again in the
    backward for the weight's and for the input's gradient where either is
    wanted. Returns ``(saved, hooks)``, ``saved()`` giving the FLOPs."""
    per_row, counted, needed = {}, collections.Counter(), collections.Counter()
    owner = {}  # cross-attention -> the grid projection that feeds it

    def proj(mod, args, out):
        x = args[0]
        passes = 1
        if torch.is_grad_enabled():
            passes += int(mod.weight.requires_grad) + int(x.requires_grad)
        per_row[mod] = 2 * mod.weight[0].numel() * mod.weight.shape[0] * passes
        channels = out.shape[-1] if isinstance(mod, torch.nn.Linear) else out.shape[1]
        counted[mod] += out.numel() // channels

    def attn(mod, args):
        query, _, value = args
        B, Q, _ = query.shape
        needed[mod.value_proj] += B * Q
        if mod in owner:
            needed[owner[mod]] += B * Q * mod.nh

    hooks = []
    for m in ref.modules():
        if isinstance(m, MSDeformAttnTorch):
            hooks.append(m.register_forward_pre_hook(attn))
            hooks.append(m.value_proj.register_forward_hook(proj))
        if getattr(type(m), "GRID_PROJ", None):
            grid = getattr(m, type(m).GRID_PROJ)
            hooks.append(grid.register_forward_hook(proj))
            owner.update({a: grid for a in m.modules() if isinstance(a, MSDeformAttnTorch)})

    def saved():
        return sum(per_row[m] * (counted[m] - needed[m]) for m in counted)

    return saved, hooks


def peak_flops(cell) -> float:
    return roofline.PEAK_FLOPS[cell.config["precision_peak"]]


def sampling_bound_ms(calls, backward: bool) -> float:
    """The least time of the recorded sampling calls: each forward, and
    with ``backward`` each backward that a call with gradient gets."""
    total = 0.0
    for c in calls:
        args = (c["feat_shape"], c["elem"], c["loc"], c["attn_w"], c["pos_shape"],
                c["pos_block"])
        total += roofline.lazy_sample_bound_ms(*args)
        if backward and c["grad"]:
            total += roofline.lazy_sample_backward_bound_ms(*args, c["need_feat"])
    return total
