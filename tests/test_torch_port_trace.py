"""The port's spans and counters (``egorear_tpu_torch.utils.trace``): on
exactly while a ``torch.profiler`` session records, nested with their
parents and items, one clock with the profiler's own ranges, reset at each
session, counters charged to the innermost span, the sync check scoped to
the top-level spans, and ``Trainer.fit``'s ``profile/spans.json``. The last
test needs a card (it skips without one; the file imports no JAX, so it
also runs with ``--noconftest`` on the card's host).
"""

from __future__ import annotations

import json
import os
import statistics
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from egorear_tpu_torch.utils import trace
from torch_threads import torch_threads  # noqa: F401


def _profiled(fn, cuda: bool = False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
    return prof


def _nested():
    for i in range(3):
        with trace.span("forward", item=10 + i, batch=i):
            with trace.span("stage", view=i):
                trace.count("n", 2)
                with trace.span("sample", shape=torch.zeros(2, 3)):  # kept as its shape
                    torch.ones(8).sum()
            with trace.span("stage", view=i + 1):
                pass


def _ranges(prof):
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CPU
                   and e.name.startswith(trace.PREFIX)), key=lambda e: e.time_range.start)


def test_spans_nest_share_items_and_keep_attributes():
    _profiled(_nested)
    spans = trace.collected()["spans"]
    assert [s["name"] for s in spans] == ["forward", "stage", "sample", "stage"] * 3
    for k in range(3):
        top, stage, sample, stage2 = spans[4 * k:4 * k + 4]
        assert top["parent"] is None and top["attrs"] == {"batch": k}
        assert stage["parent"] == sample["parent"] - 1 == top["index"]
        assert sample["parent"] == stage["index"] and stage2["parent"] == top["index"]
        assert {s["item"] for s in (top, stage, sample, stage2)} == {10 + k}
        assert stage["attrs"] == {"view": k} and sample["attrs"] == {"shape": (2, 3)}
        assert stage["counts"] == {"n": 2} and top["counts"] == {}
        assert top["start_ns"] <= stage["start_ns"] <= sample["start_ns"]
        assert sample["end_ns"] <= stage["end_ns"] <= stage2["start_ns"] <= top["end_ns"]
    assert trace.under(trace.collected(), "forward") == (3, {"n": 6})
    assert trace.under(trace.collected(), "train.step") is None


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    _profiled(_nested)
    before = trace.collected()

    def refused(*args, **kwargs):
        raise AssertionError("a record_function range was entered with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    assert trace.span("forward", view=1) is trace.span("stage")
    _nested()
    trace.count("n")
    assert trace.collected() == before


def test_ranges_nest_as_the_spans_on_the_profilers_clock():
    _profiled(_nested)  # a first session warms the profiler's own calls
    best = None
    for _ in range(3):  # a descheduled thread delays one reading: take the best session
        prof = _profiled(_nested)
        spans, ranges = trace.collected()["spans"], _ranges(prof)
        assert [r.name for r in ranges] == [trace.PREFIX + s["name"] for s in spans]
        for s, r in zip(spans, ranges):
            parent = None if s["parent"] is None else trace.PREFIX + spans[s["parent"]]["name"]
            assert (r.cpu_parent.name if r.cpu_parent else None) == parent
        offsets = [s["start_ns"] / 1e3 - r.time_range.start for s, r in zip(spans, ranges)]
        offset = statistics.median(offsets)
        worst = max(abs(o - offset) for o in offsets)
        best = worst if best is None else min(best, worst)
    assert best < 50.0, f"span starts {best:.1f} us off their ranges' after one offset"


def test_store_is_reset_at_each_session():
    def one():
        with trace.span("forward"):
            pass

    _profiled(_nested)
    assert len(trace.collected()["spans"]) == 12
    _profiled(one)
    assert [s["name"] for s in trace.collected()["spans"]] == ["forward"]
    _profiled(lambda: None)
    assert trace.collected()["spans"] == []


def test_count_and_syncs_charge_the_innermost_span(monkeypatch):
    # The allocator is read as the top-level span opens and closes, and only then.
    monkeypatch.setattr(trace, "_device_allocs", iter(range(0, 20, 7)).__next__)

    def body():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            warnings.warn(trace.SYNC_MESSAGE)  # no span open: not counted
            with trace.span("forward"):
                trace.count("h2d_bytes", 5)
                with trace.span("stage"):
                    warnings.warn(trace.SYNC_MESSAGE)
                    warnings.warn(trace.SYNC_MESSAGE)
                    warnings.warn("another warning")
                warnings.warn(trace.SYNC_MESSAGE)
            warnings.warn(trace.SYNC_MESSAGE)
        return [str(w.message) for w in seen]

    out = []
    _profiled(lambda: out.extend(body()))
    # Inside a top-level span the sync warnings are counted and not shown;
    # outside, and any other warning, pass through as before.
    assert out == [trace.SYNC_MESSAGE, "another warning", trace.SYNC_MESSAGE]
    top, stage = trace.collected()["spans"]
    assert top["counts"] == {"h2d_bytes": 5, "syncs": 1, "device_allocs": 7}
    assert stage["counts"] == {"syncs": 2}
    sites = trace.collected()["sync_sites"]
    assert sum(sites.values()) == 3 and all(k.startswith(("forward ", "stage ")) for k in sites)
    rows = {r[0]: r[1:] for r in trace.table(trace.collected())}
    assert rows["forward"][0] == 1 and rows["stage"][0] == 1
    assert rows["forward"][3] == 1 and rows["stage"][3] == 2
    assert rows["forward"][4] == 7 and rows["stage"][4] == 0
    assert rows["forward"][1] >= rows["forward"][2] >= 0  # total >= self


class _Pairs:
    """A stage-1 dataset of four 64-px stereo samples."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return {"img": rng.standard_normal((2, 3, 64, 64), dtype=np.float32),
                "gt_heatmap": rng.random((2, 15, 16, 16), dtype=np.float32)}


def test_fit_with_profile_steps_writes_spans(tmp_path):
    from egorear_tpu_torch.train.tasks import HeatmapTask
    from egorear_tpu_torch.train.trainer import Trainer, TrainerConfig

    task = HeatmapTask({"num_heatmap": 15, "encoder_cfg": {
        "resnet_cfg": {"use_imagenet_pretrain": False}}}, device="cpu")
    cfg = TrainerConfig(max_epochs=1, save_dir=str(tmp_path), profile_steps=2,
                        log_every_n_steps=1)
    trainer = Trainer(task, lr=1e-3, weight_decay=1e-4, lr_decay_epochs=(),
                      warmup_iters=1, batch_size=2, workers=1, config=cfg)
    trainer.fit(_Pairs())
    out = os.path.join(trainer.logger.dir, "profile")
    assert os.path.exists(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "spans.json")) as f:
        data = json.load(f)
    spans = data["spans"]
    tops = [(s["name"], s["item"]) for s in spans if s["parent"] is None]
    # The session stops after the second step, before its log.
    assert tops == [("fit.wait", 0), ("train.step", 0), ("fit.log", 1),
                    ("fit.wait", 1), ("train.step", 1)]
    under = {s["name"] for s in spans if s["parent"] is not None}
    assert {"forward", "stage1.encoder", "stage1.head", "norm", "train.backward",
            "train.reduce", "train.clip", "train.optimizer"} <= under
    assert trace.under(data, "train.step")[0] == 2
    report = trace.report(data)
    assert "fit.wait:" in report and "train.step" in report


@pytest.mark.cuda
def test_syncs_match_the_profilers_synchronising_calls_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from egorear_tpu_torch import entry

    task, _ = entry.build_train((64, 64), device="cuda", precision="32",
                                steps_per_epoch=1, imagenet=False)
    img = torch.randn(2, 4, 3, 64, 64, device="cuda")
    forward = task.model.forward

    def planted(*args, **kwargs):
        # The forward itself makes no sync: one pageable copy to the card
        # inside the ``forward`` span gives the counter one to count.
        torch.tensor([64.0, 64.0], device="cuda")
        return forward(*args, **kwargs)

    monkeypatch.setattr(task.model, "forward", planted)

    def forwards():
        for _ in range(3):
            task._eval_forward({"img": img})
        torch.cuda.synchronize()

    forwards()  # builds the kernels, warms the allocator
    for _ in range(3):
        prof = _profiled(forwards, cuda=True)
        data = trace.collected()
        items, counts = trace.under(data, "forward")
        host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
        ranges = [(e.time_range.start, e.time_range.end, e.thread) for e in host
                  if e.name == trace.PREFIX + "forward"]
        synchronising = [e for e in host if e.name == "cudaStreamSynchronize"
                         or (e.name.startswith("cudaMemcpy") and "Async" not in e.name)]
        inside = [e for e in synchronising if any(
            lo <= e.time_range.start < hi and e.thread == t for lo, hi, t in ranges)]
        print(f"\n{items} forwards: syncs {counts.get('syncs', 0)}, device_allocs "
              f"{counts.get('device_allocs', 0)}; the profiler's synchronising calls "
              f"{len(inside)}; sites {data['sync_sites']}")
        assert items == 3 and len(ranges) == 3
        assert counts.get("syncs", 0) == len(inside) == 3
        spans, named = data["spans"], _ranges(prof)
        assert [r.name for r in named] == [trace.PREFIX + s["name"] for s in spans]
        offsets = [s["start_ns"] / 1e3 - r.time_range.start for s, r in zip(spans, named)]
        offset = statistics.median(offsets)
        off = sorted(abs(o - offset) for o in offsets)
        late = sum(d >= 50.0 for d in off)
        print(f"{len(spans)} spans: {len(spans) - late} start within 50 us of their ranges' "
              f"after one offset, the worst {off[-3:]}")
        # A pause of the host between the profiler's stamp and the clock's
        # reading makes a few spans late by up to ~180 us on the card's host.
        assert late <= 0.03 * len(spans) and off[-1] < 250.0
