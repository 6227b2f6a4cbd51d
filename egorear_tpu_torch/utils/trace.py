"""Spans and counters inside the program, recorded exactly while a
``torch.profiler`` session records (the benchmark's traced window,
``Trainer(profile_steps=N)``, the tools' traces) and never otherwise.

``with span(name, **attrs):`` records the name, the start and end on
``time.monotonic_ns()``, the parent span, the item (the id of a batch or a
step: the top-level span's ``item``, or the count of top-level spans) and
the attributes; while on it is also a ``record_function`` range named
``egorear::<name>``, so the spans sit in the profiler's own timeline. A
tensor given as an attribute is kept as its shape.
``count(name, n)`` adds to a counter of the innermost open span. Two
counters are kept by the module itself:

* ``syncs``: each blocking host-device synchronisation (a pageable copy,
  ``.item()``, a stream synchronise). A top-level span turns PyTorch's
  sync check on (``torch.cuda.set_sync_debug_mode("warn")``) and counts
  its warnings, with the line of the program that made each
  (``collected()["sync_sites"]``), and turns it off again on exit.
* ``device_allocs``: the caching allocator's device allocations
  (``num_device_alloc``), read as a top-level span opens and closes and
  charged to it.

Off, ``span`` returns one shared null context after one check and
``count`` returns after one. Spans are opened from one thread at a time
(the autograd engine's threads run while their caller waits in it). The
store holds the last profiler session's spans: ``collected()`` reads it,
``write(path)`` writes it as JSON, ``table()`` sums it by span name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import time
import warnings

import torch
from torch.autograd import profiler as _profiler

PREFIX = "egorear::"
SYNC_MESSAGE = "called a synchronizing CUDA operation"
_NULL = contextlib.nullcontext()


class _Store:
    def __init__(self):
        self.stack = []  # the open span records, innermost last
        self.cuda, self.allocs = False, 0  # num_device_alloc as the top span opened
        self.reset()

    def reset(self):
        self.spans, self.sites, self.tops = [], collections.Counter(), 0


_store = _Store()


def _session_started(start=_profiler._run_on_profiler_start):
    """Every profiler session starts with this call: the store is reset."""
    start()
    _store.reset()


_profiler._run_on_profiler_start = _session_started


def span(name: str, item=None, **attrs):
    """A span named ``name``; ``item`` sets a top-level span's item id."""
    if not (_store.stack or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, item, attrs)


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if _store.stack:
        counts = _store.stack[-1]["counts"]
        counts[name] = counts.get(name, 0) + n


def _device_allocs() -> int:
    if not _store.cuda:
        return 0
    return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc", 0)


def _sync_warning(message, category, filename, lineno, file=None, line=None):
    if not str(message).startswith(SYNC_MESSAGE):
        return _store.showwarning(message, category, filename, lineno, file, line)
    if _store.stack:
        rec = _store.stack[-1]
        count("syncs")
        at = filename.replace("\\", "/").rsplit("egorear_tpu_torch/", 1)[-1]
        _store.sites[f"{rec['name']} {at}:{lineno}"] += 1


class _Span:
    __slots__ = ("rec", "rf", "top")

    def __init__(self, name, item, attrs):
        attrs = {k: tuple(v.shape) if isinstance(v, torch.Tensor) else v
                 for k, v in attrs.items()}
        self.rec = {"name": name, "item": item, "attrs": attrs, "counts": {}}

    def __enter__(self):
        stack, rec = _store.stack, self.rec
        self.top = not stack
        if self.top:
            _store.cuda = torch.cuda.is_initialized()
            _store.warn = warnings.catch_warnings()
            _store.warn.__enter__()
            warnings.filterwarnings("always", message=SYNC_MESSAGE)
            _store.showwarning, warnings.showwarning = warnings.showwarning, _sync_warning
            if _store.cuda:
                _store.mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            if rec["item"] is None:
                rec["item"] = _store.tops
            _store.tops += 1
            rec["parent"] = None
            _store.allocs = _device_allocs()
        else:
            rec["parent"], rec["item"] = stack[-1]["index"], stack[-1]["item"]
        rec["index"] = len(_store.spans)
        _store.spans.append(rec)
        stack.append(rec)
        self.rf = _profiler.record_function(PREFIX + rec["name"])
        self.rf.__enter__()
        rec["start_ns"] = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.monotonic_ns()
        self.rf.__exit__(*exc)
        _store.stack.pop()
        if self.top:
            n = _device_allocs() - _store.allocs
            if n:
                self.rec["counts"]["device_allocs"] = n
            if _store.cuda:
                torch.cuda.set_sync_debug_mode(_store.mode)
            _store.warn.__exit__(*exc)
        return False


def collected() -> dict:
    """The last profiler session's spans (each ``{"name", "item", "attrs",
    "counts", "parent", "index", "start_ns", "end_ns"}``, in opening order)
    and ``sync_sites`` (syncs by "<span> <file>:<line>")."""
    return {"spans": [s for s in _store.spans if "end_ns" in s],
            "sync_sites": dict(_store.sites)}


def write(path: str, data=None) -> None:
    with open(path, "w") as f:
        json.dump(collected() if data is None else data, f)


def under(data: dict, top: str):
    """``(items, counters)`` summed over the spans under the top-level spans
    named ``top``; None when there is no such span."""
    spans = data["spans"]
    root = {}
    for s in spans:
        root[s["index"]] = s["name"] if s["parent"] is None else root.get(s["parent"])
    items = {s["item"] for s in spans if s["parent"] is None and s["name"] == top}
    if not items:
        return None
    totals = collections.Counter()
    for s in spans:
        if root[s["index"]] == top:
            totals.update(s["counts"])
    return len(items), totals


def table(data: dict) -> list:
    """Per span name: ``(name, count, total ms, self ms, syncs,
    device_allocs)``, self being the duration less the children's, by
    total time."""
    child = collections.Counter()
    for s in data["spans"]:
        if s["parent"] is not None:
            child[s["parent"]] += s["end_ns"] - s["start_ns"]
    rows = {}
    for s in data["spans"]:
        d = s["end_ns"] - s["start_ns"]
        r = rows.setdefault(s["name"], [0, 0, 0, 0, 0])
        r[0] += 1
        r[1] += d / 1e6
        r[2] += (d - child[s["index"]]) / 1e6
        r[3] += s["counts"].get("syncs", 0)
        r[4] += s["counts"].get("device_allocs", 0)
    return sorted(((n, *r) for n, r in rows.items()), key=lambda r: -r[2])


def report(data: dict) -> str:
    """:func:`table` as text, with the ``fit.wait`` spans' share of the
    time from the first span's start to the last one's end."""
    lines = [f"{'span':<18}{'count':>7}{'total ms':>11}{'self ms':>11}{'syncs':>7}"
             f"{'allocs':>8}"]
    lines += [f"{n:<18}{c:>7}{t:>11.3f}{s:>11.3f}{y:>7}{a:>8}"
              for n, c, t, s, y, a in table(data)]
    spans = data["spans"]
    wait = sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == "fit.wait")
    if wait:
        whole = max(s["end_ns"] for s in spans) - min(s["start_ns"] for s in spans)
        lines.append(f"fit.wait: {wait / 1e6:.3f} ms of {whole / 1e6:.3f} ms "
                     f"({100.0 * wait / whole:.1f} %)")
    return "\n".join(lines)
