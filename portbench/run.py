"""Run one cell of the benchmark of ``egorear_tpu_torch`` once and print its
result as the last line of standard output:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; everything else is
found by name: the configuration ``portbench/configs/<config>.json``, the
traffic mix ``portbench/traffic/<traffic>.json`` and its kind's module
``portbench/traffic/<kind>.py``, the comparison limits
``portbench/workloads/<cell>.json`` and, with ``--trace 1``, one reader per
per-layer metric, ``portbench/metrics/<metric>.py``. It needs a CUDA card
and never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # the run's set-up starts here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "egorear_tpu")


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` and every file it names."""

    def __init__(self, name: str, spec: dict, bench: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config_path = bench / "configs" / f"{self.entry['config']}.json"
        self.config = json.loads(self.config_path.read_text())
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.kind_path = bench / "traffic" / f"{self.traffic['kind']}.py"
        self.limits = json.loads(
            (bench / "workloads" / f"{name}.json").read_text())["limits"]

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.metric_paths = {m["name"]: bench / "metrics" / f"{m['name']}.py"
                             for m in self.per_layer}
        for p in [self.kind_path, *self.metric_paths.values()]:
            if not p.is_file():
                raise FileNotFoundError(p)


class Run:
    """What a traffic kind's module gets: the cell, the run's arguments and
    the device, and where it reports."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 overrides=None):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.params = dict(cell.traffic, **(overrides or {}))
        self.t_start = T_START

    def lap(self, what: str) -> None:
        """Note the set-up's seconds so far, after ``what``."""
        self.note(f"setup: {what} at {time.perf_counter() - self.t_start:.3f} s")

    def note(self, line: str) -> None:
        print(line, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, overrides=None):
    """Run the cell once on ``device``; returns the result dict (the last
    line's object) and the run's checks."""
    import torch

    from portbench import readers

    run = Run(cell, seed, seconds, trace, device, overrides)
    kind = load_module(cell.kind_path)
    out = kind.run(run)  # {"e2e", "summary", "checks", "attempted", "failed", "peak"}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module(cell.metric_paths[m["name"]]).read(out["summary"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    is_cuda = torch.device(device).type == "cuda"
    result = {
        "correct": all(c["ok"] for c in out["checks"]),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if is_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(out["peak"])},
    }
    if trace:
        s = out["summary"]
        result["device"]["busy_s"] = s["busy_s"]
        result["device"]["window_s"] = s["window_s"]
        result["breakdown"] = s["breakdown"]
        print(f"idle at the untraced rate: {readers.idle_untraced_pct(s)!r} %",
              file=sys.stderr)
    # Last, each compared number beside its limit (null where not finite).
    result["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(c["value"]) else None,
                                    "limit": c["limit"]} for c in out["checks"]}
    return result, out["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build, kernel and bytecode caches at fixed paths inside the checkout
    # (where the installed packages hold no bytecode and none is written,
    # every import would compile its source again in every run).
    cache = ROOT / "build" / "portbench"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    cell = Cell(args.workload, json.loads((ROOT / "BENCHMARK.json").read_text()))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
