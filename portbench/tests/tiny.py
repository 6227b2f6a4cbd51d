"""A benchmark cell cut to a size the CPU runs in seconds: a copy of
``portbench/`` in a temporary directory with the cell's configuration at
64 px (one lifting layer) and its traffic at batch 2, driven through
:func:`portbench.run.execute` on the CPU (the port's plain versions of its
kernels), past the look for a card."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import run as prun

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


def bench_copy(tmp: Path) -> Path:
    bench = Path(tmp) / "portbench"
    if not bench.exists():
        shutil.copytree(prun.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    return bench


def tiny_cell(tmp: Path, name: str) -> prun.Cell:
    bench = bench_copy(tmp)
    spec = json.loads((prun.ROOT / "BENCHMARK.json").read_text())
    conf = json.loads(prun.Cell(name, spec, bench).config_path.read_text())
    mc = conf["model"]["init_args"]["model_cfg"]
    mc["image_size"] = [64, 64]
    if "pose3d_cfg" in mc:
        mc["pose3d_cfg"]["num_former_layers"] = 1
    path = bench / "configs" / f"{spec_cell(spec, name)['config']}.json"
    path.write_text(json.dumps(conf))
    return prun.Cell(name, spec, bench)


def spec_cell(spec, name):
    return next(w for w in spec["workloads"] if w["name"] == name)


def run_tiny(cell: prun.Cell, trace: bool = False, seed: int = SEED):
    torch.manual_seed(0)
    over = dict(batch=2, pool=3, warmup=1, traced=2, sample=2)
    return prun.execute(cell, seed, 0.5, trace, torch.device("cpu"), over)
