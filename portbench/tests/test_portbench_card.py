"""On the card, at a size a test run holds: a tiny run of each cell is
correct, and the control (the reference with TF32 on, put in the
program's place) fails one of the cell's numbers. Skips without a card."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import calibrate, window
from portbench import run as prun
from portbench.reference import compare
from portbench.tests import tiny

CELLS = [w["name"] for w in json.loads((prun.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_on_card_is_correct(tmp_path, name):
    dev = _card()
    cell = tiny.tiny_cell(tmp_path, name)
    over = dict(batch=4, pool=3, warmup=1, traced=2, sample=2)
    result, checks = prun.execute(cell, tiny.SEED, 1.0, False, dev, over)
    assert result["correct"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tmp_path, name):
    dev = _card()
    cell = tiny.tiny_cell(tmp_path, name)
    cell.traffic.update(batch=4, pool=2, sample=2)
    for seed in (tiny.SEED, tiny.SEED + 1, tiny.SEED + 2):
        if cell.traffic["kind"] == "serve":
            numbers = calibrate.control_serve(cell, seed, dev)
        else:
            numbers = calibrate.control_train(cell, seed, dev)["control"]
        window.release(dev)
        judged = compare.judged(numbers, cell.limits)
        assert not all(c["ok"] for c in judged), judged
