"""The harness on the CPU: every cell resolves by name, a cell and a
metric added as files are found, each traffic kind runs at a tiny size
against the reference, the measurement path refuses to run without a
card, and neither the harness nor the reference loads JAX (nor the
reference the program)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import run as prun
from portbench.tests import tiny

SPEC = json.loads((prun.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = prun.Cell(name, SPEC)
    assert cell.config_path.is_file() and cell.kind_path.is_file()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:  # the metric's end-to-end metric is the cell's too
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert set(cell.limits)


def test_added_cell_and_metric_are_found(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append(dict(spec["workloads"][0], name="syn_pose3d.extra",
                                  traffic="extra_mix"))
    spec["per_layer"].append({"name": "extra_metric.serve", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "device (one H100)",
                              "moves": "serve_frames_per_s",
                              "workloads": ["syn_pose3d.extra"]})
    mix = json.loads((bench / "traffic" / "serve_b32.json").read_text())
    (bench / "traffic" / "extra_mix.json").write_text(json.dumps(dict(mix, batch=16)))
    (bench / "workloads" / "syn_pose3d.extra.json").write_text(
        (bench / "workloads" / "syn_pose3d.serve_b32.json").read_text())
    (bench / "metrics" / "extra_metric.serve.py").write_text(
        "def read(s):\n    return 1.0\n")
    cell = prun.Cell("syn_pose3d.extra", spec, bench)
    assert cell.traffic["batch"] == 16
    assert "extra_metric.serve" in cell.metric_paths
    assert prun.load_module(cell.metric_paths["extra_metric.serve"]).read({}) == 1.0
    (bench / "metrics" / "extra_metric.serve.py").unlink()
    with pytest.raises(FileNotFoundError):
        prun.Cell("syn_pose3d.extra", spec, bench)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(tmp_path, name):
    result, checks = tiny.run_tiny(tiny.tiny_cell(tmp_path, name))
    assert result["correct"], checks
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in prun.Cell(name, SPEC).end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    json.dumps(result, allow_nan=False)


def test_traced_tiny_run(tmp_path):
    result, _ = tiny.run_tiny(tiny.tiny_cell(tmp_path, "syn_mvfex.train_b64"), trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    rc = prun.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=prun.ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = ("import pathlib, runpy\n"
            "from portbench import run, program, window, readers, calibrate\n"
            "import portbench.reference.build, portbench.reference.compare\n"
            "for p in sorted(pathlib.Path('portbench').glob('*/*.py')):\n"
            "    if p.parent.name != 'tests':\n"
            "        run.load_module(p)\n")
    found = _modules_after(code)
    assert not found & set(prun.FORBIDDEN), found & set(prun.FORBIDDEN)
    assert "egorear_tpu_torch" in found


def test_reference_loads_no_program():
    code = ("import pathlib, importlib\n"
            "for p in sorted(pathlib.Path('portbench/reference').glob('*.py')):\n"
            "    importlib.import_module('portbench.reference.' + p.stem)\n")
    found = _modules_after(code)
    assert not found & {*prun.FORBIDDEN, "egorear_tpu_torch"}, found


def test_reference_decay_rule_is_the_ports():
    """Stage 3 exempts norms and biases from weight decay: the reference's
    rule by module kind picks the leaves the port's rule picks by path."""
    from egorear_tpu_torch.train.optim import decay_mask
    from egorear_tpu_torch.train.tasks import Pose3DTask
    from portbench import program
    from portbench.reference import build, train
    from portbench.traffic import train_step

    conf = prun.Cell("syn_pose3d.train_b32", SPEC).config
    mc = json.loads(json.dumps(conf["model"]["init_args"]["model_cfg"]))
    mc["image_size"] = [64, 64]
    mc["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    port = Pose3DTask(mc, device="cpu").model
    layout = train_step.small_layout("pose_3d_mvf_ex", mc)
    keymap = program.leaf_map("pose_3d_mvf_ex", [(k, tuple(t.shape)) for k, t in layout])
    with torch.device("meta"):
        ref = build.build_reference("pose_3d_mvf_ex", mc)
    want = train.decays(ref, conf["exempt_norms_and_biases"])
    got = {keymap[n]: d for n, d in decay_mask(port).items()}
    assert got == want


def test_lazy_count_leaves_out_the_grid_rows():
    """``mfu``'s count takes off each grid projection's rows beyond those
    the lazy order samples: for the stage-3 forward at 64 px (a 16 x 16
    grid, 4 views, 4 heads), 4 refiners' value projections (256 wide) on
    15 queries and their 128 -> 256 grid projections on 15 x 4 rows a
    view, and 3 lifting layers' value projections (128 wide) on 16 queries
    and the 128 -> 128 grid projection on 3 x 16 x 4 rows a view."""
    from portbench import window
    from portbench.reference import build

    conf = prun.Cell("syn_pose3d.train_b32", SPEC).config
    mc = json.loads(json.dumps(conf["model"]["init_args"]["model_cfg"]))
    mc["image_size"] = [64, 64]
    B, V, HW, nh = 2, 4, 16 * 16, 4
    with torch.device("meta"):
        ref = build.build_reference(conf["task"], mc).eval()
        saved, hooks = window.lazy_savings(ref)
        with torch.no_grad():
            build.forward(conf["task"], ref, torch.empty(B, V, 3, 64, 64))
    for h in hooks:
        h.remove()
    refiners = 4 * (V * B * (HW - 15) * 256 * 256 + B * V * (HW - 15 * nh) * 128 * 256)
    lifter = 3 * V * B * (HW - 16) * 128 * 128 + B * V * (HW - 3 * 16 * nh) * 128 * 128
    assert saved() == 2 * (refiners + lifter)
