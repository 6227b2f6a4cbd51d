"""A port-only CLI chain on the CPU (``python -m egorear_tpu_torch.run`` as
``main(argv)``): stage-1 ``fit`` of both stereo pairs from the seeded
"ImageNet" weights, stage-2 ``fit`` grafted from both, stage-3 ``fit``
grafted from stage 2, then ``test`` and ``predict`` on the stage-3
checkpoint, with their JSON on stdout. One train step a stage on a
one-frame tree (64-px JPEGs, the models at the datasets' 256 px); the
parts are held to JAX in ``tests/test_torch_port_cli.py``.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from egorear_tpu_torch import run
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")


def _yaml(name: str) -> str:
    return os.path.join(CONFIGS, f"{name}.yaml")


def _data(root: str, save_dir, batch: int, *extra) -> list:
    return ["--model.data_root", root, "--model.batch_size", str(batch),
            "--model.workers", "2", "--trainer.save_dir", str(save_dir), *extra]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_cli_chain_on_cpu(tmp_path, capsys):
    """Stage 1 (front, back) -> 2 -> 3 ``fit`` through the CLI, then ``test``
    and ``predict`` on the stage-3 checkpoint; one step a stage, b1 from
    stage 2 on."""
    root = make_synthetic_dataset(str(tmp_path / "data"), frames_per_seq=1,
                                  eval_frames_per_seq=1, image_size=64,
                                  write_heatmaps=True, draw_pose=True, seed=3)
    weights = str(tmp_path / "resnet18-seeded.pth")
    chip_smoke.write_imagenet_weights(weights)
    with chip_smoke.env_var(chip_smoke.IMAGENET_ENV, weights):
        _chain(root, tmp_path, capsys)


def _chain(root, tmp_path, capsys):
    def fit(name, *extra):
        # Stage 1 validates; stages 2 and 3 do not (their evaluation is
        # held to JAX in test_torch_port_cli.py, and this chain tests and
        # predicts).
        batch, val_every = (2, 1) if "stereo" in name else (1, 2)
        trainer = run.main(["fit", "--config", _yaml(name), "--device", "cpu",
                            "--trainer.max_epochs", "1",
                            "--trainer.check_val_every_n_epoch", str(val_every)]
                           + _data(root, tmp_path / name, batch, *extra))
        assert trainer.step == 1
        with open(trainer.logger.path) as f:
            reader = csv.DictReader(f)
            fields, rows = reader.fieldnames, list(reader)
        losses = [float(r[k]) for r in rows for k in fields
                  if k.startswith("train/") and "loss" in k and r[k]]
        assert losses and all(np.isfinite(losses)), losses
        assert any(k.startswith("val/") for k in fields) == ("stereo" in name)
        path = os.path.join(trainer.logger.dir, "checkpoints", "epoch=0.pt")
        assert os.path.exists(path)
        return path

    front = fit("ego4view_syn_heatmap_stereo_front")
    back = fit("ego4view_syn_heatmap_stereo_back")
    stage2 = fit("ego4view_syn_heatmap_mvfex-n1_jqa",
                 "--model.heatmap_estimator_pretrained_stereo_front", front,
                 "--model.heatmap_estimator_pretrained_stereo_back", back)
    thin = ["--model.model_cfg.pose3d_cfg.num_former_layers", "1"]
    stage3 = fit("ego4view_syn_pose3d", "--model.heatmap_estimator_mvf_pretrained",
                 stage2, *thin)
    eval_args = ["--config", _yaml("ego4view_syn_pose3d"), "--device", "cpu",
                 "--ckpt_path", stage3] + _data(root, tmp_path / "eval", 1, *thin)
    capsys.readouterr()
    metrics = run.main(["test"] + eval_args)
    assert json.loads(capsys.readouterr().out) == {
        k: round(float(v), 6) for k, v in metrics.items()}
    assert sorted(metrics) == sorted(
        f"test/{s}_{m}" for s in ("final", "proposal")
        for m in ("mpjpe", "pa_mpjpe", "pck_3d", "auc_3d"))
    assert all(np.isfinite(list(metrics.values())))
    path = run.main(["predict"] + eval_args)
    assert json.loads(capsys.readouterr().out) == {"predictions": path}
    pred = np.load(path, allow_pickle=True)
    assert pred["final"].shape == (1, 16, 3) and np.isfinite(pred["final"]).all()
