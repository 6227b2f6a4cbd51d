"""The CLI's tensor-parallel launch on the CPU (``python -m
egorear_tpu_torch.run`` as ``main(argv)``): stage 3 on a one-frame
synthetic tree (64-px JPEGs, the model at the datasets' 256 px, one lifting
layer), ``--trainer.devices 2 --trainer.model_parallel 2
--trainer.tp_min_dim 256`` (two gloo ranks through ``parallel.dist.spawn``,
one model group, one torch thread each) against one process:

  * ``fit`` grafted from a seeded stage-2 checkpoint (each rank grafts the
    full tree and keeps its slices) at lr 0, as the JAX package's own
    tensor-parallel test trains (AdamW's first step is ~ lr * sign(g), so
    a gradient within rounding of 0 moves its element by 2 lr either way,
    in fp32 the sharded sums' order flips such signs, and the validation
    after the step then differs by ~3e-6), without its validation (the
    ``validate`` below runs it): rank 0 alone writes ``metrics.csv`` and
    ``epoch=0.pt``, its loss terms within TOL of the one process's;
  * ``validate`` and ``predict`` from the sharded run's checkpoint: the
    same metrics on both ranks and ``predictions.npz`` written by rank 0,
    within TOL of one process from the same checkpoint; ``validate`` again
    from that state written as an EgoRear ``.ckpt`` (imported whole, then
    sliced);
  * ``--trainer.devices 3 --trainer.model_parallel 2`` raises the JAX
    package's ``ValueError`` before any rank starts.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import csv
import glob
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from egorear_tpu_torch import entry, run
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.tasks import MVFexTask
from torch_threads import torch_threads  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
TOL = 1e-6
TP = ["--trainer.devices", "2", "--trainer.model_parallel", "2",
      "--trainer.tp_min_dim", "256"]


def _csv(path: str) -> list:
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_tensor_parallel_matches_one_process(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = make_synthetic_dataset(str(tmp_path / "data"), frames_per_seq=1,
                                  eval_frames_per_seq=1, image_size=64,
                                  write_heatmaps=True, draw_pose=True, seed=3)
    weights = str(tmp_path / "resnet18-seeded.pth")
    chip_smoke.write_imagenet_weights(weights)
    monkeypatch.setenv(chip_smoke.IMAGENET_ENV, weights)
    cfg = copy.deepcopy(entry.STAGE2_CFG)
    cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    stage2 = ckpt_lib.save(str(tmp_path / "stage2"), 11, {
        "model": MVFexTask(cfg, device="cpu", seed=5).model.state_dict()})
    common = ["--config", os.path.join(CONFIGS, "ego4view_syn_pose3d.yaml"),
              "--device", "cpu", "--model.data_root", root, "--model.batch_size", "1",
              "--model.workers", "1", "--model.model_cfg.pose3d_cfg.num_former_layers",
              "1"]

    def fit(name, *extra):
        return ["fit"] + common + ["--trainer.max_epochs", "1", "--trainer.save_dir",
                                   str(tmp_path / name),
                                   "--model.heatmap_estimator_mvf_pretrained", stage2,
                                   "--model.lr", "0",
                                   "--trainer.check_val_every_n_epoch", "2", *extra]

    try:
        with pytest.raises(ValueError, match="model_parallel=2 does not divide 3 devices"):
            run.main(fit("refused", "--trainer.devices", "3",
                         "--trainer.model_parallel", "2"))
        assert not os.path.exists(tmp_path / "refused")

        # Each sharded run beside its one-process counterpart, in a thread.
        with cf.ThreadPoolExecutor(2) as pool:
            tp_fit, one = pool.submit(run.main, fit("tp", *TP)), run.main(fit("one"))
            assert tp_fit.result() == [None, None]
            (version,) = glob.glob(str(tmp_path / "tp" / "lightning_logs" / "*"))
            ckpt = os.path.join(version, "checkpoints", "epoch=0.pt")
            want = _csv(os.path.join(one.logger.dir, "metrics.csv"))
            got = _csv(os.path.join(version, "metrics.csv"))
            assert [list(r) for r in got] == [list(r) for r in want]
            for g, w in zip(got, want):
                for k, v in w.items():
                    if v:
                        np.testing.assert_allclose(float(g[k]), float(v), rtol=TOL,
                                                   atol=TOL, err_msg=k)
            # ~1 GB each at 256 px (weights and both moments): the suite's
            # temporary directory is not large.
            shutil.rmtree(os.path.join(one.logger.dir, "checkpoints"))

            val = ["validate"] + common + ["--ckpt_path", ckpt]
            two, alone = pool.submit(run.main, val + TP), run.main(val)
            two = two.result()
            assert len(two) == 2 and two[0] == two[1]
            assert sorted(alone) == sorted(two[0]) and alone
            for k, v in alone.items():
                np.testing.assert_allclose(two[0][k], v, rtol=TOL, atol=TOL, err_msg=k)
            # The same state as an EgoRear .ckpt: imported whole, then sliced.
            egorear = chip_smoke.write_egorear_ckpt(
                str(tmp_path / "epoch=0.ckpt"), ckpt_lib.restore(ckpt)["model"],
                "pose_3d_mvf_ex")
            two = run.main(["validate"] + common + ["--ckpt_path", egorear] + TP)
            os.remove(egorear)
            for k, v in alone.items():
                np.testing.assert_allclose(two[0][k], v, rtol=TOL, atol=TOL, err_msg=k)

            def predict(name, *extra):
                return run.main(["predict"] + common + [
                    "--ckpt_path", ckpt, "--trainer.save_dir", str(tmp_path / name),
                    *extra])

            pred, pred_one = pool.submit(predict, "pred_tp", *TP), predict("pred_one")
            pred = pred.result()
        assert pred[1] is None and os.path.exists(pred[0])
        got, want = np.load(pred[0], allow_pickle=True), np.load(pred_one, allow_pickle=True)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            if want[k].dtype == object:
                assert list(got[k]) == list(want[k]), k
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                           err_msg=k)
    finally:
        torch.set_num_threads(n_threads)
