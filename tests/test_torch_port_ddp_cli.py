"""The CLI's data-parallel launch on the CPU (``python -m
egorear_tpu_torch.run`` as ``main(argv)``), stage 1 on a synthetic tree
(64-px JPEGs, the model at the datasets' 256 px), one torch thread a rank:

  * ``--trainer.devices 2`` starts two gloo ranks through
    ``parallel.dist.spawn`` and returns their results: ``fit`` writes one
    version directory (rank 0's), ``validate`` gives the same metrics on
    both ranks, within 1e-5 of the one process's, ``predict`` writes on
    rank 0 alone;
  * in ``torchrun``'s environment (here a one-rank group) this process is
    rank 0: its ``fit`` is bitwise the one-process ``fit``, and the group
    is gone after it.
"""

from __future__ import annotations

import glob
import os
import socket

import numpy as np
import torch

import chip_smoke
from egorear_tpu_torch import run
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
from egorear_tpu_torch.parallel import dist
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from torch_threads import torch_threads  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
EVAL_TOL = 1e-5


def test_cli_on_two_ranks_and_under_torchrun(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = make_synthetic_dataset(str(tmp_path / "data"), frames_per_seq=2,
                                  eval_frames_per_seq=1, image_size=64,
                                  write_heatmaps=True, draw_pose=True, seed=3)
    weights = str(tmp_path / "resnet18-seeded.pth")
    chip_smoke.write_imagenet_weights(weights)
    monkeypatch.setenv(chip_smoke.IMAGENET_ENV, weights)
    common = ["--config", os.path.join(CONFIGS, "ego4view_syn_heatmap_stereo_front.yaml"),
              "--device", "cpu", "--model.data_root", root, "--model.batch_size", "2",
              "--model.workers", "1"]

    def fit(name, devices):
        return ["fit"] + common + ["--trainer.max_epochs", "1", "--trainer.devices",
                                   str(devices), "--trainer.save_dir",
                                   str(tmp_path / name)]

    try:
        assert run.main(fit("two", 2)) == [None, None]
        (version,) = glob.glob(str(tmp_path / "two" / "lightning_logs" / "*"))
        assert os.path.exists(os.path.join(version, "metrics.csv"))
        ckpt = os.path.join(version, "checkpoints", "epoch=0.pt")
        assert ckpt_lib.restore(ckpt)["step"] >= 1

        val = ["validate"] + common + ["--ckpt_path", ckpt]
        two = run.main(val + ["--trainer.devices", "2"])
        assert len(two) == 2 and two[0] == two[1]
        one = run.main(val + ["--trainer.devices", "1"])
        assert sorted(one) == sorted(two[0])
        for k, v in one.items():
            np.testing.assert_allclose(two[0][k], v, rtol=EVAL_TOL, atol=EVAL_TOL,
                                       err_msg=k)
        pred = run.main(["predict"] + common + ["--ckpt_path", ckpt, "--trainer.devices",
                                                "2", "--trainer.save_dir",
                                                str(tmp_path / "pred")])
        assert pred[1] is None and os.path.exists(pred[0])

        trainer = run.main(fit("one", 1))
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                         MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
            monkeypatch.setenv(k, v)
        ranked = run.main(fit("torchrun", 1))
        assert not dist.is_initialized() and ranked.shard.collective
        assert ranked.step == trainer.step >= 1
        got, want = ranked.task.model.state_dict(), trainer.task.model.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    finally:
        torch.set_num_threads(n_threads)
