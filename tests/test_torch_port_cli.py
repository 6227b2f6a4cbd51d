"""The port's CLI path (``python -m egorear_tpu_torch.run``) held against the
JAX package's ``run.py`` on the CPU:

  * ``config.loader.load_config`` on all 12 shipped yamls: the task, the
    model's ``init_args`` and the trainer settings JAX reads; overrides and
    ``cli_keys``; the ``encoder_lr_scale`` precedence;
  * ``run.build_task`` over the 12 yamls: every one builds (``NOT_PORTED``
    is empty since the V = 2 and real-world rigs were ported);
  * stage-1 ``fit`` (2 epochs, b4, ``log_every_n_steps 1``) from the JAX
    trainer's initial weights (grafted through ``network_pretrained``):
    every ``metrics.csv`` row within 1e-4 relative of JAX ``Trainer.fit``'s,
    the epoch-1 checkpoint within Adam's step bound;
  * stage-3 ``test`` / ``validate`` on a padded last batch within 1e-4
    relative of JAX ``Trainer.evaluate``, and ``predict``'s
    ``predictions.npz`` and OBJ meshes against JAX's, on the same weights;
  * ``auto_resume``, ``debug_nans``, the ``CSVLogger`` file, the refused
    import of an EgoRear ``.ckpt`` of another task and the refused run
    without CUDA.

The port-only chain (stage 1 -> 2 -> 3 ``fit``, ``test``, ``predict``) is
``tests/test_torch_port_cli_chain.py``.

The trees hold 64-px JPEGs; the models run at the datasets' 256 px, which
the 64 x 64 ground-truth heatmaps fix. "ImageNet" weights are a seeded
random ResNet-18 in torchvision's layout (``chip_smoke.write_imagenet_weights``)
named by ``EGOREAR_IMAGENET_RESNET18``; both frameworks graft them.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from egorear_tpu.config.loader import load_config as jax_load_config
from egorear_tpu.data.datasets import get_dataset as jax_get_dataset
from egorear_tpu.train.tasks import TASKS as JAX_TASKS
from egorear_tpu.train.trainer import CSVLogger as JaxCSVLogger
from egorear_tpu.train.torch_convert import (
    convert_lightning_ckpt as jax_convert_lightning_ckpt,
)
from egorear_tpu.train.trainer import Trainer as JaxTrainer
from egorear_tpu.utils.skeleton import export_pose_obj as jax_export_pose_obj
import chip_smoke
from egorear_tpu_torch import entry, run
from egorear_tpu_torch.config.loader import load_config
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
from egorear_tpu_torch.train import checkpoint
from egorear_tpu_torch.train.tasks import HeatmapTask
from egorear_tpu_torch.train.trainer import CSVLogger, Trainer, TrainerConfig
from test_torch_port_models import random_variables
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
CONFIGS = os.path.join(REPO, "configs")
YAMLS = sorted(n[:-5] for n in os.listdir(CONFIGS) if n.endswith(".yaml"))
# Yamls that the port refuses to build: none since the V = 2 stereo rigs and
# the real-world rig were ported.
NOT_PORTED: set = set()
METRIC_RTOL = 1e-4
POSE_ATOL = 1e-4  # cm
STAGE1 = "ego4view_syn_heatmap_stereo_front"


def _yaml(name: str) -> str:
    return os.path.join(CONFIGS, f"{name}.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    """Seeded "ImageNet" weights named by the environment for this file."""
    path = str(tmp_path_factory.mktemp("imagenet") / "resnet18-seeded.pth")
    chip_smoke.write_imagenet_weights(path)
    with chip_smoke.env_var(chip_smoke.IMAGENET_ENV, path):
        yield path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 train frames (8 stage-1 items: 2 steps at b4), 1 validation and 1
    test frame (a padded batch at b2 and b4)."""
    root = str(tmp_path_factory.mktemp("cli_tree"))
    return make_synthetic_dataset(root, frames_per_seq=4, eval_frames_per_seq=1,
                                  image_size=64, write_heatmaps=True,
                                  draw_pose=True, seed=11)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """1 train frame (one step a stage: 2 stage-1 items at b2, 1 frame at
    b1) and 1 validation and 1 test frame."""
    root = str(tmp_path_factory.mktemp("cli_small_tree"))
    return make_synthetic_dataset(root, frames_per_seq=1, eval_frames_per_seq=1,
                                  image_size=64, write_heatmaps=True,
                                  draw_pose=True, seed=3)


def _data(root: str, save_dir, batch: int, *extra) -> list:
    return ["--model.data_root", root, "--model.batch_size", str(batch),
            "--model.workers", "2", "--trainer.save_dir", str(save_dir),
            "--model.dataset_kwargs.use_native_loader", "false", *extra]


# -- configs ---------------------------------------------------------------------


def _jax_trainer_fields(cfg) -> dict:
    return dict(vars(cfg.trainer))


@pytest.mark.parametrize("name", YAMLS)
def test_load_config_matches_jax(name):
    want = jax_load_config(_yaml(name))
    got = load_config(_yaml(name))
    assert got.task_name == want.task_name and got.seed == want.seed == 42
    assert got.init_args == want.init_args
    assert vars(got.trainer) == _jax_trainer_fields(want)
    assert got.cli_keys == want.cli_keys == frozenset()
    assert got.trainer.save_dir == f"./logs/{name}"
    assert got.model_cfg == want.model_cfg


def test_overrides_cli_keys_and_refusals():
    ov = ["--model.batch_size", "1", "--trainer.max_epochs=2",
          "--model.encoder_lr_scale", "0.5", "--trainer.debug_nans", "true",
          "--trainer.profile_steps", "3", "--model.dataset_kwargs.image_size", "64",
          "--trainer.callbacks", "[{class_path: ModelCheckpoint, init_args: {every_n_epochs: 3}}]",
          "--ckpt_path", "some/dir"]
    want = jax_load_config(_yaml("ego4view_syn_pose3d"), ov)
    got = load_config(_yaml("ego4view_syn_pose3d"), ov)
    assert got.cli_keys == want.cli_keys
    assert "model.init_args.encoder_lr_scale" in got.cli_keys
    assert got.init_args == want.init_args and got.init_args["batch_size"] == 1
    assert vars(got.trainer) == _jax_trainer_fields(want)
    assert got.trainer.ckpt_every_n_epochs == 3 and got.trainer.debug_nans is True
    # encoder_lr_scale: CLI model value > yaml model value != 1 > trainer value.
    for ov2, scale in ((["--trainer.encoder_lr_scale", "0.3"], 0.3),
                       (["--trainer.encoder_lr_scale", "0.3",
                         "--model.encoder_lr_scale", "1.0"], 1.0)):
        cfg = load_config(_yaml("ego4view_syn_pose3d"), ov2)
        run._apply_encoder_lr(cfg, dict(cfg.init_args))
        assert cfg.trainer.encoder_lr_scale == scale
    # The tensor-parallel keys, coerced as the JAX package's loader does: a
    # quoted number is taken as the int, anything else is refused.
    for ov2 in (["--trainer.tp_min_dim", "4", "--trainer.tp_shard_stacked", "false"],
                ["--trainer.tp_min_dim", '"2048"', "--trainer.tp_shard_stacked", "on"]):
        got = load_config(_yaml(STAGE1), ov2)
        assert vars(got.trainer) == vars(jax_load_config(_yaml(STAGE1), ov2).trainer)
        assert type(got.trainer.tp_min_dim) is int
    assert got.trainer.tp_min_dim == 2048 and got.trainer.tp_shard_stacked is True
    for bad in (["--trainer.tp_min_dim", "lots"], ["--trainer.tp_shard_stacked", "maybe"]):
        with pytest.raises(ValueError) as want:
            jax_load_config(_yaml(STAGE1), bad)
        with pytest.raises(ValueError, match="expects (int|bool)") as e:
            load_config(_yaml(STAGE1), bad)
        assert str(e.value) == str(want.value)
    # Data parallelism, remat and the model axis are ported.
    taken = load_config(_yaml(STAGE1), ["--trainer.remat", "true",
                                        "--trainer.devices", "2"])
    assert taken.trainer.remat is True and taken.trainer.devices == 2
    ov2 = ["--trainer.model_parallel", "2", "--trainer.devices", "4"]
    taken = load_config(_yaml(STAGE1), ov2)
    assert taken.trainer.model_parallel == 2
    assert vars(taken.trainer) == vars(jax_load_config(_yaml(STAGE1), ov2).trainer)
    with pytest.raises(ValueError):
        load_config(_yaml(STAGE1), ["--trainer.precision", "16-mixed"])
    with pytest.raises(ValueError):
        load_config(_yaml(STAGE1), ["--trainer.debug_nans", "maybe"])


@pytest.mark.parametrize("name", YAMLS)
def test_build_task_builds_or_refuses(imagenet, name):
    cfg = load_config(_yaml(name))
    if name in NOT_PORTED:
        with pytest.raises(NotImplementedError):
            run.build_task(cfg, "cpu")
        return
    task, args = run.build_task(cfg, "cpu")
    assert task.name == cfg.task_name
    trainer = run.build_trainer(cfg, task, args)
    assert trainer.batch_size == args["batch_size"] and trainer.cfg is cfg.trainer
    assert trainer.no_decay_mask == (task.name == "pose_3d_mvf_ex")
    assert next(task.model.parameters()).device.type == "cpu"


# -- the JAX side -------------------------------------------------------------------


def _jax_build(cfg):
    """JAX ``run.py``'s ``build_task`` and ``build_trainer``."""
    args = dict(cfg.init_args)
    task = JAX_TASKS[cfg.task_name](
        model_cfg=args.get("model_cfg", {}), w_heatmap=args.get("w_heatmap", 10.0),
        w_mpjpe=args.get("w_mpjpe", 0.1), dataset_type=args.get("dataset_type", ""),
        camera_calib_path=args.get("camera_calib_path"))
    trainer = JaxTrainer(
        task, cfg.trainer, lr=args.get("lr", 1e-3),
        weight_decay=args.get("weight_decay", 5e-4),
        lr_decay_epochs=args.get("lr_decay_epochs", (8, 10)),
        warmup_iters=args.get("warmup_iters", 500),
        batch_size=args.get("batch_size", 32), workers=args.get("workers", 8),
        no_decay_mask=(cfg.task_name == "pose_3d_mvf_ex"
                       and cfg.trainer.encoder_lr_scale == 1.0))
    return task, trainer, args


def _jax_datasets(args, splits):
    kw = dict(args.get("dataset_kwargs", {}) or {})
    return [jax_get_dataset(args["dataset_type"], args["data_root"], s, **kw)
            for s in splits]


def _jax_init(trainer, ds, steps):
    probe = ds[0]
    sample = {k: np.asarray(v)[None].repeat(trainer.batch_size, 0)
              for k, v in probe.items() if isinstance(v, np.ndarray)}
    trainer.init_state(sample, steps)


def _jax_variables(trainer) -> dict:
    state = jax.device_get(trainer.state)
    return {"params": state["params"], **state["extra_vars"]}


def _save_weights(path_dir, variables) -> str:
    """The port checkpoint of ``variables`` (model state only)."""
    return checkpoint.save(str(path_dir), 0, {"model": from_flax(variables),
                                              "optimizer": {}, "step": 0})


def _rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


# -- stage-1 fit -----------------------------------------------------------------


def test_stage1_fit_matches_jax_trainer(imagenet, tree, tmp_path):
    ov = _data(tree, tmp_path / "jax", 4, "--trainer.max_epochs", "2",
               "--trainer.log_every_n_steps", "1")
    jcfg = jax_load_config(_yaml(STAGE1), ov)
    _, jtrainer, jargs = _jax_build(jcfg)
    train_ds, val_ds = _jax_datasets(jargs, ("train", "validation"))
    steps = len(train_ds) // jtrainer.batch_size
    assert steps == 2 and len(val_ds) == 2
    _jax_init(jtrainer, train_ds, steps)
    start = _save_weights(tmp_path / "start", _jax_variables(jtrainer))
    jtrainer.fit(train_ds, val_ds)

    trainer = run.main(["fit", "--config", _yaml(STAGE1), "--device", "cpu",
                        "--model.network_pretrained", start]
                       + _data(tree, tmp_path / "port", 4, "--trainer.max_epochs",
                               "2", "--trainer.log_every_n_steps", "1"))
    want_fields, want = _rows(jtrainer.logger.path)
    got_fields, got = _rows(trainer.logger.path)
    assert got_fields == want_fields and len(got) == len(want) == 2 * (2 + 1 + 1)
    assert "val/proposal_mse_pts2d" in got_fields and "train/lr" in got_fields
    worst = 0.0
    for g, w in zip(got, want):
        assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
        for k in want_fields[2:]:
            assert (g[k] == "") == (w[k] == ""), k
            if w[k]:
                a, b = float(g[k]), float(w[k])
                worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
                assert abs(a - b) <= METRIC_RTOL * abs(b) + 1e-12, (k, a, b)
    print(f"stage-1 fit: worst metrics.csv relative difference {worst:.2e}")

    # The epoch-1 checkpoint: 4 AdamW steps from the same start, each
    # element within Adam's step bound (1.5 lr per step each way).
    ckpt = checkpoint.restore(os.path.join(trainer.logger.dir, "checkpoints",
                                           "epoch=1"))
    assert ckpt["epoch"] == 1 and ckpt["step"] == 4
    lrs = [float(r["train/lr"]) for r in got if r["train/lr"]][:4]
    want_sd = from_flax(_jax_variables(jtrainer))
    bound = 2 * 1.5 * sum(lrs)
    for k, w in want_sd.items():
        g = ckpt["model"][k]
        if "running" in k:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        elif "num_batches" not in k:
            diff = (g - w).abs() - 2.4e-7 * w.abs()
            assert float(diff.max()) <= bound, k
    assert os.path.exists(os.path.join(trainer.logger.dir, "checkpoints", "epoch=0.pt"))


# -- stage-3 test, validate, predict ---------------------------------------------------


def _obj_vertices(path):
    with open(path) as f:
        return np.array([[float(x) for x in ln.split()[1:]] for ln in f
                         if ln.startswith("v ")])


def test_stage3_eval_and_predict_match_jax(imagenet, tree, tmp_path):
    ov = _data(tree, tmp_path / "jax", 2, "--model.save_result", "true",
               "--model.model_cfg.pose3d_cfg.num_former_layers", "1")
    jcfg = jax_load_config(_yaml("ego4view_syn_pose3d"), ov)
    jtask, jtrainer, jargs = _jax_build(jcfg)
    test_ds, val_ds = _jax_datasets(jargs, ("test", "validation"))
    assert len(test_ds) == len(val_ds) == 1  # a padded batch at b2
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), np.zeros((2, 4, 3, 256, 256), np.float32),
        jtask.rig, train=False))
    v = random_variables(shapes, np.random.default_rng(5), heatmap_bias=0.3)
    # The evaluation state without init_state's jitted init: the loops read
    # the parameters and BN stats only.
    jtrainer.state = {"params": v["params"],
                      "extra_vars": {"batch_stats": v["batch_stats"]}}
    jtrainer._build_steps()
    ckpt = _save_weights(tmp_path / "weights", v)

    port_ov = ["--config", _yaml("ego4view_syn_pose3d"), "--device", "cpu",
               "--ckpt_path", ckpt] + _data(
        tree, tmp_path / "port", 2, "--model.save_result", "true",
        "--model.model_cfg.pose3d_cfg.num_former_layers", "1")
    for sub, mode, ds in (("test", "test", test_ds), ("validate", "val", val_ds)):
        # The stage-3 metrics do not depend on test mode: one JAX compile.
        want = {k.replace("test/", f"{mode}/"): v
                for k, v in jtrainer.evaluate(ds, mode="test").items()}
        got = run.main([sub] + port_ov)
        assert list(got) == list(want)
        assert f"{mode}/final_mpjpe" in got and f"{mode}/proposal_auc_3d" in got
        for k, w in want.items():
            assert abs(got[k] - w) <= METRIC_RTOL * abs(w) + 1e-6, (k, got[k], w)

    want_path = jtrainer.predict(test_ds, str(tmp_path / "jax_pred"), save_obj=True)
    got_path = run.main(["predict"] + port_ov)
    assert got_path == os.path.join(str(tmp_path / "port"), "predictions",
                                    "predictions.npz")
    want, got = (np.load(p, allow_pickle=True) for p in (want_path, got_path))
    assert sorted(got.files) == sorted(want.files) == ["final", "frame_path", "proposal"]
    assert list(got["frame_path"]) == list(want["frame_path"])
    for k in ("final", "proposal"):
        assert got[k].shape == want[k].shape == (1, 16, 3)
        np.testing.assert_allclose(got[k], want[k], atol=POSE_ATOL, rtol=0, err_msg=k)
    objs = sorted(glob.glob(os.path.join(os.path.dirname(got_path), "pose_*.obj")))
    assert len(objs) == 1
    for i, p in enumerate(objs):
        ref = str(tmp_path / f"jax_{i}.obj")
        jax_export_pose_obj(ref, got["final"][i])
        assert open(p).read() == open(ref).read()
        np.testing.assert_allclose(
            _obj_vertices(p), _obj_vertices(os.path.join(
                os.path.dirname(want_path), os.path.basename(p))),
            atol=POSE_ATOL + 1e-6, rtol=0)


# -- resume, non-finite guard, logger, refusals ----------------------------------


def _stage1_fit(tree, save_dir, *extra):
    return run.main(["fit", "--config", _yaml(STAGE1), "--device", "cpu"]
                    + _data(tree, save_dir, 2, *extra))


def test_auto_resume_equals_straight_run(imagenet, small_tree, tmp_path):
    once = ["--trainer.check_val_every_n_epoch", "2"]  # one validation, at the end
    straight = _stage1_fit(small_tree, tmp_path / "a", "--trainer.max_epochs", "2", *once)
    _stage1_fit(small_tree, tmp_path / "b", "--trainer.max_epochs", "1", *once)
    resumed = _stage1_fit(small_tree, tmp_path / "b", "--trainer.max_epochs", "2",
                          "--trainer.auto_resume", "true", *once)
    assert resumed.logger.dir.endswith("version_1") and resumed.step == 2
    assert straight.step == 2 and len(straight.epoch_times) == 2
    assert [e for e, _, _ in resumed.epoch_times] == [1]
    a, b = (checkpoint.restore(os.path.join(t.logger.dir, "checkpoints", "epoch=1"))
            for t in (straight, resumed))
    assert a["step"] == b["step"] == 2
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    for i, s in a["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(b["optimizer"]["state"][i][k], v), (i, k)


def test_debug_nans_saves_state_and_raises(imagenet, tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "data"), frames_per_seq=1,
                                  eval_frames_per_seq=1, image_size=32,
                                  write_heatmaps=True, seed=2)
    for p in glob.glob(os.path.join(root, "**", "fisheye_hm", "*", "*.npy"),
                       recursive=True):
        np.save(p, np.full((16, 64, 64), np.nan, np.float32))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 1"):
        run.main(["fit", "--config", _yaml(STAGE1), "--device", "cpu",
                  "--trainer.debug_nans", "true"]
                 + _data(root, tmp_path / "logs", 2))
    saved = glob.glob(str(tmp_path / "logs" / "lightning_logs" / "version_0"
                          / "checkpoints-nan" / "epoch=0.pt"))
    assert len(saved) == 1 and checkpoint.restore(saved[0])["step"] == 1


def test_csv_logger_file_matches_jax(tmp_path):
    rows = [({"train/a": 1.5, "train/lr": np.float32(1e-3)}, 1, 0),
            ({"train/a": 2.25, "train/lr": 2e-3}, 2, 0),
            ({"val/m": 0.125}, 2, 0),  # a new column: the file is rewritten
            ({"train/a": np.float32(3.0), "train/lr": 3e-3}, 3, 1)]
    got, want = CSVLogger(str(tmp_path / "port")), JaxCSVLogger(str(tmp_path / "jax"))
    for metrics, step, epoch in rows:
        got.log(metrics, step, epoch)
        want.log(metrics, step, epoch)
        assert open(got.path, "rb").read() == open(want.path, "rb").read()
    assert got.path.endswith(os.path.join("lightning_logs", "version_0", "metrics.csv"))
    assert CSVLogger(str(tmp_path / "port")).dir.endswith("version_1")


def test_ckpt_import_and_cuda_refused(tmp_path, monkeypatch):
    cfg = dict(entry.STAGE1_CFG)
    cfg = {**cfg, "encoder_cfg": {**cfg["encoder_cfg"], "resnet_cfg": {
        **cfg["encoder_cfg"]["resnet_cfg"], "use_imagenet_pretrain": False}}}
    task = HeatmapTask(cfg, device="cpu")
    # An EgoRear .ckpt whose head has 14 joints, not 15: refused by both
    # packages' strict import, before any weight is loaded.
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    sd = dict(before, **{"conv_heatmap.weight": before["conv_heatmap.weight"][:14],
                         "conv_heatmap.bias": before["conv_heatmap.bias"][:14]})
    ckpt = chip_smoke.write_egorear_ckpt(str(tmp_path / "epoch=11.ckpt"), sd, "heatmap")
    jtask = JAX_TASKS["heatmap"](cfg)
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 3, 64, 64), np.float32), train=False))
    with pytest.raises(ValueError, match="shape mismatch /params/conv_heatmap/bias"):
        jax_convert_lightning_ckpt(ckpt, shapes, "heatmap")
    with pytest.raises(ValueError, match="shape mismatch conv_heatmap.bias"):
        run.load_eval_ckpt(task, types.SimpleNamespace(task_name="heatmap"), ckpt)
    assert all(torch.equal(v, before[k]) for k, v in task.model.state_dict().items())
    assert TrainerConfig(remat=True, devices=2).remat
    assert TrainerConfig(model_parallel=2).model_parallel == 2
    with pytest.raises(ValueError, match="model_parallel=2 does not divide 1 devices"):
        Trainer(task, 1e-3, 0.0, (), 1, config=TrainerConfig(model_parallel=2))
    if not torch.cuda.is_available():  # the module's own entry, as users run it
        out = subprocess.run(
            [sys.executable, "-m", "egorear_tpu_torch.run", "test", "--config",
             _yaml("ego4view_syn_pose3d")], cwd=REPO, capture_output=True,
            text=True, timeout=300)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main(["test", "--config", _yaml("ego4view_syn_pose3d")])
