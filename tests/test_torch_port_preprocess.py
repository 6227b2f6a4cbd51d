"""The port's on-device preprocessing (``data/preprocess.py``, the uint8
``device_preprocess`` items, ``tasks.prepare_batch``) and its offline
heatmap precompute held against the JAX package on the CPU, on inputs made
from a seed with numpy:

  * ``pil_bicubic_matrix``: bitwise JAX's; the identity at the same size;
  * ``resize_bicubic_device``: within 1 LSB of JAX's with at most
    ``FLIP_SHARE`` of the values off by one (on the CPU: bitwise), and
    within 1 LSB of PIL (PIL rounds to 8 bits between its two passes);
  * ``preprocess_images_device``: its shape, within ``IMG_TOL`` (one LSB
    after normalisation) of JAX's and of the host pipeline; the caller's
    matmul precision (TF32, bf16) changes nothing and is restored;
  * ``preprocess_batch_device``'s targets within ``HM_TOL`` of JAX's, with
    and without Head;
  * ``prepare_batch``: the keys and values of JAX's; a host batch passes
    through, a batch's own ``gt_heatmap`` is kept;
  * the datasets' ``device_preprocess`` items bitwise JAX's (syn MVF, syn
    pose3d, rw pose3d with its ``coord_trans_mat``), also from the cache;
    stage 1 ignores the flag, as JAX's does;
  * ``MVFexTask.loss`` and ``Pose3DTask.loss`` on a uint8 batch (872-px
    views, the 256-px model) against JAX's, within the stage tests' loss
    tolerance;
  * ``python -m egorear_tpu_torch.generate_heatmap`` bitwise the root
    tool's NPYs; the CLI's ``dataset_kwargs`` overrides in both spellings;
    one ``--device cpu`` ``fit`` of stage 2 with ``device_preprocess``.
"""

from __future__ import annotations

import copy
import glob
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from egorear_tpu.data import preprocess as jpre
from egorear_tpu.data.datasets import get_dataset as jax_get_dataset
from egorear_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from egorear_tpu.ops.heatmap import render_gaussian_targets as jax_render
from egorear_tpu.train.tasks import MVFexTask as JaxMVFexTask
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu.train.tasks import prepare_batch as jax_prepare_batch
from egorear_tpu_torch import entry
from egorear_tpu_torch.config.loader import load_config
from egorear_tpu_torch.convert import load_flax
from egorear_tpu_torch.data import preprocess
from egorear_tpu_torch.data.datasets import get_dataset
from egorear_tpu_torch.train.tasks import MVFexTask, Pose3DTask, prepare_batch
from test_torch_port_models import random_variables
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FLIP_SHARE = 1e-3  # values one LSB off JAX's resize (measured on the CPU: 0)
IMG_TOL = (1.0 / 255.0) / float(jpre.IMAGENET_STD.min()) + 1e-4  # one LSB
HM_TOL = 1e-6
LOSS_RTOL = 1e-5  # tests/test_torch_port_stages.py, test_torch_port_train.py


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, size=(2, 872, 872, 3), dtype=np.uint8)


def _pil_resize(img: np.ndarray, size: int = 256) -> np.ndarray:
    return np.asarray(Image.fromarray(img).resize([size, size], Image.BICUBIC),
                      np.float32)


# -- filters and resize -----------------------------------------------------------


@pytest.mark.parametrize("in_size,out_size", [(872, 256), (256, 256), (64, 64)])
def test_pil_bicubic_matrix_bitwise(in_size, out_size):
    got = preprocess.pil_bicubic_matrix(in_size, out_size)
    want = jpre.pil_bicubic_matrix(in_size, out_size)
    assert got.dtype == np.float32 and got.shape == (out_size, in_size)
    np.testing.assert_array_equal(got, want)
    assert preprocess.pil_bicubic_matrix(in_size, out_size) is got  # cached


@pytest.mark.parametrize("size", [64, 256, 872])
def test_pil_bicubic_matrix_identity_at_same_size(size):
    np.testing.assert_array_equal(preprocess.pil_bicubic_matrix(size, size),
                                  np.eye(size, dtype=np.float32))


def test_resize_matches_jax_and_pil(images):
    got = preprocess.resize_bicubic_device(torch.from_numpy(images), 256)
    assert got.shape == (2, 256, 256, 3) and got.dtype == torch.float32
    got = got.numpy() * 255.0
    want = np.asarray(jpre.resize_bicubic_device(images, 256)) * 255.0
    off = np.abs(got - want)
    share = float((off > 0.5).mean())
    print(f"resize vs JAX: max {off.max():.3g} LSB, flipped share {share:.3g}")
    assert off.max() <= 1.0 + 1e-4 and share <= FLIP_SHARE
    for i in range(len(images)):
        assert np.abs(got[i] - _pil_resize(images[i])).max() <= 1.0 + 1e-4


def test_preprocess_images_matches_jax_and_host(images):
    u8 = images[None]  # (1, 2, 872, 872, 3)
    got = preprocess.preprocess_images_device(torch.from_numpy(u8), 256)
    assert got.shape == (1, 2, 3, 256, 256) and got.dtype == torch.float32
    assert got.is_contiguous()
    got = got.numpy()
    want = np.asarray(jpre.preprocess_images_device(u8, 256))
    print(f"normalised vs JAX: max {np.abs(got - want).max():.3g}, bitwise share "
          f"{float((got == want).mean()):.6f}")
    assert np.abs(got - want).max() <= IMG_TOL
    for i in range(len(images)):
        host = _pil_resize(images[i]) / 255.0
        host = ((host - jpre.IMAGENET_MEAN) / jpre.IMAGENET_STD).transpose(2, 0, 1)
        assert np.abs(got[0, i] - host).max() <= IMG_TOL


def test_precision_pinned_and_restored():
    """TF32 / bf16 matmuls set by the caller, by either API, neither change
    the resize nor survive it changed."""
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 255, size=(1, 2, 300, 300, 3),
                                       dtype=np.uint8))
    want = preprocess.preprocess_images_device(u8)
    cuda_mm = torch.backends.cuda.matmul

    def state():
        return (cuda_mm.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision)

    before, saved = torch.get_float32_matmul_precision(), state()
    try:
        for setting in ("high", "medium", "new-api tf32"):
            torch.set_float32_matmul_precision("highest")
            if setting == "new-api tf32":
                cuda_mm.fp32_precision = "tf32"
            else:
                torch.set_float32_matmul_precision(setting)
            was = state()
            got = preprocess.preprocess_images_device(u8)
            assert state() == was, setting
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    finally:
        torch.set_float32_matmul_precision(before)
        cuda_mm.fp32_precision, torch.backends.mkldnn.matmul.fp32_precision = saved


@pytest.mark.parametrize("drop_head", [True, False])
def test_preprocess_batch_targets_match_jax(images, drop_head):
    rng = np.random.default_rng(1)
    joints = rng.uniform(-100, 972, size=(1, 2, 16, 2)).astype(np.float32)
    small = images[None, :, :96, :96]  # the targets do not depend on them
    want = jpre.preprocess_batch_device(small, joints, drop_head=drop_head)
    got = preprocess.preprocess_batch_device(torch.from_numpy(np.ascontiguousarray(small)),
                                             torch.from_numpy(joints),
                                             drop_head=drop_head)
    assert sorted(got) == sorted(want)
    J = 15 if drop_head else 16
    assert got["gt_heatmap"].shape == (1, 2, J, 64, 64)
    assert got["img"].shape == (1, 2, 3, 256, 256)
    np.testing.assert_allclose(got["gt_heatmap"].numpy(), np.asarray(want["gt_heatmap"]),
                               rtol=0, atol=HM_TOL)
    full, _ = jax_render(joints)
    np.testing.assert_allclose(got["gt_heatmap"].numpy(),
                               np.asarray(full)[:, :, 16 - J:], rtol=0, atol=HM_TOL)
    np.testing.assert_allclose(got["img"].numpy(), np.asarray(want["img"]), rtol=0,
                               atol=IMG_TOL)


# -- prepare_batch ------------------------------------------------------------------


def _u8_batch(rng, B=2, V=4, size=96, pose=True):
    batch = {"img_u8": rng.integers(0, 255, size=(B, V, size, size, 3), dtype=np.uint8),
             "joints_2d": rng.uniform(-50, 900, size=(B, V, 16, 2)).astype(np.float32)}
    if pose:
        batch["gt_pose"] = rng.normal(size=(B, 16, 3)).astype(np.float32)
    return batch


def test_prepare_batch_matches_jax():
    batch = _u8_batch(np.random.default_rng(2))
    want = jax_prepare_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = prepare_batch({k: torch.from_numpy(v) for k, v in batch.items()})
    assert list(got) == list(want) == ["gt_pose", "img", "gt_heatmap"]
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0,
                                   atol=HM_TOL if k == "gt_heatmap" else IMG_TOL, err_msg=k)
    assert got["gt_heatmap"].shape == (2, 4, 15, 64, 64)


def test_prepare_batch_passes_host_batches_and_keeps_gt_heatmap():
    rng = np.random.default_rng(3)
    host = {"img": torch.zeros(2, 4, 3, 8, 8), "gt_heatmap": torch.ones(2, 4, 15, 2, 2)}
    assert prepare_batch(host) is host
    batch = {k: torch.from_numpy(v) for k, v in _u8_batch(rng, pose=False).items()}
    batch["gt_heatmap"] = torch.full((2, 4, 15, 64, 64), 7.0)
    got = prepare_batch(batch)
    assert sorted(got) == ["gt_heatmap", "img"]
    assert got["gt_heatmap"] is batch["gt_heatmap"]
    want = jax_prepare_batch({k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_array_equal(np.asarray(want["gt_heatmap"]), got["gt_heatmap"].numpy())


# -- datasets -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A syn and an rw tree from the JAX generator (64-px images), without
    heatmap NPYs: the device items never read them."""
    base = tmp_path_factory.mktemp("port_preprocess")
    syn = jax_make_synthetic(str(base / "syn"), "syn", num_chars=1, num_seqs=1,
                             frames_per_seq=3, image_size=64, write_heatmaps=False,
                             seed=4)
    rw = jax_make_synthetic(str(base / "rw"), "rw", num_chars=1, num_seqs=2,
                            frames_per_seq=2, image_size=64, write_heatmaps=False,
                            seed=5)
    return {"syn": syn, "rw": rw, "base": base}


def _assert_items_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("dataset_type,image_size", [
    ("ego4view_syn_heatmap_mvf", 64), ("ego4view_syn_pose3d", 96),
    ("ego4view_rw_pose3d", 64), ("ego4view_rw_heatmap_mvf", 96)])
def test_device_items_match_jax(trees, dataset_type, image_size):
    root = trees[dataset_type.split("_")[1]]
    kw = dict(device_preprocess=True, image_size=image_size)
    want = jax_get_dataset(dataset_type, root, "train", use_native_loader=False, **kw)
    got = get_dataset(dataset_type, root, "train", use_native_loader=False, **kw)
    cached = get_dataset(dataset_type, root, "train", cache_in_memory=True,
                         use_native_loader=False, **kw)
    assert len(got) == len(want) > 0
    keys = ["img_u8", "joints_2d"] + (["gt_pose"] if "pose3d" in dataset_type else [])
    for i in range(len(want)):
        w = want[i]
        assert list(w)[:len(keys)] == keys and w["img_u8"].dtype == np.uint8
        assert w["img_u8"].shape == (4, image_size, image_size, 3)
        assert ("coord_trans_mat" in w) == (dataset_type == "ego4view_rw_pose3d")
        _assert_items_equal(got[i], w)
        first = cached[i]
        _assert_items_equal(first, w)
        again = cached[i]
        assert again["img_u8"] is first["img_u8"] and not first["img_u8"].flags.writeable


def test_stage1_ignores_device_preprocess(trees):
    root = trees["syn"]
    kw = dict(device_preprocess=True, image_size=96, render_missing_heatmaps=True)
    want = jax_get_dataset("ego4view_syn_heatmap", root, "train",
                           use_native_loader=False, **kw)
    got = get_dataset("ego4view_syn_heatmap", root, "train", use_native_loader=False,
                      **kw)
    plain = get_dataset("ego4view_syn_heatmap", root, "train", image_size=96,
                        render_missing_heatmaps=True, use_native_loader=False)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert got[i]["img"].shape == (1, 3, 96, 96)  # float32 at image_size
        _assert_items_equal(got[i], want[i])
        _assert_items_equal(got[i], plain[i])


# -- the tasks on a uint8 batch ------------------------------------------------------


def _stage_cfg(name: str) -> dict:
    """Stage 2 / 3 at the 256 px that prepare_batch gives, thinned to one
    refiner layer and one lifting layer, without ImageNet."""
    if name == "mvfex":
        cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[256, 256]))
        cfg["mvf_cfg"]["num_former_layers"] = 1
        enc = cfg["encoder_cfg"]
    else:
        cfg = entry.flagship_cfg_dict((256, 256))
        cfg["heatmap_mvf_cfg"]["mvf_cfg"]["num_former_layers"] = 1
        cfg["pose3d_cfg"]["num_former_layers"] = 1
        enc = cfg["heatmap_mvf_cfg"]["encoder_cfg"]
    enc["resnet_cfg"]["use_imagenet_pretrain"] = False
    return cfg


@pytest.mark.parametrize("name", ["mvfex", "pose3d"])
def test_task_loss_on_u8_batch_matches_jax(name):
    rng = np.random.default_rng(6)
    cfg = _stage_cfg(name)
    batch = _u8_batch(rng, B=1, size=872, pose=name == "pose3d")
    if name == "mvfex":
        jtask = JaxMVFexTask(cfg)
        init = lambda: jtask.model.init(  # noqa: E731
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 3, 256, 256)), train=False)
        task_cls = MVFexTask
    else:
        jtask = JaxPose3DTask(cfg)
        init = lambda: jtask.model.init(  # noqa: E731
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 3, 256, 256)), jtask.rig, None,
            train=False)
        task_cls = Pose3DTask
    variables = random_variables(jax.eval_shape(init), rng, heatmap_bias=0.3)
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    want, (want_terms, _) = jax.jit(lambda p, ev, b: jtask.loss(p, ev, b, True))(
        params, extra, {k: jnp.asarray(v) for k, v in batch.items()})
    task = task_cls(cfg, device="cpu")
    load_flax(task.model, variables)
    task.model.train()
    with torch.no_grad():
        got, terms = task.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(terms) == sorted(want_terms)
    for k, w in want_terms.items():
        np.testing.assert_allclose(float(terms[k]), float(w), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# -- the offline precompute ------------------------------------------------------------


def _root_tool():
    spec = importlib.util.spec_from_file_location(
        "root_generate_heatmap", os.path.join(REPO, "generate_heatmap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["syn", "rw"])
def test_generate_heatmap_matches_root_tool(trees, variant):
    """The port's tool on one copy of a tree (in process, ``--device cpu``),
    the root tool's frame function on another: the same NPYs, bitwise."""
    from egorear_tpu_torch import generate_heatmap

    src = trees[variant]
    ours = str(trees["base"] / f"gen_{variant}_port")
    theirs = str(trees["base"] / f"gen_{variant}_root")
    for d in (ours, theirs):
        shutil.copytree(src, d)
    assert generate_heatmap.main(["--data_dir_path", ours, "--dataset_type", variant,
                                  "--device", "cpu"]) == 0
    seq_glob, json_dir = generate_heatmap.LAYOUTS[variant]
    tool = _root_tool()
    frames = sorted(glob.glob(os.path.join(theirs, seq_glob, json_dir, "*.json")))
    assert frames
    for fp in frames:
        tool.process_frame(fp, json_dir)
    want = sorted(glob.glob(os.path.join(theirs, "**", "fisheye_hm", "*", "*.npy"),
                            recursive=True))
    got = sorted(glob.glob(os.path.join(ours, "**", "fisheye_hm", "*", "*.npy"),
                           recursive=True))
    assert len(want) == 4 * len(frames)
    assert [os.path.relpath(p, ours) for p in got] == [os.path.relpath(p, theirs)
                                                        for p in want]
    for g, w in zip(got, want):
        a, b = np.load(g), np.load(w)
        assert a.shape == (16, 64, 64) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_generate_heatmap_module_runs(tmp_path):
    """``python -m egorear_tpu_torch.generate_heatmap --device cpu`` writes
    every camera's NPY of every split's frames; without the flag and
    without CUDA it raises."""
    from egorear_tpu_torch import generate_heatmap

    root = jax_make_synthetic(str(tmp_path / "syn"), "syn", num_chars=1, num_seqs=1,
                              frames_per_seq=1, image_size=32, write_heatmaps=False,
                              seed=6)
    argv = ["--data_dir_path", root, "--dataset_type", "syn"]
    proc = subprocess.run([sys.executable, "-m", "egorear_tpu_torch.generate_heatmap"]
                          + argv + ["--device", "cpu"], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    frames = glob.glob(os.path.join(root, "rp*", "*", "json_smplx_gendered", "*.json"))
    npys = glob.glob(os.path.join(root, "**", "fisheye_hm", "*", "*.npy"), recursive=True)
    assert len(frames) == 3 and len(npys) == 4 * len(frames)  # train, validation, test
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            generate_heatmap.main(argv)


# -- the CLI ------------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", ["--model.", "--model.init_args."])
def test_cli_dataset_kwargs_reach_the_datasets(trees, prefix):
    from egorear_tpu_torch import run

    kw = prefix + "dataset_kwargs."
    cfg = load_config(os.path.join(CONFIGS, "ego4view_syn_heatmap_mvfex-n1_jqa.yaml"),
                      ["--model.data_root", trees["syn"], kw + "device_preprocess", "true",
                       kw + "image_size", "872", kw + "cache_in_memory", "true"])
    assert cfg.init_args["dataset_kwargs"] == {
        "camera_pos": "all", "device_preprocess": True, "image_size": 872,
        "cache_in_memory": True}
    (ds,) = run._datasets(cfg.init_args, ("train",))
    assert ds.device_preprocess is True and ds.image_size == 872
    assert isinstance(ds.image_size, int) and ds._cache == {}


def test_cli_fit_stage2_device_preprocess_on_cpu(trees, tmp_path, monkeypatch):
    """``fit`` of the stage-2 yaml through ``run.main`` on the CPU with
    uint8 items at the files' size: the loss terms are finite, the
    checkpoint is written, and the batches the trainer saw were uint8."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.train import trainer as trainer_mod

    seen = []
    step = trainer_mod.Trainer.train_step

    def spy(self, batch):
        seen.append({k: (v.dtype, tuple(v.shape)) for k, v in batch.items()})
        return step(self, batch)

    monkeypatch.setattr(trainer_mod.Trainer, "train_step", spy)
    argv = ["fit", "--config", os.path.join(CONFIGS, "ego4view_syn_heatmap_mvfex-n1_jqa.yaml"),
            "--device", "cpu", "--model.data_root", trees["syn"],
            "--model.batch_size", "2", "--trainer.max_epochs", "1",
            "--trainer.save_dir", str(tmp_path / "logs"),
            "--model.model_cfg.mvf_cfg.num_former_layers", "1",
            "--model.model_cfg.encoder_cfg.resnet_cfg.use_imagenet_pretrain", "false",
            "--model.heatmap_estimator_pretrained_stereo_front", "null",
            "--model.heatmap_estimator_pretrained_stereo_back", "null",
            "--model.dataset_kwargs.device_preprocess", "true",
            "--model.dataset_kwargs.image_size", "64"]
    trainer = run.main(argv)
    assert seen and seen[0]["img_u8"] == (torch.uint8, (2, 4, 64, 64, 3))
    assert seen[0]["joints_2d"] == (torch.float32, (2, 4, 16, 2))
    (_, steps, _), = trainer.epoch_times
    assert steps == len(seen) == 1
    import csv

    with open(trainer.logger.path) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["train/loss_total"]) for r in rows if r.get("train/loss_total")]
    assert losses and all(np.isfinite(losses))
    assert any(v for k, v in rows[-1].items() if k.startswith("val/"))
    assert os.path.exists(os.path.join(trainer.logger.dir, "checkpoints", "epoch=0.pt"))
