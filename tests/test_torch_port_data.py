"""The port's data path held against the JAX package on the CPU, on inputs
made from a seed with numpy:

  * ``ops.heatmap.render_gaussian_targets`` and its numpy twin: bitwise,
    negative (truncated, not floored) and off-grid joints included;
  * every item of the six dataset types (``data/datasets.py``): bitwise
    ``img``, ``gt_heatmap``, ``gt_pose``, ``coord_trans_mat`` and
    ``frame_path``, with precomputed and with rendered heatmaps, on trees
    made by the JAX generator (both sides decode with PIL); the port's
    default decoder, the native loader, within one LSB of them;
  * the loader's batch-index sequence, ``__valid_n__`` and collation
    (``data/loader.py``) against the JAX loader's over 3 epochs;
  * the port's synthetic syn tree against the JAX generator's at one seed:
    the same files, images bitwise without ``draw_pose``, ``device_pts3d``
    exact, ``*_pts2d`` within 1e-3 px (the two frameworks' fp32
    projections), heatmap NPYs within 1e-6;
  * ``CameraRig.from_calib_file`` on the reference's directory of
    per-camera JSONs.
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from egorear_tpu.data.datasets import get_dataset as jax_get_dataset
from egorear_tpu.data.loader import DataLoader as JaxDataLoader
from egorear_tpu.data.synthetic import _draw_pose_image as jax_draw_pose_image
from egorear_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from egorear_tpu.ops.camera import CameraRig as JaxCameraRig
from egorear_tpu.ops.heatmap import render_gaussian_targets as jax_render
from egorear_tpu.ops.heatmap import render_gaussian_targets_np as jax_render_np
from egorear_tpu_torch import native
from egorear_tpu_torch.data.datasets import _DATASETS, get_dataset
from egorear_tpu_torch.data.loader import DataLoader
from egorear_tpu_torch.data.preprocess import IMAGENET_STD
from egorear_tpu_torch.data.synthetic import _draw_pose_image, make_synthetic_dataset
from egorear_tpu_torch.ops.camera import CameraRig, default_calib_path
from egorear_tpu_torch.ops.heatmap import (
    render_gaussian_targets,
    render_gaussian_targets_np,
)
from torch_threads import torch_threads  # noqa: F401

PTS2D_TOL = 1e-3  # px, the fp32 projections of the two frameworks
HM_NPY_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- heatmap targets --------------------------------------------------------------


@pytest.mark.parametrize("image_size,heatmap_size,sigma", [
    (872, 64, 1.0), (872, 64, 2.0), (256, 48, 1.5)])
def test_render_gaussian_targets_bitwise(image_size, heatmap_size, sigma):
    rng = np.random.default_rng(0)
    joints = rng.uniform(-150.0, image_size + 150.0, size=(6, 4, 16, 2)
                         ).astype(np.float32)
    stride = image_size / heatmap_size
    # Truncation toward zero vs floor, a stamp box just on and just off the
    # grid at each side, and a joint far away.
    joints[0, 0, :8] = np.array([
        [-0.6 * stride, 3.0], [-0.4 * stride, -0.4 * stride],
        [-(3.6 + 0.5) * stride, 10.0], [-(3.4 + 0.5) * stride, 10.0],
        [(heatmap_size + 2.4) * stride, 5.0], [(heatmap_size + 2.6) * stride, 5.0],
        [image_size - 0.01, image_size], [-1e4, 2e4]], np.float32)
    want_t, want_w = jax_render(joints, image_size=image_size,
                                heatmap_size=heatmap_size, sigma=sigma)
    got_t, got_w = render_gaussian_targets(torch.from_numpy(joints), image_size,
                                           heatmap_size, sigma)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert got_t.dtype == torch.float32 and got_w.dtype == torch.float32
    nt, nw = render_gaussian_targets_np(joints, image_size, heatmap_size, sigma)
    jt, jw = jax_render_np(joints, image_size, heatmap_size, sigma)
    np.testing.assert_array_equal(nt, jt)
    np.testing.assert_array_equal(nw, jw)
    # Off-grid joints: weight 0 and an all-zero map; some are on the grid.
    off = nw == 0
    assert off.any() and (~off).any()
    assert not nt[off].any()


# -- datasets ------------------------------------------------------------------------


def _drop_some_heatmaps(root: str) -> None:
    """Delete every other frame's heatmap NPYs: those frames' targets are
    rendered from their JSON."""
    for p in sorted(glob.glob(os.path.join(root, "**", "fisheye_hm", "*", "*.npy"),
                              recursive=True))[::2]:
        os.remove(p)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A syn tree (2 characters, for the first-line quirk) and an rw tree
    (2 sequences, one of whose metadata files has the hyphen-stripped name)
    from the JAX generator, half their heatmaps deleted."""
    base = tmp_path_factory.mktemp("port_data")
    syn = jax_make_synthetic(str(base / "syn"), "syn", num_chars=2, num_seqs=1,
                             frames_per_seq=3, image_size=64, write_heatmaps=True,
                             seed=1)
    rw = jax_make_synthetic(str(base / "rw"), "rw", num_chars=1, num_seqs=2,
                            frames_per_seq=2, image_size=64, write_heatmaps=True,
                            seed=2)
    seq_meta = sorted(glob.glob(os.path.join(rw, "*", "*", "seq1-*_metadata.json")))
    for p in seq_meta:
        d, name = os.path.split(p)
        os.rename(p, os.path.join(d, name.split("-")[0] + "_metadata.json"))
    assert seq_meta
    for root in (syn, rw):
        _drop_some_heatmaps(root)
    return {"syn": syn, "rw": rw}


def _assert_items_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("dataset_type", sorted(_DATASETS))
def test_every_item_matches_jax(trees, dataset_type):
    root = trees[dataset_type.split("_")[1]]
    for split in ("train", "test"):
        for camera_pos in (("front", "back", "all") if split == "train" else ("all",)):
            kw = dict(camera_pos=camera_pos, render_missing_heatmaps=True)
            want = jax_get_dataset(dataset_type, root, split,
                                   use_native_loader=False, **kw)
            got = get_dataset(dataset_type, root, split, use_native_loader=False, **kw)
            assert len(got) == len(want) > 0
            for i in range(len(want)):
                _assert_items_equal(got[i], want[i])
    if dataset_type == "ego4view_syn_heatmap":  # the reference's first-line quirk
        n_lines = len(open(os.path.join(root, "train.txt")).read().split())
        full = get_dataset(dataset_type, root, "train", all_split_lines=True)
        assert n_lines == 2 and len(full) == 2 * len(get_dataset(dataset_type, root, "train"))
    # Without rendering, a missing NPY raises in both.
    for getter, extra in ((jax_get_dataset, {"use_native_loader": False}),
                          (get_dataset, {})):
        ds = getter(dataset_type, root, "train", **extra)
        with pytest.raises(FileNotFoundError):
            for i in range(len(ds)):
                ds[i]


def test_cache_in_memory_and_refused_options(trees):
    root = trees["syn"]
    ds = get_dataset("ego4view_syn_pose3d", root, "train", cache_in_memory=True,
                     render_missing_heatmaps=True, use_native_loader=False)
    first = ds[1]
    again = ds[1]
    assert again is not first and again["img"] is first["img"]
    assert not first["img"].flags.writeable
    with pytest.raises(ValueError):
        first["img"] += 1.0
    want = jax_get_dataset("ego4view_syn_pose3d", root, "train",
                           use_native_loader=False, render_missing_heatmaps=True)[1]
    _assert_items_equal(again, want)
    # The default decoder is the native loader, as in the JAX package: the
    # same item but its images, which are the loader's, within one LSB of
    # PIL's after normalisation.
    item = get_dataset("ego4view_syn_pose3d", root, "train",
                       render_missing_heatmaps=True)[1]
    views = [ds._img_path(ds.frames[1], c) for c in ds.cameras]
    np.testing.assert_array_equal(item["img"], native.load_f32_batch(views))
    tol = (1.0 / 255.0) / float(IMAGENET_STD.min()) + 1e-6
    assert np.abs(item["img"] - want["img"]).max() <= tol
    _assert_items_equal({k: v for k, v in item.items() if k != "img"},
                        {k: v for k, v in want.items() if k != "img"})


# -- loader ----------------------------------------------------------------------


class _Indexed:
    """Samples that name their index: an array, a 0-d array and a string."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 3), i, np.float32), "i": np.array(i),
                "frame_path": f"f{i}"}


@pytest.mark.parametrize("n,batch,shuffle,drop_last,pad_last", [
    (11, 4, True, True, False),
    (11, 4, True, False, True),
    (11, 4, False, False, True),
    (10, 5, True, False, False),
    (3, 4, False, False, True),
])
def test_loader_sequence_matches_jax(n, batch, shuffle, drop_last, pad_last):
    ds = _Indexed(n)
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=3, seed=7,
              pad_last=pad_last)
    want_loader = JaxDataLoader(ds, batch, device_put=False, **kw)
    got_loader = DataLoader(ds, batch, **kw)
    assert len(got_loader) == len(want_loader)
    for epoch in range(3):
        want_loader.set_epoch(epoch)
        got_loader.set_epoch(epoch)
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) == len(want_loader)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k, wv in w.items():
                if isinstance(wv, np.ndarray):
                    assert torch.is_tensor(g[k]) and g[k].device.type == "cpu"
                    np.testing.assert_array_equal(g[k].numpy(), wv)
                else:
                    assert g[k] == wv, k
    if pad_last and n % batch:
        assert got[-1]["__valid_n__"] == n % batch


def test_loader_rows_survive_many_racing_workers():
    """More workers than cores fill each batch's rows at once (the first
    sample to arrive allocates the batch), with a short switch interval:
    every row and list entry is its own sample's, none lost or swapped."""
    import sys
    import threading

    class Jittered(_Indexed):
        def __getitem__(self, i):
            time.sleep(0.0005 * (i * 7 % 5))  # vary the arrival order
            return super().__getitem__(i)

    n, batch = 203, 16
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done = []
        worker = threading.Thread(target=lambda: done.append(list(DataLoader(
            Jittered(n), batch, shuffle=True, seed=3, num_workers=4 * os.cpu_count(),
            pad_last=True))))
        worker.start()
        worker.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not worker.is_alive() and len(done) == 1
    batches = done[0]
    order = np.arange(n)
    np.random.default_rng(3).shuffle(order)
    assert len(batches) == -(-n // batch)
    for b, start in zip(batches, range(0, n, batch)):
        idxs = order[start:start + batch]
        idxs = np.concatenate([idxs, np.repeat(idxs[-1:], batch - len(idxs))])
        assert b["i"].tolist() == idxs.tolist()
        np.testing.assert_array_equal(b["x"].numpy(), np.broadcast_to(
            idxs[:, None, None].astype(np.float32), (batch, 2, 3)))
        assert b["frame_path"] == [f"f{i}" for i in idxs]


def test_loader_batches_dataset_items(trees):
    ds = get_dataset("ego4view_syn_pose3d", trees["syn"], "train",
                     render_missing_heatmaps=True)
    batches = list(DataLoader(ds, 4, num_workers=2, pad_last=True, device="cpu"))
    assert len(ds) == 6 and [b["__valid_n__"] for b in batches] == [4, 2]
    last = batches[-1]
    for k in ("img", "gt_heatmap", "gt_pose"):
        for row, i in enumerate((4, 5, 5, 5)):  # padded with the last index
            np.testing.assert_array_equal(last[k][row].numpy(), ds[i][k])
    assert last["frame_path"] == [ds[i]["frame_path"] for i in (4, 5, 5, 5)]


# -- synthetic tree ------------------------------------------------------------


def _tree_files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**"), recursive=True))


@pytest.mark.parametrize("draw_pose", [False, True])
def test_synthetic_tree_matches_jax(tmp_path, draw_pose):
    kw = dict(num_chars=2, num_seqs=2, frames_per_seq=3, eval_frames_per_seq=2,
              image_size=48, write_heatmaps=True, draw_pose=draw_pose, seed=5,
              skeleton=draw_pose, occlusion=0.3 if draw_pose else 0.0)
    want_root = jax_make_synthetic(str(tmp_path / "jax"), "syn", **kw)
    got_root = make_synthetic_dataset(str(tmp_path / "port"), "syn", **kw)
    files = _tree_files(want_root)
    assert _tree_files(got_root) == files
    worst_2d = worst_hm = 0.0
    n = {"jpg": 0, "json": 0, "npy": 0}
    for rel in files:
        a, b = os.path.join(want_root, rel), os.path.join(got_root, rel)
        if os.path.isdir(a):
            continue
        ext = rel.rsplit(".", 1)[-1]
        if ext == "jpg":
            n[ext] += 1
            if not draw_pose:  # the same generator draws: the same bytes
                assert open(a, "rb").read() == open(b, "rb").read(), rel
        elif ext == "json":
            n[ext] += 1
            ja, jb = json.load(open(a)), json.load(open(b))
            assert list(ja["joints"]) == list(jb["joints"])
            for joint, entry in ja["joints"].items():
                assert list(entry) == list(jb["joints"][joint])
                for key, v in entry.items():
                    got = np.asarray(jb["joints"][joint][key])
                    if key == "device_pts3d":
                        np.testing.assert_array_equal(got, v)
                    else:
                        worst_2d = max(worst_2d, float(np.abs(got - v).max()))
        elif ext == "npy":
            n[ext] += 1
            wa, wb = np.load(a), np.load(b)
            assert wa.dtype == wb.dtype and wa.shape == wb.shape
            if rel.endswith("visibility.npy"):
                np.testing.assert_array_equal(wb, wa)
            else:
                worst_hm = max(worst_hm, float(np.abs(wb - wa).max()))
        else:
            assert open(a).read() == open(b).read(), rel
    assert worst_2d <= PTS2D_TOL and worst_hm <= HM_NPY_TOL, (worst_2d, worst_hm)
    assert n["jpg"] == 4 * n["json"] and n["json"] == 2 * 2 * (3 + 2 + 2)


def test_draw_pose_image_matches_jax():
    """The blobs, cut at 6 sigma, against JAX's full-frame sum: the uint8
    images within 1 level (a sum landing within rounding of a level)."""
    rng = np.random.default_rng(3)
    for size in (96, 872):
        pts = rng.uniform(-20.0, size + 20.0, size=(16, 2))
        visible = rng.random(16) > 0.2
        want = jax_draw_pose_image(pts, size, np.random.default_rng(size), visible)
        got = _draw_pose_image(pts, size, np.random.default_rng(size), visible)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and diff.mean() < 1e-3, (size, diff.max(), diff.mean())


# -- calibration directory -----------------------------------------------------------


def test_from_calib_file_reads_a_calibration_directory(tmp_path):
    rig = json.load(open(default_calib_path()))["cameras"]
    for i, (name, d) in enumerate(rig.items()):
        json.dump({"size": d["image_size_hw"],
                   "image_center": [c + 0.25 * i for c in d["center_xy"]],
                   "polynomialC2W": d["poly_cam2world"],
                   "polynomialW2C": d["poly_world2cam"][:6 + i % 3]},
                  open(tmp_path / f"{name}.json", "w"))
    for chained in (True, False):
        want = JaxCameraRig.from_calib_file("ego4view_syn", str(tmp_path),
                                            chained=chained)
        got = CameraRig.from_calib_file("ego4view_syn", str(tmp_path),
                                        chained=chained, device="cpu")
        for field in ("poly_w2c", "center", "image_size_hw", "sign", "offset",
                      "final_sign", "final_offset"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), err_msg=field)
    assert not torch.equal(got.center, CameraRig.from_calib_file(
        "ego4view_syn", chained=False, device="cpu").center)


def test_pose3d_task_resolves_the_calibration_as_jax(tmp_path):
    """Explicit ``camera_calib_path`` > the config's
    ``pose3d_cfg.camera_calib_file_dir_path`` if it exists > the bundled
    rig; ``chained_cameras`` as JAX's ``Pose3DTask``."""
    from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.train.tasks import Pose3DTask, resolve_calib_path

    rig = json.load(open(default_calib_path()))["cameras"]
    for name, d in rig.items():
        json.dump({"size": d["image_size_hw"],
                   "image_center": [c + 1.5 for c in d["center_xy"]],
                   "polynomialC2W": d["poly_cam2world"],
                   "polynomialW2C": d["poly_world2cam"]},
                  open(tmp_path / f"{name}.json", "w"))
    cfg = entry.flagship_cfg_dict((64, 64))
    missing = str(tmp_path / "missing")
    cfg["pose3d_cfg"]["camera_calib_file_dir_path"] = missing
    assert resolve_calib_path(cfg, None) is None
    assert resolve_calib_path(cfg, "given") == "given"
    cfg["pose3d_cfg"]["camera_calib_file_dir_path"] = str(tmp_path)
    assert resolve_calib_path(cfg, None) == str(tmp_path)
    for chained in (True, False):
        got = Pose3DTask(cfg, device="cpu", chained_cameras=chained,
                         pose_relative_type="device").rig
        want = JaxPose3DTask(cfg, chained_cameras=chained).rig
        for field in ("center", "offset", "final_offset"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
    assert float(got.center[0, 0]) == np.float32(
        rig["camera_front_left"]["center_xy"][0] + 1.5)  # the directory's
