"""Ego4View dataset indexers, host side (the JAX package's
``data/datasets.py``).

Path grammar (the reference's ``pose_estimation/datasets/``):
  * syn: ``<root>/<line of split.txt>/<seq>/json_smplx_gendered/*.json``,
    images ``fisheye_rgb/<camera>/<frame>.jpg``, ground-truth heatmaps
    ``fisheye_hm/<camera>/<frame>.npy``;
  * rw: ``<root>/<line>/json_smplx/*.json``, images ``.png``, and per
    sequence ``<seqdir>_metadata.json`` with the device-to-camera 4x4
    transforms (``coord_trans_mat``).

A sample is a dict of numpy arrays (and its ``frame_path``): images decoded
with PIL, BICUBIC-resized from 872 px and ImageNet-normalised to (V, 3, S,
S) float32; the 16-joint heatmap NPYs without Head (``[1:]``, 15 channels);
the 16-joint ``device_pts3d`` pose in cm. With ``render_missing_heatmaps``
a missing NPY is rendered from the frame JSON's 2D joints
(:func:`~egorear_tpu_torch.ops.heatmap.render_gaussian_targets_np`).
Batching and the transfer to the card are :mod:`egorear_tpu_torch.data.loader`'s.

Reference quirk kept: the syn single-view heatmap dataset reads only the
FIRST line of its split file (``lines[0:1]``) unless ``all_split_lines``.

Not ported: the native decoder (``use_native_loader=True``) and the uint8
samples of the on-device preprocessing (``device_preprocess=True``), both
of which raise (ROADMAP Queue A, host decode and ``img_u8`` device
preprocessing).
"""

from __future__ import annotations

import glob
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from egorear_tpu_torch.ops.heatmap import render_gaussian_targets_np

CAMERA_NAMES = (
    "camera_front_left",
    "camera_front_right",
    "camera_back_left",
    "camera_back_right",
)

JOINT_NAMES = (
    "Head", "Neck", "LeftArm", "RightArm", "LeftForeArm", "RightForeArm",
    "LeftHand", "RightHand", "LeftUpLeg", "RightUpLeg", "LeftLeg", "RightLeg",
    "LeftFoot", "RightFoot", "LeftToeBase", "RightToeBase",
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _cameras_for(camera_pos: str) -> Sequence[str]:
    if camera_pos == "front":
        return CAMERA_NAMES[:2]
    if camera_pos == "back":
        return CAMERA_NAMES[2:]
    return CAMERA_NAMES


def load_image(path: str, image_size: int = 256) -> np.ndarray:
    """Decode + BICUBIC resize + ImageNet-normalise -> (3, S, S) float32."""
    img = Image.open(path).convert("RGB")
    img = img.resize([image_size, image_size], Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr.transpose(2, 0, 1)


def _render_heatmap_from_json(json_data: dict, camera: str) -> np.ndarray:
    joints = np.array(
        [json_data["joints"][j][f"{camera}_pts2d"] for j in JOINT_NAMES],
        np.float32)
    target, _ = render_gaussian_targets_np(joints)
    return target.astype(np.float32)


class _Ego4ViewBase:
    """Frame indexing and per-frame asset loading."""

    def __init__(
        self,
        data_root: str,
        info_json: str,
        variant: str,  # "syn" | "rw"
        camera_pos: str = "all",
        image_size: int = 256,
        pre_shuffle: bool = False,
        render_missing_heatmaps: bool = False,
        use_native_loader: Optional[bool] = None,
        device_preprocess: bool = False,
        cache_in_memory: bool = False,
        **unused_kwargs,
    ):
        if use_native_loader:
            raise NotImplementedError(
                "use_native_loader: the native JPEG/PNG decoder is not ported "
                "(ROADMAP Queue A, host decode); images are decoded with PIL")
        if device_preprocess:
            raise NotImplementedError(
                "device_preprocess: the uint8 on-device preprocessing "
                "(data/preprocess.py) is not ported (ROADMAP Queue A, img_u8 "
                "device preprocessing)")
        # Every decoded sample stays resident (about len x sample size):
        # epochs after the first skip the decode.
        self._cache: Optional[dict] = {} if cache_in_memory else None
        self.data_root = data_root
        self.variant = variant
        self.camera_pos = camera_pos or "all"
        self.cameras = _cameras_for(self.camera_pos)
        self.image_size = image_size
        self.render_missing_heatmaps = render_missing_heatmaps
        self.json_dir = "json_smplx_gendered" if variant == "syn" else "json_smplx"
        self.img_ext = ".jpg" if variant == "syn" else ".png"
        self.frames = self._collect(info_json, pre_shuffle)

    def _load_images(self, paths) -> np.ndarray:
        """-> (len(paths), 3, S, S) normalised float32."""
        return np.stack([load_image(p, self.image_size) for p in paths])

    def _collect(self, info_json: str, pre_shuffle: bool) -> List[str]:
        frames: List[str] = []
        for line in self._split_lines(info_json):
            line = line.strip()
            if not line:
                continue
            if self.variant == "syn":
                for seq in sorted(glob.glob(os.path.join(self.data_root, line, "*"))):
                    frames.extend(sorted(
                        glob.glob(os.path.join(seq, self.json_dir, "*.json"))))
            else:
                frames.extend(sorted(glob.glob(
                    os.path.join(self.data_root, line, self.json_dir, "*.json"))))
        if pre_shuffle:
            random.shuffle(frames)
        return frames

    def _split_lines(self, info_json: str) -> List[str]:
        with open(info_json) as f:
            return f.readlines()

    # -- per-frame assets --------------------------------------------------

    def _img_path(self, frame: str, camera: str) -> str:
        return frame.replace(self.json_dir, f"fisheye_rgb/{camera}").replace(
            ".json", self.img_ext)

    def _hm_path(self, frame: str, camera: str) -> str:
        return frame.replace(self.json_dir, f"fisheye_hm/{camera}").replace(
            ".json", ".npy")

    def _load_views(self, frame: str):
        imgs = self._load_images([self._img_path(frame, c) for c in self.cameras])
        hms = []
        json_cache = None
        for c in self.cameras:
            p = self._hm_path(frame, c)
            if os.path.exists(p):
                hm = np.load(p)
            elif self.render_missing_heatmaps:
                if json_cache is None:
                    with open(frame) as f:
                        json_cache = json.load(f)
                hm = _render_heatmap_from_json(json_cache, c)
            else:
                raise FileNotFoundError(
                    f"{p} (precompute the heatmaps or pass "
                    f"render_missing_heatmaps=True)")
            hms.append(hm[1:])  # drop Head -> 15 channels
        return imgs, np.stack(hms).astype(np.float32)

    def _load_pose(self, frame: str) -> np.ndarray:
        with open(frame) as f:
            data = json.load(f)
        return np.array(
            [data["joints"][j]["device_pts3d"] for j in JOINT_NAMES], np.float32)

    def _load_coord_trans(self, frame: str) -> np.ndarray:
        # The reference: frame_path.split("-")[0] + "_metadata.json", i.e.
        # the sequence directory's name up to its first hyphen, taken on the
        # basename only; the unsuffixed location is tried first.
        seq_dir = os.path.dirname(os.path.dirname(frame))
        candidates = [
            seq_dir + "_metadata.json",
            os.path.join(os.path.dirname(seq_dir),
                         os.path.basename(seq_dir).split("-")[0] + "_metadata.json"),
        ]
        meta_path = next((p for p in candidates if os.path.exists(p)), candidates[1])
        with open(meta_path) as f:
            meta = json.load(f)["coord_transformation_matrix"]
        return np.stack(
            [np.asarray(meta[f"device_to_{c}"], np.float32) for c in self.cameras])

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is not None:
                return dict(hit)  # callers may rebind keys, not write arrays
        out = self._get_item(idx)
        if self._cache is not None:
            # Frozen: an in-place write by a consumer would otherwise change
            # every later epoch's sample.
            for v in out.values():
                if isinstance(v, np.ndarray):
                    v.setflags(write=False)
            self._cache[idx] = out
            return dict(out)
        return out


class HeatmapDataset(_Ego4ViewBase):
    """Single-view samples: one (frame, camera) pair per item."""

    def __init__(self, *args, all_split_lines: Optional[bool] = None, **kwargs):
        variant = kwargs.get("variant") or args[2]
        if all_split_lines is None:
            all_split_lines = variant != "syn"  # the reference's syn quirk
        self._all_split_lines = all_split_lines
        super().__init__(*args, **kwargs)
        self.items = [(f, c) for f in self.frames for c in self.cameras]

    def _split_lines(self, info_json):
        lines = super()._split_lines(info_json)
        return lines if self._all_split_lines else lines[0:1]

    def __len__(self):
        return len(self.items)

    def _get_item(self, idx) -> Dict[str, np.ndarray]:
        frame, camera = self.items[idx]
        img = self._load_images([self._img_path(frame, camera)])[0]
        p = self._hm_path(frame, camera)
        if os.path.exists(p):
            hm = np.load(p)
        elif self.render_missing_heatmaps:
            with open(frame) as f:
                hm = _render_heatmap_from_json(json.load(f), camera)
        else:
            raise FileNotFoundError(p)
        return {
            "img": img[None],  # (1, 3, S, S): a view axis of size 1
            "gt_heatmap": hm[None, 1:].astype(np.float32),
            "frame_path": f"{frame}:{camera}",
        }


class HeatmapMVFDataset(_Ego4ViewBase):
    """Multi-view samples: the V images and their heatmaps."""

    def _get_item(self, idx) -> Dict[str, np.ndarray]:
        frame = self.frames[idx]
        img, hm = self._load_views(frame)
        return {"img": img, "gt_heatmap": hm, "frame_path": frame}


class Pose3DDataset(_Ego4ViewBase):
    """Multi-view images and heatmaps with the 16 x 3 device-frame pose
    (cm); rw adds the per-view device-to-camera transforms."""

    def _get_item(self, idx) -> Dict[str, np.ndarray]:
        frame = self.frames[idx]
        img, hm = self._load_views(frame)
        out = {"img": img, "gt_heatmap": hm, "gt_pose": self._load_pose(frame),
               "frame_path": frame}
        if self.variant == "rw":
            out["coord_trans_mat"] = self._load_coord_trans(frame)
        return out


_DATASETS = {
    "ego4view_syn_heatmap": (HeatmapDataset, "syn"),
    "ego4view_syn_heatmap_mvf": (HeatmapMVFDataset, "syn"),
    "ego4view_syn_pose3d": (Pose3DDataset, "syn"),
    "ego4view_rw_heatmap": (HeatmapDataset, "rw"),
    "ego4view_rw_heatmap_mvf": (HeatmapMVFDataset, "rw"),
    "ego4view_rw_pose3d": (Pose3DDataset, "rw"),
}


def get_dataset(dataset_type: str, root: str, split: str, **kwargs):
    """The dataset of ``dataset_type`` on ``<root>/<split>.txt``."""
    if split not in ("train", "test", "validation"):
        raise ValueError(f"split {split!r}")
    if dataset_type not in _DATASETS:
        raise NotImplementedError(dataset_type)
    cls, variant = _DATASETS[dataset_type]
    return cls(root, os.path.join(root, f"{split}.txt"), variant, **kwargs)
