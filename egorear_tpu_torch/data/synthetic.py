"""Synthetic Ego4View-style dataset tree (the JAX package's
``data/synthetic.py``): the syn variant and the real-world one (``rw``).

Writes a tree in the reference's path grammar (images, frame JSONs with the
2D and 3D joints, split files) so that ``fit``/``test``/``predict`` run end
to end without the dataset. The 3D poses sit in a body envelope below the
head-mounted device (or come from a fixed-bone-length kinematic tree), and
their 2D joints are the fisheye projections through the repository's
calibration (``CameraRig.project`` on the CPU, ``chained=False``), so
images, heatmaps and poses agree geometrically. The random draws follow the
JAX generator's order, so one seed gives the same poses, noise and files.

The real-world variant (``variant="rw"``) writes the rw grammar: split lines
``2024-01-0<c>/S<c>/seq<s>-<split>``, frame JSONs under ``json_smplx``, PNG
images, and per sequence ``<seqdir>_metadata.json`` with its device-to-camera
transforms (identity rotations, translations of a few centimetres drawn
after the poses), through which its 2D joints are projected.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import json
import os

import numpy as np
import torch
from PIL import Image

from egorear_tpu_torch.data.datasets import CAMERA_NAMES, JOINT_NAMES
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.heatmap import render_gaussian_targets_np

# A blob is drawn out to this many sigmas, where it adds under 4e-6 to a
# channel (exp(-18) x 255), far below the 1/255 step of the uint8 image.
_BLOB_REACH_SIGMAS = 6.0


def _project_np(rig: CameraRig, pts_bj3: np.ndarray, mats=None) -> np.ndarray:
    """(B, J, 3) cm -> (B, V, J, 2) pixel coordinates of the 872-px frame;
    the real-world rig projects through the sequence's (V, 4, 4) ``mats``."""
    ctm = None
    if rig.is_rw:
        B = pts_bj3.shape[0]
        ctm = torch.from_numpy(np.broadcast_to(
            mats[None], (B, *mats.shape)).astype(np.float32))
    pts2d, _, _ = rig.project(torch.from_numpy(pts_bj3.astype(np.float32)), ctm)
    return pts2d.numpy() * 872.0


def _add_blobs(img: np.ndarray, pts2d_j2: np.ndarray, visible=None) -> None:
    """Add each visible joint's coloured Gaussian blob to ``img`` (S, S, 3)
    float32, in place."""
    size = img.shape[0]
    sigma = max(2.0, size / 40.0)
    reach = int(np.ceil(_BLOB_REACH_SIGMAS * sigma))
    axis = np.arange(size, dtype=np.float32)
    for j in range(pts2d_j2.shape[0]):
        if visible is not None and not visible[j]:
            continue
        x, y = float(pts2d_j2[j, 0]), float(pts2d_j2[j, 1])
        if not (0 <= x < size and 0 <= y < size):
            continue
        x0, x1 = max(0, int(x) - reach), min(size, int(x) + reach + 1)
        y0, y1 = max(0, int(y) - reach), min(size, int(y) + reach + 1)
        gx = np.exp(-((axis[x0:x1] - x) ** 2) / (2.0 * sigma**2))
        gy = np.exp(-((axis[y0:y1] - y) ** 2) / (2.0 * sigma**2))
        color = np.array([(j * 53 + 40) % 256, (j * 97 + 80) % 256,
                          (j * 193 + 120) % 256], np.float32)
        img[y0:y1, x0:x1] += (gy[:, None] * gx[None, :])[..., None] * color


def _blobbed(noise: np.ndarray, pts2d_j2: np.ndarray, visible=None) -> np.ndarray:
    """``noise`` (float32, written in place) with the blobs, as uint8."""
    _add_blobs(noise, pts2d_j2, visible)
    return np.clip(noise, 0, 255).astype(np.uint8)


def _draw_pose_image(pts2d_j2: np.ndarray, size: int, rng,
                     visible=None) -> np.ndarray:
    """A (size, size, 3) uint8 image: dim noise (from ``rng``) with a
    coloured Gaussian blob at each visible joint's 2D projection, so that
    the image carries the pose (an occluded joint, ``visible[j]`` False,
    keeps its labels and loses its blob)."""
    return _blobbed(rng.integers(0, 40, size=(size, size, 3)).astype(np.float32),
                    pts2d_j2, visible)


def _finish_image(path: str, noise: np.ndarray, pts2d_j2, visible) -> None:
    """Blobs onto ``noise`` (float32; a uint8 image is taken as it is),
    encode, write: the part of an image that draws nothing from the
    generator."""
    img = noise if noise.dtype == np.uint8 else _blobbed(noise, pts2d_j2, visible)
    Image.fromarray(img).save(path)


# ---------------------------------------------------------------------------
# skeletal pose prior
# ---------------------------------------------------------------------------

# (parent index, rest direction in the device frame, bone length cm) in
# JOINT_NAMES order. Head is the root, just below the headset.
_SKELETON = {
    1: (0, (0.0, 0.1, 1.0), 12.0),     # Neck        <- Head
    2: (1, (-1.0, 0.0, 0.15), 18.0),   # LeftArm     <- Neck
    3: (1, (1.0, 0.0, 0.15), 18.0),    # RightArm    <- Neck
    4: (2, (-0.25, 0.15, 1.0), 28.0),  # LeftForeArm <- LeftArm
    5: (3, (0.25, 0.15, 1.0), 28.0),   # RightForeArm<- RightArm
    6: (4, (-0.1, -0.3, 1.0), 26.0),   # LeftHand    <- LeftForeArm
    7: (5, (0.1, -0.3, 1.0), 26.0),    # RightHand   <- RightForeArm
    8: (1, (-0.22, 0.05, 1.0), 52.0),  # LeftUpLeg   <- Neck (torso+hip)
    9: (1, (0.22, 0.05, 1.0), 52.0),   # RightUpLeg  <- Neck
    10: (8, (-0.05, 0.1, 1.0), 40.0),  # LeftLeg     <- LeftUpLeg
    11: (9, (0.05, 0.1, 1.0), 40.0),   # RightLeg    <- RightUpLeg
    12: (10, (0.0, 0.1, 1.0), 42.0),   # LeftFoot    <- LeftLeg
    13: (11, (0.0, 0.1, 1.0), 42.0),   # RightFoot   <- RightLeg
    14: (12, (0.0, -1.0, 0.3), 15.0),  # LeftToeBase <- LeftFoot
    15: (13, (0.0, -1.0, 0.3), 15.0),  # RightToeBase<- RightFoot
}


def sample_skeleton_poses(rng, n_frames: int, angle_noise: float = 0.6,
                          root_jitter: float = 20.0,
                          yaw_range: float = 1.5) -> np.ndarray:
    """(F, 16, 3) poses (cm, device frame) from a fixed-bone-length
    kinematic tree: per-bone direction noise, root jitter and a whole-body
    yaw about the device's z (down) axis."""
    J = len(JOINT_NAMES)
    poses = np.zeros((n_frames, J, 3))
    head = np.array([0.0, 18.0, 30.0])  # +z is down, toward the body
    poses[:, 0] = head + rng.normal(scale=root_jitter, size=(n_frames, 3))
    yaw = rng.uniform(-yaw_range, yaw_range, size=n_frames)
    cz, sz = np.cos(yaw), np.sin(yaw)
    for j in range(1, J):
        parent, rest, length = _SKELETON[j]
        d = np.asarray(rest) / np.linalg.norm(rest)
        dirs = d + rng.normal(scale=angle_noise, size=(n_frames, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        rx = cz * dirs[:, 0] - sz * dirs[:, 1]
        ry = sz * dirs[:, 0] + cz * dirs[:, 1]
        dirs = np.stack([rx, ry, dirs[:, 2]], axis=-1)
        poses[:, j] = poses[:, parent] + dirs * length
    return poses


def sample_pair_visibility(rng, n_frames: int, occlusion: float):
    """(F, V=4, J) bool visibility per stereo pair: each joint is hidden
    from the front pair and, independently, from the back pair with
    probability ``occlusion``, never from both (a coin flip reveals one)."""
    J = len(JOINT_NAMES)
    hide_front = rng.random(size=(n_frames, J)) < occlusion
    hide_back = rng.random(size=(n_frames, J)) < occlusion
    both = hide_front & hide_back
    coin = rng.random(size=(n_frames, J)) < 0.5
    hide_front &= ~(both & coin)
    hide_back &= ~(both & ~coin)
    vis = np.ones((n_frames, 4, J), bool)
    vis[:, 0] = vis[:, 1] = ~hide_front
    vis[:, 2] = vis[:, 3] = ~hide_back
    return vis


def make_synthetic_dataset(
    root: str,
    variant: str = "syn",
    num_chars: int = 1,
    num_seqs: int = 1,
    frames_per_seq: int = 8,
    image_size: int = 96,
    splits=("train", "validation", "test"),
    seed: int = 0,
    write_heatmaps: bool = False,
    draw_pose: bool = False,
    eval_frames_per_seq: int = None,
    skeleton: bool = False,
    occlusion: float = 0.0,
):
    """Build ``<root>/...`` with one split file per entry of ``splits``,
    each split on its own characters and sequences.

    Images are random JPEGs, or with ``draw_pose`` the joints drawn into
    them (:func:`_draw_pose_image`); ``write_heatmaps`` also writes the
    ``fisheye_hm`` NPYs (else pass ``render_missing_heatmaps=True`` to the
    datasets); ``eval_frames_per_seq`` sizes the validation and test splits
    apart from the train split. ``skeleton`` draws the poses from the
    kinematic tree (:func:`sample_skeleton_poses`); ``occlusion`` > 0 hides
    blobs per stereo pair (:func:`sample_pair_visibility`, saved to
    ``<seq>/visibility.npy``) while the labels stay. Images are finished
    and encoded on a thread pool; the generator is drawn in order.
    """
    if variant not in ("syn", "rw"):
        raise ValueError(f"variant {variant!r}: syn or rw")
    rng = np.random.default_rng(seed)
    rig = CameraRig.from_calib_file(f"ego4view_{variant}", chained=False,
                                    device="cpu")
    json_dir = "json_smplx_gendered" if variant == "syn" else "json_smplx"
    ext = ".jpg" if variant == "syn" else ".png"
    workers = os.cpu_count() or 1
    with cf.ThreadPoolExecutor(workers) as pool:
        # Each job holds an image's noise: at most 2 per worker in flight.
        jobs = _Jobs(pool, 2 * workers)
        for split in splits:
            n_frames = (frames_per_seq if split == "train" or not eval_frames_per_seq
                        else eval_frames_per_seq)
            lines = []
            for ci in range(num_chars):
                if variant == "syn":
                    char = f"rp_{split}_{ci:02d}"
                    seqs = [os.path.join(char, f"seq_{si}") for si in range(num_seqs)]
                    lines.append(char)
                else:
                    seqs = [os.path.join(f"2024-01-0{ci + 1}", f"S{ci}",
                                         f"seq{si}-{split}") for si in range(num_seqs)]
                    lines.extend(seqs)
                for seq_rel in seqs:
                    seq_dir = os.path.join(root, seq_rel)
                    os.makedirs(os.path.join(seq_dir, json_dir), exist_ok=True)
                    if skeleton:
                        poses = sample_skeleton_poses(rng, n_frames)
                    else:
                        # +z is down in the device frame: the rig looks
                        # down +z, so the body envelope sits at positive z.
                        base = np.array([0.0, 18.0, 100.0])
                        poses = base + rng.normal(scale=25.0, size=(n_frames, 16, 3))
                    visibility = (sample_pair_visibility(rng, n_frames, occlusion)
                                  if occlusion > 0 else None)
                    mats = None
                    if variant == "rw":
                        mats = _write_rw_metadata(seq_dir, rng)
                    pts2d = _project_np(rig, poses, mats)  # (F, V, J, 2)
                    if visibility is not None:
                        np.save(os.path.join(seq_dir, "visibility.npy"), visibility)
                    _write_frames(jobs, seq_dir, json_dir, ext, poses, pts2d,
                                  visibility, rng, image_size, draw_pose,
                                  write_heatmaps)
            with open(os.path.join(root, f"{split}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
        jobs.drain(0)
    return root


def _write_rw_metadata(seq_dir: str, rng) -> np.ndarray:
    """Draw a sequence's (4, 4, 4) device-to-camera transforms (identity
    rotations, translations of sd 2 cm, metres) and write them to
    ``<seq_dir>_metadata.json``, as the real-world tree holds them."""
    mats = np.tile(np.eye(4, dtype=np.float64), (4, 1, 1))
    mats[:, :3, 3] = rng.normal(scale=0.02, size=(4, 3))
    meta = {"coord_transformation_matrix": {
        f"device_to_{c}": mats[i].tolist() for i, c in enumerate(CAMERA_NAMES)}}
    with open(seq_dir + "_metadata.json", "w") as f:
        json.dump(meta, f)
    return mats


class _Jobs:
    """Futures of a pool, at most ``limit`` pending; every result is read."""

    def __init__(self, pool, limit: int):
        self.pool, self.limit = pool, limit
        self.pending = collections.deque()

    def drain(self, keep: int) -> None:
        while len(self.pending) > keep:
            self.pending.popleft().result()

    def submit(self, fn, *args) -> None:
        self.drain(self.limit - 1)
        self.pending.append(self.pool.submit(fn, *args))


def _write_frames(jobs: _Jobs, seq_dir, json_dir, ext, poses, pts2d, visibility,
                  rng, image_size, draw_pose, write_heatmaps) -> None:
    """Write one sequence's frame JSONs and heatmaps; draw its images'
    random parts in order and hand the rest to ``jobs``."""
    for fi in range(poses.shape[0]):
        frame = f"frame_{fi:04d}"
        jdata = {"joints": {}}
        for j, name in enumerate(JOINT_NAMES):
            entry = {"device_pts3d": poses[fi, j].tolist()}
            for vi, cam in enumerate(CAMERA_NAMES):
                entry[f"{cam}_pts2d"] = pts2d[fi, vi, j].tolist()
            jdata["joints"][name] = entry
        with open(os.path.join(seq_dir, json_dir, frame + ".json"), "w") as f:
            json.dump(jdata, f)

        for vi, cam in enumerate(CAMERA_NAMES):
            img_dir = os.path.join(seq_dir, "fisheye_rgb", cam)
            os.makedirs(img_dir, exist_ok=True)
            if draw_pose:
                noise = rng.integers(0, 40, size=(image_size, image_size, 3)
                                     ).astype(np.float32)
            else:
                noise = rng.integers(0, 255, size=(image_size, image_size, 3),
                                     dtype=np.uint8)
            jobs.submit(_finish_image, os.path.join(img_dir, frame + ext),
                        noise, pts2d[fi, vi] * (image_size / 872.0),
                        None if visibility is None else visibility[fi, vi])

        if write_heatmaps:
            t, _ = render_gaussian_targets_np(pts2d[fi].astype(np.float32))
            for vi, cam in enumerate(CAMERA_NAMES):
                hm_dir = os.path.join(seq_dir, "fisheye_hm", cam)
                os.makedirs(hm_dir, exist_ok=True)
                np.save(os.path.join(hm_dir, frame + ".npy"),
                        np.asarray(t[vi], np.float32))
