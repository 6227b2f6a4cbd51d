"""Image and metric helpers of the reference's component inventory (the JAX
package's ``utils/image.py``), host-side numpy:

  * :func:`denormalize`, :func:`tensor2im`: ImageNet-normalised CHW back to
    uint8 HWC (the reference's util.py:15-37, 111-114);
  * :func:`draw_2d_joints`: joints and bones drawn over an image for
    qualitative dumps (models/utils/util.py:184-240);
  * :class:`RunningAverage`, :class:`RunningAverageDict` (util.py:133-159);
  * :func:`align_by_pelvis`, :func:`pelvis_aligned_error` (util.py:269-291);
  * :func:`compute_accel`, :func:`compute_error_accel`,
    :func:`compute_error_verts` (models/utils/util.py:415-460);
  * :func:`egoglass_limb_masks`: EgoGlass-style limb masks drawn from 2D
    joints (models/utils/util.py:371-407).

The two drawing functions import ``cv2`` when called and raise
``ImportError`` where it is not installed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from egorear_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
from egorear_tpu_torch.utils.skeleton import BONES


def denormalize(img_chw: np.ndarray) -> np.ndarray:
    """(3, H, W) ImageNet-normalised -> (3, H, W) float in [0, 1]."""
    return img_chw * IMAGENET_STD[:, None, None] + IMAGENET_MEAN[:, None, None]


def tensor2im(img_chw: np.ndarray) -> np.ndarray:
    """(3, H, W) normalised float -> (H, W, 3) uint8."""
    x = denormalize(np.asarray(img_chw))
    x = np.clip(x * 255.0, 0, 255).astype(np.uint8)
    return x.transpose(1, 2, 0)


def draw_2d_joints(image_hwc: np.ndarray, joints_2d: np.ndarray,
                   valid: Optional[np.ndarray] = None, color=(0, 255, 0),
                   bone_color=(255, 128, 0), radius: int = 3) -> np.ndarray:
    """A copy of the uint8 HWC image with the valid joints' bones (1 px
    lines) and the joints (filled circles of ``radius``) drawn in."""
    import cv2

    img = np.ascontiguousarray(image_hwc.copy())
    J = len(joints_2d)
    ok = np.ones(J, bool) if valid is None else np.asarray(valid, bool)
    for p, c in BONES:
        if p < J and c < J and ok[p] and ok[c]:
            cv2.line(img, tuple(np.int32(joints_2d[p])),
                     tuple(np.int32(joints_2d[c])), bone_color, 1)
    for j in range(J):
        if ok[j]:
            cv2.circle(img, tuple(np.int32(joints_2d[j])), radius, color, -1)
    return img


class RunningAverage:
    """A count-weighted running mean of scalars."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.total += float(value) * n
        self.count += n

    @property
    def average(self) -> float:
        return self.total / max(self.count, 1)


class RunningAverageDict:
    """A :class:`RunningAverage` per key."""

    def __init__(self):
        self._avgs: Dict[str, RunningAverage] = {}

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self._avgs.setdefault(k, RunningAverage()).update(v, n)

    def averages(self) -> Dict[str, float]:
        return {k: a.average for k, a in self._avgs.items()}


def align_by_pelvis(joints: np.ndarray, pelvis_idx=(8, 9)) -> np.ndarray:
    """Joints centred on the mid-point of the up-legs (the pelvis proxy)."""
    pelvis = joints[..., list(pelvis_idx), :].mean(axis=-2, keepdims=True)
    return joints - pelvis


def pelvis_aligned_error(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Mean per-joint error after both are centred on their pelvis."""
    p = align_by_pelvis(pred)
    g = align_by_pelvis(gt)
    return np.linalg.norm(p - g, axis=-1).mean(axis=-1)


def compute_accel(joints_seq: np.ndarray) -> np.ndarray:
    """(T, J, 3) -> (T-2,) mean acceleration magnitude."""
    accel = joints_seq[:-2] - 2 * joints_seq[1:-1] + joints_seq[2:]
    return np.linalg.norm(accel, axis=-1).mean(axis=-1)


def compute_error_accel(gt_seq: np.ndarray, pred_seq: np.ndarray,
                        vis: Optional[np.ndarray] = None) -> np.ndarray:
    """(T, J, 3) x 2 -> (T-2,) acceleration error, over the joints visible
    in all three frames of each window when ``vis`` (T, J) is given (0 where
    none is)."""
    accel_gt = gt_seq[:-2] - 2 * gt_seq[1:-1] + gt_seq[2:]
    accel_pred = pred_seq[:-2] - 2 * pred_seq[1:-1] + pred_seq[2:]
    err = np.linalg.norm(accel_pred - accel_gt, axis=-1)
    if vis is None:
        return err.mean(axis=-1)
    v = np.asarray(vis, bool)
    mask = v[:-2] & v[1:-1] & v[2:]
    out = np.zeros(err.shape[0])
    for t in range(err.shape[0]):
        m = mask[t]
        out[t] = err[t][m].mean() if m.any() else 0.0
    return out


def compute_error_verts(pred_verts: np.ndarray,
                        gt_verts: np.ndarray) -> np.ndarray:
    """Mean per-vertex error."""
    return np.linalg.norm(pred_verts - gt_verts, axis=-1).mean(axis=-1)


# EgoGlass's body parts as bones of the 16-joint tree.
_LIMB_PARTS = {
    "torso": [(1, 8), (1, 9), (8, 9), (1, 2), (1, 3)],
    "left_arm": [(2, 4), (4, 6)],
    "right_arm": [(3, 5), (5, 7)],
    "left_leg": [(8, 10), (10, 12), (12, 14)],
    "right_leg": [(9, 11), (11, 13), (13, 15)],
}


def egoglass_limb_masks(joints_2d: np.ndarray, image_hw=(256, 256),
                        thickness: int = 12) -> np.ndarray:
    """(5, H, W) uint8 pseudo segmentation masks of {torso, left arm, right
    arm, left leg, right leg}, each its bones drawn as lines of
    ``thickness`` px."""
    import cv2

    J = joints_2d
    out = np.zeros((len(_LIMB_PARTS), *image_hw), np.uint8)
    for pi, bones in enumerate(_LIMB_PARTS.values()):
        for a, b in bones:
            if a < len(J) and b < len(J):
                cv2.line(out[pi], tuple(np.int32(J[a])), tuple(np.int32(J[b])),
                         255, thickness)
    return out
