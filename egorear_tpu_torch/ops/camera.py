"""Calibrated Scaramuzza fisheye camera rig, vectorized over views (the JAX
package's ``ops/camera.py``: ``CameraRig.from_calib_file``, ``.project``,
``fisheye_world2camera`` and ``apply_se3``), for every rig of the reference's
``camera_model``: ``ego4view_{syn,rw}`` with all four cameras, or one stereo
pair (``_stereo_front``, ``_stereo_back``).

Beside the rig: the legacy UnrealEgo stereo projection the reference keeps
next to its calibrated model (:func:`unrealego_project`, dispatched by
:data:`projection_funcs`) and the Blender <-> OpenCV axis flip of camera
poses (:func:`blender_to_opencv_extrinsics`, numpy).

The synthetic rig places each camera by a fixed centimetre offset (and an
x/y flip for the back pair). The real-world rig (``ego4view_rw*``) takes a
per-sample device-to-camera 4x4 transform (``coord_trans_mat``, metres)
instead, and hands the anchors back unchanged.

Reference quirk reproduced on purpose (``chained=True``, the default): the
reference applies each camera's offset/flip IN PLACE on the shared anchor
tensor, so the four projections chain:

    FL projects a + (6, 0, 0)
    FR projects a                     (the -6 offset lands on FL's state)
    BL projects (-ax - 6, -ay + 37, az)
    BR projects ( ax + 12, ay,      az)

and the anchors handed back to the 3D offset regressor are the mutated end
state (a + (12, 0, 0) for the 4-view rig). ``chained=False`` gives the
geometrically intended independent transforms. The real-world rig never
chains.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from egorear_tpu_torch.utils.constants import device_constant

_EPS = 1e-12

CAMERA_ORDER = (
    "camera_front_left",
    "camera_front_right",
    "camera_back_left",
    "camera_back_right",
)

# Per-camera (flip_xy, offset) of the synthetic Ego4View rig, centimeters.
_SYN_LAYOUT = {
    "camera_front_left": (False, (6.0, 0.0, 0.0)),
    "camera_front_right": (False, (-6.0, 0.0, 0.0)),
    "camera_back_left": (True, (-6.0, 37.0, 0.0)),
    "camera_back_right": (True, (6.0, 37.0, 0.0)),
}

# The cameras of each camera_model suffix, in view order.
_MODEL_CAMERAS = {
    "": CAMERA_ORDER,
    "_stereo_front": CAMERA_ORDER[:2],
    "_stereo_back": CAMERA_ORDER[2:],
}


def read_calib_dir(path: str) -> dict:
    """The reference's calibration layout (a config's
    ``camera_calib_file_dir_path``): one ``<camera>.json`` per camera with
    ``size``, ``image_center``, ``polynomialC2W`` and ``polynomialW2C``,
    as the rig JSON's ``cameras`` entries."""
    rig_data = {}
    for name in CAMERA_ORDER:
        with open(os.path.join(path, f"{name}.json")) as f:
            d = json.load(f)
        rig_data[name] = {"image_size_hw": d["size"],
                          "center_xy": d["image_center"],
                          "poly_cam2world": d["polynomialC2W"],
                          "poly_world2cam": d["polynomialW2C"]}
    return rig_data


def default_calib_path() -> str:
    """``calib/ego4view_rig.json`` at the repository root."""
    return str(Path(__file__).resolve().parents[2] / "calib" / "ego4view_rig.json")


@dataclass(frozen=True)
class CameraRig:
    """Stacked calibration constants for V fisheye cameras (fp32 tensors).

    ``sign``/``offset`` hold the *cumulative* affine per view (see the module
    docstring on chaining).
    """

    poly_w2c: torch.Tensor  # (V, D) world->cam polynomial, zero padded
    center: torch.Tensor  # (V, 2) image center (cx, cy) px
    image_size_hw: torch.Tensor  # (V, 2) (H, W) px
    sign: torch.Tensor  # (V, 3) cumulative +-1 per axis
    offset: torch.Tensor  # (V, 3) cumulative offset, cm
    final_sign: torch.Tensor  # (3,) end-state sign after the last camera
    final_offset: torch.Tensor  # (3,) end-state offset after the last camera
    is_rw: bool = False
    num_views: int = 4

    @staticmethod
    def from_calib_file(camera_model: str, calib_path: Optional[str] = None,
                        chained: bool = True,
                        device=None) -> "CameraRig":
        """Build the rig of the reference ``camera_model``
        (``ego4view_{syn,rw}`` plus ``""``, ``_stereo_front`` or
        ``_stereo_back``) from a rig JSON (default: the repository's
        ``calib/ego4view_rig.json``) or from the reference's directory of
        per-camera JSONs (:func:`read_calib_dir`)."""
        calib_path = calib_path or default_calib_path()
        if os.path.isdir(calib_path):
            rig_data = read_calib_dir(calib_path)
        else:
            with open(calib_path) as f:
                rig_data = json.load(f)["cameras"]
        suffix = ""
        for s in ("_stereo_front", "_stereo_back"):
            if camera_model.endswith(s):
                suffix = s
        cameras = _MODEL_CAMERAS[suffix]
        is_rw = camera_model.startswith("ego4view_rw")

        polys, centers, sizes = [], [], []
        max_deg = max(len(rig_data[c]["poly_world2cam"]) for c in cameras)
        for c in cameras:
            d = rig_data[c]
            p = list(d["poly_world2cam"])
            polys.append(p + [0.0] * (max_deg - len(p)))
            centers.append(d["center_xy"])
            sizes.append(d["image_size_hw"])

        # Cumulative per-view affine: p_v = sign_v * a + offset_v.
        signs, offsets = [], []
        s = np.ones(3, dtype=np.float64)
        t = np.zeros(3, dtype=np.float64)
        for c in cameras:
            flip, off = _SYN_LAYOUT[c]
            if chained:
                if flip:
                    s = s * np.array([-1.0, -1.0, 1.0])
                    t = t * np.array([-1.0, -1.0, 1.0])
                t = t + np.asarray(off)
            else:
                s = np.array([-1.0, -1.0, 1.0]) if flip else np.ones(3)
                t = np.asarray(off, dtype=np.float64)
            signs.append(s.copy())
            offsets.append(t.copy())
        final_sign = signs[-1] if chained else np.ones(3)
        final_offset = offsets[-1] if chained else np.zeros(3)

        # Round through float32 numpy exactly as the JAX package does.
        f32 = lambda x: torch.from_numpy(  # noqa: E731
            np.asarray(x, dtype=np.float32)).to(device)
        return CameraRig(
            poly_w2c=f32(polys), center=f32(centers), image_size_hw=f32(sizes),
            sign=f32(signs), offset=f32(offsets), final_sign=f32(final_sign),
            final_offset=f32(final_offset), is_rw=is_rw, num_views=len(cameras),
        )

    def camera_relative_points(self, pts3d: torch.Tensor,
                               coord_trans_mat: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
        """(B, J, 3) device-frame cm points -> (B, V, J, 3) camera-frame cm;
        the real-world rig applies ``coord_trans_mat`` (B, V, 4, 4), metres."""
        if self.is_rw:
            if coord_trans_mat is None:
                raise ValueError("real-world rig needs per-sample coord_trans_mat")
            return apply_se3(coord_trans_mat, pts3d[:, None] * 0.01) * 100.0
        return self.sign[None, :, None, :] * pts3d[:, None] + self.offset[None, :, None, :]

    def project(self, pts3d: torch.Tensor,
                coord_trans_mat: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Project device-frame 3D points (B, J, 3), cm, into every view
        (the real-world rig through ``coord_trans_mat`` (B, V, 4, 4)).

        Returns pts2d (B, V, J, 2) in [0, 1], in_fov (B, V, J) bool, and
        anchors_out (B, J, 3): the anchor state after projection, which in
        chained synthetic mode is the mutated end state the reference
        regresses offsets against, and ``pts3d`` itself on the real-world
        rig.
        """
        pts3d = pts3d.detach()
        cam_pts = self.camera_relative_points(pts3d, coord_trans_mat)
        pts2d, in_fov = fisheye_world2camera(
            cam_pts, self.poly_w2c, self.center, self.image_size_hw)
        if self.is_rw:
            return pts2d, in_fov, pts3d
        anchors_out = self.final_sign * pts3d + self.final_offset
        return pts2d, in_fov, anchors_out


def fisheye_world2camera(cam_pts: torch.Tensor, poly_w2c: torch.Tensor,
                         center: torch.Tensor, image_size_hw: torch.Tensor):
    """Scaramuzza polynomial projection, batched over views.

    cam_pts (..., V, J, 3) camera-frame points; poly_w2c (V, D) coefficients
    a_i of rho = sum a_i theta^i; center (V, 2) (cx, cy); image_size_hw
    (V, 2). Returns pts2d (..., V, J, 2) clipped to [0, 1] and the strict
    in-bounds mask in_fov (..., V, J).
    """
    x, y, z = cam_pts[..., 0], cam_pts[..., 1], cam_pts[..., 2]
    r = torch.sqrt(x * x + y * y)
    r_safe = torch.clamp(r, min=_EPS)  # the reference divides by an unguarded norm
    theta = torch.atan(-z / r_safe)

    # Horner evaluation, coefficients low -> high, broadcast over J.
    deg = poly_w2c.shape[-1]
    rho = poly_w2c[:, deg - 1][..., None] * torch.ones_like(theta)
    for i in range(deg - 2, -1, -1):
        rho = rho * theta + poly_w2c[:, i][..., None]

    u = x / r_safe * rho + center[:, 0][..., None]
    v = y / r_safe * rho + center[:, 1][..., None]
    u = u / image_size_hw[:, 1][..., None]
    v = v / image_size_hw[:, 0][..., None]

    pts2d = torch.stack([u, v], dim=-1)
    in_fov = (u > 0) & (v > 0) & (u < 1) & (v < 1)
    return pts2d.clamp(0.0, 1.0), in_fov


def apply_se3(mats: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Homogeneous 4x4 transforms ``mats`` (..., 4, 4) applied to 3D points
    ``pts`` (..., J, 3), batch axes broadcast -> (..., J, 3).

    Products and sums in the points' dtype, no matmul: fp32 whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says, as the JAX package's
    einsum at ``Precision.HIGHEST``.
    """
    rot = mats[..., None, :3, :3]  # (..., 1, 3, 3): broadcast over J
    p = pts[..., None, :]  # (..., J, 1, 3)
    out = rot[..., 0] * p[..., 0] + rot[..., 1] * p[..., 1] + rot[..., 2] * p[..., 2]
    return out + mats[..., None, :3, 3]


# The legacy UnrealEgo stereo projection (the reference's
# utils/camera_models.py:106-157 keeps it beside the calibrated model,
# dispatched through projection_funcs).

_UNREALEGO_POLY_W2C = (
    541.084422, 133.996745, -53.833198, 60.96083, -24.78051, 12.451492,
    -30.240511, 26.90122, 116.38499, -133.991117, -141.904687, 184.05592,
    107.45616, -125.552875, -55.66342, 44.209519, 18.234651, -6.410899,
    -2.737066,
)
_UNREALEGO_CENTER = (511.1183388444314, 510.8730105600536)
_UNREALEGO_SIZE = (1024, 1024)


def unrealego_project(local_3d: torch.Tensor, local_origin=None):
    """The hard-coded UnrealEgo stereo fisheye projection.

    local_3d: (B, J, 3) device-frame points (cm); ``local_origin``, when
    given, is added in place of the fixed stereo baseline (camera 0 at
    x - 6 cm, camera 1 at x + 6 cm, the reference's
    utils/camera_models.py:116-127). Returns ((B, 2, J, 2) normalised
    coordinates clipped to [0, 1], (B, 2, J) strict in-bounds mask).
    """
    p = local_3d[:, None].repeat(1, 2, 1, 1)
    if local_origin is not None:
        p = p + local_origin
    else:
        offsets = device_constant(((-6.0, 0, 0), (6.0, 0, 0)), p.dtype, p.device)
        p = p + offsets[None, :, None, :]

    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = torch.clamp(torch.sqrt(x * x + y * y), min=_EPS)
    theta = torch.atan(-z / r)
    coeffs = _UNREALEGO_POLY_W2C
    rho = torch.full_like(theta, coeffs[-1])
    for a in coeffs[-2::-1]:
        rho = rho * theta + a
    u = (x / r * rho + _UNREALEGO_CENTER[0]) / _UNREALEGO_SIZE[1]
    v = (y / r * rho + _UNREALEGO_CENTER[1]) / _UNREALEGO_SIZE[0]
    pts2d = torch.stack([u, v], dim=-1)
    in_fov = (u > 0) & (v > 0) & (u < 1) & (v < 1)
    return pts2d.clamp(0.0, 1.0), in_fov


# The reference's dispatch table (utils/camera_models.py:154-157).
projection_funcs = {
    "unrealego": unrealego_project,
    "unrealego2": unrealego_project,
}

_BLENDER_CV_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def blender_to_opencv_extrinsics(mat: np.ndarray) -> np.ndarray:
    """Blender camera pose (4x4, -Z forward / +Y up) -> OpenCV extrinsics
    (+Z forward / -Y up): the core axis flip of the reference's converter
    family (utils/util.py:300-471; the rest is
    :mod:`egorear_tpu_torch.ops.extrinsics`), in float64."""
    return np.asarray(mat, np.float64) @ _BLENDER_CV_FLIP


def opencv_to_blender_extrinsics(mat: np.ndarray) -> np.ndarray:
    """The inverse of :func:`blender_to_opencv_extrinsics` (the flip is its
    own inverse)."""
    return np.asarray(mat, np.float64) @ _BLENDER_CV_FLIP
