"""Blender <-> OpenCV extrinsics converters and global/local pose
transforms (the JAX package's ``ops/extrinsics.py``, after the reference's
``pose_estimation/utils/util.py:300-471``): quaternion and extrinsic-xyz
Euler rotations, the Blender camera convention (-Z forward, +Y up) to
OpenCV's (+Z forward, -Y up), relative camera chains, and local <-> global
skeleton transforms.

Host-side numpy in float64, vectorised over leading batch axes where the
reference loops per frame: these run in data-preparation scripts, not on
the card (the model's camera math is :mod:`egorear_tpu_torch.ops.camera`).
No scipy: the rotation conversions are written out.

Conventions (scipy's, which the reference uses):
  * quaternions are ``[x, y, z, w]`` (scalar last);
  * ``'xyz'`` Euler angles are EXTRINSIC rotations applied x, then y, then
    z, i.e. ``R = Rz(c) @ Ry(b) @ Rx(a)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "quat_to_matrix",
    "euler_xyz_to_matrix",
    "matrix_to_euler_xyz",
    "trans_qrot_to_matrix",
    "transformation_matrix_to_translation_and_rotation",
    "transform_pose",
    "global_skeleton_2_local_skeleton",
    "get_concecutive_global_cam",
    "get_relative_global_pose",
    "get_relative_global_pose_with_camera_matrix",
    "get_global_pose_from_relative_global_pose",
    "get_relative_camera_matrix",
    "get_relative_transform",
    "get_transform_relative_to_base_cv",
    "get_transform_relative_to_base_blender",
    "get_cv_rt_from_blender",
    "get_cv_rt_from_cv",
]


# ---------------------------------------------------------------------------
# rotation primitives
# ---------------------------------------------------------------------------

def quat_to_matrix(q) -> np.ndarray:
    """``[..., 4]`` quaternion (x, y, z, w, scipy order) -> ``[..., 3, 3]``."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.empty(q.shape[:-1] + (3, 3), np.float64)
    m[..., 0, 0] = 1 - 2 * (yy + zz)
    m[..., 0, 1] = 2 * (xy - wz)
    m[..., 0, 2] = 2 * (xz + wy)
    m[..., 1, 0] = 2 * (xy + wz)
    m[..., 1, 1] = 1 - 2 * (xx + zz)
    m[..., 1, 2] = 2 * (yz - wx)
    m[..., 2, 0] = 2 * (xz - wy)
    m[..., 2, 1] = 2 * (yz + wx)
    m[..., 2, 2] = 1 - 2 * (xx + yy)
    return m


def euler_xyz_to_matrix(angles) -> np.ndarray:
    """Extrinsic-xyz Euler ``[..., 3]`` (radians) -> ``[..., 3, 3]``.

    ``R = Rz(c) @ Ry(b) @ Rx(a)`` -- scipy's ``Rotation.from_euler('xyz')``.
    """
    a = np.asarray(angles, np.float64)
    ca, cb, cc = np.cos(a[..., 0]), np.cos(a[..., 1]), np.cos(a[..., 2])
    sa, sb, sc = np.sin(a[..., 0]), np.sin(a[..., 1]), np.sin(a[..., 2])
    m = np.empty(a.shape[:-1] + (3, 3), np.float64)
    m[..., 0, 0] = cc * cb
    m[..., 0, 1] = cc * sb * sa - sc * ca
    m[..., 0, 2] = cc * sb * ca + sc * sa
    m[..., 1, 0] = sc * cb
    m[..., 1, 1] = sc * sb * sa + cc * ca
    m[..., 1, 2] = sc * sb * ca - cc * sa
    m[..., 2, 0] = -sb
    m[..., 2, 1] = cb * sa
    m[..., 2, 2] = cb * ca
    return m


def matrix_to_euler_xyz(mat) -> np.ndarray:
    """``[..., 3, 3]`` -> extrinsic-xyz Euler ``[..., 3]`` (radians).

    Inverse of :func:`euler_xyz_to_matrix`; matches scipy's
    ``Rotation.from_matrix(m).as_euler('xyz')`` away from the gimbal lock
    at ``|b| = pi/2``.
    """
    m = np.asarray(mat, np.float64)
    b = np.arctan2(-m[..., 2, 0],
                   np.hypot(m[..., 0, 0], m[..., 1, 0]))
    a = np.arctan2(m[..., 2, 1], m[..., 2, 2])
    c = np.arctan2(m[..., 1, 0], m[..., 0, 0])
    return np.stack([a, b, c], axis=-1)


# ---------------------------------------------------------------------------
# reference converter family (utils/util.py:300-471)
# ---------------------------------------------------------------------------

def trans_qrot_to_matrix(trans, rot) -> np.ndarray:
    """Translation + quaternion -> 4x4 camera matrix (util.py:300-308)."""
    trans = np.asarray(trans, np.float64)
    mat = np.broadcast_to(np.eye(4), trans.shape[:-1] + (4, 4)).copy()
    mat[..., :3, :3] = quat_to_matrix(rot)
    mat[..., :3, 3] = trans
    return mat


def transformation_matrix_to_translation_and_rotation(
    mat,
) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 -> (euler_xyz rotation, translation) (util.py:310-314)."""
    mat = np.asarray(mat, np.float64)
    return matrix_to_euler_xyz(mat[..., :3, :3]), mat[..., :3, 3]


def transform_pose(pose, matrix) -> np.ndarray:
    """Apply a homogeneous 4x4 to ``[..., J, 3]`` points (util.py:324-335,
    covering both the numpy and torch variants)."""
    pose = np.asarray(pose, np.float64)
    matrix = np.asarray(matrix, np.float64)
    return pose @ matrix[..., :3, :3].swapaxes(-1, -2) + matrix[..., None, :3, 3]


def global_skeleton_2_local_skeleton(global_pose, world_2_cam_mat) -> np.ndarray:
    """World-frame joints -> camera-frame, HOMOGENEOUS output ``[J, 4]``
    (the reference returns the un-truncated homogeneous rows,
    util.py:319-322)."""
    global_pose = np.asarray(global_pose, np.float64)
    homo = np.concatenate(
        [global_pose, np.ones_like(global_pose[..., :1])], axis=-1
    )
    return homo @ np.asarray(world_2_cam_mat, np.float64).swapaxes(-1, -2)


def get_concecutive_global_cam(cam_seq, last_cam) -> np.ndarray:
    """Rebase a camera-pose sequence so its first frame lands on ``last_cam``
    (sequence stitching; util.py:337-345). Vectorized over the sequence."""
    cam_seq = np.asarray(cam_seq, np.float64)
    rebase = np.asarray(last_cam, np.float64) @ np.linalg.inv(cam_seq[0])
    return rebase @ cam_seq


def get_relative_global_pose(local_pose_list, camera_pose_list) -> list:
    """Per-frame local poses + ``{'loc', 'rot'}`` camera dicts -> poses in
    the FIRST frame's camera coordinates (util.py:347-358)."""
    mats = np.stack([
        trans_qrot_to_matrix(c["loc"], c["rot"]) for c in camera_pose_list
    ])
    rel = get_relative_global_pose_with_camera_matrix(local_pose_list, mats)
    return list(rel)


def get_relative_global_pose_with_camera_matrix(
    local_pose_list, camera_pose_list
) -> np.ndarray:
    """Same as :func:`get_relative_global_pose` with explicit 4x4 matrices
    (util.py:360-372 and the torch variant :386-397), vectorized."""
    local = np.asarray(local_pose_list, np.float64)  # (T, J, 3)
    cams = np.asarray(camera_pose_list, np.float64)  # (T, 4, 4)
    cam0_inv = np.linalg.inv(cams[0])
    i_to_0 = cam0_inv @ cams  # (T, 4, 4)
    return transform_pose(local, i_to_0)


def get_global_pose_from_relative_global_pose(
    relative_global_pose_list, initial_camera_matrix
) -> np.ndarray:
    """Undo :func:`get_relative_global_pose` given the first camera matrix
    (util.py:374-379)."""
    return transform_pose(
        np.asarray(relative_global_pose_list, np.float64),
        initial_camera_matrix,
    )


def get_relative_camera_matrix(camera_pose_1, camera_pose_2) -> np.ndarray:
    """``inv(cam1) @ cam2`` (util.py:381-384)."""
    return np.linalg.inv(np.asarray(camera_pose_1, np.float64)) @ np.asarray(
        camera_pose_2, np.float64
    )


def get_relative_transform(location1, rotation1, location2, rotation2):
    """Blender cam 1 and 2 -> (euler, translation, 4x4) of cv2->cv1
    (util.py:400-409)."""
    _, _, mat_world2cv1 = get_cv_rt_from_blender(location1, rotation1)
    _, _, mat_world2cv2 = get_cv_rt_from_blender(location2, rotation2)
    mat_cv1_to_cv2 = np.linalg.inv(mat_world2cv1) @ mat_world2cv2
    mat_cv2_to_cv1 = np.linalg.inv(mat_cv1_to_cv2)
    rotation, translation = transformation_matrix_to_translation_and_rotation(
        mat_cv2_to_cv1
    )
    return rotation, translation, mat_cv2_to_cv1


def _transform_relative_to_base(mat_world2cv_base, R_world2cv2, location):
    location_cv_homo = np.concatenate(
        [np.asarray(location, np.float64), np.ones(1)]
    )
    R_base = mat_world2cv_base[:3, :3]
    R_cv2_2_base = R_world2cv2.T @ R_base
    new_rotation_euler = matrix_to_euler_xyz(R_cv2_2_base)
    new_location = (mat_world2cv_base @ location_cv_homo)[:3]
    return new_location, new_rotation_euler


def get_transform_relative_to_base_cv(base_location, base_rotation,
                                      location, rotation):
    """Express an OpenCV-convention camera relative to a base camera
    (util.py:412-424)."""
    _, _, mat_base = get_cv_rt_from_cv(base_location, base_rotation)
    _, R2, _ = get_cv_rt_from_cv(location, rotation)
    return _transform_relative_to_base(mat_base, R2, location)


def get_transform_relative_to_base_blender(base_location, base_rotation,
                                           location, rotation):
    """Blender flavor of :func:`get_transform_relative_to_base_cv`
    (util.py:426-438)."""
    _, _, mat_base = get_cv_rt_from_blender(base_location, base_rotation)
    _, R2, _ = get_cv_rt_from_blender(location, rotation)
    return _transform_relative_to_base(mat_base, R2, location)


_R_BCAM2CV = np.diag([1.0, -1.0, -1.0])


def get_cv_rt_from_blender(location, rotation):
    """Blender camera pose (location + extrinsic-xyz Euler) -> OpenCV
    world->cam (T, R, 4x4) (util.py:440-459): transpose to world->cam, then
    flip Y/Z from Blender's -Z-forward/+Y-up to OpenCV's +Z-forward/-Y-up."""
    R_world2bcam = euler_xyz_to_matrix(rotation).T
    T_world2bcam = -R_world2bcam @ np.asarray(location, np.float64)
    R_world2cv = _R_BCAM2CV @ R_world2bcam
    T_world2cv = _R_BCAM2CV @ T_world2bcam
    mat = np.eye(4)
    mat[:3, :3] = R_world2cv
    mat[:3, 3] = T_world2cv
    return T_world2cv, R_world2cv, mat


def get_cv_rt_from_cv(location, rotation):
    """OpenCV-convention camera pose -> world->cam (T, R, 4x4)
    (util.py:461-471)."""
    R_world2cv = euler_xyz_to_matrix(rotation).T
    T_world2cv = -R_world2cv @ np.asarray(location, np.float64)
    mat = np.eye(4)
    mat[:3, :3] = R_world2cv
    mat[:3, 3] = T_world2cv
    return T_world2cv, R_world2cv, mat
