"""Skeleton meshes of 16-joint poses as Wavefront OBJ (the JAX package's
``utils/skeleton.py``: ``skeleton_mesh``, ``save_obj``, ``export_pose_obj``
and their sphere and cylinder primitives), for ``Trainer.predict``'s
``save_obj``. The reference draws them with open3d; the meshes are built
here directly."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

# parent[i] = index of joint i's parent (-1: the root, Neck), in the order
# of data.datasets.JOINT_NAMES.
PARENTS = (1, -1, 1, 1, 2, 3, 4, 5, 1, 1, 8, 9, 10, 11, 12, 13)
BONES = tuple((p, i) for i, p in enumerate(PARENTS) if p >= 0)


def _uv_sphere(center, radius, n=8):
    verts, faces = [], []
    for i in range(n + 1):
        theta = np.pi * i / n
        for j in range(2 * n):
            phi = 2 * np.pi * j / (2 * n)
            verts.append(center + radius * np.array([
                np.sin(theta) * np.cos(phi),
                np.sin(theta) * np.sin(phi),
                np.cos(theta),
            ]))
    cols = 2 * n
    for i in range(n):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            c = (i + 1) * cols + j
            d = (i + 1) * cols + (j + 1) % cols
            faces.append((a, c, b))
            faces.append((b, c, d))
    return np.asarray(verts), np.asarray(faces)


def _cylinder(p0, p1, radius, n=8):
    axis = p1 - p0
    h = np.linalg.norm(axis)
    if h < 1e-9:
        return np.zeros((0, 3)), np.zeros((0, 3), int)
    z = axis / h
    ref = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(z, ref)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    verts, faces = [], []
    for base in (p0, p1):
        for j in range(n):
            phi = 2 * np.pi * j / n
            verts.append(base + radius * (np.cos(phi) * x + np.sin(phi) * y))
    for j in range(n):
        a, b = j, (j + 1) % n
        c, d = n + j, n + (j + 1) % n
        faces.append((a, c, b))
        faces.append((b, c, d))
    return np.asarray(verts), np.asarray(faces, int)


def skeleton_mesh(joints: np.ndarray, joint_radius: float = 1.5,
                  bone_radius: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """(16, 3) joints -> (verts, faces): a sphere per joint and a cylinder
    per bone, in the joints' units."""
    all_v, all_f = [], []
    offset = 0
    for j in joints:
        v, f = _uv_sphere(np.asarray(j, float), joint_radius)
        all_v.append(v)
        all_f.append(f + offset)
        offset += len(v)
    for p, c in BONES:
        v, f = _cylinder(np.asarray(joints[p], float),
                         np.asarray(joints[c], float), bone_radius)
        if len(v):
            all_v.append(v)
            all_f.append(f + offset)
            offset += len(v)
    return np.concatenate(all_v), np.concatenate(all_f)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")


def export_pose_obj(path: str, joints: np.ndarray, **kw) -> str:
    verts, faces = skeleton_mesh(joints, **kw)
    save_obj(path, verts, faces)
    return path
