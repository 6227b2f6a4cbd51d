"""The 16-joint skeleton (the JAX package's ``utils/skeleton.py``, after the
reference's ``pose_estimation/utils/skeleton.py``), host-side numpy: the
kinematic tree, per-bone lengths and their renormalisation against a
template, Gaussian temporal smoothing, the numpy argmax decode of heatmaps,
and skeleton meshes as Wavefront OBJ for ``Trainer.predict``'s
``save_obj`` (the reference draws them with open3d; the meshes are built
here directly)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from egorear_tpu_torch.data.datasets import JOINT_NAMES  # noqa: F401

# parent[i] = index of joint i's parent (-1: the root, Neck), in the order
# of JOINT_NAMES.
PARENTS = (1, -1, 1, 1, 2, 3, 4, 5, 1, 1, 8, 9, 10, 11, 12, 13)
BONES = tuple((p, i) for i, p in enumerate(PARENTS) if p >= 0)


def bone_lengths(joints: np.ndarray) -> np.ndarray:
    """(..., 16, 3) -> (..., num_bones) per-bone lengths, in BONES order."""
    a = joints[..., [b[0] for b in BONES], :]
    b = joints[..., [b[1] for b in BONES], :]
    return np.linalg.norm(b - a, axis=-1)


def renormalize_bone_lengths(joints: np.ndarray,
                             template: np.ndarray) -> np.ndarray:
    """Each bone rescaled to the template's length along its own direction,
    walking the tree from the root; a bone's change moves its child and all
    the child's descendants. float64 (the reference's skeleton.py:163-174)."""
    out = np.array(joints, dtype=np.float64, copy=True)
    t_len = bone_lengths(template)
    order = sorted(range(len(BONES)), key=lambda i: BONES[i][1])
    for bi in order:
        p, c = BONES[bi]
        vec = out[..., c, :] - out[..., p, :]
        norm = np.linalg.norm(vec, axis=-1, keepdims=True)
        norm = np.maximum(norm, 1e-9)
        delta = vec / norm * t_len[..., bi, None] - vec
        stack = [c]
        while stack:
            j = stack.pop()
            out[..., j, :] += delta
            stack.extend(i for i, pp in enumerate(PARENTS) if pp == j)
    return out


def smooth_temporal(seq: np.ndarray, sigma: float = 1.0,
                    radius: Optional[int] = None) -> np.ndarray:
    """Gaussian smoothing along the time axis of a (T, J, 3) sequence, the
    ends padded by repetition; radius 3 sigma (at least 1) unless given
    (the reference's skeleton.py:219-227). Sums in float64, returned in the
    sequence's dtype."""
    T = seq.shape[0]
    radius = radius if radius is not None else max(1, int(3 * sigma))
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    pad = np.concatenate(
        [seq[:1].repeat(radius, 0), seq, seq[-1:].repeat(radius, 0)], axis=0)
    out = np.zeros_like(seq, dtype=np.float64)
    for i, w in enumerate(k):
        out += w * pad[i:i + T]
    return out.astype(seq.dtype)


def decode_heatmaps_np(heatmaps: np.ndarray, threshold: float = 0.0):
    """(J, H, W) -> ((J, 2) float32 (x, y) of each map's first maximum, its
    peak values, peak >= threshold) (the reference's skeleton.py:229-253)."""
    J, H, W = heatmaps.shape
    flat = heatmaps.reshape(J, -1)
    idx = flat.argmax(axis=1)
    maxv = flat.max(axis=1)
    pts = np.stack([idx % W, idx // W], axis=-1).astype(np.float32)
    return pts, maxv, maxv >= threshold


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
