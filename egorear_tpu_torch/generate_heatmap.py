"""Offline precompute of the ground-truth heatmaps (the repository's root
``generate_heatmap.py``, same flags and output):

    python -m egorear_tpu_torch.generate_heatmap --data_dir_path <root> \\
        --dataset_type {rw,syn} [--device cpu]

For every frame JSON it renders the 16-joint Gaussian targets (64 x 64,
sigma 1, from the 872-px 2D joints) of all four cameras and saves
``fisheye_hm/<camera>/<frame>.npy`` (16, 64, 64) float32. The renderer is
:func:`~egorear_tpu_torch.ops.heatmap.render_gaussian_targets`, the one the
on-device preprocessing uses, over up to ``FRAMES_PER_CALL`` frames of a
sequence at once; it runs on the card unless ``--device cpu`` is given
(without CUDA it raises).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from egorear_tpu_torch.data.datasets import CAMERA_NAMES, JOINT_NAMES
from egorear_tpu_torch.ops.heatmap import render_gaussian_targets
from egorear_tpu_torch.train.tasks import resolve_device
from egorear_tpu_torch.utils.logging import get_logger

logger = get_logger("generate_heatmap")

# (sequence glob under the data root, frame JSON directory) per dataset type.
LAYOUTS = {"rw": ("2024*/S*/seq*", "json_smplx"),
           "syn": ("rp*/*", "json_smplx_gendered")}
FRAMES_PER_CALL = 256  # 1 MiB of targets a frame


def _joints(json_path: str) -> np.ndarray:
    with open(json_path) as f:
        data = json.load(f)
    return np.array([[data["joints"][j][f"{cam}_pts2d"] for j in JOINT_NAMES]
                     for cam in CAMERA_NAMES], np.float32)  # (4, 16, 2)


def process_sequence(frames: List[str], json_dir_name: str,
                     device: torch.device) -> None:
    """Render and save the heatmaps of ``frames`` (one sequence's JSONs)."""
    for i in range(0, len(frames), FRAMES_PER_CALL):
        chunk = frames[i:i + FRAMES_PER_CALL]
        joints = torch.from_numpy(np.stack([_joints(p) for p in chunk])).to(device)
        targets, _ = render_gaussian_targets(joints, image_size=872,
                                             heatmap_size=64, sigma=1.0)
        for json_path, per_camera in zip(chunk, targets.cpu().numpy()):
            for cam, hm in zip(CAMERA_NAMES, per_camera):  # (16, 64, 64)
                out = os.path.join(
                    os.path.dirname(json_path).replace(json_dir_name, "fisheye_hm"),
                    cam, os.path.basename(json_path).replace(".json", ".npy"))
                os.makedirs(os.path.dirname(out), exist_ok=True)
                np.save(out, hm)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir_path", type=str, required=True)
    parser.add_argument("--dataset_type", type=str, choices=["rw", "syn"],
                        default="rw")
    parser.add_argument("--device", default=None,
                        help="render on this device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "generate_heatmap")
    seq_glob, json_dir_name = LAYOUTS[args.dataset_type]
    seq_dirs = sorted(glob.glob(os.path.join(args.data_dir_path, seq_glob)))
    logger.info(f"{len(seq_dirs)} sequences on {device}")
    for seq in seq_dirs:
        frames = sorted(glob.glob(os.path.join(seq, json_dir_name, "*.json")))
        logger.info(f"{seq}: {len(frames)} frames")
        process_sequence(frames, json_dir_name, device)
    logger.info("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
