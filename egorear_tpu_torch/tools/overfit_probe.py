"""Fixed-batch overfit probe of the pose3d stage (the JAX package's
``tools/overfit_probe.py``).

Tells "step budget" from "pipeline bug" when the 3D error plateaus at the
predicts-the-mean floor: memorising one small batch must drive the MPJPE
far below the batch's floor if, and only if, the gradients connect the
images to the 3D targets. It reads ``ego4view_syn_pose3d`` items through
the port's ``get_dataset`` and trains the flagship (seeded random weights,
fp32) on them with the JAX tools' step
(:class:`~egorear_tpu_torch.tools.common.ProbeStep`), on the card unless
``--device cpu``.

    python -m egorear_tpu_torch.tools.overfit_probe --data <syn tree>
        [--image-size 256] [--batch 8] [--steps 2000] [--lr 1e-3]
        [--full-training] [--device cpu]

Prints the batch's shapes and mean-prediction MPJPE floor, then
``hm_loss``, ``final_mpjpe`` and ``proposal_mpjpe`` every 100 steps and at
the last one.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from egorear_tpu_torch.tools.common import ProbeStep, tool_device


def probe_batch(data: str, image_size: int, batch: int, device):
    """The first ``batch`` train items of the tree at ``data`` as (img,
    gt_pose, gt_heatmap) on ``device``."""
    from egorear_tpu_torch.data.datasets import get_dataset

    ds = get_dataset("ego4view_syn_pose3d", data, "train", image_size=image_size)
    samples = [ds[i] for i in range(batch)]
    return tuple(torch.from_numpy(np.stack([s[k] for s in samples])).to(device)
                 for k in ("img", "gt_pose", "gt_heatmap"))


def overfit(data: str, image_size: int = 256, batch: int = 8, steps: int = 2000,
            lr: float = 1e-3, full_training: bool = False, device=None,
            every: int = 100) -> dict:
    """Run the probe; prints its lines and returns ``{floor_mm, records,
    step, batch}``: ``records`` the (step, hm_loss, final_mpjpe mm,
    proposal_mpjpe mm) of every step, ``step`` the ProbeStep and ``batch``
    its (img, gt_pose, gt_heatmap)."""
    from egorear_tpu_torch import entry

    device = tool_device(device, "overfit_probe")
    img, gt_pose, gt_hm = probe_batch(data, image_size, batch, device)
    print(f"batch img {tuple(img.shape)} hm {tuple(gt_hm.shape)} pose "
          f"{tuple(gt_pose.shape)}")
    # The predicts-the-mean floor of this batch (cm).
    mean_pose = gt_pose.mean(dim=0, keepdim=True)
    floor = float(torch.linalg.vector_norm(gt_pose - mean_pose, dim=-1).mean())
    print(f"batch mean-prediction MPJPE floor: {floor * 10:.1f} mm")

    model, rig = entry.build((image_size, image_size), device=device, seed=0)
    if full_training:  # the estimators' backbones train too
        hm = model.heatmap_estimator
        hm.cfg = dataclasses.replace(hm.cfg, full_training=True)
    step = ProbeStep(model, rig, lr=lr, precision="32")
    terms = []
    for i in range(steps):
        out = step(img, gt_pose, gt_hm)
        terms.append((out["hm_loss"], out["mpjpe_final"], out["mpjpe_proposal"]))
        if i % every == 0 or i == steps - 1:
            l_hm, mpf, mpp = (float(t) for t in terms[-1])
            print(f"step {i:5d}  hm_loss {l_hm:8.4f}  final_mpjpe "
                  f"{mpf * 10:8.1f} mm  proposal_mpjpe {mpp * 10:8.1f} mm",
                  flush=True)
    records = [(i, float(h), float(f) * 10, float(p) * 10)
               for i, (h, f, p) in enumerate(terms)]
    return dict(floor_mm=floor * 10, records=records, step=step,
                batch=(img, gt_pose, gt_hm))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True,
                    help="an Ego4View syn tree with heatmap NPYs "
                         "(egorear_tpu_torch.data.synthetic)")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full-training", action="store_true",
                    help="train the estimators' backbones too (the flagship "
                         "already sets full_training)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    return overfit(args.data, args.image_size, args.batch, args.steps, args.lr,
                   args.full_training, args.device)


if __name__ == "__main__":
    main()
