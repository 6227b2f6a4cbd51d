"""The stage-2 (MVFex) heatmap evaluation split by per-pair joint visibility
(the JAX package's ``tools/eval_occlusion_split.py``).

The occlusion curriculum (``run_curriculum --occlusion``) hides each
joint's image blob from the front or the back stereo pair while its
ground-truth heatmap stays, so a hidden joint can be recovered only through
the cross-pair feature exchange of the MVFex refiners. The aggregate
``mse_pts2d`` averages visible and occluded joints and can hide the
refiners' effect, so this tool reads a stage-2 checkpoint and the tree's
per-sequence ``visibility.npy`` (F, 4, 16) and reports the argmax point
error of the initial (``hms[0]``) and the refined (``hms[-1]``) heatmaps
per pair, for the joints visible in that pair and for those hidden from it
(never from both).

    python -m egorear_tpu_torch.tools.eval_occlusion_split --ckpt <epoch=N.pt>
        --data-root <tree> [--split validation] [--config <stage-2 yaml>]
        [--batch 4] [--limit 0] [--device cpu] [--out report.json]

The checkpoint is the port's ``epoch=N.pt`` (or an EgoRear ``.ckpt``),
loaded into the config's task as ``run.py test`` loads it; the model runs
on the card unless ``--device cpu``. Prints the report as JSON
(``{front,back}_{visible,occluded}_{init,final}_mse_pts2d`` and
``..._final_over_init``) and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from egorear_tpu_torch.tools.common import tool_device

PAIRS = (("front", (0, 1)), ("back", (2, 3)))
TAGS = ("visible", "occluded")
STAGES = ("init", "final")


def new_sums() -> dict:
    """(pair, tag, stage) -> [sum of squared errors, count]."""
    return {(p, t, s): [0.0, 0] for p, _ in PAIRS for t in TAGS for s in STAGES}


def accumulate(sums: dict, err_init: np.ndarray, err_final: np.ndarray,
               visibility) -> None:
    """Add a batch to ``sums``: ``err_*`` (B, V, J) squared point errors
    (the mean over x and y), ``visibility`` B (V, J) bool arrays. A pair's
    joints split by the visibility of its first view (both views of a pair
    share it)."""
    for bi, vis in enumerate(visibility):
        for pair, views in PAIRS:
            pv = vis[views[0]]
            for stage, err in (("init", err_init), ("final", err_final)):
                for tag, mask in (("visible", pv), ("occluded", ~pv)):
                    if mask.any():
                        e = err[bi, list(views)][:, mask]
                        sums[(pair, tag, stage)][0] += float(e.sum())
                        sums[(pair, tag, stage)][1] += int(e.size)


def report(sums: dict, ckpt: str, split: str, frames: int) -> dict:
    """The report's keys: each class's mean squared error (3 decimals, None
    where no joint fell in it) and, where both are non-zero, final over
    init."""
    out = {"ckpt": ckpt, "split": split, "frames": frames}
    for pair, _ in PAIRS:
        for tag in TAGS:
            for stage in STAGES:
                s, c = sums[(pair, tag, stage)]
                out[f"{pair}_{tag}_{stage}_mse_pts2d"] = round(s / c, 3) if c else None
            i = out[f"{pair}_{tag}_init_mse_pts2d"]
            f = out[f"{pair}_{tag}_final_mse_pts2d"]
            if i and f:
                out[f"{pair}_{tag}_final_over_init"] = round(f / i, 3)
    return out


class FrameVisibility:
    """(V, 15) bool visibility of a frame (Head dropped, as in the targets),
    from its sequence's ``visibility.npy``; all visible without one."""

    def __init__(self):
        self._cache = {}

    def __call__(self, frame_path: str) -> np.ndarray:
        seq_dir = os.path.dirname(os.path.dirname(frame_path))
        if seq_dir not in self._cache:
            p = os.path.join(seq_dir, "visibility.npy")
            self._cache[seq_dir] = np.load(p) if os.path.exists(p) else None
        v = self._cache[seq_dir]
        if v is None:
            return np.ones((4, 15), bool)
        fi = int(os.path.basename(frame_path).split("_")[1].split(".")[0])
        return v[fi, :, 1:]


def evaluate_split(ckpt: str, data_root: str, split: str = "validation",
                   config: str = "configs/ego4view_syn_heatmap_mvfex-n1_jqa.yaml",
                   batch: int = 4, limit: int = 0, device=None) -> dict:
    """The report of ``ckpt`` on ``split`` of the tree (its first ``limit``
    frames when non-zero)."""
    from egorear_tpu_torch import run
    from egorear_tpu_torch.config.loader import load_config
    from egorear_tpu_torch.data.datasets import get_dataset
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    device = tool_device(device, "eval_occlusion_split")
    cfg = load_config(config, [
        "--model.data_root", data_root,
        # The checkpoint sets every parameter: no ImageNet weights needed.
        "--model.model_cfg.encoder_cfg.resnet_cfg.use_imagenet_pretrain", "false",
    ])
    task, targs = run.build_task(cfg, device)
    run.load_eval_ckpt(task, cfg, ckpt)
    model = task.model.eval()
    ds = get_dataset(targs["dataset_type"], data_root, split,
                     render_missing_heatmaps=True, cache_in_memory=False)
    n = len(ds) if not limit else min(limit, len(ds))
    print(f"{split} frames: {n} (of {len(ds)})", flush=True)

    def points(hm):
        return argmax_2d(hm, threshold=1.0, normalize=False)[0]

    visibility = FrameVisibility()
    sums = new_sums()
    for start in range(0, n, batch):
        items = [ds[i] for i in range(start, min(start + batch, n))]
        img = torch.from_numpy(np.stack([it["img"] for it in items])).to(device)
        gt = torch.from_numpy(np.stack([it["gt_heatmap"] for it in items])).to(device)
        with torch.no_grad():
            hms, _ = model(img)
            gtp = points(gt)
            err_i = ((points(hms[0]) - gtp) ** 2).mean(-1).cpu().numpy()
            err_f = ((points(hms[-1]) - gtp) ** 2).mean(-1).cpu().numpy()
        accumulate(sums, err_i, err_f, [visibility(it["frame_path"]) for it in items])
        print(f"  {start + len(items)}/{n}", flush=True)
    return report(sums, ckpt, split, n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--config",
                    default="configs/ego4view_syn_heatmap_mvfex-n1_jqa.yaml")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="validation")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the number of frames (0 = all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    out = evaluate_split(args.ckpt, args.data_root, args.split, args.config,
                         args.batch, args.limit, args.device)
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
