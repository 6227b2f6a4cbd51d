"""FLOP count of the flagship 4-view forward (the JAX package's
``tools/flops_count.py``), on the CPU.

    python -m egorear_tpu_torch.tools.flops_count [batch] [image_size]

Defaults: batch 4, 256 px. Runs the fp32 full-cascade forward once (seeded
random weights, eval mode, zero images) on the CPU under
``torch.utils.flop_counter.FlopCounterMode`` and prints the total, the
figure per frame (one 4-view sample), the count by operator family and by
the cascade's three parts.

What it counts: the matmul family (``mm``, ``addmm``, ``bmm`` and the
attention products) and the convolutions, two FLOPs a multiply-add, as
``FlopCounterMode`` does. What it leaves out: elementwise work (norms,
activations, softmax, the sampling's weighting and sums) and
``F.grid_sample`` in the plain lazy sampling, which the counter does not
know. The JAX tool reports XLA's cost model, which counts elementwise work
and its own formulation of the sampling, so the two differ both ways (the
JAX package's 3.39 GFLOP a frame at 64 px and 53.26 at 256 px, this tool's
3.51 and 50.72, both on the CPU).
"""

from __future__ import annotations

import argparse
import collections
import re

import torch
from torch.utils.flop_counter import FlopCounterMode

# Operator families of the counter's keys (``aten.<op>``).
FAMILIES = {"convolution": "conv", "mm": "matmul", "addmm": "matmul",
            "bmm": "matmul", "baddbmm": "matmul"}
# The counter's module paths of the cascade's parts: stage 1 with its heads
# is the heatmap estimator less its MVFex refiners (each called alone).
STAGE12, POSE3D = "EgoRearNet.heatmap_estimator", "EgoRearNet.pose3d_estimator"
REFINER = re.compile(r"EgoRearNet\.heatmap_estimator\.refiners\.\d+")


def _family(op) -> str:
    name = str(op).split(".")[-1]
    return FAMILIES.get(name, "attention" if "attention" in name else name)


def count(batch: int = 4, image_size: int = 256) -> dict:
    """``{total, by_family, by_part}`` FLOPs of one fp32 forward of
    ``batch`` frames on the CPU."""
    from egorear_tpu_torch import entry

    model, rig = entry.build((image_size, image_size), device="cpu", seed=0)
    img = torch.zeros(batch, 4, 3, image_size, image_size)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(img, rig)
    counts = counter.get_flop_counts()
    by_family = collections.Counter()
    for op, n in counts["Global"].items():
        by_family[_family(op)] += n
    stage12, pose3d = (sum(counts.get(k, {}).values()) for k in (STAGE12, POSE3D))
    refiners = sum(sum(c.values()) for k, c in counts.items() if REFINER.fullmatch(k))
    by_part = collections.Counter({"stage 1 + heads": stage12 - refiners,
                                   "mvfex refiners": refiners, "pose3d": pose3d})
    total = counter.get_total_flops()
    by_part["other"] = total - sum(by_part.values())
    return dict(total=total, by_family=by_family, by_part=by_part)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=4)
    ap.add_argument("image_size", nargs="?", type=int, default=256)
    args = ap.parse_args(argv)
    out = count(args.batch, args.image_size)
    flops, batch = out["total"], args.batch
    print(f"batch {batch}, image {args.image_size}px")
    print(f"total  : {flops / 1e9:.2f} GFLOP")
    print(f"/frame : {flops / batch / 1e9:.2f} GFLOP "
          f"(frame = one 4-view sample, full cascade)")
    for title, key in (("by operator family", "by_family"), ("by part", "by_part")):
        print(f"{title} (GFLOP/frame):")
        for name, n in out[key].most_common():
            print(f"  {name:16s} {n / batch / 1e9:8.3f}")
    return out


if __name__ == "__main__":
    main()
