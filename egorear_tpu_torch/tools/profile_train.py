"""Profile the flagship's stage-3 train step (the JAX package's
``tools/profile_train.py``): the JAX tools' step (:class:`~egorear_tpu_torch.
tools.common.ProbeStep`: loss and gradient through the lazy sampling
kernels, clipping, AdamW; fp32 masters, bf16 compute in ``bf16-mixed``, BN
running stats updated), its steady-state ms/step, then a ``torch.profiler``
trace of a few steps: device time by kernel, the forward / backward /
optimizer split (by the program's ``train.*`` spans) and the span buckets
of ``profile_fwd`` (``fwd+`` and ``bwd`` of each).

    python -m egorear_tpu_torch.tools.profile_train [batch] [precision] [--remat]
        [--image-size 256] [--device cpu]

Defaults: batch 32, ``bf16-mixed`` (any ``bf16*`` string; ``fp32``,
``32`` or ``32-true`` for fp32), 256 px, on the card (without CUDA it
raises unless ``--device cpu``). ``--remat`` recomputes the loss's
activations in the backward.
"""

from __future__ import annotations

import argparse
import collections

import torch

from egorear_tpu_torch.tools.common import ProbeStep, card_line, tool_device
from egorear_tpu_torch.tools.profile_fwd import aggregate, print_tables, steady_ms, trace


def step_batch(batch: int, image_size: int, device: torch.device, seed: int = 0):
    """The JAX tool's seeded batch: images ~ N(0, 1), 3D poses ~ N(0, 30 cm),
    heatmaps ~ U(0, 1) at 1/4 of the image size."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = image_size // 4
    img = torch.randn(batch, 4, 3, image_size, image_size, generator=gen, device=device)
    gt_pose = torch.randn(batch, 16, 3, generator=gen, device=device) * 30
    gt_hm = torch.rand(batch, 4, 15, h, h, generator=gen, device=device)
    return img, gt_pose, gt_hm


def train_step(batch: int, precision: str, device, image_size: int = 256,
               remat: bool = False, lr: float = 1e-3):
    """(ProbeStep, batch tensors) of the flagship built from seed 0."""
    from egorear_tpu_torch import entry

    if not (precision.startswith("bf16") or precision in ("fp32", "32", "32-true")):
        raise ValueError(f"precision {precision!r}: bf16* or fp32")
    model, rig = entry.build((image_size, image_size), device=device, seed=0)
    return (ProbeStep(model, rig, lr=lr, precision=precision, remat=remat),
            step_batch(batch, image_size, device))


def profile_train_step(batch: int = 32, precision: str = "bf16-mixed",
                       device=None, image_size: int = 256, remat: bool = False,
                       timed: int = 10, traced: int = 3, quiet: bool = False) -> dict:
    """Time ``timed`` steps after one warm-up, then trace ``traced`` more
    (the program's spans on); prints the lines and returns ``{ms, steps, traced,
    card, losses, total, kernels, buckets, phases}`` (us over the trace;
    ``buckets`` keyed ``fwd+ <bucket>`` and ``bwd <bucket>``)."""
    device = tool_device(device, "profile_train")
    step, args = train_step(batch, precision, device, image_size, remat)
    card = card_line(device)
    losses = []

    def one():
        losses.append(step(*args)["loss"])

    ms = steady_ms(one, device, timed)
    if not quiet:
        print(f"steady state: {ms:.3f} ms/step  {batch * 1e3 / ms:.1f} samples/s "
              f"(batch {batch}, {precision}{', remat' if remat else ''}, "
              f"{image_size} px) | {card}", flush=True)
    prof = trace(one, traced, device)
    agg = aggregate_step(prof, device)
    if not quiet:
        print_tables(agg, traced, "step", card)
        print("\nphase split (us/step):")
        for k, v in agg["phases"].most_common():
            print(f"{v / traced:>12.1f}  {100.0 * v / agg['total']:>5.1f}  {k}")
    return dict(ms=ms, steps=1 + timed + traced, traced=traced, card=card,
                losses=[float(x) for x in losses], **agg)


def aggregate_step(prof, device) -> dict:
    """:func:`~egorear_tpu_torch.tools.profile_fwd.aggregate` of a train
    step's trace with each scope bucket split into its forward (``fwd+``)
    and backward (``bwd``) share, and the update (the ``train.reduce``,
    ``train.clip`` and ``train.optimizer`` spans) as ``fwd+ optimizer``."""
    agg = aggregate(prof, device)
    split = collections.Counter()
    for (phase, bucket), us in agg["phase_buckets"].items():
        if phase == "optimizer":
            bucket = "optimizer"
        split[f"{'bwd' if phase == 'backward' else 'fwd+'} {bucket}"] += us
    agg["buckets"] = split
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=32)
    ap.add_argument("precision", nargs="?", default="bf16-mixed")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    return profile_train_step(args.batch, args.precision, args.device,
                              args.image_size, args.remat)


if __name__ == "__main__":
    main()
