"""The readings that a cell's comparison limits are set from, on the card,
in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [--first <seed>]
        [--seconds 3] [--out <file.jsonl>]

For each seed: the program's numbers from a short run of the cell (the
lower readings), and the control's: the reference computed with TF32 on,
put in the program's place and compared with the fp32 reference (the
upper readings). For a training cell also the fault of a step on half of
the batch, planted in the reference. One JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import run as prun
from portbench import window
from portbench.reference import compare, weights


def control_serve(cell, seed, dev):
    """The serve numbers of the TF32 reference against the fp32 one, on the
    sampled count of pool batches."""
    kind = prun.load_module(cell.kind_path)
    p = cell.traffic
    conf = cell.config
    task_name, mc = conf["task"], conf["model"]["init_args"]["model_cfg"]
    size = mc["image_size"][0]
    pool = weights.seeded_batches(seed, dev, p["pool"], p["batch"], image_size=size,
                                  heatmap_size=size // 4)
    picks = list(range(min(p["sample"], p["pool"])))
    outs = kind.reference_outputs(task_name, mc, seed, dev, [pool[k]["img"] for k in picks],
                                  tf32=True)
    r = prun.Run(cell, seed, 0, False, dev)
    return kind.check(r, task_name, mc, pool, {k: (o[0], o[1]) for k, o in zip(picks, outs)},
                      dev)


def control_train(cell, seed, dev):
    kind = prun.load_module(cell.kind_path)
    p, conf = cell.traffic, cell.config
    size = conf["model"]["init_args"]["model_cfg"]["image_size"][0]
    pool = weights.seeded_batches(seed, dev, p["followed"], p["batch"], image_size=size,
                                  heatmap_size=size // 4)
    ref = kind.follow(conf, seed, pool, p["steps_per_epoch"], dev)
    out = {"control": compare.train_numbers(
        kind.follow(conf, seed, pool, p["steps_per_epoch"], dev, tf32=True), ref)}
    half = [{k: v[: p["batch"] // 2] for k, v in b.items()} for b in pool]
    out["fault_half_batch"] = compare.train_numbers(
        kind.follow(conf, seed, half, p["steps_per_epoch"], dev), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=4_100_000_001)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = json.loads((prun.ROOT / "BENCHMARK.json").read_text())
    cell = prun.Cell(args.workload, spec)
    dev = torch.device("cuda", 0)
    with open(args.out, "a") if args.out else contextlib.nullcontext() as sink:
        for i in range(args.seeds):
            read_seed(cell, args.first + 7919 * i, i < args.control, args.seconds, dev, sink)
    return 0


def read_seed(cell, seed, control, seconds, dev, sink):
    """One seed's readings, printed and (with ``sink``) appended."""
    result, _ = prun.execute(cell, seed, seconds, False, dev)
    lines = [{"seed": seed, "reading": "program",
              "numbers": {k: v["value"] for k, v in result["checks"].items()}}]
    window.release(dev)
    if control:
        if cell.traffic["kind"] == "serve":
            lines.append({"seed": seed, "reading": "control",
                          "numbers": control_serve(cell, seed, dev)})
        else:
            for name, numbers in control_train(cell, seed, dev).items():
                lines.append({"seed": seed, "reading": name, "numbers": numbers})
        window.release(dev)
    for line in lines:
        text = json.dumps(dict(line, cell=cell.name))
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()


if __name__ == "__main__":
    sys.exit(main())
