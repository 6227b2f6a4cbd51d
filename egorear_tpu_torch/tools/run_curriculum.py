"""The three-stage training curriculum end to end through the port's CLI
(the JAX package's ``tools/run_curriculum.py``): fit stage 1 of the front
and of the back stereo pair, graft both into stage 2 (MVFex) and fit it,
test it, graft it into stage 3 (pose3d) and fit it, test it, as the
reference's README protocol chains them. Each stage is a ``python -m
egorear_tpu_torch.run`` subprocess on the shipped yaml with overrides for
the data, the epochs, the scaled lr milestones and the grafts.

It runs on a learnable synthetic tree (``egorear_tpu_torch.data.synthetic``
with ``draw_pose``: the images carry per-joint coloured blobs at the true
fisheye projections of the sampled 3D poses, so image -> heatmap -> 3D can
be learnt and the pose error can fall), built under ``--data-root`` unless
it holds one. ``--occlusion p`` hides each joint's blob from the front (or
the back) pair with probability p, never from both, and then also runs
``egorear_tpu_torch.tools.eval_occlusion_split`` on the stage-2
checkpoint (train and validation splits, 128 frames each) on the stages'
device while stage 3 trains.

Protocol deviations: ``warmup_iters`` shortened to ``--warmup`` (the
reference's 500 would span a short run) and ``use_imagenet_pretrain`` off
(blob images are far from ImageNet's).

    python -m egorear_tpu_torch.tools.run_curriculum [--frames 512]
        [--epochs 12] [--occlusion 0.25] [--out logs/curriculum]
        [--data-root <out>/data] [--device cpu] [--resume] [--report-only]

The stages run on the card unless ``--device cpu``. Each stage's log is
``<out>/<stage>.<subcommand>.log``; the report, from the stages' metrics,
test JSONs and the occlusion-split JSONs, is ``<out>/ACCURACY.md``.
"""

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import time

from egorear_tpu_torch.tools.common import tool_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_cli(args, env, log_path):
    t0 = time.time()
    with open(log_path, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "egorear_tpu_torch.run"] + args,
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=REPO,
            timeout=21600,
        )
    dt = time.time() - t0
    if proc.returncode != 0:
        tail = open(log_path).read()[-4000:]
        raise RuntimeError(f"egorear_tpu_torch.run {args[0]} failed ({dt:.0f}s):\n{tail}")
    return dt


def scaled_milestones(cfg_path, epochs):
    """Scale the config's MultiStep LR milestones to the actual epoch budget.

    The shipped configs carry the reference's 12-epoch schedule
    (lr_decay_epochs [8, 10] of max_epochs 12 -- fractions 2/3 and 5/6).
    With the raw milestones a run of 100 epochs would cut the LR 100x at
    epoch 10, so the reference's *fractional* schedule is kept at any epoch
    budget. None where the config has no milestones or the budget is its
    own.
    """
    import yaml

    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    model = (raw.get("model") or {}).get("init_args") or raw.get("model") or {}
    ms = model.get("lr_decay_epochs")
    ref_max = (raw.get("trainer") or {}).get("max_epochs")
    if not ms or not ref_max or not epochs or epochs == ref_max:
        return None
    return [max(1, round(m * epochs / ref_max)) for m in ms]


def newest_epoch(save_dir):
    hits = []
    for base, _dirs, files in os.walk(save_dir):
        for d in _dirs + files:
            m = re.match(r"epoch=(\d+)", d)
            if m:
                hits.append((int(m.group(1)), os.path.join(base, d)))
    return max(hits) if hits else None


def latest_ckpt(save_dir):
    hit = newest_epoch(save_dir)
    assert hit, f"no checkpoint under {save_dir}"
    return hit[1]


def read_metrics(save_dir):
    rows = []
    for base, _dirs, files in os.walk(save_dir):
        if "metrics.csv" in files:
            with open(os.path.join(base, "metrics.csv")) as f:
                rows.extend(list(csv.DictReader(f)))
    return rows


def series(rows, key):
    out = []
    for r in rows:
        if r.get(key):
            out.append((int(r["step"]), float(r[key])))
    return sorted(out)


def test_json(log_path):
    txt = open(log_path).read()
    for line in reversed(txt.splitlines()):
        line = line.strip()
        if line.startswith("{") and "test/" in line:
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    # multi-line json.dumps(indent=1)
    m = re.search(r"\{[^{}]*\"test/[^{}]*\}", txt, re.S)
    return json.loads(m.group(0)) if m else {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--eval-frames", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--epochs2", type=int, default=None,
                    help="stage-2 epochs (default: --epochs)")
    ap.add_argument("--epochs3", type=int, default=None,
                    help="stage-3 epochs (default: --epochs; the 3D head "
                         "needs by far the most steps)")
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--skeleton", action="store_true",
                    help="fixed-bone-length kinematic poses (skeletal prior)")
    ap.add_argument("--occlusion", type=float, default=0.0,
                    help="per-joint prob of hiding the blob from the front "
                         "(resp. back) stereo pair; makes multi-view "
                         "refinement necessary")
    ap.add_argument("--data-root", default=None,
                    help="the synthetic tree (default: <out>/data)")
    ap.add_argument("--out", default=os.path.join(REPO, "logs", "curriculum"))
    ap.add_argument("--device", default=None,
                    help="torch device of every stage and of the occlusion "
                         "split (default: cuda)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="override the configs' batch sizes (smoke runs on "
                         "sets smaller than the stock batch of 64/32)")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint every N epochs (a 256-px checkpoint "
                         "is ~1 GB)")
    ap.add_argument("--resume", action="store_true",
                    help="skip any fit stage whose save dir already holds a "
                         "checkpoint at the final epoch (crash recovery for "
                         "the multi-hour drive; partial stages rerun from "
                         "their grafts)")
    ap.add_argument("--report-only", action="store_true",
                    help="rebuild <out>/ACCURACY.md from the logs already under "
                         "--out (stage test jsons are read from the "
                         "*.test.log files) without running anything")
    args = ap.parse_args(argv)
    if args.data_root is None:
        args.data_root = os.path.join(args.out, "data")

    if args.report_only:
        out = args.out
        write_report(
            args, {},
            os.path.join(out, "s1_front"), os.path.join(out, "s1_back"),
            os.path.join(out, "s2_mvfex"), os.path.join(out, "s3_pose3d"),
            test_json(os.path.join(out, "s2_mvfex.test.log")),
            test_json(os.path.join(out, "s3_pose3d.test.log")),
        )
        return

    # Every stage runs on this device: refuse here rather than after the tree.
    tool_device(args.device, "run_curriculum")
    env = dict(os.environ)
    device = ["--device", args.device] if args.device else []

    # ---- data ----
    if not os.path.exists(os.path.join(args.data_root, "train.txt")):
        print(f"generating synthetic set ({args.frames} train frames, "
              f"{args.image_size}px, draw_pose, skeleton={args.skeleton}, "
              f"occlusion={args.occlusion})...", flush=True)
        from egorear_tpu_torch.data.synthetic import make_synthetic_dataset

        make_synthetic_dataset(
            args.data_root, "syn", num_chars=1, num_seqs=1,
            frames_per_seq=args.frames, image_size=args.image_size,
            write_heatmaps=True, draw_pose=True,
            eval_frames_per_seq=args.eval_frames,
            skeleton=args.skeleton, occlusion=args.occlusion,
        )
    os.makedirs(args.out, exist_ok=True)

    no_imnet = [
        "--model.model_cfg.encoder_cfg.resnet_cfg.use_imagenet_pretrain",
        "false",
    ]
    # pose3d nests the stage-2 encoder under heatmap_mvf_cfg.
    no_imnet3 = [
        "--model.model_cfg.heatmap_mvf_cfg.encoder_cfg.resnet_cfg"
        ".use_imagenet_pretrain",
        "false",
    ]
    common = [
        "--model.data_root", args.data_root,
        "--model.workers", str(args.workers),
        "--model.warmup_iters", str(args.warmup),
        "--trainer.log_every_n_steps", "8",
        # Epochs are decode-bound on the host and the synthetic set fits
        # in memory: decoded samples are cached after epoch 0.
        "--model.dataset_kwargs.cache_in_memory", "true",
        # uint8 views (a quarter of the fp32 bytes) go to the card, which
        # normalises them and renders the targets (tasks.prepare_batch).
        "--model.dataset_kwargs.device_preprocess", "true",
    ] + device
    if args.batch_size:
        common += ["--model.batch_size", str(args.batch_size)]
    timings = {}

    def stage(tag, cfg, extra, subcmd="fit", ckpt=None, imnet_off=None,
              epochs=None):
        save = os.path.join(args.out, tag)
        if subcmd == "fit" and args.resume:
            hit = newest_epoch(save) if os.path.isdir(save) else None
            if hit is not None and hit[0] >= (epochs or args.epochs) - 1:
                print(f"[{tag}] resume: epoch={hit[0]} checkpoint present, "
                      "skipping fit", flush=True)
                return save, os.path.join(args.out, f"{tag}.fit.log")
        argv = [subcmd, "--config", os.path.join(REPO, "configs", cfg)]
        argv += common + (imnet_off or no_imnet) + extra
        argv += ["--trainer.max_epochs", str(epochs or args.epochs)]
        ms = scaled_milestones(
            os.path.join(REPO, "configs", cfg), epochs or args.epochs)
        if subcmd == "fit" and ms:
            argv += ["--model.lr_decay_epochs", json.dumps(ms)]
        if subcmd == "fit" and args.ckpt_every > 1:
            argv += ["--trainer.ckpt_every_n_epochs", str(args.ckpt_every)]
        if subcmd == "fit":
            # Crash recovery WITHIN a stage: a relaunched curriculum restores
            # the newest checkpoint under the stage dir instead of
            # retraining from the grafts (fresh dirs have none -> no-op).
            argv += ["--trainer.auto_resume", "true"]
        argv += ["--trainer.save_dir", save]
        if ckpt:
            argv += ["--ckpt_path", ckpt]
        log = os.path.join(args.out, f"{tag}.{subcmd}.log")
        print(f"[{tag}] egorear_tpu_torch.run {subcmd} ...", flush=True)
        timings[f"{tag}.{subcmd}"] = run_cli(argv, env, log)
        print(f"[{tag}] done in {timings[f'{tag}.{subcmd}']:.0f}s", flush=True)
        return save, log

    # ---- stage 1: stereo front + back ----
    s1f, _ = stage("s1_front", "ego4view_syn_heatmap_stereo_front.yaml", [])
    s1f_ckpt = latest_ckpt(s1f)
    s1b, _ = stage("s1_back", "ego4view_syn_heatmap_stereo_back.yaml", [])
    s1b_ckpt = latest_ckpt(s1b)

    # ---- stage 2: MVFex with stage-1 grafts ----
    graft2 = [
        "--model.heatmap_estimator_pretrained_stereo_front", s1f_ckpt,
        "--model.heatmap_estimator_pretrained_stereo_back", s1b_ckpt,
        "--model.network_pretrained", "null",
    ]
    s2, _ = stage("s2_mvfex", "ego4view_syn_heatmap_mvfex-n1_jqa.yaml", graft2,
                  epochs=args.epochs2)
    s2_ckpt = latest_ckpt(s2)
    _, s2_test_log = stage("s2_mvfex", "ego4view_syn_heatmap_mvfex-n1_jqa.yaml",
                           graft2, subcmd="test", ckpt=s2_ckpt)

    # ---- stage-2 occlusion-split eval (the decisive per-joint-class read),
    # on the stages' device while stage 3 trains ----
    occ_procs = []
    if args.occlusion:
        for split, short in (("train", "train"), ("validation", "val")):
            out_json = os.path.join(args.out, f"occlusion_split_s2_{short}.json")
            log = os.path.join(args.out, f"occlusion_split_s2_{short}.log")
            occ_procs.append((subprocess.Popen(
                [sys.executable, "-m", "egorear_tpu_torch.tools.eval_occlusion_split",
                 "--ckpt", s2_ckpt, "--data-root", args.data_root,
                 "--split", split, "--limit", "128", "--out", out_json] + device,
                stdout=open(log, "w"), stderr=subprocess.STDOUT,
                env=env, cwd=REPO), split))

    # ---- stage 3: pose3d with stage-2 graft ----
    graft3 = [
        "--model.heatmap_estimator_mvf_pretrained", s2_ckpt,
        "--model.network_pretrained", "null",
    ]
    s3, _ = stage("s3_pose3d", "ego4view_syn_pose3d.yaml", graft3,
                  imnet_off=no_imnet3, epochs=args.epochs3)
    s3_ckpt = latest_ckpt(s3)
    _, s3_test_log = stage("s3_pose3d", "ego4view_syn_pose3d.yaml", graft3,
                           subcmd="test", ckpt=s3_ckpt, imnet_off=no_imnet3)

    for proc, split in occ_procs:
        if proc.wait() != 0:
            print(f"[occlusion_split {split}] FAILED (rc={proc.returncode}), "
                  "see log", flush=True)

    # ---- report ----
    write_report(args, timings,
                 s1f, s1b, s2, s3, test_json(s2_test_log),
                 test_json(s3_test_log))


def mean_floor_mm(data_root):
    """Empirical predicts-the-mean MPJPE floor: test-split MPJPE of a
    constant train-mean prediction, in mm. None when the data is gone."""
    import glob
    import numpy as np

    from egorear_tpu_torch.data.datasets import JOINT_NAMES

    def poses_of(split):
        path = os.path.join(data_root, f"{split}.txt")
        if not os.path.exists(path):
            return None
        out = []
        with open(path) as f:
            chars = [ln.strip() for ln in f if ln.strip()]
        for ch in chars:
            for jf in sorted(glob.glob(os.path.join(
                    data_root, ch, "*", "json_smplx_gendered", "*.json"))):
                with open(jf) as fh:
                    d = json.load(fh)
                out.append([d["joints"][k]["device_pts3d"]
                            for k in JOINT_NAMES])
        return np.asarray(out) if out else None

    train, test = poses_of("train"), poses_of("test")
    if train is None or test is None:
        return None
    mean = train.mean(axis=0)
    return float(np.linalg.norm(test - mean, axis=-1).mean() * 10.0)


def fmt_series(pairs, n=6):
    if not pairs:
        return "n/a"
    idx = [0] + sorted(set(
        round(i * (len(pairs) - 1) / (n - 1)) for i in range(1, n)))
    return " -> ".join(f"{pairs[i][1]:.4g}" for i in dict.fromkeys(idx))


def write_report(args, timings, s1f, s1b, s2, s3, s2_test, s3_test):
    """``<out>/ACCURACY.md`` from the stages' metrics.csv files, their test
    JSONs, the occlusion-split JSONs and ``<out>/overfit_probe.log`` where
    they exist."""
    r1f = read_metrics(s1f)
    r1b = read_metrics(s1b)
    r2 = read_metrics(s2)
    r3 = read_metrics(s3)

    floor = mean_floor_mm(args.data_root)

    L = []
    L.append("# ACCURACY -- 3-stage curriculum evidence\n")
    L.append(
        "Full reference training protocol driven end-to-end through "
        "`python -m egorear_tpu_torch.run` with the shipped YAML configs (fit stereo-front -> fit "
        "stereo-back -> graft -> fit MVFex -> graft -> fit pose3d -> test; "
        "reference protocol: README.md:183-189, pose_3d_mvf_ex.py:317-333) "
        f"on a {args.image_size}px geometrically-consistent synthetic set "
        f"({args.frames} train frames, draw_pose images -- see "
        "egorear_tpu_torch/data/synthetic.py). Real Ego4View data/checkpoints are "
        "not available in this environment; this is the strongest available "
        "proxy: every stage trains, grafts and evaluates exactly as the "
        "reference does, and the pose error genuinely falls because the "
        "images encode the pose.\n")
    if getattr(args, "skeleton", False):
        L.append(
            "Poses are drawn from a fixed-bone-length kinematic tree "
            "(sample_skeleton_poses: correlated joints, exact bone "
            "lengths, whole-body yaw), a skeletal prior.\n")
    if getattr(args, "occlusion", 0):
        L.append(
            f"Occlusions: with prob {args.occlusion} per joint, the image "
            "blob is hidden from the front (resp. back) stereo pair -- "
            "never both -- while GT labels/heatmaps stay. The per-pair "
            "stage-1 estimators therefore CANNOT localize those joints; "
            "only the stage-2 multi-view refiner can, so refined-beats-init "
            "is demanded by the data, not incidental.\n")
    L.append("Protocol deviations: `warmup_iters` 500 -> "
             f"{args.warmup} (500 would span the whole small-set run), "
             "`use_imagenet_pretrain` off (blob images are out-of-domain "
             "for ImageNet features). Everything else is the stock "
             f"configs. Device: {args.device or 'cuda'}.\n")

    L.append("## Stage 1 (per-pair heatmap estimators)\n")
    for tag, rows in (("front", r1f), ("back", r1b)):
        tr = series(rows, "train/heatmap_loss")
        vl = series(rows, "val/proposal_mse_heatmap")
        L.append(f"- stereo_{tag} train/heatmap_loss: {fmt_series(tr)}")
        L.append(f"- stereo_{tag} val/proposal_mse_heatmap: {fmt_series(vl)}")
    L.append("")

    L.append("## Stage 2 (MVFex refinement, stage-1 grafts loaded)\n")
    L.append(f"- train/loss_total: {fmt_series(series(r2, 'train/loss_total'))}")
    for k in ("val/proposal_stereo_front_mse_pts2d",
              "val/final_stereo_front_mse_pts2d",
              "val/proposal_stereo_back_mse_pts2d",
              "val/final_stereo_back_mse_pts2d",
              "val/proposal_stereo_front_mse_heatmap",
              "val/final_stereo_front_mse_heatmap"):
        L.append(f"- {k}: {fmt_series(series(r2, k))}")
    L.append("\ntest split (final checkpoint):\n")
    keys2 = sorted(k for k in s2_test if "mse_heatmap" in k or "pts2d" in k)
    for k in keys2:
        L.append(f"- {k}: {s2_test[k]:.6f}")
    for pair in ("front", "back"):
        fr = s2_test.get(f"test/final_stereo_{pair}_mse_pts2d")
        pr = s2_test.get(f"test/proposal_stereo_{pair}_mse_pts2d")
        if fr is not None and pr is not None:
            L.append(f"\n**Refined-vs-init pts2d MSE ({pair}): {fr:.4f} vs "
                     f"{pr:.4f} "
                     f"({'REFINED BEATS INIT' if fr < pr else 'NOT improved'})**")
    fr = s2_test.get("test/final_stereo_front_mse_heatmap")
    pr = s2_test.get("test/proposal_stereo_front_mse_heatmap")
    if fr is not None and pr is not None:
        L.append(f"\n**Refined-vs-init heatmap MSE (front): {fr:.6f} vs "
                 f"{pr:.6f} ({'improved' if fr < pr else 'NOT improved'})**")
    L.append("")

    # ---- occlusion-split: init vs refined on the joints the experiment
    # is about (eval_occlusion_split's output, written when
    # --occlusion > 0) ----
    splits = {}
    for short in ("train", "val"):
        p = os.path.join(args.out, f"occlusion_split_s2_{short}.json")
        if os.path.exists(p):
            with open(p) as f:
                splits[short] = json.load(f)
    if splits:
        L.append("### Stage-2 occlusion split (argmax px error, init vs "
                 "refined)\n")
        L.append(
            "The aggregate mse_pts2d above averages visible and occluded "
            "joints; the experiment's claim lives on the occluded ones — "
            "joints hidden from one stereo pair that ONLY cross-pair "
            "exchange (MVFex) can localize "
            "(`egorear_tpu_torch/tools/eval_occlusion_split.py`, artifacts "
            f"`{os.path.relpath(args.out, REPO)}/occlusion_split_s2_*.json`):\n")
        L.append("| split | pair | class | init | refined | refined/init |")
        L.append("|---|---|---|---|---|---|")
        for short, rep in splits.items():
            for pair in ("front", "back"):
                for cls in ("visible", "occluded"):
                    i = rep.get(f"{pair}_{cls}_init_mse_pts2d")
                    f_ = rep.get(f"{pair}_{cls}_final_mse_pts2d")
                    r = rep.get(f"{pair}_{cls}_final_over_init")
                    if i is None:
                        continue
                    L.append(f"| {short} | {pair} | {cls} | {i:.2f} | "
                             f"{f_:.2f} | {r:.3f} |")
        occ_wins = [rep.get(f"{p}_occluded_final_over_init", 9.9)
                    for p in ("front", "back")
                    for rep in ([splits["val"]] if "val" in splits else [])]
        if occ_wins:
            ok = all(r < 1.0 for r in occ_wins)
            L.append(
                "\n**Occluded-joint refined/init on val: front "
                f"{occ_wins[0]:.3f}, back {occ_wins[1]:.3f} — "
                + ("the refiner recovers pair-occluded joints on held-out "
                   "frames; cross-view exchange is doing its job.**"
                   if ok else
                   "the refiner does not yet beat init on held-out "
                   "occluded joints at this data scale.**"))
        L.append("")

    L.append("## Stage 3 (3D pose, stage-2 graft loaded)\n")
    L.append(f"- train/loss_total: {fmt_series(series(r3, 'train/loss_total'))}")
    for k in ("val/final_mpjpe", "val/proposal_mpjpe"):
        L.append(f"- {k}: {fmt_series(series(r3, k))}")
    L.append("\ntest split (final checkpoint, mm):\n")
    for k in sorted(k for k in s3_test):
        L.append(f"- {k}: {s3_test[k]:.4f}")
    fm = s3_test.get("test/final_mpjpe")
    pm = s3_test.get("test/proposal_mpjpe")
    if fm is not None and pm is not None:
        L.append(f"\n**Final MPJPE {fm:.2f} mm vs proposal {pm:.2f} mm "
                 f"({'refinement helps' if fm < pm else 'refinement does NOT help'})**")
    L.append("")

    # ---- interpretation: where the numbers land vs what is learnable ----
    fm = s3_test.get("test/final_mpjpe") or float("nan")
    L.append("## Reading the stage-3 number against the mean floor\n")
    if floor is not None:
        verdict = ("BELOW the floor -- the model learned genuine image->3D "
                   "lifting that generalizes" if fm < floor else
                   "at/above the floor -- the 3D head has recovered the "
                   "dataset mean but not yet the image->3D lifting at this "
                   "step budget")
        L.append(
            "The empirical predicts-the-mean MPJPE floor of this dataset "
            "(test-split error of a constant train-mean prediction, "
            f"computed from the generated JSONs) is **{floor:.1f} mm**. "
            f"The curriculum's stage-3 test MPJPE ({fm:.1f} mm) is "
            f"{verdict}.\n")
    else:
        L.append(
            f"(dataset at {args.data_root} no longer present; floor not "
            "recomputed)\n")

    # ---- overfit probe: the decisive learnability evidence ----
    probe = os.path.join(args.out, "overfit_probe.log")
    if os.path.exists(probe):
        L.append("## Fixed-batch overfit probe\n")
        L.append(
            "`python -m egorear_tpu_torch.tools.overfit_probe`: the full "
            "pose3d network (the same config, dataset and loss) trained on "
            "one fixed batch. If a link in the image->heatmap->3D chain "
            "were broken (data misalignment, stopped gradients, scale bugs), "
            "memorising the batch would bottom out at its predicts-the-mean "
            "floor:\n")
        L.append("```")
        for line in open(probe).read().splitlines():
            if line.startswith(("batch ", "step")):
                L.append(line)
        L.append("```\n")

    L.append("## Wall-clock\n")
    if timings:
        for k, v in timings.items():
            L.append(f"- {k}: {v:.0f}s")
    else:
        for tag in ("s1_front", "s1_back", "s2_mvfex", "s3_pose3d"):
            log = os.path.join(args.out, f"{tag}.fit.log")
            if os.path.exists(log):
                txt = open(log).read()
                secs = [float(m) for m in
                        re.findall(r"done in ([0-9.]+)s", txt)]
                L.append(f"- {tag}.fit: {sum(secs):.0f}s over "
                         f"{len(secs)} epochs (epoch medians incl. val)")
    L.append("")

    out = os.path.join(args.out, "ACCURACY.md")
    with open(out, "w") as f:
        f.write("\n".join(L))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
