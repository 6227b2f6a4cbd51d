"""The port's tools (``egorear_tpu_torch/tools/``) held against the JAX
package's ``tools/`` on the CPU.

  * ``flops_count``: the convolution count equals the closed form over the
    model's convolving modules (forward hooks: 2 x output elements x input
    channels per group x kernel area, for ``nn.Conv2d`` and the 1x1
    ``PointwiseConv``); the total at 64 px within 5 % of the JAX tool's XLA
    cost-model figure (XLA also counts elementwise work and its own
    sampling; the port's counter counts neither, and not ``grid_sample``);
    the 256-px ratio printed.
  * The train step that ``profile_train`` and ``overfit_probe`` share
    (``tools.common.ProbeStep``) against the JAX tools' step, which is
    local to their ``main()`` and is rebuilt here from the same calls
    (``net.apply`` in train mode with ``batch_stats`` mutable, ``0.1 x sum
    mpjpe_loss + 10 x sum mean squared heatmap error``,
    ``optax.chain(clip_by_global_norm(5.0), adamw(lr))``, on the raveled
    parameter vector, which is the same update): three steps at
    64 px on the same converted weights and batch, in fp64 on both sides
    around the fp32 lazy sampling (as ``tests/test_torch_port_rigs.py``),
    on the flagship with one lifting layer (the cascade's gradients are
    held to JAX's in ``tests/test_torch_port_train.py``).
    Each step's loss terms within STEP_LOSS_RTOL; after three steps every
    parameter within Adam's step bound (1.5 lr a step each way) plus four
    fp64 ulps, and the BN running stats within STEP_BN_TOL.
  * ``eval_occlusion_split``'s accumulation and report against a
    transcription of the JAX tool's loop (:func:`_jax_accumulate`, the JAX
    ``main()``'s lines, which no function of its own holds).
  * ``run_curriculum``'s helpers against the JAX module's, and its stage
    argv sequence against the JAX tool's with ``run_cli``,
    ``latest_ckpt``, the evaluation subprocess and the report replaced in
    both.
  * ``profile_fwd``'s scope ranges on the CPU at 64 px, batch 1: every
    bucket present, ``other/unattributed`` under 10 % of the operators'
    self time; ``profile_train``'s phase split.
  * Every tool but ``flops_count`` raises without CUDA unless asked for the
    CPU.
"""

from __future__ import annotations

import csv
import glob
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.flatten_util import ravel_pytree
import torch
import torch.nn as nn

from egorear_tpu.ops.metrics import mpjpe_loss as jax_mpjpe_loss
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
from egorear_tpu_torch.models.layers import PointwiseConv
from egorear_tpu_torch.tools import (
    eval_occlusion_split,
    flops_count,
    overfit_probe,
    profile_fwd,
    profile_train,
    run_curriculum,
)
from egorear_tpu_torch.tools.common import ProbeStep
from test_torch_port_rigs import _cascade_cfg, step_case
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
FLOPS_RTOL = 0.05
STEPS, STEP_LR, STEP_SEED = 3, 1e-5, 100
# Loss terms of each step, relative (measured <= 4.7e-8: the fp32 sampling
# cores); BN running stats, absolute and relative.
STEP_LOSS_RTOL, STEP_BN_TOL = 1e-6, 1e-7


def _jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- flops_count ----------------------------------------------------------------


def _jax_flops_per_frame(size: int, batch: int) -> float:
    """The JAX tool's XLA cost-model count (its ``main()``'s calls)."""
    from __graft_entry__ import _build

    net, rig, _ = _build((size, size))
    img = jnp.zeros((batch, 4, 3, size, size), jnp.float32)
    variables = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), img[:1], rig))

    def fwd(v, im):
        preds3d, hms = net.apply(v, im, rig)
        return preds3d[-1], hms[-1]

    cost = jax.jit(fwd).lower(variables, img).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    return float(cost["flops"]) / batch


def _conv_closed_form(size: int, batch: int) -> int:
    model, rig = entry.build((size, size), device="cpu", seed=0)
    total = [0]

    def hook(mod, args, out):
        if isinstance(mod, nn.Conv2d):
            per = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        else:  # PointwiseConv: a 1x1 convolution
            per = mod.in_features
        total[0] += 2 * out.numel() * per

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, PointwiseConv)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(batch, 4, 3, size, size), rig)
    return total[0]


def test_flops_count_matches_closed_form_and_jax(capsys):
    out = flops_count.main(["1", "64"])
    assert out["by_family"]["conv"] == _conv_closed_form(64, 1)
    assert out["total"] == sum(out["by_family"].values()) == sum(out["by_part"].values())
    assert out["by_part"]["other"] == 0 and min(out["by_part"].values()) >= 0
    assert all(out["by_part"][k] > 0 for k in ("stage 1 + heads", "mvfex refiners", "pose3d"))
    want = _jax_flops_per_frame(64, 1)
    got = out["total"]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)
    text = capsys.readouterr().out
    assert "/frame" in text and "conv" in text and "mvfex refiners" in text
    got256 = flops_count.count(1, 256)["total"]
    want256 = _jax_flops_per_frame(256, 1)
    print(f"GFLOP/frame, port (FlopCounterMode) vs JAX (XLA): 64 px {got / 1e9:.3f} vs "
          f"{want / 1e9:.3f} ({got / want:.4f}); 256 px {got256 / 1e9:.3f} vs "
          f"{want256 / 1e9:.3f} ({got256 / want256:.4f})")


# -- the shared train step -------------------------------------------------------------


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def test_probe_step_matches_jax_tools_step():
    cfg = _cascade_cfg(4, "ego4view_syn")
    cfg["pose3d_cfg"]["num_former_layers"] = 1  # the step, not the model, is under test
    jtask, variables, batch, task = step_case("pose_3d_mvf_ex", cfg, STEP_SEED)
    net, jrig = jtask.model, jtask.rig
    img, gt_pose, gt_hm = (np.asarray(batch[k], np.float64)
                           for k in ("img", "gt_pose", "gt_heatmap"))
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(STEP_LR))

    def loss_fn(p, stats):
        (p3d, hms), mut = net.apply({"params": p, "batch_stats": stats}, img, jrig,
                                    train=True, mutable=["batch_stats"])
        l_pose = sum(jax_mpjpe_loss(x, gt_pose) for x in p3d) * 0.1
        l_hm = sum(((h - gt_hm) ** 2).mean() for h in hms) * 10.0
        return l_pose + l_hm, (mut["batch_stats"], l_hm, jax_mpjpe_loss(p3d[-1], gt_pose),
                               jax_mpjpe_loss(p3d[0], gt_pose))

    def step(flat, stats, opt_state):
        (loss, (stats, *terms)), grads = jax.value_and_grad(
            lambda f: loss_fn(unravel(f), stats), has_aux=True)(flat)
        updates, opt_state = tx.update(grads, opt_state, flat)
        return optax.apply_updates(flat, updates), stats, opt_state, [loss] + terms

    with jax.enable_x64(True):
        # The optimizer on the raveled parameters: clipping by the global
        # norm and AdamW are elementwise or global, so this is the tree's
        # update, and one vector compiles in a fraction of the time.
        flat, unravel = ravel_pytree(_f64(variables["params"]))
        stats = _f64(variables["batch_stats"])
        opt_state, jstep, want = tx.init(flat), jax.jit(step), []
        for _ in range(STEPS):
            flat, stats, opt_state, terms = jstep(flat, stats, opt_state)
            want.append([float(t) for t in terms])
        params = unravel(flat)
    want_params = from_flax({"params": jax.device_get(params)})
    want_stats = from_flax({"batch_stats": jax.device_get(stats)})

    model = task.model.double()
    probe = ProbeStep(model, task.rig, lr=STEP_LR, precision="32")
    args = tuple(torch.from_numpy(x) for x in (img, gt_pose, gt_hm))
    got = []
    for _ in range(STEPS):
        out = probe(*args)
        got.append([float(out[k]) for k in ("loss", "hm_loss", "mpjpe_final",
                                             "mpjpe_proposal")])
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(np.array(want))
    assert rel.max() <= STEP_LOSS_RTOL, (rel, got, want)
    bound = 2 * 1.5 * STEPS * STEP_LR
    worst = 0.0
    for k, w in want_params.items():
        p = dict(model.named_parameters())[k].detach()
        assert p.dtype == torch.float64, k
        diff = float(((p - w).abs() - 8.9e-16 * w.abs()).max())
        worst = max(worst, diff)
        assert diff <= bound, (k, diff, bound)
    sd = model.state_dict()
    for k, w in want_stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=STEP_BN_TOL,
                                       rtol=STEP_BN_TOL, err_msg=k)
    print(f"ProbeStep vs the JAX tools' step, {STEPS} fp64 steps: loss terms "
          f"{rel.max():.3e} relative; params {worst:.3e} (Adam bound {bound:.1e})")


# -- eval_occlusion_split ----------------------------------------------------------------


def _jax_accumulate(sums, err_i, err_f, items_vis):
    """The JAX tool's accumulation loop (tools/eval_occlusion_split.py,
    ``main()``), transcribed."""
    for bi, vis in enumerate(items_vis):
        for pair, views in (("front", (0, 1)), ("back", (2, 3))):
            pv = vis[views[0]]
            for stage, err in (("init", err_i), ("final", err_f)):
                for tag, mask in (("visible", pv), ("occluded", ~pv)):
                    if mask.any():
                        e = err[bi, list(views)][:, mask]
                        sums[(pair, tag, stage)][0] += float(e.sum())
                        sums[(pair, tag, stage)][1] += int(e.size)


def _jax_report(sums, ckpt, split, n):
    """The JAX tool's report (its ``main()``'s lines), transcribed."""
    report = {"ckpt": ckpt, "split": split, "frames": n}
    for pair in ("front", "back"):
        for tag in ("visible", "occluded"):
            for stage in ("init", "final"):
                s, c = sums[(pair, tag, stage)]
                report[f"{pair}_{tag}_{stage}_mse_pts2d"] = round(s / c, 3) if c else None
            i = report[f"{pair}_{tag}_init_mse_pts2d"]
            f = report[f"{pair}_{tag}_final_mse_pts2d"]
            if i and f:
                report[f"{pair}_{tag}_final_over_init"] = round(f / i, 3)
    return report


def test_occlusion_split_accumulation_matches_jax():
    rng = np.random.default_rng(8)
    sums, want = eval_occlusion_split.new_sums(), eval_occlusion_split.new_sums()
    for b in (4, 4, 3):
        err_i = rng.uniform(size=(b, 4, 15)) * 9
        err_f = rng.uniform(size=(b, 4, 15)) * 9
        vis = [rng.uniform(size=(4, 15)) > 0.3 for _ in range(b)]
        vis[0][0] = True  # a pair with no occluded joint
        eval_occlusion_split.accumulate(sums, err_i, err_f, vis)
        _jax_accumulate(want, err_i, err_f, vis)
    assert sums == want
    assert eval_occlusion_split.report(sums, "c", "val", 11) == _jax_report(want, "c", "val", 11)
    empty = eval_occlusion_split.new_sums()
    assert eval_occlusion_split.report(empty, "c", "val", 0) == _jax_report(empty, "c", "val", 0)
    keys = [k for k in _jax_report(want, "c", "val", 11) if k.endswith("_mse_pts2d")]
    assert len(keys) == 8


def test_frame_visibility_reads_the_tree(tmp_path):
    root = str(tmp_path / "tree")
    make_synthetic_dataset(root, frames_per_seq=3, image_size=32, occlusion=0.5,
                           draw_pose=True, splits=("validation",))
    frames = sorted(glob.glob(os.path.join(root, "*", "*", "json_smplx_gendered", "*.json")))
    vis = np.load(os.path.join(os.path.dirname(os.path.dirname(frames[1])), "visibility.npy"))
    got = eval_occlusion_split.FrameVisibility()(frames[1])
    np.testing.assert_array_equal(got, vis[1, :, 1:])
    assert eval_occlusion_split.FrameVisibility()(str(tmp_path / "a/b/c/frame_000000.json")).all()


# -- run_curriculum ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_curriculum():
    return _jax_tool("run_curriculum")


@pytest.mark.parametrize("epochs", [None, 1, 12, 30, 100])
def test_scaled_milestones_match_jax(jax_curriculum, epochs):
    assert len(CONFIGS) == 12
    for cfg in CONFIGS:
        assert (run_curriculum.scaled_milestones(cfg, epochs)
                == jax_curriculum.scaled_milestones(cfg, epochs)), cfg


def test_curriculum_helpers_match_jax(jax_curriculum, tmp_path):
    save = tmp_path / "stage"
    for rel in ("a/checkpoints/epoch=3.pt", "b/epoch=11.pt", "b/epoch=2"):
        (save / rel).parent.mkdir(parents=True, exist_ok=True)
        (save / rel).write_text("")
    assert run_curriculum.newest_epoch(str(save)) == jax_curriculum.newest_epoch(str(save))
    assert run_curriculum.newest_epoch(str(tmp_path / "none")) is None
    rng = np.random.default_rng(9)
    for v in range(2):
        d = save / "lightning_logs" / f"version_{v}"
        d.mkdir(parents=True)
        with open(d / "metrics.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["epoch", "step", "train/loss_total", "val/x"])
            w.writeheader()
            for s in range(5):
                w.writerow({"epoch": v, "step": 8 * s + v, "train/loss_total": rng.normal(),
                            "val/x": rng.normal() if s % 2 else ""})
    rows = run_curriculum.read_metrics(str(save))
    assert rows == jax_curriculum.read_metrics(str(save)) and len(rows) == 10
    for key in ("train/loss_total", "val/x", "absent"):
        assert run_curriculum.series(rows, key) == jax_curriculum.series(rows, key)
    for n in (2, 6):
        pairs = run_curriculum.series(rows, "train/loss_total")
        assert run_curriculum.fmt_series(pairs, n) == jax_curriculum.fmt_series(pairs, n)
    metrics = {"test/final_mpjpe": 12.5, "test/proposal_mpjpe": 20.25}
    logs = {"one_line": "log\n" + json.dumps(metrics) + "\nend\n",
            "indented": "log\n" + json.dumps(metrics, indent=1) + "\n",
            "none": "nothing here\n"}
    for name, text in logs.items():
        (tmp_path / f"{name}.log").write_text(text)
        path = str(tmp_path / f"{name}.log")
        assert run_curriculum.test_json(path) == jax_curriculum.test_json(path), name
    root = str(tmp_path / "tree")
    make_synthetic_dataset(root, frames_per_seq=3, image_size=32)
    floor = run_curriculum.mean_floor_mm(root)
    assert floor is not None and floor == jax_curriculum.mean_floor_mm(root)
    assert run_curriculum.mean_floor_mm(str(tmp_path / "none")) is None


def _stage_argvs(module, argv, monkeypatch, device_flag=()):
    """The argv of every stage ``module.main`` would run, and of every
    evaluation it would spawn, with nothing run."""
    calls, spawned = [], []
    def run_cli(args, env, log):
        calls.append(list(args))
        open(log, "w").close()
        return 1.0

    monkeypatch.setattr(module, "run_cli", run_cli)
    monkeypatch.setattr(module, "latest_ckpt", lambda save: os.path.join(save, "epoch=0"))
    monkeypatch.setattr(module, "write_report", lambda *a: None)

    class Popen:
        def __init__(self, args, **kwargs):
            spawned.append(list(args))
            kwargs["stdout"].close()
            self.returncode = 0

        def wait(self):
            return 0

    monkeypatch.setattr(module.subprocess, "Popen", Popen)
    if module is run_curriculum:
        module.main(list(argv) + list(device_flag))
    else:
        monkeypatch.setattr(sys, "argv", ["run_curriculum.py"] + list(argv))
        module.main()
    return calls, spawned


def _drop(args, flag):
    """``args`` without the pairs ``flag value``."""
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("case", ["plain", "occlusion", "resume"])
def test_curriculum_stage_argvs_match_jax(jax_curriculum, tmp_path, monkeypatch, case):
    data = tmp_path / "data"
    data.mkdir()
    (data / "train.txt").write_text("")  # a tree already there: nothing generated
    out = tmp_path / "out"
    argv = ["--data-root", str(data), "--out", str(out), "--epochs", "3",
            "--epochs3", "5", "--frames", "8", "--batch-size", "4"]
    if case == "occlusion":
        argv += ["--occlusion", "0.25", "--ckpt-every", "2"]
    if case == "resume":
        argv += ["--resume"]
        (out / "s1_back" / "checkpoints").mkdir(parents=True)
        (out / "s1_back" / "checkpoints" / "epoch=2.pt").write_text("")
    want, want_spawned = _stage_argvs(jax_curriculum, argv, monkeypatch)
    got, got_spawned = _stage_argvs(run_curriculum, argv, monkeypatch, ["--device", "cpu"])
    assert [_drop(a, "--device") for a in got] == want
    assert all(a[a.index("--device") + 1] == "cpu" for a in got)
    assert len(want) == (5 if case == "resume" else 6)
    assert len(got_spawned) == len(want_spawned) == (2 if case == "occlusion" else 0)
    for g, w in zip(got_spawned, want_spawned):
        assert g[:3] == [sys.executable, "-m", "egorear_tpu_torch.tools.eval_occlusion_split"]
        assert _drop(g[3:], "--device") == _drop(w[2:], "--device")
        assert g[g.index("--device") + 1] == "cpu"


# -- profile_fwd, profile_train on the CPU ---------------------------------------------------


def test_profile_fwd_scope_buckets_on_cpu():
    out = profile_fwd.profile_forward(1, "fp32", "cpu", 64, timed=1, traced=1, quiet=True)
    assert out["forwards"] == 3 and out["card"] == "cpu"
    buckets, total = out["buckets"], out["total"]
    assert set(buckets) == set(profile_fwd.BUCKETS), buckets
    assert all(buckets[b] > 0 for b in profile_fwd.BUCKETS), buckets
    assert sum(buckets.values()) == pytest.approx(total)
    assert sum(out["kernels"].values()) == pytest.approx(total)
    assert total == pytest.approx(out["busy"], rel=0.05)
    assert buckets[profile_fwd.UNATTRIBUTED] < 0.1 * total, buckets


def test_profile_train_phases_on_cpu():
    out = profile_train.profile_train_step(1, "fp32", "cpu", 64, timed=1, traced=1,
                                           quiet=True)
    assert out["steps"] == 3 and all(np.isfinite(out["losses"]))
    phases, total = out["phases"], out["total"]
    assert {"forward", "backward", "optimizer"} <= set(phases)
    assert sum(phases.values()) == pytest.approx(total)
    assert total == pytest.approx(out["busy"], rel=0.05)
    assert phases.get("unattributed", 0.0) < 0.05 * total, phases
    assert out["buckets"]["fwd+ optimizer"] == pytest.approx(phases["optimizer"])
    for b in ("backbone.resnet", "refiner.deform_attn", "pose3d.deform_attn"):
        assert out["buckets"][f"bwd {b}"] > 0 and out["buckets"][f"fwd+ {b}"] > 0, b


# -- the device rule ---------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["profile_fwd", "profile_train", "overfit_probe",
                                  "eval_occlusion_split", "run_curriculum"])
def test_tools_refuse_without_cuda(tool, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"overfit_probe": ["--data", str(tmp_path)],
            "eval_occlusion_split": ["--ckpt", str(tmp_path / "x.pt"),
                                     "--data-root", str(tmp_path)],
            "run_curriculum": ["--out", str(tmp_path / "out")]}.get(tool, [])
    module = {"profile_fwd": profile_fwd, "profile_train": profile_train,
              "overfit_probe": overfit_probe, "eval_occlusion_split": eval_occlusion_split,
              "run_curriculum": run_curriculum}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
    assert not (tmp_path / "out" / "data").exists()
