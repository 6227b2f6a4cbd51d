"""Stages 1 and 2 of the port held against the JAX package on the CPU: the
same numpy inputs and the same random flax weights (carried across by
``egorear_tpu_torch.convert.from_flax``), fp32, 64 px, batch 2.

  * the stage-1 ``HeatmapNet`` with its ``conv_heatmap`` head, with and
    without ``detach_heatmap_feat_init``; ``from_flax`` strict on the
    variables of all three stages;
  * ``heatmap_eval_metrics`` on maps with ties and flat (invalid) targets;
  * ``HeatmapTask`` and ``MVFexTask``: the loss terms, per-leaf gradients
    vs ``jax.grad`` and BN running stats of one train-mode forward, three
    train steps vs the JAX trainer's step (also at ``encoder_lr_scale``
    0.1), ``eval_metrics`` (with the ``test_mode`` stages) and
    ``predict_outputs``;
  * ``entry``'s stage configs vs the yamls.

Gradients: a leaf whose largest JAX gradient is below ``GRAD_FLOOR`` of the
model's largest is zero in exact arithmetic (the spatial attention's
key-projection biases, to which softmax is invariant) and carries only
rounding; both frameworks keep it below that floor. Every other leaf agrees
within ``GRAD_TOL`` of its own largest JAX value in fp32: train-mode
BatchNorm over 16 values on the 2x2 stride-32 maps of 64 px images
amplifies fp32 rounding (measured worst leaves 1.7e-5 in stage 1, 2.2e-5 in
stage 2, a refiner's position table whose gradient is 3e-5 of the model's
largest), so the limit sits a little above the worst stage 2 shows. The
stage-1 network's gradients are also held in fp64, to ``FP64_GRAD_TOL``:
there the two frameworks compute the same numbers. (Stage 2 has no fp64
form: deformable sampling computes in fp32 by contract, as its kernels
do.)
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from egorear_tpu.models.heatmap_net import HeatmapNet as JaxHeatmapNet
from egorear_tpu.train.optim import make_optimizer as jax_make_optimizer
from egorear_tpu.train.tasks import HeatmapTask as JaxHeatmapTask
from egorear_tpu.train.tasks import MVFexTask as JaxMVFexTask
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu.train.tasks import heatmap_eval_metrics as jax_heatmap_metrics
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.models.heatmap_net import HeatmapNet
from egorear_tpu_torch.models.mvfex import HeatmapMVFexNet
from egorear_tpu_torch.models.configs import MVFexNetCfg
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.train.tasks import (
    TASKS,
    HeatmapTask,
    MVFexTask,
    heatmap_eval_metrics,
)
from egorear_tpu_torch.train.trainer import Trainer, no_decay_mask_for
from test_torch_port_models import random_variables
from torch_threads import torch_threads  # noqa: F401

SIZE, B, SEED, HEATMAP_BIAS = 64, 2, 3, 0.3
HM_ATOL = 2e-5  # the cascade's heatmap tolerance
LOSS_RTOL = METRIC_RTOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 5e-5, 1e-8  # worst leaf measured: 2.2e-5 (stage 2)
FP64_GRAD_TOL = 1e-10
BN_TOL = 1e-5
# Three train steps (as tests/test_torch_port_train.py's): warmup over 2
# steps and a decay at step 2, the stage yamls' weight decay, no mask.
LR, WD, WARMUP, DECAY_EPOCHS, STEPS = 1e-5, 5e-3, 2, (2,), 3
CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")


def _cfg(name: str, num_former_layers: int = 1) -> dict:
    """A stage's config at 64 px, without the ImageNet initialisation (the
    weights come from the JAX side)."""
    if name == "heatmap":
        cfg = copy.deepcopy(entry.STAGE1_CFG)
    else:
        cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[SIZE, SIZE]))
        cfg["mvf_cfg"]["num_former_layers"] = num_former_layers
    cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    return cfg


def _batch(name: str, rng) -> dict:
    V = 2 if name == "heatmap" else 4
    img = rng.normal(size=(B, V, 3, SIZE, SIZE)).astype(np.float32)
    gt = rng.uniform(size=(B, V, 15, SIZE // 4, SIZE // 4)).astype(np.float32)
    return {"img": img, "gt_heatmap": gt}


def _jax_task(name: str, cfg: dict):
    return {"heatmap": JaxHeatmapTask, "heatmap_mvf_ex": JaxMVFexTask}[name](cfg)


def _jax_variables(jtask, batch, seed):
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["img"]), train=False))
    return random_variables(shapes, np.random.default_rng(seed),
                            heatmap_bias=HEATMAP_BIAS)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU ops: alone this file
    runs as fast with it, and under xdist, where several files share a few
    cores, idle-spinning torch threads would starve the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def stages():
    """Per task: the JAX task, random variables, a seeded batch, the jitted
    JAX loss-and-gradient and a maker of the port's task on those weights."""
    out = {}
    for i, name in enumerate(("heatmap", "heatmap_mvf_ex")):
        cfg = _cfg(name)
        rng = np.random.default_rng(SEED + i)
        batch = _batch(name, rng)
        jtask = _jax_task(name, cfg)
        variables = _jax_variables(jtask, batch, SEED + 10 + i)
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, ev, b, jtask=jtask: jtask.loss(p, ev, b, True), has_aux=True))

        def port_task(cfg=cfg, name=name, variables=variables):
            task = TASKS[name](cfg, device="cpu")
            load_flax(task.model, variables)
            return task

        out[name] = dict(jtask=jtask, cfg=cfg, variables=variables, batch=batch,
                         torch_batch={k: torch.from_numpy(v) for k, v in batch.items()},
                         value_and_grad=value_and_grad, port_task=port_task)
    return out


# -- the stage-1 head and the weight bridge ----------------------------------------


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("detach", [False, True])
def test_stage1_heatmaps_and_gradients_match_flax(detach):
    """Train-mode heatmaps (B, V, J, h, w) within HM_ATOL and the BN running
    stats in fp32; in fp64 the gradients of a random projection of the
    heatmaps, leaf by leaf: with ``detach_heatmap_feat_init`` the encoder
    gets none, in both frameworks."""
    rng = np.random.default_rng(5)
    img = rng.normal(size=(B, 2, 3, SIZE, SIZE)).astype(np.float32)
    proj = rng.normal(size=(B, 2, 15, SIZE // 4, SIZE // 4)).astype(np.float32)
    jnet = JaxHeatmapNet(detach_heatmap_feat_init=detach)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), img))
    variables = random_variables(shapes, rng)

    def f(params, stats, img, proj):
        hm, mutated = jnet.apply({"params": params, "batch_stats": stats},
                                 img, train=True, mutable=["batch_stats"])
        return (hm * proj).sum(), (hm, mutated)

    (_, (want, mutated)) = jax.jit(f)(variables["params"],
                                      variables["batch_stats"], img, proj)
    net = load_flax(HeatmapNet(num_heatmap=15, detach_heatmap_feat_init=detach),
                    variables).train()
    got = net(torch.from_numpy(img))
    assert got.shape == (B, 2, 15, SIZE // 4, SIZE // 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=HM_ATOL, rtol=0)
    sd = net.state_dict()
    for k, v in from_flax({"batch_stats": mutated["batch_stats"]}).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=BN_TOL,
                                       rtol=0, err_msg=k)

    v64 = _f64(variables)
    with jax.enable_x64(True):
        grads, _ = jax.jit(jax.grad(f, has_aux=True))(
            v64["params"], v64["batch_stats"], *_f64((img, proj)))
        want_grads = from_flax({"params": jax.device_get(grads)})
    net = load_flax(HeatmapNet(num_heatmap=15, detach_heatmap_feat_init=detach),
                    variables).double().train()
    hm = net(torch.from_numpy(img).double())
    (hm * torch.from_numpy(proj).double()).sum().backward()
    named = dict(net.named_parameters())
    assert sorted(named) == sorted(want_grads)
    for k, w in want_grads.items():
        g = named[k].grad
        if detach and k.startswith("encoder."):
            assert g is None and not bool(w.any()), k
            continue
        assert w.dtype == g.dtype == torch.float64
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= FP64_GRAD_TOL * scale, k


@pytest.mark.parametrize("stage", ["heatmap", "heatmap_mvf_ex", "pose_3d_mvf_ex"])
def test_from_flax_is_strict_on_stage_variables(stage):
    """Every stage's flax variables load strictly into the port's model; the
    stage-2 estimators have no ``conv_heatmap``, so a stage-1 head in their
    place is refused."""
    img = jnp.zeros((1, 2 if stage == "heatmap" else 4, 3, SIZE, SIZE))
    if stage == "heatmap":
        jmodel, model = JaxHeatmapNet(), HeatmapNet(num_heatmap=15)
        init = lambda: jmodel.init(jax.random.PRNGKey(0), img)  # noqa: E731
    elif stage == "heatmap_mvf_ex":
        jtask = JaxMVFexTask(_cfg(stage))
        model = HeatmapMVFexNet(MVFexNetCfg.from_dict(_cfg(stage)))
        init = lambda: jtask.model.init(jax.random.PRNGKey(0), img)  # noqa: E731
    else:
        cfg = entry.flagship_cfg_dict((SIZE, SIZE))
        jtask = JaxPose3DTask(cfg)
        model = EgoRearNet(entry.flagship_cfg((SIZE, SIZE)))
        init = lambda: jtask.model.init(  # noqa: E731
            jax.random.PRNGKey(0), img, jtask.rig, None, train=False)
    variables = random_variables(jax.eval_shape(init), np.random.default_rng(0))
    load_flax(model, variables)
    if stage == "heatmap":
        return
    params = copy.deepcopy(variables["params"])
    est = (params if stage == "heatmap_mvf_ex" else params["heatmap_estimator"])
    est["heatmap_estimator_stereo_front"]["conv_heatmap"] = {
        "kernel": np.zeros((1, 1, 128, 15), np.float32),
        "bias": np.zeros((15,), np.float32)}
    with pytest.raises(RuntimeError, match="conv_heatmap"):
        load_flax(model, {**variables, "params": params})


# -- metrics -------------------------------------------------------------------


def test_heatmap_eval_metrics_match_jax():
    """Random maps with exact ties (the first maximum wins), ground-truth
    peaks of exactly 1 (valid) and flat ground-truth maps (invalid)."""
    rng = np.random.default_rng(8)
    shape = (3, 4, 15, 16, 16)
    pred = rng.normal(size=shape).astype(np.float32)
    pred[0, 0, :3] = 0.5  # flat: every cell ties
    pred[1, 2, 4, 3:5, 7] = pred[1, 2, 4].max() + 1.0  # a two-cell tie
    gt = (rng.uniform(size=shape) * 0.9).astype(np.float32)
    peaks = rng.integers(0, 16, size=(3, 4, 15, 2))
    valid = rng.uniform(size=(3, 4, 15)) < 0.6
    for idx in zip(*np.nonzero(valid)):
        y, x = peaks[idx]
        gt[idx + (y, x)] = 1.0
    gt[2, 1] = 0.0  # flat ground truth: invalid, and no positive cell
    assert 0 < valid.mean() < 1
    want = jax.device_get(jax_heatmap_metrics(pred, gt, "final_stereo_front"))
    got = heatmap_eval_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                               "final_stereo_front")
    assert sorted(got) == sorted(want) and len(got) == 4
    for k, w in want.items():
        assert got[k].shape == (3,)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=METRIC_RTOL, atol=0,
                                   err_msg=k)


# -- one train-mode forward -------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step(stages):
    """Per task: JAX loss terms, mutated stats and gradients of one
    train-mode forward, and the port's after backward."""
    out = {}
    for name, s in stages.items():
        v = s["variables"]
        (_, (jm, mutated)), grads = s["value_and_grad"](
            v["params"], {"batch_stats": v["batch_stats"]}, s["batch"])
        task = s["port_task"]()
        task.model.train()
        total, metrics = task.loss(s["torch_batch"])
        total.backward()
        out[name] = dict(
            jax_metrics=jax.device_get(jm),
            jax_stats=from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])}),
            jax_grads=from_flax({"params": jax.device_get(grads)}),
            metrics={k: float(x.detach()) for k, x in metrics.items()}, task=task)
    return out


@pytest.mark.parametrize("name", ["heatmap", "heatmap_mvf_ex"])
def test_stage_loss_and_bn_stats_match_jax(one_step, name):
    r = one_step[name]
    want, got = r["jax_metrics"], r["metrics"]
    assert sorted(got) == sorted(want)
    assert len(got) == (1 if name == "heatmap" else 3)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    sd = r["task"].model.state_dict()
    n = 0
    for k, v in r["jax_stats"].items():
        if "running" in k:
            n += 1
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=BN_TOL,
                                       rtol=0, err_msg=k)
    assert n == (1 if name == "heatmap" else 2) * 2 * 20


@pytest.mark.parametrize("name", ["heatmap", "heatmap_mvf_ex"])
def test_stage_gradients_match_jax_grad(one_step, stages, name):
    r = one_step[name]
    want = r["jax_grads"]
    named = dict(r["task"].model.named_parameters())
    assert sorted(named) == sorted(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    floor = GRAD_FLOOR * gmax
    worst, rounding_zero = (0.0, ""), []
    for k, w in want.items():
        g = named[k].grad if named[k].grad is not None else torch.zeros_like(w)
        scale, err = float(w.abs().max()), float((g - w).abs().max())
        if scale == 0:
            continue
        if scale < floor:
            rounding_zero.append(k)
            assert float(g.abs().max()) <= floor, k
            continue
        worst = max(worst, (err / scale, k))
        assert err <= GRAD_TOL * scale, f"{k}: {err:.3e} > {GRAD_TOL:g} x {scale:.3e}"
    print(f"{name}: worst leaf gradient max-abs/scale {worst[0]:.3e} ({worst[1]}); "
          f"{len(rounding_zero)} leaves below the floor")
    zero_jax = {k for k, w in want.items() if not bool(w.any())}
    zero_port = {k for k, p in named.items() if p.grad is None or not bool(p.grad.any())}
    assert zero_jax == zero_port
    assert all("spatial_attn.k_proj.bias" in k for k in rounding_zero)
    if name == "heatmap":
        assert not zero_jax
        return
    # full_training is off: the backbones get no gradient; the refiners'
    # residual projection sits behind a stop-gradient.
    assert {k for k in zero_jax if "heatmap_estimator_stereo" in k} == {
        k for k in named if "heatmap_estimator_stereo" in k}
    assert zero_jax - {k for k in named if "heatmap_estimator_stereo" in k} == {
        k for k in named if ".ff_proj_" in k}
    # Anchors partly valid, so the sampling gradients cross both paths;
    # the initial heads get gradient through the refiners' heatmap input.
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    with torch.no_grad():
        hms, _ = r["task"].forward(stages[name]["torch_batch"]["img"])
    assert 0 < float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean()) < 1


# -- three train steps -----------------------------------------------------------------


def _clip_factor(grads: dict, max_norm: float = 5.0) -> float:
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    return min(1.0, max_norm / norm)


def _three_steps(s, encoder_lr_scale: float = 1.0):
    """Three fp32 steps of the JAX trainer's step and of the port's Trainer
    from the same state, held as tests/test_torch_port_train.py's
    ``test_three_train_steps_match_jax_trainer`` holds stage 3: step 1 to
    AdamW's per-element bound, step 3 to Adam's step bound, every loss to
    LOSS_RTOL and the BN running stats to BN_TOL. With ``encoder_lr_scale``
    every encoder leaf's update is scaled (optax's ``masked(scale)`` after
    ``adamw``), and so is its bound."""
    jtask, v, batch = s["jtask"], s["variables"], s["batch"]
    params, extra = v["params"], {"batch_stats": v["batch_stats"]}
    tx, schedule = jax_make_optimizer(LR, WD, WARMUP, DECAY_EPOCHS, 1,
                                      grad_clip_norm=5.0, no_decay_mask=False,
                                      params=params,
                                      encoder_lr_scale=encoder_lr_scale)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    jax_losses, jax_params, jax_grads = [], [], []
    for _ in range(STEPS):
        (loss, (_, mutated)), grads = s["value_and_grad"](params, extra, batch)
        jax_losses.append(float(loss))
        jax_grads.append(from_flax({"params": jax.device_get(grads)}))
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        extra = {**extra, **mutated}
        jax_params.append(from_flax({"params": jax.device_get(params)}))
    want_stats = from_flax({"batch_stats": jax.device_get(extra["batch_stats"])})

    task = s["port_task"]()
    trainer = Trainer(task, LR, WD, DECAY_EPOCHS, WARMUP, precision="32",
                      gradient_clip_val=5.0, no_decay_mask=False,
                      encoder_lr_scale=encoder_lr_scale)
    trainer.init_state(steps_per_epoch=1)
    losses, lrs, port_params = [], [], []
    key = "heatmap_loss" if task.name == "heatmap" else "loss_total"
    for _ in range(STEPS):
        m = trainer.train_step(s["torch_batch"])
        losses.append(float(m[key]))
        lrs.append(float(m["lr"]))
        port_params.append({k: p.detach().clone()
                            for k, p in task.model.named_parameters()})
    np.testing.assert_allclose(lrs, [float(schedule(i)) for i in range(STEPS)], rtol=1e-6)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert trainer.step == STEPS

    def scale_of(k):
        return encoder_lr_scale if "encoder" in k.split(".") else 1.0

    g0 = jax_grads[0]
    clip = _clip_factor(g0)
    floor = GRAD_FLOOR * clip * max(float(g.abs().max()) for g in g0.values())
    for k, want in jax_params[0].items():
        lr = lrs[0] * scale_of(k)
        g = g0[k] * clip
        scale = float(g.abs().max())
        tol = GRAD_TOL * scale if scale >= floor else floor
        gmin = (g.abs() - tol).clamp_min(0.0)
        ulps = 4.8e-7 * (want.abs() + lr) + 1e-5 * lr
        bound = lr * (1e-8 * tol / (gmin + 1e-8) ** 2).clamp(max=2.0) + ulps
        diff = (port_params[0][k] - want).abs()
        assert bool((diff <= bound * (1 + 1e-3)).all()), k

    worst = 0.0
    for k, want in jax_params[-1].items():
        adam_bound = 2 * 1.5 * sum(lrs) * scale_of(k)
        diff = (port_params[-1][k] - want).abs() - 2.4e-7 * want.abs()
        worst = max(worst, float(diff.max()) / adam_bound)
        assert float(diff.max()) <= adam_bound, k
    sd = task.model.state_dict()
    for k, w in want_stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=BN_TOL,
                                       rtol=BN_TOL, err_msg=k)
    print(f"{task.name} encoder_lr_scale {encoder_lr_scale}: after {STEPS} steps "
          f"the worst leaf is {worst:.3e} of its Adam bound; losses {losses} vs "
          f"{jax_losses}")
    return task, port_params


@pytest.mark.parametrize("name", ["heatmap", "heatmap_mvf_ex"])
def test_three_train_steps_match_jax_trainer(stages, name):
    task, port_params = _three_steps(stages[name])
    if name == "heatmap_mvf_ex":
        # Frozen backbones get no gradient, yet AdamW's decay moves them.
        start = stages[name]["port_task"]().model.state_dict()
        k = "heatmap_estimator_stereo_front.encoder.resnet.conv1.weight"
        assert not torch.equal(port_params[-1][k], start[k])


def test_encoder_lr_scale_matches_optax_masked_scale(stages):
    """``encoder_lr_scale`` 0.1 on stage 1: the port's per-group lr vs the
    JAX chain's ``optax.masked(optax.scale(0.1))`` over the encoder."""
    _three_steps(stages["heatmap"], encoder_lr_scale=0.1)


# -- eval and predict ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["heatmap", "heatmap_mvf_ex"])
def test_eval_metrics_and_predictions_match_jax(stages, name):
    """Eval mode (BN running stats): the per-sample metrics, in test mode
    too, and the predictions. Stage 2 with two refiner layers, so that test
    mode has the ``mid_0`` stages."""
    if name == "heatmap":
        s = stages[name]
        jtask, v, batch = s["jtask"], s["variables"], s["batch"]
        task = s["port_task"]()
    else:
        cfg = _cfg(name, num_former_layers=2)
        batch = _batch(name, np.random.default_rng(21))
        jtask = _jax_task(name, cfg)
        v = _jax_variables(jtask, batch, 22)
        task = MVFexTask(cfg, device="cpu")
        load_flax(task.model, v)
    torch_batch = {k: torch.from_numpy(x) for k, x in batch.items()}
    # Without test mode JAX's metrics are those of test mode less mid_*.
    want_all = jax.device_get(jax.jit(jtask.eval_metrics, static_argnums=2)(
        v, batch, True))
    for test_mode in (False, True):
        want = {k: w for k, w in want_all.items()
                if test_mode or not k.startswith("mid_")}
        got = task.eval_metrics(torch_batch, test_mode=test_mode)
        assert sorted(got) == sorted(want)
        n_stages = 1 if name == "heatmap" else 2 * (2 + test_mode)
        assert len(got) == 4 * n_stages
        if test_mode and name != "heatmap":
            assert "mid_0_stereo_back_mse_pts2d" in got
        for k, w in want.items():
            assert got[k].shape == (B,)
            np.testing.assert_allclose(got[k].numpy(), w, rtol=METRIC_RTOL,
                                       atol=1e-5, err_msg=k)
    want = jax.device_get(jax.jit(jtask.predict_outputs)(v, batch))
    got = task.predict_outputs(torch_batch)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k in ("pts2d", "pts2d_valid"):  # decoded peaks: equal
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:  # heatmap values
            np.testing.assert_allclose(g, w, atol=HM_ATOL, rtol=0, err_msg=k)


# -- configs -----------------------------------------------------------------------


@pytest.mark.parametrize("yaml_name", ["ego4view_syn_heatmap_stereo_front",
                                       "ego4view_syn_heatmap_stereo_back",
                                       "ego4view_syn_heatmap_mvfex-n1_jqa"])
def test_stage_configs_match_the_yamls(yaml_name):
    with open(os.path.join(CONFIGS, f"{yaml_name}.yaml")) as f:
        d = yaml.safe_load(f)
    args, trainer = d["model"]["init_args"], d["trainer"]
    stage1 = "mvfex" not in yaml_name
    assert (entry.STAGE1_CFG if stage1 else entry.STAGE2_CFG) == args["model_cfg"]
    o = entry.STAGE_OPTIM
    assert o["lr"] == args["lr"] and o["weight_decay"] == args["weight_decay"]
    assert list(o["lr_decay_epochs"]) == args["lr_decay_epochs"]
    assert o["warmup_iters"] == args["warmup_iters"]
    assert o["gradient_clip_val"] == trainer["gradient_clip_val"]
    assert trainer["gradient_clip_algorithm"] == "norm"
    assert entry.STAGE_PRECISION == str(trainer["precision"])
    assert entry.STAGE_BATCH == args["batch_size"]
    task = (HeatmapTask if stage1 else MVFexTask).name
    assert o["encoder_lr_scale"] == 1.0 and not no_decay_mask_for(task, 1.0)
    assert args["w_heatmap"] == 10.0
    assert d["model"]["class_path"].endswith(
        {"heatmap": "PoseHeatmapLightningModel",
         "heatmap_mvf_ex": "PoseHeatmapMVFEXLightningModel"}[task])
