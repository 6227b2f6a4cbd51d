"""The stereo-pair (V = 2) and real-world rigs of the port held against the
JAX package on the CPU: the same numpy inputs and the same random flax
weights (carried across by ``egorear_tpu_torch.convert.from_flax``), fp32
(the train steps fp64), 64 px, batch 2.

  * ``CameraRig.from_calib_file(...).project`` for each of the six camera
    models (``ego4view_{syn,rw}`` x all, ``_stereo_front``, ``_stereo_back``),
    chained and not, the real-world ones on random SE(3) transforms:
    pts2d within 1e-5, in_fov bitwise, anchors_out within 1e-5;
    ``apply_se3`` itself;
  * ``HeatmapMVFexNet`` at V = 2 (heatmaps, features) and ``EgoRearNet`` at
    V = 2 on the synthetic stereo-front rig and at V = 4 on the real-world
    rig with per-sample transforms: heatmaps 2e-5, argmax anchors bitwise,
    3D stages 9e-3 cm;
  * one fp64 train step of stage 2 at V = 2 and of stage 3 at V = 2 (syn)
    and V = 4 (rw): the loss terms, per-leaf gradients, the updated
    parameters (AdamW's per-element bound) and BN running stats vs the JAX
    loss, ``jax.grad`` and the optax update that the JAX trainer's step runs;
    the V = 2 ``eval_metrics`` keys and values;
  * the real-world synthetic tree against the JAX generator's, and the
    real-world ``Pose3DDataset`` items (``camera_pos`` all and front) of
    both packages on it, bitwise; ``run.build_task``'s ``test_on_rw`` rig.
"""

from __future__ import annotations

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egorear_tpu.data.datasets import get_dataset as jax_get_dataset
from egorear_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic
from egorear_tpu.models.configs import EgoRearNetCfg as JaxEgoRearNetCfg
from egorear_tpu.models.configs import MVFexNetCfg as JaxMVFexNetCfg
from egorear_tpu.models.mvfex import HeatmapMVFexNet as JaxHeatmapMVFexNet
from egorear_tpu.models.pose3d import EgoRearNet as JaxEgoRearNet
from egorear_tpu.ops.camera import CameraRig as JaxRig
from egorear_tpu.ops.camera import apply_se3 as jax_apply_se3
from egorear_tpu.ops.heatmap import argmax_2d as jax_argmax_2d
from egorear_tpu.train.optim import make_optimizer as jax_make_optimizer
from egorear_tpu.train.tasks import MVFexTask as JaxMVFexTask
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu_torch import entry, run
from egorear_tpu_torch.config.loader import load_config
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.data.datasets import get_dataset
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
from egorear_tpu_torch.models.configs import EgoRearNetCfg, MVFexNetCfg
from egorear_tpu_torch.models.mvfex import HeatmapMVFexNet
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.ops.camera import CameraRig, apply_se3
from egorear_tpu_torch.ops.heatmap import argmax_2d
from egorear_tpu_torch.train.tasks import MVFexTask, Pose3DTask
from egorear_tpu_torch.train.trainer import Trainer
from test_torch_port_models import random_variables
from torch_threads import torch_threads  # noqa: F401

SIZE, B, HEATMAP_BIAS = 64, 2, 0.3
PTS2D_ATOL = 1e-5
HM_ATOL, FEAT_ATOL, FEAT_RTOL, P3D_ATOL = 2e-5, 1e-5, 1e-4, 9e-3
METRIC_RTOL = 1e-4
GRAD_FLOOR = 1e-8
LR, WARMUP, DECAY_EPOCHS = 1e-5, 2, (2,)
WD = {"heatmap_mvf_ex": 5e-3, "pose_3d_mvf_ex": 0.1}
CAMERA_MODELS = [f"ego4view_{v}{s}" for v in ("syn", "rw")
                 for s in ("", "_stereo_front", "_stereo_back")]
CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the fp64 steps are the suite's heaviest, and
    the parallel test workers would otherwise oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def se3(rng, shape, max_angle: float, shift: float = 0.05) -> np.ndarray:
    """Random rigid transforms (*shape, 4, 4), fp32: a rotation by up to
    ``max_angle`` radians about a random axis (Rodrigues) and a translation
    of sd ``shift`` metres."""
    axis = rng.normal(size=(*shape, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-max_angle, max_angle, size=shape)[..., None, None]
    k = np.zeros((*shape, 3, 3))
    k[..., 0, 1], k[..., 0, 2], k[..., 1, 2] = -axis[..., 2], axis[..., 1], -axis[..., 0]
    k = k - np.swapaxes(k, -1, -2)
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    m = np.tile(np.eye(4), (*shape, 1, 1))
    m[..., :3, :3] = rot
    m[..., :3, 3] = rng.normal(scale=shift, size=(*shape, 3))
    return m.astype(np.float32)


# -- the rigs ----------------------------------------------------------------------


@pytest.mark.parametrize("chained", [True, False])
@pytest.mark.parametrize("camera_model", CAMERA_MODELS)
def test_rig_project_matches_jax(camera_model, chained):
    rng = np.random.default_rng(CAMERA_MODELS.index(camera_model))
    pts = np.stack([rng.uniform(-60, 60, (3, 16)), rng.uniform(-60, 60, (3, 16)),
                    rng.uniform(-20, 80, (3, 16))], axis=-1).astype(np.float32)
    pts[0, 0] = (0.0, 0.0, 30.0)  # r == 0 on the synthetic front-left view
    want_rig = JaxRig.from_calib_file(camera_model, chained=chained)
    rig = CameraRig.from_calib_file(camera_model, chained=chained)
    assert (rig.is_rw, rig.num_views) == (want_rig.is_rw, want_rig.num_views)
    assert rig.num_views == (4 if camera_model.endswith(("_syn", "_rw")) else 2)
    for f in ("poly_w2c", "center", "image_size_hw", "sign", "offset",
              "final_sign", "final_offset"):
        np.testing.assert_array_equal(getattr(rig, f).numpy(),
                                      np.asarray(getattr(want_rig, f)), err_msg=f)
    mats = se3(rng, (3, rig.num_views), np.pi) if rig.is_rw else None
    want = want_rig.project(pts, mats)
    got = rig.project(torch.from_numpy(pts),
                      None if mats is None else torch.from_numpy(mats))
    assert got[0].shape == (3, rig.num_views, 16, 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=PTS2D_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=PTS2D_ATOL,
                               rtol=0)
    assert 0 < got[1].float().mean() < 1  # both in- and out-of-view points
    if rig.is_rw:  # the real-world rig hands the anchors back unchanged
        np.testing.assert_array_equal(got[2].numpy(), pts)


def test_apply_se3_matches_jax():
    """Batched (B, V, 4, 4) transforms on (B, 1, J, 3) points and one
    transform on (J, 3) points, fp32: within fp32 rounding of JAX's
    ``Precision.HIGHEST`` einsum, and exact on the identity."""
    rng = np.random.default_rng(11)
    mats = se3(rng, (3, 4), np.pi, shift=0.5)
    pts = rng.normal(scale=0.6, size=(3, 1, 16, 3)).astype(np.float32)
    for m, p in ((mats, pts), (mats[1, 2], pts[0, 0])):
        want = np.asarray(jax_apply_se3(m, p))
        got = apply_se3(torch.from_numpy(m), torch.from_numpy(p))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    eye = torch.eye(4).expand(2, 4, 4)
    p = torch.from_numpy(pts[:2, 0])
    assert torch.equal(apply_se3(eye, p), p)


# -- the models at 64 px -----------------------------------------------------------------


def _cascade_cfg(num_views: int, camera_model: str) -> dict:
    return copy.deepcopy(dict(entry.FLAGSHIP_CFG, image_size=[SIZE, SIZE],
                              num_views=num_views, camera_model=camera_model))


def _mvfex_cfg(num_views: int) -> dict:
    cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[SIZE, SIZE],
                             num_views=num_views))
    cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    return cfg


# (views, camera model, seed): seeds whose initial heatmaps keep every
# top-1/top-2 gap and every distance to the 0.5 threshold above 5 x HM_ATOL,
# the margins under which the argmax decode is stable against the heatmap
# error (test_cascade_anchors_match_jax_bitwise checks them).
CASCADES = {"syn_stereo_front": (2, "ego4view_syn_stereo_front", 23),
            "rw": (4, "ego4view_rw", 21)}


@pytest.fixture(scope="module")
def cascades():
    """{case: (JAX (preds, hms), port (preds, hms), JAX rig, transforms)}:
    eval-mode forwards on the same random weights and images; the real-world
    case with small per-sample rotations, so that the proposal projects
    partly into every view."""
    out = {}
    for case, (V, camera_model, seed) in CASCADES.items():
        cfg = _cascade_cfg(V, camera_model)
        jnet = JaxEgoRearNet(cfg=JaxEgoRearNetCfg.from_dict(copy.deepcopy(cfg)))
        jrig = JaxRig.from_calib_file(camera_model)
        rng = np.random.default_rng(seed)
        ctm = se3(rng, (B, V), 0.2) if jrig.is_rw else None
        shapes = jax.eval_shape(lambda: jnet.init(
            jax.random.PRNGKey(0), jnp.zeros((B, V, 3, SIZE, SIZE)), jrig, ctm))
        variables = random_variables(shapes, rng, heatmap_bias=HEATMAP_BIAS)
        img = rng.normal(size=(B, V, 3, SIZE, SIZE)).astype(np.float32)
        want = jax.tree.map(np.asarray, jax.jit(
            lambda v, x, c: jnet.apply(v, x, jrig, c))(variables, img, ctm))
        model = load_flax(EgoRearNet(EgoRearNetCfg.from_dict(copy.deepcopy(cfg))),
                          variables).eval()
        assert hasattr(model.heatmap_estimator, "heatmap_estimator_stereo_back") == (V >= 3)
        with torch.inference_mode():
            got = model(torch.from_numpy(img), CameraRig.from_calib_file(camera_model),
                        None if ctm is None else torch.from_numpy(ctm))
        out[case] = (want, got, jrig, ctm)
    return out


@pytest.mark.parametrize("case", sorted(CASCADES))
def test_cascade_heatmaps_match_jax(cascades, case):
    (_, want), (_, got), _, _ = cascades[case]
    V = CASCADES[case][0]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, V, 15, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=HM_ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASCADES))
def test_cascade_anchors_match_jax_bitwise(cascades, case):
    (want_p3d, want_hm), (got_p3d, got_hm), jrig, ctm = cascades[case]
    top = np.sort(want_hm[0].reshape(-1, (SIZE // 4) ** 2), axis=-1)
    assert (top[:, -1] - top[:, -2]).min() > 5 * HM_ATOL
    assert np.abs(top[:, -1] - 0.5).min() > 5 * HM_ATOL
    want = jax_argmax_2d(want_hm[0], threshold=0.5, normalize=True)
    got = argmax_2d(got_hm[0], threshold=0.5, normalize=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].float().mean() < 1
    _, want_fov, _ = jrig.project(want_p3d[0], ctm)
    _, got_fov, _ = CameraRig.from_calib_file(CASCADES[case][1]).project(
        got_p3d[0], None if ctm is None else torch.from_numpy(ctm))
    np.testing.assert_array_equal(got_fov.numpy(), np.asarray(want_fov))
    assert 0 < got_fov.float().mean() < 1


@pytest.mark.parametrize("case", sorted(CASCADES))
def test_cascade_preds_3d_match_jax(cascades, case):
    (want, _), (got, _), _, _ = cascades[case]
    assert len(got) == len(want) == 4
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"{case}: preds_3d stage max-abs divergence (cm) {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 16, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=P3D_ATOL, rtol=0)


def test_mvfex_v2_forward_matches_jax():
    """The stage-2 network on the front pair alone: no back estimator or
    head on either side, heatmaps (B, 2, J, h, w) and the view-major
    features of every stage."""
    cfg = _mvfex_cfg(2)
    jnet = JaxHeatmapMVFexNet(cfg=JaxMVFexNetCfg.from_dict(copy.deepcopy(cfg)))
    rng = np.random.default_rng(30)
    img = rng.normal(size=(B, 2, 3, SIZE, SIZE)).astype(np.float32)
    variables = random_variables(jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), img)), rng, heatmap_bias=HEATMAP_BIAS)
    assert "heatmap_estimator_stereo_back" not in variables["params"]
    want_hm, want_feat = jax.tree.map(
        np.asarray, jax.jit(lambda v, x: jnet.apply(v, x))(variables, img))
    model = load_flax(HeatmapMVFexNet(MVFexNetCfg.from_dict(copy.deepcopy(cfg))),
                      variables).eval()
    with torch.inference_mode():
        got_hm, got_feat = model(torch.from_numpy(img))
    assert len(got_hm) == len(want_hm) == len(got_feat) == 2
    for g, w in zip(got_hm, want_hm):
        assert g.shape == w.shape == (B, 2, 15, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=HM_ATOL, rtol=0)
    for g, w in zip(got_feat, want_feat):  # (V, B, h, w, C) -> (V*B, C, h, w)
        w = w.reshape(-1, *w.shape[2:]).transpose(0, 3, 1, 2)
        assert g.shape == w.shape == (2 * B, 128, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=FEAT_ATOL, rtol=FEAT_RTOL)


# -- one train step at V = 2 and on the real-world rig -----------------------------------


# (task, views, camera model, seed). Each step runs in fp64 on both sides
# (``jax.enable_x64``, scoped, and the port's model in double), as
# tests/test_torch_port_stages.py holds stage 1. In fp32 the 64 px
# train-mode step is ill-conditioned: the two frameworks' rounding
# differences carry a ReLU input or a sampling corner across its kink at
# most seeds, which moves up to 234 leaves' gradients by 1e-4 to 0.35 of
# their scale (tests/scan_step_seeds.py, seeds 100-109).
# Both packages keep the lazy sampling in fp32 by contract, so in fp64 the
# two steps differ only by the rounding of those fp32 cores. Each seed is
# the first from 100 that passes JAX's own conditioning check in
# test_train_step_matches_jax, which does not look at the port; no seed was
# dropped.
STEPS = {"stage2_v2": ("heatmap_mvf_ex", 2, "ego4view_syn_stereo_front", 100),
         "stage3_v2_syn": ("pose_3d_mvf_ex", 2, "ego4view_syn_stereo_front", 100),
         "stage3_v4_rw": ("pose_3d_mvf_ex", 4, "ego4view_rw", 100)}
# fp64 step tolerances: gradients per leaf, of its largest JAX value; loss
# terms relative; BN running stats absolute and relative.
GRAD_TOL64, LOSS_RTOL64, BN_TOL64 = 2e-5, 1e-8, 1e-7


def step_case(task_name: str, cfg: dict, seed: int,
              camera_model: str = "ego4view_syn", **variables_kw):
    """The JAX task, random variables (``random_variables`` with
    ``variables_kw``), a seeded batch (real-world: its per-sample
    transforms) and the port's task of ``task_name`` on the model config
    ``cfg``."""
    V = cfg["num_views"]
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(B, V, 3, SIZE, SIZE)).astype(np.float32)
    batch = {"img": img, "gt_heatmap": rng.uniform(
        size=(B, V, 15, SIZE // 4, SIZE // 4)).astype(np.float32)}
    if task_name == "heatmap_mvf_ex":
        kw = {}
        jtask = JaxMVFexTask(copy.deepcopy(cfg))
        init = lambda: jtask.model.init(jax.random.PRNGKey(0), img)  # noqa: E731
    else:
        kw = dict(dataset_type=("ego4view_rw_pose3d" if "rw" in camera_model
                                else "ego4view_syn_pose3d"))
        jtask = JaxPose3DTask(copy.deepcopy(cfg), **kw)
        u = rng.uniform(size=(B, 16, 3))
        batch["gt_pose"] = (np.array([-60.0, -60.0, -20.0])
                            + u * [120.0, 120.0, 100.0]).astype(np.float32)
        if jtask.is_rw:
            batch["coord_trans_mat"] = se3(rng, (B, V), 0.2)
        init = lambda: jtask.model.init(  # noqa: E731
            jax.random.PRNGKey(0), img, jtask.rig, batch.get("coord_trans_mat"),
            train=False)
    variables = random_variables(jax.eval_shape(init), rng,
                                 **{"heatmap_bias": HEATMAP_BIAS, **variables_kw})
    task = {"heatmap_mvf_ex": MVFexTask, "pose_3d_mvf_ex": Pose3DTask}[task_name](
        copy.deepcopy(cfg), device="cpu", **kw)
    load_flax(task.model, variables)
    return jtask, variables, batch, task


def _step_case(case: str):
    """:func:`step_case` of one STEPS case."""
    task_name, V, camera_model, seed = STEPS[case]
    cfg = (_mvfex_cfg(V) if task_name == "heatmap_mvf_ex"
           else _cascade_cfg(V, camera_model))
    return step_case(task_name, cfg, seed, camera_model)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_matches_jax(case):
    """One fp64 step from the same state: :func:`check_train_step`."""
    task_name, V = STEPS[case][:2]
    check_train_step(case, task_name, lambda seed: _step_case(case),
                     [STEPS[case][3]], bn_layers=2 * 20 * (2 if V >= 3 else 1))


def check_train_step(case, task_name, make_case, seeds, bn_layers: int,
                     grad_tol: float = GRAD_TOL64,
                     floor_leaves: tuple = ("k_proj.bias",)):
    """One fp64 step from the same state, at the first of ``seeds`` that
    passes JAX's conditioning check (``make_case(seed)`` gives
    :func:`step_case`'s tuple): one-fp32-ulp noise (2^-23 relative) on
    every parameter moves no leaf of JAX's own gradient by more than a
    quarter of ``grad_tol`` (GRAD_TOL64 unless given) of its scale, so that
    no kink lies within the perturbation; the check does not look at the
    port. Then: the noise
    moves JAX's loss terms more than the port differs from them, so that
    the perturbation covers the two steps' difference; the loss terms
    within LOSS_RTOL64, each leaf's gradient within grad_tol of its
    largest JAX value (a leaf below GRAD_FLOOR of the largest gradient is
    one of ``floor_leaves``, by default the key-projection biases of softmax
    attention, whose gradient is rounding, and both keep it below the
    floor; the zero sets equal), the ``bn_layers`` BN running
    stats (mean and var each) within BN_TOL64, and every updated element
    within AdamW's per-element bound of the optax update (the bound of
    ``tests/test_torch_port_stages.py``'s first step)."""
    stage3 = task_name == "pose_3d_mvf_ex"
    value_and_grad = None
    for seed in seeds:
        jtask, v, batch, task = make_case(seed)
        params, batch64 = _f64(v["params"]), _f64(batch)
        extra = {"batch_stats": _f64(v["batch_stats"])}
        sign = np.random.default_rng(0)
        noisy = jax.tree.map(lambda x: x * (1 + sign.choice([-1.0, 1.0], size=x.shape)
                                            * 2.0**-23), params)
        with jax.enable_x64(True):
            if value_and_grad is None:  # one compile: the seeds share a config
                value_and_grad = jax.jit(jax.value_and_grad(
                    lambda p, ev, b, jtask=jtask: jtask.loss(p, ev, b, True),
                    has_aux=True))
            (_, (jm, mutated)), grads = value_and_grad(params, extra, batch64)
            (_, (jm_noisy, _)), grads_noisy = value_and_grad(noisy, extra, batch64)
        want_grads = from_flax({"params": jax.device_get(grads)})
        moved = from_flax({"params": jax.device_get(grads_noisy)})
        gmax = max(float(w.abs().max()) for w in want_grads.values())
        floor = GRAD_FLOOR * gmax
        cond = 0.0
        for k, w in want_grads.items():
            scale = float(w.abs().max())
            if scale >= floor:
                cond = max(cond, float((moved[k] - w).abs().max()) / scale)
        if cond <= grad_tol / 4:
            break
    else:
        raise AssertionError(f"{case} is ill-conditioned at every seed of "
                             f"{list(seeds)}: {cond:.3e} at the last")
    with jax.enable_x64(True):
        tx, schedule = jax_make_optimizer(LR, WD[task_name], WARMUP, DECAY_EPOCHS, 1,
                                          grad_clip_norm=5.0, no_decay_mask=stage3,
                                          params=params)
        updates, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(grads, params)
        want_params = from_flax({"params": jax.device_get(
            jax.tree.map(lambda p, u: p + u, params, updates))})
        lr0 = float(schedule(0))
    want_stats = from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])})
    jm, jm_noisy = jax.device_get(jm), jax.device_get(jm_noisy)

    task.model.double()
    loss_terms = {}
    task_loss = task.loss

    def loss(b, *args):  # the step's own fp64 loss terms
        out = task_loss(b, *args)
        loss_terms.update({k: float(t.detach()) for k, t in out[1].items()})
        return out

    task.loss = loss
    trainer = Trainer(task, LR, WD[task_name], DECAY_EPOCHS, WARMUP, precision="32",
                      gradient_clip_val=5.0, no_decay_mask=stage3)
    trainer.init_state(steps_per_epoch=1)
    named = dict(task.model.named_parameters())
    grads_seen = {}
    for k, p in named.items():  # the step's clipped gradients, before Adam
        p.register_hook(lambda g, k=k: grads_seen.__setitem__(k, g.detach().clone()))
    m = trainer.train_step({k: torch.from_numpy(x) for k, x in batch64.items()})
    assert sorted(m) == sorted(list(jm) + ["lr"]) and sorted(loss_terms) == sorted(jm)
    rel = {k: abs(loss_terms[k] - float(w)) / abs(float(w)) for k, w in jm.items()}
    noise = max(abs(float(jm_noisy[k]) - float(w)) / abs(float(w)) for k, w in jm.items())
    assert max(rel.values()) <= noise, (rel, noise)
    for k, w in jm.items():
        assert rel[k] <= LOSS_RTOL64, (k, loss_terms[k], float(w))
    lr = float(m["lr"])
    np.testing.assert_allclose(lr, lr0, rtol=1e-6)

    zero_jax = {k for k, w in want_grads.items() if not bool(w.any())}
    zero_port = {k for k in named if k not in grads_seen or not bool(grads_seen[k].any())}
    assert zero_jax == zero_port
    norm = float(torch.sqrt(sum((w ** 2).sum() for w in want_grads.values())))
    clip = min(1.0, 5.0 / norm)
    worst = (0.0, "")
    for k, w in want_grads.items():
        g = grads_seen.get(k, torch.zeros_like(w))
        assert g.dtype == w.dtype == torch.float64, k
        scale = float(w.abs().max())
        if scale == 0:
            continue
        if scale < floor:
            assert k.endswith(floor_leaves) and float(g.abs().max()) <= floor, k
            continue
        err = float((g - w).abs().max())
        worst = max(worst, (err / scale, k))
        assert err <= grad_tol * scale, f"{k}: {err:.3e} > {grad_tol:g} x {scale:.3e}"
        # AdamW's first step moves an element by lr * g / (|g| + eps) plus the
        # decay: bounded over the gradient's tolerance interval, plus ulps.
        gc, tl = w * clip, grad_tol * scale * clip
        gmin = (gc.abs() - tl).clamp_min(0.0)
        want = want_params[k]
        bound = (lr * (1e-8 * tl / (gmin + 1e-8) ** 2).clamp(max=2.0)
                 + 4.8e-7 * (want.abs() + lr) + 1e-5 * lr)
        diff = (named[k].detach() - want).abs()
        assert bool((diff <= bound * (1 + 1e-3)).all()), k
    sd = task.model.state_dict()
    n = 0
    for k, w in want_stats.items():
        if "running" in k:
            n += 1
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=BN_TOL64,
                                       rtol=BN_TOL64, err_msg=k)
    assert n == bn_layers
    print(f"{case} (seed {seed}): JAX's one-ulp move {cond:.3e}; worst leaf gradient max-abs/scale "
          f"{worst[0]:.3e} ({worst[1]}); loss terms {max(rel.values()):.3e} vs the "
          f"noise's {noise:.3e}")


def test_mvfex_eval_metrics_match_jax_at_v2():
    """The V = 2 stage-2 metrics: only ``*_stereo_front`` columns, as the
    JAX task emits them, in test mode too, each within METRIC_RTOL."""
    jtask, v, batch, task = _step_case("stage2_v2")
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    want = jax.device_get(jax.jit(lambda vs, b: jtask.eval_metrics(
        vs, b, test_mode=True))(variables, batch))
    got = task.eval_metrics({k: torch.from_numpy(x) for k, x in batch.items()},
                            test_mode=True)
    assert sorted(got) == sorted(want) and len(got) == 8
    assert all(k.split("_stereo_")[1].startswith("front_") for k in got)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=METRIC_RTOL, atol=1e-6,
                                   err_msg=k)


# -- the real-world tree and items -----------------------------------------------------


def _tree_files(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**"), recursive=True))


@pytest.fixture(scope="module")
def rw_trees(tmp_path_factory):
    """The real-world tree of each generator at one seed."""
    base = tmp_path_factory.mktemp("rw_trees")
    kw = dict(num_chars=2, num_seqs=2, frames_per_seq=2, eval_frames_per_seq=1,
              image_size=48, write_heatmaps=True, seed=9)
    return (jax_make_synthetic(str(base / "jax"), "rw", **kw),
            make_synthetic_dataset(str(base / "port"), "rw", **kw))


def test_rw_synthetic_tree_matches_jax(rw_trees):
    """The same files: PNG images and metadata bitwise, split files equal,
    ``device_pts3d`` exact, ``*_pts2d`` within 1e-3 px (the two frameworks'
    fp32 projections through the sequence's transforms), heatmap NPYs
    within 1e-6."""
    want_root, got_root = rw_trees
    files = _tree_files(want_root)
    assert _tree_files(got_root) == files
    n = {}
    worst_2d = worst_hm = 0.0
    for rel in files:
        a, b = os.path.join(want_root, rel), os.path.join(got_root, rel)
        if os.path.isdir(a):
            continue
        kind = "meta" if rel.endswith("_metadata.json") else rel.rsplit(".", 1)[-1]
        n[kind] = n.get(kind, 0) + 1
        if kind in ("meta", "txt", "png"):
            assert open(a, "rb").read() == open(b, "rb").read(), rel
        elif kind == "json":
            ja, jb = json.load(open(a)), json.load(open(b))
            for joint, entry in ja["joints"].items():
                assert list(entry) == list(jb["joints"][joint])
                for key, v in entry.items():
                    got = np.asarray(jb["joints"][joint][key])
                    if key == "device_pts3d":
                        np.testing.assert_array_equal(got, v)
                    else:
                        worst_2d = max(worst_2d, float(np.abs(got - v).max()))
        else:
            worst_hm = max(worst_hm, float(np.abs(np.load(a) - np.load(b)).max()))
    assert worst_2d <= 1e-3 and worst_hm <= 1e-6, (worst_2d, worst_hm)
    # 2 days x 2 sequences x (2 + 1 + 1) frames; a metadata file a sequence.
    assert n == {"json": 16, "png": 4 * 16, "npy": 4 * 16, "meta": 12, "txt": 3}
    lines = open(os.path.join(got_root, "test.txt")).read().split()
    assert lines[0] == "2024-01-01/S0/seq0-test" and len(lines) == 4


@pytest.mark.parametrize("camera_pos", ["all", "front"])
def test_rw_pose3d_items_match_jax(rw_trees, camera_pos):
    root = rw_trees[1]
    for split in ("train", "test"):
        want = jax_get_dataset("ego4view_rw_pose3d", root, split, camera_pos=camera_pos,
                               use_native_loader=False)
        got = get_dataset("ego4view_rw_pose3d", root, split, camera_pos=camera_pos,
                          use_native_loader=False)
        assert len(got) == len(want) == (8 if split == "train" else 4)
        V = 4 if camera_pos == "all" else 2
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert list(g) == list(w) and g["frame_path"] == w["frame_path"]
            assert g["coord_trans_mat"].shape == (V, 4, 4)
            for k in ("img", "gt_heatmap", "gt_pose", "coord_trans_mat"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", ["ego4view_syn_pose3d", "ego4view_syn_pose3d_stereo_front"])
def test_build_task_test_on_rw_gives_jax_rig(name):
    """``test_on_rw`` rewrites the camera model and dataset type as the
    reference's constructor does; the port's rig is the JAX package's."""
    import run as jax_run

    cfg = load_config(os.path.join(CONFIGS, f"{name}.yaml"),
                      ["--model.test_on_rw", "true", "--model.model_cfg."
                       "heatmap_mvf_cfg.encoder_cfg.resnet_cfg.use_imagenet_pretrain",
                       "false"])
    jcfg = jax_run.load_config(os.path.join(CONFIGS, f"{name}.yaml"),
                               ["--model.test_on_rw", "true"])
    jtask, jargs = jax_run.build_task(jcfg)
    task, args = run.build_task(cfg, "cpu")
    assert args["dataset_type"] == jargs["dataset_type"] == "ego4view_rw_pose3d"
    assert task.is_rw and jtask.is_rw
    assert (task.rig.is_rw, task.rig.num_views) == (jtask.rig.is_rw, jtask.rig.num_views)
    for f in ("poly_w2c", "center", "image_size_hw"):
        np.testing.assert_array_equal(getattr(task.rig, f).numpy(),
                                      np.asarray(getattr(jtask.rig, f)))
