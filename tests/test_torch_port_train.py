"""The PyTorch port's training slice held against the JAX package on the
CPU: the same numpy inputs and the same random flax weights (carried across
by ``egorear_tpu_torch.convert.from_flax``), fp32, 64 px, batch 2.

  * the lazy-sampling backward (plain version) vs ``jax.vjp`` of the Pallas
    path, which is ``_lazy_bwd_rule``, and vs torch autograd through the
    plain forward; the autograd node on every input;
  * train-mode BatchNorm (flax semantics) and its running stats;
  * the pose metrics, the lr schedule, the no-decay mask, clipping;
  * ``Pose3DTask.loss``, the per-leaf gradients of the whole cascade vs
    ``jax.grad`` of the JAX ``Pose3DTask.loss``, and three fp32 train steps
    vs the JAX trainer's step (``trainer.py:275-321``).

Gradients of the whole cascade: a leaf whose largest JAX gradient is below
``GRAD_FLOOR`` (1e-8) of the model's largest gradient is zero in exact
arithmetic -- the spatial attention's key-projection biases, to which the
softmax is invariant -- and carries only rounding; both frameworks must keep
it below that floor. Every other leaf must agree within 1e-4 of its own
largest JAX value.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
from jax.experimental.pallas import tpu as pltpu

from egorear_tpu.models import backbone as jbackbone
from egorear_tpu.ops import metrics as jmetrics
from egorear_tpu.ops.deform_attn import lazy_deform_sample as jax_lazy_sample
from egorear_tpu.train.optim import _no_decay_mask, make_lr_schedule as jax_schedule
from egorear_tpu.train.optim import make_optimizer as jax_make_optimizer
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.entry import flagship_cfg_dict
from egorear_tpu_torch.models import backbone
from egorear_tpu_torch.models.layers import dropout_generator
from egorear_tpu_torch.ops import deform_attn, metrics
from egorear_tpu_torch.ops.deform_attn import (
    LazyDeformSample,
    lazy_deform_sample,
    lazy_deform_sample_backward_plain,
    lazy_deform_sample_plain,
)
from egorear_tpu_torch.train import optim
from egorear_tpu_torch.train.tasks import Pose3DTask
from egorear_tpu_torch.train.trainer import Trainer
from test_torch_port_models import init_variables, nchw, random_variables, t
from test_torch_port_ops import _sample_case
from torch_threads import torch_threads  # noqa: F401

SIZE, B, SEED, HEATMAP_BIAS = 64, 2, 1, 0.3
# Lazy-sampling backward: max-abs error over the largest reference value
# (tests/test_ops_deform_attn.py:218 holds the JAX paths to 2e-3 absolute;
# measured here <= 4e-7 of scale).
BWD_RTOL = 1e-5
BN_TOL = 1e-5
METRIC_RTOL = 1e-5
LOSS_RTOL = 1e-5  # measured <= 1.2e-6
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-8  # measured worst leaf 1.9e-5
# Three train steps: warmup over 2 steps and a decay at step 2; a large
# decay, so that the decoupled decay shows in the parameters (see the test).
LR, WD, WARMUP, DECAY_EPOCHS, STEPS = 1e-5, 0.1, 2, (2,), 3


# -- lazy-sampling backward -----------------------------------------------------


def _upstream(feat, pos, seed=7):
    rng = np.random.default_rng(seed)
    Bq = feat.shape[0]
    g_feat = rng.normal(size=(Bq, 15, 4, feat.shape[-1])).astype(np.float32)
    g_pos = (rng.normal(size=(Bq, 15, 4, pos.shape[-1])).astype(np.float32)
             if pos is not None else None)
    g_one = rng.normal(size=(Bq, 15, 4, 1)).astype(np.float32)
    return g_feat, g_pos, g_one


def _assert_grads_close(got, want, names, rtol=BWD_RTOL):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol:g} x {scale:.3e}"


@pytest.mark.parametrize("pos_mode", ["none", "shared", "interleaved", "block"])
def test_backward_plain_matches_jax_and_autograd(pos_mode):
    feat, loc, w, pos, block = _sample_case(pos_mode)
    g_feat, g_pos, g_one = _upstream(feat, pos)
    T = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = lazy_deform_sample_backward_plain(T(feat), T(loc), T(w), T(pos), block,
                                            T(g_feat), T(g_pos), T(g_one))
    got = [None if g is None else g.numpy() for g in got]
    names = ("d_feat", "d_loc", "d_attn_w", "d_pos")

    # jax.vjp of the Pallas path (interpreted): its VJP is _lazy_bwd_rule.
    with pltpu.force_tpu_interpret_mode():
        args = [None if x is None else jnp.asarray(x) for x in (feat, loc, w, pos)]
        _, vjp = jax.vjp(lambda fe, l, ww, p: jax_lazy_sample(
            fe, l, ww, pos=p, impl="pallas", pos_block=block), *args)
        want = vjp((g_feat, g_pos, g_one))
    _assert_grads_close(got, want, names)

    # torch autograd through the plain (grid_sample) forward.
    ins = [None if x is None else torch.from_numpy(x).requires_grad_()
           for x in (feat, loc, w, pos)]
    out = lazy_deform_sample_plain(*ins, pos_block=block)
    total = sum((o * torch.from_numpy(g)).sum()
                for o, g in zip(out, (g_feat, g_pos, g_one)) if o is not None)
    total.backward()
    _assert_grads_close(got, [None if x is None else x.grad.numpy() for x in ins],
                        names)


def test_lazy_sample_is_differentiable_in_every_input():
    """The fault of the first slice: the CUDA path gave outputs without a
    grad_fn. Every device now goes through LazyDeformSample; on the CPU its
    backward is the plain VJP, and it reaches loc, attn_w, feat and pos."""
    feat, loc, w, pos, block = _sample_case("block")
    ins = [torch.from_numpy(x).requires_grad_() for x in (feat, loc, w, pos)]
    out = lazy_deform_sample(*ins, pos_block=block)
    for o in out:
        assert type(o.grad_fn).__name__ == "LazyDeformSampleBackward"
    sum(o.square().sum() for o in out).backward()
    for name, x in zip(("feat", "loc", "attn_w", "pos"), ins):
        assert x.grad is not None and float(x.grad.abs().max()) > 0, name
    # bf16 locations: sampled in fp32 inside the graph, gradient cast back.
    loc16 = torch.from_numpy(loc).bfloat16().requires_grad_()
    s = lazy_deform_sample(torch.from_numpy(feat), loc16, torch.from_numpy(w))
    s[0].sum().backward()
    assert loc16.grad.dtype == torch.bfloat16


def test_lazy_sample_backward_honours_needs_input_grad(monkeypatch):
    """A detached feature map (the MVFex refiners sample detached tokens)
    gets no d_feat: the backward is asked not to build it."""
    calls = []
    real = deform_attn.lazy_deform_sample_backward_plain

    def spy(*args):
        calls.append(args[-2:])
        return real(*args)

    monkeypatch.setattr(deform_attn, "lazy_deform_sample_backward_plain", spy)
    feat, loc, w, pos, block = _sample_case("block")
    loc_t, w_t, pos_t = (torch.from_numpy(x).requires_grad_() for x in (loc, w, pos))
    out = LazyDeformSample.apply(torch.from_numpy(feat), loc_t, w_t, pos_t, block, False)
    out[1].sum().backward()
    assert calls == [(False, True)]
    assert pos_t.grad is not None and loc_t.grad is not None


# -- train-mode BatchNorm ---------------------------------------------------------


class _FlaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5)(x)


def test_train_batchnorm_matches_flax_on_a_2x2_map():
    """2x2 maps of 2 samples: n = 8, where torch's unbiased running
    variance would be 8/7 of flax's."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 2, 2, 16)) * 2.0 + 0.5).astype(np.float32)
    variables = init_variables(_FlaxBN(), 4, x)
    want, mutated = _FlaxBN().apply(variables, x, mutable=["batch_stats"])
    sd = from_flax({"params": variables["params"]["BatchNorm_0"],
                    "batch_stats": variables["batch_stats"]["BatchNorm_0"]})
    bn = backbone.BatchNorm2d(16, eps=1e-5)
    bn.load_state_dict(sd)
    got = bn.train()(t(nchw(x)))
    np.testing.assert_allclose(got.detach().numpy(), nchw(want), atol=BN_TOL, rtol=0)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=BN_TOL, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=BN_TOL, rtol=0)


def test_train_backbone_matches_flax():
    """ResNet18 + FPN in train mode at 64 px (2x2 stride-32 maps): outputs,
    within 1e-5 of each output's largest value (batch statistics over 8
    values amplify the rounding of the 20 stacked layers), and every running
    stat after one step, 1e-5."""
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jbackbone.BackboneWithFPN()
    variables = init_variables(jmod, 7, x)
    (want_fpn, want_pyr), mutated = jmod.apply(variables, x, train=True,
                                               mutable=["batch_stats"])
    mod = load_flax(backbone.BackboneWithFPN(), variables).train()
    got_fpn, got_pyr = mod(t(nchw(x)))
    for g, w in zip([got_fpn, *got_pyr], [want_fpn, *want_pyr]):
        w = nchw(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=BN_TOL * float(np.abs(w).max()))
    want_stats = from_flax({"batch_stats": mutated["batch_stats"]})
    sd = mod.state_dict()
    assert len(want_stats) == 3 * 20 and all(k in sd for k in want_stats)
    for k, v in want_stats.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=BN_TOL, rtol=0,
                                   err_msg=k)


# -- metrics, schedule, mask, clipping --------------------------------------------


def _poses():
    """(B, J, 3) predictions and ground truth in cm; sample 1's prediction is
    a scaled, rotated, shifted MIRROR image of its ground truth, so the SVD
    solution has det(U V^T) < 0 and needs the reflection fix."""
    rng = np.random.default_rng(9)
    gt = rng.uniform(-60, 60, size=(4, 16, 3)).astype(np.float32)
    pred = (gt + rng.normal(size=gt.shape) * 8.0).astype(np.float32)
    a = 0.7
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    mirror = np.diag([1.0, 1.0, -1.0])
    pred[1] = (1.3 * gt[1] @ (rot @ mirror).T + 5.0).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("name", ["mpjpe", "mpjpe_loss", "procrustes_align",
                                  "pa_mpjpe", "pck_3d", "auc_3d"])
def test_metric_matches_jax(name):
    pred, gt = _poses()
    if name in ("pck_3d", "auc_3d"):  # mm inputs
        pred, gt = pred * 10.0, gt * 10.0
    want = np.asarray(getattr(jmetrics, name)(pred, gt))
    got = getattr(metrics, name)(t(pred), t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=1e-5)
    if name == "pa_mpjpe":  # the reflected sample is not aligned perfectly
        assert got[1] > 1.0


def test_lr_schedule_matches_jax():
    steps_per_epoch = 7
    want = jax_schedule(1e-3, 500, (8, 10), steps_per_epoch)
    got = optim.make_lr_schedule(1e-3, 500, (8, 10), steps_per_epoch)
    for step in (0, 1, 498, 499, 500, 501, 55, 56, 57, 69, 70, 71):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
    assert got(0) == pytest.approx(1e-3 / 500)


@pytest.fixture(scope="module")
def cascade():
    """JAX Pose3DTask and the port's on the same perturbed random weights,
    and a seeded batch; the jitted JAX loss-and-gradient."""
    cfg = flagship_cfg_dict((SIZE, SIZE))
    jtask = JaxPose3DTask(cfg)
    img0 = jnp.zeros((B, 4, 3, SIZE, SIZE), jnp.float32)
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), img0, jtask.rig, None, train=False))
    rng = np.random.default_rng(SEED)
    variables = random_variables(shapes, rng, heatmap_bias=HEATMAP_BIAS)
    img = rng.normal(size=(B, 4, 3, SIZE, SIZE)).astype(np.float32)
    u = rng.uniform(size=(B, 16, 3))
    gt_pose = (np.array([-60.0, -60.0, -20.0]) + u * [120.0, 120.0, 100.0])
    gt_hm = rng.uniform(size=(B, 4, 15, SIZE // 4, SIZE // 4))
    batch = {"img": img, "gt_pose": gt_pose.astype(np.float32),
             "gt_heatmap": gt_hm.astype(np.float32)}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, ev, b: jtask.loss(p, ev, b, True,
                                    {"dropout": jax.random.PRNGKey(0)}),
        has_aux=True))

    def port_task():
        task = Pose3DTask(cfg, device="cpu")
        load_flax(task.model, variables)
        return task

    return dict(jtask=jtask, variables=variables, batch=batch,
                torch_batch={k: torch.from_numpy(v) for k, v in batch.items()},
                value_and_grad=value_and_grad, port_task=port_task)


def test_decay_mask_matches_jax(cascade):
    params = cascade["variables"]["params"]
    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                        _no_decay_mask(params), params)
    want = {k: bool(v.flatten()[0]) for k, v in from_flax({"params": mask}).items()}
    got = optim.decay_mask(cascade["port_task"]().model)
    assert got == want
    assert not got["heatmap_estimator.refiners.0.transformer_0.norm_cross.weight"]
    assert got["heatmap_estimator.refiners.0.fc_query.weight"]


@pytest.mark.parametrize("factor", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(factor):
    rng = np.random.default_rng(11)
    grads = [(rng.normal(size=s) * factor).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 3))]
    want, _ = optax.clip_by_global_norm(5.0).update(grads, None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = optim.clip_by_global_norm_(got, 5.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# -- the task loss, gradients and train steps ---------------------------------------


@pytest.fixture(scope="module")
def one_step(cascade):
    """JAX loss, metrics, mutated stats and gradients of one train-mode
    forward, and the port's (loss, metrics, task) after backward."""
    v = cascade["variables"]
    (_, (jmetrics_, mutated)), grads = cascade["value_and_grad"](
        v["params"], {"batch_stats": v["batch_stats"]}, cascade["batch"])
    task = cascade["port_task"]()
    task.model.train()
    total, metrics_ = task.loss(cascade["torch_batch"])
    total.backward()
    return dict(jax_metrics=jax.device_get(jmetrics_),
                jax_stats=from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])}),
                jax_grads=from_flax({"params": jax.device_get(grads)}),
                metrics={k: float(x.detach()) for k, x in metrics_.items()}, task=task)


def test_pose3d_task_loss_matches_jax(one_step, cascade):
    want, got = one_step["jax_metrics"], one_step["metrics"]
    assert sorted(got) == sorted(want) and len(got) == 4 + 2 + 1
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    # Train-mode BN: every running stat after the forward.
    sd = one_step["task"].model.state_dict()
    for k, v in one_step["jax_stats"].items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=BN_TOL,
                                       rtol=0, err_msg=k)
    # Both valid and invalid anchors in the training forward, so the
    # gradients below cross the masked and unmasked sampling paths.
    from egorear_tpu_torch.ops.heatmap import argmax_2d

    with torch.no_grad():  # a second train-mode forward; stats checked above
        preds, hms = one_step["task"].forward(cascade["torch_batch"]["img"])
    assert 0 < float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean()) < 1
    assert 0 < float(one_step["task"].rig.project(preds[0])[1].float().mean()) < 1


def test_eval_and_predict_match_jax(cascade):
    """Eval mode (BN running stats), fp32 masters: the per-sample metrics of
    the final and proposal stages, and the predicted poses."""
    jtask, v, batch = cascade["jtask"], cascade["variables"], cascade["batch"]
    want = jax.device_get(jax.jit(jtask.eval_metrics)(v, batch))
    want_pred = jax.device_get(jax.jit(jtask.predict_outputs)(v, batch))
    task = cascade["port_task"]()
    trainer = Trainer(task, LR, WD, DECAY_EPOCHS, WARMUP)
    got = trainer.eval_step(cascade["torch_batch"])
    assert sorted(got) == sorted(want) and len(got) == 8
    for k, w in want.items():
        assert got[k].shape == (B,)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=METRIC_RTOL, atol=1e-4,
                                   err_msg=k)
    pred = task.predict_outputs(cascade["torch_batch"])
    for k in ("final", "proposal"):  # test_torch_port_cascade's P3D_ATOL, cm
        np.testing.assert_allclose(pred[k].numpy(), want_pred[k], atol=9e-3, rtol=0)


@pytest.mark.parametrize("fault", ["dropout", "precision", "imagenet",
                                   "real_world_rig"])
def test_unported_training_paths_raise(fault, monkeypatch, tmp_path):
    cfg = flagship_cfg_dict((SIZE, SIZE))
    if fault == "imagenet":
        # The flag with no weights anywhere: no file named by the
        # environment, an empty hub cache.
        monkeypatch.delenv("EGOREAR_IMAGENET_RESNET18", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        cfg["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = True
        with pytest.raises(FileNotFoundError, match="use_imagenet_pretrain"):
            Pose3DTask(cfg, device="cpu")
        return
    if fault == "real_world_rig":
        # A real-world batch without its device-to-camera transforms: the
        # rig refuses it, as the JAX package's does.
        cfg["camera_model"] = "ego4view_rw"
        task = Pose3DTask(cfg, dataset_type="ego4view_rw_pose3d", device="cpu")
        assert task.is_rw and task.rig.is_rw
        batch = {"img": torch.zeros(B, 4, 3, SIZE, SIZE),
                 "gt_pose": torch.zeros(B, 16, 3),
                 "gt_heatmap": torch.zeros(B, 4, 15, SIZE // 4, SIZE // 4)}
        with pytest.raises(ValueError, match="coord_trans_mat"):
            task.loss(batch)
        return
    if fault == "dropout":
        cfg["pose3d_cfg"]["mlp_dropout"] = 0.1
    task = Pose3DTask(cfg, device="cpu")
    if fault == "dropout":
        # Once refused, now taken: the proposal MLP draws its masks from
        # the trainer's generator, seeded by the step. (Whole steps with
        # dropout: tests/test_torch_port_branches_train.py.)
        drop = task.model.pose3d_estimator.mlp_drop
        assert drop.p == 0.1
        trainer = Trainer(task, LR, WD, DECAY_EPOCHS, WARMUP)
        trainer.init_state(steps_per_epoch=1)
        gen = trainer.dropout_generator()
        state = gen.get_state()
        x = torch.ones(B, 1024)
        with dropout_generator(task.model.train(), gen):
            y = drop(x)
        assert not torch.equal(gen.get_state(), state)  # masks were drawn
        assert 0 < int((y == 0).sum()) < y.numel()
    else:
        with pytest.raises(ValueError):
            Trainer(task, LR, WD, DECAY_EPOCHS, WARMUP, precision="16-mixed")


def _leaf_errors(got: dict, want: dict):
    """{leaf: (err, scale)} and the global gradient scale."""
    gmax = max(float(w.abs().max()) for w in want.values())
    out = {}
    for k, w in want.items():
        g = got[k]
        out[k] = (float((g - w).abs().max()), float(w.abs().max()), float(g.abs().max()))
    return out, gmax


def test_cascade_gradients_match_jax_grad(one_step):
    want = one_step["jax_grads"]
    named = dict(one_step["task"].model.named_parameters())
    assert sorted(named) == sorted(want)
    got = {k: p.grad if p.grad is not None else torch.zeros_like(p)
           for k, p in named.items()}
    errs, gmax = _leaf_errors(got, want)
    floor = GRAD_FLOOR * gmax
    worst, rounding_zero = (0.0, ""), []
    for k, (err, scale, got_max) in errs.items():
        if scale == 0:  # no path to the loss: the zero sets below
            continue
        if scale < floor:  # zero in exact arithmetic: rounding only
            rounding_zero.append(k)
            assert got_max <= floor, f"{k}: {got_max:.3e} above the floor {floor:.3e}"
            continue
        worst = max(worst, (err / scale, k))
        assert err <= GRAD_TOL * scale, f"{k}: {err:.3e} > {GRAD_TOL:g} x {scale:.3e}"
    print(f"worst leaf gradient max-abs/scale {worst[0]:.3e} ({worst[1]}); "
          f"{len(rounding_zero)} leaves below the floor")
    zero_jax = {k for k, w in want.items() if not bool(w.any())}
    zero_port = {k for k, p in named.items() if p.grad is None or not bool(p.grad.any())}
    assert zero_jax == zero_port
    assert zero_jax and all(".ff_proj_" in k for k in zero_jax)
    assert all("spatial_attn.k_proj.bias" in k for k in rounding_zero)


def _clip_factor(grads: dict, max_norm: float = 5.0) -> float:
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    return min(1.0, max_norm / norm)


def test_three_train_steps_match_jax_trainer(cascade):
    """Three fp32 steps (lr 0.5e-5, 1e-5 in the warmup, then 1e-6 after the
    milestone; clipping at 5; masked decay) vs the JAX trainer's step.

    Step 1 starts from the same state, and its gradients agree per leaf to
    GRAD_TOL of the leaf's scale. AdamW's first step moves each element by
    lr * g / (|g| + eps) plus the decay, so the bound per element is lr times
    the largest change of g / (|g| + eps) over the gradient's tolerance
    interval, plus four fp32 ulps of the parameter and of the step (the two
    frameworks round the decay and the Adam step in other orders) and 1e-5
    of the step (optax's first step is 6.4e-6 short: it takes 1 - b2 in
    double for the second moment and in fp32 for its bias correction): an
    element whose gradient is rounding (|g| near eps) may move by up to 2 lr
    in one framework and not the other; every other element agrees to its
    ulps.

    Steps 2 and 3 start from states that differ by such rounding, and the
    64 px train-mode cascade is ill-conditioned there: one-ulp relative noise
    on the parameters moves JAX's own gradients by up to 8e-4 of a leaf's
    scale, 1e-6 noise by 6 % (small maps, ReLU kinks, BN over 16 values). So
    after three steps every element is held to Adam's step bound (1.5 lr per
    step each way), the loss of every step to LOSS_RTOL and the BN running
    stats to BN_TOL absolute plus BN_TOL relative. The base lr is small so
    that the later states keep the seeded state's argmax anchors (at 1e-3 one
    flips at step 2).
    """
    jtask, v, batch = cascade["jtask"], cascade["variables"], cascade["batch"]
    params, extra = v["params"], {"batch_stats": v["batch_stats"]}
    tx, schedule = jax_make_optimizer(LR, WD, WARMUP, DECAY_EPOCHS, 1,
                                      grad_clip_norm=5.0, no_decay_mask=True,
                                      params=params)
    opt_state = tx.init(params)
    jax_losses, jax_params, jax_grads = [], [], []
    for _ in range(STEPS):
        (loss, (_, mutated)), grads = cascade["value_and_grad"](params, extra, batch)
        jax_losses.append(float(loss))
        jax_grads.append(from_flax({"params": jax.device_get(grads)}))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        extra = {**extra, **mutated}
        jax_params.append(from_flax({"params": jax.device_get(params)}))
    want_stats = from_flax({"batch_stats": jax.device_get(extra["batch_stats"])})

    task = cascade["port_task"]()
    trainer = Trainer(task, LR, WD, DECAY_EPOCHS, WARMUP, precision="32",
                      gradient_clip_val=5.0, no_decay_mask=True)
    trainer.init_state(steps_per_epoch=1)
    losses, lrs, port_params = [], [], []
    for _ in range(STEPS):
        metrics_ = trainer.train_step(cascade["torch_batch"])
        losses.append(float(metrics_["loss_total"]))
        lrs.append(float(metrics_["lr"]))
        port_params.append({k: p.detach().clone()
                            for k, p in task.model.named_parameters()})
    np.testing.assert_allclose(lrs, [float(schedule(s)) for s in range(STEPS)], rtol=1e-6)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert trainer.step == STEPS

    # Step 1: the exact AdamW bound per element.
    g0 = jax_grads[0]
    clip = _clip_factor(g0)
    floor = GRAD_FLOOR * clip * max(float(g.abs().max()) for g in g0.values())
    worst_step1 = 0.0
    for k, want in jax_params[0].items():
        g = g0[k] * clip
        scale = float(g.abs().max())  # rounding-zero leaves: the floor
        tol = GRAD_TOL * scale if scale >= floor else floor
        gmin = (g.abs() - tol).clamp_min(0.0)
        # Four ulps of the parameter and of the step, and 1e-5 of the step.
        ulps = 4.8e-7 * (want.abs() + lrs[0]) + 1e-5 * lrs[0]
        bound = lrs[0] * (1e-8 * tol / (gmin + 1e-8) ** 2).clamp(max=2.0) + ulps
        diff = (port_params[0][k] - want).abs()
        assert bool((diff <= bound * (1 + 1e-3)).all()), k
        worst_step1 = max(worst_step1, float((diff - ulps).max()))

    # After three steps: Adam's step bound, and the BN running stats.
    adam_bound = 2 * 1.5 * sum(lrs)
    worst = 0.0
    for k, want in jax_params[-1].items():
        diff = (port_params[-1][k] - want).abs() - 2.4e-7 * want.abs()
        worst = max(worst, float(diff.max()))
        assert float(diff.max()) <= adam_bound, k
    sd = task.model.state_dict()
    for k, w in want_stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=BN_TOL,
                                       rtol=BN_TOL, err_msg=k)
    print(f"params after step 1: max-abs beyond the rounding allowance {worst_step1:.3e}; after "
          f"{STEPS} steps {worst:.3e} (Adam bound {adam_bound:.1e}); losses "
          f"{losses} vs {jax_losses}")
