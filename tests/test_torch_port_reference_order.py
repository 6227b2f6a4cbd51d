"""The port's reference computation order (``lazy_deform: false`` in
``mvf_cfg`` and ``pose3d_cfg``) held against the JAX package: the same random
flax weights (carried across by ``egorear_tpu_torch.convert.from_flax``) and
the same numpy inputs, fp32 on the CPU.

  * ``MSDeformAttn`` vs the flax ``MSDeformAttn``, on its default sampling
    (``onehot``) and on the Pallas kernel ``_make_deform_kernel``
    interpreted; the JAX layers build ``MSDeformAttn`` without ``impl``, so
    the Pallas path is chosen with ``EGOREAR_DEFORM_IMPL=pallas``; 1e-5;
  * the reference-order ``MultiViewTransformerLayer`` and ``MVFexRefiner``;
  * ``from_flax`` of a JAX ``lazy_deform: false`` model, ``strict=True``;
  * the 64 px cascade, BN-unfolded and BN-folded: heatmaps 2e-5, anchors
    bitwise, ``preds_3d`` 9e-3 cm (the bounds of
    ``test_torch_port_cascade.py``); and the port's two orders on the same
    weights;
  * per-leaf gradients of ``Pose3DTask.loss`` vs ``jax.grad``, 1e-4 of each
    leaf's largest value (the rules of ``test_torch_port_train.py``), and one
    fp32 train step vs the JAX trainer's step, to the AdamW bound.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from egorear_tpu.models import backbone as jbackbone
from egorear_tpu.models import layers as jlayers
from egorear_tpu.models import mvfex as jmvfex
from egorear_tpu.models.configs import EgoRearNetCfg
from egorear_tpu.models.configs import MVFCfg as JMVFCfg
from egorear_tpu.models.configs import TransformerLayerCfg as JTransformerLayerCfg
from egorear_tpu.models.pose3d import EgoRearNet as JaxEgoRearNet
from egorear_tpu.ops.camera import CameraRig as JaxRig
from egorear_tpu.ops.heatmap import argmax_2d as jax_argmax_2d
from egorear_tpu.train.optim import make_optimizer as jax_make_optimizer
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.entry import build, flagship_cfg_dict
from egorear_tpu_torch.models import layers, mvfex
from egorear_tpu_torch.models.backbone import fold_batchnorm
from egorear_tpu_torch.models.configs import MVFCfg, TransformerLayerCfg
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.deform_attn import deformable_sampling, lazy_deform_sample
from egorear_tpu_torch.ops.heatmap import argmax_2d
from egorear_tpu_torch.train.tasks import Pose3DTask
from egorear_tpu_torch.train.trainer import Trainer
from test_torch_port_models import assert_close, init_variables, nchw, random_variables, t
from test_torch_port_train import (
    DECAY_EPOCHS,
    GRAD_FLOOR,
    GRAD_TOL,
    LOSS_RTOL,
    LR,
    WARMUP,
    WD,
    _clip_factor,
    _leaf_errors,
)

SIZE, B, SEED, HEATMAP_BIAS = 64, 2, 1, 0.3
HM_ATOL, P3D_ATOL = 2e-5, 9e-3


@pytest.fixture(params=["default", "pallas"])
def jax_sampling(request, monkeypatch):
    """Run the JAX layers on their default sampling or, interpreted, on the
    Pallas kernel."""
    if request.param == "default":
        monkeypatch.delenv("EGOREAR_DEFORM_IMPL", raising=False)
        yield
    else:
        monkeypatch.setenv("EGOREAR_DEFORM_IMPL", "pallas")
        with pltpu.force_tpu_interpret_mode():
            yield


# -- modules ---------------------------------------------------------------------


def test_msdeform_attn_matches_jax(jax_sampling):
    rng = np.random.default_rng(0)
    Bq, Q, C, H = 8, 5, 32, 8
    q = rng.normal(size=(Bq, Q, C)).astype(np.float32)
    ref = rng.uniform(0, 1, size=(Bq, Q, 2)).astype(np.float32)
    value = rng.normal(size=(Bq, H * H, C)).astype(np.float32)
    jmod = jlayers.MSDeformAttn(d_model=C, n_heads=4, n_points=16)
    variables = init_variables(jmod, 1, q, ref, value, (H, H))
    want = jmod.apply(variables, q, ref, value, (H, H))
    mod = load_flax(layers.MSDeformAttn(C, 4, 16), variables)
    before = deformable_sampling.launches
    assert_close(mod(t(q), t(ref), t(value), (H, H)), want)
    assert deformable_sampling.launches == before  # the plain version on the CPU


def test_multiview_transformer_layer_matches_jax(jax_sampling):
    rng = np.random.default_rng(1)
    V, Bb, J, C, H = 4, 2, 5, 32, 8
    q = rng.normal(size=(Bb, J, C)).astype(np.float32)
    anchors = rng.uniform(0, 1, size=(Bb, V, J, 2)).astype(np.float32)
    valid = rng.uniform(size=(Bb, V, J)) > 0.3
    memory = rng.normal(size=(V, Bb, H * H, C)).astype(np.float32)
    jmod = jmvfex.MultiViewTransformerLayer(
        num_views=V, embed_dims=C, feat_shape=(H, H),
        cfg=JTransformerLayerCfg(), vmajor=True)
    variables = init_variables(jmod, 2, q, memory, anchors, valid)
    want = jmod.apply(variables, q, memory, anchors, valid)

    mod = load_flax(mvfex.MultiViewTransformerLayer(V, C, (H, H),
                                                    TransformerLayerCfg(), lazy=False),
                    variables)
    assert isinstance(mod.cross_attn, layers.MSDeformAttn)
    assert not isinstance(mod.cross_attn, layers.MSDeformAttnLazy)
    got = mod(t(q), t(anchors), t(valid), t(memory.reshape(V * Bb, H * H, C)))
    assert_close(got, want)
    with pytest.raises(ValueError):  # the reference order takes no projection
        mod(t(q), t(anchors), t(valid), t(memory.reshape(V * Bb, H * H, C)),
            mem_kernel=torch.zeros(C, C))


def test_mvfex_refiner_matches_jax():
    """One view's JQA refiner in the reference order: the memory is
    materialised view-major with each view's own position table."""
    rng = np.random.default_rng(2)
    V, Bb, J, Cin, C, h = 4, 2, 15, 128, 64, 8
    hm = rng.normal(size=(Bb, J, h, h)).astype(np.float32)
    feat_mv = rng.normal(size=(V, Bb, h, h, Cin)).astype(np.float32)
    anchors = rng.uniform(0, 1, size=(Bb, V, J, 2)).astype(np.float32)
    valid = rng.uniform(size=(Bb, V, J)) > 0.3
    bfb = rng.normal(size=(Bb, 512)).astype(np.float32)
    bfb_mv = rng.normal(size=(Bb, V, 512)).astype(np.float32)

    jcfg = JMVFCfg(input_dims=Cin, embed_dims=C, joint_query_adaptation=True,
                   transformer=JTransformerLayerCfg(), lazy_deform=False)
    jmod = jmvfex.MVFexRefiner(num_views=V, num_heatmap=J, feat_shape=(h, h),
                               detach_heatmap_feat=True, cfg=jcfg, vmajor=True)
    args = (hm, feat_mv[1], feat_mv, anchors, valid, bfb, bfb_mv)
    variables = init_variables(jmod, 3, *args)
    want_hm, want_feat = jmod.apply(variables, *args)

    cfg = MVFCfg(input_dims=Cin, embed_dims=C, joint_query_adaptation=True,
                 lazy_deform=False)
    mod = load_flax(mvfex.MVFexRefiner(V, J, (h, h), True, cfg), variables)
    tokens = t(feat_mv.reshape(V * Bb, h * h, Cin))
    # JQA reads this view's pooled bottom: bfb as view 0 of a 1-view stack.
    got_hm, got_feat = mod(t(hm), t(nchw(feat_mv[1])), tokens, t(anchors),
                           t(valid), t(bfb)[:, None], 0)
    assert len(got_hm) == len(want_hm) == 1
    assert_close(got_hm[0], want_hm[0])
    assert_close(got_feat[0], nchw(want_feat[0]))


# -- the cascade ---------------------------------------------------------------------


def _jax_cfg(**kw):
    return EgoRearNetCfg.from_dict(flagship_cfg_dict((SIZE, SIZE), lazy_deform=False, **kw))


@pytest.fixture(scope="module")
def cascade_case():
    """Perturbed random flax variables of the reference-order cascade, a
    seeded image batch and the JAX rig."""
    net = JaxEgoRearNet(cfg=_jax_cfg())
    rig = JaxRig.from_calib_file("ego4view_syn")
    img = jnp.zeros((B, 4, 3, SIZE, SIZE), jnp.float32)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), img, rig))
    rng = np.random.default_rng(SEED)
    variables = random_variables(shapes, rng, heatmap_bias=HEATMAP_BIAS)
    img = rng.normal(size=(B, 4, 3, SIZE, SIZE)).astype(np.float32)
    return variables, img, rig


def test_from_flax_loads_the_reference_order_strictly(cascade_case):
    """The two orders have one parameter tree: a JAX ``lazy_deform: false``
    model loads with ``strict=True`` into the port's reference order and
    into its lazy order, and its state dict is the JAX lazy model's."""
    variables, _, rig = cascade_case
    img = jnp.zeros((B, 4, 3, SIZE, SIZE), jnp.float32)
    lazy_shapes = jax.eval_shape(lambda: JaxEgoRearNet(
        cfg=EgoRearNetCfg.from_dict(flagship_cfg_dict((SIZE, SIZE)))).init(
            jax.random.PRNGKey(0), img, rig))
    sd = from_flax(variables)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in from_flax(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), lazy_shapes)).items()}
    for lazy in (False, True):
        model, _ = build((SIZE, SIZE), device="cpu", lazy_deform=lazy)
        load_flax(model, variables)  # strict
        n_ref = sum(type(m) is layers.MSDeformAttn for m in model.modules())
        n_lazy = sum(type(m) is layers.MSDeformAttnLazy for m in model.modules())
        assert (n_ref, n_lazy) == ((0, 7) if lazy else (7, 0))


@pytest.fixture(scope="module")
def runs(cascade_case):
    """{variant: (jax (preds, hms), port (preds, hms))}, plus the port's lazy
    order on the unfolded weights under "lazy"."""
    variables, img, rig = cascade_case
    out = {}
    for variant in ("unfolded", "folded", "lazy"):
        folded, lazy = variant == "folded", variant == "lazy"
        jvars = jbackbone.fold_batchnorm(variables) if folded else variables
        want = None
        if not lazy:
            jnet = JaxEgoRearNet(cfg=_jax_cfg(bn_folded=folded))
            want = jax.tree.map(np.asarray, jax.jit(
                lambda v, x: jnet.apply(v, x, rig))(jvars, img))
        model, trig = build((SIZE, SIZE), device="cpu", bn_folded=folded,
                            lazy_deform=lazy)
        if folded:
            model.load_state_dict(fold_batchnorm(from_flax(variables)), strict=True)
        else:
            load_flax(model, variables)
        lazy0, ref0 = lazy_deform_sample.launches, deformable_sampling.launches
        with torch.inference_mode():
            got = model(torch.from_numpy(img), trig)
        assert (lazy_deform_sample.launches, deformable_sampling.launches) == (lazy0, ref0)
        out[variant] = (want, got)
    return out


VARIANTS = ["unfolded", "folded"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_heatmaps_match_jax(runs, variant):
    want, got = runs[variant][0][1], runs[variant][1][1]
    assert len(got) == len(want) == 2
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"{variant}: heatmap stage max-abs divergence {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 4, 15, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=HM_ATOL, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_anchors_match_jax_bitwise(runs, cascade_case, variant):
    (want_p3d, want_hm), (got_p3d, got_hm) = runs[variant]
    rig = cascade_case[2]
    top = np.sort(want_hm[0].reshape(-1, (SIZE // 4) ** 2), axis=-1)
    assert (top[:, -1] - top[:, -2]).min() > 5 * HM_ATOL
    assert np.abs(top[:, -1] - 0.5).min() > 5 * HM_ATOL
    want = jax_argmax_2d(want_hm[0], threshold=0.5, normalize=True)
    got = argmax_2d(got_hm[0], threshold=0.5, normalize=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].float().mean() < 1  # valid and invalid anchors
    _, want_fov, _ = rig.project(want_p3d[0])
    _, got_fov, _ = CameraRig.from_calib_file("ego4view_syn").project(got_p3d[0])
    np.testing.assert_array_equal(got_fov.numpy(), np.asarray(want_fov))
    assert 0 < got_fov.float().mean() < 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_preds_3d_match_jax(runs, variant):
    want, got = runs[variant][0][0], runs[variant][1][0]
    assert len(got) == len(want) == 4  # proposal + 3 lifting layers
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"{variant}: preds_3d stage max-abs divergence (cm) {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 16, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=P3D_ATOL, rtol=0)


def test_port_lazy_order_matches_reference_order(runs):
    """Two algebras of one function on the same weights: the lazy order
    samples the raw features and projects after, the reference order
    projects on the grid and samples per head."""
    (ref_p3d, ref_hm), (lazy_p3d, lazy_hm) = runs["unfolded"][1], runs["lazy"][1]
    hm_errs = [float((a - b).abs().max()) for a, b in zip(ref_hm, lazy_hm)]
    p3d_errs = [float((a - b).abs().max()) for a, b in zip(ref_p3d, lazy_p3d)]
    print(f"port lazy vs reference order: heatmaps {hm_errs}, preds_3d cm {p3d_errs}")
    assert torch.equal(ref_hm[0], lazy_hm[0]) and torch.equal(ref_p3d[0], lazy_p3d[0])
    assert max(hm_errs) <= HM_ATOL and max(p3d_errs) <= P3D_ATOL


# -- gradients and one train step -------------------------------------------------------


@pytest.fixture(scope="module")
def train_case(cascade_case):
    """The JAX Pose3DTask of the reference order on the perturbed weights, a
    seeded stage-3 batch, and the jitted JAX loss-and-gradient."""
    variables, img, _ = cascade_case
    cfg = flagship_cfg_dict((SIZE, SIZE), lazy_deform=False)
    jtask = JaxPose3DTask(cfg)
    rng = np.random.default_rng(SEED + 1)
    u = rng.uniform(size=(B, 16, 3))
    gt_pose = np.array([-60.0, -60.0, -20.0]) + u * [120.0, 120.0, 100.0]
    gt_hm = rng.uniform(size=(B, 4, 15, SIZE // 4, SIZE // 4))
    batch = {"img": img, "gt_pose": gt_pose.astype(np.float32),
             "gt_heatmap": gt_hm.astype(np.float32)}
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, ev, b: jtask.loss(p, ev, b, True,
                                    {"dropout": jax.random.PRNGKey(0)}),
        has_aux=True))
    (loss, (_, mutated)), grads = value_and_grad(
        variables["params"], {"batch_stats": variables["batch_stats"]}, batch)

    def port_task():
        task = Pose3DTask(cfg, device="cpu")
        load_flax(task.model, variables)
        return task

    return dict(variables=variables, batch=batch, loss=float(loss), jax_grads=grads,
                grads=from_flax({"params": jax.device_get(grads)}),
                torch_batch={k: torch.from_numpy(v) for k, v in batch.items()},
                port_task=port_task)


def test_cascade_gradients_match_jax_grad(train_case):
    task = train_case["port_task"]()
    task.model.train()
    total, _ = task.loss(train_case["torch_batch"])
    np.testing.assert_allclose(float(total.detach()), train_case["loss"], rtol=LOSS_RTOL)
    total.backward()
    # Both valid and invalid anchors, so the gradients cross the masked and
    # unmasked sampling paths.
    with torch.no_grad():
        preds, hms = task.forward(train_case["torch_batch"]["img"])
    assert 0 < float(argmax_2d(hms[0], 0.5, normalize=True)[2].float().mean()) < 1
    assert 0 < float(task.rig.project(preds[0])[1].float().mean()) < 1

    want = train_case["grads"]
    named = dict(task.model.named_parameters())
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
    assert all("spatial_attn.k_proj.bias" in k for k in rounding_zero)
    # The grid-side memory and value projections train in this order.
    for k in ("heatmap_estimator.refiners.0.frame_feat_multi_view_pos_embed",
              "heatmap_estimator.refiners.0.transformer_0.cross_attn.value_proj.weight",
              "pose3d_estimator.feat_proj.weight",
              "pose3d_estimator.transformer_2.cross_attn.sampling_offsets.weight"):
        assert errs[k][1] > floor, k


def test_one_train_step_matches_jax_trainer(train_case):
    """One fp32 step from the same state (lr in the warmup, clipping at 5,
    masked decay) vs the JAX trainer's step: the exact AdamW bound per
    element of ``test_torch_port_train.test_three_train_steps_match_jax_trainer``'s
    first step."""
    params = train_case["variables"]["params"]
    tx, schedule = jax_make_optimizer(LR, WD, WARMUP, DECAY_EPOCHS, 1,
                                      grad_clip_norm=5.0, no_decay_mask=True,
                                      params=params)
    step = jax.jit(lambda g, p: jax.tree.map(
        lambda a, u: a + u, p, tx.update(g, tx.init(p), p)[0]))
    want = from_flax({"params": jax.device_get(step(train_case["jax_grads"], params))})

    task = train_case["port_task"]()
    trainer = Trainer(task, LR, WD, DECAY_EPOCHS, WARMUP, precision="32",
                      gradient_clip_val=5.0, no_decay_mask=True)
    trainer.init_state(steps_per_epoch=1)
    metrics_ = trainer.train_step(train_case["torch_batch"])
    lr = float(metrics_["lr"])
    np.testing.assert_allclose(lr, float(schedule(0)), rtol=1e-6)
    np.testing.assert_allclose(float(metrics_["loss_total"]), train_case["loss"],
                               rtol=LOSS_RTOL)

    g0 = train_case["grads"]
    clip = _clip_factor(g0)
    floor = GRAD_FLOOR * clip * max(float(x.abs().max()) for x in g0.values())
    got = dict(task.model.named_parameters())
    for k, w in want.items():
        gk = g0[k] * clip
        scale = float(gk.abs().max())  # rounding-zero leaves: the floor
        tol = GRAD_TOL * scale if scale >= floor else floor
        gmin = (gk.abs() - tol).clamp_min(0.0)
        ulps = 4.8e-7 * (w.abs() + lr) + 1e-5 * lr
        bound = lr * (1e-8 * tol / (gmin + 1e-8) ** 2).clamp(max=2.0) + ulps
        diff = (got[k].detach() - w).abs()
        assert bool((diff <= bound * (1 + 1e-3)).all()), k
