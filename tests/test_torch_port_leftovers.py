"""The port's leftovers held against the JAX package on the CPU: the
precision strings the trainers take, ``soft_argmax_2d`` and the auxiliary
losses, the UnrealEgo projection, and the host-side numpy helpers
(``ops/extrinsics``, the Blender/OpenCV flip, ``utils/skeleton``,
``utils/image``).

Tolerances: the numpy copies and the uint8 drawings are bitwise JAX's (the
same numpy calls in the same order); the torch ports of ``jnp`` code agree
in fp32 within 1e-6 of each output's scale and their gradients (autograd
vs ``jax.vjp`` of a seeded cotangent) within 1e-5 of each gradient's
scale; the UnrealEgo in-view masks are equal at points more than 1e-4 from
the view's edge (a rounding there may land either side).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import flax.linen as fnn

from egorear_tpu.ops import camera as jcamera
from egorear_tpu.ops import extrinsics as jext
from egorear_tpu.ops import heatmap as jheatmap
from egorear_tpu.ops import losses as jlosses
from egorear_tpu.train.trainer import Trainer as JaxTrainer
from egorear_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from egorear_tpu.utils import image as jimage
from egorear_tpu.utils import skeleton as jskeleton
from egorear_tpu_torch.ops import camera, extrinsics, heatmap, losses
from egorear_tpu_torch.train.trainer import Trainer, TrainerConfig
from egorear_tpu_torch.utils import image, skeleton
from torch_threads import torch_threads  # noqa: F401

VALUE_RTOL, GRAD_RTOL, EDGE = 1e-6, 1e-5, 1e-4


def _close(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol:g} x {scale:.3e}"


def _value_and_vjp_match(jax_fn, torch_fn, args, rng, grad_of=(0,)):
    """``jax_fn`` and ``torch_fn`` on the same fp32 ``args``: outputs within
    VALUE_RTOL of scale, and the gradients of <output, seeded cotangent>
    w.r.t. the args in ``grad_of`` within GRAD_RTOL of scale."""
    jargs = [jnp.asarray(a) for a in args]
    out, vjp = jax.vjp(lambda *g: jax_fn(*[g[grad_of.index(i)] if i in grad_of
                                           else jargs[i] for i in range(len(args))]),
                       *[jargs[i] for i in grad_of])
    targs = [torch.tensor(a, requires_grad=i in grad_of) for i, a in enumerate(args)]
    got = torch_fn(*targs)
    outs_j = out if isinstance(out, tuple) else (out,)
    outs_t = got if isinstance(got, tuple) else (got,)
    cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs_j]
    for k, (t, j) in enumerate(zip(outs_t, outs_j, strict=True)):
        _close(t.detach().numpy(), j, VALUE_RTOL, f"output {k}")
    want = vjp(tuple(jnp.asarray(c) for c in cots) if isinstance(out, tuple)
               else jnp.asarray(cots[0]))
    total = sum((t * torch.from_numpy(c)).sum() for t, c in zip(outs_t, cots)
                if t.dtype.is_floating_point)
    total.backward()
    for i, w in zip(grad_of, want, strict=True):
        _close(targs[i].grad.numpy(), w, GRAD_RTOL, f"d/d arg {i}")


# -- the precision strings ---------------------------------------------------------


class _JaxTinyTask:
    """A conv net whose loss records the dtype its parameters and its batch
    arrive in (while the step traces)."""

    def __init__(self, seen):
        self.net, self.seen = fnn.Conv(1, (1, 1)), seen

    def init(self, rng, batch):
        return self.net.init(rng, batch["x"])

    def loss(self, params, extra_vars, batch, train, rngs=None):
        self.seen.append((params["kernel"].dtype, batch["x"].dtype))
        loss = (self.net.apply({"params": params}, batch["x"]) ** 2).mean()
        return loss, ({"loss": loss}, {})


class _TinyTask:
    """The port's counterpart of :class:`_JaxTinyTask`."""

    name = "tiny"

    def __init__(self, seen):
        self.model, self.seen = nn.Conv2d(3, 1, 1), seen

    def loss(self, batch, params=None, generator=None):
        weight = (params or dict(self.model.named_parameters()))["weight"]
        self.seen.append((weight.dtype, batch["x"].dtype))
        out = torch.func.functional_call(self.model, params, (batch["x"],)) \
            if params else self.model(batch["x"])
        loss = (out ** 2).mean()
        return loss, {"loss": loss}


_X = np.random.default_rng(0).normal(size=(8, 4, 4, 3)).astype(np.float32)


def _names(dtypes) -> tuple:
    return tuple(str(t).split(".")[-1] for t in dtypes)


def _jax_dtypes(precision: str) -> tuple:
    """The (parameter, batch) dtype names inside one JAX train step."""
    seen = []
    trainer = JaxTrainer(_JaxTinyTask(seen), JaxTrainerConfig(
        precision=precision, gradient_clip_val=None), lr=0.0, weight_decay=0.0,
        lr_decay_epochs=(), warmup_iters=1, batch_size=8)
    trainer.init_state({"x": _X}, steps_per_epoch=1)
    trainer._train_step(trainer.state, {"x": _X})
    return _names(seen[-1])


def _port_trainer(precision: str, seen: list) -> Trainer:
    return Trainer(_TinyTask(seen), lr=0.0, weight_decay=0.0, lr_decay_epochs=(),
                   warmup_iters=1, precision=precision, gradient_clip_val=None,
                   batch_size=8)


@pytest.mark.parametrize("precision", ["32", "32-true", "bf16-mixed", "bf16",
                                       "bf16-true"])
def test_precision_strings_pick_jax_compute_dtype(precision):
    seen = []
    trainer = _port_trainer(precision, seen)
    trainer.init_state(steps_per_epoch=1)
    trainer.train_step({"x": torch.from_numpy(_X.transpose(0, 3, 1, 2).copy())})
    assert _names(seen[-1]) == _jax_dtypes(precision), precision
    assert trainer.mixed == precision.startswith("bf16")


@pytest.mark.parametrize("precision", ["16-mixed", "16", "16-true", "64", "64-true"])
def test_precision_strings_jax_reads_as_fp32_are_refused(precision):
    """JAX trains these in fp32 whatever the name says; the port refuses
    them (a conscious fix), in the config and in the trainer."""
    assert _jax_dtypes(precision) == ("float32", "float32")
    with pytest.raises(ValueError, match="precision"):
        TrainerConfig(precision=precision)
    with pytest.raises(ValueError, match="precision"):
        _port_trainer(precision, [])


# -- soft_argmax_2d, the losses, the UnrealEgo projection ------------------------------


def _heatmaps(rng, shape=(2, 3, 16, 12)):
    return (rng.normal(size=shape) * 3).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
def test_soft_argmax_matches_jax(normalize):
    rng = np.random.default_rng(1)
    _value_and_vjp_match(lambda h: jheatmap.soft_argmax_2d(h, normalize),
                         lambda h: heatmap.soft_argmax_2d(h, normalize),
                         [_heatmaps(rng)], rng)


LOSSES = {
    "mse": (jlosses.joints_mse_loss, losses.joints_mse_loss, False),
    "mse_weighted": (jlosses.joints_mse_loss, losses.joints_mse_loss, True),
    "ohkm": (lambda p, t, w: jlosses.joints_ohkm_mse_loss(p, t, w, topk=3),
             lambda p, t, w: losses.joints_ohkm_mse_loss(p, t, w, topk=3), False),
    "ohkm_weighted": (lambda p, t, w: jlosses.joints_ohkm_mse_loss(p, t, w, topk=3),
                      lambda p, t, w: losses.joints_ohkm_mse_loss(p, t, w, topk=3),
                      True),
    "coordinate": (lambda p, t: jlosses.joints_coordinate_loss(p, t, (16, 12)),
                   lambda p, t: losses.joints_coordinate_loss(p, t, (16, 12)), None),
    "wing": (lambda p, t: jlosses.wing_loss(p, t, image_size=(16, 12)),
             lambda p, t: losses.wing_loss(p, t, image_size=(16, 12)), None),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    jfn, tfn, weighted = LOSSES[name]
    rng = np.random.default_rng(2)
    pred = _heatmaps(rng, (2, 6, 16, 12))
    if weighted is None:  # coordinate losses: target points in pixels
        target = (rng.uniform(size=(2, 6, 2)) * [12, 16]).astype(np.float32)
        args = [pred, target]
    else:
        target = rng.uniform(size=pred.shape).astype(np.float32)
        weight = (rng.uniform(size=(2, 6)) > 0.3).astype(np.float32) if weighted else None
        jfn0, tfn0 = jfn, tfn
        jfn = lambda p, t: jfn0(p, t, None if weight is None else jnp.asarray(weight))  # noqa: E731
        tfn = lambda p, t: tfn0(p, t, None if weight is None else torch.from_numpy(weight))  # noqa: E731
        args = [pred, target]
    _value_and_vjp_match(jfn, tfn, args, rng, grad_of=(0, 1))


def _unrealego_uv(pts, origin):
    """The unclipped (B, 2, J, 2) UnrealEgo coordinates in fp64, from the
    JAX module's constants: how far each point lies from a view's edge."""
    p = np.repeat(pts[:, None].astype(np.float64), 2, axis=1)
    p = p + (origin if origin is not None else np.array([[-6.0, 0, 0], [6.0, 0, 0]])[None, :, None])
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = np.maximum(np.hypot(x, y), 1e-12)
    theta = np.arctan(-z / r)
    rho = np.polyval(jcamera._UNREALEGO_POLY_W2C[::-1], theta)
    (cx, cy), (h, w) = jcamera._UNREALEGO_CENTER, jcamera._UNREALEGO_SIZE
    return np.stack([(x / r * rho + cx) / w, (y / r * rho + cy) / h], axis=-1)


@pytest.mark.parametrize("with_origin", [False, True])
def test_unrealego_project_matches_jax(with_origin):
    rng = np.random.default_rng(3)
    pts = (rng.uniform(size=(4, 16, 3)) * [240, 240, 100] - [120, 120, 80]).astype(np.float32)
    origin = (rng.normal(size=(1, 2, 1, 3)) * 5).astype(np.float32) if with_origin else None
    args = [pts] + ([origin] if with_origin else [])
    for name in ("unrealego", "unrealego2"):
        assert camera.projection_funcs[name] is camera.unrealego_project
    _, jin = jcamera.unrealego_project(*map(jnp.asarray, args))
    _, tin = camera.unrealego_project(*map(torch.from_numpy, args))
    uv = _unrealego_uv(pts, origin)
    away = np.all((np.abs(uv) > EDGE) & (np.abs(uv - 1) > EDGE), axis=-1)
    assert 0.1 < np.asarray(jin).mean() < 0.9 and away.mean() > 0.9
    np.testing.assert_array_equal(tin.numpy()[away], np.asarray(jin)[away])
    _value_and_vjp_match(lambda *a: jcamera.unrealego_project(*a)[0],
                         lambda *a: camera.unrealego_project(*a)[0], args, rng)


# -- the numpy copies, bitwise --------------------------------------------------------


def _rand_quat(rng, n=None):
    q = rng.normal(size=(4,) if n is None else (n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _cam(rng, n=None):
    return jext.trans_qrot_to_matrix(rng.normal(size=(3,) if n is None else (n, 3)),
                                     _rand_quat(rng, n))


def _pose(rng, *lead):
    return rng.normal(size=(*lead, 16, 3)) * 30.0


# name -> (function name in both modules, args from a seeded rng)
NUMPY_CASES = {
    "quat_to_matrix": (extrinsics, jext, "quat_to_matrix", lambda r: [_rand_quat(r, 8)]),
    "euler_xyz_to_matrix": (extrinsics, jext, "euler_xyz_to_matrix",
                            lambda r: [r.uniform(-3, 3, size=(8, 3))]),
    "matrix_to_euler_xyz": (extrinsics, jext, "matrix_to_euler_xyz",
                            lambda r: [jext.quat_to_matrix(_rand_quat(r, 8))]),
    "trans_qrot_to_matrix": (extrinsics, jext, "trans_qrot_to_matrix",
                             lambda r: [r.normal(size=(5, 3)), _rand_quat(r, 5)]),
    "transformation_matrix_to_translation_and_rotation": (
        extrinsics, jext, "transformation_matrix_to_translation_and_rotation",
        lambda r: [_cam(r, 4)]),
    "transform_pose": (extrinsics, jext, "transform_pose",
                       lambda r: [_pose(r, 3), _cam(r, 3)]),
    "global_skeleton_2_local_skeleton": (extrinsics, jext,
                                         "global_skeleton_2_local_skeleton",
                                         lambda r: [_pose(r), _cam(r)]),
    "get_concecutive_global_cam": (extrinsics, jext, "get_concecutive_global_cam",
                                   lambda r: [_cam(r, 5), _cam(r)]),
    "get_relative_global_pose": (extrinsics, jext, "get_relative_global_pose",
                                 lambda r: [_pose(r, 3), [
                                     {"loc": r.normal(size=3), "rot": _rand_quat(r)}
                                     for _ in range(3)]]),
    "get_relative_global_pose_with_camera_matrix": (
        extrinsics, jext, "get_relative_global_pose_with_camera_matrix",
        lambda r: [_pose(r, 4), _cam(r, 4)]),
    "get_global_pose_from_relative_global_pose": (
        extrinsics, jext, "get_global_pose_from_relative_global_pose",
        lambda r: [_pose(r, 4), _cam(r)]),
    "get_relative_camera_matrix": (extrinsics, jext, "get_relative_camera_matrix",
                                   lambda r: [_cam(r), _cam(r)]),
    "get_relative_transform": (extrinsics, jext, "get_relative_transform",
                               lambda r: [r.normal(size=3), r.uniform(-1, 1, 3),
                                          r.normal(size=3), r.uniform(-1, 1, 3)]),
    "get_transform_relative_to_base_cv": (
        extrinsics, jext, "get_transform_relative_to_base_cv",
        lambda r: [r.normal(size=3), r.uniform(-1, 1, 3), r.normal(size=3),
                   r.uniform(-1, 1, 3)]),
    "get_transform_relative_to_base_blender": (
        extrinsics, jext, "get_transform_relative_to_base_blender",
        lambda r: [r.normal(size=3), r.uniform(-1, 1, 3), r.normal(size=3),
                   r.uniform(-1, 1, 3)]),
    "get_cv_rt_from_blender": (extrinsics, jext, "get_cv_rt_from_blender",
                               lambda r: [r.normal(size=3), r.uniform(-1, 1, 3)]),
    "get_cv_rt_from_cv": (extrinsics, jext, "get_cv_rt_from_cv",
                          lambda r: [r.normal(size=3), r.uniform(-1, 1, 3)]),
    "blender_to_opencv_extrinsics": (camera, jcamera, "blender_to_opencv_extrinsics",
                                     lambda r: [_cam(r)]),
    "opencv_to_blender_extrinsics": (camera, jcamera, "opencv_to_blender_extrinsics",
                                     lambda r: [_cam(r, 3)]),
    "bone_lengths": (skeleton, jskeleton, "bone_lengths", lambda r: [_pose(r, 5)]),
    "renormalize_bone_lengths": (skeleton, jskeleton, "renormalize_bone_lengths",
                                 lambda r: [_pose(r, 3), _pose(r)]),
    "smooth_temporal": (skeleton, jskeleton, "smooth_temporal",
                        lambda r: [_pose(r, 9).astype(np.float32), 1.5]),
    "smooth_temporal_radius": (skeleton, jskeleton, "smooth_temporal",
                               lambda r: [_pose(r, 9), 0.7, 2]),
    "decode_heatmaps_np": (skeleton, jskeleton, "decode_heatmaps_np",
                           lambda r: [r.uniform(size=(15, 16, 12)).astype(np.float32),
                                      0.9]),
    "denormalize": (image, jimage, "denormalize",
                    lambda r: [r.normal(size=(3, 8, 6)).astype(np.float32)]),
    "tensor2im": (image, jimage, "tensor2im",
                  lambda r: [r.normal(size=(3, 8, 6)).astype(np.float32) * 2]),
    "align_by_pelvis": (image, jimage, "align_by_pelvis", lambda r: [_pose(r, 4)]),
    "pelvis_aligned_error": (image, jimage, "pelvis_aligned_error",
                             lambda r: [_pose(r, 4), _pose(r, 4)]),
    "compute_accel": (image, jimage, "compute_accel", lambda r: [_pose(r, 7)]),
    "compute_error_accel": (image, jimage, "compute_error_accel",
                            lambda r: [_pose(r, 7), _pose(r, 7)]),
    "compute_error_accel_vis": (image, jimage, "compute_error_accel",
                                lambda r: [_pose(r, 7), _pose(r, 7),
                                           r.uniform(size=(7, 16)) > 0.4]),
    "compute_error_verts": (image, jimage, "compute_error_verts",
                            lambda r: [r.normal(size=(3, 50, 3)), r.normal(size=(3, 50, 3))]),
}


def _assert_bitwise(got, want, name):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), name
        for g, w in zip(got, want):
            _assert_bitwise(g, w, name)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("case", sorted(NUMPY_CASES))
def test_numpy_copies_are_bitwise_jax(case):
    mod, jmod, fn, make = NUMPY_CASES[case]
    args = make(np.random.default_rng(4))
    _assert_bitwise(getattr(mod, fn)(*args), getattr(jmod, fn)(*args), case)


def test_skeleton_constants_are_jax():
    assert skeleton.JOINT_NAMES == jskeleton.JOINT_NAMES
    assert skeleton.PARENTS == jskeleton.PARENTS and skeleton.BONES == jskeleton.BONES
    assert set(extrinsics.__all__) == set(jext.__all__)
    _assert_bitwise(image.IMAGENET_MEAN, jimage.IMAGENET_MEAN, "mean")
    _assert_bitwise(image.IMAGENET_STD, jimage.IMAGENET_STD, "std")


def test_running_averages_are_jax():
    got, want = image.RunningAverageDict(), jimage.RunningAverageDict()
    single, jsingle = image.RunningAverage(), jimage.RunningAverage()
    assert single.average == jsingle.average == 0.0
    rng = np.random.default_rng(5)
    for _ in range(5):
        values, n = {"a": rng.normal(), "b": np.float32(rng.normal())}, int(rng.integers(1, 9))
        got.update(values, n)
        want.update(values, n)
        single.update(values["a"], n)
        jsingle.update(values["a"], n)
    assert got.averages() == want.averages()
    assert single.average == jsingle.average


@pytest.mark.parametrize("valid", [False, True])
def test_drawings_are_bitwise_jax(valid):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, size=(64, 48, 3), dtype=np.uint8)
    joints = rng.uniform(-4, 60, size=(16, 2)).astype(np.float32)
    ok = rng.uniform(size=16) > 0.3 if valid else None
    _assert_bitwise(image.draw_2d_joints(img, joints, ok),
                    jimage.draw_2d_joints(img, joints, ok), "draw_2d_joints")
    _assert_bitwise(image.egoglass_limb_masks(joints, (64, 48), 5),
                    jimage.egoglass_limb_masks(joints, (64, 48), 5), "limb masks")
