"""The hot path's small constants (``egorear_tpu_torch.utils.constants``):
made once per (values, dtype, device) and kept on the device, so no
forward or train step copies from host memory, and the values that use
them bitwise what the per-call ``torch.tensor`` gave. On the CPU: the
sampling locations of both deformable attentions, the stereo baseline,
``norm_mlp_pred``'s range, the coordinate losses' image size and
``auc_3d``'s thresholds, each against the per-call formula. The last test
needs a card (it skips without one): the stage-3 eval forward and a
stage-3 and a stage-2 train step under PyTorch's sync check set to raise.

This file imports neither JAX nor the JAX package, so the card test also
runs with ``--noconftest`` on the card's host (~10 s here):

    python -m pytest tests/test_torch_port_constants.py -q -p no:cacheprovider --noconftest
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch

from egorear_tpu_torch.models import layers
from egorear_tpu_torch.models.configs import Pose3DCfg
from egorear_tpu_torch.models.layers import MSDeformAttn, MSDeformAttnLazy
from egorear_tpu_torch.models.pose3d import Pose3DLifter
from egorear_tpu_torch.ops.camera import unrealego_project
from egorear_tpu_torch.ops.heatmap import soft_argmax_2d
from egorear_tpu_torch.ops.losses import _normalized_points
from egorear_tpu_torch.ops.metrics import AUC_THRESHOLDS, auc_3d
from egorear_tpu_torch.utils import constants
from egorear_tpu_torch.utils.constants import device_constant
from torch_threads import torch_threads  # noqa: F401

SHAPES = [(16, 16), (12, 20)]  # (H, W): square and not
DTYPES = [torch.float32, torch.bfloat16]


def _attention(cls, dtype, seed=0):
    """A small deformable attention whose offsets reach well off the grid."""
    g = torch.Generator().manual_seed(seed)
    m = cls(d_model=32, n_heads=4, n_points=4)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
        m.sampling_offsets.weight.mul_(2.0)
        m.sampling_offsets.bias.mul_(5.0)
    return m.to(dtype)


def _inputs(shape, dtype, seed=1, B=2, Q=5, C=32):
    g = torch.Generator().manual_seed(seed)
    H, W = shape
    return (torch.randn(B, Q, C, generator=g).to(dtype),
            torch.rand(B, Q, 2, generator=g).to(dtype),
            torch.randn(B, H * W, C, generator=g).to(dtype))


def _old_locations(m, query, reference_points, shape):
    """The locations as ``_locations`` computed them before: a new
    normaliser tensor on every call."""
    B, Q, _ = query.shape
    H, W = shape
    offsets = m.sampling_offsets(query).reshape(B, Q, m.n_heads, m.n_points, 2)
    normalizer = torch.tensor([W, H], dtype=offsets.dtype, device=offsets.device)
    return reference_points[:, :, None, None, :] + offsets / normalizer


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("cls", [MSDeformAttn, MSDeformAttnLazy], ids=["reference", "lazy"])
def test_locations_are_bitwise_the_old_formula(cls, dtype, shape):
    m = _attention(cls, dtype)
    query, ref, _ = _inputs(shape, dtype)
    with torch.no_grad():
        loc, weights = m._locations(query, ref, shape)
        want = _old_locations(m, query, ref, shape)
    assert loc.dtype == weights.dtype == dtype and torch.equal(loc, want)


# The lazy sampling takes square grids only.
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("cls, sampler, shape", [
    (MSDeformAttn, "deformable_sampling", (16, 16)),
    (MSDeformAttn, "deformable_sampling", (12, 20)),
    (MSDeformAttnLazy, "lazy_deform_sample", (16, 16))],
    ids=["reference-square", "reference-wide", "lazy-square"])
def test_forward_samples_at_the_old_locations_bitwise(monkeypatch, cls, sampler,
                                                      shape, dtype):
    """The locations each forward hands to its sampling op are bitwise the
    per-call formula's."""
    m = _attention(cls, dtype)
    query, ref, memory = _inputs(shape, dtype)
    real, seen = getattr(layers, sampler), []

    def spy(value, loc, *args, **kwargs):
        seen.append(loc)
        return real(value, loc, *args, **kwargs)

    monkeypatch.setattr(layers, sampler, spy)
    with torch.no_grad():
        m(query, ref, memory, shape)
        want = _old_locations(m, query, ref, shape)
    (loc,) = seen
    assert loc.dtype == dtype and torch.equal(loc, want)


def test_repeated_calls_reuse_one_normaliser(monkeypatch):
    constants._made.cache_clear()
    made = []

    def spy(*args):
        made.append(device_constant(*args))
        return made[-1]

    monkeypatch.setattr(layers, "device_constant", spy)
    query, ref, _ = _inputs((12, 20), torch.float32)
    with torch.no_grad():
        for cls in (MSDeformAttn, MSDeformAttnLazy):
            m = _attention(cls, torch.float32)
            for _ in range(3):
                m._locations(query, ref, (12, 20))
    assert len(made) == 6 and all(n is made[0] for n in made)
    assert made[0].tolist() == [20.0, 12.0]
    info = constants._made.cache_info()
    assert (info.misses, info.hits) == (1, 5)


@pytest.mark.parametrize("cls", [MSDeformAttn, MSDeformAttnLazy],
                         ids=["reference", "lazy"])
def test_normaliser_made_in_inference_mode_serves_autograd(cls):
    """A normaliser first made under ``torch.inference_mode()`` (serving)
    is a normal tensor: a later training call saves it for its backward,
    and the offsets' gradients are bitwise the per-call formula's."""
    constants._made.cache_clear()
    m = _attention(cls, torch.float32)
    query, ref, _ = _inputs((12, 20), torch.float32)
    with torch.inference_mode():
        m._locations(query, ref, (12, 20))
    assert not device_constant((20, 12), torch.float32, "cpu").is_inference()
    g = torch.randn(2, 5, 4, 4, 2, generator=torch.Generator().manual_seed(3))

    def grads(locations):
        m.zero_grad(set_to_none=True)
        q = query.clone().requires_grad_()
        (locations(q) * g).sum().backward()
        return q.grad, m.sampling_offsets.weight.grad, m.sampling_offsets.bias.grad

    new = grads(lambda q: m._locations(q, ref, (12, 20))[0])
    old = grads(lambda q: _old_locations(m, q, ref, (12, 20)))
    assert constants._made.cache_info().misses == 1
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_device_constant_is_torch_tensor_once_per_dtype_and_device():
    constants._made.cache_clear()
    values = ((-6.0, 0, 0), (6.0, 0, 0))
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        with torch.inference_mode():
            c = device_constant(values, dtype, torch.device("cpu"))
        assert not c.is_inference() and not c.requires_grad
        assert c.dtype == dtype and torch.equal(c, torch.tensor(values, dtype=dtype))
        assert device_constant(values, dtype, "cpu") is c
    assert constants._made.cache_info().misses == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_stereo_baseline_is_bitwise_the_old_offsets(dtype):
    g = torch.Generator().manual_seed(4)
    pts = (torch.randn(3, 16, 3, generator=g) * 40.0
           + torch.tensor([0.0, 0.0, 60.0])).to(dtype)
    old = torch.tensor([[-6.0, 0, 0], [6.0, 0, 0]], dtype=dtype)[None, :, None, :]
    for got, want in zip(unrealego_project(pts), unrealego_project(pts, old)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_norm_mlp_pred_range_is_bitwise_the_old_lo_hi(dtype):
    lo_hi = dict(coor_norm_min=(-95.5, -80.25, -40.0), coor_norm_max=(90.0, 81.75, 150.5))
    cfg = Pose3DCfg(num_former_layers=1, mlp_dims=64, **lo_hi)
    torch.manual_seed(5)
    plain = Pose3DLifter(4, (64, 64), False, cfg).to(dtype).eval()
    normed = Pose3DLifter(4, (64, 64), False,
                          dataclasses.replace(cfg, norm_mlp_pred=True)).to(dtype).eval()
    normed.load_state_dict(plain.state_dict())
    g = torch.Generator().manual_seed(6)
    feats = torch.randn(8, 128, 16, 16, generator=g).to(dtype)
    with torch.no_grad():
        pred = plain._proposal(feats, None)
        got = normed._proposal(feats, None)
    lo = torch.tensor(lo_hi["coor_norm_min"], dtype=dtype)
    hi = torch.tensor(lo_hi["coor_norm_max"], dtype=dtype)
    assert torch.equal(got, (hi - lo) * (pred + 1.0) / 2.0 + lo)


@pytest.mark.parametrize("image_size", [(64, 64), (48, 80)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_normalized_points_are_bitwise_the_old_division(dtype, image_size):
    g = torch.Generator().manual_seed(7)
    hm = torch.randn(2, 15, 16, 16, generator=g).to(dtype)
    tgt = (torch.rand(2, 15, 2, generator=g) * 64.0).to(dtype)
    pts, tgt_n = _normalized_points(hm, tgt, image_size)
    raw, _ = soft_argmax_2d(hm)
    size = torch.tensor([image_size[1], image_size[0]], dtype=raw.dtype)
    assert torch.equal(pts, raw / size) and torch.equal(tgt_n, tgt / size)


@pytest.mark.parametrize("thresholds", [None, [10.0, 37.5, 150.0, 290.0]],
                         ids=["default", "list"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_auc_3d_is_bitwise_the_old_thresholds(dtype, thresholds):
    g = torch.Generator().manual_seed(8)
    gt = (torch.randn(4, 16, 3, generator=g) * 300.0).to(dtype)
    pred = gt + (torch.randn(4, 16, 3, generator=g) * 80.0).to(dtype)
    th_values = AUC_THRESHOLDS if thresholds is None else thresholds
    got = auc_3d(pred, gt) if thresholds is None else auc_3d(pred, gt, thresholds)
    dist = torch.linalg.vector_norm(gt - pred, dim=-1)
    th = torch.tensor(th_values, dtype=dist.dtype)
    want = (dist[..., None] <= th).to(dist.dtype).mean(dim=-2).mean(dim=-1)
    assert torch.equal(got, want)


# -- on the card -------------------------------------------------------------------


@contextlib.contextmanager
def _syncs_raise():
    """PyTorch's sync check set to raise on any blocking host-device
    synchronisation, over exactly what the ``syncs`` counter spans."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _batch(B, size, stage3, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"img": torch.randn(B, 4, 3, size, size, generator=g, device="cuda"),
             "gt_heatmap": torch.rand(B, 4, 15, size // 4, size // 4, generator=g,
                                      device="cuda")}
    if stage3:
        batch["gt_pose"] = torch.randn(B, 16, 3, generator=g, device="cuda") * 40.0
    return batch


@pytest.mark.cuda
def test_forward_and_train_steps_never_synchronise_on_card():
    """After one warm-up call each, the stage-3 eval forward (the top-level
    ``forward`` span) and one stage-3 and one stage-2 ``Trainer.train_step``
    (the ``train.step`` span) run with no blocking host-device
    synchronisation: any would raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from egorear_tpu_torch import entry

    task, trainer = entry.build_train((64, 64), device="cuda", precision="32",
                                      steps_per_epoch=1, imagenet=False)
    batch = _batch(2, 64, stage3=True)
    for run in (lambda: task._eval_forward({"img": batch["img"]}),
                lambda: trainer.train_step(batch)):
        run()  # builds the kernels and the constants, warms the allocator
        torch.cuda.synchronize()
        with _syncs_raise():
            run()
        torch.cuda.synchronize()

    task, trainer = entry.build_stage2((64, 64), steps_per_epoch=1, imagenet=False)
    batch = _batch(2, 64, stage3=False, seed=1)
    trainer.train_step(batch)
    torch.cuda.synchronize()
    with _syncs_raise():
        metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(metrics["loss_total"]))
