"""The port in bf16 held against the JAX package in bf16, on the CPU, on the
same numpy inputs and the same bf16 weights:

  * the per-head plain forward (``deformable_sampling_plain``, the card
    kernel's oracle) vs the Pallas kernel ``_make_deform_kernel``
    interpreted (``_sample_pallas_vjp`` under
    ``pltpu.force_tpu_interpret_mode()``), within a bound derived in the
    test's docstring;
  * the BN-folded bf16 serving forward, 64 px, batch 2, in both computation
    orders: JAX folds BatchNorm in fp32 and casts every fp32 leaf to bf16 as
    ``bench.py`` does, and the port loads those very bf16 values
    (``from_flax`` of the folded tree, then ``.to(torch.bfloat16)``). The
    JAX lazy order runs its reference sampling (``EGOREAR_LAZY_IMPL=
    reference``): its bf16 default is the Pallas S-builder, which the CPU
    backend refuses outside interpret mode.

Tolerances for the serving forward sit below the gap that computing in
fp32 would open, each framework's own bf16 vs fp32 gap on these inputs
(seed 1, perturbed random weights, bf16 vs unrounded fp32 weights; measured
on the CPU): initial heatmaps JAX 0.0101, the port 0.0080 (scale 1.06);
refined heatmaps 0.0092 and 0.0125 (scale 0.54); ``preds_3d`` 0.28-0.30 cm
in both. The heatmaps leave little room: bf16 holds 8 significant bits,
so neighbouring bf16 values near 1 lie 2^-7 = 0.0078 apart, and the gap is
about one such step. So the initial heatmaps are held to one bf16 step at their
scale, 2^-7 (measured: exactly that, in either order; the next possible
difference, 0.0098, would fail), and only just tell bf16 from fp32.
``preds_3d`` is the output that tells the precisions apart with room: it is
held to 0.1 cm (measured <= 0.0254), a third of the gap.

The refined heatmaps depend on the 2D anchors, the argmax of the initial
ones, and the anchors of a bf16 heatmap are not bitwise: its 16 x 16 maps
are flat at the top, with ties and near-ties a bf16 step apart (seed 1: 7
of 120 joints pick another cell, each a top-two gap of at most one step;
only 20 anchors have a top-two gap above twice the tolerance). The refiners
mix joints and views, so every refined map of a batch element feels its
flipped anchors: end to end the refined stage diverges by 0.0146 (lazy)
and 0.0137 (reference), above either gap. The refined stage is therefore
held where its anchors are determined by construction: the port's
refiners are given JAX's bf16 initial heatmaps (so both cascades take the
same anchors), and its refined heatmaps are held to 2^-7, two bf16 steps at
their scale and below either gap (measured 0.0039 lazy, 0.0049 reference).
End to end, with its own anchors, the refined stage is held only to 2^-5
= 0.031, four bf16 steps near 1 (it cannot tell bf16 from fp32 there),
and the anchors themselves to what the heatmap tolerance implies: validity
bitwise, the cell bitwise where the top-two gap exceeds twice the
tolerance, and elsewhere a near-tie.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from egorear_tpu.models import backbone as jbackbone
from egorear_tpu.models.configs import EgoRearNetCfg
from egorear_tpu.models.pose3d import EgoRearNet as JaxEgoRearNet
from egorear_tpu.ops.camera import CameraRig as JaxRig
from egorear_tpu.ops.deform_attn import _sample_pallas_vjp
from egorear_tpu.ops.heatmap import argmax_2d as jax_argmax_2d
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.entry import build, flagship_cfg_dict
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.deform_attn import deformable_sampling_plain
from egorear_tpu_torch.ops.heatmap import argmax_2d
from test_torch_port_models import random_variables
from torch_threads import torch_threads  # noqa: F401

SIZE, B, SEED, HEATMAP_BIAS = 64, 2, 1, 0.3
HM_ATOL = 2.0 ** -7  # initial and anchor-forced refined heatmaps; measured 0.0078, <= 0.0049
HM_END_TO_END_ATOL = 2.0 ** -5  # refined heatmaps on the port's own anchors; measured <= 0.0146
P3D_ATOL = 0.1  # cm; measured <= 0.0254
ORDERS = ["lazy", "reference"]


def test_sampling_plain_bf16_matches_jax_pallas():
    """The per-head plain forward in bf16 vs the interpreted Pallas kernel
    on the same bf16 value (fp32 locations and weights, as both sample).

    Both sum in fp32 and round the output to bf16 once. The Pallas kernel
    also rounds each entry S_i of its sampling operator (the summed weights
    of the corners on cell i) to bf16 before its dot, which the port does
    not. With x and x' the two fp32 sums of a row, and 2^-9 the relative
    error of a bf16 rounding:

        |x - x'| <= sum_i |S_i - bf16(S_i)| |v_i| <= 2^-9 sum_i |S_i| max|v|
                 <= 2^-9 sum_p |a_p| max|v|

    (the bilinear factors of a point sum to at most 1), and each output
    rounding adds at most 2^-9 of its value, so elementwise

        |out - out'| <= 2^-9 (|out| + |out'| + sum_p |a_p| max|v|)

    plus fp32 rounding of the sums (1e-6 here). Measured well inside it.
    """
    rng = np.random.default_rng(7)
    Bs, H, nh, ch, Q, P = 2, 16, 4, 8, 15, 16
    value = jnp.asarray(rng.normal(size=(Bs, H, H, nh, ch)), jnp.bfloat16)
    loc = rng.uniform(-0.2, 1.2, size=(Bs, Q, nh, P, 2)).astype(np.float32)
    w = rng.uniform(size=(Bs, Q, nh, P)).astype(np.float32)
    w /= w.sum(axis=-1, keepdims=True)
    with pltpu.force_tpu_interpret_mode():
        want = _sample_pallas_vjp(value, loc, w)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    v32 = np.array(value.astype(jnp.float32))
    got = deformable_sampling_plain(torch.from_numpy(v32).bfloat16(),
                                    torch.from_numpy(loc), torch.from_numpy(w))
    assert got.dtype == torch.bfloat16 and got.shape == (Bs, Q, nh * ch)
    got = got.float().numpy()
    a_sum = np.repeat(np.abs(w).sum(-1), ch, axis=-1).reshape(got.shape)
    bound = 2.0 ** -9 * (np.abs(got) + np.abs(want) + a_sum * np.abs(v32).max()) + 1e-6
    err = np.abs(got - want)
    print(f"bf16 per-head forward vs Pallas: max-abs {err.max():.3e}, "
          f"largest share of the bound {(err / bound).max():.3f}")
    assert (err <= bound).all(), f"max excess {(err - bound).max():.3e}"


def _jax_serving(lazy):
    """JAX's BN-folded bf16 serving forward of one order, its rig, and the
    folded bf16 variables as fp32 numpy arrays (exact)."""
    cfg = lambda **kw: EgoRearNetCfg.from_dict(  # noqa: E731
        flagship_cfg_dict((SIZE, SIZE), lazy_deform=lazy, **kw))
    rig = JaxRig.from_calib_file("ego4view_syn")
    img = jnp.zeros((B, 4, 3, SIZE, SIZE), jnp.float32)
    shapes = jax.eval_shape(
        lambda: JaxEgoRearNet(cfg=cfg()).init(jax.random.PRNGKey(0), img, rig))
    rng = np.random.default_rng(SEED)
    variables = random_variables(shapes, rng, heatmap_bias=HEATMAP_BIAS)
    img = rng.normal(size=(B, 4, 3, SIZE, SIZE)).astype(np.float32)
    # bench.py's serving cast: fold in fp32, then every fp32 leaf to bf16.
    folded = jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        jbackbone.fold_batchnorm(variables))
    net = JaxEgoRearNet(cfg=cfg(bn_folded=True))
    out = jax.jit(lambda v, x: net.apply(v, x, rig))(
        folded, jnp.asarray(img, jnp.bfloat16))
    return out, rig, folded, img


@pytest.fixture(scope="module")
def serving():
    """{order: (jax (preds_3d, heatmaps), port (preds_3d, heatmaps), jax
    rig, the port's refined heatmaps when its refiners are given JAX's
    initial heatmaps)}, every output as fp32 numpy, after checking that the
    two agree on each output's dtype."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EGOREAR_LAZY_IMPL", "reference")
        for order in ORDERS:
            lazy = order == "lazy"
            (want_p3d, want_hm), rig, folded, img = _jax_serving(lazy)
            model, trig = build((SIZE, SIZE), device="cpu", bn_folded=True,
                                lazy_deform=lazy)
            model.load_state_dict(from_flax(jax.tree.map(
                lambda x: np.asarray(x.astype(jnp.float32)), folded)), strict=True)
            model = model.to(torch.bfloat16)
            with torch.inference_mode():
                got_p3d, got_hm = model(torch.from_numpy(img).bfloat16(), trig)
            forced = torch.from_numpy(np.asarray(want_hm[0], np.float32)).bfloat16()
            with pytest.MonkeyPatch.context() as mp_hm, torch.inference_mode():
                mp_hm.setattr(model.heatmap_estimator, "_heatmaps_from_feat",
                              lambda feat_f, feat_b: forced)
                _, forced_hm = model(torch.from_numpy(img).bfloat16(), trig)
            assert torch.equal(forced_hm[0], forced)
            # The same dtype at every output: bf16 but for the lifting
            # layers' preds_3d, fp32 in both.
            assert [str(x.dtype) for x in (*want_p3d, *want_hm)] == [
                str(x.dtype)[6:] for x in (*got_p3d, *got_hm)]
            assert str(want_hm[0].dtype) == "bfloat16"
            f32 = lambda xs: [np.asarray(x, np.float32) for x in xs]  # noqa: E731
            runs[order] = ((f32(jnp.asarray(x, jnp.float32) for x in want_p3d),
                            f32(jnp.asarray(x, jnp.float32) for x in want_hm)),
                           ([x.float().numpy() for x in got_p3d],
                            [x.float().numpy() for x in got_hm]), rig,
                           forced_hm[1].float().numpy())
    return runs


@pytest.mark.parametrize("order", ORDERS)
def test_bf16_serving_heatmaps_match_jax(serving, order):
    """Initial heatmaps and the refined ones on JAX's anchors within one
    bf16 step near 1, 2^-7, below the bf16 vs fp32 gap; the refined ones on
    the port's own anchors within 2^-5 (see the module's docstring)."""
    (_, want), (_, got), _, forced = serving[order]
    assert len(got) == len(want) == 2
    for g, w in zip((*got, forced), (*want, want[1])):
        assert g.shape == w.shape == (B, 4, 15, SIZE // 4, SIZE // 4)
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    forced_err = float(np.abs(forced - want[1]).max())
    print(f"{order}: bf16 heatmap max-abs divergence: initial {errs[0]}, "
          f"refined on JAX's anchors {forced_err}, on the port's {errs[1]}")
    np.testing.assert_allclose(got[0], want[0], atol=HM_ATOL, rtol=0)
    np.testing.assert_allclose(forced, want[1], atol=HM_ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=HM_END_TO_END_ATOL, rtol=0)


@pytest.mark.parametrize("order", ORDERS)
def test_bf16_serving_anchors_match_jax(serving, order):
    """The refiners' 2D anchors (argmax of the initial heatmaps). With every
    heatmap error within the tolerance tol, a top-two gap above 2 tol in
    JAX's map fixes the argmax, and elsewhere the port's cell lies within
    2 tol of the maximum of JAX's map: those two hold, validity is bitwise,
    and so are the lifting layers' anchors (the projected proposal)."""
    (want_p3d, want_hm), (got_p3d, got_hm), rig, _ = serving[order]
    want = jax_argmax_2d(jnp.asarray(want_hm[0]), threshold=0.5, normalize=True)
    got = argmax_2d(torch.from_numpy(got_hm[0]), threshold=0.5, normalize=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].float().mean() < 1  # valid and invalid anchors
    flat_w = want_hm[0].reshape(-1, (SIZE // 4) ** 2)
    pick_w = flat_w.argmax(-1)
    pick_g = got_hm[0].reshape(-1, (SIZE // 4) ** 2).argmax(-1)
    top = np.sort(flat_w, axis=-1)
    tol = HM_ATOL
    determined = top[:, -1] - top[:, -2] > 2 * tol
    print(f"{order}: {int((pick_w != pick_g).sum())} of {pick_w.size} anchors "
          f"on another cell, {int(determined.sum())} determined")
    assert determined.any()
    np.testing.assert_array_equal(pick_g[determined], pick_w[determined])
    at_pick = flat_w[np.arange(pick_g.size), pick_g]
    assert (top[:, -1] - at_pick <= 2 * tol).all()
    same = (pick_w == pick_g).reshape(np.asarray(want[0]).shape[:-1])
    np.testing.assert_array_equal(got[0].numpy()[same], np.asarray(want[0])[same])
    _, want_fov, _ = rig.project(jnp.asarray(want_p3d[0]))
    _, got_fov, _ = CameraRig.from_calib_file("ego4view_syn").project(
        torch.from_numpy(got_p3d[0]))
    np.testing.assert_array_equal(got_fov.numpy(), np.asarray(want_fov))


@pytest.mark.parametrize("order", ORDERS)
def test_bf16_serving_preds_3d_match_jax(serving, order):
    (want, _), (got, _), _, _ = serving[order]
    assert len(got) == len(want) == 4  # proposal + 3 lifting layers
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    print(f"{order}: bf16 preds_3d stage max-abs divergence (cm) {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 16, 3)
        np.testing.assert_allclose(g, w, atol=P3D_ATOL, rtol=0)
