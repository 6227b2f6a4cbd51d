"""The whole flagship forward of the PyTorch port vs the JAX package's
``EgoRearNet.apply``: 64 px, batch 2, fp32 on the CPU, the same perturbed
random weights (sampling offsets, attention weights and position tables
away from their zero init, so deformable sampling is non-trivial), first
with BatchNorm, then BN-folded (each framework folding its own weights).

Bounds: heatmaps 2e-5; the argmax anchors bitwise (the seed keeps every
top-1/top-2 gap and every distance to the 0.5 threshold far above the
heatmap error, and gives both valid and invalid anchors); 3D stages 9e-3 cm,
the fp32 envelope of PARITY.md.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egorear_tpu.models import backbone as jbackbone
from egorear_tpu.models.configs import EgoRearNetCfg
from egorear_tpu.models.pose3d import EgoRearNet as JaxEgoRearNet
from egorear_tpu.ops.camera import CameraRig as JaxRig
from egorear_tpu.ops.heatmap import argmax_2d as jax_argmax_2d
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.entry import FLAGSHIP_CFG, build
from egorear_tpu_torch.models.backbone import fold_batchnorm
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.heatmap import argmax_2d
from test_torch_port_models import random_variables

SIZE, B, SEED, HEATMAP_BIAS = 64, 2, 1, 0.3
HM_ATOL, P3D_ATOL = 2e-5, 9e-3


def _jax_net(bn_folded):
    d = copy.deepcopy(dict(FLAGSHIP_CFG, image_size=[SIZE, SIZE]))
    if bn_folded:
        d["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["bn_folded"] = True
    return JaxEgoRearNet(cfg=EgoRearNetCfg.from_dict(d))


@pytest.fixture(scope="module")
def runs():
    """{variant: (jax (preds, hms), port (preds, hms), jax rig)}"""
    net = _jax_net(False)
    rig = JaxRig.from_calib_file("ego4view_syn")
    img = jnp.zeros((B, 4, 3, SIZE, SIZE), jnp.float32)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), img, rig))
    rng = np.random.default_rng(SEED)
    variables = random_variables(shapes, rng, heatmap_bias=HEATMAP_BIAS)
    img = rng.normal(size=(B, 4, 3, SIZE, SIZE)).astype(np.float32)

    out = {}
    for variant in ("unfolded", "folded"):
        folded = variant == "folded"
        jnet = _jax_net(folded)
        jvars = jbackbone.fold_batchnorm(variables) if folded else variables
        want = jax.jit(lambda v, x: jnet.apply(v, x, rig))(jvars, img)
        want = jax.tree.map(np.asarray, want)

        model, trig = build((SIZE, SIZE), device="cpu", bn_folded=folded)
        if folded:
            model.load_state_dict(fold_batchnorm(from_flax(variables)), strict=True)
        else:
            load_flax(model, variables)
        with torch.inference_mode():
            got = model(torch.from_numpy(img), trig)
        out[variant] = (want, got, rig)
    return out


VARIANTS = ["unfolded", "folded"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_heatmaps_match_jax(runs, variant):
    (_, want), (_, got), _ = runs[variant]
    assert len(got) == len(want) == 2
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"{variant}: heatmap stage max-abs divergence {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 4, 15, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=HM_ATOL, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_anchors_match_jax_bitwise(runs, variant):
    (want_p3d, want_hm), (got_p3d, got_hm), rig = runs[variant]
    # The seed's margins keep the decode stable against the heatmap error.
    top = np.sort(want_hm[0].reshape(-1, (SIZE // 4) ** 2), axis=-1)
    assert (top[:, -1] - top[:, -2]).min() > 5 * HM_ATOL
    assert np.abs(top[:, -1] - 0.5).min() > 5 * HM_ATOL
    # 2D anchors of the refiners: argmax of the initial heatmaps.
    want = jax_argmax_2d(want_hm[0], threshold=0.5, normalize=True)
    got = argmax_2d(got_hm[0], threshold=0.5, normalize=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].float().mean() < 1  # valid and invalid anchors
    # Anchors of the lifting layers: validity of the projected proposal.
    _, want_fov, _ = rig.project(want_p3d[0])
    _, got_fov, _ = CameraRig.from_calib_file("ego4view_syn").project(got_p3d[0])
    np.testing.assert_array_equal(got_fov.numpy(), np.asarray(want_fov))
    assert 0 < got_fov.float().mean() < 1


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_preds_3d_match_jax(runs, variant):
    (want, _), (got, _), _ = runs[variant]
    assert len(got) == len(want) == 4  # proposal + 3 lifting layers
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"{variant}: preds_3d stage max-abs divergence (cm) {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 16, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=P3D_ATOL, rtol=0)
