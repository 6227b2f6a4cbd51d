"""The model branches that no shipped yaml sets (``chip_smoke.BRANCHES``),
each held to the JAX package's ``EgoRearNet.apply`` on the CPU: 64 px, batch 2,
fp32, the same random weights (``random_variables``) and images.

Each case sets one branch of the MVFex stage (the query modes,
``use_1by1_conv``, dense cross-attention) and one of the lifter (dense
cross-attention, stage 3 without ``use_pred_heatmap_init``, the avgpool and
heatmap 3D proposals, ``norm_mlp_pred``), or the 512-channel head, which
changes both: six JAX compiles for eleven branches. The MVFex stage's
output does not depend on the lifter's branch, and the lifter is fed the
JAX stage's outputs, so each stage test holds its branch alone.

One jitted JAX forward per case also returns its two stages' own outputs
(``capture_intermediates``), so each stage is held alone too:

  * the MVFex stage (heatmaps and features of every stage) within 1e-5 +
    1e-4 relative, on the same images;
  * the 3D lifter within the same bound, on the JAX stage's outputs;
  * the cascade: heatmaps 2e-5, the argmax anchors bitwise, ``preds_3d``
    9e-3 cm, the bounds of ``test_torch_port_cascade.py``.

Each case runs at the first seed from 1 whose JAX forward has the margins
under which the argmax decode is stable against the heatmap error (every
top-1/top-2 gap and every distance to the 0.5 threshold above 5 x HM_ATOL)
and both valid and invalid anchors in each stage; the search looks at JAX
only. ``CASES`` records where it stopped, and the fixture searches on from
there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from egorear_tpu.models.configs import EgoRearNetCfg as JaxEgoRearNetCfg
from egorear_tpu.models.pose3d import EgoRearNet as JaxEgoRearNet
from egorear_tpu.ops.camera import CameraRig as JaxRig
from egorear_tpu.ops.heatmap import argmax_2d as jax_argmax_2d
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import load_flax
from egorear_tpu_torch.models.configs import EgoRearNetCfg
from egorear_tpu_torch.models.layers import MSDeformAttn, MultiheadAttention
from egorear_tpu_torch.models.pose3d import EgoRearNet
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.heatmap import argmax_2d
from test_torch_port_models import random_variables
from torch_threads import torch_threads  # noqa: F401

SIZE, B, HEATMAP_BIAS = 64, 2, 0.3
HM_ATOL, P3D_ATOL = 2e-5, 9e-3
MOD_ATOL, MOD_RTOL = 1e-5, 1e-4
# case ("+"-joined branches) -> where its seed search stopped.
CASES = {"1by1+avgpool": 1, "hm_embed+mlp_heatmap": 3,
         "jqa_mv+norm_mlp_pred": 10, "query_only+normal_p3d": 1,
         "normal_mvf+no_pred_init": 1, "head512": 3}
# The proposal's spread before unnormalisation: norm_mlp_pred maps it onto
# the flagship spread (+-60 cm in x and y, -20 to 80 cm in z).
NORM_SPREAD = (0.6, 0.6, (-0.7, 0.3))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_cfg(case: str, size=(SIZE, SIZE)) -> dict:
    """The flagship config dict with every branch of ``case`` set."""
    cfg = entry.flagship_cfg_dict(size)
    for b in case.split("+"):
        chip_smoke.set_keys(cfg, chip_smoke.BRANCHES[b])
    return cfg


def _stage_filter(mdl, method_name):
    return method_name == "__call__" and mdl.name in ("heatmap_estimator",
                                                      "pose3d_estimator")


def nchw_stack(x):
    """JAX's view-major (V, B, h, w, C) features -> the port's (V*B, C, h, w)."""
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(-1, *x.shape[2:]).transpose(0, 3, 1, 2)))


def _stable(want, jrig) -> bool:
    """Whether a JAX forward has the decode margins and mixed anchors."""
    preds, hms = want
    top = np.sort(hms[0].reshape(-1, (SIZE // 4) ** 2), axis=-1)
    valid = np.asarray(jax_argmax_2d(hms[0], threshold=0.5, normalize=True)[2])
    fov = np.asarray(jrig.project(preds[0])[1])
    return bool((top[:, -1] - top[:, -2]).min() > 5 * HM_ATOL
                and np.abs(top[:, -1] - 0.5).min() > 5 * HM_ATOL
                and 0 < valid.mean() < 1 and 0 < fov.mean() < 1)


@pytest.fixture(scope="module")
def runs():
    """{case: dict(want=(preds, hms), stages=JAX stage outputs, got=port
    (preds, hms), mvfex=port stage-2 outputs, lifter=port lifter preds on
    JAX's stage-2 outputs, model=port model, seed)}."""
    jrig = JaxRig.from_calib_file("ego4view_syn")
    rig = CameraRig.from_calib_file("ego4view_syn")
    out = {}
    for name, first in CASES.items():
        cfg = case_cfg(name)
        jnet = JaxEgoRearNet(cfg=JaxEgoRearNetCfg.from_dict(cfg))
        shapes = jax.eval_shape(lambda: jnet.init(
            jax.random.PRNGKey(0), jnp.zeros((B, 4, 3, SIZE, SIZE)), jrig))
        apply = jax.jit(lambda v, x: jnet.apply(
            v, x, jrig, capture_intermediates=_stage_filter,
            mutable=["intermediates"]))
        spread = {"pose_spread": NORM_SPREAD} if "norm_mlp_pred" in name else {}
        for seed in range(first, first + 20):
            rng = np.random.default_rng(seed)
            variables = random_variables(shapes, rng, heatmap_bias=HEATMAP_BIAS,
                                         **spread)
            img = rng.normal(size=(B, 4, 3, SIZE, SIZE)).astype(np.float32)
            want, inter = jax.tree.map(np.asarray, apply(variables, img))
            if _stable(want, jrig):
                break
        else:
            raise AssertionError(f"{name}: no seed in 20 with stable anchors")
        inter = inter["intermediates"]
        stages = {k: inter[k]["__call__"][0] for k in ("heatmap_estimator",
                                                       "pose3d_estimator")}

        model = load_flax(EgoRearNet(EgoRearNetCfg.from_dict(cfg)), variables).eval()
        mvfex = {}
        hook = model.heatmap_estimator.register_forward_hook(
            lambda m, i, o: mvfex.setdefault("out", o))
        with torch.inference_mode():
            got = model(torch.from_numpy(img), rig)
            hook.remove()
            j_hms, j_feats = stages["heatmap_estimator"]
            lifter = model.pose3d_estimator(
                nchw_stack(j_feats[0]), nchw_stack(j_feats[-1]),
                torch.from_numpy(j_hms[-1].copy()), rig)
        out[name] = dict(want=want, stages=stages, got=got, mvfex=mvfex["out"],
                         lifter=lifter, model=model, jrig=jrig, seed=seed)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mvfex_stage_matches_jax(runs, case):
    r = runs[case]
    want_hms, want_feats = r["stages"]["heatmap_estimator"]
    got_hms, got_feats = r["mvfex"]
    assert len(got_hms) == len(want_hms) == len(got_feats) == len(want_feats) == 2
    Cin = case_cfg(case)["heatmap_mvf_cfg"]["mvf_cfg"]["input_dims"]
    for g, w in zip(got_hms, want_hms):
        assert g.shape == w.shape == (B, 4, 15, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=MOD_ATOL, rtol=MOD_RTOL)
    for g, w in zip(got_feats, want_feats):
        w = nchw_stack(w).numpy()
        assert g.shape == w.shape == (4 * B, Cin, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=MOD_ATOL, rtol=MOD_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_pose3d_lifter_matches_jax(runs, case):
    r = runs[case]
    want = r["stages"]["pose3d_estimator"]
    assert len(r["lifter"]) == len(want) == 4
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(r["lifter"], want)]
    print(f"{case}: lifter on JAX's stage-2 outputs, max-abs (cm) {errs}")
    for g, w in zip(r["lifter"], want):
        np.testing.assert_allclose(g.numpy(), w, atol=MOD_ATOL, rtol=MOD_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_cascade_heatmaps_match_jax(runs, case):
    r = runs[case]
    (_, want), (_, got) = r["want"], r["got"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 4, 15, SIZE // 4, SIZE // 4)
        np.testing.assert_allclose(g.numpy(), w, atol=HM_ATOL, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_cascade_anchors_match_jax_bitwise(runs, case):
    r = runs[case]
    (want_p3d, want_hm), (got_p3d, got_hm) = r["want"], r["got"]
    top = np.sort(want_hm[0].reshape(-1, (SIZE // 4) ** 2), axis=-1)
    assert (top[:, -1] - top[:, -2]).min() > 5 * HM_ATOL
    assert np.abs(top[:, -1] - 0.5).min() > 5 * HM_ATOL
    want = jax_argmax_2d(want_hm[0], threshold=0.5, normalize=True)
    got = argmax_2d(got_hm[0], threshold=0.5, normalize=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < got[2].float().mean() < 1  # valid and invalid anchors
    _, want_fov, _ = r["jrig"].project(want_p3d[0])
    _, got_fov, _ = CameraRig.from_calib_file("ego4view_syn").project(got_p3d[0])
    np.testing.assert_array_equal(got_fov.numpy(), np.asarray(want_fov))
    assert 0 < got_fov.float().mean() < 1


@pytest.mark.parametrize("case", list(CASES))
def test_cascade_preds_3d_match_jax(runs, case):
    r = runs[case]
    (want, _), (got, _) = r["want"], r["got"]
    assert len(got) == len(want) == 4
    errs = [float(np.abs(g.numpy() - w).max()) for g, w in zip(got, want)]
    print(f"{case} (seed {r['seed']}): preds_3d stage max-abs divergence "
          f"(cm) {errs}")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 16, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=P3D_ATOL, rtol=0)


@pytest.mark.parametrize("dense_branch", ["normal_mvf", "normal_p3d"])
def test_dense_layers_have_no_deformable_attention(runs, dense_branch):
    """A stage with ``use_normal_cross_attn`` holds 4-head
    ``cross_attn_dense`` layers and no sampling module; the other stage
    keeps its deformable layers."""
    model = next(r["model"] for case, r in runs.items()
                 if dense_branch in case.split("+"))
    dense, other = ((model.heatmap_estimator, model.pose3d_estimator)
                    if dense_branch == "normal_mvf"
                    else (model.pose3d_estimator, model.heatmap_estimator))
    layers = [m for m in dense.modules() if hasattr(m, "cross_attn_dense")]
    assert layers and all(isinstance(m.cross_attn_dense, MultiheadAttention)
                          and m.cross_attn_dense.num_heads == 4 for m in layers)
    assert not any(isinstance(m, MSDeformAttn) for m in dense.modules())
    assert any(isinstance(m, MSDeformAttn) for m in other.modules())
