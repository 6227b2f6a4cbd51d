"""The PyTorch port's modules held against the JAX package's modules: the
same random weights (drawn with numpy into the flax tree, carried across by
``egorear_tpu_torch.convert.from_flax``) and the same inputs, fp32 on the
CPU. Also: the port's BatchNorm folding vs the JAX package's, the weight
bridge's layout rules, and the config branches the port refuses."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from egorear_tpu.models import backbone as jbackbone
from egorear_tpu.models import layers as jlayers
from egorear_tpu.models import mvfex as jmvfex
from egorear_tpu.models.configs import MVFCfg as JMVFCfg
from egorear_tpu.models.configs import TransformerLayerCfg as JTransformerLayerCfg
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.entry import flagship_cfg
from egorear_tpu_torch.models import backbone, layers, mvfex, pose3d
from egorear_tpu_torch.models.configs import MVFCfg, TransformerLayerCfg

ATOL, RTOL = 1e-5, 1e-4


def random_variables(shapes, rng, pose_spread=(60.0, 60.0, (-20.0, 80.0)),
                     heatmap_bias=0.0):
    """A flax variables tree of the given shapes, filled from ``rng``.

    Kernels LeCun-normal, biases and norm parameters perturbed away from
    their init, BatchNorm stats non-trivial. Unlike the init, the sampling
    offsets, attention-weight kernels and position tables are non-zero, so
    deformable sampling is non-trivial; ``mlp_pred_out``'s bias is a random
    pose spread over ``pose_spread`` cm (x, y half-widths, z range), so the
    proposal projects partly inside the fisheye views; the initial heatmap
    heads get ``heatmap_bias`` added, which sets how many anchors pass the
    0.5 threshold.
    """

    def fill(path, s):
        name, shape = path[-1], s.shape
        core = shape[1:] if "refiners" in path else shape
        if name == "kernel":
            return rng.normal(size=shape) * np.prod(core[:-1]) ** -0.5
        if name == "bias":
            if path[-2] == "sampling_offsets":
                return rng.normal(size=shape) * 4.0  # pixels
            if path[-2] == "mlp_pred_out":
                n = shape[0] // 3
                sx, sy, (z0, z1) = pose_spread
                return np.stack([rng.uniform(-sx, sx, n), rng.uniform(-sy, sy, n),
                                 rng.uniform(z0, z1, n)], -1).reshape(shape)
            b = rng.normal(size=shape) * 0.1
            if path[-3:-1] in (("conv_heatmap_head_front", "Conv_4"),
                               ("conv_heatmap_head_back", "Conv_4")):
                b = b + heatmap_bias
            return b
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "mean":
            return rng.normal(size=shape) * 0.1
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape)
        if name == "joint_query_embed":
            return rng.normal(size=shape)
        if name == "frame_feat_multi_view_pos_embed":
            return rng.normal(size=shape) * 0.5
        raise KeyError(f"no fill rule for {'/'.join(path)}")

    out = {}
    for col, tree in shapes.items():
        flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
        out[col] = jax.tree_util.tree_unflatten(treedef, [
            fill(tuple(k.key for k in path), s).astype(np.float32)
            for path, s in flat])
    return out


def init_variables(module, seed, *args, **kwargs):
    """Random variables for a flax module called on ``args``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return random_variables(shapes, np.random.default_rng(seed))


def t(x):
    return torch.from_numpy(np.asarray(x))


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


# -- modules ------------------------------------------------------------------


@pytest.mark.parametrize("pos_block", [False, True])
def test_msdeform_attn_lazy_matches_jax(pos_block):
    rng = np.random.default_rng(0)
    B, Q, C, Cin, H, G = 8, 5, 32, 16, 8, 4
    q = rng.normal(size=(B, Q, C)).astype(np.float32)
    ref = rng.uniform(0, 1, size=(B, Q, 2)).astype(np.float32)
    feat = rng.normal(size=(B, H * H, Cin)).astype(np.float32)
    mk = (rng.normal(size=(Cin, C)) * 0.3).astype(np.float32)
    mb = rng.normal(size=(C,)).astype(np.float32)
    mp = rng.normal(size=(G, H * H, C)).astype(np.float32)

    jmod = jlayers.MSDeformAttnLazy(d_model=C, n_heads=4, n_points=16,
                                    pos_block=pos_block)
    args = (q, ref, feat, (H, H))
    kw = dict(mem_kernel=mk, mem_bias=mb, mem_pos=mp)
    variables = init_variables(jmod, 1, *args, **kw)
    want = jmod.apply(variables, *args, **kw)

    mod = load_flax(layers.MSDeformAttnLazy(C, 4, 16, pos_block=pos_block),
                    variables)
    got = mod(t(q), t(ref), t(feat), (H, H), mem_kernel=t(mk), mem_bias=t(mb),
              mem_pos=t(mp))
    assert_close(got, want)
    # Without the memory projection and pos table: memory of width C.
    feat_c = rng.normal(size=(B, H * H, C)).astype(np.float32)
    want = jmod.apply(variables, q, ref, feat_c, (H, H))
    assert_close(mod(t(q), t(ref), t(feat_c), (H, H)), want)


def test_multiview_transformer_layer_matches_jax():
    rng = np.random.default_rng(1)
    V, B, J, C, Cin, H = 4, 2, 5, 32, 16, 8
    q = rng.normal(size=(B, J, C)).astype(np.float32)
    anchors = rng.uniform(0, 1, size=(B, V, J, 2)).astype(np.float32)
    valid = rng.uniform(size=(B, V, J)) > 0.3
    feat = rng.normal(size=(V, B, H * H, Cin)).astype(np.float32)
    mk = (rng.normal(size=(Cin, C)) * 0.3).astype(np.float32)
    mb = rng.normal(size=(C,)).astype(np.float32)
    mp = rng.normal(size=(V, H * H, C)).astype(np.float32)

    jmod = jmvfex.MultiViewTransformerLayer(
        num_views=V, embed_dims=C, feat_shape=(H, H),
        cfg=JTransformerLayerCfg(), vmajor=True)
    kw = dict(feat_raw=feat, mem_kernel=mk, mem_bias=mb, mem_pos=mp)
    variables = init_variables(jmod, 2, q, None, anchors, valid, **kw)
    want = jmod.apply(variables, q, None, anchors, valid, **kw)

    mod = load_flax(mvfex.MultiViewTransformerLayer(V, C, (H, H),
                                                    TransformerLayerCfg()),
                    variables)
    got = mod(t(q), t(anchors), t(valid), t(feat.reshape(V * B, H * H, Cin)),
              mem_kernel=t(mk), mem_bias=t(mb), mem_pos=t(mp))
    assert_close(got, want)


def test_mvfex_refiner_matches_jax():
    """One view's JQA refiner: 128 raw channels, 64-d tokens (8x8 token
    maps, so the head's output is resized down to the residual's 4x4)."""
    rng = np.random.default_rng(2)
    V, B, J, Cin, C, h = 4, 2, 15, 128, 64, 8
    hm = rng.normal(size=(B, J, h, h)).astype(np.float32)
    feat_mv = rng.normal(size=(V, B, h, h, Cin)).astype(np.float32)
    anchors = rng.uniform(0, 1, size=(B, V, J, 2)).astype(np.float32)
    valid = rng.uniform(size=(B, V, J)) > 0.3
    bfb = rng.normal(size=(B, 512)).astype(np.float32)
    bfb_mv = rng.normal(size=(B, V, 512)).astype(np.float32)

    jcfg = JMVFCfg(input_dims=Cin, embed_dims=C, joint_query_adaptation=True,
                   transformer=JTransformerLayerCfg())
    jmod = jmvfex.MVFexRefiner(num_views=V, num_heatmap=J, feat_shape=(h, h),
                               detach_heatmap_feat=True, cfg=jcfg, vmajor=True)
    args = (hm, feat_mv[1], feat_mv, anchors, valid, bfb, bfb_mv)
    variables = init_variables(jmod, 3, *args)
    want_hm, want_feat = jmod.apply(variables, *args)

    cfg = MVFCfg(input_dims=Cin, embed_dims=C, joint_query_adaptation=True)
    mod = load_flax(mvfex.MVFexRefiner(V, J, (h, h), True, cfg), variables)
    tokens = t(feat_mv.reshape(V * B, h * h, Cin))
    got_hm, got_feat = mod(t(hm), t(nchw(feat_mv[1])), tokens, t(anchors),
                           t(valid), t(bfb))
    assert len(got_hm) == len(want_hm) == 1
    assert_close(got_hm[0], want_hm[0])
    assert_close(got_feat[0], nchw(want_feat[0]))


def test_conv_heatmap_head_matches_jax():
    x = np.random.default_rng(4).normal(size=(3, 8, 8, 16)).astype(np.float32)
    jmod = jmvfex.ConvHeatmapHead(input_dims=16, num_heatmap=15)
    variables = init_variables(jmod, 5, x)
    want = jmod.apply(variables, x)
    mod = load_flax(mvfex.ConvHeatmapHead(16, 15), variables)
    assert_close(mod(t(nchw(x))), nchw(want))


@pytest.fixture(scope="module")
def backbone_case():
    x = np.random.default_rng(6).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jbackbone.BackboneWithFPN()
    variables = init_variables(jmod, 7, x)
    return x, jmod, variables


def test_backbone_with_fpn_eval_bn_matches_jax(backbone_case):
    x, jmod, variables = backbone_case
    want_fpn, want_pyr = jmod.apply(variables, x)
    mod = load_flax(backbone.BackboneWithFPN(), variables).eval()
    got_fpn, got_pyr = mod(t(nchw(x)))
    assert_close(got_fpn, nchw(want_fpn))
    assert len(got_pyr) == len(want_pyr) == 4
    for g, w in zip(got_pyr, want_pyr):
        assert_close(g, nchw(w))


def test_fold_batchnorm_matches_jax(backbone_case):
    x, jmod, variables = backbone_case
    want = from_flax(jbackbone.fold_batchnorm(variables))
    got = backbone.fold_batchnorm(from_flax(variables))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    # The folded model computes what the unfolded one does in eval mode.
    ref = load_flax(backbone.BackboneWithFPN(), variables).eval()
    folded = backbone.BackboneWithFPN(bn_folded=True)
    folded.load_state_dict(got, strict=True)
    assert_close(folded(t(nchw(x)))[0], ref(t(nchw(x)))[0].detach())


# -- weight bridge --------------------------------------------------------------


def test_from_flax_layout_rules():
    rng = np.random.default_rng(8)
    variables = {
        "params": {
            "dense": {"kernel": rng.normal(size=(3, 5)), "bias": np.zeros(5)},
            "conv": {"kernel": rng.normal(size=(3, 3, 2, 4))},
            "norm": {"scale": np.ones(4), "bias": np.zeros(4)},
            "refiners": {"proj": {"kernel": rng.normal(size=(4, 6, 7))},
                         "pos_embed": rng.normal(size=(4, 1, 9))},
        },
        "batch_stats": {"norm": {"mean": np.zeros(4), "var": np.ones(4)}},
    }
    sd = from_flax(variables)
    k = variables["params"]
    np.testing.assert_array_equal(sd["dense.weight"].numpy(), k["dense"]["kernel"].T)
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  k["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert set(sd) >= {"norm.weight", "norm.bias", "norm.running_mean",
                       "norm.running_var", "norm.num_batches_tracked"}
    for v in range(4):  # the stacked refiner axis splits into 4 modules
        np.testing.assert_array_equal(sd[f"refiners.{v}.proj.weight"].numpy(),
                                      k["refiners"]["proj"]["kernel"][v].T)
        np.testing.assert_array_equal(sd[f"refiners.{v}.pos_embed"].numpy(),
                                      k["refiners"]["pos_embed"][v])


# -- refused branches ----------------------------------------------------------


def _cfg_with(**changes):
    """The 64 px flagship config with one nested field changed."""
    cfg = flagship_cfg((64, 64))
    for path, value in changes.items():
        parts = path.split("__")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        new = dataclasses.replace(objs[-1], **{parts[-1]: value})
        for obj, p in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            new = dataclasses.replace(obj, **{p: new})
        cfg = new
    return cfg


@pytest.mark.parametrize("change", [
    {"heatmap_mvf__mvf__use_1by1_conv": True},
    {"heatmap_mvf__mvf__joint_query_adaptation": False},
    {"heatmap_mvf__mvf__joint_query_adaptation_multi_view": True},
    {"heatmap_mvf__mvf__transformer__use_normal_cross_attn": True},
    {"heatmap_mvf__use_pred_heatmap_init": False},
    {"pose3d__use_mlp_avgpool": True},
    {"pose3d__use_mlp_heatmap": True},
    {"pose3d__norm_mlp_pred": True},
], ids=lambda c: next(iter(c)))
def test_unported_branches_raise(change):
    with pytest.raises(NotImplementedError):
        pose3d.EgoRearNet(_cfg_with(**change))
