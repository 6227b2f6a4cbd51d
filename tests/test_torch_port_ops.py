"""The PyTorch port's ops held against the JAX package on the same numpy
inputs: lazy deformable sampling (vs the jnp reference and the interpreted
Pallas kernel), argmax decoding, the camera rig, the align-corners resize;
plus the port's import hygiene and its refusal to fall back to the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from egorear_tpu.models.layers import resize_align_corners as jax_resize
from egorear_tpu.ops.camera import CameraRig as JaxRig
from egorear_tpu.ops.deform_attn import _lazy_sample_reference
from egorear_tpu.ops.deform_attn import lazy_deform_sample as jax_lazy_sample
from egorear_tpu.ops.heatmap import argmax_2d as jax_argmax_2d
from egorear_tpu_torch.models.layers import resize_align_corners
from egorear_tpu_torch.ops.camera import CameraRig
from egorear_tpu_torch.ops.deform_attn import (
    lazy_deform_sample,
    lazy_deform_sample_plain,
)
from egorear_tpu_torch.ops.heatmap import argmax_2d
from torch_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _sample_case(pos_mode: str, seed: int = 2):
    """The shapes of tests/test_ops_deform_attn.py's lazy-sample case:
    locations in [-0.3, 1.3] (corners off every side), nh*Q = 60 rows (not a
    multiple of 8), a G=2 grouped pos table."""
    rng = np.random.default_rng(seed)
    B, H, W, Cin, Q, nh, P = 4, 16, 16, 24, 15, 4, 16
    feat = rng.normal(size=(B, H * W, Cin)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(B, Q, nh, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, nh, P)).astype(np.float32)
    w /= w.sum(axis=-1, keepdims=True)
    pos = {
        "none": None,
        "shared": rng.normal(size=(H * W, 8)).astype(np.float32),
        "interleaved": rng.normal(size=(2, H * W, 8)).astype(np.float32),
        "block": rng.normal(size=(2, H * W, 8)).astype(np.float32),
    }[pos_mode]
    return feat, loc, w, pos, pos_mode == "block"


def _port_sample(feat, loc, w, pos, block):
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return lazy_deform_sample_plain(t(feat), t(loc), t(w), t(pos), block)


def _assert_samples_close(got, want, atol):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


@pytest.mark.parametrize("pos_mode", ["none", "shared", "interleaved", "block"])
def test_lazy_sample_plain_matches_jax_reference(pos_mode):
    feat, loc, w, pos, block = _sample_case(pos_mode)
    want = _lazy_sample_reference(feat, loc, w, pos, block)
    _assert_samples_close(_port_sample(feat, loc, w, pos, block), want, 1e-4)


@pytest.mark.parametrize("pos_mode", ["none", "interleaved", "block"])
def test_lazy_sample_plain_matches_interpreted_pallas(pos_mode):
    feat, loc, w, pos, block = _sample_case(pos_mode)
    with pltpu.force_tpu_interpret_mode():
        want = jax_lazy_sample(feat, loc, w, pos=pos, impl="pallas",
                               pos_block=block)
    _assert_samples_close(_port_sample(feat, loc, w, pos, block), want, 1e-4)


@pytest.mark.parametrize("pos_mode", ["none", "interleaved", "block"])
def test_lazy_sample_plain_bf16_matches_jax_reference(pos_mode):
    """bf16 feat and pos, fp32 loc and attn_w: the port's plain version (the
    oracle the bf16 kernel is held to on the card) vs JAX's reference impl.

    The two round at different places. JAX rounds each weight of its
    sampling operator S to bf16 (2^-9 relative) before a bf16 matmul with
    fp32 accumulation; the port keeps the weights in fp32. Both round each
    output to bf16 once, and the two roundings may land one ulp (2^-8
    relative) apart. So per element |port - JAX| <= 2^-8 (|JAX| + sum |S| |v|),
    where sum |S| |v| is the fp32 sampling of |feat|, |pos| and ones.
    Measured on this case: at most one bf16 ulp of the output (3.9e-3 at
    0.746). The cascade in bf16 is not held to JAX yet (ROADMAP Queue C)."""
    feat, loc, w, pos, block = _sample_case(pos_mode)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    feat_b = t(feat).bfloat16()
    pos_b = None if pos is None else t(pos).bfloat16()
    got = lazy_deform_sample_plain(feat_b, t(loc), t(w), pos_b, block)
    as_jax = lambda x: None if x is None else jnp.asarray(  # noqa: E731
        x.float().numpy(), jnp.bfloat16)  # exact: the values are bf16
    want = jax_lazy_sample(as_jax(feat_b), loc, w, pos=as_jax(pos_b),
                           impl="reference", pos_block=block)
    mass = lazy_deform_sample_plain(feat_b.float().abs(), t(loc), t(w),
                                    None if pos_b is None else pos_b.float().abs(),
                                    block)
    for g, ww, m in zip(got, want, mass):
        if ww is None:
            assert g is None
            continue
        assert g.dtype == torch.bfloat16 and ww.dtype == jnp.bfloat16
        ww = np.asarray(ww.astype(jnp.float32))
        err = np.abs(g.float().numpy() - ww)
        bound = 2.0 ** -8 * (np.abs(ww) + m.numpy())
        assert (err <= bound).all(), float((err - bound).max())


def test_lazy_sample_wrapper_uses_plain_on_cpu():
    feat, loc, w, pos, block = _sample_case("block")
    args = [torch.from_numpy(x) for x in (feat, loc, w, pos)]
    before = lazy_deform_sample.launches
    got = lazy_deform_sample(*args, pos_block=block)
    want = lazy_deform_sample_plain(*args, pos_block=block)
    assert lazy_deform_sample.launches == before  # no kernel on the CPU
    for g, ww in zip(got, want):
        assert torch.equal(g, ww)


def test_lazy_sample_rejects_other_devices():
    feat, loc, w, pos, block = _sample_case("none")
    with pytest.raises(ValueError):
        lazy_deform_sample(torch.empty(feat.shape, device="meta"),
                           torch.empty(loc.shape, device="meta"),
                           torch.empty(w.shape, device="meta"))


@pytest.mark.parametrize("normalize", [False, True])
def test_argmax_2d_ties_match_jax_bitwise(normalize):
    rng = np.random.default_rng(5)
    hm = rng.normal(size=(2, 4, 15, 8, 12)).astype(np.float32)
    peak = hm.max() + 1.0
    hm[0, 0, 0, 2, 3] = hm[0, 0, 0, 5, 1] = peak  # row-major first: (2, 3)
    hm[0, 1, 2, 4, 7] = hm[0, 1, 2, 4, 9] = peak  # same row: x = 7
    hm[1, 3, 14] = 0.5  # all equal, exactly at the threshold: index 0
    got = argmax_2d(torch.from_numpy(hm), threshold=0.5, normalize=normalize)
    want = jax_argmax_2d(hm, threshold=0.5, normalize=normalize)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0, 0, 0].tolist() == ([3 / 12, 2 / 8] if normalize else [3, 2])
    assert got[0][1, 3, 14].tolist() == [0, 0] and bool(got[2][1, 3, 14])


@pytest.mark.parametrize("chained", [True, False])
def test_camera_project_matches_jax(chained):
    rng = np.random.default_rng(7)
    pts = np.stack([rng.uniform(-60, 60, (3, 16)), rng.uniform(-60, 60, (3, 16)),
                    rng.uniform(-20, 80, (3, 16))], axis=-1).astype(np.float32)
    pts[0, 0] = (0.0, 0.0, 30.0)  # r == 0 after no offset: the r_safe guard
    want = JaxRig.from_calib_file("ego4view_syn", chained=chained).project(pts)
    got = CameraRig.from_calib_file("ego4view_syn", chained=chained).project(
        torch.from_numpy(pts))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5, rtol=0)
    assert 0 < got[1].float().mean() < 1  # both in- and out-of-view points


def test_camera_rig_refuses_real_world_rig():
    """The real-world rig refuses to project without its per-sample
    device-to-camera transforms, as the JAX package's does (with them every
    rig is held to JAX in ``tests/test_torch_port_rigs.py``)."""
    pts = np.full((1, 16, 3), 30.0, np.float32)
    rig = CameraRig.from_calib_file("ego4view_rw")
    assert rig.is_rw and rig.num_views == 4
    with pytest.raises(ValueError, match="coord_trans_mat"):
        JaxRig.from_calib_file("ego4view_rw").project(pts)
    with pytest.raises(ValueError, match="coord_trans_mat"):
        rig.project(torch.from_numpy(pts))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 5, 4, 4), (8, 8)),  # x2 upsample
    ((2, 3, 32, 32), (8, 8)),  # downsample (the refiner head at 64 px)
    ((1, 2, 6, 10), (11, 7)),  # non-square, mixed
])
def test_resize_align_corners_matches_jax(shape, out_hw):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = jax_resize(x.transpose(0, 2, 3, 1), out_hw)  # NHWC in the JAX package
    got = resize_align_corners(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-6, rtol=0)


def test_build_without_cuda_raises(monkeypatch):
    from egorear_tpu_torch import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry.build((64, 64))
    with pytest.raises(RuntimeError):
        entry.build((64, 64), device="cuda")


def _port_sources():
    return sorted((REPO / "egorear_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax") or top == "egorear_tpu"


def test_port_never_imports_jax_or_the_jax_package():
    # Statically: no import statement anywhere in the port names them.
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"
    # Dynamically: importing every port module (and chip_smoke) loads none.
    modules = ["chip_smoke"] + [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_sources() if p.parent != REPO
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'egorear_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
