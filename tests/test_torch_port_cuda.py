"""The port's CUDA kernel wrappers, forward and backward, of both sampling
ops (lazy and per-head): their input checks (on the CPU) and the kernels
against their plain versions (on a card). Also on a card: a stage-2 train
step's kernel launches, a checkpoint round trip, the ImageNet graft, the
loader's pinned transfer and a stage-2 ``fit`` through the CLI.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU and nvcc, from
the repository root (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest tests/test_torch_port_cuda.py -q -p no:cacheprovider --noconftest
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from egorear_tpu_torch.ops.deform_attn import (
    _aligned16,
    _backward_kernel,
    _bwd_smem_bytes,
    _check_backward_inputs,
    _check_cuda_inputs,
    _check_sampling_backward_inputs,
    _check_sampling_inputs,
    _forward_kernel,
    _fwd_smem_bytes,
    _sampling_backward_kernel,
    _sampling_bwd_layout,
    _sampling_fwd_smem_bytes,
    _sampling_kernel,
    _vector_width,
    deformable_sampling,
    deformable_sampling_backward,
    deformable_sampling_backward_plain,
    deformable_sampling_plain,
    deformable_sampling_shared,
    lazy_deform_sample,
    lazy_deform_sample_backward,
    lazy_deform_sample_backward_plain,
    lazy_deform_sample_plain,
)
from egorear_tpu_torch.models.layers import deform_offset_bias


def _ring_loc(rng, B, Q, nh, P, H):
    """Locations shaped as the model's: each head's points on its ray from
    the query's anchor, 1 to P cells out (``deform_offset_bias``, the
    sampling offsets' init), moved by N(0, 1 cell); neighbouring points of
    a ray share corners, and the rays of a short grid run off its border."""
    anchors = rng.uniform(0.2, 0.8, size=(B, Q, 1, 1, 2))
    rays = deform_offset_bias(nh, P).numpy().reshape(nh, P, 2)
    loc = anchors + (rays + rng.normal(size=(B, Q, nh, P, 2))) / H
    return loc.astype(np.float32)


def _case(pos_mode: str, seed: int = 2, Cin: int = 128, C: int = 64,
          H: int = 16, rings: bool = False, B: int = 4, Q: int = 15,
          nh: int = 4, P: int = 16, G: int = 2):
    """Locations in [-0.3, 1.3] (corners off every side) or on the model's
    rays (:func:`_ring_loc`), by default nh*Q = 60 rows and a G=2 pos table in
    either layout; channels are multiples of 4."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(B, H * H, Cin)).astype(np.float32)
    loc = (_ring_loc(rng, B, Q, nh, P, H) if rings else
           rng.uniform(-0.3, 1.3, size=(B, Q, nh, P, 2)).astype(np.float32))
    w = rng.uniform(size=(B, Q, nh, P)).astype(np.float32)
    w /= w.sum(axis=-1, keepdims=True)
    pos = None if pos_mode == "none" else rng.normal(
        size=(G, H * H, C)).astype(np.float32)
    return feat, loc, w, pos, pos_mode == "block"


def _tensors(feat, loc, w, pos):
    return [None if x is None else torch.from_numpy(x) for x in (feat, loc, w, pos)]


def test_check_accepts_the_flagship_layout():
    feat, loc, w, pos = _tensors(*_case("block")[:4])
    _check_cuda_inputs(feat, loc, w, pos)
    _check_cuda_inputs(feat.bfloat16(), loc, w, pos.bfloat16())
    _check_cuda_inputs(feat, loc, w, None)


@pytest.mark.parametrize("fault", [
    "half", "feat_rank", "loc_shape", "strided_feat", "channels", "pos_dtype",
    "pos_grid", "too_many_points",
])
def test_check_refuses_what_the_kernel_cannot_take(fault):
    feat, loc, w, pos = _tensors(*_case("interleaved")[:4])
    if fault == "half":
        feat, pos = feat.half(), pos.half()
    elif fault == "feat_rank":
        feat = feat.reshape(4, 16, 16, 128)
    elif fault == "loc_shape":
        loc = loc[:, :, :, :8]
    elif fault == "strided_feat":
        feat = torch.cat([feat, feat], -1)[..., ::2]
    elif fault == "channels":
        feat = feat[..., :126].contiguous()
    elif fault == "pos_dtype":
        pos = pos.bfloat16()
    elif fault == "pos_grid":
        pos = pos[:, :200].contiguous()
    elif fault == "too_many_points":
        loc = loc.repeat(1, 1, 1, 128, 1)
        w = w.repeat(1, 1, 1, 128)
    with pytest.raises((TypeError, ValueError)):
        _check_cuda_inputs(feat, loc, w, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_mode", ["none", "interleaved", "block",
                                      "c52_c36_h20", "rings", "out_of_grid",
                                      "p512", "offset_loc"])
def test_kernel_matches_plain_on_card(pos_mode):
    """The CUDA kernel vs its plain version, fp32 (atol 1e-4: sums in
    another order) and bf16 (the plain version in fp32 on the same bf16
    inputs, atol 1e-2 of the largest output: one bf16 rounding of each
    output); one launch per call. The cases after ``block`` are
    :func:`_forward_case`'s; with every corner out of the grid the outputs
    are exactly zero. ``chip_smoke.py`` does the same at the flagship
    shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if pos_mode in ("none", "interleaved", "block"):
        feat, loc, w, pos, block = _case(pos_mode)
    else:
        feat, loc, w, pos, block = _forward_case(pos_mode)
    feat_t, loc_t, w_t, pos_t = _tensors(feat, loc, w, pos)
    for dtype in (torch.float32, torch.bfloat16):
        c = lambda x: None if x is None else x.cuda().to(dtype)  # noqa: E731
        want = lazy_deform_sample_plain(
            c(feat_t).float().cpu(), loc_t, w_t,
            None if pos_t is None else c(pos_t).float().cpu(), block)
        loc_c = loc_t.cuda()
        if pos_mode == "offset_loc":  # a view 4 bytes past an 8-byte boundary
            buf = torch.zeros(loc_c.numel() + 1, device="cuda")
            buf[1:] = loc_c.flatten()
            loc_c = buf[1:].view(loc_c.shape)
            assert loc_c.is_contiguous() and loc_c.data_ptr() % 8 == 4
        before = lazy_deform_sample.launches
        got = lazy_deform_sample(c(feat_t), loc_c, w_t.cuda(), c(pos_t), block)
        torch.cuda.synchronize()
        assert lazy_deform_sample.launches == before + 1
        scale = max(float(x.abs().max()) for x in want if x is not None)
        atol = 1e-4 if dtype == torch.float32 else 1e-2 * scale
        for g, ww in zip(got, want):
            if ww is None:
                assert g is None
                continue
            assert g.dtype == dtype and g.is_cuda and g.shape == ww.shape
            if pos_mode == "out_of_grid":
                assert not bool(g.any()) and not bool(ww.any())
            torch.testing.assert_close(g.float().cpu(), ww, atol=atol, rtol=0)


def test_forward_smem_fits_the_flagship_calls():
    """The forward kernel's shared memory is sized in one place,
    ``_fwd_smem_bytes``: both flagship calls (P = 16) fit the 48 KB a block
    takes without opt-in, and the check accepts them at batch 16 (the pos
    tables of the MVFex call in blocks of 16, pose3d without)."""
    assert _fwd_smem_bytes(16) <= 48 * 1024
    for Q, C, G in ((15, 256, 4), (16, 0, 0)):
        for dtype in (torch.float32, torch.bfloat16):
            feat = torch.zeros(64, 4096, 128, dtype=dtype)
            loc, w = torch.zeros(64, Q, 4, 16, 2), torch.zeros(64, Q, 4, 16)
            pos = torch.zeros(G, 4096, C, dtype=dtype) if C else None
            _check_cuda_inputs(feat, loc, w, pos)


@pytest.mark.parametrize("P", [512, 2048])
def test_forward_smem_check_refuses_before_any_launch(P):
    """A call whose corner lists exceed a block's shared memory raises in the
    wrapper, on any device, before the kernel is built or launched. Lists
    above 48 KB and within the opt-in limit are accepted (the kernel opts
    in): P = 512 needs 64 KB, P = 2048 more than a block can take."""
    feat = torch.zeros(2, 64, 8)
    loc, w = torch.zeros(2, 3, 1, P, 2), torch.zeros(2, 3, 1, P)
    assert _fwd_smem_bytes(P) > 48 * 1024
    if P == 512:
        _check_cuda_inputs(feat, loc, w, None)
        return
    before = lazy_deform_sample.launches
    with pytest.raises(ValueError, match="shared memory"):
        _forward_kernel(feat, loc, w, None, False)
    assert lazy_deform_sample.launches == before


def _forward_case(case: str):
    """Forward kernel cases on the card: ``c52_c36_h20`` (52 + 36 channels,
    both 4 mod 8, so bf16 takes the 8-byte path; a 20x20 grid; 3 x 5 x 3 =
    45 rows, which no block of 2 or 4 rows divides; P = 9, so a row's 36
    corners take two ballots, the second partial), ``rings`` (the points on
    the model's rays, :func:`_ring_loc`, where corners repeat),
    ``out_of_grid`` (every point a cell or more outside the grid), ``p512``
    (one row of 512 points: 64 KB of corner lists a block, so the kernel
    opts in above 48 KB of shared memory) and ``offset_loc`` (``block``'s
    inputs, with ``loc`` handed to the wrapper at an offset that the
    kernel's 8-byte loads cannot take, so the wrapper copies it)."""
    if case == "p512":
        return _case("none", B=1, Q=1, nh=1, P=512)
    if case == "offset_loc":
        return _case("block")
    if case == "c52_c36_h20":
        return _case("block", Cin=52, C=36, H=20, B=3, Q=5, nh=3, P=9, G=3)
    if case == "rings":
        return _case("interleaved", rings=True)
    feat, loc, w, pos, block = _case("block")
    side = np.where(loc > 0.5, 1.1, -0.1).astype(np.float32)  # off every side
    return feat, side + (loc - 0.5) * 0.01, w, pos, block


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["c52_c36_h20", "rings"])
def test_forward_kernel_is_bitwise_reproducible_on_card(case):
    """Two runs of the forward kernel on the same inputs give bitwise equal
    s_feat, s_pos and s_one (no atomics; the split corner sums meet in a
    fixed order), in fp32 and bf16; each call counts one launch."""
    _needs_card()
    feat, loc, w, pos, block = _forward_case(case)
    feat_t, loc_t, w_t, pos_t = _tensors(feat, loc, w, pos)
    for dtype in (torch.float32, torch.bfloat16):
        c = lambda x: None if x is None else x.cuda().to(dtype)  # noqa: E731
        args = (c(feat_t), loc_t.cuda(), w_t.cuda(), c(pos_t), block)
        before = lazy_deform_sample.launches
        first = lazy_deform_sample(*args)
        second = lazy_deform_sample(*args)
        torch.cuda.synchronize()
        assert lazy_deform_sample.launches == before + 2
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def _grads(feat, pos, seed=3):
    """Upstream gradients of one call on ``_case``'s shapes (Q=15, nh=4)."""
    rng = np.random.default_rng(seed)
    B = feat.shape[0]
    g = lambda c: torch.from_numpy(rng.normal(size=(B, 15, 4, c)).astype(np.float32))  # noqa: E731
    return g(feat.shape[-1]), (g(pos.shape[-1]) if pos is not None else None), g(1)


def test_backward_check_accepts_the_flagship_layout():
    feat, loc, w, pos = _tensors(*_case("block")[:4])
    g_feat, g_pos, g_one = _grads(feat, pos)
    _check_backward_inputs(feat, loc, w, pos, g_feat, g_pos, g_one)
    _check_backward_inputs(feat.bfloat16(), loc, w, pos.bfloat16(), g_feat.bfloat16(),
                           g_pos.bfloat16(), g_one.bfloat16())
    _check_backward_inputs(feat, loc, w, None, g_feat, None, g_one)


@pytest.mark.parametrize("fault", [
    "g_feat_shape", "g_one_missing", "g_pos_without_pos", "g_pos_missing",
    "g_dtype", "g_misaligned", "too_many_channels", "feat_fault",
])
def test_backward_check_refuses_what_the_kernel_cannot_take(fault):
    feat, loc, w, pos = _tensors(*_case("interleaved")[:4])
    g_feat, g_pos, g_one = _grads(feat, pos)
    if fault == "g_feat_shape":
        g_feat = g_feat[..., :64]
    elif fault == "g_one_missing":
        g_one = None
    elif fault == "g_pos_without_pos":
        pos = None
    elif fault == "g_pos_missing":
        g_pos = None
    elif fault == "g_dtype":
        g_feat = g_feat.bfloat16()
    elif fault == "g_misaligned":  # a view 4 bytes into a larger buffer
        g_feat = _misaligned(g_feat)
    elif fault == "too_many_channels":  # upstream rows exceed shared memory
        feat = torch.zeros(4, 256, 4096)
        g_feat = torch.zeros(4, 15, 4, 4096)
    elif fault == "feat_fault":  # the forward's checks apply too
        feat = feat.half()
    with pytest.raises((TypeError, ValueError)):
        _check_backward_inputs(feat, loc, w, pos, g_feat, g_pos, g_one)


def _misaligned(x):
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def test_backward_wrapper_realigns_upstream_gradients():
    """The kernel wrapper hands the kernel aligned copies of gradient views
    that autograd may pass, and leaves aligned ones as they are."""
    g = torch.arange(2 * 15 * 4 * 8, dtype=torch.float32).reshape(2, 15, 4, 8)
    view = _misaligned(g)
    assert view.data_ptr() % 16
    fixed = _aligned16(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, g)
    assert _aligned16(g) is g and _aligned16(None) is None
    strided = _aligned16(torch.cat([g, g], -1)[..., 8:])
    assert strided.is_contiguous() and torch.equal(strided, g)


def test_backward_wrapper_uses_plain_on_cpu():
    feat, loc, w, pos, block = _case("block")
    args = _tensors(feat, loc, w, pos)
    g = _grads(args[0], args[3])
    before = lazy_deform_sample_backward.launches
    got = lazy_deform_sample_backward(*args, block, *g, need_feat=False)
    want = lazy_deform_sample_backward_plain(*args, block, *g, need_feat=False)
    assert lazy_deform_sample_backward.launches == before  # no kernel on the CPU
    assert got[0] is None and want[0] is None
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


def test_backward_smem_fits_the_flagship_calls():
    """Both flagship calls at batch 16 fit the backward kernels' shared
    memory: the MVFex call without d_feat (the adjoint kernel alone, within
    the 48 KB a block takes without opt-in) and the pose3d call with it (a
    128-cell band tile and the 64 g_feat rows; two blocks fit an SM's
    228 KB, 1 KB of it reserved per block)."""
    adjoint, dfeat = _bwd_smem_bytes(4096, 15, 4, 16, 128, 256, False, 2)
    assert adjoint <= 48 * 1024 and dfeat == 0
    adjoint, dfeat = _bwd_smem_bytes(4096, 16, 4, 16, 128, 0, True, 2)
    assert adjoint <= 48 * 1024 and 2 * (dfeat + 1024) <= 228 * 1024
    adjoint, dfeat = _bwd_smem_bytes(4096, 15, 4, 16, 128, 256, True, 4)
    assert max(adjoint, dfeat) <= 227 * 1024
    feat = torch.zeros(4, 4096, 128)
    loc, w = torch.zeros(4, 16, 4, 16, 2), torch.zeros(4, 16, 4, 16)
    g = torch.zeros(4, 16, 4, 128), torch.zeros(4, 16, 4, 1)
    _check_backward_inputs(feat, loc, w, None, g[0], None, g[1], need_feat=True)
    pos = torch.zeros(4, 4096, 256)
    loc, w = loc[:, :15].contiguous(), w[:, :15].contiguous()
    _check_backward_inputs(feat, loc, w, pos, g[0][:, :15].contiguous(),
                           torch.zeros(4, 15, 4, 256), g[1][:, :15].contiguous(),
                           need_feat=False)


@pytest.mark.parametrize("case", ["wide_feat", "many_rows", "wide_heads"])
def test_backward_smem_check_refuses_before_any_launch(case):
    """What exceeds a block's shared memory raises in the wrapper, on any
    device, before a kernel is built or launched: g_feat rows too wide for
    the d_feat kernel (accepted when d_feat is not wanted), too many points
    for its list, upstream-gradient rows of all heads too wide for the
    adjoint kernel."""
    B, HW, Q, nh, P, Cin = 2, 256, 15, 4, 16, 1024
    if case == "many_rows":
        Q, Cin = 240, 64
    elif case == "wide_heads":
        nh, Cin = 8, 8192
    feat = torch.zeros(B, HW, Cin)
    loc, w = torch.zeros(B, Q, nh, P, 2), torch.zeros(B, Q, nh, P)
    g_feat, g_one = torch.zeros(B, Q, nh, Cin), torch.zeros(B, Q, nh, 1)
    before = lazy_deform_sample_backward.launches
    with pytest.raises(ValueError):
        _backward_kernel(feat, loc, w, None, False, g_feat, None, g_one,
                         True, True)
    assert lazy_deform_sample_backward.launches == before
    if case != "wide_heads":  # without d_feat only the adjoint kernel runs
        _check_backward_inputs(feat, loc, w, None, g_feat, None, g_one,
                               need_feat=False)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_mode", ["none", "interleaved", "block",
                                      "block_c52_h20", "rings"])
def test_backward_kernel_matches_plain_on_card(pos_mode):
    """The backward kernels vs their plain version, fp32 (1e-4 of each
    gradient's largest value: sums in another order, atomics in a varying
    order) and bf16 (the plain version in fp32 on the same bf16 inputs, 1e-2
    of scale: one bf16 rounding of d_feat and d_pos), with and without
    d_feat. ``block_c52_h20``: 52 + 36 channels (neither a multiple of 32
    lanes nor of a float4 per lane), a 20x20 grid whose last d_feat band is
    partial, and 960 points per batch element (not a multiple of the
    d_feat kernel's 512 threads); ``rings``: the points on the model's rays
    (:func:`_ring_loc`), so corner cells repeat within a block.
    ``chip_smoke.py`` does the same at the flagship shapes, with the
    locations of the flagship's own forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if pos_mode == "block_c52_h20":
        feat, loc, w, pos, block = _case("block", Cin=52, C=36, H=20)
    elif pos_mode == "rings":
        feat, loc, w, pos, block = _case("block", rings=True)
    else:
        feat, loc, w, pos, block = _case(pos_mode)
    feat_t, loc_t, w_t, pos_t = _tensors(feat, loc, w, pos)
    grads = _grads(feat_t, pos_t)
    for dtype in (torch.float32, torch.bfloat16):
        c = lambda x: None if x is None else x.cuda().to(dtype)  # noqa: E731
        f = lambda x: None if x is None else c(x).float().cpu()  # noqa: E731
        for need_feat in (True, False):
            want = lazy_deform_sample_backward_plain(
                f(feat_t), loc_t, w_t, f(pos_t), block, *map(f, grads),
                need_feat=need_feat)
            before = lazy_deform_sample_backward.launches
            got = lazy_deform_sample_backward(
                c(feat_t), loc_t.cuda(), w_t.cuda(), c(pos_t), block,
                *map(c, grads), need_feat=need_feat)
            torch.cuda.synchronize()
            assert lazy_deform_sample_backward.launches == before + 1
            rtol = 1e-4 if dtype == torch.float32 else 1e-2
            for g, ww in zip(got, want):
                if ww is None:
                    assert g is None
                    continue
                assert g.is_cuda
                scale = float(ww.abs().max())
                torch.testing.assert_close(g.float().cpu(), ww, atol=rtol * scale,
                                           rtol=0)


def test_profile_counts_every_kernel_of_a_source_once():
    """``chip_smoke.kernel_time`` sums each csrc source's __global__
    functions as the profiler names them: both kernels of the lazy backward
    under its key and neither under the lazy forward's; the per-head
    forward's key takes neither lazy kernel nor its own backward."""
    import chip_smoke

    class Event:
        def __init__(self, key, us):
            self.key, self.self_device_time_total = key, us

    ns = "void (anonymous namespace)::"
    events = [Event(f"{ns}lazy_deform_sample_kernel<float>(float const*)", 1),
              Event(f"{ns}lazy_deform_sample_bwd_adjoint_kernel<__nv_bfloat16>()", 10),
              Event(f"{ns}lazy_deform_sample_bwd_dfeat_kernel<__nv_bfloat16>()", 100),
              Event(f"{ns}deform_sample_kernel<float>(float const*)", 1000),
              Event(f"{ns}deform_sample_bwd_kernel<float>(float const*)", 10000),
              Event("void at::native::elementwise_kernel<128, 4>()", 1e5)]
    assert {n: chip_smoke.kernel_time(events, n) for n in chip_smoke.KERNELS} == {
        "lazy_deform_sample": 1, "lazy_deform_sample_bwd": 110,
        "deform_sample": 1000, "deform_sample_bwd": 10000}


@pytest.mark.cuda
def test_backward_d_feat_is_bitwise_reproducible_on_card():
    """d_feat (and d_loc, d_attn_w) come out bitwise equal from two runs on
    the same inputs, with the points on the model's rays, where many
    corners share a cell: each cell of d_feat is summed by one thread in a
    fixed order.
    Each call of the wrapper counts one launch."""
    _needs_card()
    feat, loc, w, pos, block = _case("block", rings=True)
    feat_t, loc_t, w_t, pos_t = _tensors(feat, loc, w, pos)
    grads = _grads(feat_t, pos_t)
    for dtype in (torch.float32, torch.bfloat16):
        c = lambda x: None if x is None else x.cuda().to(dtype)  # noqa: E731
        args = (c(feat_t), loc_t.cuda(), w_t.cuda(), c(pos_t), block,
                *map(c, grads))
        before = lazy_deform_sample_backward.launches
        first = lazy_deform_sample_backward(*args)
        second = lazy_deform_sample_backward(*args)
        torch.cuda.synchronize()
        assert lazy_deform_sample_backward.launches == before + 2
        for a, b in zip(first[:3], second[:3]):
            assert torch.equal(a, b)
        assert first[0].dtype == dtype and first[0].shape == feat_t.shape


# -- per-head deformable sampling (the reference order) ----------------------------


def _msda_case(ch: int = 64, seed: int = 4, H: int = 16, locs: str = "uniform",
               P: int = 16):
    """value (2, H, H, 4, ch), Q=15, P points, weights normalised over the
    points, an upstream gradient of the output, and locations in [-0.3, 1.3]
    (corners off every side), or with ``locs="one_cell"`` every point of a
    batch element at one spot (each (cell, head) slice of its 4 corners
    takes all Q * P = 240 points of its head), or with ``"out_of_grid"``
    every point a cell or more outside the grid."""
    rng = np.random.default_rng(seed)
    B, Q, nh = 2, 15, 4
    value = rng.normal(size=(B, H, H, nh, ch)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(B, Q, nh, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, nh, P)).astype(np.float32)
    w /= w.sum(axis=-1, keepdims=True)
    g = rng.normal(size=(B, Q, nh * ch)).astype(np.float32)
    if locs == "one_cell":
        spot = np.array([[0.37, 0.52], [0.71, 0.18]], dtype=np.float32)
        loc = np.broadcast_to(spot[:, None, None, None], loc.shape).copy()
    elif locs == "out_of_grid":
        side = np.where(loc > 0.5, 1.1, -0.1).astype(np.float32)
        loc = side + (loc - 0.5) * 0.01
    return [torch.from_numpy(x) for x in (value, loc, w, g)]


@pytest.mark.parametrize("ch", [64, 32, 13])
def test_sampling_check_accepts_the_flagship_layout(ch):
    value, loc, w, g = _msda_case(ch)
    _check_sampling_inputs(value, loc, w)
    _check_sampling_inputs(value.bfloat16(), loc, w)
    _check_sampling_backward_inputs(value, loc, w, g)
    _check_sampling_backward_inputs(value.bfloat16(), loc, w, g.bfloat16())


@pytest.mark.parametrize("fault", [
    "half", "value_rank", "loc_shape", "heads", "batch", "strided_value",
    "too_many_points",
])
def test_sampling_check_refuses_what_the_kernel_cannot_take(fault):
    value, loc, w, _ = _msda_case()
    if fault == "half":
        value = value.half()
    elif fault == "value_rank":
        value = value.reshape(2, 256, 4, 64)
    elif fault == "loc_shape":
        loc = loc[:, :, :, :8]
    elif fault == "heads":
        value = value.reshape(2, 16, 16, 8, 32)
    elif fault == "batch":
        value = torch.cat([value, value])
    elif fault == "strided_value":
        value = value.transpose(1, 2)
    elif fault == "too_many_points":
        loc = loc.repeat(1, 1, 1, 128, 1)
        w = w.repeat(1, 1, 1, 128)
    with pytest.raises((TypeError, ValueError)):
        _check_sampling_inputs(value, loc, w)


@pytest.mark.parametrize("fault", [
    "g_shape", "g_missing", "g_dtype", "g_misaligned", "g_strided",
    "too_many_channels", "value_fault",
])
def test_sampling_backward_check_refuses_what_the_kernel_cannot_take(fault):
    value, loc, w, g = _msda_case()
    if fault == "g_shape":
        g = g[..., :128]
    elif fault == "g_missing":
        g = None
    elif fault == "g_dtype":
        g = g.bfloat16()
    elif fault == "g_misaligned":
        g = _misaligned(g)
    elif fault == "g_strided":
        g = torch.cat([g, g], -1)[..., ::2]
    elif fault == "too_many_channels":  # upstream rows exceed shared memory
        value = torch.zeros(2, 4, 4, 4, 4096)
        g = torch.zeros(2, 15, 4 * 4096)
    elif fault == "value_fault":  # the forward's checks apply too
        value = value.half()
    with pytest.raises((TypeError, ValueError)):
        _check_sampling_backward_inputs(value, loc, w, g)


def test_vector_width_follows_channels_and_alignment():
    """16-byte loads where every head slice starts on a 16-byte boundary
    (4 fp32, 8 bf16 channels), else 8-byte bf16 loads (ch = 36, 4 mod 8),
    else one channel (ch = 13, or a base 4 or 2 bytes off)."""
    value = _msda_case(64)[0]
    assert _vector_width(value) == 4 and _vector_width(value.bfloat16()) == 8
    assert _vector_width(_msda_case(36)[0]) == 4
    assert _vector_width(_msda_case(36)[0].bfloat16()) == 4
    assert _vector_width(_msda_case(13)[0]) == 1
    assert _vector_width(_misaligned(value)) == 1  # base 4 bytes off
    assert _vector_width(_misaligned(value.bfloat16())) == 1  # base 2 bytes off


def test_sampling_fwd_smem_fits_the_flagship_calls():
    """The per-head forward kernel's shared memory is sized in one place,
    ``_sampling_fwd_smem_bytes``: the flagship calls (P = 16) take 2 KB a
    block, within the 48 KB a block takes without opt-in, and the check
    accepts them at batch 16 (MVFex ch = 64, Q = 15; pose3d ch = 32, Q = 16;
    the head-shared form one map of 128 channels and 4 x 16 folded
    queries)."""
    assert _sampling_fwd_smem_bytes(16) == 2048
    for nh, ch, Q in ((4, 64, 15), (4, 32, 16), (1, 128, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            value = torch.zeros(64, 64, 64, nh, ch, dtype=dtype)
            loc, w = torch.zeros(64, Q, nh, 16, 2), torch.zeros(64, Q, nh, 16)
            _check_sampling_inputs(value, loc, w)


@pytest.mark.parametrize("P", [512, 2048])
def test_sampling_fwd_smem_check_refuses_before_any_launch(P):
    """A call whose corner lists exceed a block's shared memory raises in the
    wrapper, on any device, before the kernel is built or launched. Lists
    above 48 KB and within the opt-in limit are accepted (the kernel opts
    in): P = 512 needs 64 KB, P = 2048 more than a block can take."""
    value, loc, w, _ = _msda_case(P=P)
    assert _sampling_fwd_smem_bytes(P) > 48 * 1024
    if P == 512:
        _check_sampling_inputs(value, loc, w)
        return
    before = deformable_sampling.launches
    with pytest.raises(ValueError, match="shared memory"):
        _sampling_kernel(value, loc, w)
    assert deformable_sampling.launches == before


def test_sampling_backward_smem_fits_the_flagship_calls():
    """The d_value kernel's shared memory is sized in one place,
    ``_sampling_bwd_layout``: at both flagship calls (batch 16, 64x64 grid,
    4 heads, P = 16; MVFex ch = 64, Q = 15; pose3d ch = 32, Q = 16) a block
    owns 256 or 512 cells (four 64 KB rows of fp32 cells), its 32 KB tile
    holds 128 or 256 slices (a multiple of the 16 warps), two blocks fit
    an SM's 228 KB (1 KB of it reserved per block) in fp32 and bf16, and
    the check accepts the calls."""
    for ch, Q, span_cells, slots in ((64, 15, 256, 128), (32, 16, 512, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            span, cap, smem = _sampling_bwd_layout(4096, Q, 4, ch, 16, dtype.itemsize)
            assert (span, cap) == (span_cells, slots)
            assert 48 * 1024 < smem and 2 * (smem + 1024) <= 228 * 1024
            value = torch.zeros(64, 64, 64, 4, ch, dtype=dtype)
            loc, w = torch.zeros(64, Q, 4, 16, 2), torch.zeros(64, Q, 4, 16)
            g = torch.zeros(64, Q, 4 * ch, dtype=dtype)
            _check_sampling_backward_inputs(value, loc, w, g)
    # A grid smaller than a span: one block of every cell; tile slots are a
    # multiple of 16 for any channel count.
    assert _sampling_bwd_layout(15 * 15, 15, 4, 64, 16, 2)[0] == 225
    assert _sampling_bwd_layout(16 * 16, 15, 4, 13, 16, 2)[1] == 624


@pytest.mark.parametrize("case", ["wide_rows", "many_points"])
def test_sampling_backward_smem_check_refuses_before_any_launch(case):
    """A call whose d_value kernel would need more shared memory than a
    block takes after opt-in raises in the wrapper, on any device, before a
    kernel is built or launched: upstream-gradient rows too wide to stage
    (nh * ch = 8192 channels of 15 queries), or too many points for the
    corner list (Q = 2000). Without d_value only the adjoint kernel runs,
    which takes no shared memory, and the check accepts both."""
    B, H, Q, nh, ch, P = 2, 4, 15, 4, 2048, 16
    if case == "many_points":
        Q, ch = 2000, 8
    value = torch.zeros(B, H, H, nh, ch)
    loc, w = torch.zeros(B, Q, nh, P, 2), torch.zeros(B, Q, nh, P)
    g = torch.zeros(B, Q, nh * ch)
    assert _sampling_bwd_layout(H * H, Q, nh, ch, P, 4)[2] > 232448
    before = deformable_sampling_backward.launches
    with pytest.raises(ValueError, match="shared memory"):
        _sampling_backward_kernel(value, loc, w, g, True)
    assert deformable_sampling_backward.launches == before
    _check_sampling_backward_inputs(value, loc, w, g, need_value=False)


def test_sampling_kernel_wrappers_raise_before_any_launch():
    """The kernel wrappers check first: what the kernels cannot take raises
    and is never handed to the plain versions."""
    value, loc, w, g = _msda_case()
    before = (deformable_sampling.launches, deformable_sampling_backward.launches)
    with pytest.raises(TypeError):
        _sampling_kernel(value.half(), loc, w)
    with pytest.raises(ValueError):
        _sampling_kernel(value.transpose(1, 2), loc, w)
    with pytest.raises(TypeError):
        _sampling_backward_kernel(value, loc, w, g.bfloat16(), True)
    assert (deformable_sampling.launches,
            deformable_sampling_backward.launches) == before


@pytest.mark.parametrize("name", ["lazy_deform_sample", "lazy_deform_sample_bwd",
                                  "deform_sample", "deform_sample_bwd"])
def test_wrappers_pass_what_the_entry_points_declare(monkeypatch, name):
    """Each kernel wrapper hands its C entry point as many arguments as the
    source declares, and declares as many ``argtypes``: the library is
    replaced by a stand-in that records the call (CPU tensors; nothing is
    built or launched)."""
    import contextlib
    import re
    from pathlib import Path

    from egorear_tpu_torch import kernels
    from egorear_tpu_torch.ops import deform_attn as da

    src = (Path(kernels.CSRC) / f"{name}.cu").read_text()
    decl = re.search(r'extern "C" int (\w+)\(([^)]*)\)', src)
    n_params = len(decl.group(2).split(","))
    calls = []

    def entry(*args):
        calls.append((len(args), len(entry.argtypes)))
        return 0

    monkeypatch.setattr(kernels, "load", lambda _: type("Lib", (), {decl.group(1): entry}))
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _: type("Stream", (), {"cuda_stream": 0}))
    if name.startswith("lazy"):
        feat, loc, w, pos, block = _tensors(*_case("block")[:4]) + [True]
        if name == "lazy_deform_sample":
            da._forward_kernel(feat, loc, w, pos, block)
        else:
            da._backward_kernel(feat, loc, w, pos, block, *_grads(feat, pos), True, True)
    else:
        value, loc, w, g = _msda_case()
        if name == "deform_sample":
            da._sampling_kernel(value, loc, w)
        else:
            da._sampling_backward_kernel(value, loc, w, g, True)
    assert calls == [(n_params, n_params)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _msda_card_case(case: str):
    """``_msda_case`` by name: ``ch64``, ``ch32``, ``ch13`` (no vector width
    divides it: the scalar paths), ``ch36`` (4 mod 8: the forward's 8-byte
    bf16 loads), ``ch64_misaligned`` (value's base 4 bytes off: the scalar
    loads), ``one_cell`` (the longest per-slice sum), ``h24`` (a 24x24
    grid: 576 cells, two full 256-cell blocks of d_value and a partial one),
    ``out_of_grid`` (every output and gradient exactly zero) and ``p9`` (9
    points: a row's 36 corners take two ballots, the second partial). With
    uniform locations a block touches several times the 128 slices its
    tile holds, so it sums them in rounds."""
    if case in ("one_cell", "out_of_grid"):
        return _msda_case(locs=case)
    if case == "h24":
        return _msda_case(H=24)
    if case == "p9":
        return _msda_case(P=9)
    return _msda_case(int(case[2:4]))


MSDA_CARD_CASES = ["ch64", "ch32", "ch13", "ch36", "ch64_misaligned", "one_cell",
                   "h24", "out_of_grid", "p9"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MSDA_CARD_CASES)
def test_sampling_kernels_match_plain_on_card(case):
    """Both kernels vs their plain versions: forward fp32 1e-5 of the
    largest output (sums in another order), bf16 1e-2 of it (the plain
    version in fp32 on the same bf16 inputs: one bf16 rounding of each
    output); backward fp32 1e-4 of each gradient's largest value (sums in
    another order), bf16 1e-2 (one bf16 rounding of d_value), with and
    without d_value (:func:`_msda_card_case`). The wrapper allocates
    d_value and never zeroes it: with every corner out of the grid, every
    output is exactly zero. ``chip_smoke.py`` does the same at the flagship
    shapes."""
    _needs_card()
    value, loc, w, g = _msda_card_case(case)
    for dtype in (torch.float32, torch.bfloat16):
        v = value.cuda().to(dtype)
        if case.endswith("misaligned"):
            v = _misaligned(v)
        gc = g.cuda().to(dtype)
        args = (v, loc.cuda(), w.cuda())
        want = deformable_sampling_plain(v.float().cpu(), loc, w)
        before = deformable_sampling.launches
        got = deformable_sampling(*args)
        torch.cuda.synchronize()
        assert deformable_sampling.launches == before + 1
        assert got.dtype == dtype and got.is_cuda
        tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(want.abs().max())
        torch.testing.assert_close(got.float().cpu(), want, atol=tol, rtol=0)
        for need_value in (True, False):
            want = deformable_sampling_backward_plain(
                v.float().cpu(), loc, w, gc.float().cpu(), need_value)
            before = deformable_sampling_backward.launches
            got = deformable_sampling_backward(*args, gc, need_value)
            torch.cuda.synchronize()
            assert deformable_sampling_backward.launches == before + 1
            rtol = 1e-4 if dtype == torch.float32 else 1e-2
            for a, b in zip(got, want):
                if b is None:
                    assert a is None
                    continue
                assert a.is_cuda and a.shape == b.shape
                if case == "out_of_grid":
                    assert not bool(a.any()) and not bool(b.any())
                scale = float(b.abs().max())
                torch.testing.assert_close(a.float().cpu(), b.float(),
                                           atol=rtol * scale, rtol=0)
            if need_value:
                assert got[0].dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ch64", "one_cell", "ch13", "h24"])
def test_sampling_backward_is_bitwise_reproducible_on_card(case):
    """Two runs of the backward kernels on the same inputs give bitwise
    equal d_value, d_loc and d_attn_w (no atomics: each slice of d_value is
    summed by one warp in list order, each corner adjoint by a fixed shuffle
    tree), in fp32 and bf16, with every point of a batch element on one
    cell too; each call counts one launch."""
    _needs_card()
    value, loc, w, g = _msda_card_case(case)
    for dtype in (torch.float32, torch.bfloat16):
        args = (value.cuda().to(dtype), loc.cuda(), w.cuda(), g.cuda().to(dtype))
        before = deformable_sampling_backward.launches
        first = deformable_sampling_backward(*args)
        second = deformable_sampling_backward(*args)
        torch.cuda.synchronize()
        assert deformable_sampling_backward.launches == before + 2
        for a, b in zip(first, second):
            assert torch.equal(a, b)
        assert first[0].dtype == dtype and first[0].shape == value.shape


@pytest.mark.cuda
@pytest.mark.parametrize("case", MSDA_CARD_CASES + ["p512"])
def test_sampling_forward_is_bitwise_reproducible_on_card(case):
    """Two runs of the forward kernel on the same inputs give bitwise equal
    outputs (no atomics: a warp sums its row's corner list in list order,
    its lane groups meet in a fixed shuffle tree), in fp32 and bf16; each
    call counts one launch. ``p512`` (512 points: 64 KB of corner lists a
    block, so the kernel opts in above 48 KB of shared memory), which the
    backward cannot take, is held against the plain version here too."""
    _needs_card()
    value, loc, w, _ = _msda_case(P=512) if case == "p512" else _msda_card_case(case)
    for dtype in (torch.float32, torch.bfloat16):
        v = value.cuda().to(dtype)
        if case.endswith("misaligned"):
            v = _misaligned(v)
        before = deformable_sampling.launches
        first = deformable_sampling(v, loc.cuda(), w.cuda())
        second = deformable_sampling(v, loc.cuda(), w.cuda())
        torch.cuda.synchronize()
        assert deformable_sampling.launches == before + 2
        assert torch.equal(first, second) and first.dtype == dtype
        if case == "out_of_grid":
            assert not bool(first.any())
        if case == "p512":
            want = deformable_sampling_plain(v.float().cpu(), loc, w)
            tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(want.abs().max())
            torch.testing.assert_close(first.float().cpu(), want, atol=tol, rtol=0)


def _fp64_sum(value, loc, w):
    """The per-head forward on the CPU with the kernel's fp32 corner weights
    (x = loc_x * W - 0.5 rounded as the kernel rounds it, then (1 - lx | lx)
    * (1 - ly | ly) * attn_w, each operation in fp32) summed in fp64, and
    the sum of the terms' magnitudes, both (B, Q, nh * ch) in fp64."""
    B, H, W, nh, ch = value.shape
    Q, P = w.shape[1], w.shape[3]
    x = loc[..., 0].float() * float(W) - 0.5
    y = loc[..., 1].float() * float(H) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    rows = value.double().reshape(B, H * W, nh, ch)
    b = torch.arange(B).view(B, 1, 1, 1)
    h = torch.arange(nh).view(1, 1, nh, 1)
    out = torch.zeros(B, Q, nh, ch, dtype=torch.float64)
    mag = torch.zeros_like(out)
    for dy in (0, 1):
        for dx in (0, 1):
            xc, yc = x0 + dx, y0 + dy
            ok = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            wt = ((lx if dx else 1.0 - lx) * (ly if dy else 1.0 - ly)) * w.float()
            wt = torch.where(ok, wt, 0.0).double()
            cell = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            terms = wt[..., None] * rows[b, cell, h]
            out += terms.sum(3)
            mag += terms.abs().sum(3)
    return out.reshape(B, Q, nh * ch), mag.reshape(B, Q, nh * ch)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ch64", "ch13", "one_cell", "p9"])
def test_sampling_forward_fp32_is_within_its_rounding_bound_on_card(case):
    """On an fp32 map the kernel sums fp32 corner weights times fp32 values
    in fp32. Its weights are those of :func:`_fp64_sum`, operation for
    operation, and each product of two fp32 numbers is exact in fp64, so
    the fp64 sum differs from the exact one by ~1e-16 relative. In the
    kernel every term passes through at most n fmas of its lane group (n <=
    4 P, the row's corners) and 5 additions of the shuffle tree, each
    rounding by at most u = 2^-24 relative, so whatever order it takes

        |out - sum| <= gamma_(n + 5) sum |w_k v_k|,  gamma_m = m u / (1 - m u),

    Higham's bound for a recursive sum of n terms."""
    _needs_card()
    value, loc, w, _ = _msda_card_case(case)
    got = deformable_sampling(value.cuda(), loc.cuda(), w.cuda())
    torch.cuda.synchronize()
    want, mag = _fp64_sum(value, loc, w)
    m = 4 * w.shape[3] + 5
    gamma = m * 2.0 ** -24 / (1 - m * 2.0 ** -24)
    err = (got.cpu().double() - want).abs()
    assert bool((err <= gamma * mag).all()), f"largest share of the bound " \
        f"{float((err / (gamma * mag).clamp_min(1e-300)).max()):.3f}"


@pytest.mark.cuda
def test_sampling_shared_form_is_bitwise_reproducible_on_card():
    """The head-shared form at the width of the flagship's raw memory (one
    map of 128 channels, 4 heads folded into the queries; bf16 reads a slice
    in 16 lanes of 16 bytes, fp32 in 32) vs its plain version, fp32 1e-5
    and bf16 1e-2 of the largest output, and bitwise equal over two runs."""
    _needs_card()
    _, loc, w, _ = _msda_case()
    vs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 16, 16, 128)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        v = vs.cuda().to(dtype)
        first = deformable_sampling_shared(v, loc.cuda(), w.cuda())
        second = deformable_sampling_shared(v, loc.cuda(), w.cuda())
        torch.cuda.synchronize()
        assert torch.equal(first, second) and first.dtype == dtype
        want = deformable_sampling_shared(v.float().cpu(), loc, w)
        tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(want.abs().max())
        torch.testing.assert_close(first.float().cpu(), want, atol=tol, rtol=0)


@pytest.mark.cuda
def test_sampling_shared_form_and_autograd_on_card():
    """The head-shared form (Cs = 13) on the card goes through both kernels,
    and its autograd gradients agree with the plain versions'."""
    _needs_card()
    _, loc, w, _ = _msda_case()
    vs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, 16, 13)).astype(np.float32))
    ins = [x.cuda().requires_grad_() for x in (vs, loc, w)]
    ref = [x.detach().clone().requires_grad_() for x in (vs, loc, w)]
    fwd0, bwd0 = deformable_sampling.launches, deformable_sampling_backward.launches
    got = deformable_sampling_shared(*ins)
    want = deformable_sampling_shared(*ref)
    got.square().sum().backward()
    want.square().sum().backward()
    torch.cuda.synchronize()
    assert (deformable_sampling.launches - fwd0,
            deformable_sampling_backward.launches - bwd0) == (1, 1)
    torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-5, rtol=0)
    for a, b in zip(ins, ref):
        scale = float(b.grad.abs().max())
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
def test_sampling_on_card_raises_instead_of_falling_back():
    """A CUDA tensor the kernels cannot take raises; only ``plain=True``
    reaches the plain version on the card, and it launches nothing."""
    _needs_card()
    value, loc, w, _ = [x.cuda() for x in _msda_case()]
    before = deformable_sampling.launches
    with pytest.raises(TypeError):
        deformable_sampling(value.half(), loc, w)
    with pytest.raises(ValueError):
        deformable_sampling(value.transpose(1, 2), loc, w)
    out = deformable_sampling(value, loc, w, plain=True)
    assert out.is_cuda and deformable_sampling.launches == before


# -- stages 1 and 2 on the card --------------------------------------------------


def _stage2_batch(B, size, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return {"img": torch.randn(B, 4, 3, size, size, generator=g, device=device),
            "gt_heatmap": torch.rand(B, 4, 15, size // 4, size // 4, generator=g,
                                     device=device)}


@pytest.mark.cuda
def test_stage2_train_step_launches_the_lazy_kernels_on_card():
    """One stage-2 step (64 px, b2, fp32) launches the lazy forward once per
    refiner and its backward (no ``d_feat``: the refiners sample detached
    features) once per refiner; the per-head kernels never."""
    _needs_card()
    from egorear_tpu_torch import entry

    task, trainer = entry.build_stage2((64, 64), steps_per_epoch=10,
                                       imagenet=False)
    counters = (lazy_deform_sample, lazy_deform_sample_backward,
                deformable_sampling, deformable_sampling_backward)
    for fn in counters:
        fn.launches = 0
    metrics = trainer.train_step(_stage2_batch(2, 64, "cuda"))
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [4, 4, 0, 0]
    assert bool(torch.isfinite(metrics["loss_total"]))
    assert next(task.model.parameters()).is_cuda


@pytest.mark.cuda
def test_checkpoint_of_a_cuda_trainer_round_trips_bitwise(tmp_path):
    _needs_card()
    from egorear_tpu_torch import entry
    from egorear_tpu_torch.train import checkpoint

    task, trainer = entry.build_stage1(steps_per_epoch=10, imagenet=False)
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"img": torch.randn(2, 2, 3, 64, 64, generator=g, device="cuda"),
             "gt_heatmap": torch.rand(2, 2, 15, 16, 16, generator=g, device="cuda")}
    trainer.train_step(batch)
    path = checkpoint.save(str(tmp_path), 1, trainer.state_dict())
    task2, trainer2 = entry.build_stage1(seed=1, steps_per_epoch=10, imagenet=False)
    trainer2.load_state_dict(checkpoint.restore(path, map_location="cuda"))
    assert trainer2.step == trainer.step == 1
    for a, b in ((task.model.state_dict(), task2.model.state_dict()),):
        for k in a:
            assert b[k].is_cuda and torch.equal(a[k], b[k]), k
    sa, sb = trainer.optimizer.state_dict(), trainer2.optimizer.state_dict()
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    # The next step of both, bitwise: cuDNN's deterministic algorithms
    # (its default weight-gradient algorithms sum in a varying order).
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainer.train_step(batch)
        trainer2.train_step(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k, v in task.model.state_dict().items():
        assert torch.equal(v, task2.model.state_dict()[k]), k


@pytest.mark.cuda
def test_imagenet_graft_lands_in_the_model_dtype_on_card():
    """The graft copies into a bf16 model on the card in place: each leaf
    keeps its dtype and device and holds the weight rounded once to bf16."""
    _needs_card()
    from egorear_tpu_torch.models.backbone import ResNet18
    from egorear_tpu_torch.models.heatmap_net import HeatmapNet
    from egorear_tpu_torch.train.imagenet import (
        convert_torchvision_resnet18,
        graft_imagenet_backbones,
    )

    gen = torch.Generator().manual_seed(3)
    tv = {}
    for k, v in ResNet18().state_dict().items():
        if "num_batches" in k:
            continue
        k = (k.replace("downsample_conv", "downsample.0")
              .replace("downsample_bn", "downsample.1"))
        k = re.sub(r"^layer(\d)_(\d)\.", r"layer\1.\2.", k)
        tv[k] = torch.randn(v.shape, generator=gen)
    weights = convert_torchvision_resnet18(tv)
    model = HeatmapNet(num_heatmap=15).cuda().to(torch.bfloat16)
    before = [id(p) for p in model.parameters()]
    fpn = {k: v.clone() for k, v in model.encoder.fpn.state_dict().items()}
    assert graft_imagenet_backbones(model, weights) == 1
    assert [id(p) for p in model.parameters()] == before
    for k, v in model.encoder.resnet.state_dict().items():
        if "num_batches" in k:
            continue
        assert v.is_cuda and v.dtype == torch.bfloat16, k
        assert torch.equal(v, weights[k].to("cuda", torch.bfloat16)), k
    for k, v in model.encoder.fpn.state_dict().items():
        assert torch.equal(v, fpn[k]), k


@pytest.mark.cuda
def test_loader_moves_batches_to_the_card_pinned(monkeypatch):
    """``DataLoader(device="cuda")``: every array field on the card and
    equal to its host batch, each through pinned host memory; lists and
    ``__valid_n__`` stay on the host."""
    _needs_card()
    pinned = []
    pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self, *a: pinned.append(1) or pin(self, *a))
    from egorear_tpu_torch.data.loader import DataLoader

    class Samples:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"x": np.full((3, 4), i, np.float32), "i": np.array(i),
                    "frame_path": f"f{i}"}

    host = list(DataLoader(Samples(), 2, pad_last=True))
    card = list(DataLoader(Samples(), 2, pad_last=True, device="cuda"))
    assert [b["__valid_n__"] for b in card] == [2, 2, 1]
    for h, c in zip(host, card):
        for k in ("x", "i"):
            assert c[k].is_cuda and torch.equal(c[k].cpu(), h[k]), k
        assert c["frame_path"] == h["frame_path"]
    assert len(pinned) == 2 * len(card)


@pytest.mark.cuda
def test_stage2_fit_through_the_cli_launches_the_lazy_kernels_on_card(tmp_path):
    """``run.main fit`` on the stage-2 yaml (full width, b2, one epoch of
    one step, no stage-1 grafts, random backbones): 4 + 4 lazy launches for
    the step and 4 for the one validation batch; the per-head kernels
    never."""
    _needs_card()
    from egorear_tpu_torch import run
    from egorear_tpu_torch.data.synthetic import make_synthetic_dataset

    root = make_synthetic_dataset(str(tmp_path / "data"), frames_per_seq=2,
                                  eval_frames_per_seq=1, image_size=96,
                                  write_heatmaps=True, seed=4)
    counters = (lazy_deform_sample, lazy_deform_sample_backward,
                deformable_sampling, deformable_sampling_backward)
    for fn in counters:
        fn.launches = 0
    config = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                          "ego4view_syn_heatmap_mvfex-n1_jqa.yaml")
    trainer = run.main([
        "fit", "--config", config,
        "--model.data_root", root, "--model.batch_size", "2",
        "--model.workers", "2", "--trainer.max_epochs", "1",
        "--trainer.save_dir", str(tmp_path / "logs"),
        "--model.heatmap_estimator_pretrained_stereo_front", "",
        "--model.heatmap_estimator_pretrained_stereo_back", "",
        "--model.model_cfg.encoder_cfg.resnet_cfg.use_imagenet_pretrain", "false"])
    torch.cuda.synchronize()
    assert trainer.step == 1 and trainer.device.type == "cuda"
    assert [fn.launches for fn in counters] == [4 + 4, 4, 0, 0]


# -- the stereo-pair and real-world rigs on the card -------------------------------


@pytest.mark.cuda
def test_rw_projection_ignores_tf32_on_card():
    """``apply_se3`` sums fp32 products, no matmul: on the card the
    real-world projection is bitwise the same with TF32 matmuls on and off,
    and within fp32 rounding of the CPU's."""
    _needs_card()
    from egorear_tpu_torch.ops.camera import CameraRig, apply_se3

    g = torch.Generator().manual_seed(3)
    mats = torch.eye(4).repeat(8, 4, 1, 1)
    mats[..., :3, :3] += 0.2 * torch.randn(8, 4, 3, 3, generator=g)
    mats[..., :3, 3] = 0.05 * torch.randn(8, 4, 3, generator=g)
    pts = torch.randn(8, 16, 3, generator=g) * 30 + torch.tensor([0.0, 18.0, 60.0])
    rig = CameraRig.from_calib_file("ego4view_rw", device="cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        outs = []
        for on in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = on
            outs.append((apply_se3(mats.cuda(), pts.cuda()[:, None]),
                         rig.project(pts.cuda(), mats.cuda())[0]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    cpu = apply_se3(mats, pts[:, None])
    assert float((outs[0][0].cpu() - cpu).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("stage,views,camera_model,want", [
    ("heatmap_mvf_ex", 2, "ego4view_syn_stereo_front", 2),
    ("pose_3d_mvf_ex", 2, "ego4view_syn_stereo_front", 5),
    ("pose_3d_mvf_ex", 4, "ego4view_rw", 7),
])
def test_v2_and_rw_steps_launch_the_lazy_kernels_on_card(stage, views, camera_model,
                                                        want):
    """One train step (64 px, b2, fp32) of the V = 2 stage 2 and stage 3 and
    of the real-world stage 3 (per-sample transforms) launches the lazy
    forward and backward once per refiner and lifting layer: V (+ 3)."""
    _needs_card()
    import copy

    from egorear_tpu_torch import entry
    from egorear_tpu_torch.train.tasks import TASKS
    from egorear_tpu_torch.train.trainer import Trainer

    if stage == "heatmap_mvf_ex":
        cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[64, 64],
                                 num_views=views))
        cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    else:
        cfg = entry.flagship_cfg_dict((64, 64))
        cfg.update(num_views=views, camera_model=camera_model)
    task = TASKS[stage](cfg, device="cuda", dataset_type=(
        "ego4view_rw_pose3d" if "rw" in camera_model else ""))
    trainer = Trainer(task, 1e-5, 5e-3, (8,), 2)
    trainer.init_state(steps_per_epoch=10)
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"img": torch.randn(2, views, 3, 64, 64, generator=g, device="cuda"),
             "gt_heatmap": torch.rand(2, views, 15, 16, 16, generator=g, device="cuda")}
    if stage == "pose_3d_mvf_ex":
        batch["gt_pose"] = torch.randn(2, 16, 3, generator=g, device="cuda") * 30
        batch["coord_trans_mat"] = torch.eye(4, device="cuda").repeat(2, views, 1, 1)
    counters = (lazy_deform_sample, lazy_deform_sample_backward,
                deformable_sampling, deformable_sampling_backward)
    for fn in counters:
        fn.launches = 0
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [want, want, 0, 0]
    assert bool(torch.isfinite(metrics["loss_total"]))
