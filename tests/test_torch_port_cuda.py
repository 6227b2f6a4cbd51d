"""The port's CUDA kernel wrappers, forward and backward, of both sampling
ops (lazy and per-head): their input checks (on the CPU) and the kernels
against their plain versions (on a card).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU and nvcc, from
the repository root (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest tests/test_torch_port_cuda.py -q -p no:cacheprovider --noconftest
"""

from __future__ import annotations

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
    _sampling_backward_kernel,
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
          H: int = 16, rings: bool = False):
    """Locations in [-0.3, 1.3] (corners off every side) or on the model's
    rays (:func:`_ring_loc`), nh*Q = 60 rows, a G=2 pos table in either
    layout; channels are multiples of 4."""
    rng = np.random.default_rng(seed)
    B, Q, nh, P, G = 4, 15, 4, 16, 2
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
@pytest.mark.parametrize("pos_mode", ["none", "interleaved", "block"])
def test_kernel_matches_plain_on_card(pos_mode):
    """The CUDA kernel vs its plain version, fp32 (atol 1e-4: sums in
    another order) and bf16 (the plain version in fp32 on the same bf16
    inputs, atol 1e-2 of the largest output: one bf16 rounding of each
    output). ``chip_smoke.py`` does the same at the flagship shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    feat, loc, w, pos, block = _case(pos_mode)
    feat_t, loc_t, w_t, pos_t = _tensors(feat, loc, w, pos)
    for dtype in (torch.float32, torch.bfloat16):
        c = lambda x: None if x is None else x.cuda().to(dtype)  # noqa: E731
        want = lazy_deform_sample_plain(
            c(feat_t).float().cpu(), loc_t, w_t,
            None if pos_t is None else c(pos_t).float().cpu(), block)
        before = lazy_deform_sample.launches
        got = lazy_deform_sample(c(feat_t), loc_t.cuda(), w_t.cuda(), c(pos_t), block)
        torch.cuda.synchronize()
        assert lazy_deform_sample.launches == before + 1
        scale = max(float(x.abs().max()) for x in want if x is not None)
        atol = 1e-4 if dtype == torch.float32 else 1e-2 * scale
        for g, ww in zip(got, want):
            if ww is None:
                assert g is None
                continue
            assert g.dtype == dtype and g.is_cuda
            torch.testing.assert_close(g.float().cpu(), ww, atol=atol, rtol=0)


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


def _msda_case(ch: int = 64, seed: int = 4):
    """value (2, 16, 16, 4, ch), Q=15, P=16, locations in [-0.3, 1.3]
    (corners off every side), weights normalised over the points, and an
    upstream gradient of the output."""
    rng = np.random.default_rng(seed)
    B, H, Q, nh, P = 2, 16, 15, 4, 16
    value = rng.normal(size=(B, H, H, nh, ch)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(B, Q, nh, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, nh, P)).astype(np.float32)
    w /= w.sum(axis=-1, keepdims=True)
    g = rng.normal(size=(B, Q, nh * ch)).astype(np.float32)
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
    value = _msda_case(64)[0]
    assert _vector_width(value) == 4 and _vector_width(value.bfloat16()) == 4
    assert _vector_width(_msda_case(13)[0]) == 1
    assert _vector_width(_misaligned(value)) == 1  # base 4 bytes off


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


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ch64", "ch32", "ch13", "ch64_misaligned"])
def test_sampling_kernels_match_plain_on_card(case):
    """Both kernels vs their plain versions: forward fp32 1e-5 of the
    largest output (sums in another order), bf16 1e-2 of it (the plain
    version in fp32 on the same bf16 inputs: one bf16 rounding of each
    output); backward fp32 1e-4 of each gradient's largest value (atomics in
    a varying order), bf16 1e-2 (one bf16 rounding of d_value), with and
    without d_value. ch=13 and a misaligned base take the scalar path.
    ``chip_smoke.py`` does the same at the flagship shapes."""
    _needs_card()
    ch = int(case[2:4])
    value, loc, w, g = _msda_case(ch)
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
                scale = float(b.abs().max())
                torch.testing.assert_close(a.float().cpu(), b.float(),
                                           atol=rtol * scale, rtol=0)


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
