"""The port's CUDA kernel wrapper: its input checks (on the CPU) and the
kernel against its plain version (on a card).

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
    _check_cuda_inputs,
    lazy_deform_sample,
    lazy_deform_sample_plain,
)


def _case(pos_mode: str, seed: int = 2, Cin: int = 128, C: int = 64):
    """Locations in [-0.3, 1.3] (corners off every side), nh*Q = 60 rows,
    a G=2 pos table in either layout; channels are multiples of 4."""
    rng = np.random.default_rng(seed)
    B, H, Q, nh, P, G = 4, 16, 15, 4, 16, 2
    feat = rng.normal(size=(B, H * H, Cin)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, size=(B, Q, nh, P, 2)).astype(np.float32)
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
