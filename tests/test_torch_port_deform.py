"""The port's per-head deformable sampling (the reference computation order,
``lazy_deform: false``) held against the JAX package's ``deformable_sampling``
on the same numpy inputs, fp32 on the CPU:

  * the plain forward vs ``_sample_gather``, ``_sample_onehot`` and the
    Pallas kernel ``_make_deform_kernel`` interpreted (``_sample_pallas_vjp``
    under ``pltpu.force_tpu_interpret_mode()``), 1e-5;
  * the plain backward vs ``jax.vjp(_sample_onehot)`` (what
    ``_pallas_bwd_rule`` computes) and ``jax.grad`` through ``_sample_gather``,
    1e-5 of each gradient's largest value;
  * the autograd node vs autograd through the plain forward, and its
    ``needs_input_grad`` handling;
  * the head-shared form vs ``_sample_shared_gather`` and the interpreted
    ``_sample_shared_pallas`` (Cs = 13).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from egorear_tpu.ops.deform_attn import (
    _sample_gather,
    _sample_onehot,
    _sample_pallas_vjp,
    _sample_shared_gather,
    _sample_shared_pallas,
)
from egorear_tpu_torch.ops import deform_attn
from egorear_tpu_torch.ops.deform_attn import (
    DeformableSampling,
    deformable_sampling,
    deformable_sampling_backward,
    deformable_sampling_backward_plain,
    deformable_sampling_plain,
    deformable_sampling_shared,
)

FWD_ATOL = 1e-5  # measured <= 1.8e-7
BWD_RTOL = 1e-5  # of each gradient's largest value; measured <= 1.7e-7


def _case(seed: int = 0):
    """tests/test_ops_deform_attn.py's case: 16x16 grid, nh=4, ch=8, Q=15,
    P=16, locations in [-0.2, 1.2] (in-bounds, border and out of the grid),
    weights normalised over the points."""
    rng = np.random.default_rng(seed)
    B, H, W, nh, ch, Q, P = 2, 16, 16, 4, 8, 15, 16
    value = rng.normal(size=(B, H, W, nh, ch)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, Q, nh, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, Q, nh, P)).astype(np.float32)
    w /= w.sum(axis=-1, keepdims=True)
    return value, loc, w


def _upstream(seed: int = 5):
    return np.random.default_rng(seed).normal(size=(2, 15, 32)).astype(np.float32)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("reference", ["gather", "onehot", "pallas"])
def test_plain_forward_matches_jax(reference):
    value, loc, w = _case()
    if reference == "pallas":
        with pltpu.force_tpu_interpret_mode():
            want = _sample_pallas_vjp(value, loc, w)
    else:
        want = {"gather": _sample_gather, "onehot": _sample_onehot}[reference](
            value, loc, w)
    got = deformable_sampling_plain(*_t(value, loc, w))
    assert got.shape == (2, 15, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def _assert_grads_close(got, want, names=("d_value", "d_loc", "d_attn_w")):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= BWD_RTOL * scale, f"{name}: {err:.3e} > {BWD_RTOL:g} x {scale:.3e}"


@pytest.mark.parametrize("reference", ["onehot_vjp", "gather_grad"])
def test_plain_backward_matches_jax(reference):
    value, loc, w = _case()
    g = _upstream()
    got = [x.numpy() for x in deformable_sampling_backward_plain(*_t(value, loc, w, g))]
    if reference == "onehot_vjp":
        _, vjp = jax.vjp(_sample_onehot, *map(jnp.asarray, (value, loc, w)))
        want = vjp(jnp.asarray(g))
    else:
        want = jax.grad(lambda v, l, a: (_sample_gather(v, l, a) * g).sum(),
                        argnums=(0, 1, 2))(value, loc, w)
    _assert_grads_close(got, want)


def test_autograd_node_matches_autograd_through_plain():
    value, loc, w = _case(seed=3)
    g = torch.from_numpy(_upstream(6))
    ins = [x.requires_grad_() for x in _t(value, loc, w)]
    out = deformable_sampling(*ins)
    assert type(out.grad_fn).__name__ == "DeformableSamplingBackward"
    (out * g).sum().backward()
    got = [x.grad.numpy() for x in ins]
    ref = [x.detach().clone().requires_grad_() for x in ins]
    (deformable_sampling_plain(*ref) * g).sum().backward()
    _assert_grads_close(got, [x.grad.numpy() for x in ref])
    # bf16 locations: sampled in fp32 inside the graph, gradient cast back.
    loc16 = torch.from_numpy(loc).bfloat16().requires_grad_()
    deformable_sampling(torch.from_numpy(value), loc16, torch.from_numpy(w)).sum().backward()
    assert loc16.grad.dtype == torch.bfloat16


def test_wrappers_use_plain_on_cpu():
    value, loc, w = _t(*_case())
    g = torch.from_numpy(_upstream())
    fwd0 = deformable_sampling.launches
    bwd0 = deformable_sampling_backward.launches
    assert torch.equal(deformable_sampling(value, loc, w),
                       deformable_sampling_plain(value, loc, w))
    got = deformable_sampling_backward(value, loc, w, g, need_value=False)
    want = deformable_sampling_backward_plain(value, loc, w, g, need_value=False)
    assert got[0] is None and want[0] is None
    assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
    # No kernel on the CPU.
    assert (deformable_sampling.launches, deformable_sampling_backward.launches) == (fwd0, bwd0)


def test_rejects_other_devices():
    value, loc, w = _case()
    meta = [torch.empty(x.shape, device="meta") for x in (value, loc, w)]
    with pytest.raises(ValueError):
        deformable_sampling(*meta)
    with pytest.raises(ValueError):
        deformable_sampling_backward(*meta, torch.empty(2, 15, 32, device="meta"))


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, True),
                                   (True, False, False), (False, True, False)])
def test_backward_honours_needs_input_grad(monkeypatch, needs):
    """``d_value`` (the zero-fill and scatter) is built only when value
    needs a gradient, and only the gradients asked for come back."""
    calls = []
    real = deform_attn.deformable_sampling_backward_plain

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(deform_attn, "deformable_sampling_backward_plain", spy)
    ins = [x.requires_grad_(n) for x, n in zip(_t(*_case()), needs)]
    DeformableSampling.apply(*ins, False).sum().backward()
    assert calls == [needs[0]]
    for x, n in zip(ins, needs):
        assert (x.grad is not None) == n


def test_shared_form_matches_jax():
    """Cs = 13 channels (no vector width divides it), heads folded into the
    queries against one value map: vs the jnp gather and the interpreted
    Pallas kernel, and its gradients vs jax.grad through the gather."""
    _, loc, w = _case()
    vs = np.random.default_rng(1).normal(size=(2, 16, 16, 13)).astype(np.float32)
    want = np.asarray(_sample_shared_gather(vs, loc, w))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(_sample_shared_pallas(vs, loc, w))
    ins = [x.requires_grad_() for x in _t(vs, loc, w)]
    got = deformable_sampling_shared(*ins)
    assert got.shape == (2, 15, 4, 13)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got.detach().numpy(), want_pallas, atol=FWD_ATOL, rtol=0)

    g = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    want_grads = jax.grad(lambda v, l, a: (_sample_shared_gather(v, l, a) * g).sum(),
                          argnums=(0, 1, 2))(vs, loc, w)
    _assert_grads_close([x.grad.numpy() for x in ins], want_grads)
