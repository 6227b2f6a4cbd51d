"""``remat`` (activation rematerialisation, the JAX package's
``jax.checkpoint(loss_fn)``) in the port's trainer on the CPU, 64 px:

  * a stage-3 step with every dropout at 0.1, fp32: with ``remat`` its
    forward runs again in the backward (each BatchNorm and dropout is
    called twice, the recompute drawing the forward's masks), and the step
    is bitwise the step without: the same gradients,
    parameters, loss terms and BN running stats, updated once
    (``num_batches_tracked`` moves by one);
  * a stage-2 step (V = 2, fp64, the case and seed of
    ``tests/test_torch_port_rigs.py``) with ``remat`` vs the JAX package's
    own ``Trainer`` step with ``remat=True``: the parameters within AdamW's
    per-element bound (over GRAD_TOL64 of each leaf's gradient scale), the
    BN running stats within BN_TOL64, the loss terms within fp32 rounding.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from egorear_tpu.train.trainer import Trainer as JaxTrainer
from egorear_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.models.backbone import BatchNorm2d
from egorear_tpu_torch.models.layers import Dropout
from egorear_tpu_torch.train.tasks import Pose3DTask
from egorear_tpu_torch.train.trainer import Trainer

from test_torch_port_rigs import (
    BN_TOL64,
    DECAY_EPOCHS,
    GRAD_FLOOR,
    GRAD_TOL64,
    LR,
    SIZE,
    STEPS,
    WARMUP,
    WD,
    _f64,
    _mvfex_cfg,
    step_case,
)
from torch_threads import torch_threads  # noqa: F401

DROPOUT = 0.1
TERM_RTOL = 3e-7  # the step's returned loss terms are fp32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(trainer, batch, start) -> dict:
    """One step of ``trainer`` from the state dict ``start``: its loss
    terms, gradients, parameters and buffers, how often each BN ran and
    every dropout call's mask (True where dropped), in call order."""
    model = trainer.task.model
    model.load_state_dict(start)
    trainer.init_state(steps_per_epoch=1)
    calls, masks = [], []
    hooks = [m.register_forward_hook(lambda *_: calls.append(1))
             for m in model.modules() if isinstance(m, BatchNorm2d)]
    n_bn = len(hooks)
    hooks += [m.register_forward_hook(lambda m, i, out: masks.append(out == 0))
              for m in model.modules() if isinstance(m, Dropout) and m.p > 0]
    metrics = trainer.train_step(batch)
    for h in hooks:
        h.remove()
    return dict(metrics=metrics, bn_calls=len(calls), n_bn=n_bn, masks=masks,
                grads={k: p.grad.clone() for k, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def test_remat_step_is_bitwise_the_step_without():
    cfg = entry.flagship_cfg_dict((SIZE, SIZE))
    cfg["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    cfg["heatmap_mvf_cfg"]["mvf_cfg"]["mvf_transformer_cfg"]["ffn_cfg"]["ffn_drop"] = DROPOUT
    cfg["pose3d_cfg"]["transformer_cfg"]["ffn_cfg"]["ffn_drop"] = DROPOUT
    cfg["pose3d_cfg"]["mlp_dropout"] = DROPOUT
    task = Pose3DTask(cfg, device="cpu", seed=3)
    trainer = Trainer(task, LR, 0.1, DECAY_EPOCHS, WARMUP, no_decay_mask=True)
    gen = torch.Generator().manual_seed(4)
    batch = {"img": torch.randn(2, 4, 3, SIZE, SIZE, generator=gen),
             "gt_pose": torch.rand(2, 16, 3, generator=gen) * 100.0 - 50.0,
             "gt_heatmap": torch.rand(2, 4, 15, SIZE // 4, SIZE // 4, generator=gen)}
    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    plain = _step(trainer, batch, start)
    trainer.cfg.remat = True
    remat = _step(trainer, batch, start)
    assert plain["bn_calls"] == plain["n_bn"] > 0  # each BN once a forward
    assert remat["bn_calls"] == 2 * remat["n_bn"]  # ... and again in the backward
    # The recompute draws the forward's masks again (4 refiners' and 3
    # lifting layers' FFNs, two calls each, and the two proposal MLP layers).
    n = len(plain["masks"])
    assert n == 2 * (4 + 3) + 2 and len(remat["masks"]) == 2 * n
    assert 0 < sum(int(m.sum()) for m in plain["masks"])
    for i, m in enumerate(plain["masks"]):
        assert torch.equal(remat["masks"][i], m) and torch.equal(remat["masks"][n + i], m)
    assert sorted(remat["metrics"]) == sorted(plain["metrics"])
    for k, v in plain["metrics"].items():
        assert torch.equal(remat["metrics"][k], v), k
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    for k, v in plain["state"].items():
        assert torch.equal(remat["state"][k], v), k
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(start[k]) + 1, k


def test_remat_step_matches_jax_remat_trainer():
    task_name, V, camera_model, seed = STEPS["stage2_v2"]
    cfg = _mvfex_cfg(V)
    jtask, v, batch, task = step_case(task_name, cfg, seed, camera_model)
    params, batch64 = _f64(v["params"]), _f64(batch)
    extra = {"batch_stats": _f64(v["batch_stats"])}
    with jax.enable_x64(True):
        jtr = JaxTrainer(jtask, JaxTrainerConfig(devices=1, remat=True,
                                                 gradient_clip_val=5.0),
                         LR, WD[task_name], DECAY_EPOCHS, WARMUP, batch_size=len(batch["img"]))
        jtr.init_state(batch64, steps_per_epoch=1)
        jtr.load_state_params(params, extra)
        state, jm = jtr._train_step(jtr.state, batch64)
        state, jm = jax.device_get((state, jm))
    want_params = from_flax({"params": state["params"]})
    want_stats = from_flax({"batch_stats": state["extra_vars"]["batch_stats"]})

    task.model.double()
    trainer = Trainer(task, LR, WD[task_name], DECAY_EPOCHS, WARMUP,
                      gradient_clip_val=5.0)
    trainer.cfg.remat = True
    trainer.init_state(steps_per_epoch=1)
    m = trainer.train_step({k: torch.from_numpy(x) for k, x in batch64.items()})
    assert sorted(m) == sorted(jm)
    for k, w in jm.items():
        assert abs(float(m[k]) - float(w)) <= TERM_RTOL * abs(float(w)), k
    named = dict(task.model.named_parameters())
    # The step's clipped gradients (the port's; JAX's trainer keeps none)
    # decide which elements AdamW's first step moves by lr * sign(g).
    gmax = max(float(p.grad.abs().max()) for p in named.values())
    lr = float(jm["lr"])
    for k, p in named.items():
        g = p.grad
        scale = float(g.abs().max())
        tl = max(GRAD_TOL64 * scale, GRAD_FLOOR * gmax)
        gmin = (g.abs() - tl).clamp_min(0.0)
        want = want_params[k]
        assert want.dtype == torch.float64, k
        bound = (lr * (1e-8 * tl / (gmin + 1e-8) ** 2).clamp(max=2.0)
                 + 4.8e-7 * (want.abs() + lr) + 1e-5 * lr)
        diff = (p.detach() - want).abs()
        assert bool((diff <= bound * (1 + 1e-3)).all()), k
    sd = task.model.state_dict()
    n = 0
    for k, w in want_stats.items():
        if "running" not in k:  # JAX keeps no count
            continue
        n += 1
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=BN_TOL64,
                                   rtol=BN_TOL64, err_msg=k)
    assert n == 2 * 20
