"""Training on the model branches that no shipped yaml sets, held to the JAX
package on the CPU at 64 px, batch 2.

  * Dropout (``ffn_drop``, ``mlp_dropout``): rate 0 draws nothing and is
    the identity, so the steps below, which run through the trainer's
    seeded generator, are the JAX steps; at rate 0.1 a train-mode loss is
    bitwise the same for the same (seed, step) and differs across steps; a
    run resumed from a checkpoint continues the same stream; eval mode
    ignores it; the kept fraction lies within 3 sigma of 1 - p and the kept
    values are scaled by 1 / (1 - p), as flax's (whose threefry bits the
    port does not reproduce: it draws from a ``torch.Generator``).
  * One EgoRear-layout ``.ckpt`` of stage 3 with ``use_1by1_conv``, the
    joint-query-only mode, the heatmap-embedding mode and the heatmap 3D
    proposal (``chip_smoke.write_egorear_ckpt``): JAX's converter takes it
    strictly and the port's import gives JAX's result bitwise.
  * With ``use_1by1_conv`` a stage-1 ``.ckpt``, its ``conv_heatmap`` head
    included, grafts into stage 2 in both packages, bitwise alike (the
    stage-2 estimators own that head on this branch).
  * One fp64 train step of stage 2 with the joint-query-only mode against
    JAX (``test_torch_port_rigs.check_train_step``; the other branches'
    steps are in ``test_torch_port_branches_steps.py`` and
    ``test_torch_port_branches_refined.py``), and the 512-channel
    token head's forward and VJP in fp64 against ``jax.vjp``.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as flax_nn

import chip_smoke
from egorear_tpu.train import checkpoint as jax_ckpt
from egorear_tpu.train.tasks import TASKS as JAX_TASKS
from egorear_tpu.train.torch_convert import convert_lightning_ckpt
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.models.layers import Dropout, dropout_generator
from egorear_tpu_torch.train import checkpoint
from egorear_tpu_torch.train.tasks import TASKS, Pose3DTask
from egorear_tpu_torch.train.torch_convert import import_lightning_ckpt
from egorear_tpu_torch.train.trainer import Trainer, dropout_seed
from test_torch_port_models import random_variables
from test_torch_port_rigs import _mvfex_cfg, check_train_step, step_case
from torch_threads import torch_threads  # noqa: F401

SIZE, B, P = 64, 2, 0.1
SEED_QUERY_ONLY = 100
LR, WD, WARMUP, DECAY_EPOCHS = 1e-5, 0.1, 2, (2,)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def branch_cfg(*branches: str, layers: int = 1) -> dict:
    """The 64 px flagship with ``branches`` set, ``layers`` lifting layers
    and no ImageNet weights."""
    cfg = entry.flagship_cfg_dict((SIZE, SIZE))
    for b in branches:
        chip_smoke.set_keys(cfg, chip_smoke.BRANCHES[b])
    cfg["pose3d_cfg"]["num_former_layers"] = layers
    return cfg


# -- dropout ---------------------------------------------------------------------


def _dropout_cfg(rate: float) -> dict:
    cfg = branch_cfg()
    cfg["heatmap_mvf_cfg"]["mvf_cfg"]["mvf_transformer_cfg"]["ffn_cfg"]["ffn_drop"] = rate
    cfg["pose3d_cfg"]["transformer_cfg"]["ffn_cfg"]["ffn_drop"] = rate
    cfg["pose3d_cfg"]["mlp_dropout"] = rate
    return cfg


def _batch(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"img": torch.randn(B, 4, 3, SIZE, SIZE, generator=g),
            "gt_heatmap": torch.rand(B, 4, 15, SIZE // 4, SIZE // 4, generator=g),
            "gt_pose": torch.rand(B, 16, 3, generator=g) * 100 - 50}


def _trainer(rate: float) -> Trainer:
    trainer = Trainer(Pose3DTask(_dropout_cfg(rate), device="cpu"), LR, WD,
                      DECAY_EPOCHS, WARMUP)
    trainer.init_state(steps_per_epoch=4)
    return trainer


def _loss_at(trainer: Trainer, step: int, batch: dict) -> torch.Tensor:
    trainer.step = step
    trainer.task.model.train()
    with torch.no_grad():
        return trainer.task.loss(batch, None, trainer.dropout_generator())[0]


def test_dropout_rate_zero_draws_nothing():
    trainer, batch = _trainer(0.0), _batch()
    gen = trainer.dropout_generator()
    state = gen.get_state()
    model = trainer.task.model.train()
    with torch.no_grad():
        with_gen = trainer.task.loss(batch, None, gen)[0]
        without = trainer.task.loss(batch)[0]
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(with_gen, without)
    assert all(m.p == 0.0 for m in model.modules() if isinstance(m, Dropout))


def test_dropout_stream_is_seeded_by_step():
    trainer, batch = _trainer(P), _batch()
    # the 4 refiners' FFNs, the lifting layer's, the proposal MLP's
    assert sum(isinstance(m, Dropout) and m.p == P
               for m in trainer.task.model.modules()) == 4 + 1 + 1
    a, again, b = (_loss_at(trainer, s, batch) for s in (5, 5, 6))
    assert torch.equal(a, again)
    assert not torch.equal(a, b)
    assert dropout_seed(42, 5) != dropout_seed(42, 6) != dropout_seed(43, 6)
    with pytest.raises(RuntimeError, match="dropout_generator"):
        trainer.task.loss(batch)  # train mode, no generator: refused


def test_dropout_resumed_run_continues_the_stream():
    batch = _batch(1)
    straight = _trainer(P)
    losses = [float(straight.train_step(batch)["loss_total"]) for _ in range(3)]
    first = _trainer(P)
    for _ in range(2):
        first.train_step(batch)
    resumed = _trainer(P)
    resumed.load_state_dict(first.state_dict())
    assert resumed.step == 2
    assert float(resumed.train_step(batch)["loss_total"]) == losses[2]
    assert len(set(losses)) == 3


def test_dropout_eval_mode_is_the_identity():
    trainer, batch = _trainer(P), _batch()
    model = trainer.task.model.eval()
    gen = trainer.dropout_generator()
    state = gen.get_state()
    with torch.no_grad():
        got = trainer.task.forward(batch["img"], None, None, gen)
        want = trainer.task.forward(batch["img"])
    assert torch.equal(gen.get_state(), state)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert torch.equal(g, w)
    assert not model.training


def test_dropout_kept_fraction_and_scale_match_flax():
    n = 1 << 20
    x = torch.full((n,), 3.0)
    drop = Dropout(P).train()
    with dropout_generator(drop, torch.Generator().manual_seed(7)):
        y = drop(x)
    jy = np.asarray(flax_nn.Dropout(P, deterministic=False).apply(
        {}, jnp.full((n,), 3.0), rngs={"dropout": jax.random.PRNGKey(7)}))
    sigma = math.sqrt(P * (1 - P) / n)
    for kept, values in (((y != 0).float().mean().item(), y[y != 0].unique()),
                         (float((jy != 0).mean()), torch.from_numpy(np.unique(jy[jy != 0])))):
        assert abs(kept - (1 - P)) <= 3 * sigma, kept
        assert values.numel() == 1 and float(values[0]) == np.float32(3.0) / np.float32(1 - P)


# -- .ckpt import and the stage-1 graft -------------------------------------------


@pytest.mark.parametrize("branch", ["1by1", "query_only", "hm_embed", "mlp_heatmap"])
def test_ckpt_import_matches_jax(tmp_path, branch):
    cfg = branch_cfg(branch, layers=3)
    jtask = JAX_TASKS["pose_3d_mvf_ex"](copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 3, SIZE, SIZE)), jtask.rig, None,
        train=False))
    sd = from_flax(random_variables(shapes, np.random.default_rng(70)))
    path = chip_smoke.write_egorear_ckpt(str(tmp_path / "x.ckpt"), sd, "pose_3d_mvf_ex")
    want = from_flax(convert_lightning_ckpt(path, shapes, "pose_3d_mvf_ex"))
    assert sorted(want) == sorted(sd)
    target = TASKS["pose_3d_mvf_ex"](cfg, device="cpu").model.state_dict()
    got = import_lightning_ckpt(path, target, "pose_3d_mvf_ex")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w) and torch.equal(w, sd[k]), k


def test_stage1_ckpt_grafts_into_1by1_stage2(tmp_path):
    """The conv-stack stage 2 refuses a stage-1 ``.ckpt`` with its head in
    both packages (``test_torch_port_ckpt_import.py``); with
    ``use_1by1_conv`` the stage-2 estimators own ``conv_heatmap`` and both
    packages take the head along, bitwise alike."""
    cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[SIZE, SIZE]))
    chip_smoke.set_keys(cfg, {"mvf_cfg.use_1by1_conv": True,
                         "encoder_cfg.resnet_cfg.use_imagenet_pretrain": False})
    jtask = JAX_TASKS["heatmap_mvf_ex"](copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 3, SIZE, SIZE)), train=False))
    base = random_variables(shapes, np.random.default_rng(71))
    stage1 = JAX_TASKS["heatmap"](copy.deepcopy(entry.STAGE1_CFG))
    s1_shapes = jax.eval_shape(lambda: stage1.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 3, SIZE, SIZE)), train=False))
    src = from_flax(random_variables(s1_shapes, np.random.default_rng(72)))
    assert "conv_heatmap.weight" in src
    ckpt = chip_smoke.write_egorear_ckpt(str(tmp_path / "s1.ckpt"), src, "heatmap")

    key = "heatmap_estimator_pretrained_stereo_back"
    path = checkpoint.PRETRAINED_GRAFTS[key][0]
    loaded = jax_ckpt.load_pretrained(
        ckpt, {c: base[c][path] for c in base}, "heatmap")
    want = from_flax({"params": jax_ckpt.graft(base["params"], path, loaded["params"]),
                      "batch_stats": jax_ckpt.graft(base["batch_stats"], path,
                                                    loaded["batch_stats"])})
    task = TASKS["heatmap_mvf_ex"](cfg, device="cpu")
    task.model.load_state_dict(from_flax(base), strict=True)
    assert checkpoint.apply_pretrained(task.model, task.name, {key: ckpt}) == [key]
    got = task.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert torch.equal(got[f"{path}.conv_heatmap.weight"], src["conv_heatmap.weight"])


# -- one fp64 train step ------------------------------------------------------------


# The branch steps' gradient bound, of each leaf's largest JAX value. They
# route more gradient through the fp32 sampling core than the rigs' steps
# (without use_pred_heatmap_init the lifter's d_feat reaches every refiner
# leaf), and JAX's own one-ulp move is ~1e-5 there at every seed from 100
# (``check_train_step``'s conditioning check), so the bound is 1e-4: ten
# times under the card's fp32 phase-5 bound.
BRANCH_GRAD_TOL = 1e-4
# Leaves whose gradient may lie below the rounding floor in both packages:
# the attention key biases (rounding), and the refiners' position tables
# under dense cross-attention, which spreads each query's gradient over
# 4096 keys (~5e-9 of the largest leaf at 64 px).
FLOOR_LEAVES = ("k_proj.bias", "frame_feat_multi_view_pos_embed")


def run_step(name: str, branches, seed: int, stage: int = 3, variables_kw=None):
    """One fp64 step of stage ``stage`` (3: the 64 px flagship with one
    lifting layer; 2: the stage-2 yaml's network) with ``branches`` held to
    JAX at ``seed``, the first from 100 that JAX's conditioning check
    passes."""
    if stage == 3:
        task_name, cfg = "pose_3d_mvf_ex", branch_cfg(*branches)
    else:
        task_name, cfg = "heatmap_mvf_ex", _mvfex_cfg(4)
        for b in branches:
            chip_smoke.set_keys(cfg, {k[len("heatmap_mvf_cfg."):]: v
                                 for k, v in chip_smoke.BRANCHES[b].items()})
    check_train_step(name, task_name,
                     lambda s: step_case(task_name, cfg, s, **(variables_kw or {})),
                     [seed], bn_layers=2 * 20 * 2, grad_tol=BRANCH_GRAD_TOL,
                     floor_leaves=FLOOR_LEAVES)


def test_train_step_query_only_matches_jax():
    """The joint-query-only mode in a stage-2 step (the refiners' queries
    read neither heatmaps nor backbone)."""
    run_step("stage2 query_only", ["query_only"], SEED_QUERY_ONLY, stage=2)


def test_head512_gradients_match_jax():
    """The 512-channel token head's forward and VJP in fp64 against
    ``jax.vjp`` of the JAX module: output, input gradient and each kernel's
    and bias's gradient within 1e-10 of their scale. (A whole fp64 step at
    512 channels takes JAX ~36 s a gradient on this CPU, over the file's
    budget; on the card phase 15 holds that step, kernels vs plain.)"""
    from egorear_tpu.models.mvfex import TransformerHeadLayer as JaxHead
    from egorear_tpu_torch.models.mvfex import TransformerHeadLayer

    rng = np.random.default_rng(73)
    x = rng.normal(size=(B, 16, 16, 15))  # (B, side, side, J), JAX's NHWC
    g = rng.normal(size=(B, 32, 32, 512))
    jhead = JaxHead(output_dims=512)
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), x))
        params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              random_variables(shapes, rng)["params"])
        want, vjp = jax.vjp(lambda p, x: jhead.apply({"params": p}, x), params, x)
        want_dp, want_dx = jax.tree.map(np.asarray, vjp(g))
    head = TransformerHeadLayer(15, 512).double()
    head.load_state_dict(from_flax({"params": params}), strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = head(xt)
    out.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    assert [f"Conv_{i}" for i in range(4)] == sorted(want_dp)
    pairs = [(out.detach().permute(0, 2, 3, 1), np.asarray(want)),
             (xt.grad.permute(0, 2, 3, 1), want_dx)]
    pairs += [(p.grad, w) for p, w in zip(
        (q for _, q in sorted(head.named_parameters())),
        (v for _, v in sorted(from_flax({"params": want_dp}).items())))]
    for got, w in pairs:
        w = torch.as_tensor(np.asarray(w))
        scale = float(w.abs().max())
        assert scale > 0 and float((got - w).abs().max()) <= 1e-10 * scale
