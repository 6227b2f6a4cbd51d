"""Data-parallel training of the port (the JAX package's ``data`` mesh axis)
on the CPU: two ranks of a gloo group started by the port's own
``parallel.dist.spawn``, one torch thread each (``tests/ddp_ranks.py``
runs in them), held against the JAX package's single-device step and
``Trainer.evaluate`` on the same global batch, and against the port's own
one-process step.

  * one fp64 step of stage 2 (V = 2) and stage 3 (V = 2, syn), 64 px,
    global batch 2, one sample a rank (the cases and seeds of
    ``tests/test_torch_port_rigs.py``, whose conditioning check passes at
    them): per-leaf gradients within 2e-5 of their scale of JAX's, the
    parameters within AdamW's per-element bound of the optax update, the
    BN running stats and loss terms as there; against the one-process port
    step, gradients within 1e-10 of scale; both ranks' states bitwise equal;
  * stage 3 with ``ffn_drop`` and ``mlp_dropout`` 0.1 (every dropout call
    site): each rank's masks bitwise the one-process masks' rows;
  * the loader: every rank walks the global index sequence and loads only
    its rows of each batch;
  * a one-epoch stage-1 ``fit``: the ranks' states bitwise equal, rank 0
    alone writes ``metrics.csv`` and ``epoch=0.pt``, which loads into a
    one-process trainer bitwise;
  * ``evaluate`` on 5 items at batch 4 (the last batch padded): the same
    dict on both ranks, within 1e-5 of JAX's ``Trainer.evaluate``;
  * three ranks at batch 4: the data group shrinks to gcd(3, 4) = 1 rank
    with the JAX package's warning, its step is bitwise the one-process
    step, the idle ranks refuse steps, and ``evaluate`` returns rank 0's
    dict on every rank.

The ranks run beside the JAX references, in threads of this process.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import glob
import os

import numpy as np
import pytest
import torch

import jax

from egorear_tpu.train.optim import make_optimizer as jax_make_optimizer
from egorear_tpu.train.tasks import HeatmapTask as JaxHeatmapTask
from egorear_tpu.train.trainer import Trainer as JaxTrainer
from egorear_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.parallel import dist
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.tasks import HeatmapTask

import ddp_ranks
from test_torch_port_models import random_variables
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
    _cascade_cfg,
    _f64,
    _mvfex_cfg,
    step_case,
)
from torch_threads import torch_threads  # noqa: F401

CASES = ("stage2_v2", "stage3_v2_syn")
ONE_PROCESS_GRAD_TOL = 1e-10  # fp64, of each leaf's scale
# The refiners' position tables, whose gradient the lazy sampling (fp32 in
# both packages by contract) sums over the batch in fp32: the one process
# sums both samples in one fp32 call, the ranks one each, then in fp64
# across the ranks, so these leaves differ by fp32 rounding (measured
# 1.03e-7 of scale in stage 2; every other leaf <= 8.6e-15).
FP32_SUM_LEAVES, FP32_SUM_TOL = ("frame_feat_multi_view_pos_embed",), 1e-6
DROPOUT = 0.1
EVAL_TOL = 1e-5
# The step's returned (logged) loss terms are fp32: each rank's rounded,
# then their average.
TERM_RTOL = 3e-7
B1, N_FIT, N_EVAL = 4, 8, 5  # stage 1: global batch, fit and eval items


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(task_name, cfg, kw, state, batch, fp64=True) -> dict:
    return dict(task=task_name, cfg=cfg, kw=kw, state=state, batch=batch,
                batch_size=len(next(iter(batch.values()))), lr=LR,
                wd=WD.get(task_name, 5e-3), decay=DECAY_EPOCHS, warmup=WARMUP,
                fp64=fp64)


def _step_spec(case: str, tmp) -> tuple:
    """(JAX task, variables, batch, the port's spec) of a STEPS case."""
    task_name, V, camera_model, seed = STEPS[case]
    cfg = (_mvfex_cfg(V) if task_name == "heatmap_mvf_ex"
           else _cascade_cfg(V, camera_model))
    jtask, v, batch, task = step_case(task_name, cfg, seed, camera_model)
    path = str(tmp / f"{case}_start.pt")
    torch.save(task.model.state_dict(), path)
    kw = {} if task_name == "heatmap_mvf_ex" else dict(dataset_type="ego4view_syn_pose3d")
    return jtask, v, batch, _spec(task_name, copy.deepcopy(cfg), kw, path, batch)


def _dropout_spec(spec: dict) -> dict:
    """``spec`` (stage 3) with every dropout at DROPOUT: the refiners' and
    the lifting layers' FFNs and the proposal MLP."""
    cfg = copy.deepcopy(spec["cfg"])
    cfg["heatmap_mvf_cfg"]["mvf_cfg"]["mvf_transformer_cfg"]["ffn_cfg"]["ffn_drop"] = DROPOUT
    cfg["pose3d_cfg"]["transformer_cfg"]["ffn_cfg"]["ffn_drop"] = DROPOUT
    cfg["pose3d_cfg"]["mlp_dropout"] = DROPOUT
    return dict(spec, cfg=cfg)


def _stage1(tmp) -> dict:
    """Stage 1 at 64 px: the JAX task, random variables, the port's state,
    a fit dataset of N_FIT items and an eval dataset of N_EVAL."""
    cfg = copy.deepcopy(entry.STAGE1_CFG)
    cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
    rng = np.random.default_rng(5)

    def items(n):
        return {"img": rng.normal(size=(n, 2, 3, SIZE, SIZE)).astype(np.float32),
                "gt_heatmap": rng.uniform(size=(n, 2, 15, SIZE // 4, SIZE // 4)
                                          ).astype(np.float32)}

    fit, ev = items(N_FIT), items(N_EVAL)
    jtask = JaxHeatmapTask(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), ev["img"][:B1], train=False))
    v = random_variables(shapes, rng, heatmap_bias=0.3)
    task = HeatmapTask(copy.deepcopy(cfg), device="cpu")
    load_flax(task.model, v)
    path = str(tmp / "stage1_start.pt")
    torch.save(task.model.state_dict(), path)
    base = _spec("heatmap", cfg, {}, path, {k: a[:B1] for k, a in fit.items()},
                 fp64=False)
    return dict(jtask=jtask, variables=v, fit=dict(base, dataset=fit),
                eval=dict(base, dataset=ev))


def _jax_step(jtask, v, batch, task_name) -> dict:
    """JAX's fp64 step from ``v`` on ``batch``: the clipped gradients, the
    optax update's parameters, the BN running stats, the loss terms, lr."""
    params, batch64 = _f64(v["params"]), _f64(batch)
    extra = {"batch_stats": _f64(v["batch_stats"])}
    stage3 = task_name == "pose_3d_mvf_ex"
    with jax.enable_x64(True):
        (_, (terms, mutated)), grads = jax.jit(jax.value_and_grad(
            lambda p, ev, b: jtask.loss(p, ev, b, True), has_aux=True))(
            params, extra, batch64)
        tx, schedule = jax_make_optimizer(LR, WD[task_name], WARMUP, DECAY_EPOCHS, 1,
                                          grad_clip_norm=5.0, no_decay_mask=stage3,
                                          params=params)
        updates, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(grads, params)
        new = jax.tree.map(lambda p, u: p + u, params, updates)
        lr = float(schedule(0))
    grads = from_flax({"params": jax.device_get(grads)})
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    clip = min(1.0, 5.0 / norm)
    return dict(grads={k: g * clip for k, g in grads.items()},
                params=from_flax({"params": jax.device_get(new)}),
                stats=from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])}),
                terms={k: float(t) for k, t in jax.device_get(terms).items()}, lr=lr)


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The two- and three-rank groups' results, the JAX references and the
    one-process port steps."""
    tmp = tmp_path_factory.mktemp("ddp")
    cases = {c: _step_spec(c, tmp) for c in CASES}
    steps = {c: spec for c, (*_, spec) in cases.items()}
    steps["dropout"] = _dropout_spec(steps["stage3_v2_syn"])
    s1 = _stage1(tmp)
    loader = dict(arrays={"idx": np.arange(10)[:, None]}, batch_size=4, seed=3, epoch=1)
    plan = dict(steps=steps, out=str(tmp), loader=loader,
                fit=dict(s1["fit"], save_dir=str(tmp / "logs")), eval=s1["eval"])
    shrink = dict(step=s1["fit"], eval=s1["eval"])
    with cf.ThreadPoolExecutor(2) as pool:
        two = pool.submit(dist.spawn, ddp_ranks.two_ranks, 2, plan)
        three = pool.submit(dist.spawn, ddp_ranks.three_ranks, 3, shrink)
        jax_steps = {c: _jax_step(jtask, v, batch, steps[c]["task"])
                     for c, (jtask, v, batch, _) in cases.items()}
        one = {}
        for name, spec in steps.items():
            _, trainer = ddp_ranks.build(spec)
            one[name] = ddp_ranks.take_step(spec, trainer)
        _, trainer = ddp_ranks.build(s1["fit"])
        one["stage1"] = ddp_ranks.take_step(s1["fit"], trainer)
        jtr = JaxTrainer(s1["jtask"], JaxTrainerConfig(devices=1, seed=0), LR, 5e-3,
                         DECAY_EPOCHS, WARMUP, batch_size=B1, workers=1)
        eval_ds = ddp_ranks.ArrayDataset(s1["eval"]["dataset"])
        jtr.init_state(eval_ds.arrays, steps_per_epoch=1)
        v = s1["variables"]
        jtr.load_state_params(v["params"], {"batch_stats": v["batch_stats"]})
        jax_eval = {k: float(x) for k, x in jtr.evaluate(eval_ds, mode="test").items()}
        _, trainer = ddp_ranks.build(s1["eval"])
        one_eval = trainer.evaluate(ddp_ranks.ArrayDataset(s1["eval"]["dataset"]),
                                    mode="test")
        two, three = two.result(), three.result()
    rank0 = {c: torch.load(two[0]["steps"][c]["file"], weights_only=False)
             for c in steps}
    return dict(two=two, three=three, rank0=rank0, jax=jax_steps, one=one,
                jax_eval=jax_eval, one_eval=one_eval, plan=plan, s1=s1)


def _hold(got: dict, want: dict, lr: float, grad_tol: float,
          leaf_tol: dict = {}) -> float:
    """Per-leaf gradients within ``grad_tol`` of each leaf's scale (or the
    ``leaf_tol`` of the leaves whose names end with its keys; a leaf
    below GRAD_FLOOR of the largest gradient is a key-projection bias,
    rounding only, and stays below the floor), every parameter within
    AdamW's first-step bound over that tolerance (as
    ``test_torch_port_rigs.check_train_step``). Returns the worst ratio."""
    floor = GRAD_FLOOR * max(float(np.abs(np.asarray(w)).max())
                             for w in want["grads"].values())
    worst = 0.0
    for k, w in want["grads"].items():
        w = torch.as_tensor(np.asarray(w))
        g = torch.as_tensor(got["grads"][k])
        assert g.dtype == torch.float64, k
        scale = float(w.abs().max())
        if scale == 0:
            assert not bool(g.any()), k
            continue
        if scale < floor:
            assert k.endswith("k_proj.bias") and float(g.abs().max()) <= floor, k
            continue
        err = float((g - w).abs().max())
        tol = next((t for end, t in leaf_tol.items() if k.endswith(end)), grad_tol)
        if tol == grad_tol:
            worst = max(worst, err / scale)
        assert err <= tol * scale, f"{k}: {err:.3e} > {tol:g} x {scale:.3e}"
        tl = tol * scale
        gmin = (w.abs() - tl).clamp_min(0.0)
        p_want = torch.as_tensor(np.asarray(want["params"][k]))
        bound = (lr * (1e-8 * tl / (gmin + 1e-8) ** 2).clamp(max=2.0)
                 + 4.8e-7 * (p_want.abs() + lr) + 1e-5 * lr)
        diff = (torch.as_tensor(got["params"][k]) - p_want).abs()
        assert bool((diff <= bound * (1 + 1e-3)).all()), k
    return worst


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_jax(ddp, case):
    """Rank 0's step (its gradients are the ranks' average) vs JAX's
    single-device step on the global batch."""
    got, want = ddp["rank0"][case], ddp["jax"][case]
    worst = _hold(got, want, want["lr"], GRAD_TOL64)
    n = 0
    for k, w in want["stats"].items():
        if "running" in k:
            n += 1
            np.testing.assert_allclose(got["stats"][k], w.numpy(), atol=BN_TOL64,
                                       rtol=BN_TOL64, err_msg=k)
    assert n == 2 * 20  # mean and var of the front estimator's 20 BNs (V = 2)
    terms = ddp["two"][0]["steps"][case]["metrics"]
    for k, w in want["terms"].items():
        assert abs(terms[k] - w) <= TERM_RTOL * abs(w), (k, terms[k], w)
    print(f"{case}: two ranks vs JAX, worst leaf gradient {worst:.3e} of scale")


@pytest.mark.parametrize("case", CASES)
def test_two_rank_step_matches_one_process(ddp, case):
    """Rank 0's step vs the port's one-process step on the global batch:
    gradients within 1e-10 of scale in fp64 (the position tables, summed
    over the batch in fp32 by the lazy sampling, within FP32_SUM_TOL), BN
    running stats (the one process takes its statistics in fp32) within
    BN_TOL64."""
    got, want = ddp["rank0"][case], ddp["one"][case]
    worst = _hold(got, want, ddp["jax"][case]["lr"], ONE_PROCESS_GRAD_TOL,
                  dict.fromkeys(FP32_SUM_LEAVES, FP32_SUM_TOL))
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], w, atol=BN_TOL64, rtol=BN_TOL64,
                                   err_msg=k)
    for k, w in want["metrics"].items():
        assert abs(ddp["two"][0]["steps"][case]["metrics"][k] - w) <= TERM_RTOL * abs(w), k
    print(f"{case}: two ranks vs one process, worst leaf gradient {worst:.3e} of scale")


@pytest.mark.parametrize("case", CASES + ("dropout",))
def test_rank_replicas_stay_bitwise_equal(ddp, case):
    assert ddp["two"][0]["steps"][case]["hash"] == ddp["two"][1]["steps"][case]["hash"]


def test_dropout_masks_are_the_one_process_rows(ddp):
    """Every dropout call of the stage-3 step (the refiners' and lifting
    layers' FFNs, the proposal MLP) drops on each rank bitwise what the
    one process drops on that rank's rows."""
    want = ddp["one"]["dropout"]["masks"]
    # Two per FFN (V refiners x 1 layer, 3 lifting layers), one per
    # proposal MLP layer.
    assert len(want) == 2 * (2 + 3) + 2
    for r in (0, 1):
        got = ddp["two"][r]["steps"]["dropout"]["masks"]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            n = g.shape[0]
            np.testing.assert_array_equal(g, w[r * n:(r + 1) * n], err_msg=f"call {i}")
        dropped = sum(int(g.sum()) for g in got)
        assert 0 < dropped < sum(g.size for g in got)
    for k, w in ddp["one"]["dropout"]["metrics"].items():
        assert abs(ddp["two"][0]["steps"]["dropout"]["metrics"][k] - w) <= TERM_RTOL * abs(w)


def test_each_rank_loads_only_its_rows(ddp):
    """The loader of both ranks walks the one-process index sequence; each
    loads only its contiguous half of every global batch."""
    from egorear_tpu_torch.data.loader import DataLoader

    spec = ddp["plan"]["loader"]
    loader = DataLoader(ddp_ranks.ArrayDataset(spec["arrays"]), spec["batch_size"],
                        shuffle=True, drop_last=True, seed=spec["seed"])
    loader.set_epoch(spec["epoch"])
    want = [b["idx"].reshape(-1).tolist() for b in loader]
    assert len(want) == 2
    for r in (0, 1):
        got = ddp["two"][r]["loader"]
        assert got["batches"] == [b[2 * r:2 * r + 2] for b in want]
        assert got["loaded"] == sorted(i for b in want for i in b[2 * r:2 * r + 2])


def test_fit_checkpoint_is_rank_zeros_and_loads_bitwise(ddp, tmp_path):
    fit = [ddp["two"][r]["fit"] for r in (0, 1)]
    assert fit[0]["hash"] == fit[1]["hash"] and fit[0]["step"] == fit[1]["step"] == 2
    # 2 steps x 2 rows a rank, loaded by each rank alone.
    assert fit[0]["loaded"] == fit[1]["loaded"] == N_FIT // 2
    assert fit[1]["log_dir"] is None
    root = ddp["plan"]["fit"]["save_dir"]
    assert glob.glob(os.path.join(root, "lightning_logs", "*")) == [fit[0]["log_dir"]]
    assert os.path.exists(os.path.join(fit[0]["log_dir"], "metrics.csv"))
    (ckpt,) = glob.glob(os.path.join(fit[0]["log_dir"], "checkpoints", "*.pt"))
    assert ckpt.endswith("epoch=0.pt")
    state = ckpt_lib.restore(ckpt)
    assert state["step"] == 2 and not any(k.startswith("module.") for k in state["model"])
    _, trainer = ddp_ranks.build(ddp["s1"]["fit"])
    trainer.load_state_dict(state)
    want = torch.load(fit[0]["file"], weights_only=True)
    got = trainer.task.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert ddp_ranks.state_hash(trainer.task.model) == fit[0]["hash"]


def test_evaluate_matches_jax_on_every_rank(ddp):
    """``evaluate`` on 5 items at batch 4 (the last batch padded by index):
    each rank evaluates its rows of each batch; both return one dict,
    within EVAL_TOL of JAX's ``Trainer.evaluate`` and of the one process."""
    got = [ddp["two"][r]["eval"] for r in (0, 1)]
    assert got[0] == got[1]
    want = ddp["jax_eval"]
    assert sorted(got[0]) == sorted(want) and len(want) == 4
    for k, w in want.items():
        np.testing.assert_allclose(got[0][k], w, rtol=EVAL_TOL, atol=EVAL_TOL, err_msg=k)
        np.testing.assert_allclose(got[0][k], ddp["one_eval"][k], rtol=EVAL_TOL,
                                   atol=EVAL_TOL, err_msg=k)


def test_three_ranks_shrink_to_gcd_and_warn(ddp):
    """W = 3 at batch 4: one data rank (JAX's mesh would shrink to gcd(3,
    4) = 1 device the same way), with JAX's warning on every rank; rank 0's
    step is bitwise the one-process step; the idle ranks refuse steps and
    return from ``fit`` untrained; ``evaluate`` is rank 0's everywhere."""
    three = ddp["three"]
    assert [r["shard"] for r in three] == [(0, 1, True), (0, 1, False), (0, 1, False)]
    for r in three:
        assert any("shrunk to 1/3 ranks" in m and "2 ranks will sit idle" in m
                   for m in r["warnings"]), r["warnings"]
    assert three[0]["step"] == ddp["one"]["stage1"]["hash"]
    for r in three[1:]:
        assert "idle" in r["step"] and r["fit_step"] == 0
    assert three[0]["eval"] == three[1]["eval"] == three[2]["eval"]
    for k, w in ddp["one_eval"].items():
        np.testing.assert_allclose(three[0]["eval"][k], w, rtol=EVAL_TOL, atol=EVAL_TOL)


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """NCCL needs a card per rank: asking for more raises before any
    process starts, naming gloo; it never falls back."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL needs one CUDA card per rank.*gloo"):
        dist.spawn(ddp_ranks.two_ranks, 2, {}, device="cuda")


def test_loader_refuses_ranks_that_do_not_divide_the_batch():
    from egorear_tpu_torch.data.loader import DataLoader

    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(ddp_ranks.ArrayDataset({"idx": np.arange(9)}), 4, drop_last=True,
                   shard=dist.DataShard(0, 3, None, True, True))
