"""Tensor parallelism over the model axis (the JAX package's
``--trainer.model_parallel``) on the CPU: gloo groups started by the port's
own ``parallel.dist.spawn``, one torch thread a rank (``tests/tp_ranks.py``
runs in them), 64 px, ``tp_min_dim`` 256 so that the rule fires at these
widths, as the JAX package's own test and dry run do.

  * The placements: ``parallel.mesh.param_placements`` of the stage-2 and
    stage-3 flagships (256 px) equal the JAX package's ``param_shardings``
    on the same flax tree (an 8-device mesh, ``model_parallel=2``), mapped
    onto the port's tensors by ``convert.from_flax``, at ``min_dim`` 256
    and 2048, with and without ``shard_stacked``; ``leaf_axis`` on the
    unit shapes of ``test_leaf_sharding_rule_covers_stacked_refiner_kernels``
    equals ``leaf_sharding``.
  * The layers on 2 ranks, fp64: row-parallel and column-parallel Linears
    and PointwiseConvs and gathered leaves, forward and backward, equal the
    unsharded modules within 1e-12.
  * fp64 steps at (D, M) = (1, 2) and (2, 2) of stage 3 (V = 2, syn) and
    (1, 2) of stage 2 (V = 2) with ``shard_stacked`` off, clipping engaged
    (``gradient_clip_val`` CLIP, far below the gradients' norm, so that a
    norm over one rank's slices would clip by another factor): the
    gradients within 1e-12 of scale of the port's one-process step (the
    refiners' position tables, which the fp32 lazy sampling sums, within
    1e-6) and within 2e-6 of JAX's one-device step, the parameters within
    AdamW's per-element bound, the BN running stats and loss terms; every
    replicated leaf bitwise the same across each model group, the slices
    the same across each data group.
  * ``remat`` under tensor parallelism equals the plain step bitwise.
  * Four ranks at global batch 1 with ``model_parallel`` 2: the data axis
    shrinks to gcd(2, 1) = 1, ranks 0 and 1 form the model group and ranks
    2 and 3 sit idle, as the JAX package's mesh keeps n·M devices.
  * ``state_dict`` under tensor parallelism writes the one-process
    ``epoch=0.pt`` (loads into one process with the same keys and shapes,
    its leaves bitwise the gathered ones); it loads back into a sharded
    trainer bitwise, and ``auto_resume`` restores the slices.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from egorear_tpu.parallel.mesh import leaf_sharding, make_mesh, param_shardings
from egorear_tpu.train.optim import make_optimizer as jax_make_optimizer
from egorear_tpu.train.tasks import MVFexTask as JaxMVFexTask
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.parallel import dist, tensor
from egorear_tpu_torch.parallel.mesh import leaf_axis, param_placements
from egorear_tpu_torch.train import checkpoint as ckpt_lib
from egorear_tpu_torch.train.tasks import MVFexTask, Pose3DTask

import tp_ranks
from test_torch_port_ddp import FP32_SUM_LEAVES, FP32_SUM_TOL, TERM_RTOL, _hold
from test_torch_port_rigs import (
    BN_TOL64,
    DECAY_EPOCHS,
    LR,
    STEPS,
    WARMUP,
    WD,
    _cascade_cfg,
    _f64,
    _mvfex_cfg,
    step_case,
)
from torch_threads import torch_threads  # noqa: F401

MIN_DIM = 256
CLIP = 0.05  # far below both steps' gradient norms: clipping engages
ONE_PROCESS_GRAD_TOL = 1e-12  # fp64, of each leaf's scale
# fp64, of each leaf's scale: the data-parallel steps measured <= 1.38e-6
# against JAX (their test holds 2e-5, the rigs' GRAD_TOL64).
JAX_GRAD_TOL = 2e-6
LAYER_TOL = 1e-12
# (STEPS case, (data, model) ranks, shard_stacked)
TP_STEPS = {"stage3_1x2": ("stage3_v2_syn", (1, 2), True),
            "stage3_2x2": ("stage3_v2_syn", (2, 2), True),
            "stage2_1x2": ("stage2_v2", (1, 2), False)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the placement rule --------------------------------------------------------

UNIT_SHAPES = [((2048, 128), True, P("model", None)),
               ((128, 4096), True, P(None, "model")),
               ((4, 4096, 256), True, P(None, "model", None)),
               ((4, 256, 512), True, P(None, None, "model")),
               ((4, 4096, 256), False, P()),
               ((4, 100, 30), True, P()),
               ((513,), True, P()),
               ((4, 256, 256), True, P(None, "model", None))]  # a tie: the input


@pytest.mark.parametrize("shape,stacked,spec", UNIT_SHAPES)
def test_leaf_axis_matches_leaf_sharding(shape, stacked, spec):
    mesh = make_mesh(8, model_parallel=2)
    assert leaf_sharding(shape, mesh, MIN_DIM, shard_stacked=stacked).spec == spec
    want = next((i for i, s in enumerate(spec) if s == "model"), None)
    assert leaf_axis(shape, 2, MIN_DIM, stacked) == want
    assert leaf_axis(shape, 1, MIN_DIM, stacked) is None


def _flagship(stage: str):
    """(JAX params' shapes, the port's model) of the stage-2 or stage-3
    flagship at 256 px."""
    if stage == "stage2":
        cfg = copy.deepcopy(entry.STAGE2_CFG)
        cfg["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
        jtask, task = JaxMVFexTask(copy.deepcopy(cfg)), MVFexTask(cfg, device="cpu")
        img = np.zeros((1, 4, 3, 256, 256), np.float32)
        init = lambda: jtask.model.init(jax.random.PRNGKey(0), img)  # noqa: E731
    else:
        cfg = copy.deepcopy(entry.FLAGSHIP_CFG)
        cfg["heatmap_mvf_cfg"]["encoder_cfg"]["resnet_cfg"]["use_imagenet_pretrain"] = False
        kw = dict(dataset_type="ego4view_syn_pose3d")
        jtask, task = JaxPose3DTask(copy.deepcopy(cfg), **kw), Pose3DTask(cfg, device="cpu", **kw)
        img = np.zeros((1, 4, 3, 256, 256), np.float32)
        init = lambda: jtask.model.init(jax.random.PRNGKey(0), img, jtask.rig,  # noqa: E731
                                        None, train=False)
    return jax.eval_shape(init)["params"], task.model


@pytest.fixture(scope="module")
def flagships():
    return {s: _flagship(s) for s in ("stage2", "stage3")}


def _jax_placements(shapes, min_dim: int, stacked: bool) -> dict:
    """The JAX package's placements as {port key: torch dim or None}: each
    flax leaf becomes a small marker array, varying only along its sharded
    axis (and keeping a stacked leaf's view axis), which ``from_flax`` lays
    out as the port's tensors."""
    mesh = make_mesh(8, model_parallel=2)
    specs = param_shardings(shapes, mesh, min_dim, stacked)

    def marker(path, leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * (len(leaf.shape) - len(sharding.spec))
        stacked_leaf = any(getattr(k, "key", None) == "refiners" for k in path)
        shape = [leaf.shape[0] if stacked_leaf and i == 0 else 1
                 for i in range(len(leaf.shape))]
        if "model" in spec:
            shape[spec.index("model")] = 2
            return np.broadcast_to(np.arange(2).reshape(
                [2 if s == "model" else 1 for s in spec]), shape)
        return np.zeros(shape)

    markers = jax.tree_util.tree_map_with_path(marker, shapes, specs)
    out = {}
    for k, t in from_flax({"params": markers}).items():
        varying = [d for d in range(t.ndim) if t.shape[d] == 2 and bool(
            (t.narrow(d, 0, 1) != t.narrow(d, 1, 1)).any())]
        assert len(varying) <= 1, k
        out[k] = varying[0] if varying else None
    return out


@pytest.mark.parametrize("stage", ["stage2", "stage3"])
@pytest.mark.parametrize("min_dim", [256, 2048])
@pytest.mark.parametrize("stacked", [True, False])
def test_placements_match_param_shardings(flagships, stage, min_dim, stacked):
    shapes, model = flagships[stage]
    want = _jax_placements(shapes, min_dim, stacked)
    got = param_placements(model, 2, min_dim, stacked)
    assert sorted(got) == sorted(want)
    assert got == want
    sharded = {k for k, d in got.items() if d is not None}
    # Stage 2's only leaf of 2048 or more is the stacked heatmap projection.
    assert bool(sharded) == (stage == "stage3" or min_dim == 256 or stacked)
    if stage == "stage3" and min_dim == 2048:
        # the proposal MLP's 32768 x 2048 and 2048 x 128 kernels: their input
        assert got["pose3d_estimator.mlp_pred_0.weight"] == 1
        assert got["pose3d_estimator.mlp_pred_1.weight"] == 1
    if min_dim == 2048:  # the JQA heatmap projections (V, 4096, 256): input
        d = got["heatmap_estimator.refiners.0.heatmap_proj_0.weight"
                if stage == "stage3" else "refiners.0.heatmap_proj_0.weight"]
        assert d == (1 if stacked else None)


# -- the groups ------------------------------------------------------------------


def _jax_step(jtask, v, batch, task_name) -> dict:
    """JAX's fp64 step from ``v`` on ``batch`` at ``gradient_clip_val``
    CLIP: the clipped gradients, the optax update's parameters, the BN
    running stats, the loss terms, lr, and the gradients' norm."""
    params, batch64 = _f64(v["params"]), _f64(batch)
    extra = {"batch_stats": _f64(v["batch_stats"])}
    stage3 = task_name == "pose_3d_mvf_ex"
    with jax.enable_x64(True):
        (_, (terms, mutated)), grads = jax.jit(jax.value_and_grad(
            lambda p, ev, b: jtask.loss(p, ev, b, True), has_aux=True))(
            params, extra, batch64)
        tx, schedule = jax_make_optimizer(LR, WD[task_name], WARMUP, DECAY_EPOCHS, 1,
                                          grad_clip_norm=CLIP, no_decay_mask=stage3,
                                          params=params)
        updates, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(grads, params)
        new = jax.tree.map(lambda p, u: p + u, params, updates)
        lr = float(schedule(0))
    grads = from_flax({"params": jax.device_get(grads)})
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values())))
    clip = min(1.0, CLIP / norm)
    return dict(grads={k: g * clip for k, g in grads.items()},
                params=from_flax({"params": jax.device_get(new)}),
                stats=from_flax({"batch_stats": jax.device_get(mutated["batch_stats"])}),
                terms={k: float(t) for k, t in jax.device_get(terms).items()}, lr=lr,
                norm=norm)


def _spec(case: str, tmp) -> tuple:
    """(JAX task, variables, batch, the port's one-process spec) of a STEPS
    case, its start state written under ``tmp``."""
    task_name, V, camera_model, seed = STEPS[case]
    cfg = (_mvfex_cfg(V) if task_name == "heatmap_mvf_ex"
           else _cascade_cfg(V, camera_model))
    jtask, v, batch, task = step_case(task_name, cfg, seed, camera_model)
    path = str(tmp / f"{case}_start.pt")
    torch.save(task.model.state_dict(), path)
    kw = {} if task_name == "heatmap_mvf_ex" else dict(dataset_type="ego4view_syn_pose3d")
    spec = dict(task=task_name, cfg=copy.deepcopy(cfg), kw=kw, state=path, batch=batch,
                batch_size=len(batch["img"]), lr=LR, wd=WD[task_name],
                decay=DECAY_EPOCHS, warmup=WARMUP, fp64=True, clip=CLIP)
    return jtask, v, batch, spec


def _tp(spec: dict, M: int, stacked: bool, **kw) -> dict:
    return dict(spec, parallel=dict(model_parallel=M, tp_min_dim=MIN_DIM,
                                    tp_shard_stacked=stacked, **kw))


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The 2- and 4-rank groups' results, the JAX references and the
    one-process port steps."""
    tmp = tmp_path_factory.mktemp("tp")
    cases = {c: _spec(c, tmp) for c in ("stage3_v2_syn", "stage2_v2")}
    plans = {2: dict(layers=True, out=str(tmp / "two"), steps={}),
             4: dict(out=str(tmp / "four"), steps={}, shrink=True)}
    for name, (case, (D, M), stacked) in TP_STEPS.items():
        plans[D * M]["steps"][name] = _tp(cases[case][3], M, stacked)
    s3 = plans[2]["steps"]["stage3_1x2"]
    plans[2]["steps"]["stage3_1x2_remat"] = dict(s3, parallel=dict(s3["parallel"],
                                                                   remat=True))
    plans[2]["checkpoint"] = s3
    for p in plans.values():
        os.makedirs(p["out"])
    with cf.ThreadPoolExecutor(2) as pool:
        groups = {n: pool.submit(dist.spawn, tp_ranks.ranks, n, p)
                  for n, p in plans.items()}
        jax_steps = {c: _jax_step(jtask, v, batch, spec["task"])
                     for c, (jtask, v, batch, spec) in cases.items()}
        one = {}
        for c, (*_, spec) in cases.items():
            _, trainer = tp_ranks.build(spec)
            one[c] = tp_ranks.take_step(spec, trainer)
        net, x, fmap, ups = tp_ranks.layer_case()
        one_layers = tp_ranks.layer_pass(net, x, fmap, ups)
        groups = {n: g.result() for n, g in groups.items()}
    files = {name: torch.load(groups[len(r)][0]["steps"][name]["file"], weights_only=False)
             for r in groups.values() for name in r[0]["steps"]}
    return dict(groups=groups, files=files, jax=jax_steps, one=one,
                one_layers=one_layers, cases=cases)


def test_layers_match_unsharded(tp):
    """Row- and column-parallel Linears and PointwiseConvs and gathered
    leaves on 2 ranks, fp64: each rank's outputs, input gradients and
    (gathered) parameter gradients within LAYER_TOL of the unsharded
    modules; each rank holds half of every sharded leaf."""
    want = tp["one_layers"]
    for r in (0, 1):
        got = tp["groups"][2][r]["layers"]
        assert got["placements"] == tp_ranks.LAYER_PLACEMENTS
        for k, d in got["placements"].items():
            assert got["slices"][k][d] * 2 == want["slices"][k][d], k
        for g, w in zip(got["outs"] + [got["dx"], got["dfmap"]],
                        want["outs"] + [want["dx"], want["dfmap"]]):
            torch.testing.assert_close(g, w, rtol=0, atol=LAYER_TOL * float(w.abs().max()))
        assert sorted(got["grads"]) == sorted(want["grads"])
        for k, w in want["grads"].items():
            torch.testing.assert_close(got["grads"][k], w, rtol=0,
                                       atol=LAYER_TOL * float(w.abs().max()), msg=k)


def _case(name: str) -> str:
    return TP_STEPS[name][0] if name in TP_STEPS else "stage3_v2_syn"


@pytest.mark.parametrize("name", sorted(TP_STEPS))
def test_tp_step_matches_one_process(tp, name):
    """Rank 0's step (sharded leaves gathered) vs the port's one-process
    step on the global batch: gradients within ONE_PROCESS_GRAD_TOL of
    scale in fp64 (the position tables within FP32_SUM_TOL), BN running
    stats within BN_TOL64, the loss terms within fp32 rounding."""
    case = TP_STEPS[name][0]
    assert tp["jax"][case]["norm"] > 20 * CLIP  # clipping engaged
    got, want = tp["files"][name], tp["one"][case]
    worst = _hold(got, want, tp["jax"][case]["lr"], ONE_PROCESS_GRAD_TOL,
                  dict.fromkeys(FP32_SUM_LEAVES, FP32_SUM_TOL))
    for k, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], w, atol=BN_TOL64, rtol=BN_TOL64,
                                   err_msg=k)
    D, M = TP_STEPS[name][1]
    rank0 = tp["groups"][D * M][0]["steps"][name]
    for k, w in want["metrics"].items():
        assert abs(rank0["metrics"][k] - w) <= TERM_RTOL * abs(w), k
    print(f"{name}: vs one process, worst leaf gradient {worst:.3e} of scale")


@pytest.mark.parametrize("name", sorted(TP_STEPS))
def test_tp_step_matches_jax(tp, name):
    """Rank 0's step vs JAX's one-device step on the global batch, at
    JAX_GRAD_TOL of each leaf's scale."""
    case = TP_STEPS[name][0]
    got, want = tp["files"][name], tp["jax"][case]
    worst = _hold(got, want, want["lr"], JAX_GRAD_TOL)
    for k, w in want["stats"].items():
        if "running" in k:
            np.testing.assert_allclose(got["stats"][k], w.numpy(), atol=BN_TOL64,
                                       rtol=BN_TOL64, err_msg=k)
    D, M = TP_STEPS[name][1]
    terms = tp["groups"][D * M][0]["steps"][name]["metrics"]
    for k, w in want["terms"].items():
        assert abs(terms[k] - w) <= TERM_RTOL * abs(w), (k, terms[k], w)
    print(f"{name}: vs JAX, worst leaf gradient {worst:.3e} of scale")


@pytest.mark.parametrize("name", sorted(TP_STEPS))
def test_replicas_and_slices_agree_across_the_grid(tp, name):
    """Every replicated leaf bitwise the same on every rank; each rank's
    slices the same as its data group's (the ranks of one model index);
    the grid is (d, m) = (r // M, r % M); the model ranks hold different
    slices; the expected leaves are sharded."""
    (D, M), stacked = TP_STEPS[name][1:]
    res = [r["steps"][name] for r in tp["groups"][D * M]]
    assert [r["grid"] for r in res] == [(i // M, D, i % M, M) for i in range(D * M)]
    assert len({r["replicated"] for r in res}) == 1
    for m in range(M):
        assert len({res[d * M + m]["slices"] for d in range(D)}) == 1
    assert len({res[m]["slices"] for m in range(M)}) == M
    dims = res[0]["placements"]
    stage3 = TP_STEPS[name][0].startswith("stage3")
    prefix = "heatmap_estimator.refiners.0." if stage3 else "refiners.0."
    # JQA's heatmap projection (V, 256, 256) at 64 px: stacked, a tie, the
    # input; its stacked bias (V, 256) is 2-D and shards whatever the flag.
    assert dims.get(prefix + "heatmap_proj_0.weight") == (1 if stacked else None)
    assert dims[prefix + "heatmap_proj_0.bias"] == 0
    assert (prefix + "joint_query_embed" in dims) == stacked
    if stage3:  # the lifter's FFN (128 -> 512 -> 128): column-, then row-parallel
        assert dims["pose3d_estimator.transformer_0.ffn.Dense_0.weight"] == 0
        assert dims["pose3d_estimator.transformer_0.ffn.Dense_1.weight"] == 1
        assert dims["pose3d_estimator.mlp_pred_0.weight"] == 1


def test_grid_shrinks_over_the_data_axis_only(tp):
    assert [r["shrink"] for r in tp["groups"][4]] == [
        (0, 1, True, 0, 2), (0, 1, True, 1, 2), (0, 1, False, 0, 2), (0, 1, False, 0, 2)]


def test_remat_under_tp_is_the_plain_step(tp):
    two = tp["groups"][2]
    for r in two:
        plain, remat = r["steps"]["stage3_1x2"], r["steps"]["stage3_1x2_remat"]
        assert remat["replicated"] == plain["replicated"]
        assert remat["slices"] == plain["slices"]
        assert remat["metrics"] == plain["metrics"]
    got, want = tp["files"]["stage3_1x2_remat"], tp["files"]["stage3_1x2"]
    for part in ("grads", "params", "stats"):
        for k, w in want[part].items():
            np.testing.assert_array_equal(got[part][k], w, err_msg=k)


def test_checkpoint_is_the_one_process_format(tp):
    """The sharded trainer's ``epoch=0.pt`` (rank 0's, after one step) loads
    into a one-process trainer with its keys and shapes, every leaf bitwise
    the gathered state; it loads back into the sharded trainers bitwise and
    ``auto_resume`` restores their slices without a step."""
    two = tp["groups"][2]
    spec = tp["cases"]["stage3_v2_syn"][3]
    state = ckpt_lib.restore(two[0]["ckpt"])
    _, trainer = tp_ranks.build(spec)
    want_model = trainer.task.model.state_dict()
    assert sorted(state["model"]) == sorted(want_model)
    for k, v in want_model.items():
        assert state["model"][k].shape == v.shape, k
    stepped = tp["files"]["stage3_1x2"]
    for k, w in stepped["params"].items():
        np.testing.assert_array_equal(state["model"][k].numpy(), w, err_msg=k)
    want_opt = trainer.optimizer.state_dict()
    trainer.load_state_dict(state)  # strict, with the one process's shapes
    assert sorted(trainer.optimizer.state_dict()["state"]) == sorted(state["optimizer"]["state"])
    assert len(state["optimizer"]["param_groups"]) == len(want_opt["param_groups"])
    assert state["step"] == trainer.step == 1
    for r in two:
        assert r["loaded_bitwise"]
        assert r["resumed"] == dict(step=1, bitwise=True)
    assert tensor.placements(trainer.task.model) == {}
