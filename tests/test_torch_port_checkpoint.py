"""The port's ImageNet initialisation, checkpoints and stage grafts held
against the JAX package on the CPU, at 64 px:

  * ``convert_torchvision_resnet18`` vs ``from_flax`` of the JAX converter on
    a random state dict in torchvision's key layout, bitwise; the graft into
    the backbones of each task; the weights' lookup order and its failures;
  * ``save``/``restore``/``restore_latest`` round trips, bitwise;
    ``prune_to_structure``; every graft of ``PRETRAINED_GRAFTS`` vs
    ``from_flax`` of JAX's ``ckpt_lib.graft`` on the same weights, bitwise;
    the trainer's next step after a graft.

Nothing is downloaded: the "ImageNet" weights are seeded random tensors.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egorear_tpu.train import checkpoint as jax_ckpt
from egorear_tpu.train.tasks import HeatmapTask as JaxHeatmapTask
from egorear_tpu.train.tasks import MVFexTask as JaxMVFexTask
from egorear_tpu.train.tasks import Pose3DTask as JaxPose3DTask
from egorear_tpu.train.torch_convert import (
    convert_torchvision_resnet18 as jax_convert_torchvision,
)
import chip_smoke
from egorear_tpu_torch import entry
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.models.backbone import ResNet18
from egorear_tpu_torch.train import checkpoint, imagenet
from egorear_tpu_torch.train.tasks import TASKS, HeatmapTask, MVFexTask, Pose3DTask
from test_imagenet_pretrain import _torchvision_style_sd
from test_torch_port_models import random_variables

SIZE, B = 64, 2
ENV = imagenet.ENV_VAR


def _stage_cfg(name: str, imagenet_on: bool) -> dict:
    if name == "heatmap":
        cfg = copy.deepcopy(entry.STAGE1_CFG)
        enc = cfg["encoder_cfg"]
    elif name == "heatmap_mvf_ex":
        cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[SIZE, SIZE]))
        enc = cfg["encoder_cfg"]
    else:
        cfg = entry.flagship_cfg_dict((SIZE, SIZE))
        enc = cfg["heatmap_mvf_cfg"]["encoder_cfg"]
    enc["resnet_cfg"]["use_imagenet_pretrain"] = imagenet_on
    return cfg



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's small CPU ops: alone this file
    runs as fast with it, and under xdist, where several files share a few
    cores, idle-spinning torch threads would starve the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def tv():
    """A random torchvision-layout ResNet-18 state dict (numpy arrays)."""
    sd, _ = _torchvision_style_sd(seed=4)
    return sd


def _npz(path, sd):
    np.savez(path, **sd)
    return str(path)


# -- ImageNet ------------------------------------------------------------------


def test_convert_torchvision_resnet18_matches_jax_bitwise(tv):
    got = imagenet.convert_torchvision_resnet18(tv)
    want = {k: v for k, v in from_flax(jax_convert_torchvision(tv)).items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    assert not any(k.startswith("fc.") for k in got)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    # Every leaf of the port's ResNet-18 but the BN counters.
    target = {k for k in ResNet18().state_dict() if "num_batches" not in k}
    assert set(got) == target


@pytest.mark.parametrize("name,n", [("heatmap", 1), ("heatmap_mvf_ex", 2),
                                    ("pose_3d_mvf_ex", 2)])
def test_imagenet_graft_fills_every_backbone(tv, tmp_path, monkeypatch, name, n):
    """The task with the flag on: every ``encoder.resnet`` leaf equals the
    file's, bitwise; every other leaf and the BN counters equal the seeded
    initialisation without the flag. The graft counts 1, 2 and 2 backbones."""
    monkeypatch.setenv(ENV, _npz(tmp_path / "w.npz", tv))
    weights = imagenet.convert_torchvision_resnet18(tv)
    task = TASKS[name](_stage_cfg(name, True), device="cpu", seed=7)
    plain = TASKS[name](_stage_cfg(name, False), device="cpu", seed=7)
    got, base = task.model.state_dict(), plain.model.state_dict()
    n_resnet = 0
    for k, v in got.items():
        if ".resnet." in f".{k}" and "num_batches" not in k:
            sub = k.split("resnet.", 1)[1]
            assert torch.equal(v, weights[sub]), k
            n_resnet += 1
        else:
            assert torch.equal(v, base[k]), k
    assert n_resnet == n * len(weights)
    assert imagenet.graft_imagenet_backbones(plain.model, weights) == n


def test_imagenet_lookup_order(tv, tmp_path, monkeypatch):
    """An explicit path, then the environment, then the hub cache under
    ``HOME``; ``.pth`` and ``.npz``; none of them: FileNotFoundError."""
    home = tmp_path / "home"
    hub = home / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv(ENV, raising=False)
    sds = [dict(tv, **{"conv1.weight": tv["conv1.weight"] + i}) for i in range(3)]

    def which(out):
        d = out["conv1.weight"] - torch.from_numpy(tv["conv1.weight"])
        return int(torch.round(d.mean()))

    with pytest.raises(FileNotFoundError, match="use_imagenet_pretrain"):
        imagenet.load_imagenet_resnet18()
    torch.save({k: torch.from_numpy(v) for k, v in sds[2].items()},
               hub / "resnet18-f37072fd.pth")
    assert which(imagenet.load_imagenet_resnet18()) == 2
    env = _npz(tmp_path / "env.npz", sds[1])
    monkeypatch.setenv(ENV, env)
    assert which(imagenet.load_imagenet_resnet18()) == 1
    path = tmp_path / "explicit.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sds[0].items()}},
               path)
    assert which(imagenet.load_imagenet_resnet18(str(path))) == 0
    # A path that does not exist falls through to the next candidate.
    assert which(imagenet.load_imagenet_resnet18(str(tmp_path / "no.pth"))) == 1
    monkeypatch.setenv(ENV, str(tmp_path / "missing.npz"))
    assert which(imagenet.load_imagenet_resnet18()) == 2


def test_imagenet_refuses_unknown_keys_and_shapes(tv, tmp_path, monkeypatch):
    with pytest.raises(KeyError, match="layer5"):
        imagenet.convert_torchvision_resnet18(dict(tv, **{"layer5.0.conv1.weight": 0}))
    with pytest.raises(KeyError):
        imagenet.convert_torchvision_resnet18(dict(tv, **{"conv1.scale": 0}))
    weights = imagenet.convert_torchvision_resnet18(tv)
    model = HeatmapTask(_stage_cfg("heatmap", False), device="cpu").model
    bad = dict(weights, **{"conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(ValueError, match="shape mismatch conv1.weight"):
        imagenet.graft_imagenet_backbones(model, bad)
    missing = {k: v for k, v in weights.items() if k != "bn1.running_var"}
    with pytest.raises(ValueError, match="missing bn1.running_var"):
        imagenet.graft_imagenet_backbones(model, missing)
    with pytest.raises(ValueError, match="no encoder.resnet"):
        imagenet.graft_imagenet_backbones(model.conv_heatmap, weights)
    # Through a task: the shape mismatch from a file.
    bad_tv = dict(tv, **{"fc.weight": tv["conv1.weight"]})  # dropped: fine
    bad_tv["layer1.0.conv1.weight"] = np.zeros((64, 64, 1, 1), np.float32)
    monkeypatch.setenv(ENV, _npz(tmp_path / "bad.npz", bad_tv))
    with pytest.raises(ValueError, match="layer1_0.conv1.weight"):
        HeatmapTask(_stage_cfg("heatmap", True), device="cpu")


# -- checkpoints -------------------------------------------------------------------


def _batch(V: int, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"img": torch.randn(B, V, 3, SIZE, SIZE, generator=g),
            "gt_heatmap": torch.rand(B, V, 15, SIZE // 4, SIZE // 4, generator=g)}


def _state_equal(a, b) -> bool:
    """Bitwise equality of two nested state dicts."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str)
                and all(_state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_checkpoint_round_trips_bitwise(tmp_path):
    """Two steps, save, restore into a fresh trainer: model, optimizer state
    and step are bitwise equal, and the next step is too."""
    task, trainer = entry.build_stage1("cpu", steps_per_epoch=10, imagenet=False,
                                       warmup_iters=2)
    batch = _batch(2)
    for _ in range(2):
        trainer.train_step(batch)
    path = checkpoint.save(str(tmp_path / "ckpts"), 3, trainer.state_dict())
    assert path.endswith("epoch=3.pt")
    state = checkpoint.restore(path[:-3], map_location="cpu")
    assert state["epoch"] == 3 and state["step"] == 2
    task2, trainer2 = entry.build_stage1("cpu", seed=1, steps_per_epoch=10,
                                         imagenet=False, warmup_iters=2)
    assert not _state_equal(task2.model.state_dict(), task.model.state_dict())
    trainer2.load_state_dict(state)
    assert trainer2.step == 2
    assert _state_equal(trainer2.state_dict(), trainer.state_dict())
    trainer.train_step(batch)
    trainer2.train_step(batch)
    assert _state_equal(trainer2.state_dict(), trainer.state_dict())
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "ckpts" / "epoch=4"))


def test_restore_latest_picks_the_highest_epoch(tmp_path):
    d = tmp_path / "ckpts"
    assert checkpoint.restore_latest(str(d)) == (None, -1)
    d.mkdir()
    (d / "epoch=99.pt.tmp").write_bytes(b"")
    (d / "last.pt").write_bytes(b"")
    assert checkpoint.restore_latest(str(d)) == (None, -1)
    for epoch in (2, 10, 9):
        checkpoint.save(str(d), epoch, {"model": {"w": torch.full((2,), epoch)},
                                        "optimizer": {}, "step": epoch})
    state, epoch = checkpoint.restore_latest(str(d))
    assert epoch == 10 and state["step"] == 10
    assert torch.equal(state["model"]["w"], torch.full((2,), 10))


def test_prune_to_structure_drops_the_stage1_head(tmp_path):
    stage1 = HeatmapTask(_stage_cfg("heatmap", False), device="cpu").model.state_dict()
    stage2 = MVFexTask(_stage_cfg("heatmap_mvf_ex", False), device="cpu").model
    target = checkpoint.sub_state(stage2.state_dict(), "heatmap_estimator_stereo_front")
    pruned = checkpoint.prune_to_structure(target, stage1)
    assert sorted(pruned) == sorted(target)
    assert {k for k in stage1 if k not in pruned} == {"conv_heatmap.weight",
                                                     "conv_heatmap.bias"}
    short = {k: v for k, v in stage1.items() if k != "encoder.fpn.fpn_0.bias"}
    with pytest.raises(ValueError, match="encoder.fpn.fpn_0.bias"):
        checkpoint.prune_to_structure(target, short)
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.graft(stage2.state_dict(), "heatmap_estimator_stereo_front",
                         dict(pruned, **{"encoder.fpn.fpn_0.bias": torch.zeros(3)}))
    # An EgoRear .ckpt is imported strictly: its stage-1 head, which the
    # stage-2 estimator lacks, is refused, as the JAX package refuses it.
    ckpt = chip_smoke.write_egorear_ckpt(str(tmp_path / "stage1.ckpt"), stage1,
                                         "heatmap")
    jtask = JaxMVFexTask(_stage_cfg("heatmap_mvf_ex", False))
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 3, SIZE, SIZE)), train=False))
    front = {c: shapes[c]["heatmap_estimator_stereo_front"] for c in shapes}
    with pytest.raises(ValueError, match="extra /params/conv_heatmap"):
        jax_ckpt.load_pretrained(ckpt, front, "heatmap")
    with pytest.raises(ValueError, match="extra conv_heatmap.weight"):
        checkpoint.load_pretrained(ckpt, target, "heatmap")


# -- the stage grafts -------------------------------------------------------------


@pytest.fixture(scope="module")
def stage_vars():
    """Random flax variables of each stage's JAX model at 64 px, distinct
    seeds, and the port's checkpoint of each (saved from a model loaded with
    them)."""
    imgs = {n: jnp.zeros((1, 2 if n == "heatmap" else 4, 3, SIZE, SIZE))
            for n in ("heatmap", "heatmap_mvf_ex", "pose_3d_mvf_ex")}
    jtasks = {"heatmap": JaxHeatmapTask(_stage_cfg("heatmap", False)),
              "heatmap_mvf_ex": JaxMVFexTask(_stage_cfg("heatmap_mvf_ex", False)),
              "pose_3d_mvf_ex": JaxPose3DTask(_stage_cfg("pose_3d_mvf_ex", False))}
    out = {}
    for i, (n, jt) in enumerate(jtasks.items()):
        args = (jt.rig, None) if n == "pose_3d_mvf_ex" else ()
        shapes = jax.eval_shape(lambda jt=jt, n=n, args=args: jt.model.init(
            jax.random.PRNGKey(0), imgs[n], *args, train=False))
        out[n] = random_variables(shapes, np.random.default_rng(30 + i))
    return out


def _port_model(name, variables):
    task = TASKS[name](_stage_cfg(name, False), device="cpu")
    load_flax(task.model, variables)
    return task


def _save_port(tmp_path, name, variables, tag):
    task = _port_model(name, variables)
    return checkpoint.save(str(tmp_path / tag), 11,
                           {"model": task.model.state_dict(), "optimizer": {},
                            "step": 0})


def _jax_graft(base: dict, path: str, src: dict) -> dict:
    """JAX's ``run.apply_pretrained`` on variable trees: prune ``src`` to the
    target subtree, graft params and batch stats."""
    params, stats = base["params"], base["batch_stats"]
    tp, ts = params, stats
    for p in [p for p in path.split("/") if p]:
        tp, ts = tp[p], ts[p]
    loaded = jax_ckpt.prune_to_structure({"params": tp, "batch_stats": ts}, src)
    if not path:
        return loaded
    return {"params": jax_ckpt.graft(params, path, loaded["params"]),
            "batch_stats": jax_ckpt.graft(stats, path, loaded["batch_stats"])}


@pytest.mark.parametrize("key,target,source", [
    ("heatmap_estimator_pretrained_stereo_front", "heatmap_mvf_ex", "heatmap"),
    ("heatmap_estimator_pretrained_stereo_back", "heatmap_mvf_ex", "heatmap"),
    ("heatmap_estimator_mvf_pretrained", "pose_3d_mvf_ex", "heatmap_mvf_ex"),
    ("network_pretrained", "heatmap_mvf_ex", "heatmap_mvf_ex"),
])
def test_stage_graft_matches_jax_bitwise(stage_vars, tmp_path, key, target, source):
    src_vars = stage_vars[source]
    if key == "network_pretrained":  # a second stage-2 network
        src_vars = jax.tree.map(lambda x: x + 1.0, src_vars)
    ckpt = _save_port(tmp_path, source, src_vars, "src")
    task = _port_model(target, stage_vars[target])
    assert checkpoint.apply_pretrained(task.model, task.name, {key: ckpt}) == [key]
    path = checkpoint.PRETRAINED_GRAFTS[key][0].replace(".", "/")
    want = from_flax(_jax_graft(stage_vars[target], path, src_vars))
    got, before = task.model.state_dict(), from_flax(stage_vars[target])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    assert any(not torch.equal(w, before[k]) for k, w in want.items())


def test_trainer_steps_on_the_grafted_values(stage_vars, tmp_path):
    """A graft after the trainer's state exists copies into the model's own
    parameters: the optimizer still holds them, its moments are kept, and
    the next step starts from the grafted values (the same step as a
    trainer built on a model that held them from the start)."""
    front = _save_port(tmp_path, "heatmap", stage_vars["heatmap"], "front")
    cfg = _stage_cfg("heatmap_mvf_ex", False)
    batch = _batch(4, seed=3)
    task, trainer = entry.build_stage2((SIZE, SIZE), "cpu", steps_per_epoch=10,
                                       imagenet=False, warmup_iters=2)
    trainer.train_step(batch)
    params = list(task.model.parameters())
    moments = {id(p): s["exp_avg"].clone() for p, s in trainer.optimizer.state.items()}
    checkpoint.apply_pretrained(task.model, task.name,
                                {"heatmap_estimator_pretrained_stereo_front": front})
    opt_params = [p for g in trainer.optimizer.param_groups for p in g["params"]]
    assert {id(p) for p in opt_params} == {id(p) for p in params}
    assert all(torch.equal(s["exp_avg"], moments[id(p)])
               for p, s in trainer.optimizer.state.items())
    grafted = copy.deepcopy(task.model.state_dict())
    want_front = checkpoint.restore(front)["model"]
    for k, v in checkpoint.sub_state(grafted, "heatmap_estimator_stereo_front").items():
        assert torch.equal(v, want_front[k]), k

    # The same step from the same state: model and optimizer loaded.
    twin = MVFexTask(cfg, device="cpu", seed=5)
    twin_trainer = type(trainer)(twin, **{k: getattr(trainer, k) for k in (
        "lr", "weight_decay", "lr_decay_epochs", "warmup_iters", "precision",
        "gradient_clip_val", "no_decay_mask", "encoder_lr_scale")})
    twin_trainer.init_state(steps_per_epoch=10)
    twin_trainer.load_state_dict(copy.deepcopy(trainer.state_dict()))
    trainer.train_step(batch)
    twin_trainer.train_step(batch)
    assert _state_equal(task.model.state_dict(), twin.model.state_dict())
    moved = checkpoint.sub_state(task.model.state_dict(), "heatmap_estimator_stereo_front")
    k = "encoder.fpn.fpn_0.weight"
    assert not torch.equal(moved[k], grafted["heatmap_estimator_stereo_front." + k])


def test_stage_build_functions_chain_the_grafts(stage_vars, tmp_path, tv,
                                                monkeypatch):
    """``entry``'s build functions as the yamls chain them: stage 2 from two
    stage-1 checkpoints, stage 3 from the stage-2 checkpoint, each with the
    ImageNet flag on; the grafted leaves are the checkpoints', bitwise."""
    monkeypatch.setenv(ENV, _npz(tmp_path / "w.npz", tv))
    front = _save_port(tmp_path, "heatmap", stage_vars["heatmap"], "front")
    back = _save_port(tmp_path, "heatmap",
                      jax.tree.map(lambda x: x * 0.5, stage_vars["heatmap"]), "back")
    task2, trainer2 = entry.build_stage2((SIZE, SIZE), "cpu", steps_per_epoch=10,
                                         pretrained={
        "heatmap_estimator_pretrained_stereo_front": front,
        "heatmap_estimator_pretrained_stereo_back": back})
    sd2 = task2.model.state_dict()
    for pair, ckpt in (("front", front), ("back", back)):
        want = checkpoint.restore(ckpt)["model"]
        got = checkpoint.sub_state(sd2, f"heatmap_estimator_stereo_{pair}")
        assert sorted(got) == sorted(k for k in want if "conv_heatmap" not in k)
        assert all(torch.equal(v, want[k]) for k, v in got.items())
    s2 = checkpoint.save(str(tmp_path / "stage2"), 11, trainer2.state_dict())
    task3, _ = entry.build_train((SIZE, SIZE), "cpu", "32", steps_per_epoch=10,
                                 pretrained={"heatmap_estimator_mvf_pretrained": s2})
    got = checkpoint.sub_state(task3.model.state_dict(), "heatmap_estimator")
    assert sorted(got) == sorted(sd2)
    assert all(torch.equal(v, sd2[k]) for k, v in got.items())
    assert isinstance(task3, Pose3DTask)
