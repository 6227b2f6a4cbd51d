"""The import of EgoRear's own Lightning ``.ckpt`` files held against the
JAX package's converter on the CPU.

No EgoRear checkpoint is in the repository, so a stand-in is written:
``chip_smoke.write_egorear_ckpt`` puts a port state dict under EgoRear's
module paths and layouts. First the writer is held to the JAX package's key
grammar: for each task (``heatmap``, ``heatmap_mvf_ex``, ``pose_3d_mvf_ex``)
at V = 2 and 4 and with the ``network._orig_mod.`` or ``module.`` prefix,
JAX's ``convert_lightning_ckpt`` accepts the file strictly and ``from_flax``
of its result gives back the state dict bitwise. Then the port's import
(``train/torch_convert.py``) is held bitwise to ``from_flax`` of JAX's
conversion, and a missing, an extra, a misshapen and an unknown key are
refused by both. The port reads a file weights-only: an object in it whose
unpickling would call a function calls nothing. The stage grafts and ``run.load_eval_ckpt`` take the
files as JAX's ``run.py`` does, and the CLI ``test`` of the V = 2
real-world yaml from a ``.ckpt`` matches JAX's ``run.main`` to 1e-4
relative. Last, ``fit`` of the V = 2 stage-2 yaml writes the metric
columns the JAX task emits.
"""

from __future__ import annotations

import copy
import csv
import io
import contextlib
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from egorear_tpu.train import checkpoint as jax_ckpt
from egorear_tpu.train.tasks import TASKS as JAX_TASKS
from egorear_tpu.train.torch_convert import convert_lightning_ckpt
from egorear_tpu.train.trainer import CSVLogger as JaxCSVLogger
from egorear_tpu_torch import entry, run
from egorear_tpu_torch.convert import from_flax, load_flax
from egorear_tpu_torch.data.synthetic import make_synthetic_dataset
from egorear_tpu_torch.train import checkpoint
from egorear_tpu_torch.train.tasks import TASKS
from egorear_tpu_torch.train.torch_convert import (
    import_lightning_ckpt,
    read_lightning_state_dict,
)
from test_torch_port_models import random_variables

SIZE = 64
METRIC_RTOL = 1e-4
CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
CASES = [("heatmap", 2), ("heatmap_mvf_ex", 2), ("heatmap_mvf_ex", 4),
         ("pose_3d_mvf_ex", 2), ("pose_3d_mvf_ex", 4)]
PREFIXES = ["network._orig_mod.", "module."]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(task: str, V: int) -> dict:
    """The task's config at 64 px with V views (stage 1: one pair)."""
    if task == "heatmap":
        cfg = copy.deepcopy(entry.STAGE1_CFG)
        enc = cfg["encoder_cfg"]
    elif task == "heatmap_mvf_ex":
        cfg = copy.deepcopy(dict(entry.STAGE2_CFG, image_size=[SIZE, SIZE],
                                 num_views=V))
        enc = cfg["encoder_cfg"]
    else:
        cfg = copy.deepcopy(dict(entry.FLAGSHIP_CFG, image_size=[SIZE, SIZE],
                                 num_views=V, camera_model="ego4view_syn"
                                 + ("_stereo_front" if V == 2 else "")))
        enc = cfg["heatmap_mvf_cfg"]["encoder_cfg"]
    enc["resnet_cfg"]["use_imagenet_pretrain"] = False
    return cfg


@pytest.fixture(scope="module")
def models():
    """{(task, V): (JAX variables' shapes, random variables, the port's
    state dict of them)}: every leaf random, so that a swapped or
    transposed leaf shows."""
    out = {}
    for i, (task, V) in enumerate(CASES):
        jtask = JAX_TASKS[task](_cfg(task, V))
        img = jnp.zeros((1, 2 if task == "heatmap" else V, 3, SIZE, SIZE))
        args = (jtask.rig, None) if task == "pose_3d_mvf_ex" else ()
        shapes = jax.eval_shape(lambda jtask=jtask, img=img, args=args: jtask.model.init(
            jax.random.PRNGKey(0), img, *args, train=False))
        variables = random_variables(shapes, np.random.default_rng(60 + i))
        out[task, V] = (shapes, variables, from_flax(variables))
    return out


def _ids(cases):
    return [f"{t}-V{v}" for t, v in cases]


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("task,V", CASES, ids=_ids(CASES))
def test_writer_is_the_inverse_of_jax_grammar(models, tmp_path, task, V, prefix):
    shapes, _, sd = models[task, V]
    path = chip_smoke.write_egorear_ckpt(str(tmp_path / "x.ckpt"), sd, task, prefix)
    raw = torch.load(path, weights_only=True)["state_dict"]
    assert all(k.startswith(prefix) for k in raw) and len(raw) == len(sd)
    got = from_flax(convert_lightning_ckpt(path, shapes, task))
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("task,V", CASES, ids=_ids(CASES))
def test_import_matches_jax_converter_bitwise(models, tmp_path, task, V):
    shapes, _, sd = models[task, V]
    path = chip_smoke.write_egorear_ckpt(str(tmp_path / "x.ckpt"), sd, task)
    want = from_flax(convert_lightning_ckpt(path, shapes, task))
    # The target is the port's own model (its seeded init), as the graft
    # and run.load_eval_ckpt give it.
    target = TASKS[task](_cfg(task, V), device="cpu").model.state_dict()
    assert sorted(target) == sorted(sd)
    got = import_lightning_ckpt(path, target, task)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "uneven", "unknown"])
def test_import_refuses_what_jax_refuses(models, tmp_path, fault):
    """A stage-2 checkpoint (V = 4) with a key dropped, keys the model lacks
    (each refiner's ``query_pos_embed``), a leaf of another shape, one
    refiner's leaf dropped (the refiners no longer stack) or a key outside
    the grammar: JAX's converter and the port's import raise the same
    error, each in its own names (JAX's flax paths, the port's state-dict
    keys)."""
    shapes, _, sd = models["heatmap_mvf_ex", 4]
    path = chip_smoke.write_egorear_ckpt(str(tmp_path / "x.ckpt"), sd,
                                         "heatmap_mvf_ex", prefix="")
    ref = torch.load(path, weights_only=True)["state_dict"]
    head = "conv_heatmap_layers_stereo_back.9."
    if fault == "missing":
        del ref[head + "bias"]
        err, match = ValueError, ("missing /params/conv_heatmap_head_back/Conv_4/bias",
                                  "missing conv_heatmap_head_back.Conv_4.bias")
    elif fault == "extra":
        for r in chip_smoke.EGOREAR_REFINERS:
            ref[f"{r}.query_pos_embed"] = torch.zeros(15, 256)
        err, match = ValueError, ("extra /params/refiners/query_pos_embed",
                                  "extra refiners.3.query_pos_embed")
    elif fault == "shape":
        ref[head + "weight"] = ref[head + "weight"][:, :-1]
        err, match = ValueError, (
            "shape mismatch /params/conv_heatmap_head_back/Conv_4/kernel",
            r"shape mismatch conv_heatmap_head_back.Conv_4.weight: \(15, 127, 1, 1\)")
    elif fault == "uneven":
        del ref["heatmap_refiner_back_left.fc_bfb.bias"]
        err, match = ValueError, (None, "do not stack")
    else:
        ref["heatmap_refiner_front_left.no_such_layer.weight"] = torch.zeros(1)
        err, match = KeyError, ("no_such_layer",) * 2
    torch.save({"state_dict": ref}, path)
    with pytest.raises(err, match=match[0]):
        convert_lightning_ckpt(path, shapes, "heatmap_mvf_ex")
    with pytest.raises(err, match=match[1]):
        import_lightning_ckpt(path, sd, "heatmap_mvf_ex")


_CALLS = []


def _record(*args):
    _CALLS.append(args)
    return args


class _RunsCode:
    """Unpickled in full, it calls :func:`_record`: code that a file runs."""

    def __reduce__(self):
        return (_record, ("ran",))


class _HParams(dict):
    """A dict subclass, as Lightning's ``AttributeDict`` of hyper-parameters."""


def test_import_runs_no_code_from_the_file(models, tmp_path):
    """A Lightning-style file (hyper-parameters in a dict subclass with an
    attribute, a path, loop state) that also holds an object whose
    unpickling calls a function: the import reads the tensors bitwise and
    calls nothing, where a full unpickle calls it. A file holding what a
    weights-only read cannot rebuild (a numpy scalar) is refused."""
    _CALLS.clear()
    _, _, sd = models["heatmap", 2]
    path = chip_smoke.write_egorear_ckpt(str(tmp_path / "x.ckpt"), sd, "heatmap")
    raw = torch.load(path, weights_only=True)
    hp = _HParams(lr=1e-3, model_cfg={"num_views": 2})
    hp.note = "stage 1"
    raw.update(epoch=11, global_step=5, hyper_parameters=hp, hparams_name="kwargs",
               callbacks={"ModelCheckpoint": {"dirpath": pathlib.Path("ckpts"),
                                              "best_model_score": torch.tensor(1.5)}},
               loops={"fit_loop": {"epoch_progress": {"completed": 11}}},
               code=_RunsCode())
    torch.save(raw, path)
    got = import_lightning_ckpt(path, {k: torch.zeros_like(v) for k, v in sd.items()},
                                "heatmap")
    assert _CALLS == []
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    torch.load(path, weights_only=False)
    assert _CALLS == [("ran",)]
    torch.save(dict(raw, score=np.float32(2.0)), path)
    with pytest.raises(ValueError, match="weights-only read"):
        import_lightning_ckpt(path, sd, "heatmap")
    assert _CALLS == [("ran",)]


def _jax_graft(variables: dict, path: str, loaded: dict) -> dict:
    """JAX ``run.apply_pretrained``'s graft of converted variables."""
    if not path:
        return {**variables, **loaded}
    out = {"params": jax_ckpt.graft(variables["params"], path, loaded["params"])}
    stats = variables["batch_stats"]
    out["batch_stats"] = (jax_ckpt.graft(stats, path, loaded["batch_stats"])
                          if "batch_stats" in loaded else stats)
    return out


def _sub(tree: dict, path: str) -> dict:
    for p in [p for p in path.split("/") if p]:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("key,target,source", [
    ("heatmap_estimator_pretrained_stereo_front", ("heatmap_mvf_ex", 4), "heatmap"),
    ("heatmap_estimator_pretrained_stereo_back", ("heatmap_mvf_ex", 4), "heatmap"),
    ("heatmap_estimator_mvf_pretrained", ("pose_3d_mvf_ex", 2), "heatmap_mvf_ex"),
    ("network_pretrained", ("pose_3d_mvf_ex", 4), "pose_3d_mvf_ex"),
])
def test_graft_from_ckpt_matches_jax(models, tmp_path, key, target, source):
    """Each graft key takes a ``.ckpt`` of its checkpoint's own stage as
    JAX's ``run.apply_pretrained`` does (``load_pretrained`` with the
    stage's task name, then ``graft``), bitwise; a stage-1 checkpoint with
    its ``conv_heatmap`` head is refused by both."""
    path = checkpoint.PRETRAINED_GRAFTS[key][0]
    src_task = checkpoint.PRETRAINED_GRAFTS[key][1] or target[0]
    assert src_task == source
    shapes, base, base_sd = models[target]
    src = (models[source, target[1]][2] if source != "heatmap"
           else models["heatmap", 2][2])
    src = {k: v + 1.0 if v.is_floating_point() else v for k, v in src.items()}
    task = TASKS[target[0]](_cfg(*target), device="cpu")
    load_flax(task.model, base)
    if source == "heatmap":  # the stage-2 estimators have no stage-1 head
        ckpt = chip_smoke.write_egorear_ckpt(str(tmp_path / "head.ckpt"), src, source)
        with pytest.raises(ValueError, match="extra /params/conv_heatmap"):
            jax_ckpt.load_pretrained(ckpt, {c: _sub(base[c], path) for c in base},
                                     source)
        with pytest.raises(ValueError, match="extra conv_heatmap.weight"):
            checkpoint.apply_pretrained(task.model, task.name, {key: ckpt})
        src = {k: v for k, v in src.items() if not k.startswith("conv_heatmap.")}
    ckpt = chip_smoke.write_egorear_ckpt(str(tmp_path / "src.ckpt"), src, source)
    loaded = jax_ckpt.load_pretrained(ckpt, {c: _sub(base[c], path) for c in base},
                                      source)
    want = from_flax(_jax_graft(base, path, loaded))
    assert checkpoint.apply_pretrained(task.model, task.name, {key: ckpt}) == [key]
    got = task.model.state_dict()
    assert sorted(got) == sorted(want)
    n_moved = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
        n_moved += not torch.equal(w, base_sd[k])
    assert n_moved > 0


def test_import_keeps_the_stats_a_checkpoint_lacks(models, tmp_path):
    """A checkpoint without BN running statistics: the parameters are
    imported, the target's statistics kept (JAX ``run.load_eval_ckpt``
    keeps the model's ``batch_stats``)."""
    _, _, sd = models["heatmap", 2]
    params_only = {k: v for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    path = chip_smoke.write_egorear_ckpt(str(tmp_path / "p.ckpt"), params_only, "heatmap")
    assert not any("running" in k for k in read_lightning_state_dict(path))
    target = {k: torch.full_like(v, 7) for k, v in sd.items()}
    got = import_lightning_ckpt(path, target, "heatmap")
    for k, v in got.items():
        want = target[k] if k not in params_only else sd[k]
        assert torch.equal(v, want), k


# -- the CLI --------------------------------------------------------------------------


def _yaml(name: str) -> str:
    return os.path.join(CONFIGS, f"{name}.yaml")


@pytest.fixture(scope="module")
def imagenet(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("imagenet") / "resnet18-seeded.pth")
    chip_smoke.write_imagenet_weights(path)
    with chip_smoke.env_var(chip_smoke.IMAGENET_ENV, path):
        yield path


def test_cli_test_from_ckpt_matches_jax_run(imagenet, tmp_path):
    """``test`` of ``ego4view_rw_pose3d_stereo_front`` (V = 2, the real-world
    rig with each sequence's transforms) on a one-frame real-world tree,
    ``--ckpt_path x.ckpt``: the port's ``run.main`` and JAX's, metrics
    within 1e-4 relative. One lifting layer keeps JAX's CPU compile short."""
    import run as jax_run

    root = make_synthetic_dataset(str(tmp_path / "rw"), "rw", frames_per_seq=1,
                                  eval_frames_per_seq=1, image_size=64,
                                  write_heatmaps=True, draw_pose=True, seed=4)
    ov = ["--model.data_root", root, "--model.batch_size", "1",
          "--model.model_cfg.pose3d_cfg.num_former_layers", "1",
          "--model.dataset_kwargs.use_native_loader", "false"]
    cfg = run.load_config(_yaml("ego4view_rw_pose3d_stereo_front"), ov)
    jtask = JAX_TASKS["pose_3d_mvf_ex"](copy.deepcopy(cfg.init_args["model_cfg"]),
                                        dataset_type="ego4view_rw_pose3d")
    assert jtask.rig.is_rw and jtask.rig.num_views == 2
    ctm = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    shapes = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 3, 256, 256)), jtask.rig, ctm,
        train=False))
    variables = random_variables(shapes, np.random.default_rng(7), heatmap_bias=0.3)
    ckpt = chip_smoke.write_egorear_ckpt(str(tmp_path / "epoch=11.ckpt"),
                                         from_flax(variables), "pose_3d_mvf_ex")
    argv = ["test", "--config", _yaml("ego4view_rw_pose3d_stereo_front"),
            "--ckpt_path", ckpt]
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_run.main(argv + ov + ["--trainer.save_dir", str(tmp_path / "jax")])
    got = run.main(argv + ov + ["--trainer.save_dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert list(got) == list(want) and "test/final_mpjpe" in got
    for k, w in want.items():
        assert abs(got[k] - float(w)) <= METRIC_RTOL * abs(float(w)) + 1e-6, (k, got[k], w)


def test_cli_fit_stereo_front_mvfex_writes_jax_columns(imagenet, tmp_path):
    """One ``fit`` step of ``ego4view_syn_heatmap_mvfex-n1_jqa_stereo_front``
    (V = 2) through the port's CLI: its ``metrics.csv`` header is the one
    JAX's CSVLogger writes for the keys the JAX task emits (the loss terms
    and lr, then the ``*_stereo_front`` eval metrics: no back pair)."""
    root = make_synthetic_dataset(str(tmp_path / "syn"), frames_per_seq=1,
                                  eval_frames_per_seq=1, image_size=64,
                                  write_heatmaps=True, draw_pose=True, seed=5)
    name = "ego4view_syn_heatmap_mvfex-n1_jqa_stereo_front"
    front = checkpoint.save(str(tmp_path / "stage1"), 0, {
        "model": TASKS["heatmap"](_cfg("heatmap", 2), device="cpu").model.state_dict(),
        "optimizer": {}, "step": 0})
    trainer = run.main(["fit", "--config", _yaml(name), "--device", "cpu",
                        "--model.heatmap_estimator_pretrained_stereo_front", front,
                        "--model.data_root", root, "--model.batch_size", "1",
                        "--model.workers", "2", "--trainer.max_epochs", "1",
                        "--trainer.log_every_n_steps", "1",
                        "--trainer.save_dir", str(tmp_path / "port")])
    with open(trainer.logger.path) as f:
        got = next(csv.reader(f))
    cfg = run.load_config(_yaml(name), ["--model.model_cfg.encoder_cfg.resnet_cfg."
                                        "use_imagenet_pretrain", "false"])
    jtask = JAX_TASKS[cfg.task_name](copy.deepcopy(cfg.init_args["model_cfg"]))
    batch = {"img": jnp.zeros((1, 2, 3, 256, 256)),
             "gt_heatmap": jnp.zeros((1, 2, 15, 64, 64))}
    variables = jax.eval_shape(lambda: jtask.model.init(
        jax.random.PRNGKey(0), batch["img"], train=False))
    loss_keys = jax.eval_shape(lambda v: jtask.loss(
        v["params"], {"batch_stats": v["batch_stats"]}, batch)[1][0], variables)
    eval_keys = jax.eval_shape(lambda v: jtask.eval_metrics(v, batch), variables)
    logger = JaxCSVLogger(str(tmp_path / "jax"))
    logger.log({f"train/{k}": 0.0 for k in sorted(list(loss_keys) + ["lr"])}, 1, 0)
    logger.log({f"val/{k}": 0.0 for k in sorted(eval_keys)}, 1, 0)
    with open(logger.path) as f:
        want = next(csv.reader(f))
    assert got == want
    assert not any("stereo_back" in c for c in got) and "val/final_stereo_front_mse_heatmap" in got
