"""Import of EgoRear's own PyTorch-Lightning checkpoints (the JAX package's
``train/torch_convert.py``: ``strip_prefixes``, the key grammar,
``convert_state_dict`` and the view-count inference of
``convert_lightning_ckpt``).

A reference ``.ckpt`` is a ``torch.save``'d Lightning state whose
``state_dict`` keys may carry the ``network._orig_mod.`` (torch.compile) and
``module.`` (DDP) prefixes. Its keys follow the reference module trees
(``egoposeformer_heatmap{,_mvf_ex}.py``, ``egoposeformer_mvf_ex.py``,
``backbones/resnet.py``); the grammar below maps each onto the JAX package's
flax variables tree, with its layout changes:

  * conv weight OIHW -> HWIO kernel; linear weight (out, in) -> (in, out);
  * the reference's 1x1 convs that the models hold as Dense layers
    (memory projections, refiner heads) -> (in, out) kernels;
  * BatchNorm / LayerNorm weight, bias -> scale, bias; running stats ->
    ``batch_stats`` mean, var (``num_batches_tracked`` dropped);
  * embeddings and position tables copied;
  * the V per-view refiners (``heatmap_refiner_front_left`` ...) stacked
    along a leading axis in view order, as the JAX package's ``refiners``.

:func:`~egorear_tpu_torch.convert.from_flax` then turns that tree into the
port's state dict (:func:`import_lightning_ckpt`), so the import is one
grammar shared with the JAX package and one bridge shared with every
parity test. Everything here is numpy; nothing imports JAX.
"""

from __future__ import annotations

import pickle
import re
from collections import OrderedDict
from typing import Dict, List, Mapping

import numpy as np
import torch

from egorear_tpu_torch.convert import from_flax
from egorear_tpu_torch.train.checkpoint import _check_same_structure

REFINER_ORDER_4 = (
    "heatmap_refiner_front_left",
    "heatmap_refiner_front_right",
    "heatmap_refiner_back_left",
    "heatmap_refiner_back_right",
)
REFINER_ORDER_3 = (
    "heatmap_refiner_front_left",
    "heatmap_refiner_front_right",
    "heatmap_refiner_back",
)
REFINER_ORDER_2 = REFINER_ORDER_4[:2]


def strip_prefixes(state_dict: Mapping) -> dict:
    """Strip the Lightning / torch.compile / DDP key prefixes."""
    out = {}
    for k, v in state_dict.items():
        for pre in ("network._orig_mod.", "network.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# leaf-level transforms
# ---------------------------------------------------------------------------


def _conv(v):
    return np.transpose(v, (2, 3, 1, 0))


def _linear(v):
    return np.transpose(v, (1, 0))


def _set(tree: dict, path: List[str], value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    if path[-1] in node:
        raise KeyError(f"duplicate target {'/'.join(path)}")
    node[path[-1]] = value


def _emit_conv(params, path, name, v):
    if name == "weight":
        _set(params, path + ["kernel"], _conv(v))
    elif name == "bias":
        _set(params, path + ["bias"], v)
    else:
        raise KeyError(name)


def _emit_linear(params, path, name, v):
    if name == "weight":
        _set(params, path + ["kernel"], _linear(v))
    elif name == "bias":
        _set(params, path + ["bias"], v)
    else:
        raise KeyError(name)


def _emit_conv1x1_as_dense(params, path, name, v):
    """A reference 1x1 conv weight (D, C, 1, 1) -> a Dense kernel (C, D)."""
    if name == "weight":
        _set(params, path + ["kernel"], v[:, :, 0, 0].T)
    elif name == "bias":
        _set(params, path + ["bias"], v)
    else:
        raise KeyError(name)


def _emit_norm(params, stats, path, name, v):
    if name == "weight":
        _set(params, path + ["scale"], v)
    elif name == "bias":
        _set(params, path + ["bias"], v)
    elif name == "running_mean":
        _set(stats, path + ["mean"], v)
    elif name == "running_var":
        _set(stats, path + ["var"], v)
    elif name != "num_batches_tracked":
        raise KeyError(name)


# ---------------------------------------------------------------------------
# key grammars
# ---------------------------------------------------------------------------

_RESNET_STAGE = {"layer_s8": "layer2", "layer_s16": "layer3", "layer_s32": "layer4"}


def _map_heatmap_net(key: str, v, params, stats, base: List[str]):
    """Keys under a reference EgoPoseFormerHeatmap."""
    if key.startswith("encoder.backbone."):
        rest = key[len("encoder.backbone."):]
        rpath = base + ["encoder", "resnet"]
        m = re.fullmatch(r"layer_s2\.0\.(\w+)", rest)
        if m:
            return _emit_conv(params, rpath + ["conv1"], m.group(1), v)
        m = re.fullmatch(r"layer_s2\.1\.(\w+)", rest)
        if m:
            return _emit_norm(params, stats, rpath + ["bn1"], m.group(1), v)
        m = re.fullmatch(r"layer_s4\.1\.(\d)\.(.+)", rest)
        if m:
            return _map_basic_block(m.group(2), v, params, stats,
                                    rpath + [f"layer1_{m.group(1)}"])
        m = re.fullmatch(r"(layer_s8|layer_s16|layer_s32)\.(\d)\.(.+)", rest)
        if m:
            stage = _RESNET_STAGE[m.group(1)]
            return _map_basic_block(m.group(3), v, params, stats,
                                    rpath + [f"{stage}_{m.group(2)}"])
        raise KeyError(key)
    if key.startswith("encoder.neck."):
        rest = key[len("encoder.neck."):]
        m = re.fullmatch(r"(lateral|fuse|fpn)_convs\.(\d+)\.0\.(\w+)", rest)
        if m:
            kind, idx, name = m.groups()
            return _emit_conv(params, base + ["encoder", "fpn", f"{kind}_{idx}"],
                              name, v)
        raise KeyError(key)
    m = re.fullmatch(r"conv_heatmap\.(\w+)", key)
    if m:
        return _emit_conv(params, base + ["conv_heatmap"], m.group(1), v)
    raise KeyError(key)


def _map_basic_block(rest: str, v, params, stats, bpath: List[str]):
    m = re.fullmatch(r"(conv1|conv2)\.(\w+)", rest)
    if m:
        return _emit_conv(params, bpath + [m.group(1)], m.group(2), v)
    m = re.fullmatch(r"(bn1|bn2)\.(\w+)", rest)
    if m:
        return _emit_norm(params, stats, bpath + [m.group(1)], m.group(2), v)
    m = re.fullmatch(r"downsample\.0\.(\w+)", rest)
    if m:
        return _emit_conv(params, bpath + ["downsample_conv"], m.group(1), v)
    m = re.fullmatch(r"downsample\.1\.(\w+)", rest)
    if m:
        return _emit_norm(params, stats, bpath + ["downsample_bn"], m.group(1), v)
    raise KeyError(rest)


def _map_transformer_layer(rest: str, v, params, stats, tpath: List[str]):
    """Reference MultiViewTransformerLayer / EgoPoseFormerTransformerLayer."""
    m = re.fullmatch(r"cross_attn\.(sampling_offsets|attention_weights|value_proj|"
                     r"output_proj)\.(\w+)", rest)
    if m:
        return _emit_linear(params, tpath + ["cross_attn", m.group(1)], m.group(2), v)
    m = re.fullmatch(r"fuse_mlp\.(\w+)", rest)
    if m:
        return _emit_linear(params, tpath + ["fuse_mlp"], m.group(1), v)
    m = re.fullmatch(r"spatial_attn\.(q_proj|k_proj|v_proj|out_proj)\.(\w+)", rest)
    if m:
        return _emit_linear(params, tpath + ["spatial_attn", m.group(1)], m.group(2), v)
    m = re.fullmatch(r"(norm_cross|norm_spatial|norm_ffn)\.(\w+)", rest)
    if m:
        return _emit_norm(params, stats, tpath + [m.group(1)], m.group(2), v)
    m = re.fullmatch(r"ffn\.layers\.(\d+)\.0\.(\w+)", rest)
    if m:  # inner [Linear, GELU, Dropout] blocks
        return _emit_linear(params, tpath + ["ffn", f"Dense_{m.group(1)}"], m.group(2), v)
    m = re.fullmatch(r"ffn\.layers\.(\d+)\.(\w+)", rest)
    if m:  # the trailing plain Linear
        return _emit_linear(params, tpath + ["ffn", f"Dense_{m.group(1)}"], m.group(2), v)
    raise KeyError(rest)


def _map_refiner(key: str, v, params, stats):
    """Reference HeatmapMVF keys -> one (unstacked) refiner tree."""
    m = re.fullmatch(r"heatmap_proj\.([02])\.(\w+)", key)
    if m:
        idx = "0" if m.group(1) == "0" else "1"
        return _emit_linear(params, [f"heatmap_proj_{idx}"], m.group(2), v)
    m = re.fullmatch(r"fc_bfb\.(\w+)", key)
    if m:
        return _emit_linear(params, ["fc_bfb"], m.group(1), v)
    m = re.fullmatch(r"fc_query\.0\.(\w+)", key)
    if m:
        return _emit_linear(params, ["fc_query"], m.group(1), v)
    if key == "joint_query_embed.weight":
        return _set(params, ["joint_query_embed"], v)
    if key in ("query_pos_embed", "frame_feat_multi_view_pos_embed"):
        return _set(params, [key], v)
    m = re.fullmatch(r"frame_feat_multi_view_proj\.(\w+)", key)
    if m:
        return _emit_conv1x1_as_dense(params, ["frame_feat_multi_view_proj"],
                                      m.group(1), v)
    m = re.fullmatch(r"frame_feat_proj_layers\.([024])\.(\w+)", key)
    if m:
        idx = {"0": "0", "2": "1", "4": "2"}[m.group(1)]
        if idx == "1":  # the middle 3x3 stride-2 conv stays a conv
            return _emit_conv(params, [f"ff_proj_{idx}"], m.group(2), v)
        return _emit_conv1x1_as_dense(params, [f"ff_proj_{idx}"], m.group(2), v)
    m = re.fullmatch(r"transformer_layers\.(\d+)\.(.+)", key)
    if m:
        return _map_transformer_layer(m.group(2), v, params, stats,
                                      [f"transformer_{m.group(1)}"])
    m = re.fullmatch(r"post_norm\.(\d+)\.(\w+)", key)
    if m:
        return _emit_norm(params, stats, [f"post_norm_{m.group(1)}"], m.group(2), v)
    m = re.fullmatch(r"head_layers\.(\d+)\.head\.([03])\.(\w+)", key)
    if m:  # the 128-dim head: 1x1 convs at Sequential indices 0, 3
        idx = {"0": "0", "3": "1"}[m.group(2)]
        return _emit_conv1x1_as_dense(params, [f"head_{m.group(1)}", f"Conv_{idx}"],
                                      m.group(3), v)
    m = re.fullmatch(r"frame_feat_refined_proj_layers\.(\d+)\.([03])\.(\w+)", key)
    if m:
        idx = {"0": "0", "3": "1"}[m.group(2)]
        return _emit_conv1x1_as_dense(
            params, [f"ff_refined_proj_{m.group(1)}_{idx}"], m.group(3), v)
    m = re.fullmatch(r"conv_heatmap\.(\w+)", key)
    if m:
        return _emit_conv1x1_as_dense(params, ["conv_heatmap"], m.group(1), v)
    m = re.fullmatch(r"conv_heatmap_layers\.(\d+)\.([0257])\.(\w+)", key)
    if m:
        idx = {"0": "0", "2": "1", "5": "2", "7": "3"}[m.group(2)]
        if idx == "0":  # the leading 3x3 stride-2 conv stays a conv
            return _emit_conv(params, [f"conv_hm_{m.group(1)}_{idx}"], m.group(3), v)
        return _emit_conv1x1_as_dense(params, [f"conv_hm_{m.group(1)}_{idx}"],
                                      m.group(3), v)
    raise KeyError(key)


def _map_conv_stack_head(key: str, v, params, base: List[str]):
    """The MVFex-level conv-stack heatmap heads (Sequential indices
    0, 2, 4, 7, 9)."""
    m = re.fullmatch(r"([02479])\.(\w+)", key)
    if m:
        idx = {"0": "0", "2": "1", "4": "2", "7": "3", "9": "4"}[m.group(1)]
        return _emit_conv(params, base + [f"Conv_{idx}"], m.group(2), v)
    raise KeyError(key)


def _map_pose3d(key: str, v, params, stats, base: List[str]):
    m = re.fullmatch(r"feat_proj\.(\w+)", key)
    if m:
        return _emit_conv1x1_as_dense(params, base + ["feat_proj"], m.group(1), v)
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", key)
    if m:
        return _map_transformer_layer(m.group(2), v, params, stats,
                                      base + [f"transformer_{m.group(1)}"])
    m = re.fullmatch(r"post_norm\.(\d+)\.(\w+)", key)
    if m:
        return _emit_norm(params, stats, base + [f"post_norm_{m.group(1)}"],
                          m.group(2), v)
    m = re.fullmatch(r"query_gen_mlp\.([024])\.(\w+)", key)
    if m:
        idx = {"0": "0", "2": "1", "4": "2"}[m.group(1)]
        return _emit_linear(params, base + [f"query_gen_{idx}"], m.group(2), v)
    m = re.fullmatch(r"conv_frame_feat\.([0257])\.(\w+)", key)
    if m:
        idx = {"0": "0", "2": "1", "5": "2", "7": "3"}[m.group(1)]
        return _emit_conv(params, base + [f"conv_ff_{idx}"], m.group(2), v)
    m = re.fullmatch(r"conv_heatmap_(front_left|front_right)\.([03])\.(\w+)", key)
    if m:  # use_mlp_heatmap heads, front views
        view = {"front_left": 0, "front_right": 1}[m.group(1)]
        idx = {"0": "0", "3": "1"}[m.group(2)]
        return _emit_conv(params, base + [f"conv_heatmap_view{view}_{idx}"],
                          m.group(3), v)
    m = re.fullmatch(r"conv_frame_feat_(back_left|back_right)\.([03])\.(\w+)", key)
    if m:  # (sic) the reference names the back heatmap convs conv_frame_feat_*
        view = {"back_left": 2, "back_right": 3}[m.group(1)]
        idx = {"0": "0", "3": "1"}[m.group(2)]
        return _emit_conv(params, base + [f"conv_heatmap_view{view}_{idx}"],
                          m.group(3), v)
    # mlp_pred: inner blocks "i.0.weight", the last Linear "N.weight".
    m = re.fullmatch(r"mlp_pred\.(\d+)\.0\.(\w+)", key)
    if m:
        return _emit_linear(params, base + [f"mlp_pred_{m.group(1)}"], m.group(2), v)
    m = re.fullmatch(r"mlp_pred\.(\d+)\.(\w+)", key)
    if m:
        return _emit_linear(params, base + ["mlp_pred_out"], m.group(2), v)
    # reg_mlp: Sequential(Linear, GELU) * k + Linear, torch index 2i; the
    # last Linear is the one with a 3-dim output.
    m = re.fullmatch(r"reg_mlp\.(\d+)\.(\d+)\.(\w+)", key)
    if m:
        layer, seq, name = int(m.group(1)), int(m.group(2)), m.group(3)
        target = (f"reg_mlp_{layer}_out" if v.shape[0] == 3
                  else f"reg_mlp_{layer}_{seq // 2}")
        return _emit_linear(params, base + [target], name, v)
    raise KeyError(key)


# ---------------------------------------------------------------------------
# top-level converters
# ---------------------------------------------------------------------------


def _stack_refiners(per_view: List[dict]) -> dict:
    """The per-view refiner trees stacked leaf by leaf along a new axis 0."""
    first = per_view[0]
    if isinstance(first, dict):
        if any(set(t) != set(first) for t in per_view):
            raise ValueError("the refiners' trees differ: they do not stack")
        return {k: _stack_refiners([t[k] for t in per_view]) for k in first}
    return np.stack(per_view, axis=0)


def convert_state_dict(sd: Mapping[str, np.ndarray], task_name: str,
                       num_views: int = 4) -> dict:
    """A stripped reference state dict -> the JAX package's flax variables
    of the task's network (``heatmap``, ``heatmap_mvf_ex`` or
    ``pose_3d_mvf_ex``), numpy leaves."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}
    refiner_order = {2: REFINER_ORDER_2, 3: REFINER_ORDER_3,
                     4: REFINER_ORDER_4}[num_views]
    estimators = {
        "heatmap_estimator_stereo_front.": (_map_heatmap_net, "heatmap_estimator_stereo_front"),
        "heatmap_estimator_stereo_back.": (_map_heatmap_net, "heatmap_estimator_stereo_back"),
        "conv_heatmap_layers_stereo_front.": (None, "conv_heatmap_head_front"),
        "conv_heatmap_layers_stereo_back.": (None, "conv_heatmap_head_back"),
    }

    def convert_mvfex(prefix: str, base: List[str]):
        refiner_trees = [({}, {}) for _ in refiner_order]
        for key, v in sd.items():
            if not key.startswith(prefix):
                continue
            k = key[len(prefix):]
            for pre, (fn, name) in estimators.items():
                if k.startswith(pre):
                    if fn is None:
                        _map_conv_stack_head(k[len(pre):], v, params, base + [name])
                    else:
                        fn(k[len(pre):], v, params, stats, base + [name])
                    break
            else:
                for i, rname in enumerate(refiner_order):
                    if k.startswith(rname + "."):
                        _map_refiner(k[len(rname) + 1:], v, *refiner_trees[i])
                        break
                else:
                    raise KeyError(key)
        _set(params, base + ["refiners"], _stack_refiners([t[0] for t in refiner_trees]))
        if any(t[1] for t in refiner_trees):
            _set(stats, base + ["refiners"],
                 _stack_refiners([t[1] for t in refiner_trees]))

    if task_name == "heatmap":
        for key, v in sd.items():
            _map_heatmap_net(key, v, params, stats, [])
    elif task_name == "heatmap_mvf_ex":
        convert_mvfex("", [])
    elif task_name == "pose_3d_mvf_ex":
        convert_mvfex("heatmap_estimator.", ["heatmap_estimator"])
        for key, v in sd.items():
            if key.startswith("pose3d_estimator."):
                _map_pose3d(key[len("pose3d_estimator."):], v, params, stats,
                            ["pose3d_estimator"])
    else:
        raise ValueError(task_name)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def infer_num_views(sd: Mapping) -> int:
    """The refiner count of a stripped reference state dict: 4 with a
    ``back_left`` key, 3 with a ``heatmap_refiner_back``, else 2."""
    if any("back_left" in k for k in sd):
        return 4
    return 3 if any("refiner_back." in k for k in sd) else 2


class _StandIn:
    """Stands in for every class or function that a checkpoint's pickle names
    beyond PyTorch's weights-only allowlist (Lightning's ``AttributeDict`` of
    hyper-parameters, paths, callbacks): whatever the file builds from one
    is an empty ``OrderedDict`` that then takes the file's items and
    attributes, so none of the named code runs."""

    def __new__(cls, *args, **kwargs):
        return OrderedDict()


def read_lightning_state_dict(path: str) -> dict:
    """The prefix-stripped ``state_dict`` of a reference ``.ckpt`` (or of a
    bare state dict), numpy values. The file is read with
    ``weights_only=True``, each global beyond PyTorch's allowlist built as
    a :class:`_StandIn`: no code from the file runs. A file whose objects
    cannot be rebuilt so raises ``ValueError``."""
    names = torch.serialization.get_unsafe_globals_in_checkpoint(path)
    try:
        with torch.serialization.safe_globals([(_StandIn, n) for n in names]):
            raw = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, TypeError, ValueError) as e:
        raise ValueError(f"{path}: a weights-only read cannot rebuild the Python "
                         f"objects it holds besides its tensors; save its "
                         f"'state_dict' alone from a trusted copy ({e})") from None
    sd = raw.get("state_dict", raw)
    return strip_prefixes({k: v.numpy() if hasattr(v, "numpy") else v
                           for k, v in sd.items()})


_BN_STATS = ("running_mean", "running_var", "num_batches_tracked")


def import_lightning_ckpt(path: str, target: Mapping[str, torch.Tensor],
                          task_name: str) -> Dict[str, torch.Tensor]:
    """A reference ``.ckpt`` of task ``task_name`` as the port's state dict
    with exactly ``target``'s keys: ``from_flax`` of
    :func:`convert_state_dict` (the view count inferred from the refiners'
    keys), as strict as the reference's ``load_state_dict``: every extra,
    missing or misshapen entry raises ``ValueError``. A checkpoint without
    BatchNorm statistics leaves ``target``'s as they are."""
    sd = read_lightning_state_dict(path)
    got = from_flax(convert_state_dict(sd, task_name, infer_num_views(sd)))
    want = target
    if not any(k.endswith(_BN_STATS) for k in got):
        want = {k: v for k, v in target.items() if not k.endswith(_BN_STATS)}
    _check_same_structure(got, want, path)
    return {**target, **got}
