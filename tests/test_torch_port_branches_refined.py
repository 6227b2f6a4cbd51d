"""One fp64 train step of stage 3 without ``use_pred_heatmap_init``, held to
JAX on the CPU as in ``test_torch_port_branches_steps.py``: the lifter reads
the refined features, so its gradient reaches every refiner, and the
refiners' gradient reaches the initial heads. With it: ``1by1`` (the initial
heatmaps from the estimators' own 1x1 heads), the multi-view JQA queries,
dense cross-attention in the refiners and the heatmap 3D proposal. The seed
is the first from 100 that passes JAX's conditioning check."""

from __future__ import annotations

from test_torch_port_branches_train import _one_torch_thread, run_step  # noqa: F401
from torch_threads import torch_threads  # noqa: F401

BRANCHES = ["1by1", "no_pred_init", "jqa_mv", "normal_mvf", "mlp_heatmap"]


def test_train_step_matches_jax():
    run_step("+".join(BRANCHES), BRANCHES, 101)
