"""One fp64 train step of stage 3 on the branches that no shipped yaml sets,
held to the JAX loss, ``jax.grad`` and the optax update on the CPU (64 px,
batch 2, one lifting layer; ``test_torch_port_rigs.check_train_step`` at
``BRANCH_GRAD_TOL``).

Each step sets several branches at once, one per axis of the model, so that
every branch trains in a step at a fraction of the JAX compiles. Here:
``1by1`` with ``use_pred_heatmap_init`` (the estimators' own heads keep
their gradient) + the heatmap-embedding queries + the avgpool proposal +
``norm_mlp_pred`` + dense cross-attention in the lifter.
``test_torch_port_branches_refined.py`` holds the step without
``use_pred_heatmap_init``; ``test_torch_port_branches_train.py`` the
joint-query-only mode's step (stage 2) and the 512-channel head. Each seed
is the first from 100 that passes JAX's conditioning check, which does not
look at the port.
"""

from __future__ import annotations

from test_torch_port_branches import NORM_SPREAD
from test_torch_port_branches_train import _one_torch_thread, run_step  # noqa: F401
from torch_threads import torch_threads  # noqa: F401

BRANCHES = ["1by1", "hm_embed", "avgpool", "norm_mlp_pred", "normal_p3d"]


def test_train_step_matches_jax():
    run_step("+".join(BRANCHES), BRANCHES, 101,
             variables_kw={"pose_spread": NORM_SPREAD})
