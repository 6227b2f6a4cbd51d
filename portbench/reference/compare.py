"""The comparisons that decide ``correct``: the numbers a run computes
from the program's outputs and the reference's, each held to its cell's
limit (``portbench/workloads/<cell>.json``)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch


def sample_gaps(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per sample (B,): the largest |got - want| over every output, each
    output measured against the largest |want| of its batch."""
    gaps = []
    for g, w in zip(got, want):
        scale = w.abs().max().clamp_min(1e-30)
        gaps.append(((g.float() - w.float()).abs() / scale).reshape(w.shape[0], -1).amax(1))
    return torch.stack(gaps).amax(0)


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             keys: Iterable[str]) -> Tuple[float, str]:
    """The worst leaf's |got norm - want norm|, over the larger of the
    want norm and the median want norm of ``keys``; and that leaf."""
    keys = list(keys)
    if not keys:
        return float("nan"), ""
    median = float(torch.tensor([want[k] for k in keys]).median())
    return max((abs(got[k] - want[k]) / max(want[k], median, 1e-30), k) for k in keys)


def train_numbers(prog: dict, ref: dict, moved_share: float = 1e-3) -> Dict[str, float]:
    """The training cells' numbers. ``prog`` and ``ref`` hold ``losses`` (the
    first steps'), ``grad`` (each leaf's norm of the first gradient as the
    optimizer took it) and ``change`` (each leaf's norm of its change over
    the first steps), keyed alike. A leaf whose reference gradient is under
    ``moved_share`` of the median leaf's moves by round-off alone and is
    left out of the change. ``worst`` names the leaves that set the two
    leaf numbers."""
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    keys = sorted(ref["grad"])
    if set(prog["grad"]) != set(keys):
        return {"loss_gap": max(losses), "grad_gap": float("inf"),
                "change_gap": float("inf"), "worst": "the leaves differ"}
    median = float(torch.tensor([ref["grad"][k] for k in keys]).median())
    moved = [k for k in keys if ref["grad"][k] >= moved_share * median]
    grad, grad_leaf = leaf_gap(prog["grad"], ref["grad"], keys)
    change, change_leaf = leaf_gap(prog["change"], ref["change"], moved)
    return {"loss_gap": max(losses), "grad_gap": grad, "change_gap": change,
            "worst": f"grad {grad_leaf}, change {change_leaf}"}


def judged(numbers: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """[{name, value, limit, ok}] for every limited number; a number that
    is missing or not finite fails."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        ok = v == v and v <= limit
        out.append({"name": name, "value": v, "limit": limit, "ok": bool(ok)})
    return out
