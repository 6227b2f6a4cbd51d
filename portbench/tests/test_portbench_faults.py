"""Runs of tiny cells with the timed path broken underneath, past the
look for a card: each fault that a cell can have makes ``correct`` false.
One chip, so no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from egorear_tpu_torch.train import tasks as port_tasks
from egorear_tpu_torch.train import trainer as port_trainer
from portbench.tests import tiny


def _altered(original):
    def eval_forward(self, batch):
        batch, (preds, hms) = original(self, batch)
        preds = list(preds)
        preds[-1] = preds[-1].clone()
        preds[-1][0, 0, 0] += 1.0  # one joint of one answer, 1 cm off
        return batch, (preds, hms)
    return eval_forward


def _half_left_out(original):
    def eval_forward(self, batch):
        half = batch["img"].shape[0] // 2
        _, (preds, hms) = original(self, {"img": batch["img"][:half]})
        pad = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
        return batch, ([pad(p) for p in preds], [pad(h) for h in hms])
    return eval_forward


def _unchanged(original):
    def train_step(self, batch):
        with torch.no_grad():
            _, metrics = self.task.loss(batch)
        self.step += 1
        return {k: v.detach().float() for k, v in metrics.items()}
    return train_step


def _half_batch(original):
    def train_step(self, batch):
        half = batch["img"].shape[0] // 2
        return original(self, {k: v[:half] for k, v in batch.items()})
    return train_step


SERVE = [("answer_altered", _altered), ("half_batch_left_out", _half_left_out)]
TRAIN = [("state_unchanged", _unchanged), ("half_batch_mean_over_rest", _half_batch)]


@pytest.mark.parametrize("fault,make", SERVE, ids=[f for f, _ in SERVE])
def test_serve_fault_is_caught(tmp_path, monkeypatch, fault, make):
    monkeypatch.setattr(port_tasks.Pose3DTask, "_eval_forward",
                        make(port_tasks.Pose3DTask._eval_forward))
    result, checks = tiny.run_tiny(tiny.tiny_cell(tmp_path, "syn_pose3d.serve_b32"))
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", ["syn_pose3d.train_b32", "syn_mvfex.train_b64"])
@pytest.mark.parametrize("fault,make", TRAIN, ids=[f for f, _ in TRAIN])
def test_train_fault_is_caught(tmp_path, monkeypatch, cell, fault, make):
    monkeypatch.setattr(port_trainer.Trainer, "train_step",
                        make(port_trainer.Trainer.train_step))
    result, checks = tiny.run_tiny(tiny.tiny_cell(tmp_path, cell))
    assert not result["correct"], checks
