"""Conditioning of the 64 px train-step tests of ``test_torch_port_rigs.py``
over a range of seeds, in fp32 and in fp64, on the CPU.

For each seed of a ``STEPS`` case it prints one JSON line with, in each
precision: ``jax_move``, how far one-fp32-ulp noise (2^-23 relative) on
every parameter moves JAX's own gradient (the tests' conditioning check),
and ``port``, how far the port's gradient lies from JAX's, each the worst
leaf's max-abs error over that leaf's largest JAX value; and ``port_off``,
the number of leaves (of ``leaves``) whose error exceeds 1e-4 of their
scale. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/scan_step_seeds.py stage3_v4_rw 100 110
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_port_rigs as rigs  # noqa: E402
from egorear_tpu_torch.convert import from_flax  # noqa: E402


def _errors(got, want, floor):
    return {k: float((got.get(k, torch.zeros_like(w)) - w).abs().max())
            / float(w.abs().max())
            for k, w in want.items() if float(w.abs().max()) >= floor}


def _port_grads(task, batch, dtype):
    model = task.model.to(dtype).train()
    loss, _ = task.loss({k: torch.from_numpy(x).to(dtype) for k, x in batch.items()})
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def scan(case: str, seeds) -> None:
    task_name, views, camera_model, _ = rigs.STEPS[case]
    jitted = {}
    for seed in seeds:
        rigs.STEPS[case] = (task_name, views, camera_model, seed)
        out = {"case": case, "seed": seed}
        for name, x64, dtype in (("fp32", False, np.float32), ("fp64", True, np.float64)):
            jtask, v, batch, task = rigs._step_case(case)
            params = jax.tree.map(lambda x: np.asarray(x, dtype), v["params"])
            extra = {"batch_stats": jax.tree.map(lambda x: np.asarray(x, dtype),
                                                 v["batch_stats"])}
            batch = {k: np.asarray(x, dtype) for k, x in batch.items()}
            sign = np.random.default_rng(0)
            noisy = jax.tree.map(lambda x: (x * (1 + sign.choice(
                [-1.0, 1.0], size=x.shape) * 2.0**-23)).astype(dtype), params)
            with jax.enable_x64(x64):
                if name not in jitted:
                    jitted[name] = jax.jit(jax.value_and_grad(
                        lambda p, ev, b, t=jtask: t.loss(p, ev, b, True), has_aux=True))
                grads = [from_flax({"params": jax.device_get(
                    jitted[name](p, extra, batch)[1])}) for p in (params, noisy)]
            floor = rigs.GRAD_FLOOR * max(float(w.abs().max()) for w in grads[0].values())
            port = _errors(_port_grads(task, batch, getattr(torch, name.replace(
                "fp", "float"))), grads[0], floor)
            out[name] = {"jax_move": max(_errors(grads[1], grads[0], floor).values()),
                         "port": max(port.values()),
                         "port_off": sum(e > 1e-4 for e in port.values()),
                         "leaves": len(port)}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    scan(sys.argv[1], range(int(sys.argv[2]), int(sys.argv[3])))
