"""Traffic kind ``train_step``: back-to-back ``Trainer.train_step`` calls on
batches (images, ``gt_heatmap``, ``gt_pose``) drawn in turn from a pool of
``pool`` distinct batches made on the device from the seed, dispatched
ahead as ``Trainer.fit`` dispatches them (no wait between steps). No
loader.

Set-up builds the task and trainer once, loads the seeded weights and
takes the first ``followed`` steps on pool batches 0, 1, ...: the
reference follows those steps after the window, and the window goes on
with the same trainer. Parameters (``traffic/<mix>.json``): ``batch``,
``pool``, ``followed``, ``steps_per_epoch`` (places the schedule's
decay epochs), ``traced`` (steps in a traced window), ``rate_seconds``
(the untraced stretch before it, whose rate ``mfu`` reads).
"""

from __future__ import annotations

import time

import torch

from portbench import program, window
from portbench.reference import build as ref_build
from portbench.reference import compare
from portbench.reference import train as ref_train

BETA1 = 0.9  # the first moment's decay: exp_avg after one step is (1 - b1) g


def run(r):
    p, dev = r.params, r.device
    B = p["batch"]
    conf = r.cell.config
    task_name, model_cfg = conf["task"], conf["model"]["init_args"]["model_cfg"]
    task, trainer, pool = program.set_up(r, trainer=True)
    trainer.init_state(p["steps_per_epoch"])

    # The followed steps: losses, the first gradient as AdamW took it, the
    # change of every parameter over them.
    named = dict(task.model.named_parameters())
    start = {n: t.detach().to("cpu", copy=True) for n, t in named.items()}
    losses, grad = [], {}
    for k in range(p["followed"]):
        out = trainer.train_step(pool[k])
        losses.append(out["loss_total"])
        if k == 0:
            grad = {n: first_moment(trainer.optimizer, t).norm() / (1 - BETA1)
                    for n, t in named.items()}
        window.synchronize(dev)
        r.lap(f"followed step {k}")
    change = {n: float((t.detach().cpu() - start[n]).norm()) for n, t in named.items()}
    prog = {"losses": [float(x) for x in losses],
            "grad": {n: float(v) for n, v in grad.items()}, "change": change}
    del start, grad
    setup_s = time.perf_counter() - r.t_start
    setup_peak = window.peak_bytes(dev)
    window.reset_peak(dev)

    summary = None
    k = p["followed"]
    if r.trace:
        # The untraced rate that ``mfu`` reads: the profiler slows the host.
        n_rate, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < min(r.seconds, p["rate_seconds"]):
            trainer.train_step(pool[(k + n_rate) % len(pool)])
            n_rate += 1
        window.synchronize(dev)
        rate = n_rate / (time.perf_counter() - t0)
        k += n_rate
        calls = []
        with program.sampling_calls(calls), window.Traced(dev, task.model) as tr:
            for i in range(p["traced"]):
                with tr.mark(f"step::{i}"):
                    trainer.train_step(pool[(k + i) % len(pool)])
        steps = p["traced"]
        summary = tr.summary(items=steps, rate=rate)
        summary["flops_per_item"] = window.flops_per_sample(task_name, model_cfg, train=True) * B
        summary["peak_flops"] = window.peak_flops(r.cell)
        summary["sampling_bound_ms"] = window.sampling_bound_ms(calls, backward=True)
        window_s = summary["window_s"]
    else:
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < r.seconds:
            trainer.train_step(pool[(k + steps) % len(pool)])
            steps += 1
        window.synchronize(dev)
        window_s = time.perf_counter() - t0
    peak = max(setup_peak, window.peak_bytes(dev))
    r.note(f"train: {steps} steps of {B} in {window_s:.4f} s after {p['followed']} "
           f"followed steps (losses {prog['losses']})")
    e2e = {"train_samples_per_s": steps * B / window_s, "setup_s": setup_s}

    keymap = program.leaf_map(task_name, [(k_, tuple(t.shape)) for k_, t in
                                          small_layout(task_name, model_cfg)])
    prog = {"losses": prog["losses"],
            "grad": {keymap[n]: v for n, v in prog["grad"].items()},
            "change": {keymap[n]: v for n, v in prog["change"].items()}}
    del task, trainer, named
    window.release(dev)
    ref = follow(conf, r.seed, pool[:p["followed"]], p["steps_per_epoch"], dev)
    numbers = compare.train_numbers(prog, ref)
    r.note(f"train check: worst leaves: {numbers['worst']}")
    return dict(e2e=e2e, summary=summary, checks=compare.judged(numbers, r.cell.limits),
                attempted=(p["followed"] + steps) * B, failed=0, peak=peak, numbers=numbers)


def first_moment(optimizer, param):
    """AdamW's exp_avg of ``param`` (zeros where it holds none)."""
    m = optimizer.state.get(param, {}).get("exp_avg")
    return torch.zeros_like(param) if m is None else m


def small_layout(task_name, model_cfg):
    """The reference's parameters (name, tensor) at 64 px: their names are
    the layout's at any size."""
    small = dict(model_cfg, image_size=[64, 64])
    return list(ref_build.build_reference(task_name, small).named_parameters())


def follow(conf, seed, batches, steps_per_epoch, dev, tf32=False):
    """The reference's first steps, from the run's seeded weights, on
    ``batches``, with the settings of the configuration file ``conf``: each
    step's loss, each leaf's first (clipped) gradient norm and its change
    over the steps."""
    task_name, args = conf["task"], conf["model"]["init_args"]
    model = window.reference(task_name, args["model_cfg"], seed, dev).train()
    named = dict(model.named_parameters())
    start = {n: t.detach().clone() for n, t in named.items()}
    opt = ref_train.AdamW(named, args.get("weight_decay", 5e-4),
                          ref_train.decays(model, conf["exempt_norms_and_biases"]))
    losses, grad = [], {}
    with window.tf32(tf32):
        for step, batch in enumerate(batches):
            loss = ref_train.loss(task_name, model, batch, args.get("w_heatmap", 10.0),
                                  args.get("w_mpjpe", 0.1))
            gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
            gs = [torch.zeros_like(t) if g is None else g for g, t in zip(gs, named.values())]
            ref_train.clip_by_global_norm(gs, conf["trainer"].get("gradient_clip_val"))
            if step == 0:
                grad = {n: float(g.norm()) for n, g in zip(named, gs)}
            opt.step(dict(zip(named, gs)), ref_train.lr_at(
                step, args.get("lr", 1e-3), args.get("warmup_iters", 500),
                args.get("lr_decay_epochs", (8, 10)), steps_per_epoch))
            losses.append(float(loss.detach()))
    change = {n: float((t.detach() - start[n]).norm()) for n, t in named.items()}
    return {"losses": losses, "grad": grad, "change": change}
