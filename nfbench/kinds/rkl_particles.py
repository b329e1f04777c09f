"""Reverse-KL training of a flow over particles against their energy,
through the program's `train.loop.train_step` with the bench's optimizer
(`bench_optimizer`: clip 1.0, Adam, warmup then cosine decay), on base
draws made by the benchmark (the lattice plus Gaussian noise of variance
1/alpha, wrapped), step i's from its own seed.

Set-up builds the flow (`config.setup_model`), the target and the
optimizer and runs the first `setup_steps` steps; the window runs the same
objects until its time is up.

`train_step_ms`: the window's seconds over the steps completed in it.

The check: the float64 reference (configs/<config>.py) trains from the
same weights on the same first three draws, each step's loss and gradient
summed over chunks of `check_chunk` draws. Numbers: `loss_gap`,
`grad_gap`, `grad_diff_median`, `step_gap`, as in the forward-KL cell
(kinds/fkl_train.py). Traced runs also hand the readers one step's spline
calls (on `bound_rows` draws, scaled to the batch) and the attention
FLOPs of a forward pass.
"""

from __future__ import annotations

import torch

from nfbench import refcore
from nfbench.kinds import (
    Outcome,
    Window,
    generator,
    memory_peak,
    sub_seed,
)
from nfbench.kinds.fkl_train import training_gaps
from nfbench.kinds.rkl_train import schedule
from nfbench.trace import span


class Port:
    """The program: its flow holding the benchmark's weights, the target,
    `bench_optimizer` and `train_step`."""

    def __init__(self, cell, params, centers):
        from normalizingflow_tpu_torch.train.loop import (
            bench_optimizer,
            train_step,
        )
        from nfbench.ports import nsf_tcl

        tr = cell.traffic
        self.flow, self.target = nsf_tcl.build(cell.cfg, params, centers,
                                               cell.device)
        self.opt = bench_optimizer(list(self.flow.parameters()),
                                   tr["schedule_steps"], tr["warmup_steps"],
                                   tr["peak_lr"])
        self.train_step = train_step

    def named_params(self):
        return dict(self.flow.named_parameters())

    def step(self, z):
        return self.train_step(self.flow, self.target, self.opt, z)


class Reference:
    """The reference in the program's place (the control), in `prec`, its
    gradient summed over chunks of `control_chunk` draws."""

    def __init__(self, cell, params, centers, prec="tf32"):
        self.cell, self.prec = cell, prec
        self.p = {k: v.requires_grad_(True)
                  for k, v in cell.ref.cast(params, prec).items()}
        self.centers = centers.to(refcore.DTYPES[prec])
        self.adam = refcore.Adam(self.p, schedule(cell.traffic), clip=True)

    def named_params(self):
        return self.p

    def step(self, z):
        loss, grads = self.cell.ref.loss_and_grads(
            self.cell.cfg, self.p, self.centers,
            z.to(refcore.DTYPES[self.prec]), self.prec,
            self.cell.traffic["control_chunk"])
        for k, v in self.p.items():
            v.grad = grads[k]
        self.adam.step(self.p, grads)
        return torch.tensor(loss)


class Draws:
    """Step i's base draws, from a generator seeded for i alone."""

    def __init__(self, cell, centers):
        self.cell, self.centers = cell, centers
        self.gen = torch.Generator(device=cell.device)

    def at(self, i):
        self.gen.manual_seed(sub_seed(self.cell.seed, "latents", i))
        return self.cell.ref.base_draws(self.cell.cfg, self.centers,
                                        self.cell.traffic["batch"],
                                        self.gen)


def run(cell, system=None):
    cfg, tr, ref, dev, seed = (cell.cfg, cell.traffic, cell.ref, cell.device,
                               cell.seed)
    params = ref.init_params(cfg, generator(dev, seed, "init"), dev)
    cell.mark("weights")
    theta0 = {k: v.clone() for k, v in params.items()}
    centers = ref.lattice(cfg, dev)
    system = (system or Port)(cell, params, centers)
    cell.mark("build")
    draws = Draws(cell, centers)
    losses, grads, theta3 = [], None, None
    for i in range(tr["setup_steps"]):
        loss = system.step(draws.at(i))
        if i < 3:
            losses.append(loss.clone())
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in
                     system.named_params().items()}
        if i == 2:
            theta3 = {n: p.detach().clone() for n, p in
                      system.named_params().items()}
    window = Window(cell)
    window.open()
    i = tr["setup_steps"]
    while True:
        with span("train_step"):
            system.step(draws.at(i))
        i += 1
        if window.done(1):
            break
    seconds = window.close()
    out = Outcome(units=window.units, window_s=seconds,
                  setup_s=window.setup_s, memory_peak=memory_peak(dev),
                  trace=cell.tracer.summary)
    out.e2e["train_step_ms"] = 1e3 * seconds / window.units
    out.layer["flops_per_unit"] = ref.flops_rkl_step(cfg, tr["batch"])
    out.layer["attention_flops_per_unit"] = ref.flops_attention_forward(
        cfg, tr["batch"])
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if out.trace is not None:
        out.layer["crqs_calls"] = crqs_calls(cell, params, draws.at(0))
        out.layer["rows_per_unit"] = tr["batch"] * cfg["nparticles"]
    out.checks = check(cell, theta0, centers, [draws.at(i) for i in range(3)],
                       [float(v) for v in losses], grads, theta3)
    return out


def crqs_calls(cell, params, z):
    """The circular spline calls of one step's sampling, on its first
    `bound_rows` draws, as the float32 reference makes them: the inputs of
    the byte count, scaled to the batch by the reader."""
    log = []
    with torch.no_grad():
        cell.ref.sample(cell.cfg, params, z[:cell.traffic["bound_rows"]],
                        "float32", log)
    return log


def check(cell, theta0, centers, zs, losses, grads, theta3):
    """The float64 reference's first three steps against the program's."""
    cfg, ref = cell.cfg, cell.ref
    p = {k: v.requires_grad_(True) for k, v in ref.cast(theta0,
                                                         "float64").items()}
    c64 = centers.double()
    adam = refcore.Adam(p, schedule(cell.traffic), clip=True)
    ref_losses, g1 = [], None
    for z in zs:
        loss, g = ref.loss_and_grads(cfg, p, c64, z.double(), "float64",
                                     cell.traffic["check_chunk"])
        ref_losses.append(loss)
        g1 = g1 or g
        adam.step(p, g)
    return training_gaps(losses, ref_losses, grads, g1, theta0, theta3, p)
