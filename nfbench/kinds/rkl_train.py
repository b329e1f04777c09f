"""Reverse-KL training steps through the program's `train.loop.train_step`
with the bench's optimizer (`bench_optimizer`: clip 1.0, Adam, warmup then
cosine decay), on prior draws made by the benchmark, step i's from its own
seed.

Set-up builds the flow and the optimizer and runs the first
`setup_steps` steps; the window runs the same objects until its time is up.

`train_step_ms`: the window's seconds over the steps completed in it.

The check: the float64 reference trains from the same weights on the same
first three draws. Numbers: `loss_gap`, `grad_gap`,
`grad_diff_median`, `step_gap`, as in the forward-KL cell
(kinds/fkl_train.py).
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
from nfbench.trace import span


def schedule(tr):
    return refcore.warmup_cosine_lr(tr["peak_lr"], tr["warmup_steps"],
                                    tr["schedule_steps"])


class Port:
    """The program: its RealNVP flow holding the benchmark's weights, the
    funnel, `bench_optimizer` and `train_step`."""

    def __init__(self, cell, params):
        from normalizingflow_tpu_torch.train.loop import (
            bench_optimizer,
            train_step,
        )
        from nfbench.ports import realnvp

        tr = cell.traffic
        self.flow, self.target = realnvp.build(cell.cfg, params, cell.device)
        self.opt = bench_optimizer(list(self.flow.parameters()),
                                   tr["schedule_steps"], tr["warmup_steps"],
                                   tr["peak_lr"])
        self.train_step = train_step

    def named_params(self):
        return dict(self.flow.named_parameters())

    def step(self, z):
        return self.train_step(self.flow, self.target, self.opt, z)


class Reference:
    """The reference in the program's place (the control), in `prec`."""

    def __init__(self, cell, params, prec="tf32"):
        self.cell, self.prec = cell, prec
        self.p = {k: v.requires_grad_(True)
                  for k, v in cell.ref.cast(params, prec).items()}
        self.adam = refcore.Adam(self.p, schedule(cell.traffic), clip=True)

    def named_params(self):
        return self.p

    def step(self, z):
        for v in self.p.values():
            v.grad = None
        loss = self.cell.ref.reverse_kl(self.cell.cfg, self.p,
                                        z.to(refcore.DTYPES[self.prec]),
                                        self.prec)
        loss.backward()
        self.adam.step(self.p, {k: v.grad for k, v in self.p.items()})
        return loss.detach()


class Latents:
    """Step i's prior draws, from a generator seeded for i alone."""

    def __init__(self, seed, batch, dim, device):
        self.seed, self.batch, self.dim = seed, batch, dim
        self.gen = torch.Generator(device=device)
        self.device = device

    def at(self, i):
        self.gen.manual_seed(sub_seed(self.seed, "latents", i))
        return torch.randn(self.batch, self.dim, generator=self.gen,
                           device=self.device)


def run(cell, system=None):
    cfg, tr, ref, dev, seed = (cell.cfg, cell.traffic, cell.ref, cell.device,
                               cell.seed)
    params = ref.init_params(cfg, generator(dev, seed, "init"), dev)
    cell.mark("weights")
    theta0 = {k: v.clone() for k, v in params.items()}
    system = (system or Port)(cell, params)
    cell.mark("build")
    latents = Latents(seed, tr["batch"], cfg["dim"], dev)
    losses, grads, theta3 = [], None, None
    for i in range(tr["setup_steps"]):
        loss = system.step(latents.at(i))
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
            system.step(latents.at(i))
        i += 1
        if window.done(1):
            break
    seconds = window.close()
    out = Outcome(units=window.units, window_s=seconds,
                  setup_s=window.setup_s, memory_peak=memory_peak(dev),
                  trace=cell.tracer.summary)
    out.e2e["train_step_ms"] = 1e3 * seconds / window.units
    out.layer["flops_per_unit"] = ref.flops_rkl_step(cfg, tr["batch"])
    del system
    out.checks = check(cell, theta0, [latents.at(i) for i in range(3)],
                       [float(v) for v in losses], grads, theta3)
    return out


def check(cell, theta0, zs, losses, grads, theta3):
    """The float64 reference's first three steps against the program's."""
    cfg, ref = cell.cfg, cell.ref
    p = {k: v.requires_grad_(True) for k, v in ref.cast(theta0,
                                                         "float64").items()}
    adam = refcore.Adam(p, schedule(cell.traffic), clip=True)
    ref_losses, g1 = [], None
    for z in zs:
        loss = ref.reverse_kl(cfg, p, z.double(), "float64")
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        ref_losses.append(float(loss.detach()))
        g1 = g1 or g
        adam.step(p, g)
    return training_gaps(losses, ref_losses, grads, g1, theta0, theta3, p)
