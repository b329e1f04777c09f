"""Forward-KL training through the program's `train.fused.train_flow_fused`,
its minibatches fed by the benchmark (`batches=`), no checkpoints.

One call of train_flow_fused carries set-up and window: the feed hands out
the set-up steps' batches, then opens the window and hands out batches
until its time is up, when it raises `WindowClosed` out of the call. The
flow and the optimizer the window trains are those of the first steps.

`train_step_ms`: the window's seconds over the steps completed in it.

The check: the float64 reference trains from the same weights on the same
first three batches (optax's Adam, LJ.yaml's cosine rate). Numbers:
`loss_gap` (each of the three losses, as the program hands them to
`backward`), `grad_gap` (the first step's gradient, `p.grad` after it, as
the optimizer got it, by the worst leaf's norm), `grad_diff_median` (the
same gradient's difference from the reference's, slice by slice, a
conditioner MLP a slice, the median over slices: a frame whose spline bin
differs between the program's float32 parameters and the reference's
float64 ones moves the leaves' norms, and the whole gradient's
difference, as much as TF32 does on a few seeds in 60, but only in
its own dim's MLP, while TF32's error in every product moves every
slice), `step_gap` (the
change of the parameters after three steps, by the worst leaf's norm,
leaves whose reference gradient is below a thousandth of the median
leaf's left out).
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from nfbench import refcore
from nfbench.kinds import (
    Outcome,
    Window,
    WindowClosed,
    generator,
    memory_peak,
)
from nfbench.trace import span


class Frames:
    """The data source train_flow_fused gathers batches from."""

    def __init__(self, traj):
        self.traj = traj


class Port:
    """The program: its NSF_AR flow holding the benchmark's weights, and
    train_flow_fused."""

    def __init__(self, cell, params, centers):
        from nfbench.ports import nsf_ar

        self.cell = cell
        self.flow = nsf_ar.build(cell.cfg, params, centers,
                                 cell.ref.half_box(cell.cfg), cell.device)

    def named_params(self):
        return dict(self.flow.named_parameters())

    def train(self, feed, frames):
        from normalizingflow_tpu_torch.train.fused import train_flow_fused

        cfg, cell = self.cell.cfg, self.cell
        train_flow_fused(
            self.flow, generator(cell.device, cell.seed, "unused"),
            Frames(frames), max_epochs=cfg["max_epochs"],
            batch_size=cell.traffic["batch"],
            learning_rate=cfg["learning_rate"], scheduler=cfg["scheduler"],
            gamma=cfg["lr_scheduler_gamma"], checkpoint_path=None,
            batches=feed, device=cell.device)


class Reference:
    """The reference in the program's place (the control): the same
    training in `prec`."""

    def __init__(self, cell, params, centers, prec="tf32"):
        self.cell, self.prec = cell, prec
        self.p = {k: v.requires_grad_(True)
                  for k, v in cell.ref.cast(params, prec).items()}
        self.centers = centers.to(refcore.DTYPES[prec])
        self.adam = refcore.Adam(self.p, refcore.cosine_lr(
            cell.cfg["learning_rate"], cell.cfg["max_epochs"]))

    def named_params(self):
        return self.p

    def train(self, feed, frames):
        for idx in feed:
            x = frames[idx].to(refcore.DTYPES[self.prec])
            for v in self.p.values():
                v.grad = None
            loss = self.cell.ref.fkl_loss(self.cell.cfg, self.p,
                                          self.centers, x, self.prec)
            loss.backward()
            self.adam.step(self.p, {k: v.grad for k, v in self.p.items()})


class LossCapture(TorchFunctionMode):
    """Keeps a copy of every tensor `backward` is called on: the losses."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.backward:
            self.losses.append(args[0].detach().clone())
        return func(*args, **(kwargs or {}))


class Feed:
    """The minibatches, row indices into the frames drawn from the seed:
    first the set-up steps', watching the first three, then the window's.
    Call k (1-based) comes after step k - 1 has been enqueued."""

    def __init__(self, cell, system, n_frames, window):
        self.cell, self.system, self.window = cell, system, window
        self.n_frames = n_frames
        self.gen = generator(cell.device, cell.seed, "batches")
        self.calls = 0
        self.capture = LossCapture()
        self.batches, self.grads, self.theta3 = [], None, None

    def __iter__(self):
        return self

    def __next__(self):
        self.calls += 1
        k = self.calls
        setup = self.cell.traffic["setup_steps"]
        if k == 1:
            self.capture.__enter__()
        elif k == 2:
            self.grads = {n: p.grad.detach().clone() for n, p in
                          self.system.named_params().items()}
        elif k == 4:
            self.theta3 = {n: p.detach().clone() for n, p in
                           self.system.named_params().items()}
            self.capture.__exit__(None, None, None)
        if k == setup + 1:
            self.window.open()
        elif k > setup + 1 and self.window.done(1):
            raise WindowClosed
        idx = torch.randint(0, self.n_frames, (self.cell.traffic["batch"],),
                            generator=self.gen, device=self.cell.device)
        if k <= 3:
            self.batches.append(idx)
        return idx


def run(cell, system=None):
    cfg, tr, ref, dev, seed = (cell.cfg, cell.traffic, cell.ref, cell.device,
                               cell.seed)
    params = ref.init_params(cfg, generator(dev, seed, "init"), dev)
    cell.mark("weights")
    theta0 = {k: v.clone() for k, v in params.items()}
    centers = ref.lattice(cfg, dev)
    frames = ref.make_frames(cfg, tr["frames"], generator(dev, seed,
                                                          "frames"), dev)
    system = (system or Port)(cell, params, centers)
    cell.mark("build")
    window = Window(cell)
    feed = Feed(cell, system, tr["frames"], window)
    try:
        with span("train_flow_fused"):
            system.train(feed, frames)
    except WindowClosed:
        pass
    seconds = window.close()
    out = Outcome(units=window.units, window_s=seconds,
                  setup_s=window.setup_s, memory_peak=memory_peak(dev),
                  trace=cell.tracer.summary)
    out.e2e["train_step_ms"] = 1e3 * seconds / max(window.units, 1)
    out.layer["flops_per_unit"] = ref.flops_fkl_step(cfg, tr["batch"])
    if out.trace is not None:
        out.layer["rqs_vjp_calls"] = rqs_calls(cell, theta0, centers,
                                               frames[feed.batches[0]])
    losses = [float(v) for v in feed.capture.losses[:3]]
    grads, theta3 = feed.grads, feed.theta3
    batches = [frames[i] for i in feed.batches]
    del feed, system
    out.checks = check(cell, theta0, centers, batches, losses, grads, theta3)
    return out


def rqs_calls(cell, params, centers, x):
    """The RQS calls of one step's density evaluation, (x, w, h, inverse,
    bounds) each, as the float32 reference makes them: the inputs of the
    VJP calls' byte count."""
    log = []
    with torch.no_grad():
        cell.ref.log_prob(cell.cfg, params, centers, x, "float32", log)
    return log


def check(cell, theta0, centers, batches, losses, grads, theta3):
    """The float64 reference's first three steps against the program's."""
    cfg, ref = cell.cfg, cell.ref
    p = {k: v.requires_grad_(True) for k, v in ref.cast(theta0,
                                                         "float64").items()}
    c64 = centers.double()
    adam = refcore.Adam(p, refcore.cosine_lr(cfg["learning_rate"],
                                             cfg["max_epochs"]))
    ref_losses, g1 = [], None
    for x in batches:
        loss = ref.fkl_loss(cfg, p, c64, x.double(), "float64")
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        ref_losses.append(float(loss.detach()))
        g1 = g1 or g
        adam.step(p, g)
    return training_gaps(losses, ref_losses, grads, g1, theta0, theta3, p)


def training_gaps(losses, ref_losses, grads, g1, theta0, theta3, p):
    """loss_gap, grad_gap, grad_diff_median and step_gap of a training
    cell's first three steps (see the module docstring)."""
    names = ("loss_gap", "grad_gap", "grad_diff_median", "step_gap")
    if len(losses) < len(ref_losses) or grads is None or theta3 is None:
        return [(name, float("inf")) for name in names]
    loss_gap = refcore.worst_of([abs(a - b) / abs(b) for a, b in
                                 zip(losses, ref_losses)])
    moving = refcore.moving_leaves(g1)
    step_prog = {k: theta3[k].double() - theta0[k].double() for k in moving}
    step_ref = {k: p[k].detach() - theta0[k].double() for k in moving}
    return list(zip(names, (loss_gap, refcore.leaf_gaps(grads, g1),
                            refcore.median_slice_difference(grads, g1),
                            refcore.leaf_gaps(step_prog, step_ref))))
