"""Optimizers and schedules, and the bench's reverse-KL training loop.

Twin of normalizingflow_tpu/train/loop.py (`make_optimizer`: Adam with the
reference's exponential, cosine or constant rate) and of the optimizer in
bench.py (`optax.chain(clip_by_global_norm(1.0),
adam(warmup_cosine_decay_schedule(0, peak, warmup, steps)))`, with peak and
warmup 1e-3 and 500 on the funnel line, 5e-4 and 300 on the spline line)
and its train loop. One Adam serves both, with or without the clip, and
reproduces optax's arithmetic, not torch.optim.Adam's:

  * clipping is optax's `select(norm < max_norm, g, (g / norm) * max_norm)`
    (torch's clip_grad_norm_ divides by norm + 1e-6 instead);
  * the learning rate of update k (0-based) is schedule(k), so the first
    update has lr = schedule(0) = 0 under the bench's warmup;
  * `decay_steps` counts the warmup, as optax's does;
  * Adam's eps sits outside the square root: m_hat / (sqrt(v_hat) + eps);
  * with `mu_dtype=torch.bfloat16` (the training loop's memory policy for
    multi-GB flows, train/fused.py::adam_mu_dtype), the first moment is
    stored in bfloat16 and updated in optax's order: b1 * mu is taken in
    bfloat16 (JAX casts the Python scalar to the moment's dtype), added to
    (1 - b1) * g in the gradient's dtype, the step uses that full-precision
    moment, and only the stored moment is rounded to bfloat16.

optax evaluates the schedule on an int32 step counter, which JAX turns into
float32 arithmetic; the port evaluates the same formula in float64, and a
float32 update rounds the rate on use.
"""

from __future__ import annotations

import math

import torch

from ..device import check_on, entry_device
from ..params import jax_leaves
from ..utils.profiling import annotate
from .objectives import reverse_kl


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps):
    """optax.warmup_cosine_decay_schedule (end value 0, exponent 1) as a
    function of the step count.

    Warmup is optax's polynomial form (init - peak) * (1 - k/W) + peak; the
    cosine part runs over decay_steps - warmup_steps steps.
    """
    cos_steps = decay_steps - warmup_steps
    if warmup_steps <= 0 or cos_steps <= 0:
        raise ValueError("need 0 < warmup_steps < decay_steps")

    def schedule(count):
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        k = min(count - warmup_steps, cos_steps)
        return peak_value * (0.5 * (1 + math.cos(math.pi * k / cos_steps)))

    return schedule


def exponential_decay(init_value, decay_rate):
    """optax.exponential_decay(init, transition_steps=1, decay_rate):
    init * rate**k."""
    return lambda count: init_value * decay_rate ** count


def cosine_decay_schedule(init_value, decay_steps):
    """optax.cosine_decay_schedule with alpha 0: k is clamped to
    decay_steps, init * (1 + cos(pi k / decay_steps)) / 2."""
    if decay_steps <= 0:
        raise ValueError("need decay_steps > 0")

    def schedule(count):
        k = min(count, decay_steps)
        return init_value * (0.5 * (1 + math.cos(math.pi * k / decay_steps)))

    return schedule


class Adam(torch.optim.Optimizer):
    """Adam (optax's defaults b1 0.9, b2 0.999, eps 1e-8) with a step
    schedule and optax's arithmetic (see the module docstring); with
    `clip`, optax's clip_by_global_norm(1.0) first. One param group. The
    second moment keeps each parameter's dtype (float32 on the card), the
    first moment too unless `mu_dtype` is given."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, schedule, clip=False, mu_dtype=None):
        super().__init__(params, {})
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} takes one parameter "
                             f"group")
        self.schedule = schedule
        self.clip = clip
        self.mu_dtype = mu_dtype
        self.count = 0  # updates applied so far
        for p in self.param_groups[0]["params"]:
            self.state[p]["mu"] = torch.zeros_like(p, dtype=mu_dtype)
            self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        b1, b2 = self.B1, self.B2
        params = [p for p in self.param_groups[0]["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]

        if self.clip:
            # optax: select(norm < 1, g, (g / norm) * 1), as a division by
            # where(norm < 1, 1, norm), which keeps the decision on the
            # device. The global norm is the norm of the leaves' norms: a
            # few launches whatever the leaf count (a sum of squares leaf
            # by leaf took three a leaf, and a flow of 480 leaves left the
            # card idle while the host issued them).
            g_norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            grads = torch._foreach_div(grads, torch.where(
                g_norm < 1.0, torch.ones_like(g_norm), g_norm))

        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        lr = self.schedule(self.count)
        self.count += 1
        if self.mu_dtype is not None:
            # one parameter at a time, the same operations as below: the
            # full-precision moment is a transient of one tensor, not of
            # the whole model
            b1_low = float(torch.tensor(b1, dtype=self.mu_dtype))
            for p, m, v, g in zip(params, mu, nu, grads):
                f = (m * b1_low).to(g.dtype) + g * (1 - b1)
                m.copy_(f)
                f.div_(1 - b1**self.count)
                f.div_(torch.sqrt(v / (1 - b2**self.count)).add_(self.EPS))
                p.add_(f.mul_(-lr))
            return
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        mu_hat = torch._foreach_div(mu, 1 - b1**self.count)
        denom = torch._foreach_div(nu, 1 - b2**self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_mul_(mu_hat, -lr)
        torch._foreach_add_(params, mu_hat)

    def state_tree(self):
        """{"count", "mu", "nu"}: the update count and both moments, as
        numpy arrays in parameter order (a checkpoint's opt_state)."""
        ps = self.param_groups[0]["params"]
        return {"count": self.count,
                "mu": [_host(self.state[p]["mu"]) for p in ps],
                "nu": [_host(self.state[p]["nu"]) for p in ps]}

    @torch.no_grad()
    def load_state_tree(self, tree):
        """Restore `state_tree()`'s output, cast to each moment's dtype
        (so a state saved under either mu_dtype loads) and device."""
        ps = self.param_groups[0]["params"]
        if len(tree["mu"]) != len(ps) or len(tree["nu"]) != len(ps):
            raise ValueError("optimizer state does not match the parameters")
        for p, mu, nu in zip(ps, tree["mu"], tree["nu"]):
            self.state[p]["mu"].copy_(torch.as_tensor(mu))
            self.state[p]["nu"].copy_(torch.as_tensor(nu))
        self.count = int(tree["count"])


def adam_state_from_optax(flow, opt_state):
    """optax.adam's state, as read_jax_checkpoint decodes it, as an
    `Adam.state_tree()` of `flow`'s parameters, for `load_state_tree`.

    The state is optax's chain of (ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count)) under a schedule, or EmptyState() in
    place of the second under a constant rate: decoded, a pair of dicts
    ({"count", "mu", "nu"}, {"count"} or {}). mu and nu have the params'
    tree structure and come out in parameter order (params.jax_leaves;
    bfloat16 moments stay tensors, cast on loading). Adam's count drives
    both the bias correction and the schedule, so the two counts must
    agree. Raises where they do not, where the state is no such pair, or
    where mu or nu do not fit the flow."""
    if not isinstance(opt_state, (tuple, list)) or len(opt_state) != 2:
        raise ValueError(f"not an optax.adam state: {type(opt_state)}")
    adam, sched = opt_state
    if not (isinstance(adam, dict) and set(adam) == {"count", "mu", "nu"}
            and isinstance(sched, dict) and set(sched) <= {"count"}):
        raise ValueError("not an optax.adam state: (ScaleByAdamState, "
                         "ScaleByScheduleState | EmptyState) expected")
    count = int(adam["count"])
    if "count" in sched and int(sched["count"]) != count:
        raise ValueError(f"optax's Adam count {count} != its schedule's "
                         f"{int(sched['count'])}")
    return {"count": count, "mu": jax_leaves(flow, adam["mu"]),
            "nu": jax_leaves(flow, adam["nu"])}


def _host(t):
    """A CPU copy of t: a numpy array, or a tensor where numpy has no such
    dtype (bfloat16)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


class ClippedAdam(Adam):
    """clip_by_global_norm(1.0) followed by Adam."""

    def __init__(self, params, schedule):
        super().__init__(params, schedule, clip=True)


def make_optimizer(params, learning_rate=1e-4, scheduler="exponential",
                   gamma=0.999, max_epochs=4000, mu_dtype=None):
    """Adam with the reference's rate schedules: exponential (lr gamma^k),
    cosine to 0 over max_epochs, or constant (None, "none", "constant").
    `mu_dtype=torch.bfloat16` keeps Adam's first moment in bfloat16, the
    memory policy train/fused.py applies to flows too large for the
    device in float32; by default both moments keep the parameters'
    dtype."""
    if scheduler == "exponential":
        schedule = exponential_decay(learning_rate, gamma)
    elif scheduler == "cosine":
        schedule = cosine_decay_schedule(learning_rate, max_epochs)
    elif scheduler in (None, "none", "constant"):
        def schedule(count):
            return learning_rate
    else:
        raise ValueError(f"unknown scheduler {scheduler!r}")
    return Adam(params, schedule, mu_dtype=mu_dtype)


def bench_optimizer(params, steps, warmup_steps=500, peak_lr=1e-3):
    """The bench's optimizer: clip 1.0, Adam, lr warmup to `peak_lr` over
    `warmup_steps`, then cosine decay to 0 at `steps`. The funnel line uses
    (1e-3, 500), the spline line (5e-4, 300)."""
    return ClippedAdam(params, warmup_cosine_decay_schedule(
        0.0, peak_lr, warmup_steps, steps))


def train_step(flow, target, optimizer, z):
    """One reverse-KL update on the prior draws `z`; returns the loss
    tensor (pre-update, as the JAX loop reports it)."""
    optimizer.zero_grad(set_to_none=True)
    with annotate("train.loss"):
        loss = reverse_kl(flow, target, z=z)
    with annotate("train.backward"):
        loss.backward()
    optimizer.step()
    return loss.detach()


def train(flow, target, steps, batch, generator, device="cuda",
          warmup_steps=500, peak_lr=1e-3):
    """The bench's training run: `steps` reverse-KL updates at `batch`
    prior draws each, drawn from `generator`, with `bench_optimizer`.
    Returns the final loss."""
    device = entry_device(device)
    check_on(device, *flow.parameters())
    optimizer = bench_optimizer(list(flow.parameters()), steps, warmup_steps,
                                peak_lr)
    loss = None
    for _ in range(steps):
        z = flow.prior.sample(batch, generator=generator)
        loss = train_step(flow, target, optimizer, z)
    return float(loss)
