"""Plain PyTorch pieces of the benchmark's references.

Nothing here imports the program. Every reference runs in one of two
precisions, named by `prec`:

  * "float64": float64 tensors, the reference proper;
  * "tf32": float32 tensors with every matrix product's operands rounded to
    TF32 (10 mantissa bits, round to nearest even) and accumulated in
    float32, as a tensor core's TF32 mode does. This is the control: the
    nearest precision below the configurations' float32 with TF32 off. The
    rounding is done by hand, so the control computes the same on any
    device.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"float64": torch.float64, "tf32": torch.float32}


def round_tf32(x):
    """float32 x rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Einsum(torch.autograd.Function):
    """A two-operand einsum whose products, forward and backward, take
    TF32-rounded operands. Every index of an operand appears in the other
    operand or in the output, so each gradient is an einsum too."""

    @staticmethod
    def forward(ctx, eq, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        sa, sb = ins.split(",")
        g = round_tf32(g)
        return (None, torch.einsum(f"{out},{sb}->{sa}", g, b),
                torch.einsum(f"{sa},{out}->{sb}", a, g))


def ein(eq, a, b, prec):
    """torch.einsum(eq, a, b) in `prec`."""
    if prec == "tf32":
        return _TF32Einsum.apply(eq, a, b)
    return torch.einsum(eq, a, b)


def mlp(p, x, prec, prefix=""):
    """tanh(x w1 + b1) -> tanh(. w2 + b2) -> . w3 + b3, weights (fan_in,
    fan_out) under `prefix` + w1..b3 in the dict p."""
    h = torch.tanh(ein("bi,io->bo", x, p[prefix + "w1"], prec)
                   + p[prefix + "b1"])
    h = torch.tanh(ein("bi,io->bo", h, p[prefix + "w2"], prec)
                   + p[prefix + "b2"])
    return ein("bi,io->bo", h, p[prefix + "w3"], prec) + p[prefix + "b3"]


def gaussian_lp(dev, var):
    d = dev.shape[-1]
    return (-0.5 * torch.sum(dev * dev, dim=-1) / var
            - 0.5 * d * (math.log(2.0 * math.pi) + math.log(var)))


# ----------------------------------------------------------------- RQS
MIN_BIN_WIDTH = MIN_BIN_HEIGHT = MIN_DERIVATIVE = 1e-3


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _knots(unnormalized, k, min_size, lo, hi):
    probs = torch.softmax(unnormalized, dim=-1)
    probs = min_size + (1.0 - min_size * k) * probs
    cum = (hi - lo) * torch.cumsum(probs, dim=-1) + lo
    edge = cum[..., :1]
    cum = torch.cat([torch.full_like(edge, lo), cum[..., :-1],
                     torch.full_like(edge, hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def _pick(values, idx):
    return torch.gather(values, -1, idx[..., None])[..., 0]


def rqs(x, w, h, d, inverse, left, right, bottom, top):
    """The monotone rational-quadratic spline of Durkan et al. (2019) with
    identity tails, as the configurations define it: bins by softmax with a
    1e-3 floor, knot derivatives 1e-3 + softplus with unit slope at both
    ends, the inverse by the stable root 2c / (-b - sqrt(disc)). x (...),
    w and h (..., K), d (..., K-1). Returns (y, log|dy/dx|)."""
    k = w.shape[-1]
    lo, hi = (bottom, top) if inverse else (left, right)
    inside = (x >= lo) & (x <= hi)
    edge = torch.full_like(d[..., :1], math.log(math.expm1(
        1.0 - MIN_DERIVATIVE)))
    deriv = MIN_DERIVATIVE + softplus(torch.cat([edge, d, edge], dim=-1))
    xs = torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
    cw, wd = _knots(w, k, MIN_BIN_WIDTH, left, right)
    ch, ht = _knots(h, k, MIN_BIN_HEIGHT, bottom, top)
    knots = ch if inverse else cw
    idx = torch.clamp(torch.sum(xs[..., None] >= knots, dim=-1) - 1, 0, k - 1)
    icw, iw = _pick(cw, idx), _pick(wd, idx)
    ich, ih = _pick(ch, idx), _pick(ht, idx)
    delta = ih / iw
    d0, d1 = _pick(deriv, idx), _pick(deriv[..., 1:], idx)
    s = d0 + d1 - 2.0 * delta
    if inverse:
        dy = xs - ich
        a = dy * s + ih * (delta - d0)
        b = ih * d0 - dy * s
        c = -delta * dy
        t = (2.0 * c) / (-b - torch.sqrt(b * b - 4.0 * a * c))
        y = t * iw + icw
    else:
        t = (xs - icw) / iw
        y = ich + ih * (delta * t * t + d0 * t * (1.0 - t)) / (
            delta + s * t * (1.0 - t))
    t1m = t * (1.0 - t)
    dnum = delta * delta * (d1 * t * t + 2.0 * delta * t1m
                            + d0 * (1.0 - t) * (1.0 - t))
    ld = torch.log(dnum) - 2.0 * torch.log(delta + s * t1m)
    if inverse:
        ld = -ld
    return (torch.where(inside, y, x),
            torch.where(inside, ld, torch.zeros_like(ld)))


# ------------------------------------------------------- optimization
def cosine_lr(init, decay_steps):
    """optax.cosine_decay_schedule (alpha 0)."""
    return lambda k: init * 0.5 * (1 + math.cos(
        math.pi * min(k, decay_steps) / decay_steps))


def warmup_cosine_lr(peak, warmup, decay_steps):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)."""
    def lr(k):
        if k < warmup:
            return peak * k / warmup
        j = min(k - warmup, decay_steps - warmup)
        return peak * 0.5 * (1 + math.cos(math.pi * j / (decay_steps
                                                          - warmup)))
    return lr


class Adam:
    """optax's Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root),
    update k at lr(k), optionally after optax's clip_by_global_norm(1.0),
    on a dict of leaf tensors."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr, clip=False):
        self.lr, self.clip, self.count = lr, clip, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        lr = self.lr(self.count)
        self.count += 1
        self.update(params, grads, -lr, 1 - self.B1 ** self.count,
                    1 - self.B2 ** self.count)

    @torch.no_grad()
    def update(self, params, grads, neg_lr, c1, c2):
        """One update at rate -neg_lr with bias corrections c1, c2: floats,
        or 0-dim tensors (so that a CUDA graph can replay it)."""
        keys = list(params)
        ps = [params[k] for k in keys]
        gs = [grads[k] for k in keys]
        mu = [self.mu[k] for k in keys]
        nu = [self.nu[k] for k in keys]
        if self.clip:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(gs)))
            div = torch.where(norm < 1.0, torch.ones_like(norm), norm)
            gs = torch._foreach_div(gs, div)
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, torch._foreach_mul(gs, 1 - self.B1))
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1 - self.B2))
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(ps, upd)


def graphed(fn, state):
    """fn() (CUDA tensors in and out, updating the tensors in `state` in
    place) captured once in a CUDA graph; returns a function that replays
    it and returns fn's output tensors, overwritten. The warm-up calls that
    capture needs first are undone on `state`."""
    saved = [t.detach().clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)

    def replay():
        graph.replay()
        return out

    return replay


def worst(t):
    """The largest entry of t (0 when empty, inf when any is NaN)."""
    if t.numel() == 0:
        return 0.0
    if bool(torch.isnan(t).any()):
        return math.inf
    return float(t.max())


def worst_of(values):
    """max() that a NaN cannot hide: inf if any value is NaN."""
    return math.inf if any(v != v for v in values) else max(values)


def leaf_gaps(prog, ref):
    """Worst leaf of |norm(prog leaf) - norm(ref leaf)| over the larger of
    the reference leaf's norm and the median reference leaf's norm, over
    the leaves both dicts hold."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return worst_of([
        abs(float(torch.linalg.vector_norm(prog[k].double())) - r)
        / max(r, med) for k, r in norms.items()])


def median_slice_difference(prog, ref):
    """The median over slices of norm(prog - ref) / norm(ref), a slice
    being a row (first-axis entry) of a leaf of two or more axes, else the
    whole leaf; slices whose reference norm is under a thousandth of the
    median slice's are left out (masked inputs' rows have none). A stacked
    conditioner's rows are its MLPs, so one frame that lands in another
    spline bin moves one slice, and the median reads what moves them
    all."""
    ref_norms, diff_norms = [], []
    for k, r in ref.items():
        r, q = r.double(), prog[k].double()
        rows = (lambda t: t.flatten(1)) if r.dim() >= 2 else (
            lambda t: t.reshape(1, -1))
        ref_norms.append(torch.linalg.vector_norm(rows(r), dim=1))
        diff_norms.append(torch.linalg.vector_norm(rows(q - r), dim=1))
    rn, dn = torch.cat(ref_norms), torch.cat(diff_norms)
    if bool(torch.isnan(dn).any()):
        return math.inf
    keep = rn >= 1e-3 * rn.median()
    return float((dn[keep] / rn[keep]).median())


def moving_leaves(ref_grads):
    """Names of the leaves whose reference gradient norm is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone and are left out of the change."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v >= 1e-3 * med]


# ---------------------------------------------------------------- HMC
def hmc_transition(lp_grad, z, draws, step, inv_mass, leapfrog, jitter=0.2):
    """One HMC transition of chains z (n, d) from the raw draws (jitter
    U[-1,1) (n, 1), momentum N(0,1) (n, d), accept U[0,1) (n,)): the
    jittered step size, kick-drift-kick leapfrog, both Hamiltonians and
    the Metropolis test. Returns (proposal q, lp at q, gradient at q,
    log acceptance min(0, dH), log u, accepted)."""
    u_jitter, normal, u_accept = draws
    lp0, g = lp_grad(z)
    eps = step * (1.0 + jitter * u_jitter)
    p0 = torch.sqrt(1.0 / inv_mass) * normal
    q, p = z, p0
    for _ in range(leapfrog):
        p = p + 0.5 * eps * g
        q = q + eps * (inv_mass * p)
        lp, g = lp_grad(q)
        p = p + 0.5 * eps * g
    h_old = -lp0 + 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    h_new = -lp + 0.5 * torch.sum(inv_mass * p * p, dim=-1)
    log_a = torch.clamp(h_old - h_new, max=0.0)
    log_u = torch.log(u_accept)
    accepted = (log_u < log_a) & torch.isfinite(h_new)
    return q, lp, g, log_a, log_u, accepted


def lp_and_grad(logprob):
    """(n, d) -> (log-prob (n,), its gradient (n, d)) of a batched
    log-density, by autograd."""
    def f(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            lp = logprob(z)
            (g,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), g
    return f
