"""Plain reference of funnel64_realnvp: RealNVP (ActNorm + affine
couplings, tanh MLPs) over a standard normal prior, Neal's funnel, the
benchmark's own reverse-KL fit, and the shape counts of its matrix
products.

Parameters are a dict keyed by the program's parameter names
(`flow.named_parameters()` of NormalizingFlow(prior, Chain([ActNorm] +
couplings))), so the same tensors load into both sides. Imports torch and
nfbench.refcore only.
"""

from __future__ import annotations

import math

import torch

from nfbench import refcore

MLPS = ("t1", "s1", "t2", "s2")


def shapes(cfg):
    """{name: shape} of every parameter, in the program's order."""
    d, hd = cfg["dim"], cfg["hidden_dim"]
    half, other = d // 2, d - d // 2
    out = {}
    if cfg["actnorm"]:
        out["bijector.bijectors.0.mu"] = (d,)
        out["bijector.bijectors.0.log_sigma"] = (d,)
    first = 1 if cfg["actnorm"] else 0
    for layer in range(cfg["layers"]):
        for m in MLPS:
            fan_in, fan_out = (half, other) if m in ("t1", "s1") else (
                other, half)
            pre = f"bijector.bijectors.{first + layer}.{m}."
            for name, shape in (("w1", (fan_in, hd)), ("b1", (hd,)),
                                ("w2", (hd, hd)), ("b2", (hd,)),
                                ("w3", (hd, fan_out)), ("b3", (fan_out,))):
                out[pre + name] = shape
    return out


def init_params(cfg, generator, device):
    """Initial weights from `generator`, in one draw: each conditioner
    leaf uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch.nn.Linear's
    default), ActNorm zero. float32."""
    sh = shapes(cfg)
    sizes = [math.prod(s) for s in sh.values()]
    u = torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1
    params, at = {}, 0
    for (name, shape), size in zip(sh.items(), sizes):
        part = u[at:at + size].reshape(shape)
        at += size
        if name.endswith((".mu", ".log_sigma")):
            params[name] = torch.zeros(shape, device=device)
            continue
        fan_in = shape[0] if name.endswith(("w1", "w2", "w3")) else None
        if fan_in is None:  # a bias: the fan-in of its layer's weight
            fan_in = sh[name[:-2] + "w" + name[-1]][0]
        params[name] = part / math.sqrt(fan_in)
    return params


def cast(params, prec):
    return {k: v.detach().to(refcore.DTYPES[prec]) for k, v in
            params.items()}


def _layers(cfg):
    first = 1 if cfg["actnorm"] else 0
    return [f"bijector.bijectors.{first + i}." for i in range(cfg["layers"])]


def inverse(cfg, p, z, prec):
    """Latent z (n, dim) -> (x, log|dx/dz|), the flow's sampling
    direction."""
    half = cfg["dim"] // 2
    ld = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    y = z
    for pre in reversed(_layers(cfg)):
        lower, upper = y[:, :half], y[:, half:]
        t2 = refcore.mlp(p, upper, prec, pre + "t2.")
        s2 = refcore.mlp(p, upper, prec, pre + "s2.")
        lower = (lower - t2) * torch.exp(-s2)
        t1 = refcore.mlp(p, lower, prec, pre + "t1.")
        s1 = refcore.mlp(p, lower, prec, pre + "s1.")
        upper = (upper - t1) * torch.exp(-s1)
        y = torch.cat([lower, upper], dim=1)
        ld = ld - torch.sum(s1, dim=1) - torch.sum(s2, dim=1)
    if cfg["actnorm"]:
        mu, ls = p["bijector.bijectors.0.mu"], p[
            "bijector.bijectors.0.log_sigma"]
        y = (y - mu) * torch.exp(-ls)
        ld = ld - torch.sum(ls)
    return y, ld


def prior_lp(z):
    return refcore.gaussian_lp(z, 1.0)


def target_lp(x):
    """Neal's funnel: v ~ N(0, 3^2), x_i | v ~ N(0, e^v)."""
    d = x.shape[-1]
    v, rest = x[..., 0], x[..., 1:]
    lp_v = -0.5 * (v / 3.0) ** 2 - math.log(3.0)
    lp_rest = (-0.5 * torch.sum(rest * rest, dim=-1) * torch.exp(-v)
               - 0.5 * (d - 1) * v)
    return lp_v + lp_rest - 0.5 * d * math.log(2 * math.pi)


def pullback_lp(cfg, p, prec):
    """Latent log-density log pi(T(z)) + log|det dT/dz|, (n, dim) -> (n,)."""
    def lp(z):
        x, ld = inverse(cfg, p, z, prec)
        return target_lp(x) + ld
    return lp


def reverse_kl(cfg, p, z, prec):
    """E_z[log q(x) - log pi(x)] over the latents z."""
    x, ld = inverse(cfg, p, z, prec)
    return torch.mean(prior_lp(z) - ld) - torch.mean(target_lp(x))


def fit(cfg, params, generator):
    """The benchmark's reverse-KL fit, in place on float32 `params`:
    cfg["fit_steps"] updates at cfg["fit_batch"] prior draws, clip 1.0 and
    Adam with warmup and cosine decay. On the card a step (the loss, its
    gradient and the update, the rate read from a table by a step counter
    on the device) is one CUDA graph."""
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    leaves = list(p.values())
    device = leaves[0].device
    opt = refcore.Adam(p, None, clip=True)
    lr = refcore.warmup_cosine_lr(cfg["fit_peak_lr"], cfg["fit_warmup"],
                                  cfg["fit_steps"])
    table = torch.tensor([[-lr(k), 1 - opt.B1 ** (k + 1),
                           1 - opt.B2 ** (k + 1)]
                          for k in range(cfg["fit_steps"])], device=device)
    count = torch.zeros(1, dtype=torch.int64, device=device)
    z = torch.zeros(cfg["fit_batch"], cfg["dim"], device=device)

    def step():
        loss = reverse_kl(cfg, p, z, "float32")
        grads = dict(zip(p, torch.autograd.grad(loss, leaves)))
        opt.update(p, grads, *table.index_select(0, count)[0])
        count.add_(1)

    if device.type == "cuda":
        step = refcore.graphed(step, leaves + list(opt.mu.values())
                               + list(opt.nu.values()) + [count])
    for _ in range(cfg["fit_steps"]):
        torch.randn(z.shape, generator=generator, device=device, out=z)
        step()
    return {k: v.detach() for k, v in p.items()}


# ---------------------------------------------------------- shape counts
def mlp_macs(cfg):
    """Multiply-adds of one row through each conditioner MLP, and through
    its first matrix product alone: ((half, other) pairs), summed over the
    four MLPs of one coupling layer."""
    d, hd = cfg["dim"], cfg["hidden_dim"]
    half, other = d // 2, d - d // 2
    whole = 2 * (half * hd + hd * hd + hd * other) + 2 * (
        other * hd + hd * hd + hd * half)
    first_of_t2_s2 = 2 * other * hd
    return whole, first_of_t2_s2


def flops_inverse(cfg, rows):
    """Matrix-product FLOPs of flow.inverse on `rows` latents."""
    whole, _ = mlp_macs(cfg)
    return 2 * rows * cfg["layers"] * whole


def flops_grad_eval(cfg, rows):
    """The inverse and its gradient in z (parameters frozen): every product
    again for the input's cotangent."""
    return 2 * flops_inverse(cfg, rows)


def flops_rkl_step(cfg, rows):
    """One reverse-KL step: the inverse, the weights' cotangents, and the
    inputs' cotangents except those of the first products of t2 and s2 in
    the layer applied first, whose input is the latent itself."""
    whole, skip = mlp_macs(cfg)
    fwd = rows * cfg["layers"] * whole
    return 2 * (3 * fwd - rows * skip)
