"""Plain reference of lj32_nsf_ar: configs/LJ.yaml's flow, NSF_AR (spline
autoregressive layers whose dim-1 conditioners are masked tanh MLPs on the
periodic embedding of the earlier coordinates) over an Einstein crystal on
the fcc lattice, its forward-KL loss and Adam, its sampling direction, and
the shape counts of its matrix products.

Parameters are a dict keyed by the program's parameter names
(`flow.named_parameters()` of NormalizingFlow(EinsteinCrystal,
Chain([SplineAR] * nlayers))). Imports torch and nfbench.refcore only.
"""

from __future__ import annotations

import math

import torch

from nfbench import refcore


def half_box(cfg):
    """B = (N / (8 rho))^(1/3): the box is [-B, B]^3 and B the spline's
    tail bound."""
    return (cfg["nparticles"] / (8.0 * cfg["rho"])) ** (1.0 / 3.0)


def lattice(cfg, device, dtype=torch.float32):
    """The fcc lattice, (nparticles, 3): 4 sites a cubic cell, the cells
    filling the box, in data/lj_fcc_ref.xyz's order."""
    n_cells = round((cfg["nparticles"] / 4) ** (1 / 3))
    b = half_box(cfg)
    a = 2.0 * b / n_cells
    basis = torch.tensor([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]],
                         dtype=torch.float64)
    cells = torch.cartesian_prod(*[torch.arange(n_cells,
                                                dtype=torch.float64)] * 3)
    sites = (cells[:, None, :] + basis[None]).reshape(-1, 3) * a - b
    return sites.to(device=device, dtype=dtype)


def sizes(cfg):
    dim = cfg["nparticles"] * cfg["dim"]
    n = dim - 1
    feat = (2 if cfg["periodic"] else 1) * n
    return dim, n, feat, cfg["hidden_dim"], 3 * cfg["nsplines"] - 1


def shapes(cfg):
    """{name: shape} of every parameter, in the program's order."""
    dim, n, feat, hd, out = sizes(cfg)
    sh = {}
    for layer in range(cfg["nlayers"]):
        pre = f"bijector.bijectors.{layer}."
        sh[pre + "init_raw"] = (out,)
        for name, s in (("w1", (n, feat, hd)), ("b1", (n, hd)),
                        ("w2", (n, hd, hd)), ("b2", (n, hd)),
                        ("w3", (n, hd, out)), ("b3", (n, out))):
            sh[pre + "cond." + name] = s
    return sh


def init_params(cfg, generator, device):
    """Initial weights from `generator` in one draw, by the program's rule:
    MLP i's first layer uniform with bound 1/sqrt(its fan-in, 2i), the
    others 1/sqrt(hidden), init_raw uniform(-1/2, 1/2). float32."""
    dim, n, feat, hd, out = sizes(cfg)
    sh = shapes(cfg)
    total = sum(math.prod(s) for s in sh.values())
    u = torch.rand(total, generator=generator, device=device) * 2 - 1
    fan_in = torch.arange(1, dim, device=device, dtype=torch.float32) * (
        2.0 if cfg["periodic"] else 1.0)
    bound1 = 1.0 / torch.sqrt(fan_in)
    params, at = {}, 0
    for name, shape in sh.items():
        size = math.prod(shape)
        part = u[at:at + size].reshape(shape)
        at += size
        leaf = name.rsplit(".", 1)[1]
        if leaf == "init_raw":
            params[name] = part * 0.5
        elif leaf == "w1":
            params[name] = part * bound1[:, None, None]
        elif leaf == "b1":
            params[name] = part * bound1[:, None]
        else:
            params[name] = part / math.sqrt(hd)
    return params


def cast(params, prec):
    return {k: v.detach().to(refcore.DTYPES[prec]) for k, v in
            params.items()}


def row_masks(cfg, device, dtype):
    dim, n, feat, _, _ = sizes(cfg)
    i = torch.arange(1, dim, device=device)[:, None]
    base = (torch.arange(n, device=device)[None, :] < i).to(dtype)
    return torch.cat([base, base], 1) if cfg["periodic"] else base


def _features(cfg, x):
    base = x[:, :x.shape[1] - 1]
    if not cfg["periodic"]:
        return base
    ang = math.pi * base / half_box(cfg)
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def _prep(cfg, raw):
    k, b = cfg["nsplines"], half_box(cfg)
    w = 2.0 * b * torch.softmax(raw[..., :k], dim=-1)
    h = 2.0 * b * torch.softmax(raw[..., k:2 * k], dim=-1)
    return w, h, refcore.softplus(raw[..., 2 * k:])


def _rqs(cfg, x, w, h, d, inverse, log):
    b = half_box(cfg)
    bounds = (-b, b, -b, b)
    if log is not None:
        log.append((x.reshape(-1), w.reshape(-1, w.shape[-1]),
                    h.reshape(-1, h.shape[-1]), inverse, bounds))
    return refcore.rqs(x, w, h, d, inverse, *bounds)


def layer_forward(cfg, p, pre, x, prec, masks, log=None):
    """One SplineAR layer, data -> latent, every conditioner at once."""
    b = x.shape[0]
    w1 = p[pre + "cond.w1"] * masks[:, :, None]
    h = torch.tanh(refcore.ein("bf,ifh->ibh", _features(cfg, x), w1, prec)
                   + p[pre + "cond.b1"][:, None, :])
    h = torch.tanh(refcore.ein("ibh,ihg->ibg", h, p[pre + "cond.w2"], prec)
                   + p[pre + "cond.b2"][:, None, :])
    raw = refcore.ein("ibh,iho->ibo", h, p[pre + "cond.w3"], prec) + p[
        pre + "cond.b3"][:, None, :]
    raw0 = p[pre + "init_raw"].expand(1, b, raw.shape[-1])
    raw = torch.cat([raw0, raw], 0).transpose(0, 1)
    z, ld = _rqs(cfg, x, *_prep(cfg, raw), False, log)
    return z, torch.sum(ld, dim=1)


def layer_inverse(cfg, p, pre, z, prec, masks, log=None):
    """One SplineAR layer, latent -> data, one coordinate at a time."""
    b, dim = z.shape
    raw0 = p[pre + "init_raw"].expand(b, -1)
    x0, ld = _rqs(cfg, z[:, 0], *_prep(cfg, raw0), True, log)
    cols = [x0]
    for i in range(1, dim):
        part = torch.cat([torch.stack(cols, dim=1),
                          z.new_zeros(b, dim - i)], 1)
        f = _features(cfg, part) * masks[i - 1]
        j = i - 1
        h = torch.tanh(refcore.ein("bf,fh->bh", f, p[pre + "cond.w1"][j],
                                   prec) + p[pre + "cond.b1"][j])
        h = torch.tanh(refcore.ein("bf,fh->bh", h, p[pre + "cond.w2"][j],
                                   prec) + p[pre + "cond.b2"][j])
        raw = refcore.ein("bf,fh->bh", h, p[pre + "cond.w3"][j], prec) + p[
            pre + "cond.b3"][j]
        xi, ldi = _rqs(cfg, z[:, i], *_prep(cfg, raw), True, log)
        cols.append(xi)
        ld = ld + ldi
    return torch.stack(cols, dim=1), ld


def prior_lp(cfg, centers, z):
    """Einstein crystal: wells of stiffness alpha at the lattice sites, the
    minimum-image wrap in the box."""
    length = 2.0 * half_box(cfg)
    dev = z.reshape(z.shape[0], -1, cfg["dim"]) - centers
    dev = dev - (torch.abs(dev) > 0.5 * length) * torch.sign(dev) * length
    per_atom = refcore.gaussian_lp(dev, 1.0 / cfg["prior_alpha"])
    return torch.sum(per_atom, dim=-1)


def _layers(cfg):
    return [f"bijector.bijectors.{i}." for i in range(cfg["nlayers"])]


def log_prob(cfg, p, centers, x, prec, log=None):
    """Model log-density of frames x (n, dim): prior of the latent plus the
    forward log-det."""
    masks = row_masks(cfg, x.device, x.dtype)
    ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for pre in _layers(cfg):
        x, ldi = layer_forward(cfg, p, pre, x, prec, masks, log)
        ld = ld + ldi
    return prior_lp(cfg, centers, x) + ld


def fkl_loss(cfg, p, centers, x, prec):
    return -torch.mean(log_prob(cfg, p, centers, x, prec))


def sample(cfg, p, centers, z, prec, log=None):
    """Frames and their model log-densities from latents z: the inverse,
    and prior(z) minus its log-det."""
    masks = row_masks(cfg, z.device, z.dtype)
    ld = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    x = z
    for pre in reversed(_layers(cfg)):
        x, ldi = layer_inverse(cfg, p, pre, x, prec, masks, log)
        ld = ld + ldi
    return x, prior_lp(cfg, centers, z) - ld


def make_frames(cfg, n, generator, device):
    """n training frames: the lattice plus Gaussian displacements of
    frame_sd a coordinate, wrapped into the box, flattened (n, 96)."""
    sites = lattice(cfg, device)
    length = 2.0 * half_box(cfg)
    x = sites + cfg["assumed"]["frame_sd"] * torch.randn(
        n, *sites.shape, generator=generator, device=device)
    x = x - (torch.abs(x) > 0.5 * length) * torch.sign(x) * length
    return x.reshape(n, -1)


# ---------------------------------------------------------- shape counts
def macs_per_row(cfg):
    """Multiply-adds of one row through every conditioner of one layer, and
    through their first products alone, counted on the features each
    conditioner needs: conditioner i (i = 1 .. dim-1) reads the embedding
    of the i coordinates before its own, 2i features where periodic. The
    dense stacked products over every feature, masked, are one way to
    compute them, and what they add is not counted."""
    dim, n, _, hd, out = sizes(cfg)
    per_coord = 2 if cfg["periodic"] else 1
    first = hd * per_coord * n * (n + 1) // 2
    return first + n * (hd * hd + hd * out), first


def flops_sample(cfg, rows):
    """Matrix-product FLOPs of sampling `rows` frames: each conditioner
    once a layer."""
    whole, _ = macs_per_row(cfg)
    return 2 * rows * cfg["nlayers"] * whole


def flops_fkl_step(cfg, rows):
    """One forward-KL step on `rows` frames: the forward, the weights'
    cotangents, and the inputs' cotangents except those of the first
    products of the first layer, whose input is the data."""
    whole, first = macs_per_row(cfg)
    fwd = rows * cfg["nlayers"] * whole
    return 2 * (3 * fwd - rows * first)
