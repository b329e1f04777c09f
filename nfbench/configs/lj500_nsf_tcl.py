"""Plain reference of lj500_nsf_tcl: the flow of "Normalizing flows for
atomic solids" (Wirnsberger et al. 2022, arXiv:2111.08696; code
github.com/deepmind/flows_for_atomic_solids, experiments/lj_config.py) on
a 500-particle Lennard-Jones fcc solid, trained by reverse KL: its
coupling layers (Fourier features of the conditioning axes, a transformer
over the particles, a circular rational-quadratic spline and a shift on
the moved axis), the Einstein-crystal base, the LJ energy, the loss and
Adam, and the shape counts of its matrix products.

Parameters are a dict keyed by the program's parameter names
(`flow.named_parameters()` of NormalizingFlow(EinsteinCrystal, Chain(
[TransformerCoupling] * layers))). Imports torch, nfbench.refcore and
nfbench.ljref only. Departures from the paper, each also under
`assumed` in lj500_nsf_tcl.json:

  * the spline's slopes are 1e-3 + softplus(logit) (the port's spline
    convention; distrax adds an offset so that logit 0 is slope 1), and
    the output projection starts at a small scale with the slope logits
    offset to unit slope, where the paper zeroes it;
  * the spline's bins take the port's floor (1e-3 of the span, then
    rescaled), distrax's its own;
  * the coupling layer applied first to a base draw is the last of the
    Chain (the flow's inverse runs the Chain backwards); layer l moves
    axis l mod 3;
  * no layer norm; gelu in its tanh form; biases on every projection.

Every function takes `prec`: "float64" (the reference proper) or "tf32"
(the control: float32 with every product's operands rounded to TF32, the
attention's two products and the LJ separations' squares included).
"""

from __future__ import annotations

import math

import torch

from nfbench import ljref, refcore

def box(cfg):
    """The box side L = (N / rho)^(1/3)."""
    return (cfg["nparticles"] / cfg["rho"]) ** (1.0 / 3.0)


def lattice(cfg, device, dtype=torch.float32):
    """The fcc lattice, (N, 3): 4 sites a cubic cell, the cells filling the
    box [-L/2, L/2)^3."""
    n_cells = round((cfg["nparticles"] / 4) ** (1 / 3))
    length = box(cfg)
    a = length / n_cells
    basis = torch.tensor([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]],
                         dtype=torch.float64)
    cells = torch.cartesian_prod(*[torch.arange(n_cells,
                                                dtype=torch.float64)] * 3)
    sites = (cells[:, None, :] + basis[None]).reshape(-1, 3) * a \
        - 0.5 * length
    return sites.to(device=device, dtype=dtype)


def _layers(cfg):
    return [f"bijector.bijectors.{i}." for i in range(cfg["layers"])]


def shapes(cfg):
    """{name: shape} of every parameter, in the program's order."""
    e, w = cfg["embed_dim"], cfg["widening"]
    feats = 2 * cfg["num_freqs"] * (cfg["dim"] - 1)
    out = 3 * cfg["nsplines"] + 1
    sh = {}
    for pre in _layers(cfg):
        sh[pre + "embed_w"], sh[pre + "embed_b"] = (feats, e), (e,)
        sh[pre + "final_w"], sh[pre + "final_b"] = (e, out), (out,)
        for j in range(cfg["num_blocks"]):
            for name, fi, fo in (("qkv", e, 3 * e), ("out", e, e),
                                 ("mlp1", e, w * e), ("mlp2", w * e, e)):
                sh[f"{pre}blocks.{j}.{name}_w"] = (fi, fo)
                sh[f"{pre}blocks.{j}.{name}_b"] = (fo,)
    return sh


def slope_one():
    """The slope logit of a unit slope: 1e-3 + softplus(logit) = 1."""
    return math.log(math.expm1(1.0 - refcore.MIN_DERIVATIVE))


def init_params(cfg, generator, device):
    """Initial weights from `generator` in one draw: each weight uniform(
    -1/sqrt(fan_in), 1/sqrt(fan_in)), each bias with its weight's fan-in;
    the output projection's weight and bias times `final_scale`, its slope
    logits plus slope_one(). float32."""
    sh = shapes(cfg)
    sizes = [math.prod(s) for s in sh.values()]
    u = torch.rand(sum(sizes), generator=generator, device=device) * 2 - 1
    k, scale = cfg["nsplines"], cfg["final_scale"]
    params, at = {}, 0
    for (name, shape), size in zip(sh.items(), sizes):
        part = u[at:at + size].reshape(shape)
        at += size
        fan_in = sh[name[:-1] + "w"][0]
        leaf = part / math.sqrt(fan_in)
        if name.endswith(("final_w", "final_b")):
            leaf = leaf * scale
        if name.endswith("final_b"):
            leaf[2 * k:3 * k] += slope_one()
        params[name] = leaf
    return params


def cast(params, prec):
    return {k: v.detach().to(refcore.DTYPES[prec]) for k, v in
            params.items()}


# ------------------------------------------------------------- the layer
def wrap(x, length):
    return x - length * torch.floor((x + 0.5 * length) / length)


def features(c, length, num_freqs):
    """(b, n, A) -> (b, n, A * 2F): per axis, cos then sin of 2 pi k (c +
    L/2) / L, k = 1..F."""
    k = torch.arange(1, num_freqs + 1, dtype=c.dtype, device=c.device)
    ang = (2.0 * math.pi / length) * (c + 0.5 * length)[..., None] * k
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1).reshape(
        *c.shape[:-1], -1)


def linear(p, name, x, prec):
    return refcore.ein("bnf,fo->bno", x, p[name + "_w"], prec) + p[
        name + "_b"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attend(cfg, p, pre, h, prec):
    """Multi-head self-attention over all particles, no mask, then the
    output projection."""
    b, n, e = h.shape
    heads = cfg["num_heads"]
    qkv = linear(p, pre + "qkv", h, prec).reshape(b, n, 3, heads,
                                                  e // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    s = refcore.ein("bhqd,bhkd->bhqk", q, k, prec) / math.sqrt(e // heads)
    a = torch.softmax(s, dim=-1)
    o = refcore.ein("bhqk,bhkd->bhqd", a, v, prec)
    return linear(p, pre + "out", o.transpose(1, 2).reshape(b, n, e), prec)


def conditioner(cfg, p, pre, x3, axis, prec):
    """theta (b, n, 3K + 1) from the conditioning axes of x3 (b, n, 3)."""
    cond = [i for i in range(cfg["dim"]) if i != axis]
    h = linear(p, pre + "embed", features(x3[..., cond], box(cfg),
                                          cfg["num_freqs"]), prec)
    for j in range(cfg["num_blocks"]):
        blk = f"{pre}blocks.{j}."
        h = h + attend(cfg, p, blk, h, prec)
        h = h + linear(p, blk + "mlp2",
                       gelu(linear(p, blk + "mlp1", h, prec)), prec)
    return linear(p, pre + "final", h, prec)


def crqs(x, w, h, d, inverse, lo, hi):
    """The circular rational-quadratic spline on [lo, hi]: bins by softmax
    with a 1e-3 floor, knot j's slope 1e-3 + softplus(d_j) for j < K and
    knot K's that of knot 0. Returns (y, log|dy/dx|)."""
    k = w.shape[-1]
    deriv = refcore.MIN_DERIVATIVE + refcore.softplus(
        torch.cat([d, d[..., :1]], dim=-1))
    xs = torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
    cw, wd = refcore._knots(w, k, refcore.MIN_BIN_WIDTH, lo, hi)
    ch, ht = refcore._knots(h, k, refcore.MIN_BIN_HEIGHT, lo, hi)
    knots = ch if inverse else cw
    idx = torch.clamp(torch.sum(xs[..., None] >= knots, dim=-1) - 1, 0, k - 1)
    pick = refcore._pick
    icw, iw, ich, ih = pick(cw, idx), pick(wd, idx), pick(ch, idx), pick(
        ht, idx)
    delta = ih / iw
    d0, d1 = pick(deriv, idx), pick(deriv[..., 1:], idx)
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
    ld = torch.log(delta * delta * (d1 * t * t + 2.0 * delta * t1m
                                    + d0 * (1.0 - t) ** 2)) \
        - 2.0 * torch.log(delta + s * t1m)
    return y, -ld if inverse else ld


def layer_sample(cfg, p, pre, axis, x, prec, log=None):
    """One coupling layer in the sampling direction, the paper's map, on
    flattened positions x (b, n * 3): y_a = wrap(CRQS(x_a) + shift)."""
    b, n, k = x.shape[0], cfg["nparticles"], cfg["nsplines"]
    length = box(cfg)
    x3 = wrap(x.reshape(b, n, cfg["dim"]), length)
    theta = conditioner(cfg, p, pre, x3, axis, prec)
    w, h, d = theta[..., :k], theta[..., k:2 * k], theta[..., 2 * k:3 * k]
    xa = x3[..., axis]
    if log is not None:
        log.append((xa.reshape(-1), w.reshape(-1, k), h.reshape(-1, k),
                    False, (-0.5 * length, 0.5 * length) * 2))
    ya, ld = crqs(xa, w, h, d, False, -0.5 * length, 0.5 * length)
    ya = wrap(ya + theta[..., 3 * k], length)
    cols = [ya if i == axis else x3[..., i] for i in range(cfg["dim"])]
    return torch.stack(cols, -1).reshape(b, -1), torch.sum(ld, dim=1)


def layer_density(cfg, p, pre, axis, y, prec):
    """The same layer's inverse, data -> latent: x_a = CRQS^-1(wrap(y_a -
    shift)), with log|dx/dy|."""
    b, n, k = y.shape[0], cfg["nparticles"], cfg["nsplines"]
    length = box(cfg)
    y3 = wrap(y.reshape(b, n, cfg["dim"]), length)
    theta = conditioner(cfg, p, pre, y3, axis, prec)
    w, h, d = theta[..., :k], theta[..., k:2 * k], theta[..., 2 * k:3 * k]
    u = wrap(y3[..., axis] - theta[..., 3 * k], length)
    xa, ld = crqs(u, w, h, d, True, -0.5 * length, 0.5 * length)
    cols = [xa if i == axis else y3[..., i] for i in range(cfg["dim"])]
    return torch.stack(cols, -1).reshape(b, -1), torch.sum(ld, dim=1)


def sample(cfg, p, z, prec, log=None):
    """Base draws z (b, n * 3) -> (x, log|dx/dz|): the layers from the last
    to the first, as the program's Chain.inverse runs them."""
    ld = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
    x = z
    for i, pre in reversed(list(enumerate(_layers(cfg)))):
        x, ldi = layer_sample(cfg, p, pre, i % cfg["dim"], x, prec, log)
        ld = ld + ldi
    return x, ld


def density(cfg, p, x, prec):
    """Data x -> (latent, log|dz/dx|): the layers from the first to the
    last."""
    ld = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i, pre in enumerate(_layers(cfg)):
        x, ldi = layer_density(cfg, p, pre, i % cfg["dim"], x, prec)
        ld = ld + ldi
    return x, ld


def prior_lp(cfg, centers, z):
    """Einstein crystal: wells of stiffness alpha at the lattice sites,
    minimum image in the box."""
    length = box(cfg)
    dev = ljref.minimum_image(z.reshape(z.shape[0], -1, cfg["dim"])
                              - centers, length)
    return torch.sum(refcore.gaussian_lp(dev, 1.0 / cfg["prior_alpha"]),
                     dim=-1)


def target_lp(cfg, x, prec):
    return ljref.log_prob(x, cfg["nparticles"], box(cfg), cfg["cutoff"],
                          cfg["kT"], prec)


def kl_terms(cfg, p, centers, z, prec):
    """log q(x) - log pi(x) of each base draw z, x its sample."""
    x, ld = sample(cfg, p, z, prec)
    return prior_lp(cfg, centers, z) - ld - target_lp(cfg, x, prec)


def reverse_kl(cfg, p, centers, z, prec):
    return torch.mean(kl_terms(cfg, p, centers, z, prec))


def loss_and_grads(cfg, p, centers, z, prec, chunk):
    """The reverse-KL loss of the batch z and its gradient {name: tensor},
    summed over chunks of `chunk` draws so that the float64 step fits."""
    leaves = list(p.values())
    loss, grads = 0.0, [torch.zeros_like(v) for v in leaves]
    for part in z.split(chunk):
        terms = torch.sum(kl_terms(cfg, p, centers, part, prec)) / z.shape[0]
        for g, gi in zip(grads, torch.autograd.grad(terms, leaves)):
            g += gi
        loss += float(terms.detach())
    return loss, dict(zip(p, grads))


def base_draws(cfg, centers, n, generator):
    """n base draws: the lattice plus N(0, 1/alpha) a coordinate, wrapped
    by minimum image, flattened (n, N * 3)."""
    z = centers + torch.randn(n, *centers.shape, generator=generator,
                              device=centers.device) / math.sqrt(
        cfg["prior_alpha"])
    return ljref.minimum_image(z, box(cfg)).reshape(n, -1)


# ---------------------------------------------------------- shape counts
def macs_per_token(cfg):
    """Multiply-adds of one particle through one coupling layer's
    conditioner: the embedding, each block's QKV, output and MLP
    projections, attention's Q K^T and P V (N keys a query, every head),
    and the output projection; and the embedding's alone."""
    e, w, n = cfg["embed_dim"], cfg["widening"], cfg["nparticles"]
    embed = 2 * cfg["num_freqs"] * (cfg["dim"] - 1) * e
    block = 3 * e * e + e * e + 2 * w * e * e + 2 * n * e
    final = e * (3 * cfg["nsplines"] + 1)
    return embed + cfg["num_blocks"] * block + final, embed


def attention_macs_per_token(cfg):
    """Attention's Q K^T and P V multiply-adds of one particle in one
    block."""
    return 2 * cfg["nparticles"] * cfg["embed_dim"]


def flops_sample(cfg, rows):
    """Matrix-product FLOPs of sampling `rows` configurations."""
    whole, _ = macs_per_token(cfg)
    return 2 * rows * cfg["nparticles"] * cfg["layers"] * whole


def flops_rkl_step(cfg, rows):
    """One reverse-KL step: the forward, the weights' cotangents, and the
    inputs' cotangents of every product (attention's two give both
    operands' cotangents) except the embedding's input in the layer
    applied first, whose input is the base draw."""
    whole, embed = macs_per_token(cfg)
    fwd = rows * cfg["nparticles"] * cfg["layers"] * whole
    return 2 * (3 * fwd - rows * cfg["nparticles"] * embed)


def flops_attention_forward(cfg, rows):
    """Attention's Q K^T and P V FLOPs in one forward pass of `rows`
    configurations."""
    return (2 * rows * cfg["nparticles"] * cfg["layers"] * cfg["num_blocks"]
            * attention_macs_per_token(cfg))
