"""Transformer-conditioned circular-spline coupling layers ("NSF_TCL").

The flow of Wirnsberger, Papamakarios, Ibarz, Racaniere, Ballard, Pritzel
and Blundell, "Normalizing flows for atomic solids", Mach. Learn.: Sci.
Technol. 3, 025009 (2022), arXiv:2111.08696 (code:
github.com/deepmind/flows_for_atomic_solids, `experiments/lj_config.py`).
It has no JAX twin in this repository.

Positions are N particles in a periodic cubic box [-L/2, L/2)^3, flattened
(batch, N * 3). Layer l moves axis a = l mod 3 of every particle,
conditioned on the other two axes c_i of every particle:

  * wrap: every coordinate into [-L/2, L/2) on entry (log-det 0);
  * embedding: [cos(2 pi k (c + L/2) / L), sin(...)] for k = 1..F, per
    conditioning axis, then a linear map to the width E;
  * `num_blocks` blocks, no layer norm:
    h <- h + W_o MHA(h) (softmax(Q K^T / sqrt(E / heads)) over all N
    particles, no mask, through scaled_dot_product_attention's math
    backend: plain float32 products, TF32 off as everywhere in the port),
    h <- h + W_2 gelu(W_1 h + b_1) + b_2 (W_1: E -> 4E; gelu's
    tanh form, jax.nn.gelu's default);
  * output: theta_i = W_f h_i + b_f, 3K + 1 numbers a particle: K width
    logits, K height logits, K slope logits and a shift s_i;
  * the map: y_i = wrap(CRQS(x_i) + s_i), CRQS the circular spline on
    [-L/2, L/2] (bijectors/rqs.py::circular_rqs; the CUDA kernels'
    circular mode on the card), log-det the sum of log CRQS'(x_i).

The conditioning axes pass through, so the inverse is one pass through the
same conditioner: x_i = CRQS^-1(wrap(y_i - s_i)). Every operation acts per
particle or attends over all of them, so the layer is equivariant under
permutations of the particles.

In the flow's conventions (flow.py) `inverse` runs latent -> data, the
direction sampling and reverse-KL training take: it is the paper's map
above. `forward` (data -> latent) is its inverse.

Spans (utils.profiling.annotate; free while no profiler runs):
`tcl.mlp` around the entry wrap and the embedding, around each block's MLP
and its residual, the last block's also around the output projection (3 a
layer at 2 blocks); `tcl.attention` around each block's QKV projection,
attention, output projection and residual (one a block), inside it
`tcl.sdpa` around scaled_dot_product_attention alone; `tcl.spline`
around the gather, the spline, the shift, the wrap and the scatter (one a
layer).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate
from .base import Bijector
from .mlp import _linear_init
from .rqs import DEFAULT_MIN_DERIVATIVE, apply_rqs

# the slope logit of a unit slope: min_d + softplus(SLOPE_ONE) = 1
SLOPE_ONE = math.log(math.expm1(1.0 - DEFAULT_MIN_DERIVATIVE))
WIDENING = 4        # the MLP's width over the embedding's
FINAL_SCALE = 1e-2  # the output projection's initial scale


def wrap(x, boxlength):
    """x wrapped into [-L/2, L/2) (a value within one rounding of L/2 may
    land one ulp below -L/2; the spline's identity rule takes it)."""
    return x - boxlength * torch.floor((x + 0.5 * boxlength) / boxlength)


def fourier_features(c, boxlength, num_freqs):
    """(..., A) conditioning coordinates -> (..., A * 2F): for each axis,
    cos(2 pi k (c + L/2) / L) for k = 1..F, then the sines."""
    k = torch.arange(1, num_freqs + 1, dtype=c.dtype, device=c.device)
    ang = (2.0 * math.pi / boxlength) * (c + 0.5 * boxlength)[..., None] * k
    feats = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return feats.reshape(*c.shape[:-1], -1)


def _linear(x, w, b):
    """x @ w + b over the last axis of x (one matrix product)."""
    out = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[1])


def attention(q, k, v):
    """softmax(q k^T / sqrt(head size)) v over (batch, heads, N, head size),
    no mask, by scaled_dot_product_attention's math backend: its matrix
    products follow the port's float32 settings (TF32 off), where the
    memory-efficient backend would run float32 on tensor cores."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with annotate("tcl.sdpa"), sdpa_kernel(SDPBackend.MATH):
        return F.scaled_dot_product_attention(q, k, v)


class _Block(nn.Module):
    """One transformer block's parameters: attention's QKV and output
    projections, the MLP's two layers; weights (fan_in, fan_out)."""

    def __init__(self, embed_dim, generator, device, dtype):
        super().__init__()
        e = embed_dim
        for name, fan_in, fan_out in (("qkv", e, 3 * e), ("out", e, e),
                                      ("mlp1", e, WIDENING * e),
                                      ("mlp2", WIDENING * e, e)):
            w, b = _linear_init(fan_in, fan_out, generator, device, dtype)
            setattr(self, f"{name}_w", nn.Parameter(w))
            setattr(self, f"{name}_b", nn.Parameter(b))


class TransformerCoupling(Bijector):
    """One coupling layer of the flow (see the module docstring), moving
    axis `axis` of each of `n_particles` particles in a box of side
    `boxlength`.

    Initial weights: every linear map torch.nn.Linear's uniform(-1/sqrt(
    fan_in), 1/sqrt(fan_in)), drawn from `generator`; the output
    projection's weight and bias then scaled by FINAL_SCALE, and its
    slope logits offset by SLOPE_ONE, so that the layer starts close to,
    not at, the identity (the paper zeroes that projection)."""

    def __init__(self, n_particles, boxlength, axis, num_bins=16,
                 embed_dim=256, num_heads=2, num_blocks=2, num_freqs=8,
                 space_dim=3, generator=None, device=None, dtype=None):
        super().__init__()
        self.n_particles = int(n_particles)
        self.boxlength = float(boxlength)
        self.space_dim = int(space_dim)
        self.axis = int(axis)
        self.cond_axes = [a for a in range(self.space_dim) if a != self.axis]
        self.num_bins = int(num_bins)
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.num_freqs = int(num_freqs)
        if self.embed_dim % self.num_heads or num_blocks < 1:
            raise ValueError("need num_blocks >= 1 and embed_dim a multiple "
                             "of num_heads")
        dtype = dtype or torch.get_default_dtype()
        e, k = self.embed_dim, self.num_bins
        w, b = _linear_init(2 * self.num_freqs * len(self.cond_axes), e,
                            generator, device, dtype)
        self.embed_w, self.embed_b = nn.Parameter(w), nn.Parameter(b)
        self.blocks = nn.ModuleList(
            _Block(e, generator, device, dtype)
            for _ in range(num_blocks))
        w, b = _linear_init(e, 3 * k + 1, generator, device, dtype)
        b = b * FINAL_SCALE
        b[2 * k:3 * k] += SLOPE_ONE
        self.final_w = nn.Parameter(w * FINAL_SCALE)
        self.final_b = nn.Parameter(b)

    @property
    def bounds(self):
        half = 0.5 * self.boxlength
        return dict(left=-half, right=half, bottom=-half, top=half)

    def conditioner(self, x):
        """Flattened positions x -> (the wrapped positions (batch, N, 3),
        theta (batch, N, 3K + 1))."""
        with annotate("tcl.mlp"):
            x3 = wrap(x.reshape(x.shape[0], self.n_particles,
                                self.space_dim), self.boxlength)
            h = _linear(fourier_features(x3[..., self.cond_axes],
                                         self.boxlength, self.num_freqs),
                        self.embed_w, self.embed_b)
        last = len(self.blocks) - 1
        for j, blk in enumerate(self.blocks):
            with annotate("tcl.attention"):
                h = h + _linear(self._attend(h, blk), blk.out_w, blk.out_b)
            with annotate("tcl.mlp"):
                g = F.gelu(_linear(h, blk.mlp1_w, blk.mlp1_b),
                           approximate="tanh")
                h = h + _linear(g, blk.mlp2_w, blk.mlp2_b)
                if j == last:
                    return x3, _linear(h, self.final_w, self.final_b)

    def _attend(self, h, blk):
        """Multi-head self-attention of h (batch, N, E) before the output
        projection."""
        bsz, n, e = h.shape
        qkv = _linear(h, blk.qkv_w, blk.qkv_b).reshape(
            bsz, n, 3, self.num_heads, e // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        return attention(q, k, v).transpose(1, 2).reshape(bsz, n, e)

    def _couple(self, x, inverse):
        """The paper's map (inverse=False) or its inverse on flattened
        positions x; returns (out, log|d out / d x|)."""
        bsz = x.shape[0]
        x3, theta = self.conditioner(x)
        k, a = self.num_bins, self.axis
        with annotate("tcl.spline"):
            xa, shift = x3[..., a], theta[..., 3 * k]
            if inverse:
                xa = wrap(xa - shift, self.boxlength)
            ya, ld = apply_rqs(xa, theta[..., :k], theta[..., k:2 * k],
                               theta[..., 2 * k:3 * k], inverse=inverse,
                               circular=True, **self.bounds)
            if not inverse:
                ya = wrap(ya + shift, self.boxlength)
            cols = [ya if i == a else x3[..., i]
                    for i in range(self.space_dim)]
            out = torch.stack(cols, dim=-1).reshape(bsz, -1)
            return out, torch.sum(ld, dim=1)

    def forward(self, x):
        return self._couple(x, inverse=True)

    def inverse(self, z):
        return self._couple(z, inverse=False)
