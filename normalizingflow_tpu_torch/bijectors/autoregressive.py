"""Autoregressive bijectors: RQS spline AR ("NSF_AR") and affine AR ("MAF").

Twin of normalizingflow_tpu/bijectors/autoregressive.py. Dimension i >= 1
has its own conditioner MLP on the features of dims < i. As in JAX, the
dim-1 MLPs keep stacked weights (dim-1, F, hidden) with F = 2*(dim-1)
(periodic) or dim-1 (plain), feature order [f(x_0)..f(x_{dim-2}),
g(x_0)..g(x_{dim-2})], and rows at or past each MLP's cutoff masked to
zero, so a JAX params tree loads leaf for leaf:

  * forward (density evaluation, training): every conditioner input is
    known, so all MLPs run in one batched einsum over the stacked weights;
  * inverse (sampling): a plain loop over dims, one MLP per step; where
    no autograd or torch.func sees it, SplineAR writes each decoded column
    into buffers instead of re-stacking the frame. The JAX package nests
    its scan to bound TPU trip counts; that has no effect on the result
    and is not ported.

The RQS calls of both directions go through `apply_rqs`, so on the card
they run the CUDA kernel (the JAX inverse calls `unconstrained_rqs`
directly; the function is the same).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.profiling import annotate
from .base import Bijector
from .rqs import apply_rqs, softplus, split_spline_params


def _uniform(shape, bound, generator, device, dtype):
    """uniform(-1, 1) * bound, as the JAX twin's `_uniform`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return (u * 2.0 - 1.0) * bound


class _MaskedStackedMLPs(nn.Module):
    """dim-1 independent 3-layer tanh MLPs with autoregressive input masks.

    MLP i (i = 1..dim-1) sees only the features of dims < i; `row_masks`
    [i-1, f] is 1 where feature f is visible to MLP i. Weights are
    initialised with each MLP's effective fan-in, torch.nn.Linear's default
    on the reference's ragged per-dim inputs.
    """

    def __init__(self, dim, out_dim, hidden_dim, periodic, generator=None,
                 device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.out_dim = int(out_dim)
        self.hidden = int(hidden_dim)
        self.periodic = bool(periodic)
        self.n_base = self.dim - 1
        self.n_feat = (2 if self.periodic else 1) * self.n_base
        self.n_mlps = self.dim - 1
        dtype = dtype or torch.get_default_dtype()
        n, f, hd, o = self.n_mlps, self.n_feat, self.hidden, self.out_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        fan_in = torch.arange(1, self.dim, device=device, dtype=dtype) * (
            2.0 if self.periodic else 1.0)
        bound1 = (1.0 / torch.sqrt(fan_in))[:, None, None]
        bh = 1.0 / math.sqrt(hd)
        self.w1 = nn.Parameter(_uniform((n, f, hd), 1.0, **kw) * bound1)
        self.b1 = nn.Parameter(_uniform((n, hd), 1.0, **kw) * bound1[:, :, 0])
        self.w2 = nn.Parameter(_uniform((n, hd, hd), bh, **kw))
        self.b2 = nn.Parameter(_uniform((n, hd), bh, **kw))
        self.w3 = nn.Parameter(_uniform((n, hd, o), bh, **kw))
        self.b3 = nn.Parameter(_uniform((n, o), bh, **kw))
        i = torch.arange(1, self.dim, device=device)[:, None]
        base = (torch.arange(self.n_base, device=device)[None, :] < i).to(
            dtype)
        self.register_buffer(
            "row_masks", torch.cat([base, base], 1) if self.periodic else base)

    def feature_mask(self, cutoff):
        """(n_feat,) 0/1 mask of the features of dims < `cutoff`."""
        return self.row_masks[cutoff - 1]

    def apply_all(self, feats):
        """All dim-1 MLPs at once: feats (B, F) -> (n_mlps, B, out)."""
        w1m = self.w1 * self.row_masks[:, :, None]
        h = torch.tanh(torch.einsum("bf,ifh->ibh", feats, w1m)
                       + self.b1[:, None, :])
        h = torch.tanh(torch.einsum("ibh,ihg->ibg", h, self.w2)
                       + self.b2[:, None, :])
        return torch.einsum("ibh,iho->ibo", h, self.w3) + self.b3[:, None, :]

    def apply_one(self, feats, i):
        """MLP i (1..dim-1) on feats (B, F) already masked to dims < i."""
        j = i - 1
        h = torch.tanh(feats @ self.w1[j] + self.b1[j])
        h = torch.tanh(h @ self.w2[j] + self.b2[j])
        return h @ self.w3[j] + self.b3[j]


class SplineAR(Bijector):
    """Autoregressive rational-quadratic spline flow ("NSF_AR").

    Dim 0 is transformed with the learnable vector `init_raw` (3K-1
    entries, uniform(-1/2, 1/2) init); dim i >= 1 takes its spline
    parameters from MLP i on the periodic embedding
    [cos(pi x_j / W), sin(pi x_j / W)]_{j<i} (W the half-width of the input
    domain), or on raw x_{<i} with `periodic=False`. The layer applies
    softmax * 2W, softmax * 2H and softplus before the spline normalizes
    again, as the reference does. `input_bounds` / `output_bounds` give the
    asymmetric-domain variant [in_l, in_r] -> [out_l, out_r].
    """

    def __init__(self, dim, num_bins=32, tail_bound=3.0, hidden_dim=800,
                 periodic=True, input_bounds=None, output_bounds=None,
                 generator=None, device=None, dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.num_bins = int(num_bins)
        self.tail_bound = float(tail_bound)
        if input_bounds is None:
            input_bounds = (-self.tail_bound, self.tail_bound)
        if output_bounds is None:
            output_bounds = tuple(input_bounds)
        self.input_bounds = (float(input_bounds[0]), float(input_bounds[1]))
        self.output_bounds = (float(output_bounds[0]),
                              float(output_bounds[1]))
        self.width = (self.input_bounds[1] - self.input_bounds[0]) / 2.0
        self.height = (self.output_bounds[1] - self.output_bounds[0]) / 2.0
        self.hidden_dim = int(hidden_dim)
        self.periodic = bool(periodic)
        dtype = dtype or torch.get_default_dtype()
        self.init_raw = nn.Parameter(_uniform(
            (3 * self.num_bins - 1,), 0.5, generator, device, dtype))
        if self.dim > 1:
            self.cond = _MaskedStackedMLPs(
                self.dim, 3 * self.num_bins - 1, self.hidden_dim,
                self.periodic, generator=generator, device=device,
                dtype=dtype)

    def features(self, x):
        """(B, dim) -> (B, F) embedding of the first dim-1 coordinates."""
        base = x[:, :self.dim - 1]
        if not self.periodic:
            return base
        ang = math.pi * base / self.width
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)

    def prep_spline(self, raw):
        """The layer's parameter pipeline: (..., 3K-1) -> w, h, d."""
        w, h, d = split_spline_params(raw, self.num_bins)
        w = 2.0 * self.width * torch.softmax(w, dim=-1)
        h = 2.0 * self.height * torch.softmax(h, dim=-1)
        return w, h, softplus(d)

    def _rqs(self, x, w, h, d, inverse):
        return apply_rqs(x, w, h, d, inverse=inverse,
                         left=self.input_bounds[0],
                         right=self.input_bounds[1],
                         bottom=self.output_bounds[0],
                         top=self.output_bounds[1])

    def raw_params(self, x):
        """(B, dim, 3K-1) spline parameters of every dim, given x."""
        b = x.shape[0]
        raw0 = self.init_raw.expand(1, b, 3 * self.num_bins - 1)
        if self.dim > 1:
            raw = torch.cat([raw0, self.cond.apply_all(self.features(x))], 0)
        else:
            raw = raw0
        return raw.transpose(0, 1)

    def forward(self, x):
        w, h, d = self.prep_spline(self.raw_params(x))
        z, ld = self._rqs(x, w, h, d, inverse=False)
        return z, torch.sum(ld, dim=1)

    # Inverses taken on each path of `inverse` in this process.
    inverse_paths = {"buffered": 0, "stacked": 0}

    def _recorded(self, z):
        """Whether autograd or a torch.func transform sees this inverse."""
        if torch._C._are_functorch_transforms_active():
            return True
        return torch.is_grad_enabled() and (
            z.requires_grad
            or any(p.requires_grad for p in self.parameters()))

    def _decode(self, z, i, raw):
        """Dim i's RQS inverse with its spline parameters `raw`."""
        with annotate("spline_ar.spline"):
            return self._rqs(z[:, i], *self.prep_spline(raw), inverse=True)

    def inverse(self, z):
        """A loop over dims. Where nothing records the call, the
        conditioner's input is kept in buffers written a column a step;
        autograd and torch.func see the stacked form, which writes nothing
        in place."""
        raw0 = self.init_raw.expand(z.shape[0], 3 * self.num_bins - 1)
        x0, log_det = self._decode(z, 0, raw0)
        path = "stacked" if self._recorded(z) else "buffered"
        SplineAR.inverse_paths[path] += 1
        if path == "stacked":
            return self._inverse_stacked(z, x0, log_det)
        return self._inverse_buffered(z, x0, log_det)

    def _inverse_stacked(self, z, x0, log_det):
        """Each step stacks the decoded columns, pads them with zeros and
        masks their features."""
        b = z.shape[0]
        cols = [x0]
        for i in range(1, self.dim):
            with annotate("spline_ar.restack"):
                x_partial = torch.cat([torch.stack(cols, dim=1),
                                       z.new_zeros(b, self.dim - i)], 1)
            with annotate("spline_ar.conditioner"):
                feats = self.features(x_partial) * self.cond.feature_mask(i)
                raw = self.cond.apply_one(feats, i)
            xi, ld = self._decode(z, i, raw)
            cols.append(xi)
            log_det = log_det + ld
        return torch.stack(cols, dim=1), log_det

    def _inverse_buffered(self, z, x0, log_det):
        """Each step writes the newly decoded column into the frame `x`
        and its embedding, by `features`' ops, into `feats`; the features
        of dims not decoded yet stay 0, as the mask makes them, so MLP i
        sees the stacked form's values bit for bit."""
        b, n = z.shape[0], self.dim - 1
        x = x0.new_zeros(b, self.dim)
        feats = x0.new_zeros(b, self.cond.n_feat) if n else None
        xi = x0
        for i in range(1, self.dim):
            with annotate("spline_ar.restack"):
                x[:, i - 1] = xi
                if self.periodic:
                    ang = math.pi * xi / self.width
                    torch.cos(ang, out=feats[:, i - 1])
                    torch.sin(ang, out=feats[:, n + i - 1])
                else:
                    feats[:, i - 1] = xi
            with annotate("spline_ar.conditioner"):
                raw = self.cond.apply_one(feats, i)
            xi, ld = self._decode(z, i, raw)
            log_det = log_det + ld
        x[:, n] = xi
        return x, log_det


class MaskedAffineAR(Bijector):
    """Masked autoregressive affine flow ("MAF").

    Dim 0 uses the learnable (mu, alpha) pair `init_param`
    (uniform(-sqrt(1/2), sqrt(1/2)) init); dim i >= 1 takes
    (mu, alpha) = MLP_i(x_{<i}) on raw inputs. Forward:
    z_i = (x_i - mu_i) * exp(-alpha_i), then the output is flipped along
    the dim axis; log_det = -sum_i alpha_i. The inverse un-flips first,
    then runs dim by dim.
    """

    def __init__(self, dim, hidden_dim=8, generator=None, device=None,
                 dtype=None):
        super().__init__()
        self.dim = int(dim)
        self.hidden_dim = int(hidden_dim)
        dtype = dtype or torch.get_default_dtype()
        self.init_param = nn.Parameter(_uniform(
            (2,), math.sqrt(0.5), generator, device, dtype))
        if self.dim > 1:
            self.cond = _MaskedStackedMLPs(
                self.dim, 2, self.hidden_dim, False, generator=generator,
                device=device, dtype=dtype)

    def forward(self, x):
        b = x.shape[0]
        out0 = self.init_param.expand(1, b, 2)
        if self.dim > 1:
            out = torch.cat(
                [out0, self.cond.apply_all(x[:, :self.dim - 1])], 0)
        else:
            out = out0
        mu = out[..., 0].transpose(0, 1)
        alpha = out[..., 1].transpose(0, 1)
        z = (x - mu) * torch.exp(-alpha)
        return torch.flip(z, dims=(1,)), -torch.sum(alpha, dim=1)

    def inverse(self, z):
        b = z.shape[0]
        z = torch.flip(z, dims=(1,))
        mu0, alpha0 = self.init_param[0], self.init_param[1]
        cols = [mu0 + torch.exp(alpha0) * z[:, 0]]
        log_det = alpha0.expand(b)
        for i in range(1, self.dim):
            x_partial = torch.cat(
                [torch.stack(cols, dim=1), z.new_zeros(b, self.dim - i)], 1)
            feats = x_partial[:, :self.dim - 1] * self.cond.feature_mask(i)
            out = self.cond.apply_one(feats, i)
            mu, alpha = out[:, 0], out[:, 1]
            cols.append(mu + torch.exp(alpha) * z[:, i])
            log_det = log_det + alpha
        return torch.stack(cols, dim=1), log_det
