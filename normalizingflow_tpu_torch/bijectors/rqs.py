"""Monotone rational-quadratic spline (RQS) transforms.

Twin of normalizingflow_tpu/bijectors/rqs.py (Durkan et al. 2019, "Neural
Spline Flows"), with the same normalization and flooring conventions:

  widths  = softmax -> floor `min_bin_width`  (1e-3), knots pinned to lo/hi
  heights = softmax -> floor `min_bin_height` (1e-3), knots pinned to lo/hi
  derivs  = min_derivative + softplus(raw)    (1e-3); the two boundary
            derivatives come from the raw value log(e^{1-min_d} - 1), so the
            tail slope is 1
  bin     = sum(x >= knots) - 1, clamped to [0, K-1]
  inverse via the stable quadratic root 2c / (-b - sqrt(disc))
  log|det| = log(numerator) - 2*log(denominator)

Out-of-domain inputs pass through unchanged with log-det 0 (a `where` mask),
so a NaN input gives NaN and log-det 0, an infinite one itself and 0.

Softplus is JAX's `logaddexp(x, 0)`, not `torch.nn.functional.softplus`,
whose threshold of 20 returns x itself and departs from JAX in float64.

`apply_rqs` is the transform the flow layers call. On CUDA tensors it always
runs the hand-written kernels (ops/rqs.py, csrc/rqs.cu) through an autograd
Function: the forward kernel, and a backward kernel that computes the VJP
in one pass, so no plain version runs in a gradient on the card. On CPU
tensors it runs `unconstrained_rqs` below and autograd through it; on the
card that twin serves only the checks. The JAX package's element-count
gate and its `set_fused_rqs` switch calibrate the TPU's fusion trade-offs
and are not ported: on the card every call goes to the kernels.
"""

from __future__ import annotations

import math

import torch

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _normalize_bins(unnormalized, num_bins, min_size, lo, hi):
    """softmax-normalized bin sizes with a floor, mapped onto [lo, hi].

    Returns (knots, sizes): K+1 knots with the endpoints exactly lo and hi,
    sizes = diff(knots).
    """
    probs = torch.softmax(unnormalized, dim=-1)
    probs = min_size + (1.0 - min_size * num_bins) * probs
    cum = torch.cumsum(probs, dim=-1)
    cum = (hi - lo) * cum + lo
    edge = cum[..., :1]
    cum = torch.cat([torch.full_like(edge, lo), cum[..., :-1],
                     torch.full_like(edge, hi)], dim=-1)
    sizes = cum[..., 1:] - cum[..., :-1]
    return cum, sizes


def _search_bins(knots, x):
    """Index of the bin holding x: sum(x >= knots) - 1, clamped to [0, K-1]."""
    idx = torch.sum(x[..., None] >= knots, dim=-1) - 1
    return torch.clamp(idx, 0, knots.shape[-1] - 2)


def _gather(values, idx):
    """values[..., idx] along the last axis, one per batch element."""
    return torch.gather(values, -1, idx[..., None])[..., 0]


def rational_quadratic_spline(inputs, unnormalized_widths,
                              unnormalized_heights, padded_derivatives, *,
                              inverse=False, left=0.0, right=1.0, bottom=0.0,
                              top=1.0, min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                              min_bin_height=DEFAULT_MIN_BIN_HEIGHT):
    """Core RQS on the in-domain region; `padded_derivatives` (..., K+1) are
    the floored positive knot derivatives. Returns (outputs, logabsdet)."""
    num_bins = unnormalized_widths.shape[-1]
    cumwidths, widths = _normalize_bins(unnormalized_widths, num_bins,
                                        min_bin_width, left, right)
    cumheights, heights = _normalize_bins(unnormalized_heights, num_bins,
                                          min_bin_height, bottom, top)
    derivatives = padded_derivatives

    bin_idx = _search_bins(cumheights if inverse else cumwidths, inputs)

    in_cumwidths = _gather(cumwidths, bin_idx)
    in_widths = _gather(widths, bin_idx)
    in_cumheights = _gather(cumheights, bin_idx)
    in_heights = _gather(heights, bin_idx)
    in_delta = in_heights / in_widths
    in_d = _gather(derivatives, bin_idx)
    in_d1 = _gather(derivatives[..., 1:], bin_idx)

    s_pm = in_d + in_d1 - 2.0 * in_delta

    if inverse:
        dy = inputs - in_cumheights
        a = dy * s_pm + in_heights * (in_delta - in_d)
        b = in_heights * in_d - dy * s_pm
        c = -in_delta * dy
        discriminant = b * b - 4.0 * a * c
        root = (2.0 * c) / (-b - torch.sqrt(discriminant))
        outputs = root * in_widths + in_cumwidths
        theta_1m = root * (1.0 - root)
        denominator = in_delta + s_pm * theta_1m
        derivative_numerator = (in_delta * in_delta) * (
            in_d1 * root * root
            + 2.0 * in_delta * theta_1m
            + in_d * (1.0 - root) * (1.0 - root))
        logabsdet = torch.log(derivative_numerator) - 2.0 * torch.log(
            denominator)
        return outputs, -logabsdet

    theta = (inputs - in_cumwidths) / in_widths
    theta_1m = theta * (1.0 - theta)
    numerator = in_heights * (in_delta * theta * theta + in_d * theta_1m)
    denominator = in_delta + s_pm * theta_1m
    outputs = in_cumheights + numerator / denominator
    derivative_numerator = (in_delta * in_delta) * (
        in_d1 * theta * theta
        + 2.0 * in_delta * theta_1m
        + in_d * (1.0 - theta) * (1.0 - theta))
    logabsdet = torch.log(derivative_numerator) - 2.0 * torch.log(denominator)
    return outputs, logabsdet


def resolve_bounds(tail_bound=None, left=None, right=None, bottom=None,
                   top=None):
    """(left, right, bottom, top) as the JAX functions resolve them."""
    if tail_bound is not None and left is None:
        left, right = -tail_bound, tail_bound
    if bottom is None:
        bottom, top = left, right
    return float(left), float(right), float(bottom), float(top)


def unconstrained_rqs(inputs, unnormalized_widths, unnormalized_heights,
                      unnormalized_derivatives, *, inverse=False, left=None,
                      right=None, bottom=None, top=None, tail_bound=1.0,
                      min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                      min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                      min_derivative=DEFAULT_MIN_DERIVATIVE):
    """RQS with identity tails outside [left, right] (forward) or
    [bottom, top] (inverse); `unnormalized_derivatives` holds the K-1 inner
    derivative logits."""
    left, right, bottom, top = resolve_bounds(tail_bound, left, right,
                                              bottom, top)
    constant = math.log(math.expm1(1.0 - min_derivative))
    pad = torch.full_like(unnormalized_derivatives[..., :1], constant)
    padded_raw = torch.cat([pad, unnormalized_derivatives, pad], dim=-1)
    derivatives = min_derivative + softplus(padded_raw)
    return _rqs_in_domain(inputs, unnormalized_widths, unnormalized_heights,
                          derivatives, inverse, left, right, bottom, top,
                          min_bin_width, min_bin_height)


def circular_rqs(inputs, unnormalized_widths, unnormalized_heights,
                 unnormalized_derivatives, *, inverse=False, left=None,
                 right=None, bottom=None, top=None, tail_bound=1.0,
                 min_bin_width=DEFAULT_MIN_BIN_WIDTH,
                 min_bin_height=DEFAULT_MIN_BIN_HEIGHT,
                 min_derivative=DEFAULT_MIN_DERIVATIVE):
    """The circular RQS of a periodic coordinate (Rezende et al. 2020; the
    coupling layers of bijectors/transformer.py): bins as in
    `unconstrained_rqs`, and K derivative logits, knot j's slope
    min_derivative + softplus(d_j), with knot K sharing knot 0's, so that
    the map's two ends meet with one learned slope. The caller wraps inputs
    into the domain; the identity rule outside it stays, as the kernels
    keep it."""
    left, right, bottom, top = resolve_bounds(tail_bound, left, right,
                                              bottom, top)
    raw = torch.cat([unnormalized_derivatives,
                     unnormalized_derivatives[..., :1]], dim=-1)
    derivatives = min_derivative + softplus(raw)
    return _rqs_in_domain(inputs, unnormalized_widths, unnormalized_heights,
                          derivatives, inverse, left, right, bottom, top,
                          min_bin_width, min_bin_height)


def _rqs_in_domain(inputs, unnormalized_widths, unnormalized_heights,
                   derivatives, inverse, left, right, bottom, top,
                   min_bin_width, min_bin_height):
    """The spline on [lo, hi] with the K+1 knot `derivatives`, identity
    outside."""
    lo, hi = (bottom, top) if inverse else (left, right)
    inside = (inputs >= lo) & (inputs <= hi)
    # jnp.clip is minimum(maximum(.)): at x == lo or hi each side of the tie
    # takes half the gradient. torch.clamp passes all of it; these do not.
    safe_inputs = torch.minimum(
        torch.maximum(inputs, inputs.new_tensor(lo)), inputs.new_tensor(hi))
    outputs_in, logdet_in = rational_quadratic_spline(
        safe_inputs, unnormalized_widths, unnormalized_heights, derivatives,
        inverse=inverse, left=left, right=right, bottom=bottom, top=top,
        min_bin_width=min_bin_width, min_bin_height=min_bin_height)
    outputs = torch.where(inside, outputs_in, inputs)
    logabsdet = torch.where(inside, logdet_in, torch.zeros_like(logdet_in))
    return outputs, logabsdet


def apply_rqs(inputs, w, h, d, *, inverse=False, tail_bound=None, left=None,
              right=None, bottom=None, top=None, circular=False):
    """`unconstrained_rqs` (or with `circular`, `circular_rqs`) as the flow
    layers call it: the CUDA kernels, forward and backward, on CUDA tensors
    (float32; anything else raises), the plain twin on CPU."""
    left, right, bottom, top = resolve_bounds(tail_bound, left, right,
                                              bottom, top)
    if inputs.is_cuda:
        from ..ops import rqs as ops

        kernels = ((ops.crqs_cuda, ops.crqs_vjp_cuda) if circular
                   else (ops.rqs_cuda, ops.rqs_vjp_cuda))
        return ops.unconstrained_rqs_fused(inputs, w, h, d, inverse, left,
                                           right, bottom, top, *kernels)
    if inputs.device.type != "cpu":
        raise ValueError(f"apply_rqs: unsupported device {inputs.device}")
    plain = circular_rqs if circular else unconstrained_rqs
    return plain(inputs, w, h, d, inverse=inverse, left=left, right=right,
                 bottom=bottom, top=top)


def split_spline_params(raw, num_bins):
    """Split a (..., 3K-1) conditioner output into (W, H, D) raw params:
    K width logits, K height logits, K-1 inner derivative logits."""
    w = raw[..., :num_bins]
    h = raw[..., num_bins:2 * num_bins]
    d = raw[..., 2 * num_bins:]
    return w, h, d
