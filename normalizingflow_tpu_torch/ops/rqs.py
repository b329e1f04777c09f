"""Rational-quadratic spline transform: CUDA kernels and autograd boundary.

Twin of normalizingflow_tpu/ops/rqs_pallas.py. `rqs_cuda` launches the
hand-written sm_90a forward kernel in csrc/rqs.cu, which computes
bijectors/rqs.py::unconstrained_rqs in one pass (a group of lanes per
scalar, float32 in and out, float64 inside). `rqs_vjp_cuda` launches the
backward kernel of the same library: it recomputes the knots in registers
and writes the vector-Jacobian product of the same function, the one
`jax.vjp` of the JAX function gives (the JAX custom_vjp's backward is
autodiff of its jnp path; this is that VJP in closed form).
`rqs_vjp_plain` is the backward kernel's plain version, in tensor ops;
`twin_vjp`, autograd through the twin, is the backward the kernel replaced,
kept for the checks.

The circular mode (`bijectors/rqs.py::circular_rqs`: K derivative
logits, both ends' slope learned and shared) has the same four: the
kernels `crqs_cuda` and `crqs_vjp_cuda` (csrc/rqs.cu's `nf_crqs_f32` and
`nf_crqs_vjp_f32`), the plain `plain_crqs` and `crqs_vjp_plain`, and
`twin_crqs_vjp`.

`unconstrained_rqs_fused` wraps a forward and a backward implementation in
an autograd Function. The flow layers (bijectors/rqs.py::apply_rqs) pass
the two kernels, so on the card no plain version runs in a gradient; the
plain versions serve CPU tensors, the CPU tests (which pass them to check
the Function's wiring) and chip_smoke.py's comparisons.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..bijectors.rqs import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    _gather,
    _normalize_bins,
    _search_bins,
    circular_rqs,
    softplus,
    unconstrained_rqs,
)
from . import _build

KERNEL = "rqs"
MAX_BINS = 128

# ctypes argument types of csrc/rqs.cu's entry points: pointers, n, (k,
# inverse), the bounds and floors, the stream
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 2
             + [ctypes.c_double] * 7 + [ctypes.c_void_p])
_VJP_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] + [ctypes.c_int] * 2
             + [ctypes.c_double] * 7 + [ctypes.c_void_p])
SIGNATURES = {"nf_rqs_f32": _FWD_ARGS, "nf_rqs_vjp_f32": _VJP_ARGS,
              "nf_crqs_f32": _FWD_ARGS, "nf_crqs_vjp_f32": _VJP_ARGS}


def bind(lib):
    """Declare the signatures of those of SIGNATURES' entry points that the
    loaded library `lib` has; returns it."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _library():
    lib = _build.load(KERNEL)
    if lib.nf_rqs_f32.argtypes is None:
        bind(lib)
    return lib


def _check(x, w, h, d, circular=False, **per_scalar):
    """Validate the kernels' inputs; `per_scalar` are further tensors
    shaped like x (the cotangents). Returns K."""
    k = w.shape[-1] if w.dim() else 0
    if not 2 <= k <= MAX_BINS:
        raise ValueError(f"the RQS kernel takes 2 <= K <= {MAX_BINS} bins, "
                         f"got K = {k}")
    xs = tuple(x.shape)
    shapes = dict(x=(x, xs), w=(w, xs + (k,)), h=(h, xs + (k,)),
                  d=(d, xs + (k if circular else k - 1,)))
    shapes.update((name, (t, xs)) for name, t in per_scalar.items())
    for name, (t, want) in shapes.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} on {t.device}; the RQS kernel takes "
                             f"CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the RQS kernel takes float32; {name} is "
                            f"{t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    return k


def _consts(inverse, left, right, bottom, top):
    return (int(bool(inverse)), float(left), float(right), float(bottom),
            float(top), DEFAULT_MIN_BIN_WIDTH, DEFAULT_MIN_BIN_HEIGHT,
            DEFAULT_MIN_DERIVATIVE)


def _forward(entry, circular, x, w, h, d, inverse, left, right, bottom,
             top):
    """y, logabsdet by the forward kernel `entry` of the library."""
    k = _check(x, w, h, d, circular)
    dk = k if circular else k - 1
    xf = x.reshape(-1).contiguous()
    n = xf.numel()
    y = torch.empty_like(xf)
    ld = torch.empty_like(xf)
    if n == 0:
        return y.reshape(x.shape), ld.reshape(x.shape)
    wf = w.reshape(n, k).contiguous()
    hf = h.reshape(n, k).contiguous()
    df = d.reshape(n, dk).contiguous()
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, entry)(
        xf.data_ptr(), wf.data_ptr(), hf.data_ptr(), df.data_ptr(),
        y.data_ptr(), ld.data_ptr(), n, k,
        *_consts(inverse, left, right, bottom, top), stream)
    if err != 0:
        raise RuntimeError(f"rqs kernel launch failed: CUDA error {err}")
    return y.reshape(x.shape), ld.reshape(x.shape)


def _vjp(entry, circular, x, w, h, d, grad_y, grad_ld, inverse, left,
         right, bottom, top):
    """(gx, gw, gh, gd) by the backward kernel `entry` of the library."""
    k = _check(x, w, h, d, circular, grad_y=grad_y, grad_ld=grad_ld)
    dk = k if circular else k - 1
    xf = x.reshape(-1).contiguous()
    n = xf.numel()
    gx = torch.empty_like(xf)
    gw = torch.empty(n, k, dtype=x.dtype, device=x.device)
    gh = torch.empty_like(gw)
    gd = torch.empty(n, dk, dtype=x.dtype, device=x.device)
    shapes = (x.shape, w.shape, h.shape, d.shape)
    if n == 0:
        return tuple(g.reshape(s) for g, s in zip((gx, gw, gh, gd), shapes))
    wf = w.reshape(n, k).contiguous()
    hf = h.reshape(n, k).contiguous()
    df = d.reshape(n, dk).contiguous()
    gyf = grad_y.reshape(-1).contiguous()
    gldf = grad_ld.reshape(-1).contiguous()
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, entry)(
        xf.data_ptr(), wf.data_ptr(), hf.data_ptr(), df.data_ptr(),
        gyf.data_ptr(), gldf.data_ptr(), gx.data_ptr(), gw.data_ptr(),
        gh.data_ptr(), gd.data_ptr(), n, k,
        *_consts(inverse, left, right, bottom, top), stream)
    if err != 0:
        raise RuntimeError(f"rqs vjp kernel launch failed: CUDA error {err}")
    return tuple(g.reshape(s) for g, s in zip((gx, gw, gh, gd), shapes))


def rqs_cuda(x, w, h, d, inverse, left, right, bottom, top):
    """unconstrained_rqs(x, w, h, d) by the CUDA kernel on the current
    stream: x (...), w and h (..., K), d (..., K-1), float32 on one CUDA
    device. Returns (y, logabsdet) shaped like x. Raises on inputs the
    kernel does not take and on a failed launch; never falls back."""
    out = _forward("nf_rqs_f32", False, x, w, h, d, inverse, left, right,
                   bottom, top)
    if x.numel():
        rqs_cuda.launches += 1
    return out


rqs_cuda.launches = 0


def rqs_vjp_cuda(x, w, h, d, grad_y, grad_ld, inverse, left, right, bottom,
                 top):
    """The VJP of unconstrained_rqs by the CUDA backward kernel on the
    current stream: cotangents grad_y and grad_ld shaped like x, float32 on
    x's device. Returns (gx, gw, gh, gd) shaped like (x, w, h, d). Raises
    on inputs the kernel does not take and on a failed launch."""
    out = _vjp("nf_rqs_vjp_f32", False, x, w, h, d, grad_y, grad_ld,
               inverse, left, right, bottom, top)
    if x.numel():
        rqs_vjp_cuda.launches += 1
    return out


rqs_vjp_cuda.launches = 0


def crqs_cuda(x, w, h, d, inverse, left, right, bottom, top):
    """circular_rqs(x, w, h, d) by the circular forward kernel: as
    `rqs_cuda`, with d (..., K)."""
    out = _forward("nf_crqs_f32", True, x, w, h, d, inverse, left, right,
                   bottom, top)
    if x.numel():
        crqs_cuda.launches += 1
    return out


crqs_cuda.launches = 0


def crqs_vjp_cuda(x, w, h, d, grad_y, grad_ld, inverse, left, right, bottom,
                  top):
    """The VJP of circular_rqs by the circular backward kernel: as
    `rqs_vjp_cuda`, with d and gd (..., K)."""
    out = _vjp("nf_crqs_vjp_f32", True, x, w, h, d, grad_y, grad_ld,
               inverse, left, right, bottom, top)
    if x.numel():
        crqs_vjp_cuda.launches += 1
    return out


crqs_vjp_cuda.launches = 0


def plain_rqs(x, w, h, d, inverse, left, right, bottom, top):
    """The twin with `rqs_cuda`'s signature."""
    return unconstrained_rqs(x, w, h, d, inverse=inverse, left=left,
                             right=right, bottom=bottom, top=top)


def plain_crqs(x, w, h, d, inverse, left, right, bottom, top):
    """The circular twin with `crqs_cuda`'s signature."""
    return circular_rqs(x, w, h, d, inverse=inverse, left=left, right=right,
                        bottom=bottom, top=top)


def twin_vjp(x, w, h, d, grad_y, grad_ld, inverse, left, right, bottom,
             top, plain=plain_rqs):
    """The VJP by autograd through the twin (`plain`), recomputed, with
    `rqs_vjp_plain`'s signature: the backward the kernel replaced. The
    checks compare with it; no flow layer calls it."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, w, h, d)]
        y, ld = plain(*ins, inverse, left, right, bottom, top)
        return torch.autograd.grad((y, ld), ins, (grad_y, grad_ld))


def twin_crqs_vjp(x, w, h, d, grad_y, grad_ld, inverse, left, right, bottom,
                  top):
    """`twin_vjp` of the circular twin."""
    return twin_vjp(x, w, h, d, grad_y, grad_ld, inverse, left, right,
                    bottom, top, plain=plain_crqs)


def _map_vjp(xs, cw, wb, ch, hb, dl, dr, gy, gld, inverse):
    """Reverse mode of rational_quadratic_spline's explicit formulas on one
    bin (bijectors/rqs.py), for cotangents gy, gld of (y, log|det|).

    The bin is given by its left knots (cw, ch), sizes (wb, hb) and knot
    derivatives (dl, dr). Returns the cotangents of (xs, cw, wb, ch, hb,
    dl, dr). csrc/rqs.cu's `map_vjp` is the same sequence of operations.
    """
    delta = hb / wb
    sp = dl + dr - 2.0 * delta
    if inverse:
        # t is the root of the quadratic; y = t * wb + cw and
        # log|det| = -(log(dnum) - 2 log(den))
        dy = xs - ch
        a = dy * sp + hb * (delta - dl)
        bq = hb * dl - dy * sp
        c = -delta * dy
        sq = torch.sqrt(bq * bq - 4.0 * a * c)
        den_r = -bq - sq
        t = (2.0 * c) / den_r
        g_dnum_per_gld, g_den_per_gld = -1.0, 2.0
    else:
        # t is theta; y = ch + num_y / den and
        # log|det| = log(dnum) - 2 log(den)
        t = (xs - cw) / wb
        g_dnum_per_gld, g_den_per_gld = 1.0, -2.0
    omt = 1.0 - t
    t1m = t * omt
    den = delta + sp * t1m
    q = dr * t * t + 2.0 * delta * t1m + dl * omt * omt
    dnum = delta * delta * q

    g_dnum = g_dnum_per_gld * gld / dnum
    g_den = g_den_per_gld * gld / den
    g_q = g_dnum * delta * delta
    g_delta = g_dnum * 2.0 * delta * q + g_q * 2.0 * t1m
    g_dr = g_q * t * t
    g_t = g_q * (2.0 * dr * t - 2.0 * dl * omt)
    g_dl = g_q * omt * omt
    if inverse:
        g_t = g_t + gy * wb
        g_wb, g_cw, g_hb = gy * t, gy, 0.0
    else:
        num_y = hb * (delta * t * t + dl * t1m)
        g_numy = gy / den
        g_den = g_den - gy * num_y / (den * den)
        g_hb = g_numy * (delta * t * t + dl * t1m)
        g_delta = g_delta + g_numy * hb * t * t
        g_t = g_t + g_numy * hb * 2.0 * delta * t
        g_dl = g_dl + g_numy * hb * t1m
    g_delta = g_delta + g_den
    g_sp = g_den * t1m
    g_t1m = g_q * 2.0 * delta + g_den * sp
    if not inverse:
        g_t1m = g_t1m + g_numy * hb * dl
    g_t = g_t + g_t1m * (1.0 - 2.0 * t)
    if inverse:
        g_c = g_t * 2.0 / den_r
        g_denr = -g_t * t / den_r
        g_disc = -g_denr / (2.0 * sq)
        g_bq = -g_denr + g_disc * 2.0 * bq
        g_a = -g_disc * 4.0 * c
        g_c = g_c - g_disc * 4.0 * a
        g_delta = g_delta - g_c * dy + g_a * hb
        g_hb = g_bq * dl + g_a * (delta - dl)
        g_dl = g_dl + g_bq * hb - g_a * hb
        g_sp = g_sp - g_bq * dy + g_a * dy
        g_dy = -g_c * delta - g_bq * sp + g_a * sp
        g_xs, g_ch = g_dy, -g_dy
    else:
        g_xs = g_t / wb
        g_cw = -g_t / wb
        g_wb = -g_t * t / wb
        g_ch = gy
    g_dl = g_dl + g_sp
    g_dr = g_dr + g_sp
    g_delta = g_delta - 2.0 * g_sp
    g_hb = g_hb + g_delta / wb
    g_wb = g_wb - g_delta * delta / wb
    return g_xs, g_cw, g_wb, g_ch, g_hb, g_dl, g_dr


def _knot_logit_vjp(logits, idx, g_left, g_size, span, scale):
    """Cotangent of the K bin logits from those of the bin's left knot and
    size, in autograd's order of operations. Knot j = lo + span * c_j with
    c_j the sum of the first j floored probabilities min + scale * p_i: the
    cumsum's VJP gives probability m the sum G_m of the scaled knot
    cotangents at j > m, and the softmax's VJP p_m (scale G_m -
    sum_i p_i scale G_i). The pinned knots 0 and K get none."""
    k = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    zero = torch.zeros_like(g_size)
    g_b = span * (g_left - g_size)                      # knot idx
    g_b1 = torch.where(idx + 1 < k, span * g_size, zero)  # knot idx + 1
    m = torch.arange(k, device=logits.device)
    at = idx[..., None]
    g_p = scale * (torch.where(m < at, g_b[..., None], zero[..., None])
                   + torch.where(m < at + 1, g_b1[..., None],
                                 zero[..., None]))
    return p * (g_p - torch.sum(g_p * p, dim=-1, keepdim=True))


def rqs_vjp_plain(x, w, h, d, grad_y, grad_ld, inverse, left, right, bottom,
                  top, circular=False):
    """The VJP of unconstrained_rqs in closed form, in plain tensor ops (no
    autograd): returns (gx, gw, gh, gd) for cotangents grad_y, grad_ld.
    With `circular`, that of circular_rqs (d and gd (..., K)).

    The backward kernel's plain version, equal to `jax.vjp` of the JAX
    function: x gets grad_y outside the domain and, inside, the map's
    derivative, halved at x exactly on lo or hi (jnp.clip's
    minimum/maximum tie); outside the domain the parameters get 0. A NaN
    x propagates NaN into gx, gw, gh and the d entry of its bin, as the
    JAX VJP and autograd through the twin do.
    """
    k = w.shape[-1]
    lo, hi = (bottom, top) if inverse else (left, right)
    inside = (x >= lo) & (x <= hi)
    xs = torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))
    knots_w, sizes_w = _normalize_bins(w, k, DEFAULT_MIN_BIN_WIDTH, left,
                                       right)
    knots_h, sizes_h = _normalize_bins(h, k, DEFAULT_MIN_BIN_HEIGHT, bottom,
                                       top)
    idx = _search_bins(knots_h if inverse else knots_w, xs)
    if circular:
        raw = torch.cat([d, d[..., :1]], dim=-1)
    else:
        edge = torch.full_like(d[..., :1], math.log(math.expm1(
            1.0 - DEFAULT_MIN_DERIVATIVE)))
        raw = torch.cat([edge, d, edge], dim=-1)
    deriv = DEFAULT_MIN_DERIVATIVE + softplus(raw)
    zero = torch.zeros_like(x)
    gy = torch.where(inside, grad_y, zero)
    gld = torch.where(inside, grad_ld, zero)
    g_xs, g_cw, g_wb, g_ch, g_hb, g_dl, g_dr = _map_vjp(
        xs, _gather(knots_w, idx), _gather(sizes_w, idx),
        _gather(knots_h, idx), _gather(sizes_h, idx), _gather(deriv, idx),
        _gather(deriv[..., 1:], idx), gy, gld, inverse)

    gw = _knot_logit_vjp(w, idx, g_cw, g_wb, right - left,
                         1.0 - DEFAULT_MIN_BIN_WIDTH * k)
    gh = _knot_logit_vjp(h, idx, g_ch, g_hb, top - bottom,
                         1.0 - DEFAULT_MIN_BIN_HEIGHT * k)
    # softplus' = 1 / (1 + exp(-raw)) on the bin's two knots' logits: knot
    # j's raw value is raw[j]; in d it is d[j - 1] (inner knots only), or
    # circular d[j mod K]
    den = 1.0 + torch.exp(-raw)
    g_dl = g_dl / _gather(den, idx)
    g_dr = g_dr / _gather(den[..., 1:], idx)
    m = torch.arange(d.shape[-1], device=x.device)
    if circular:
        left_at, right_at = idx, torch.where(idx + 1 == k, 0, idx + 1)
    else:
        g_dl = torch.where(idx >= 1, g_dl, zero)
        g_dr = torch.where(idx <= k - 2, g_dr, zero)
        left_at, right_at = idx - 1, idx
    gd = (torch.where(m == left_at[..., None], g_dl[..., None],
                      torch.zeros_like(d))
          + torch.where(m == right_at[..., None], g_dr[..., None],
                        torch.zeros_like(d)))
    at_bound = (x == lo) | (x == hi)
    factor = torch.where(at_bound, 0.5, 1.0).to(x.dtype)
    gx = torch.where(inside, zero, grad_y) + torch.where(
        inside, factor, zero) * g_xs
    return gx, gw, gh, gd


def crqs_vjp_plain(x, w, h, d, grad_y, grad_ld, inverse, left, right,
                   bottom, top):
    """`rqs_vjp_plain` of the circular spline, with `crqs_vjp_cuda`'s
    signature."""
    return rqs_vjp_plain(x, w, h, d, grad_y, grad_ld, inverse, left, right,
                         bottom, top, circular=True)


def _stack_rows(info, in_dims, tensors):
    """The vmap rules' batching: each batched operand's vmapped dim moved to
    the front, each unbatched one (in_dim None) expanded to the batch, all
    contiguous. The transform is per scalar over leading dims, so the
    batch is more rows of one call (the JAX package's custom_vmap rule,
    rqs_pallas.py `_fused_elementwise`, broadcasts the same way)."""
    return [(t.movedim(dim, 0) if dim is not None
             else t.expand(info.batch_size, *t.shape)).contiguous()
            for t, dim in zip(tensors, in_dims)]


class _FusedRQS(torch.autograd.Function):
    """Forward by `forward`, backward by `backward` (the JAX custom_vjp
    `_fused_fwd` / `_fused_bwd`, with the VJP a kernel of its own).

    Written for torch.func: under `torch.func.vmap` the `vmap` rule calls
    `forward` once on the stacked rows (a kernel reads storage, which a
    BatchedTensor has not), so nested vmap and `vmap(grad(...))` launch
    each kernel once an evaluation, whatever the batch."""

    @staticmethod
    def forward(x, w, h, d, forward, backward, inverse, bounds):
        return forward(x, w, h, d, inverse, *bounds)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, h, d, _, backward, inverse, bounds = inputs
        ctx.save_for_backward(x, w, h, d)
        ctx.vjp = backward
        ctx.inverse = inverse
        ctx.bounds = bounds

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        grads = _RQSVJP.apply(*ctx.saved_tensors, grad_y, grad_ld, ctx.vjp,
                              ctx.inverse, ctx.bounds)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad[:4])),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, w, h, d, forward, backward, inverse, bounds):
        out = _FusedRQS.apply(*_stack_rows(info, in_dims[:4], (x, w, h, d)),
                              forward, backward, inverse, bounds)
        return out, (0, 0)


class _RQSVJP(torch.autograd.Function):
    """The VJP by `vjp`, with its own vmap rule (the cotangents are batched
    too under `vmap(grad(...))`). Not differentiable again."""

    @staticmethod
    def forward(x, w, h, d, grad_y, grad_ld, vjp, inverse, bounds):
        return tuple(vjp(x, w, h, d, grad_y, grad_ld, inverse, *bounds))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the RQS kernels' VJP is once_differentiable: "
                           "no second derivative through the spline")

    @staticmethod
    def vmap(info, in_dims, x, w, h, d, grad_y, grad_ld, vjp, inverse,
             bounds):
        out = _RQSVJP.apply(*_stack_rows(info, in_dims[:6],
                                         (x, w, h, d, grad_y, grad_ld)),
                            vjp, inverse, bounds)
        return out, (0, 0, 0, 0)


def unconstrained_rqs_fused(x, w, h, d, inverse, left, right, bottom, top,
                            forward=rqs_cuda, backward=rqs_vjp_cuda):
    """unconstrained_rqs with its forward by `forward` and its gradient by
    `backward` (by default the two CUDA kernels)."""
    return _FusedRQS.apply(x, w, h, d, forward, backward, bool(inverse),
                           (float(left), float(right), float(bottom),
                            float(top)))
