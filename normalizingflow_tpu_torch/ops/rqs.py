"""Rational-quadratic spline transform: CUDA kernel and autograd boundary.

Twin of normalizingflow_tpu/ops/rqs_pallas.py. `rqs_cuda` launches the
hand-written sm_90a kernel in csrc/rqs.cu, which computes
bijectors/rqs.py::unconstrained_rqs in one pass (one warp per scalar,
float32 in and out, float64 inside);
`unconstrained_rqs_fused` wraps a forward implementation in an autograd
Function whose backward recomputes the plain twin and differentiates it,
as the JAX custom_vjp does: there is no backward kernel there either.

The forward implementation is an argument: the flow layers
(bijectors/rqs.py::apply_rqs) always pass `rqs_cuda`, and a CPU test can
pass the twin to check the Function's gradient wiring.
"""

from __future__ import annotations

import ctypes

import torch

from ..bijectors.rqs import (
    DEFAULT_MIN_BIN_HEIGHT,
    DEFAULT_MIN_BIN_WIDTH,
    DEFAULT_MIN_DERIVATIVE,
    unconstrained_rqs,
)
from . import _build

KERNEL = "rqs"
MAX_BINS = 128


def _library():
    lib = _build.load(KERNEL)
    fn = lib.nf_rqs_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64]
                       + [ctypes.c_int] * 2 + [ctypes.c_double] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, w, h, d):
    k = w.shape[-1] if w.dim() else 0
    if not 2 <= k <= MAX_BINS:
        raise ValueError(f"the RQS kernel takes 2 <= K <= {MAX_BINS} bins, "
                         f"got K = {k}")
    shapes = dict(x=(tuple(x.shape), tuple(x.shape)),
                  w=(tuple(w.shape), tuple(x.shape) + (k,)),
                  h=(tuple(h.shape), tuple(x.shape) + (k,)),
                  d=(tuple(d.shape), tuple(x.shape) + (k - 1,)))
    for (name, (got, want)), t in zip(shapes.items(), (x, w, h, d)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} on {t.device}; the RQS kernel takes "
                             f"CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the RQS kernel takes float32; {name} is "
                            f"{t.dtype}")
        if got != want:
            raise ValueError(f"{name} has shape {got}, expected {want}")
    return k


def rqs_cuda(x, w, h, d, inverse, left, right, bottom, top):
    """unconstrained_rqs(x, w, h, d) by the CUDA kernel on the current
    stream: x (...), w and h (..., K), d (..., K-1), float32 on one CUDA
    device. Returns (y, logabsdet) shaped like x. Raises on inputs the
    kernel does not take and on a failed launch; never falls back."""
    k = _check(x, w, h, d)
    xf = x.reshape(-1).contiguous()
    n = xf.numel()
    y = torch.empty_like(xf)
    ld = torch.empty_like(xf)
    if n == 0:
        return y.reshape(x.shape), ld.reshape(x.shape)
    wf = w.reshape(n, k).contiguous()
    hf = h.reshape(n, k).contiguous()
    df = d.reshape(n, k - 1).contiguous()
    fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(xf.data_ptr(), wf.data_ptr(), hf.data_ptr(), df.data_ptr(),
             y.data_ptr(), ld.data_ptr(), n, k, int(bool(inverse)),
             float(left), float(right), float(bottom), float(top),
             DEFAULT_MIN_BIN_WIDTH, DEFAULT_MIN_BIN_HEIGHT,
             DEFAULT_MIN_DERIVATIVE, stream)
    if err != 0:
        raise RuntimeError(f"rqs kernel launch failed: CUDA error {err}")
    rqs_cuda.launches += 1
    return y.reshape(x.shape), ld.reshape(x.shape)


rqs_cuda.launches = 0


def plain_rqs(x, w, h, d, inverse, left, right, bottom, top):
    """The twin with `rqs_cuda`'s signature."""
    return unconstrained_rqs(x, w, h, d, inverse=inverse, left=left,
                             right=right, bottom=bottom, top=top)


class _FusedRQS(torch.autograd.Function):
    """Forward by `forward`; backward by autograd through the plain twin
    (the JAX custom_vjp `_fused_fwd` / `_fused_bwd`)."""

    @staticmethod
    def forward(ctx, x, w, h, d, forward, inverse, bounds):
        ctx.save_for_backward(x, w, h, d)
        ctx.inverse = inverse
        ctx.bounds = bounds
        return forward(x, w, h, d, inverse, *bounds)

    @staticmethod
    def backward(ctx, grad_y, grad_ld):
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            y, ld = plain_rqs(*ins, ctx.inverse, *ctx.bounds)
            wanted = [t for t, need in zip(ins, needs) if need]
            grads = iter(torch.autograd.grad((y, ld), wanted,
                                             (grad_y, grad_ld),
                                             allow_unused=True))
        return (*(next(grads) if need else None for need in needs),
                None, None, None)


def unconstrained_rqs_fused(x, w, h, d, inverse, left, right, bottom, top,
                            forward=rqs_cuda):
    """unconstrained_rqs with its forward by `forward` (the CUDA kernel)
    and its gradient by autograd through the plain twin."""
    return _FusedRQS.apply(x, w, h, d, forward, bool(inverse),
                           (float(left), float(right), float(bottom),
                            float(top)))
