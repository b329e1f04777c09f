"""Parity of the port's RQS transform with the JAX package.

The plain twin (bijectors/rqs.py) against the JAX `unconstrained_rqs` in
float64 at rtol 1e-10: values, log-dets and gradients with respect to x, w,
h and d, forward and inverse, over tails, knots, the bounds themselves,
asymmetric bounds, NaN and inf. Then the twin against the Pallas kernel
(`unconstrained_rqs_fused`, interpret mode) in float32 at the tolerances
tests/test_rqs_pallas.py holds that kernel to, and the port's autograd
Function, with the twin as its forward and as its backward autograd through
the twin or the closed-form plain VJP, against autograd through the twin.
The CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py; the plain VJP against JAX's is in
tests/test_torch_rqs_vjp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu.bijectors import rqs as jrqs
from normalizingflow_tpu.ops.rqs_pallas import (
    unconstrained_rqs_fused as j_fused,
)

from normalizingflow_tpu_torch.bijectors import rqs as trqs
from normalizingflow_tpu_torch.ops import rqs as ops_rqs

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
# tests/test_rqs_pallas.py's kernel-vs-jnp tolerances (float32)
Y_TOL = dict(atol=2e-5, rtol=1e-5)
LD_TOL = dict(atol=2e-4, rtol=1e-4)

BOUNDS = {
    "symmetric": dict(left=-3.0, right=3.0, bottom=-3.0, top=3.0),
    "asymmetric": dict(left=-1.5, right=2.5, bottom=-0.5, top=4.0),
}


def t(a, dtype=np.float64):
    return torch.from_numpy(np.array(a, dtype=dtype))


def params(rng, n, k, scale=1.0):
    return (scale * rng.standard_normal((n, k)),
            scale * rng.standard_normal((n, k)),
            scale * rng.standard_normal((n, k - 1)))


def inputs(rng, n, k, bounds, inverse, w, h):
    """Points across the domain and both tails, the two bounds, and points
    exactly on the knots the JAX function computes for each row."""
    lo, hi = ((bounds["bottom"], bounds["top"]) if inverse
              else (bounds["left"], bounds["right"]))
    span = hi - lo
    x = rng.uniform(lo - 0.3 * span, hi + 0.3 * span, n)
    x[0], x[1] = lo, hi
    if inverse:
        knots, _ = jrqs._normalize_bins(jnp.asarray(h), k, 1e-3, lo, hi)
    else:
        knots, _ = jrqs._normalize_bins(jnp.asarray(w), k, 1e-3, lo, hi)
    knots = np.asarray(knots)
    rows = np.arange(2, n, 3)
    x[rows] = knots[rows, rng.integers(0, k + 1, rows.size)]
    on_knot = np.zeros(n, bool)
    on_knot[rows] = True
    return x, on_knot


def jax_rqs(x, w, h, d, inverse, bounds):
    return jrqs.unconstrained_rqs(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), jnp.asarray(d),
        inverse=inverse, **bounds)


@pytest.mark.parametrize("k", [2, 8, 32])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("bounds", ["symmetric", "asymmetric"])
def test_twin_matches_jax(k, inverse, bounds):
    rng = np.random.default_rng(k + 10 * inverse)
    b = BOUNDS[bounds]
    n = 120
    w, h, d = params(rng, n, k)
    x, on_knot = inputs(rng, n, k, b, inverse, w, h)
    jy, jld = jax_rqs(x, w, h, d, inverse, b)
    ts = [t(a).requires_grad_(True) for a in (x, w, h, d)]
    ty, tld = trqs.unconstrained_rqs(*ts, inverse=inverse, **b)
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tld.detach().numpy(), jld, rtol=RTOL,
                               atol=ATOL)

    # Gradients w.r.t. x, w, h, d of a loss that weighs every output. The
    # spline is C1, so y and log-det agree however a point on a knot is
    # binned, but the log-det's own derivative jumps there, and the two
    # packages' cumsums may round a knot to the other side of such a point:
    # the log-det terms of the knot rows are left out of the loss.
    cy = rng.standard_normal(n)
    cld = np.where(on_knot, 0.0, rng.standard_normal(n))

    def jloss(x, w, h, d):
        y, ld = jrqs.unconstrained_rqs(x, w, h, d, inverse=inverse, **b)
        return jnp.sum(cy * y * y) + jnp.sum(cld * ld)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, h, d)))
    (torch.sum(t(cy) * ty * ty) + torch.sum(t(cld) * tld)).backward()
    for name, a, g in zip("xwhd", ts, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d/d{name}")


@pytest.mark.parametrize("inverse", [False, True])
def test_twin_nan_and_inf_match_jax(inverse):
    """Non-finite inputs take the tail branch: y = x and log-det 0."""
    rng = np.random.default_rng(3)
    k = 8
    x = np.array([np.nan, np.inf, -np.inf, 0.5, -np.nan])
    w, h, d = params(rng, x.size, k)
    b = BOUNDS["asymmetric"]
    jy, jld = jax_rqs(x, w, h, d, inverse, b)
    ty, tld = trqs.unconstrained_rqs(*map(t, (x, w, h, d)), inverse=inverse,
                                     **b)
    np.testing.assert_array_equal(np.isnan(ty.numpy()), np.isnan(jy))
    np.testing.assert_allclose(ty.numpy(), jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tld.numpy(), jld, rtol=RTOL, atol=ATOL)
    assert ty[:3].tolist()[1:] == [np.inf, -np.inf] and torch.isnan(ty[0])
    assert not tld[:3].any()


def test_twin_softplus_is_jax_softplus():
    """Above torch softplus's threshold of 20 the two differ in float64."""
    x = np.array([-40.0, -5.0, 0.0, 3.0, 19.5, 20.0, 25.0, 40.0])
    np.testing.assert_allclose(trqs.softplus(t(x)).numpy(),
                               jax.nn.softplus(jnp.asarray(x)), rtol=1e-15,
                               atol=0)


def test_split_spline_params_matches_jax():
    raw = np.random.default_rng(4).standard_normal((3, 5, 3 * 6 - 1))
    for a, b in zip(trqs.split_spline_params(t(raw), 6),
                    jrqs.split_spline_params(jnp.asarray(raw), 6)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("inverse", [False, True])
def test_twin_matches_pallas_kernel_f32(inverse):
    """The twin in float32 against the Pallas kernel (interpret mode) at
    the tolerances the JAX package holds that kernel to."""
    rng = np.random.default_rng(5)
    b = 3.0
    x = np.linspace(-4.0, 4.0, 700).astype(np.float32)
    w, h, d = (a.astype(np.float32) for a in params(rng, x.size, 8))
    jy, jld = j_fused(*map(jnp.asarray, (x, w, h, d)), inverse, -b, b, -b, b,
                      True)
    ty, tld = trqs.unconstrained_rqs(
        *(t(a, np.float32) for a in (x, w, h, d)), inverse=inverse,
        tail_bound=b)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), **LD_TOL)


@pytest.mark.parametrize("needs", ["xwhd", "x", "whd", "w", "hd"])
@pytest.mark.parametrize("inverse", [False, True])
def test_autograd_function_matches_twin(needs, inverse):
    """The Function's forward and backward are the ones it is given, and
    inputs that do not need a gradient get None: with the twin as its
    forward and, as its backward, autograd through the twin (recomputed)
    or the closed-form plain VJP, it equals autograd through the twin for
    each subset of inputs needing grad. The closed form rounds otherwise
    than autograd, so it is held at RTOL, ATOL."""
    rng = np.random.default_rng(6)
    k, n = 8, 64
    b = BOUNDS["asymmetric"]
    w, h, d = params(rng, n, k)
    x, _ = inputs(rng, n, k, b, inverse, w, h)
    cy, cld = t(rng.standard_normal(n)), t(rng.standard_normal(n))

    def grads(backward):
        ts = [t(a).requires_grad_(name in needs)
              for name, a in zip("xwhd", (x, w, h, d))]
        if backward is None:
            y, ld = trqs.unconstrained_rqs(*ts, inverse=inverse, **b)
        else:
            y, ld = ops_rqs.unconstrained_rqs_fused(
                *ts, inverse, b["left"], b["right"], b["bottom"], b["top"],
                forward=ops_rqs.plain_rqs, backward=backward)
        (torch.sum(cy * y * y) + torch.sum(cld * ld)).backward()
        return y.detach(), ld.detach(), [a.grad for a in ts]

    py, pld, pg = grads(None)
    for backward, tol in ((ops_rqs.twin_vjp, dict(rtol=1e-12, atol=1e-14)),
                          (ops_rqs.rqs_vjp_plain, dict(rtol=RTOL,
                                                       atol=ATOL))):
        fy, fld, fg = grads(backward)
        assert torch.equal(fy, py) and torch.equal(fld, pld)
        for name, a, g in zip("xwhd", fg, pg):
            if name in needs:
                torch.testing.assert_close(a, g, **tol)
            else:
                assert a is None and g is None


def test_apply_rqs_on_cpu_is_the_twin():
    rng = np.random.default_rng(7)
    w, h, d = (t(a) for a in params(rng, 30, 8))
    x = t(rng.uniform(-4, 4, 30))
    for inverse in (False, True):
        a = trqs.apply_rqs(x, w, h, d, inverse=inverse, tail_bound=3.0)
        b = trqs.unconstrained_rqs(x, w, h, d, inverse=inverse,
                                   tail_bound=3.0)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_bins():
    """The kernel wrapper never falls back: CPU tensors and bin counts it
    does not take raise before anything is built or launched."""
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        ops_rqs.rqs_cuda(x, torch.zeros(4, 8), torch.zeros(4, 8),
                         torch.zeros(4, 7), False, -1.0, 1.0, -1.0, 1.0)
    with pytest.raises(ValueError, match="bins"):
        ops_rqs.rqs_cuda(x, torch.zeros(4, 129), torch.zeros(4, 129),
                         torch.zeros(4, 128), False, -1.0, 1.0, -1.0, 1.0)
    assert ops_rqs.rqs_cuda.launches == 0


def test_twin_float32_accuracy():
    """tests/test_rqs.py test_float32_accuracy: the twin in float32 stays
    within 5e-5 / 1e-5 (y) and 5e-4 / 1e-4 (log-det) of itself in float64
    on the same inputs."""
    rng = np.random.default_rng(6)
    x = np.linspace(-2.5, 2.5, 64)
    w, h, d = params(rng, x.size, 8)
    b = dict(left=-3.0, right=3.0, bottom=-3.0, top=3.0)
    y64, ld64 = trqs.unconstrained_rqs(*map(t, (x, w, h, d)), inverse=False,
                                       **b)
    f32 = [t(a, np.float32) for a in (x, w, h, d)]
    y32, ld32 = trqs.unconstrained_rqs(*f32, inverse=False, **b)
    assert y32.dtype == torch.float32
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), atol=5e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ld32.numpy(), ld64.numpy(), atol=5e-4,
                               rtol=1e-4)
