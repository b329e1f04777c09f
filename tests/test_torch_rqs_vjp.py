"""The RQS backward: its closed-form VJP against JAX, and its wiring.

`ops.rqs.rqs_vjp_plain` (the backward kernel's plain version) against
`jax.vjp` of the JAX `unconstrained_rqs` in float64 at rtol 1e-10, forward
and inverse, symmetric and asymmetric bounds, K in {2, 8, 32}: points in the
domain and both tails, on the knots, exactly on both bounds (where x gets
half the gradient), NaN and +-inf, with random cotangents of y and log-det.
A row exactly on a knot keeps only the terms that do not jump there: its
log-det cotangent is 0 (the log-det's derivative jumps at a knot, and the
two packages may round the knot to either side of the point). Then the same
against autograd through the port's twin, and one SplineCoupling layer's
parameter gradient through the autograd Function with the plain VJP
against JAX's (tests/test_torch_rqs.py holds that Function, for each
subset of inputs needing grad, against autograd through the twin). The
CUDA backward kernel is held against `rqs_vjp_plain` on the card by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu.bijectors import rqs as jrqs

from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.bijectors import coupling as tcoupling
from normalizingflow_tpu_torch.bijectors import rqs as trqs
from normalizingflow_tpu_torch.ops import rqs as ops_rqs

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
BOUNDS = {
    "symmetric": (-3.0, 3.0, -3.0, 3.0),
    "asymmetric": (-1.5, 2.5, -0.5, 4.0),
}


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def case(k, inverse, bounds, seed, n=150):
    """(x, w, h, d, grad_y, grad_ld) as numpy float64: points across the
    domain and both tails, the two bounds, rows exactly on the JAX
    function's knots (log-det cotangent 0), then NaN, +inf and -inf."""
    rng = np.random.default_rng(seed)
    left, right, bottom, top = bounds
    lo, hi = (bottom, top) if inverse else (left, right)
    w, h = rng.standard_normal((n, k)), rng.standard_normal((n, k))
    d = rng.standard_normal((n, k - 1))
    span = hi - lo
    x = rng.uniform(lo - 0.3 * span, hi + 0.3 * span, n)
    x[0], x[1], x[2], x[3] = lo, hi, lo, hi
    knots, _ = jrqs._normalize_bins(jnp.asarray(h if inverse else w), k,
                                    1e-3, lo, hi)
    rows = np.arange(4, n - 4, 3)
    x[rows] = np.asarray(knots)[rows, rng.integers(0, k + 1, rows.size)]
    x[-4:] = [np.nan, np.inf, -np.inf, -np.nan]
    gy = rng.standard_normal(n)
    gld = rng.standard_normal(n)
    gld[rows] = 0.0
    return x, w, h, d, gy, gld


def jax_vjp(x, w, h, d, gy, gld, inverse, bounds):
    left, right, bottom, top = bounds
    _, vjp = jax.vjp(lambda *a: jrqs.unconstrained_rqs(
        *a, inverse=inverse, left=left, right=right, bottom=bottom, top=top),
        *map(jnp.asarray, (x, w, h, d)))
    return [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gld)))]


def assert_grads(got, want, label):
    for name, a, b in zip("xwhd", got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} d/d{name}")


CASES = [(k, inverse, bounds) for k in (2, 8, 32) for inverse in (False, True)
         for bounds in BOUNDS]


@pytest.mark.parametrize("k,inverse,bounds", CASES)
@pytest.mark.parametrize("against", ["jax", "twin"])
def test_vjp_plain_matches(k, inverse, bounds, against):
    b = BOUNDS[bounds]
    args = case(k, inverse, b, seed=k + 10 * inverse)
    if against == "jax":
        want = jax_vjp(*args, inverse, b)
    else:
        want = ops_rqs.twin_vjp(*map(t, args), inverse, *b)
    got = ops_rqs.rqs_vjp_plain(*map(t, args), inverse, *b)
    assert_grads(got, want, f"{against} K={k} inverse={inverse} {bounds}")


@pytest.mark.parametrize("inverse", [False, True])
def test_vjp_plain_bounds_nan_and_inf_rows(inverse):
    """x on a bound gets half its in-domain gradient; +-inf rows pass
    grad_y to x and nothing to the parameters; a NaN row is NaN in x, in
    every logit and in the d entry of bin 0 (where a NaN is binned), as in
    the JAX VJP."""
    b = BOUNDS["asymmetric"]
    x, w, h, d, gy, gld = case(8, inverse, b, seed=11)
    gx, gw, gh, gd = (g.numpy() for g in ops_rqs.rqs_vjp_plain(
        *map(t, (x, w, h, d, gy, gld)), inverse, *b))
    lo, hi = (b[2], b[3]) if inverse else (b[0], b[1])
    # rows 0..3 are lo, hi, lo, hi: the full gradient at a point just inside
    for row, inward in ((0, 1.0), (1, -1.0)):
        xi = np.array(x)
        xi[row] = (lo if row == 0 else hi) + inward * 1e-13
        gi = ops_rqs.rqs_vjp_plain(*map(t, (xi, w, h, d, gy, gld)), inverse,
                                   *b)[0].numpy()
        np.testing.assert_allclose(gx[row], 0.5 * gi[row], rtol=1e-9)
    for row in (-3, -2):
        assert gx[row] == gy[row]
        assert not gw[row].any() and not gh[row].any() and not gd[row].any()
    for row in (-4, -1):
        assert np.isnan(gx[row])
        assert np.isnan(gw[row]).all() and np.isnan(gh[row]).all()
        assert np.isnan(gd[row, 0]) and not gd[row, 1:].any()
    # outside the domain the parameters get nothing
    out = (x < lo) | (x > hi)
    assert out.sum() > 10
    np.testing.assert_array_equal(gx[out], gy[out])
    assert not gw[out].any() and not gd[out].any()
    # inside, d gets at most the bin's two entries
    assert ((gd[np.isfinite(x)] != 0).sum(axis=-1) <= 2).all()


def test_function_refuses_double_backward():
    """Nothing in the port takes a second derivative of the RQS: the
    Function is once-differentiable, and a double backward raises."""
    b = BOUNDS["symmetric"]
    x, w, h, d, _, _ = (t(a) for a in case(8, False, b, seed=13, n=16))
    x.requires_grad_(True)
    y, ld = ops_rqs.unconstrained_rqs_fused(
        x, w, h, d, False, *b, forward=ops_rqs.plain_rqs,
        backward=ops_rqs.rqs_vjp_plain)
    (gx,) = torch.autograd.grad((y * y).sum() + ld.sum(), x,
                                create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


def test_vjp_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        ops_rqs.rqs_vjp_cuda(x, torch.zeros(4, 8), torch.zeros(4, 8),
                             torch.zeros(4, 7), x, x, False, -1.0, 1.0,
                             -1.0, 1.0)
    assert ops_rqs.rqs_vjp_cuda.launches == 0


def fused_plain_rqs(inputs, w, h, d, *, inverse=False, tail_bound=None,
                    left=None, right=None, bottom=None, top=None):
    """apply_rqs's path on the card, with the kernels' plain versions."""
    bounds = trqs.resolve_bounds(tail_bound, left, right, bottom, top)
    return ops_rqs.unconstrained_rqs_fused(
        inputs, w, h, d, inverse, *bounds, forward=ops_rqs.plain_rqs,
        backward=ops_rqs.rqs_vjp_plain)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_spline_coupling_grads_through_plain_vjp_match_jax(direction,
                                                           monkeypatch):
    """One SplineCoupling layer, its spline through the autograd Function
    with the plain VJP: parameter and input gradients against JAX's, the
    parameters carried by params.from_jax."""
    size, space, k, bound, hidden, batch = 4, 3, 8, 3.0, 16, 24
    kw = dict(num_bins=k, tail_bound=bound, hidden_dim=hidden, mask=(1,))
    jl = jb.SplineCoupling(size, space, **kw)
    tl = tb.SplineCoupling(size, space, **kw, dtype=torch.float64)
    rng = np.random.default_rng(14)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))),
        jl.init(jax.random.PRNGKey(14)))
    tparams.from_jax(tl, p)
    x = 1.5 * rng.standard_normal((batch, size * space))
    cy = rng.standard_normal(x.shape)
    cld = rng.standard_normal(batch)

    def jloss(q, xx):
        y, ld = getattr(jl, direction)(q, xx)
        return jnp.sum(cy * y) + jnp.sum(cld * ld)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    monkeypatch.setattr(tcoupling, "apply_rqs", fused_plain_rqs)
    tx = t(x).requires_grad_(True)
    y, ld = getattr(tl, direction)(tx)
    (torch.sum(t(cy) * y) + torch.sum(t(cld) * ld)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-9,
                               atol=1e-11)
    grads = {n: prm.grad.numpy() for n, prm in tl.named_parameters()}
    flat = {".".join(str(q.key) for q in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgp)[0]}
    assert set(grads) == set(flat)
    for name, g in flat.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-9, atol=1e-11,
                                   err_msg=name)
