"""Parity of the port's Planar, Radial and InvertibleLinear bijectors with
the JAX package's, in float64.

Each layer gets JAX's own initial weights, perturbed, through
`params.from_jax`; forward, inverse, log-det and the gradients of a scalar
of both with respect to every weight and the input then match JAX's at
rtol 1e-12. Planar has no inverse in either package. InvertibleLinear's
inverse follows a parameter update (the original code cached W^-1 and
kept the stale one). The three config names build flows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import config as jconfig
from normalizingflow_tpu.bijectors import elementary as je

from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import config as tconfig
from normalizingflow_tpu_torch import params as tparams

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
DIM, BATCH = 5, 7


def close(actual, expected, rtol=1e-12, atol=1e-13, msg=""):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=msg)


def pair(kind, seed=0):
    """(JAX layer, its perturbed float64 params, the port's layer with
    them)."""
    jlayer, tlayer = {
        "planar_tanh": (je.Planar(DIM), tb.Planar(DIM, **F64)),
        "planar_leaky_relu": (je.Planar(DIM, "leaky_relu"),
                              tb.Planar(DIM, "leaky_relu", **F64)),
        "planar_elu": (je.Planar(DIM, "elu"), tb.Planar(DIM, "elu", **F64)),
        "radial": (je.Radial(DIM), tb.Radial(DIM, **F64)),
        "linear": (je.InvertibleLinear(DIM), tb.InvertibleLinear(DIM, **F64)),
    }[kind]
    rng = np.random.default_rng(seed)
    p = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)
                              + 0.3 * rng.standard_normal(np.shape(a))),
        jlayer.init(jax.random.PRNGKey(seed)))
    if kind == "linear":  # P stays a permutation
        p["P"] = jnp.asarray(np.asarray(jlayer.init(
            jax.random.PRNGKey(seed))["P"], np.float64))
    tparams.from_jax(tlayer, p)
    return jlayer, p, tlayer


def _scalar(y, ld):
    return (y ** 2).sum() + (y[:, :1] ** 3).sum() + ld.sum()


def compare_direction(jlayer, p, tlayer, x, inverse):
    jfn = jlayer.inverse if inverse else jlayer.forward
    tfn = tlayer.inverse if inverse else tlayer.forward
    jy, jld = jfn(p, jnp.asarray(x))
    jgp, jgx = jax.grad(lambda p, x: _scalar(*jfn(p, x)), argnums=(0, 1))(
        p, jnp.asarray(x))
    tx = torch.tensor(x, **F64, requires_grad=True)
    ty, tld = tfn(tx)
    close(ty.detach(), jy, msg="y")
    close(tld.detach(), jld, msg="log_det")
    assert tld.shape == (BATCH,)
    _scalar(ty, tld).backward()
    close(tx.grad, jgx, msg="d/dx")
    got = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
           for k, v in tlayer.named_parameters()}
    for k, g in jgp.items():
        close(got[k], g, msg=f"d/d{k}")


@pytest.mark.parametrize("kind", ["planar_tanh", "planar_leaky_relu",
                                  "planar_elu", "radial", "linear"])
def test_forward_matches_jax(kind):
    jlayer, p, tlayer = pair(kind)
    x = np.random.default_rng(1).standard_normal((BATCH, DIM))
    compare_direction(jlayer, p, tlayer, x, inverse=False)


@pytest.mark.parametrize("kind", ["radial", "linear"])
def test_inverse_matches_jax_and_round_trips(kind):
    jlayer, p, tlayer = pair(kind, seed=2)
    y = np.random.default_rng(3).standard_normal((BATCH, DIM))
    compare_direction(jlayer, p, tlayer, y, inverse=True)
    with torch.no_grad():
        ty = torch.tensor(y, **F64)
        x, ld_inv = tlayer.inverse(ty)
        y2, ld_fwd = tlayer.forward(x)
    close(y2, y, rtol=1e-12, atol=1e-12)
    close(ld_inv + ld_fwd, np.zeros(BATCH), atol=1e-12)


def test_planar_has_no_inverse_and_checks_its_nonlinearity():
    with pytest.raises(NotImplementedError, match="no algebraic inverse"):
        tb.Planar(DIM, **F64).inverse(torch.zeros(2, DIM, **F64))
    with pytest.raises(NotImplementedError, match="'relu' is not supported"):
        tb.Planar(DIM, "relu")


def test_invertible_linear_inverse_follows_an_update():
    """The inverse solves against the current L, U and S: after an
    optimizer step it inverts the updated forward, with no stale cache."""
    jlayer, p, tlayer = pair("linear", seed=4)
    assert not tlayer.P.requires_grad
    y = torch.tensor(np.random.default_rng(5).standard_normal((BATCH, DIM)),
                     **F64)
    tlayer.inverse(y)  # an inverse before the update
    opt = torch.optim.SGD(tlayer.parameters(), lr=0.1)
    _scalar(*tlayer.forward(y)).backward()
    opt.step()
    assert tlayer.P.grad is None
    with torch.no_grad():
        x, _ = tlayer.inverse(y)
        close(tlayer.forward(x)[0], y, rtol=1e-12, atol=1e-12)
    new = tparams.to_numpy(tlayer)
    jx, jld = jlayer.inverse(jax.tree.map(jnp.asarray, new), jnp.asarray(y))
    close(x, jx)
    close(tlayer.inverse(y)[1].detach(), jld)


@pytest.mark.parametrize("kind,layer", [("Planar", tb.Planar),
                                        ("Radial", tb.Radial),
                                        ("OneByOneConv",
                                         tb.InvertibleLinear)])
def test_config_names_build(kind, layer):
    raw = {"dataset": {"nparticles": 4, "dim": 2},
           "flow": {"type": kind, "nlayers": 3}}
    cfg = tconfig._merge_dataclass(tconfig.Config(), raw)
    stack = tconfig.build_flow_stack(cfg, 1.0, **F64)
    jstack = jconfig.build_flow_stack(
        jconfig._merge_dataclass(jconfig.Config(), raw), 1.0)
    assert [type(b) for b in stack.bijectors] == [layer] * 3
    assert len(jstack.bijectors) == 3
    p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                     jstack.init(jax.random.PRNGKey(0)))
    tparams.from_jax(stack, p)
    x = np.random.default_rng(6).standard_normal((BATCH, 8))
    jy, jld = jstack.forward(p, jnp.asarray(x))
    ty, tld = stack.forward(torch.tensor(x, **F64))
    close(ty.detach(), jy, rtol=1e-10, atol=1e-12)
    close(tld.detach(), jld, rtol=1e-10, atol=1e-12)
    assert isinstance(jstack, jb.Chain)
