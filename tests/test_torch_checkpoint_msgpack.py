"""The port reads the JAX package's msgpack checkpoints.

The JAX package writes each checkpoint here, on the CPU, with its own
`save_checkpoint` (flax.serialization msgpack): a RealNVP, and a RealNVP
and a SplineAR stacked as `Repeat` by the config's rule, with an optax Adam
state, the PRNG key, the epoch and the losses. `load_jax_checkpoint`
rebuilds a float64 flow whose log_prob equals JAX's at rtol 1e-12 and
returns the rest of the state as it was. A state under the bfloat16
Adam-mu policy decodes its moments as bfloat16 tensors, bit for bit. And
`apps.test --checkpoint` evaluates a JAX checkpoint of the 4-particle LJ
solid of test_torch_config_apps.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import normalizingflow_tpu.config as jconfig
from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.train.checkpoint import save_checkpoint

import normalizingflow_tpu_torch as nft
import normalizingflow_tpu_torch.config as tconfig
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch.bijectors import Repeat
from normalizingflow_tpu_torch.train.checkpoint import (
    load_jax_checkpoint,
    read_jax_checkpoint,
)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))),
        tree)


def flows(kind, nlayers):
    """(JAX flow, the port's float64 twin), the stack by each config's
    build_flow_stack: 4 particles x 2 dims."""
    raw = {"dataset": {"nparticles": 4, "dim": 2},
           "flow": {"type": kind, "nlayers": nlayers, "hidden_dim": 6,
                    "nsplines": 4}}
    jstack = jconfig.build_flow_stack(
        jconfig._merge_dataclass(jconfig.Config(), raw), 3.0)
    tstack = tconfig.build_flow_stack(
        tconfig._merge_dataclass(tconfig.Config(), raw), 3.0, **F64)
    return (JFlow(jd.DiagNormal(8), jstack),
            nft.NormalizingFlow(td.DiagNormal(8, **F64), tstack))


def training_state(params, mu_dtype=None):
    """What train/fused.py saves, after one Adam step."""
    opt = optax.adam(1e-3, mu_dtype=mu_dtype)
    opt_state = opt.init(params)
    grads = jax.tree.map(lambda a: jnp.cos(a) + 0.5, params)
    _, opt_state = opt.update(grads, opt_state, params)
    return {"params": params, "opt_state": opt_state,
            "key": jax.random.PRNGKey(3), "epoch": np.asarray(7),
            "losses": np.asarray([3.5, 2.25, 1.125], np.float32)}


@pytest.mark.parametrize("kind,nlayers,repeat", [
    ("RealNVP", 2, False), ("RealNVP", 4, True), ("NSF_AR", 4, True)])
def test_flow_from_a_jax_checkpoint(tmp_path, kind, nlayers, repeat):
    jflow, tflow = flows(kind, nlayers)
    assert isinstance(tflow.bijector, Repeat) is repeat
    assert isinstance(jflow.bijector, jb.Repeat) is repeat
    params = perturbed(jflow.init(jax.random.PRNGKey(0)), 1)
    path = str(tmp_path / "model.msgpack")
    save_checkpoint(path, training_state(params))
    state = load_jax_checkpoint(path, tflow)
    x = np.random.default_rng(2).standard_normal((9, 8))
    with torch.no_grad():
        got = tflow.log_prob(torch.tensor(x, **F64))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jflow.log_prob(params, x)),
                               rtol=1e-12, atol=1e-12)
    assert int(state["epoch"]) == 7
    np.testing.assert_array_equal(state["losses"], [3.5, 2.25, 1.125])
    np.testing.assert_array_equal(state["key"],
                                  np.asarray(jax.random.PRNGKey(3)))
    adam = state["opt_state"][0]
    assert int(adam["count"]) == 1 and set(adam) == {"count", "mu", "nu"}


def _leaves(tree, prefix=()):
    """{path: leaf} of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_leaves(v, prefix + (str(k),)))
    return out


def test_bfloat16_moments_decode_bit_for_bit(tmp_path):
    jflow, tflow = flows("RealNVP", 2)
    params = perturbed(jflow.init(jax.random.PRNGKey(4)), 5)
    jstate = training_state(params, mu_dtype=jnp.bfloat16)
    path = str(tmp_path / "bf16.msgpack")
    save_checkpoint(path, jstate)
    state = read_jax_checkpoint(path)
    want = _leaves(jstate["opt_state"][0].mu)
    got = _leaves(state["opt_state"][0]["mu"])
    assert set(got) == set(want) and len(got) > 10
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy(),
            np.asarray(w).view(np.int16), err_msg=str(k))
    nu = _leaves(state["opt_state"][0]["nu"])
    for k, w in _leaves(jstate["opt_state"][0].nu).items():
        np.testing.assert_array_equal(nu[k], np.asarray(w))
    load_jax_checkpoint(path, tflow)  # the params load beside them


def test_apps_test_evaluates_a_jax_checkpoint(tmp_path, capsys):
    """apps.test --checkpoint on the tiny LJ solid's JAX checkpoint: the
    loaded flow gives JAX's log-density (float32 flow), and the estimates
    are finite."""
    from test_torch_config_apps import TINY_LJ

    from normalizingflow_tpu_torch.apps import sample_data, test
    from normalizingflow_tpu_torch.io import write_xyz

    box = 2 * (4 / (8 * 1.28)) ** (1 / 3)
    lattice = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
               * box - box / 4)
    write_xyz(str(tmp_path / "lattice.xyz"), lattice[None], 4)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_LJ.format(d=tmp_path))
    assert sample_data.main([str(cfg_path), "64"]) == 0

    jflow, _, _ = jconfig.setup_model(jconfig.load_config(str(cfg_path)),
                                      mode="testing")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), perturbed(
        jflow.init(jax.random.PRNGKey(0)), 6))
    ckpt = str(tmp_path / "jax" / "LJtiny.msgpack")
    save_checkpoint(ckpt, training_state(params))

    flow, _, _ = test.load_trained(tconfig.load_config(str(cfg_path)),
                                   checkpoint=ckpt)
    x = np.load(tmp_path / "data" / "test.npy")
    with torch.no_grad():
        got = flow.log_prob(torch.as_tensor(x, dtype=torch.float32))
    want = np.asarray(jflow.log_prob(params, jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)

    assert test.main([str(cfg_path), "--checkpoint", ckpt]) == 0
    out = np.load(tmp_path / "testing" / "fe_LJtiny.npz")
    for k in ("bar", "md", "nf", "emus"):
        assert np.isfinite(out[k]), k
    assert "bar=" in capsys.readouterr().out
    assert test.main([str(cfg_path), "--checkpoint"]) == 2
