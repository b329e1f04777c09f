"""The bfloat16 Adam first moment: the memory policy, its arithmetic against
optax.adam(mu_dtype=jnp.bfloat16), and checkpoints across the policy.

The policy keeps mu in bfloat16 when 4.25x the parameter bytes exceed 14.5/16
of the device's memory (JAX's 14.5e9 of the TPU v5e's 16 GB; on the CPU the
port keeps 14.5e9). The arithmetic is held to optax in float32 for 50 steps:
bfloat16 rounds at the same places (b1 * mu in bfloat16, the update from the
full-precision moment, the stored moment rounded), so the two agree bit for
bit on an IEEE float32 CPU; the tolerance, rtol 1e-6, leaves room for
float32 rounding alone, while one bfloat16 rounding taken differently shows as
~4e-3 relative in mu.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from normalizingflow_tpu_torch.train import (
    Adam,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
)
from normalizingflow_tpu_torch.train.fused import (
    BUDGET_SHARE,
    adam_mu_dtype,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# Polymer_rnvp: 10 x AffineCoupling(2048, hidden 4000), ~967M float32 params
RNVP_BYTES = 4 * 10 * 4 * (1024 * 4000 + 4000 + 4000 * 4000 + 4000
                           + 4000 * 1024 + 1024)


@pytest.mark.parametrize("capacity,param_bytes,want", [
    (80e9, RNVP_BYTES, None),            # the H100: every config in f32
    (16e9, RNVP_BYTES, torch.bfloat16),  # the v5e's memory
    (16e9, 3.41e9, None),                # just under 14.5e9 / 4.25
    (16e9, 3.42e9, torch.bfloat16),      # just over
    (1e9, 1e6, None),
])
def test_policy_at_forced_capacities(capacity, param_bytes, want):
    assert adam_mu_dtype(param_bytes, CPU, capacity=capacity) is want
    assert 4.25 * param_bytes > BUDGET_SHARE * capacity or want is None


def test_policy_on_the_cpu_is_jax_threshold():
    assert adam_mu_dtype(14.5e9 / 4.25 * 0.999, CPU) is None
    assert adam_mu_dtype(14.5e9 / 4.25 * 1.001, CPU) is torch.bfloat16


SHAPES = [(6, 5), (5,), (7,)]


def grads_at(k, rng):
    return [rng.standard_normal(s).astype(np.float32) * 10.0 ** (k % 3 - 1)
            for s in SHAPES]


def test_fifty_bf16_adam_steps_match_optax():
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jopt = optax.adam(3e-2, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(a) for a in p0]
    state = jopt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    topt = make_optimizer(tp, 3e-2, "constant", mu_dtype=torch.bfloat16)
    for k in range(50):
        grads = grads_at(k, rng)
        upd, state = jopt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for prm, g in zip(tp, grads):
            prm.grad = torch.from_numpy(g)
        topt.step()
    adam_state = state[0]
    assert all(m.dtype == jnp.bfloat16 for m in adam_state.mu)
    for prm, want in zip(tp, jp):
        assert prm.dtype == torch.float32
        np.testing.assert_allclose(prm.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    for prm, m, v in zip(tp, adam_state.mu, adam_state.nu):
        mu = topt.state[prm]["mu"]
        assert mu.dtype == torch.bfloat16
        np.testing.assert_allclose(mu.float().numpy(),
                                   np.asarray(m, np.float32), rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(topt.state[prm]["nu"].numpy(),
                                   np.asarray(v), rtol=1e-6)


def test_the_update_uses_the_full_precision_moment():
    """optax's order: the step divides the moment before its bfloat16
    cast, which the port follows; the cast moment gives another update."""
    g = np.array([0.3, -1.7, 2.9], np.float32)
    jopt = optax.scale_by_adam(mu_dtype=jnp.bfloat16)
    upd, state = jopt.update(jnp.asarray(g), jopt.init(jnp.zeros(3)))
    full = 0.1 * g / 0.1 / (np.sqrt(0.001 * g * g / 0.001) + 1e-8)
    np.testing.assert_allclose(np.asarray(upd), full, rtol=1e-6)
    stored = np.asarray(state.mu, np.float32)
    assert not np.allclose(stored / 0.1 / (np.abs(g) + 1e-8), full,
                           rtol=1e-5, atol=0)
    prm = torch.nn.Parameter(torch.zeros(3))
    opt = Adam([prm], lambda k: 1.0, mu_dtype=torch.bfloat16)
    prm.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(-prm.detach().numpy(), np.asarray(upd),
                               rtol=1e-6)
    np.testing.assert_array_equal(opt.state[prm]["mu"].float().numpy(),
                                  stored)


def stepped(mu_dtype, steps=3):
    prm = [torch.nn.Parameter(torch.linspace(-1, 1, 7)),
           torch.nn.Parameter(torch.ones(2, 3))]
    opt = make_optimizer(prm, 1e-2, "constant", mu_dtype=mu_dtype)
    for k in range(steps):
        for p in prm:
            p.grad = torch.full_like(p, 0.37 * (k + 1))
        opt.step()
    return prm, opt


@pytest.mark.parametrize("saved,loaded", [(torch.bfloat16, None),
                                          (None, torch.bfloat16)])
def test_checkpoints_load_across_the_policy(tmp_path, saved, loaded):
    """A training state saved under one policy loads under the other:
    load_checkpoint casts the moments to the template's dtypes, and the
    optimizer casts them to its own."""
    _, opt = stepped(saved)
    path = str(tmp_path / "s.pt")
    tree = opt.state_tree()
    save_checkpoint(path, {"opt_state": tree, "epoch": 3})
    _, other = stepped(loaded, steps=1)
    template = other.state_tree()
    back = load_checkpoint(path, {"opt_state": template})
    want = torch.bfloat16 if loaded else torch.float32
    assert all(m.dtype == want for m in back["opt_state"]["mu"])
    assert all(v.dtype == torch.float32 for v in back["opt_state"]["nu"])
    other.load_state_tree(back["opt_state"])
    assert other.count == 3
    for p, m in zip(other.param_groups[0]["params"], tree["mu"]):
        got = other.state[p]["mu"]
        assert got.dtype == want
        np.testing.assert_allclose(got.float().numpy(),
                                   torch.as_tensor(m).float().numpy(),
                                   rtol=2 ** -8)
    # and straight from the raw file, cast by the optimizer itself
    raw = load_checkpoint(path)
    assert raw["opt_state"]["mu"][0].dtype == (saved or torch.float32)
    other.load_state_tree(raw["opt_state"])
    assert other.state[other.param_groups[0]["params"][0]]["mu"].dtype \
        == want


def test_train_flow_fused_reports_the_policy():
    from normalizingflow_tpu_torch import NormalizingFlow
    from normalizingflow_tpu_torch.bijectors import ActNorm, Chain
    from normalizingflow_tpu_torch.distributions import DiagNormal
    from normalizingflow_tpu_torch.targets import TrajectoryDataset
    from normalizingflow_tpu_torch.train import train_flow_fused

    flow = NormalizingFlow(DiagNormal(3), Chain([ActNorm(3)]))
    data = TrajectoryDataset(data=np.random.default_rng(0).standard_normal(
        (32, 3)), dtype=torch.float32)
    hist = train_flow_fused(flow, torch.Generator().manual_seed(0), data,
                            max_epochs=4, batch_size=8, device="cpu")
    assert hist["adam_mu_dtype"] == "float32"
