"""Parity of the port's training path with the JAX package and optax.

The bench's optimizer is optax.chain(clip_by_global_norm(1.0),
adam(warmup_cosine_decay_schedule(0, peak, warmup, steps))); the port's
ClippedAdam must reproduce it in float64 to rounding (rtol 1e-12 per
update, 1e-9 after five steps of the whole flow, where rounding compounds
through the forward pass, the gradient and Adam's division).

optax evaluates the schedule on an int32 step counter, which JAX promotes
to float32 even with x64 on, so its learning rates are float32 values. The
port's schedule is the same formula in float64 and is held to optax at
float32 precision (rtol 1e-6); the optimizer tests give ClippedAdam
optax's own schedule, so that they test the update arithmetic exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.targets import NealsFunnel as JFunnel
from normalizingflow_tpu.train.objectives import (
    forward_kl as j_forward_kl,
    forward_kl_loss as j_forward_kl_loss,
    reverse_kl as j_reverse_kl,
)

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.targets import NealsFunnel
from normalizingflow_tpu_torch.train.loop import (
    ClippedAdam,
    train,
    train_step,
    warmup_cosine_decay_schedule,
)
from normalizingflow_tpu_torch.train.objectives import (
    forward_kl,
    forward_kl_loss,
    reverse_kl,
)

torch.set_num_threads(1)

DIM, HIDDEN, BATCH = 8, 16, 32
F64 = dict(dtype=torch.float64, device="cpu")


def optax_bench(peak, warmup, steps):
    return optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(optax.warmup_cosine_decay_schedule(
            0.0, peak, warmup_steps=warmup, decay_steps=steps)))


def optax_schedule(peak, warmup, steps):
    """optax's schedule as the port's optimizer takes it: k -> float."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, peak, warmup_steps=warmup, decay_steps=steps)
    return lambda k: float(sched(jnp.asarray(k, jnp.int32)))


def build_flows():
    jflow = JFlow(jd.DiagNormal(DIM), jb.Chain(
        [jb.ActNorm(DIM)] + [jb.AffineCoupling(DIM, HIDDEN)
                             for _ in range(2)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tb.Chain(
        [tb.ActNorm(DIM, **F64)] + [tb.AffineCoupling(DIM, HIDDEN, **F64)
                                    for _ in range(2)]))
    p = jax.tree.map(lambda a: np.asarray(a, np.float64),
                     jflow.init(jax.random.PRNGKey(0)))
    tparams.from_jax(tflow, p)
    return jflow, p, tflow


@pytest.mark.parametrize("steps", [2000, 15000])
def test_schedule_matches_optax(steps):
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=500,
                                             decay_steps=steps)
    ours = warmup_cosine_decay_schedule(0.0, 1e-3, 500, steps)
    for k in (0, 1, 250, 499, 500, 501, steps // 2, steps - 1, steps,
              steps + 7):
        np.testing.assert_allclose(ours(k), float(ref(k)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {k}")
    assert ours(0) == 0.0  # the first update has lr 0


def test_clipped_adam_matches_optax():
    """Three updates from identical grads: lr 0 at update 0, then two with
    lr > 0; the first two grads have global norm > 1 (clipped), the last
    < 1 (passed through)."""
    rng = np.random.default_rng(0)
    shapes = [(4, 16), (16,), (16, 3), (3,)]
    p0 = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) * f for s in shapes]
             for f in (3.0, 0.5, 0.02)]
    norms = [np.sqrt(sum((g * g).sum() for g in gs)) for gs in grads]
    assert norms[0] > 1 and norms[1] > 1 and norms[2] < 1

    opt = optax_bench(0.05, 2, 10)
    jp = [jnp.asarray(a) for a in p0]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    topt = ClippedAdam(tp, optax_schedule(0.05, 2, 10))
    for k, gs in enumerate(grads):
        upd, state = opt.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for prm, g in zip(tp, gs):
            prm.grad = torch.from_numpy(g.copy())
        topt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-12, atol=1e-15,
                                       err_msg=f"update {k}")
    np.testing.assert_array_equal(np.asarray(jp[0]) != p0[0], True)


def test_forward_kl_matches_jax():
    jflow, p, tflow = build_flows()
    x = np.random.default_rng(1).standard_normal((BATCH, DIM))
    tx = torch.from_numpy(x)
    loss, aux = forward_kl_loss(tflow, tx)
    jloss, jaux = j_forward_kl_loss(jflow, p, jnp.asarray(x))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-10)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-10)
    np.testing.assert_allclose(
        float(forward_kl(tflow, NealsFunnel(DIM), tx).detach()),
        float(j_forward_kl(jflow, p, JFunnel(DIM), jnp.asarray(x))),
        rtol=1e-10)


def test_five_train_steps_match_jax():
    """The whole stack on the funnel: five bench-optimizer updates on the
    same prior draws, params and losses against a JAX/optax loop."""
    jflow, p, tflow = build_flows()
    jtarget, ttarget = JFunnel(DIM), NealsFunnel(DIM)
    steps, peak, warmup = 5, 0.02, 2
    opt = optax_bench(peak, warmup, steps)
    state = opt.init(p)
    topt = ClippedAdam(list(tflow.parameters()),
                       optax_schedule(peak, warmup, steps))

    @jax.jit
    def jstep(p, state, key):
        loss, g = jax.value_and_grad(
            lambda q: j_reverse_kl(jflow, q, jtarget, key, BATCH))(p)
        upd, state = opt.update(g, state, p)
        return optax.apply_updates(p, upd), state, loss

    for k in range(steps):
        key = jax.random.PRNGKey(100 + k)
        z = torch.from_numpy(np.array(jflow.prior.sample(key, BATCH)))
        p, state, jloss = jstep(p, state, key)
        tloss = train_step(tflow, ttarget, topt, z)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-9)
    moved = False
    for a, b, p0 in zip(jax.tree.leaves(tparams.to_numpy(tflow)),
                        jax.tree.leaves(p), jax.tree.leaves(build_flows()[1])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)
        moved |= not np.allclose(a, p0, rtol=0, atol=1e-4)
    assert moved


def test_train_runs_and_lowers_the_loss():
    """The entry point on CPU: a short run reduces the reverse KL."""
    _, _, tflow = build_flows()
    gen = torch.Generator().manual_seed(0)
    target = NealsFunnel(DIM)
    with torch.no_grad():
        z = tflow.prior.sample(512, generator=gen)
        before = float(reverse_kl(tflow, target, z=z))
    final = train(tflow, target, 150, 128, gen, device="cpu",
                  warmup_steps=20)
    with torch.no_grad():
        after = float(reverse_kl(tflow, target, z=z))
    assert np.isfinite(final) and after < before - 0.5, (before, after)
