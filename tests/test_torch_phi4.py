"""Parity of the port's phi^4 lattice target (targets/phi4.py) and of the
Phi4 config's flow with the JAX package, in float64.

The action, log_prob and its gradient, and the magnetization are held to
JAX at rtol 1e-12; the Phi4 config branch builds the same target; a
two-layer SplineAR(64, K = 16, periodic=False) carried across by
`params.from_jax` gives JAX's densities and samples on the same latents at
1e-10; and a few reverse-KL fine-tune steps on the phi^4 density, on JAX's
own prior draws, end at JAX's parameters and loss at 1e-8.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import normalizingflow_tpu.config as jconfig
from normalizingflow_tpu import NormalizingFlow as JFlow
from normalizingflow_tpu import bijectors as jb
from normalizingflow_tpu import distributions as jd
from normalizingflow_tpu.targets.phi4 import Phi4Lattice as JPhi4
from normalizingflow_tpu.targets.phi4 import phi4_action as j_action
from normalizingflow_tpu.train.objectives import rkl_finetune as j_rkl

import normalizingflow_tpu_torch as nft
import normalizingflow_tpu_torch.config as tconfig
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.targets import Phi4Lattice, phi4_action
from normalizingflow_tpu_torch.train import rkl_finetune

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
F64 = dict(dtype=torch.float64, device="cpu")
L, KAPPA, LAM = 8, 0.3, 0.022  # configs/Phi4.yaml
DIM, BINS, HIDDEN, TAIL = L * L, 16, 8, 6.0


def fields(n, seed=0, scale=1.2):
    return scale * np.random.default_rng(seed).standard_normal((n, DIM))


@pytest.mark.parametrize("kappa,lam", [(KAPPA, LAM), (0.5, 1.3)])
def test_action_log_prob_grad_and_magnetization_match_jax(kappa, lam):
    x = fields(7)
    tx = torch.from_numpy(x).requires_grad_(True)
    target, jtarget = Phi4Lattice(L, kappa, lam), JPhi4(L, kappa, lam)
    np.testing.assert_allclose(
        phi4_action(torch.from_numpy(x.reshape(-1, L, L)), kappa, lam)
        .numpy(),
        np.asarray(jax.vmap(lambda f: j_action(f, kappa, lam))(
            jnp.asarray(x.reshape(-1, L, L)))), rtol=1e-12)
    lp = target.log_prob(tx)
    np.testing.assert_allclose(lp.detach().numpy(),
                               np.asarray(jtarget.log_prob(jnp.asarray(x))),
                               rtol=1e-12)
    (g,) = torch.autograd.grad(lp.sum(), tx)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jtarget.log_prob(v)))(
        jnp.asarray(x)))
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12,
                               atol=1e-12 * np.abs(jg).max())
    np.testing.assert_allclose(
        target.magnetization(torch.from_numpy(x)).numpy(),
        np.asarray(jtarget.magnetization(jnp.asarray(x))), rtol=1e-12)
    # Z2 symmetry phi -> -phi
    np.testing.assert_allclose(target.potential(-tx.detach()).numpy(),
                               target.potential(tx.detach()).numpy(),
                               rtol=1e-12)


def test_phi4_config_branch(tmp_path):
    """configs/Phi4.yaml builds the target with its trajectory attached,
    as JAX's config.py does, on the CPU in float64."""
    path = str(tmp_path / "phi4_train.npy")
    x = fields(12, seed=1)
    np.save(path, x)
    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "Phi4.yaml"))
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, training_data=path))
    jcfg = jconfig.load_config(os.path.join(ROOT, "configs", "Phi4.yaml"))
    jcfg = dataclasses.replace(jcfg, dataset=dataclasses.replace(
        jcfg.dataset, training_data=path))
    flow, target, _ = tconfig.setup_model(cfg, device="cpu",
                                          dtype=torch.float64)
    jflow, jtarget, _ = jconfig.setup_model(jcfg)
    assert isinstance(target, Phi4Lattice)
    assert (target.L, target.kappa, target.lam) == \
        (jtarget.L, jtarget.kappa, jtarget.lam)
    assert len(target.dataset) == 12
    rows = target.sample(5, idx=[0, 3, 3, 11, 7])
    np.testing.assert_array_equal(rows.numpy(), x[[0, 3, 3, 11, 7]])
    np.testing.assert_allclose(target.log_prob(rows).numpy(),
                               np.asarray(jtarget.log_prob(jnp.asarray(
                                   x[[0, 3, 3, 11, 7]]))), rtol=1e-12)
    layers = flow.bijector.bijectors
    assert [(b.num_bins, b.periodic, b.tail_bound) for b in layers] == \
        [(16, False, 6.0)] * 2
    with pytest.raises(ValueError, match="no attached trajectory"):
        Phi4Lattice(L).sample(2)


def spline_flows(seed=0):
    """(JAX flow, port flow, shared perturbed params): 2 x SplineAR(64,
    K = 16, B = 6, periodic=False, hidden 8) on a unit DiagNormal."""
    kw = dict(num_bins=BINS, tail_bound=TAIL, hidden_dim=HIDDEN,
              periodic=False)
    jflow = JFlow(jd.DiagNormal(DIM),
                  jb.Chain([jb.SplineAR(DIM, **kw) for _ in range(2)]))
    tflow = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tb.Chain(
        [tb.SplineAR(DIM, **kw, **F64) for _ in range(2)]))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.1 * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    return jflow, tflow, p


def test_k16_spline_flow_matches_jax():
    jflow, tflow, p = spline_flows()
    jx, jlp, jz = jflow.sample(p, jax.random.PRNGKey(1), 9)
    with torch.no_grad():
        x, lp, _ = tflow.sample(z=torch.from_numpy(np.array(jz)))
        dens = tflow.log_prob(torch.from_numpy(fields(9, seed=2)))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10)
    np.testing.assert_allclose(
        dens.numpy(),
        np.asarray(jflow.log_prob(p, jnp.asarray(fields(9, seed=2)))),
        rtol=1e-10)


def test_rkl_finetune_on_phi4_matches_jax():
    """rkl_finetune (clip 1 + Adam, cosine decay) on the phi^4 density,
    through the K = 16 SplineAR inverse, on JAX's prior draws."""
    jflow, tflow, p = spline_flows(seed=3)
    steps, batch = 4, 8
    jp, jloss = j_rkl(jflow, p, JPhi4(L, KAPPA, LAM), steps, lr=1e-4,
                      batch=batch)
    key = jax.random.PRNGKey(7)
    draws = [torch.from_numpy(np.array(jflow.prior.sample(
        jax.random.fold_in(key, i), batch))) for i in range(steps)]
    loss = rkl_finetune(tflow, Phi4Lattice(L, KAPPA, LAM), steps, lr=1e-4,
                        batch=batch, draws=draws)
    np.testing.assert_allclose(loss, jloss, rtol=1e-8)
    for a, b in zip(jax.tree.leaves(tparams.to_numpy(tflow)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)


def test_phi4_config_end_to_end(tmp_path):
    """tests/test_fields.py test_phi4_config_end_to_end on the port, at
    L = 4 on the CPU: apps.sample_data's HMC data (256 frames, 32 chains,
    acceptance in (0.2, 1]), forward-KL training by train_flow_fused (batch
    64, cosine from 1e-3: the last chunk's loss below the first's), then
    the flow's density of its own samples within 20 nats of the data's
    (pipeline consistency, not convergence, as the JAX test says). The
    JAX test's 1600 epochs are cut to 800 (in chunks of 200): on the CPU a
    step of this flow takes ~28 ms."""
    from normalizingflow_tpu_torch.apps.sample_data import generate
    from normalizingflow_tpu_torch.train.fused import train_flow_fused

    cfg = tconfig.load_config(os.path.join(ROOT, "configs", "Phi4.yaml"))
    ds = dataclasses.replace(cfg.dataset, L=4, nparticles=16)
    pr = dataclasses.replace(cfg.prior, nparticles=16)
    cfg = dataclasses.replace(cfg, dataset=ds, prior=pr)
    frames, acc = generate(cfg, nframes=256, chains=32, seed=0,
                           device="cpu")
    assert tuple(frames.shape) == (256, 16)
    assert 0.2 < acc <= 1.0

    data_path = str(tmp_path / "phi4.npy")
    np.save(data_path, frames.numpy())
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        ds, training_data=data_path))
    gen = torch.Generator().manual_seed(0)
    flow, potential, cfg = tconfig.setup_model(cfg, mode="training",
                                               device="cpu", generator=gen)
    assert potential.dataset is not None
    hist = train_flow_fused(flow, gen, potential, max_epochs=800,
                            batch_size=64, learning_rate=1e-3,
                            scheduler="cosine", output_freq=200, chunk=200,
                            device="cpu")
    losses = hist["losses"]
    assert losses[-1] < losses[0], losses
    with torch.no_grad():
        _, log_px, _ = flow.sample(256, generator=gen)
        lp_data = flow.log_prob(frames)
    gap = abs(float(log_px.mean()) - float(lp_data.mean()))
    assert np.isfinite(gap) and gap < 20.0, gap
