"""Parity of the port's forward-KL training path (train/loop.py's
make_optimizer, train/fused.py, train/checkpoint.py, rkl_finetune) with
the JAX package and optax, in float64.

The schedules are held to optax's on float64 step counts (called on an
int32 count, optax computes in float32: its power drifts to 1.3e-5
relative by step 1000 of exponential decay), Adam's update arithmetic on
optax's own schedule at 1e-10 over 10 steps, and whole training runs on
JAX's own minibatches at rtol 1e-8 in the parameters (absolute 1e-9 for
parameters near zero) and the per-chunk losses. Training amplifies
rounding where the rate is large (two runs at lr 3e-3 part from 1e-14 at
step 50 to 1e-2 at step 300), so the runs use the LJ config's rate, 1e-4.
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
from normalizingflow_tpu.targets.dataset import (
    TrajectoryDataset as JDataset,
)
from normalizingflow_tpu.train.fused import train_flow_fused as j_train
from normalizingflow_tpu.train.loop import make_optimizer as j_make_optimizer
from normalizingflow_tpu.train.objectives import rkl_finetune as j_rkl

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.targets import TrajectoryDataset
from normalizingflow_tpu_torch.train import (
    Adam,
    load_checkpoint,
    make_optimizer,
    rkl_finetune,
    save_checkpoint,
    train_flow_fused,
)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
DIM, BINS, HIDDEN, BATCH, FRAMES = 6, 4, 8, 16, 64


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def leaves_close(port_tree, jax_tree, rtol, atol):
    a, b = jax.tree.leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------- optimizer
SCHEDULES = [("exponential", 0.999), ("cosine", None), ("constant", None)]


@pytest.mark.parametrize("scheduler,gamma", SCHEDULES)
def test_make_optimizer_schedules_match_optax(scheduler, gamma):
    opt = make_optimizer([torch.nn.Parameter(torch.zeros(2, **F64))], 2e-3,
                         scheduler, gamma or 0.999, max_epochs=300)
    ref = {"exponential": optax.exponential_decay(2e-3, 1, 0.999),
           "cosine": optax.cosine_decay_schedule(2e-3, 300),
           "constant": lambda k: 2e-3}[scheduler]
    for k in (0, 1, 7, 150, 299, 300, 301, 1000):
        np.testing.assert_allclose(
            opt.schedule(k), float(ref(jnp.asarray(k, jnp.float64))),
            rtol=1e-12, atol=1e-18, err_msg=f"{scheduler} step {k}")
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_optimizer([torch.nn.Parameter(torch.zeros(1))], 1e-3, "linear")


@pytest.mark.parametrize("scheduler", ["exponential", "cosine", "constant"])
def test_ten_adam_steps_match_optax(scheduler):
    """JAX's make_optimizer (optax.adam) against the port's Adam on the
    same grads, the port given optax's own schedule."""
    rng = np.random.default_rng(0)
    shapes = [(4, 5), (5,), (3,)]
    p0 = [rng.standard_normal(s) for s in shapes]
    jopt = j_make_optimizer(1e-2, scheduler, 0.99, max_epochs=10)
    jp = [jnp.asarray(a) for a in p0]
    state = jopt.init(jp)
    ref = {"exponential": optax.exponential_decay(1e-2, 1, 0.99),
           "cosine": optax.cosine_decay_schedule(1e-2, 10),
           "constant": lambda k: 1e-2}[scheduler]
    tp = [torch.nn.Parameter(t(a)) for a in p0]
    topt = Adam(tp, lambda k: float(ref(jnp.asarray(k, jnp.int32))))
    for k in range(10):
        grads = [rng.standard_normal(s) * 10.0 ** (k % 3 - 1)
                 for s in shapes]
        upd, state = jopt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        for prm, g in zip(tp, grads):
            prm.grad = t(g)
        topt.step()
    leaves_close([p.detach().numpy() for p in tp], jp, 1e-10, 1e-13)


def test_adam_state_tree_round_trip():
    prm = [torch.nn.Parameter(torch.ones(3, **F64))]
    opt = make_optimizer(prm, 1e-2, "constant")
    prm[0].grad = torch.ones(3, **F64)
    opt.step()
    tree = opt.state_tree()
    other = make_optimizer([torch.nn.Parameter(torch.ones(3, **F64))], 1e-2,
                           "constant")
    other.load_state_tree(tree)
    assert other.count == 1
    np.testing.assert_array_equal(other.state_tree()["mu"][0], tree["mu"][0])
    with pytest.raises(ValueError, match="does not match"):
        other.load_state_tree({"count": 1, "mu": [], "nu": []})


# ------------------------------------------------------ train_flow_fused
def flows(kind, seed=0):
    """(JAX flow, port flow, shared perturbed params): 2 x SplineAR in a
    Chain, or a Repeat of 4 SplineAR, on a DiagNormal prior."""
    kw = dict(num_bins=BINS, tail_bound=3.0, hidden_dim=HIDDEN)
    if kind == "chain":
        jbij = jb.Chain([jb.SplineAR(DIM, **kw) for _ in range(2)])
        tbij = tb.Chain([tb.SplineAR(DIM, **kw, **F64) for _ in range(2)])
    else:
        jbij = jb.Repeat(jb.SplineAR(DIM, **kw), 4)
        tbij = tb.Repeat([tb.SplineAR(DIM, **kw, **F64) for _ in range(4)])
    jflow = JFlow(jd.DiagNormal(DIM), jbij)
    tflow = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tbij)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) + 0.05 * rng.standard_normal(np.shape(a))),
        jflow.init(jax.random.PRNGKey(seed)))
    tparams.from_jax(tflow, p)
    return jflow, tflow, p


def data(seed=1):
    rng = np.random.default_rng(seed)
    return 0.8 * rng.standard_normal((FRAMES, DIM)) + 0.3


def jax_batch_indices(key, steps):
    """The minibatch rows JAX's train_flow_fused gathers at each step."""
    _, key = jax.random.split(key)
    return [np.array(jax.random.randint(jax.random.fold_in(key, i),
                                        (BATCH,), 0, FRAMES))
            for i in range(steps)]


@pytest.mark.parametrize("kind", ["chain", "repeat"])
def test_train_flow_fused_matches_jax(kind):
    jflow, tflow, p = flows(kind)
    x = data()
    key = jax.random.PRNGKey(2)
    kw = dict(max_epochs=800, batch_size=BATCH, learning_rate=1e-4,
              scheduler="cosine", chunk=400)
    jp, jhist = j_train(jflow, key, JDataset(data=x), init_params=p, **kw)
    hist = train_flow_fused(
        tflow, torch.Generator(), TrajectoryDataset(data=x, **F64),
        batches=jax_batch_indices(key, 800), device="cpu", **kw)
    leaves_close(tparams.to_numpy(tflow), jp, 1e-8, 1e-9)
    assert len(hist["losses"]) == len(jhist["losses"]) == 2
    np.testing.assert_allclose(hist["losses"], jhist["losses"], rtol=1e-8)
    np.testing.assert_allclose(hist["best_logprob"], jhist["best_logprob"],
                               rtol=1e-8)
    assert hist["losses"][1] < hist["losses"][0]  # it learned


def small_flow(seed=0):
    return flows("chain", seed)[1]


def run(tmp_path, name, max_epochs, resume=False, seed=0, **kw):
    flow = small_flow()
    gen = torch.Generator().manual_seed(seed)
    ckpt = str(tmp_path / f"{name}.pt")
    hist = train_flow_fused(
        flow, gen, TrajectoryDataset(data=data(), **F64),
        max_epochs=max_epochs, batch_size=BATCH, learning_rate=2e-3,
        scheduler="exponential", chunk=400, checkpoint_path=ckpt,
        resume_from=ckpt + ".last" if resume else None, device="cpu", **kw)
    return flow, hist, ckpt


def test_resume_is_bit_exact(tmp_path):
    full, hist_full, _ = run(tmp_path, "a", 800)
    run(tmp_path, "b", 400)
    resumed, hist, _ = run(tmp_path, "b", 800, resume=True)
    for a, b in zip(full.parameters(), resumed.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(hist["losses"], hist_full["losses"])
    assert hist["best_logprob"] == hist_full["best_logprob"]


def test_resume_when_already_complete(tmp_path):
    done, _, _ = run(tmp_path, "c", 400)
    again, hist, _ = run(tmp_path, "c", 400, resume=True)
    assert hist["already_complete"] is True and hist["steps_per_s"] == 0.0
    for a, b in zip(done.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_best_is_a_copy_of_a_fresh_last(tmp_path):
    flow, hist, ckpt = run(tmp_path, "d", 400)  # one chunk: best == last
    with open(ckpt, "rb") as f1, open(ckpt + ".last", "rb") as f2:
        assert f1.read() == f2.read()
    state = load_checkpoint(ckpt, {"params": tparams.to_numpy(flow)})
    assert state["epoch"] == 400
    for a, b in zip(jax.tree.leaves(state["params"]),
                    jax.tree.leaves(tparams.to_numpy(flow))):
        np.testing.assert_array_equal(a, b)
    assert hist["best_logprob"] == -hist["losses"][0]


@pytest.mark.parametrize("acceptance,mixed", [(0.45, True), (0.9, False)])
def test_mixing_gate(tmp_path, acceptance, mixed):
    """Acceptance in (0.3, 0.6) trains each chunk's first step on the
    mixer's data; outside it, the run equals one without a mixer, since the
    mixer owns its randomness."""
    base, _, _ = run(tmp_path, "base", 800)
    calls = []

    def mixer(start):
        calls.append(start)
        return torch.full((32, DIM), 5.0, **F64), acceptance

    flow, hist, _ = run(tmp_path, "mix", 800, hmc_mixer=mixer,
                        mix_every=400)
    assert calls == [0, 400]
    assert [m["mixed"] for m in hist["hmc_mixing"]] == [mixed, mixed]
    same = all(torch.equal(a, b) for a, b in zip(base.parameters(),
                                                 flow.parameters()))
    assert same is not mixed
    if mixed:  # one step a chunk, not every batch: no pull toward 5
        with torch.no_grad():
            xs, _, _ = flow.sample(256, generator=torch.Generator())
        assert abs(float(xs.mean())) < 1.5


def test_checkpoint_round_trip_casts_to_the_template(tmp_path):
    flow = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tb.Repeat(
        [tb.SplineAR(DIM, num_bins=BINS, hidden_dim=HIDDEN, **F64)
         for _ in range(3)]))
    tree = tparams.to_numpy(flow)
    assert np.asarray(jax.tree.leaves(tree)[0]).shape[0] == 3  # stacked
    path = str(tmp_path / "m.pt")
    gen = torch.Generator().manual_seed(4)
    save_checkpoint(path, {"params": tree, "generator": gen.get_state(),
                           "epoch": 7, "losses": np.arange(3.0)})
    as32 = jax.tree.map(lambda a: a.astype(np.float32), tree)
    back = load_checkpoint(path, {"params": as32})
    assert all(a.dtype == torch.float32
               for a in jax.tree.leaves(back["params"]))
    raw = load_checkpoint(path)
    for a, b in zip(jax.tree.leaves(raw["params"]), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    other = nft.NormalizingFlow(td.DiagNormal(DIM, **F64), tb.Repeat(
        [tb.SplineAR(DIM, num_bins=BINS, hidden_dim=HIDDEN, **F64)
         for _ in range(3)]))
    tparams.from_jax(other, raw["params"])
    for a, b in zip(flow.parameters(), other.parameters()):
        assert torch.equal(a, b)
    restored = torch.Generator()
    restored.set_state(raw["generator"])
    assert torch.equal(torch.rand(3, generator=restored),
                       torch.rand(3, generator=gen))
    assert not (tmp_path / "m.pt.tmp").exists()


def test_rkl_finetune_matches_jax():
    """JAX's rkl_finetune (clip 1 + Adam, cosine decay, seed 7) against the
    port on JAX's own prior draws, on the funnel."""
    from normalizingflow_tpu.targets import NealsFunnel as JFunnel

    from normalizingflow_tpu_torch.targets import NealsFunnel

    jflow, tflow, p = flows("chain", seed=3)
    steps, batch = 12, 32
    jp, jloss = j_rkl(jflow, p, JFunnel(DIM), steps, lr=1e-4, batch=batch)
    key = jax.random.PRNGKey(7)
    draws = [t(jflow.prior.sample(jax.random.fold_in(key, i), batch))
             for i in range(steps)]
    loss = rkl_finetune(tflow, NealsFunnel(DIM), steps, lr=1e-4,
                        batch=batch, draws=draws)
    np.testing.assert_allclose(loss, jloss, rtol=1e-8)
    leaves_close(tparams.to_numpy(tflow), jp, 1e-8, 1e-10)
    drawn = rkl_finetune(tflow, NealsFunnel(DIM), 3, lr=1e-4, batch=8)
    assert np.isfinite(drawn)
