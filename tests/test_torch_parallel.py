"""The port's multi-device layer (parallel/) on torch.distributed, against
the port's unsharded runs and the JAX package's sharded ones.

The test process makes the inputs and the JAX references: JAX's
`make_sharded_train_step`, `run_hmc_sharded` and `run_smc_sharded` on
conftest's 8-device CPU mesh, and the raw draws of their runs (the key
splits of test_torch_hmc.py and test_torch_smc.py). It writes them as
numpy to an .npz and runs this file as a script,

    python tests/test_torch_parallel.py --ranks W <inputs.npz> <outputs>

which spawns W gloo ranks on the CPU (a file:// store beside the inputs,
so parallel test workers never share a port). Each rank imports torch and
the port only, feeds its rows of the global draws to the sharded paths,
and writes its rows and the global statistics. One spawn runs every check
of its world size: 5 training steps; HMC on a flat target (160 warmup
transitions: dual averaging and three Welford windows cross the ranks) and
on an ill-conditioned Gaussian (real accepts and rejects); SMC on a
Gaussian shift; a 2 x 2 mesh at W = 4; the divisibility error.

The sharded runs equal the port's unsharded ones at rtol 1e-12, atol
1e-12 on values of order 1 (the reductions sum in another order), the ranks hold identical parameters and
statistics, and the runs equal JAX's at the tolerances of
test_torch_train.py, test_torch_hmc.py and test_torch_smc.py. JAX is
imported inside the fixtures, never by the ranks.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import normalizingflow_tpu_torch as nft
from normalizingflow_tpu_torch import bijectors as tb
from normalizingflow_tpu_torch import distributions as td
from normalizingflow_tpu_torch.mcmc import run_hmc, run_smc
from normalizingflow_tpu_torch.parallel import (
    make_mesh,
    make_mesh_2d,
    make_sharded_train_step,
    pad_to_multiple,
    replicated,
    run_hmc_sharded,
    run_smc_sharded,
    shard_batch,
)
from normalizingflow_tpu_torch.targets import IllConditionedGaussian
from normalizingflow_tpu_torch.train.loop import make_optimizer
from normalizingflow_tpu_torch.train.objectives import forward_kl_loss

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F64 = dict(dtype=torch.float64, device="cpu")
WORLD_SIZES = [2, 4]

TRAIN_DIM, TRAIN_HIDDEN, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 16, 64, 5, \
    1e-3
HMC_DIM, HMC_CHAINS, HMC_STEP, HMC_LEAPFROG = 4, 16, 0.3, 4
# (warmup, samples). The flat target accepts every proposal, so its run
# does not amplify rounding: its 130 draws are padded to 256 transitions.
# On the Gaussian, adaptation feeds the reductions' rounding back into the
# trajectories, so its run is short.
HMC_CASES = {"flat": (160, 130), "gauss": (20, 60)}
SMC_DIM, SMC_N, SMC_MU, SMC_STAGES = 3, 64, 1.5, 8
SMC_KW = dict(n_mutation_steps=3, num_leapfrog=4, step_size=0.5,
              max_stages=SMC_STAGES)


# ------------------------------------------ shared by the test and the ranks
def port_flow():
    return nft.NormalizingFlow(td.DiagNormal(TRAIN_DIM, **F64), tb.Chain(
        [tb.AffineCoupling(TRAIN_DIM, hidden_dim=TRAIN_HIDDEN, **F64)
         for _ in range(2)]))


def hmc_logprob(case, perm):
    if case == "flat":
        return lambda x: 0.0 * torch.sum(x, dim=-1)
    return IllConditionedGaussian(HMC_DIM, perm, condition=100.0,
                                  **F64).log_prob


def smc_proposal(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def smc_target(x):
    return -0.5 * torch.sum((x - SMC_MU) ** 2, dim=-1)


def _t(a):
    return torch.from_numpy(np.array(a))


def hmc_draws(inp, case, rows):
    return list(zip(*(_t(inp[f"hmc_{case}_{k}"][:, rows])
                      for k in ("jitter", "normal", "accept"))))


def smc_draws(inp, rows):
    """run_smc's draws stage after stage: u0, then each mutation's."""
    for s in range(SMC_STAGES):
        yield torch.tensor(float(inp["smc_u0"][s]), **F64)
        for m in range(SMC_KW["n_mutation_steps"]):
            yield tuple(_t(inp[f"smc_{k}"][s, m, rows])
                        for k in ("jitter", "normal", "accept"))


def run_all(inp, mesh=None):
    """Training, HMC and SMC on `inp`'s draws: sharded over `mesh`, or,
    without one, the port's unsharded runs. Returns numpy outputs (this
    rank's rows of samples and particles)."""
    def rows(n):
        return slice(None) if mesh is None else mesh.rows(n)

    out = {}
    flow = port_flow()
    flow.load_state_dict({k[2:]: _t(v) for k, v in inp.items()
                          if k.startswith("w/")})
    opt = make_optimizer(list(flow.parameters()), TRAIN_LR, "constant")
    if mesh is not None:
        step = make_sharded_train_step(flow, opt, mesh)
    else:
        def step(x):
            opt.zero_grad(set_to_none=True)
            loss, aux = forward_kl_loss(flow, x)
            loss.backward()
            opt.step()
            return loss.detach(), {k: v.detach() for k, v in aux.items()}
    losses = [step(_t(x)) for x in inp["train_x"]]
    out["train_loss"] = np.array([float(loss) for loss, _ in losses])
    out["train_logprob"] = np.array([float(a["logprob"]) for _, a in losses])
    out.update({f"p/{k}": v.detach().numpy().copy()
                for k, v in flow.state_dict().items()})

    init = _t(inp["hmc_init"])
    for case, (warmup, samples) in HMC_CASES.items():
        kw = dict(num_warmup=warmup, step_size=HMC_STEP,
                  num_leapfrog=HMC_LEAPFROG,
                  draws=hmc_draws(inp, case, rows(HMC_CHAINS)))
        logp = hmc_logprob(case, inp["hmc_perm"])
        if mesh is None:
            res = run_hmc(None, logp, init, samples, device="cpu", **kw)
        else:
            res = run_hmc_sharded(mesh, None, logp, init, samples, **kw)
        for f in ("samples", "log_probs", "accept_rate", "step_size",
                  "inv_mass_diag"):
            out[f"hmc_{case}_{f}"] = getattr(res, f).numpy()
        out[f"hmc_{case}_final"] = res.final_state.position.numpy()

    x0 = _t(inp["smc_x0"])
    draws = smc_draws(inp, rows(SMC_N))
    if mesh is None:
        res = run_smc(None, x0, smc_proposal, smc_target, draws=draws,
                      device="cpu", **SMC_KW)
    else:
        res = run_smc_sharded(mesh, None, x0, smc_proposal, smc_target,
                              draws=draws, **SMC_KW)
    out.update(smc_particles=res.particles.numpy(),
               smc_log_evidence=res.log_evidence.numpy(),
               smc_n_stages=np.array(res.n_stages),
               smc_final_accept=res.final_accept.numpy())
    return out


def _mesh_checks(mesh):
    """The divisibility error, `replicated`, and at W = 4 a 2 x 2 mesh."""
    out = {}
    try:
        shard_batch(mesh, torch.zeros(mesh.size + 1, 2, **F64))
    except ValueError as e:
        out["divisibility_error"] = np.array(str(e))
    out["replicated"] = replicated(
        mesh, torch.tensor([float(mesh.rank + 7)], **F64)).numpy()
    if mesh.size == 4:
        grid = make_mesh_2d((2, 2), device="cpu")
        one = torch.tensor([float(mesh.rank)], **F64)
        out["grid_sizes"] = np.array([grid["data"].size,
                                      grid["chains"].size])
        out["grid_data_sum"] = grid["data"].sum(one).numpy()
        out["grid_chains_sum"] = grid["chains"].sum(one).numpy()
    return out


def _rank(rank, world, store, inp_path, out_prefix):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(device="cpu")
        with np.load(inp_path) as f:
            inp = {k: f[k] for k in f.files}
        out = run_all(inp, mesh)
        out.update(_mesh_checks(mesh))
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 4 or argv[0] != "--ranks":
        print("usage: test_torch_parallel.py --ranks W <inputs.npz> "
              "<output prefix>", file=sys.stderr)
        return 2
    world, inp_path, out_prefix = int(argv[1]), argv[2], argv[3]
    store = f"{out_prefix}store"
    torch.multiprocessing.spawn(_rank, args=(world, store, inp_path,
                                             out_prefix), nprocs=world)
    return 0


# ----------------------------------------------------------------- the test
def _jax_inputs_and_refs():
    """(inputs, JAX's sharded results) on conftest's 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from test_torch_hmc import jax_run_draws
    from test_torch_smc import smc_draws as jax_smc_draws

    from normalizingflow_tpu import NormalizingFlow as JFlow
    from normalizingflow_tpu import bijectors as jb
    from normalizingflow_tpu import distributions as jd
    from normalizingflow_tpu import parallel as jpar
    from normalizingflow_tpu.targets import IllConditionedGaussian as JIll
    from normalizingflow_tpu.train.loop import make_optimizer as j_opt

    from normalizingflow_tpu_torch import params as tparams

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(0)
    inp, ref = {}, {}

    jflow = JFlow(jd.DiagNormal(TRAIN_DIM), jb.Chain(
        [jb.AffineCoupling(TRAIN_DIM, hidden_dim=TRAIN_HIDDEN)
         for _ in range(2)]))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jflow.init(jax.random.PRNGKey(0)))
    flow = port_flow()
    tparams.from_jax(flow, params)
    inp.update({f"w/{k}": v.detach().numpy().copy()
                for k, v in flow.state_dict().items()})
    inp["train_x"] = rng.standard_normal((TRAIN_STEPS, TRAIN_BATCH,
                                          TRAIN_DIM))
    opt = j_opt(TRAIN_LR, "constant")
    opt_state = opt.init(params)
    step = jpar.make_sharded_train_step(jflow, opt, jpar.make_mesh("data"))
    losses = []
    for x in inp["train_x"]:
        params, opt_state, loss, _ = step(params, opt_state, jnp.asarray(x))
        losses.append(float(loss))
    ref["train_loss"] = np.array(losses)
    tparams.from_jax(flow, jax.tree.map(np.asarray, params))
    ref.update({f"p/{k}": v.detach().numpy().copy()
                for k, v in flow.state_dict().items()})

    mesh = jpar.make_mesh("chains")
    jill = JIll(HMC_DIM, condition=100.0, seed=1)
    inp["hmc_perm"] = np.asarray(jax.random.permutation(
        jax.random.PRNGKey(1), HMC_DIM))
    inp["hmc_init"] = rng.standard_normal((HMC_CHAINS, HMC_DIM))
    for case, (warmup, samples) in HMC_CASES.items():
        key = jax.random.PRNGKey(8)
        logp = (jill.log_prob if case == "gauss"
                else (lambda x: 0.0 * jnp.sum(x, axis=-1)))
        res = jpar.run_hmc_sharded(
            mesh, key, logp, jnp.asarray(inp["hmc_init"]), samples,
            batched_target=True, num_warmup=warmup, step_size=HMC_STEP,
            num_leapfrog=HMC_LEAPFROG)
        for f in ("samples", "log_probs", "accept_rate", "step_size",
                  "inv_mass_diag"):
            ref[f"hmc_{case}_{f}"] = np.asarray(getattr(res, f))
        ref[f"hmc_{case}_final"] = np.asarray(res.final_state.position)
        draws = jax_run_draws(key, HMC_CHAINS, HMC_DIM, warmup, samples, 1)
        for i, k in enumerate(("jitter", "normal", "accept")):
            inp[f"hmc_{case}_{k}"] = np.stack([d[i].numpy() for d in draws])

    inp["smc_x0"] = rng.standard_normal((SMC_N, SMC_DIM))
    key = jax.random.PRNGKey(7)
    res = jpar.run_smc_sharded(
        mesh, key, jnp.asarray(inp["smc_x0"]),
        lambda x: -0.5 * jnp.sum(x * x, axis=-1),
        lambda x: -0.5 * jnp.sum((x - SMC_MU) ** 2, axis=-1), **SMC_KW)
    ref.update(smc_particles=np.asarray(res.particles),
               smc_log_evidence=np.asarray(res.log_evidence),
               smc_n_stages=np.asarray(res.n_stages),
               smc_final_accept=np.asarray(res.final_accept))
    stream = jax_smc_draws(key, SMC_N, SMC_DIM, SMC_KW["n_mutation_steps"])
    m = SMC_KW["n_mutation_steps"]
    stages = [[next(stream) for _ in range(1 + m)]
              for _ in range(SMC_STAGES)]
    inp["smc_u0"] = np.array([float(s[0]) for s in stages])
    for i, k in enumerate(("jitter", "normal", "accept")):
        inp[f"smc_{k}"] = np.stack([np.stack([d[i].numpy() for d in s[1:]])
                                    for s in stages])
    return inp, ref


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs path, inputs, JAX's results, the port's unsharded
    results)."""
    inp, ref = _jax_inputs_and_refs()
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, **inp)
    return path, inp, ref, run_all(inp)


@pytest.fixture(scope="module")
def sharded(setup):
    """W -> (every rank's outputs), one spawn a world size."""
    runs = {}

    def get(world):
        if world not in runs:
            prefix = str(setup[0].parent / f"w{world}_")
            env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            proc = subprocess.run(
                [sys.executable, __file__, "--ranks", str(world),
                 str(setup[0]), prefix], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-4000:]
            ranks = []
            for r in range(world):
                with np.load(f"{prefix}{r}.npz") as f:
                    ranks.append({k: f[k] for k in f.files})
            runs[world] = ranks
        return runs[world]

    return get


ROWS = {"hmc_flat_samples": 1, "hmc_flat_log_probs": 1,
        "hmc_flat_final": 0, "hmc_gauss_samples": 1,
        "hmc_gauss_log_probs": 1, "hmc_gauss_final": 0, "smc_particles": 0}


def joined(ranks, key):
    """The global array of a key: rows joined in rank order, or the one
    value that every rank holds."""
    if key in ROWS:
        return np.concatenate([r[key] for r in ranks], axis=ROWS[key])
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


def close(actual, expected, rtol, atol, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(actual[k]),
                                   np.asarray(expected[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_pad_to_multiple_matches_jax():
    from normalizingflow_tpu.parallel import pad_to_multiple as j_pad

    for n, k in [(0, 4), (1, 4), (8, 4), (9, 4), (8193, 2), (5, 1)]:
        assert pad_to_multiple(n, k) == j_pad(n, k)


def test_one_rank_mesh_has_no_collective(setup):
    """With no process group, make_mesh is one rank: its collectives are
    identities, and a sharded run is the unsharded one."""
    _, inp, _, plain = setup
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    x = torch.randn(6, 3, **F64)
    assert shard_batch(mesh, x) is x or torch.equal(shard_batch(mesh, x), x)
    torch.testing.assert_close(mesh.mean(x), x.mean(0), rtol=1e-15,
                               atol=0)
    assert torch.equal(mesh.all_gather(x), x)
    grid = make_mesh_2d((1, 1), device="cpu")
    assert grid["data"].size == grid["chains"].size == 1
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh_2d((2, 1), device="cpu")
    one = run_all(inp, mesh)
    close(one, plain, 1e-12, 1e-12, plain.keys())


def test_mesh_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_sharded_train_step(setup, sharded, world):
    _, inp, ref, plain = setup
    ranks = sharded(world)
    keys = ["train_loss", "train_logprob"] + [k for k in plain
                                              if k.startswith("p/")]
    got = {k: joined(ranks, k) for k in keys}  # identical on every rank
    close(got, plain, 1e-12, 1e-12, keys)
    assert not all(np.allclose(got[k], inp["w/" + k[2:]], rtol=0,
                               atol=1e-4) for k in keys[2:])  # it learned
    close(got, ref, 1e-9, 1e-12,
          ["train_loss"] + [k for k in keys if k.startswith("p/")])


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_sharded_hmc(setup, sharded, world):
    _, _, ref, plain = setup
    ranks = sharded(world)
    keys = [k for k in plain if k.startswith("hmc_")]
    got = {k: joined(ranks, k) for k in keys}
    lps = [k for k in keys if k.endswith("log_probs")]
    close(got, plain, 1e-12, 1e-12, [k for k in keys if k not in lps])
    # a log-prob is a sum of terms (x_i / sigma_i)^2 up to ~30 that cancel
    # to ~5: it keeps their absolute rounding, 1e-12 of ~30 and more
    close(got, plain, 1e-12, 1e-10, lps)
    close(got, ref, 1e-8, 1e-10, keys)
    # the flat target accepts every proposal; its mass was adapted
    assert float(got["hmc_flat_accept_rate"]) == 1.0
    assert not np.allclose(got["hmc_flat_inv_mass_diag"], 1.0)
    assert 0.3 < float(got["hmc_gauss_accept_rate"]) < 1.0


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_sharded_smc(setup, sharded, world):
    _, _, ref, plain = setup
    ranks = sharded(world)
    keys = [k for k in plain if k.startswith("smc_")]
    got = {k: joined(ranks, k) for k in keys}
    assert int(got["smc_n_stages"]) == int(plain["smc_n_stages"]) \
        == int(ref["smc_n_stages"]) >= 3
    close(got, plain, 1e-12, 1e-12, keys)
    close(got, ref, 1e-9, 1e-12, keys)


@pytest.mark.parametrize("world", WORLD_SIZES)
def test_mesh_collectives_and_errors(sharded, world):
    ranks = sharded(world)
    for r in ranks:
        assert "pad_to_multiple" in str(r["divisibility_error"])
        assert r["replicated"].tolist() == [7.0]  # rank 0's value
    if world == 4:
        # rank = i * 2 + j: the data axis is column j, chains row i
        for rank, r in enumerate(ranks):
            i, j = divmod(rank, 2)
            assert r["grid_sizes"].tolist() == [2, 2]
            assert r["grid_data_sum"].tolist() == [float(j + (2 + j))]
            assert r["grid_chains_sum"].tolist() == [float(2 * i
                                                           + 2 * i + 1)]


if __name__ == "__main__":
    sys.exit(main())
