"""The port continues the JAX package's training runs and evaluates its
trained models.

The JAX package writes each checkpoint here, on the CPU, with its own
`save_checkpoint` or training loop. Checked, in float64 unless stated:

  * the reader (read_jax_checkpoint) against flax's own
    `serialization.msgpack_restore`, leaf for leaf and bit for bit, on the
    committed fixture tests/data/jax_gaussian_rnvp.msgpack.last (written by
    tools/jax_resume_fixture.py) and on fresh files with bfloat16 leaves,
    None leaves and arrays split into chunks;
  * optax's Adam state mapped onto the port's Adam
    (loop.adam_state_from_optax): after three optax updates, one more
    update on the same gradients gives optax's params at rtol 1e-12, under
    the exponential, cosine and constant schedules (the port given optax's
    own schedule values, which optax computes on an int32 count); with a
    bfloat16 first moment on either side, cast to the other side's dtype
    as JAX's load_checkpoint casts it, at test_torch_adam_mu.py's float32
    tolerance, rtol 1e-6;
  * train_flow_fused resumed from JAX's `.msgpack.last` (epoch 800) on
    JAX's own minibatches equals JAX's own resumed run to epoch 1200 at
    rtol 1e-8 (params; losses; best log-prob), for a RealNVP Chain, a
    RealNVP Repeat and an NSF_AR (the plain RQS twin on the CPU), at
    test_torch_fe_train.py's rate and schedule (1e-4, cosine);
  * the already-complete case, the key-to-seed rule, and the errors;
  * the CLIs: apps.train --resume picks `.pt.last`, else `.msgpack.last`,
    else starts fresh; apps.test, apps.fe testing and apps.polymer testing
    fall back to the JAX package's `{name}.msgpack`, also in the schema the
    reverse-KL fine-tune writes (opt_state and key None).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from test_torch_checkpoint_msgpack import flows, perturbed
from test_torch_config_apps import TINY_LJ
from test_torch_gff import TINY_POLYMER

import normalizingflow_tpu.apps.train as j_train_app
import normalizingflow_tpu.config as jconfig
from normalizingflow_tpu.targets.dataset import (
    TrajectoryDataset as JDataset,
)
from normalizingflow_tpu.train.checkpoint import save_checkpoint
from normalizingflow_tpu.train.fused import train_flow_fused as j_train
from normalizingflow_tpu.train.loop import make_optimizer as j_make_optimizer

import normalizingflow_tpu_torch.config as tconfig
from normalizingflow_tpu_torch import params as tparams
from normalizingflow_tpu_torch.apps import fe, polymer, sample_data, test
from normalizingflow_tpu_torch.apps import train as train_app
from normalizingflow_tpu_torch.targets import TrajectoryDataset
from normalizingflow_tpu_torch.train import (
    load_checkpoint,
    make_optimizer,
    read_jax_checkpoint,
    train_flow_fused,
)
from normalizingflow_tpu_torch.train.checkpoint import jax_key_seed
from normalizingflow_tpu_torch.train.loop import adam_state_from_optax

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data",
                       "jax_gaussian_rnvp.msgpack.last")
DIM, BATCH, FRAMES = 8, 16, 64


# ---------------------------------------------------------------- reader
def flat(tree, prefix=()):
    """{path: leaf} of a tree of dicts (flax's maps) and tuples (the
    port's), tuple positions as flax's keys "0", "1", ...; an empty
    container is a leaf of its own."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (str(k),)))
    return out or {prefix: "empty"}


def bits(leaf):
    """(dtype name, shape, raw bytes) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        return (str(leaf.dtype).removeprefix("torch."), tuple(leaf.shape),
                leaf.contiguous().view(torch.int16 if leaf.element_size() == 2
                                       else torch.uint8).numpy().tobytes())
    a = np.asarray(leaf)
    return a.dtype.name, a.shape, a.tobytes()


def assert_same_as_flax(path):
    with open(path, "rb") as fh:
        want = flat(serialization.msgpack_restore(fh.read()))
    got = flat(read_jax_checkpoint(path))
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None or isinstance(w, str):
            assert got[k] == w, k
        else:
            assert bits(got[k]) == bits(w), k
    return got


def test_the_committed_fixture_decodes_as_flax_does():
    got = assert_same_as_flax(FIXTURE)
    assert int(got[("epoch",)]) == 2000
    assert got[("losses",)].shape == (4,)  # four chunks of 500
    assert got[("opt_state", "0", "mu", "0", "t1", "w1")].dtype == np.float32
    assert int(got[("opt_state", "1", "count")]) == 2000


def fresh_state(mu_dtype):
    jflow, _ = flows("RealNVP", 4)  # a Repeat: stacked leaves
    params = perturbed(jflow.init(jax.random.PRNGKey(0)), 1)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    opt = optax.adam(optax.exponential_decay(1e-3, 1, 0.99),
                     mu_dtype=mu_dtype)
    state = opt.init(params)
    _, state = opt.update(jax.tree.map(jnp.cos, params), state, params)
    return {"params": params, "opt_state": state,
            "key": jax.random.PRNGKey(5), "epoch": np.asarray(400),
            "losses": np.asarray([2.5, 1.25], np.float32)}


@pytest.mark.parametrize("case", ["bf16", "finetuned", "chunked",
                                  "chunked_bf16"])
def test_fresh_checkpoints_decode_as_flax_does(tmp_path, monkeypatch, case):
    state = fresh_state(jnp.bfloat16 if "bf16" in case else None)
    if case == "finetuned":  # what apps.train writes after rkl_finetune
        state.update(opt_state=None, key=None)
    if case.startswith("chunked"):  # every leaf over 64 bytes is split
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    path = str(tmp_path / f"{case}.msgpack")
    save_checkpoint(path, state)
    if case.startswith("chunked"):
        with open(path, "rb") as fh:
            assert b"__msgpack_chunked_array__" in fh.read()
    got = assert_same_as_flax(path)
    mu = got[("opt_state", "0", "mu", "t1", "w1")] if state["opt_state"] \
        else None
    if "bf16" in case:
        assert mu.dtype == torch.bfloat16
    if case == "finetuned":
        assert got[("opt_state",)] is None and got[("key",)] is None


# --------------------------------------------------- optax state -> Adam
SCHEDULES = {"exponential": lambda: optax.exponential_decay(1e-2, 1, 0.9),
             "cosine": lambda: optax.cosine_decay_schedule(1e-2, 10),
             "constant": lambda: (lambda k: 1e-2)}
BF16 = jnp.bfloat16
# (JAX's mu dtype, the port's, the params' dtype, rtol)
MU_CASES = {"f32": (None, None, np.float64, 1e-12),
            "bf16": (BF16, BF16, np.float32, 1e-6),
            "f32_to_bf16": (None, BF16, np.float32, 1e-6),
            "bf16_to_f32": (BF16, None, np.float32, 1e-6)}


def grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(np.shape(a)), a.dtype), params)


@pytest.mark.parametrize("mu_case", list(MU_CASES))
@pytest.mark.parametrize("scheduler", list(SCHEDULES))
def test_one_more_update_continues_optax(tmp_path, scheduler, mu_case):
    j_mu, t_mu, dtype, rtol = MU_CASES[mu_case]
    jflow, tflow = flows("RealNVP", 2)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), perturbed(
        jflow.init(jax.random.PRNGKey(1)), 2))
    jopt = j_make_optimizer(1e-2, scheduler, 0.9, max_epochs=10,
                            mu_dtype=j_mu)
    state = jopt.init(params)
    for k in range(3):
        upd, state = jopt.update(grads(params, k), state, params)
        params = optax.apply_updates(params, upd)
    path = str(tmp_path / "run.msgpack.last")
    save_checkpoint(path, {"params": params, "opt_state": state,
                           "key": jax.random.PRNGKey(0),
                           "epoch": np.asarray(3),
                           "losses": np.zeros(1, np.float32)})
    # the reference: JAX's load_checkpoint casts mu to the new policy's
    # dtype, then optax takes the update
    adam = state[0]
    ref_state = (adam._replace(mu=jax.tree.map(
        lambda m, p: m.astype(t_mu or p.dtype), adam.mu, params)), state[1])
    g = grads(params, 3)
    upd, _ = j_make_optimizer(1e-2, scheduler, 0.9, max_epochs=10,
                              mu_dtype=t_mu).update(g, ref_state, params)
    want = optax.apply_updates(params, upd)

    tflow = tflow.to(torch.float64 if dtype == np.float64 else torch.float32)
    decoded = read_jax_checkpoint(path)
    tparams.from_jax(tflow, decoded["params"])
    topt = make_optimizer(list(tflow.parameters()), 1e-2, scheduler, 0.9,
                          max_epochs=10,
                          mu_dtype=None if t_mu is None else torch.bfloat16)
    schedule = SCHEDULES[scheduler]()
    topt.schedule = lambda k: float(schedule(jnp.asarray(k, jnp.int32)))
    topt.load_state_tree(adam_state_from_optax(tflow, decoded["opt_state"]))
    assert topt.count == 3
    for p, gl in zip(tflow.parameters(),
                     tparams.jax_leaves(tflow, jax.tree.map(np.asarray, g))):
        p.grad = torch.from_numpy(np.array(gl)).to(p.dtype)
        assert topt.state[p]["mu"].dtype == (
            p.dtype if t_mu is None else torch.bfloat16)
    topt.step()
    got = jax.tree.leaves(tparams.to_numpy(tflow))
    for a, b in zip(got, jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=rtol)


def adam_tree(count=3, sched_count=3, nlayers=2):
    jflow, _ = flows("RealNVP", nlayers)
    params = jflow.init(jax.random.PRNGKey(0))
    zeros = jax.tree.map(np.zeros_like, params)
    return ({"count": np.int32(count), "mu": zeros, "nu": zeros},
            {"count": np.int32(sched_count)})


@pytest.mark.parametrize("opt_state,match", [
    (adam_tree(sched_count=4), "count 3 != its schedule's 4"),
    (adam_tree(nlayers=3), "sequence of 2"),
    (None, "not an optax.adam state"),
    ((adam_tree()[0],), "not an optax.adam state"),
    ((adam_tree()[0], {"count": 3, "extra": 1}), "not an optax.adam state"),
])
def test_a_state_that_does_not_fit_raises(opt_state, match):
    _, tflow = flows("RealNVP", 2)
    with pytest.raises(ValueError, match=match):
        adam_state_from_optax(tflow, opt_state)


def test_a_constant_rate_keeps_an_empty_schedule_state():
    adam, _ = adam_tree(count=7)
    _, tflow = flows("RealNVP", 2)
    tree = adam_state_from_optax(tflow, (adam, {}))
    assert tree["count"] == 7
    assert len(tree["mu"]) == len(list(tflow.parameters()))


# ------------------------------------------------------- resume parity
def data(seed=3):
    rng = np.random.default_rng(seed)
    return 0.8 * rng.standard_normal((FRAMES, DIM)) + 0.3


TRAIN = dict(batch_size=BATCH, learning_rate=1e-4, scheduler="cosine",
             chunk=400)


def jax_run(tmp_path, kind, nlayers):
    """JAX trains to epoch 800 (writing `.msgpack.last`), then resumes to
    1200. Returns the flows, the `.last` path and the resumed run."""
    jflow, tflow = flows(kind, nlayers)
    p = perturbed(jflow.init(jax.random.PRNGKey(0)), 4)
    x = data()
    ckpt = str(tmp_path / "jax.msgpack")
    j_train(jflow, jax.random.PRNGKey(2), JDataset(data=x), init_params=p,
            max_epochs=800, checkpoint_path=ckpt, **TRAIN)
    jp, jhist = j_train(jflow, jax.random.PRNGKey(2), JDataset(data=x),
                        init_params=p, max_epochs=1200,
                        resume_from=ckpt + ".last", **TRAIN)
    return tflow, x, ckpt + ".last", jp, jhist


def jax_batches(path, start, stop):
    """The rows JAX's resumed run gathers: fold_in(saved key, step)."""
    key = jnp.asarray(read_jax_checkpoint(path)["key"])
    return [np.array(jax.random.randint(jax.random.fold_in(key, i),
                                        (BATCH,), 0, FRAMES))
            for i in range(start, stop)]


@pytest.mark.parametrize("kind,nlayers,repeat", [
    ("RealNVP", 2, False), ("RealNVP", 4, True), ("NSF_AR", 2, False)])
def test_resume_from_jax_matches_jax_resume(tmp_path, kind, nlayers, repeat):
    tflow, x, last, jp, jhist = jax_run(tmp_path, kind, nlayers)
    assert isinstance(tflow.bijector, tparams.Repeat) is repeat
    hist = train_flow_fused(
        tflow, torch.Generator(), TrajectoryDataset(data=x, **F64),
        max_epochs=1200, resume_from=last,
        batches=jax_batches(last, 800, 1200), device="cpu", **TRAIN)
    assert hist["start_epoch"] == 800
    for a, b in zip(jax.tree.leaves(tparams.to_numpy(tflow)),
                    jax.tree.leaves(jp), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-9)
    assert len(hist["losses"]) == len(jhist["losses"]) == 3
    np.testing.assert_allclose(hist["losses"], jhist["losses"], rtol=1e-8)
    np.testing.assert_allclose(hist["best_logprob"], jhist["best_logprob"],
                               rtol=1e-8)

    # already complete: the checkpoint's params, nothing trained
    again = flows(kind, nlayers)[1]
    done = train_flow_fused(
        again, torch.Generator(), TrajectoryDataset(data=x, **F64),
        max_epochs=800, resume_from=last, device="cpu", **TRAIN)
    assert done["already_complete"] and done["start_epoch"] == 800
    state = read_jax_checkpoint(last)
    np.testing.assert_array_equal(done["losses"], state["losses"])
    assert done["best_logprob"] == max(-state["losses"])
    for a, b in zip(jax.tree.leaves(tparams.to_numpy(again)),
                    jax.tree.leaves(state["params"]), strict=True):
        np.testing.assert_array_equal(a, b)


def test_the_key_seeds_the_generator_deterministically(tmp_path):
    """Two resumes from one JAX file, on the port's own batches, are
    identical, and the generator's seed is jax_key_seed of the key."""
    assert jax_key_seed(np.array([1, 2], np.uint32)) == (1 << 32) | 2
    assert jax_key_seed(np.array([2**32 - 1] * 2, np.uint32)) == 2**64 - 1
    with pytest.raises(ValueError, match="no PRNG key"):
        jax_key_seed(None)
    jflow, _ = flows("RealNVP", 2)
    ckpt = str(tmp_path / "jax.msgpack")
    j_train(jflow, jax.random.PRNGKey(7), JDataset(data=data()),
            max_epochs=400, checkpoint_path=ckpt, **TRAIN)
    runs = []
    for _ in range(2):
        tflow = flows("RealNVP", 2)[1]
        gen = torch.Generator()
        hist = train_flow_fused(
            tflow, gen, TrajectoryDataset(data=data(), **F64),
            max_epochs=800, resume_from=ckpt + ".last", device="cpu",
            **TRAIN)
        runs.append((tparams.to_numpy(tflow), hist["losses"]))
    key = read_jax_checkpoint(ckpt + ".last")["key"]
    assert gen.initial_seed() == jax_key_seed(key)
    for a, b in zip(jax.tree.leaves(runs[0][0]), jax.tree.leaves(runs[1][0]),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


# ----------------------------------------------------------------- CLIs
TINY_GAUSS = """device: cpu
dataset:
  name: Gtiny
  potential: GaussianMixture
  centers: [[0.5, 0.5]]
  vars: [[0.36]]
  nparticles: 4
  boxlength: 0
  dim: 2
flow:
  type: RealNVP
  nlayers: 2
  hidden_dim: 8
prior:
  type: GaussianMixture
  centers: [[-0.5, -0.5]]
  nparticles: 4
  vars: [[0.25]]
  dim: 2
train_parameters:
  max_epochs: {epochs}
  batch_size: 16
  output_freq: 100
  learning_rate: 5e-3
  lr_scheduler_gamma: 0.999
  rkl_finetune_steps: {finetune}
output:
  training_dir: {d}/training/
  testing_dir: {d}/testing/
  model_dir: {d}/models/
"""


def gauss_config(tmp_path, epochs, finetune=0):
    path = tmp_path / f"g{epochs}.yaml"
    path.write_text(TINY_GAUSS.format(d=tmp_path, epochs=epochs,
                                      finetune=finetune))
    return str(path)


def test_apps_train_resume_picks_its_checkpoint(tmp_path, capsys):
    """--resume in a model_dir the JAX package trained in continues JAX's
    run (the fine-tune after it); with the port's `.pt.last` beside it,
    the port's; with neither, a fresh run."""
    models = tmp_path / "models"
    assert j_train_app.main([gauss_config(tmp_path, 400)]) == 0
    assert sorted(os.listdir(models)) == ["Gtiny.msgpack",
                                          "Gtiny.msgpack.last"]
    jax_last = models / "Gtiny.msgpack.last"
    jlosses = read_jax_checkpoint(str(jax_last))["losses"]
    capsys.readouterr()

    assert train_app.main([gauss_config(tmp_path, 800, finetune=5),
                           "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {jax_last} at epoch 400" in out
    assert out.index("resumed from") < out.index("rkl fine-tune: 5 steps")
    state = load_checkpoint(str(models / "Gtiny.pt.last"))
    assert int(state["epoch"]) == 800
    np.testing.assert_array_equal(state["losses"][:1], jlosses)
    assert len(state["losses"]) == 2
    assert load_checkpoint(str(models / "Gtiny.pt"))["opt_state"] is None

    assert train_app.main([gauss_config(tmp_path, 1200), "--resume"]) == 0
    out = capsys.readouterr().out
    assert f"resumed from {models / 'Gtiny.pt.last'} at epoch 800" in out
    assert len(load_checkpoint(str(models / "Gtiny.pt.last"))["losses"]) == 3

    fresh = tmp_path / "fresh"
    fresh.mkdir()
    assert train_app.main([gauss_config(fresh, 400), "--resume"]) == 0
    captured = capsys.readouterr()
    assert "starting fresh" in captured.err
    assert "resumed from" not in captured.out
    assert (fresh / "models" / "Gtiny.pt.last").exists()


def jax_model(cfg_path, out, schema, seed):
    """The JAX package's `{name}.msgpack` of the config's flow with
    perturbed float32 params: a training state, or the schema the
    reverse-KL fine-tune writes (opt_state and key None)."""
    jflow, _, _ = jconfig.setup_model(jconfig.load_config(cfg_path),
                                      mode="testing")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), perturbed(
        jflow.init(jax.random.PRNGKey(0)), seed))
    opt_state = optax.adam(1e-3).init(params)
    state = {"params": params, "opt_state": opt_state,
             "key": jax.random.PRNGKey(1), "epoch": np.asarray(400),
             "losses": np.asarray([1.5], np.float32)}
    if schema == "finetuned":
        state.update(opt_state=None, key=None)
    save_checkpoint(out, state)
    return jflow, params


def tiny_lj(tmp_path):
    from normalizingflow_tpu_torch.io import write_xyz

    box = 2 * (4 / (8 * 1.28)) ** (1 / 3)
    lattice = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
               * box - box / 4)
    write_xyz(str(tmp_path / "lattice.xyz"), lattice[None], 4)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_LJ.format(d=tmp_path))
    assert sample_data.main([str(cfg_path), "64"]) == 0
    return str(cfg_path)


@pytest.mark.parametrize("schema", ["training", "finetuned"])
def test_eval_apps_fall_back_to_the_jax_model(tmp_path, capsys, schema):
    """apps.test and apps.fe testing on a model_dir that holds only the
    JAX package's LJtiny.msgpack: the loaded flow gives JAX's density
    (float32), and the estimates are finite."""
    cfg_path = tiny_lj(tmp_path)
    jflow, params = jax_model(cfg_path, str(tmp_path / "models" /
                                            "LJtiny.msgpack"), schema, 6)
    flow, _, _ = test.load_trained(tconfig.load_config(cfg_path))
    assert "evaluating the JAX package's" in capsys.readouterr().err
    x = np.load(tmp_path / "data" / "test.npy")
    with torch.no_grad():
        got = flow.log_prob(torch.as_tensor(x, dtype=torch.float32))
    want = np.asarray(jflow.log_prob(params, jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    if schema == "training":
        assert test.main([cfg_path]) == 0
        out = np.load(tmp_path / "testing" / "fe_LJtiny.npz")
    else:
        assert fe.main([cfg_path, "testing"]) == 0
        out = np.load(tmp_path / "testing" / "fe_LJtiny_testing.npz")
        assert np.isfinite(out["logp_generated"])
    for k in ("bar", "md", "nf", "emus"):
        assert np.isfinite(out[k]), k
    assert not (tmp_path / "models" / "LJtiny.pt").exists()


def test_polymer_testing_falls_back_to_the_jax_model(tmp_path, capsys):
    cfg = tmp_path / "poly.yaml"
    cfg.write_text(TINY_POLYMER.format(d=tmp_path))
    assert polymer.main([str(cfg), "data", "150"]) == 0
    jflow, params = jax_model(str(cfg), str(tmp_path / "models" /
                                            "PolyTiny.msgpack"),
                              "finetuned", 7)
    assert polymer.main([str(cfg), "testing"]) == 0
    assert "evaluating the JAX package's" in capsys.readouterr().err
    rec = np.load(tmp_path / "testing" / "polymer_PolyTiny_testing.npz")
    for k in ("logp_generated", "logp_data", "gap"):
        assert np.isfinite(rec[k]), k
    flow, _, _ = test.load_trained(tconfig.load_config(str(cfg)))
    x = np.load(tmp_path / "data" / "field_test.npy")
    with torch.no_grad():
        got = flow.log_prob(torch.as_tensor(x, dtype=torch.float32))
    want = np.asarray(jflow.log_prob(params, jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    assert not (tmp_path / "models" / "PolyTiny.pt").exists()


def test_the_fixture_resumes_through_the_cli(tmp_path, capsys):
    """configs/Gaussian_rnvp.yaml at its width on the CPU, the fixture in
    its model_dir: apps.train --resume starts at epoch 2000 within 1 nat
    of the fixture's last loss (cut to 2500 epochs here), then apps.test
    evaluates the port's resumed `.pt`."""
    import yaml

    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "Gaussian_rnvp.yaml")))
    raw["device"] = "cpu"
    raw["train_parameters"]["max_epochs"] = 2500
    raw["output"] = {k: f"{tmp_path / k}/" for k in (
        "training_dir", "testing_dir", "model_dir")}
    cfg = tmp_path / "g.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    models = tmp_path / "model_dir"
    os.makedirs(models)
    shutil.copyfile(FIXTURE, models / "Gaussian_rnvp_2l.msgpack.last")
    assert train_app.main([str(cfg), "--resume"]) == 0
    assert "Gaussian_rnvp_2l.msgpack.last at epoch 2000" in \
        capsys.readouterr().out
    fixture = read_jax_checkpoint(FIXTURE)["losses"]
    losses = load_checkpoint(str(models / "Gaussian_rnvp_2l.pt.last"))[
        "losses"]
    np.testing.assert_array_equal(losses[:4], fixture)
    assert len(losses) == 5 and abs(losses[4] - fixture[-1]) < 1.0
    assert test.main([str(cfg)]) == 0
    out = np.load(tmp_path / "testing_dir" / "fe_Gaussian_rnvp_2l.npz")
    assert abs(float(out["bar"])) <= 0.05
    assert abs(float(out["emus"]) - float(out["bar"])) <= 0.01
