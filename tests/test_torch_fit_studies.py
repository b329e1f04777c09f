"""The fit-quality studies' twins (tools/torch_fit_sweep.py,
torch_gm_fit_sweep.py, torch_lj_permutation.py) against the JAX package's
tools (tools/fit_sweep.py, gm_fit_sweep.py, lj_permutation.py) on the CPU
in float64: the variant grids, the config overrides on every shipped
config, the held-out gap, the GaussianMixture gap and reverse-Zwanzig nf,
the site relabeling and the permutation diagnostic on JAX's own params and
draws, a --quick sweep end to end, and the report's holds on the JAX
record."""

import dataclasses
import functools
import glob
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import normalizingflow_tpu.config as jconfig  # noqa: E402
from tools import fit_sweep as jfs  # noqa: E402
from tools import gm_fit_sweep as jgm  # noqa: E402
from tools import lj_permutation as jlp  # noqa: E402

import normalizingflow_tpu_torch.config as tconfig  # noqa: E402
from normalizingflow_tpu_torch import params as tparams  # noqa: E402
from normalizingflow_tpu_torch.io import read_xyz, write_xyz  # noqa: E402
from tools import torch_fit_sweep as tfs  # noqa: E402
from tools import torch_gm_fit_sweep as tgm  # noqa: E402
from tools import torch_lj_permutation as tlp  # noqa: E402

torch.set_num_threads(1)

ALL_CONFIGS = sorted(glob.glob(str(REPO / "configs" / "*.yaml")))
RTOL = 1e-10


def as64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def jax_latents(jflow, params, key, n, batchsize):
    """The latents JAX's generate_from_nf pushes: batch i from
    fold_in(key, i)."""
    return torch.from_numpy(np.concatenate([
        np.asarray(jflow.sample(params, jax.random.fold_in(key, i),
                                batchsize)[2])
        for i in range(-(-n // batchsize))]))


def no_round(module, monkeypatch):
    """The tool's `round` as the identity, so its rows keep every digit."""
    monkeypatch.setattr(module, "round", lambda v, ndigits=None: v,
                        raising=False)


# ------------------------------------------------------------ the grids
def test_variant_grids_equal_the_jax_tools():
    assert tfs.VARIANTS == jfs.VARIANTS
    assert tfs.QUICK == jfs.QUICK
    assert tgm.VARIANTS == jgm.VARIANTS


@pytest.mark.parametrize("path", ALL_CONFIGS, ids=lambda p: Path(p).stem)
def test_apply_overrides_equals_the_jax_tools(path):
    """Every fit variant on every shipped config: the same flow and
    training fields, the integer truncation included."""
    for name, (flow_ov, train_ov, _) in tfs.VARIANTS.items():
        got = tfs.apply_overrides(tconfig.load_config(path), flow_ov,
                                  train_ov)
        want = jfs.apply_overrides(jconfig.load_config(path), flow_ov,
                                   train_ov)
        assert tconfig.jax_schema(got) == dataclasses.asdict(want), name


class Configured(Exception):
    pass


@pytest.mark.parametrize("base", ["reference", "shipped"])
@pytest.mark.parametrize("name", list(jgm.VARIANTS))
def test_gm_overrides_equal_the_jax_tools(name, base, monkeypatch):
    """The twin's config of a variant over `base` is the one JAX's run
    builds from the same merged overrides (JAX's run is stopped at its
    setup_model)."""
    monkeypatch.chdir(REPO)
    base = tgm.REFERENCE if base == "reference" else {}

    def stop(cfg, mode):
        raise Configured(cfg)

    monkeypatch.setattr(jgm, "setup_model", stop)
    with pytest.raises(Configured) as e:
        jgm.run(name, {**base, **jgm.VARIANTS[name]})
    got = tgm.configure(tgm.VARIANTS[name], base)
    assert tconfig.jax_schema(got) == dataclasses.asdict(e.value.args[0])


def test_the_reference_base_is_what_the_config_quotes():
    """REFERENCE is the hyperparameters configs/GaussianMixture.yaml's
    header says the sweep started from, and the four JAX gaps are the ones
    it quotes."""
    text = (REPO / "configs" / "GaussianMixture.yaml").read_text()
    assert "(nlayers 1,\n# 2000 epochs, batch 40, exp decay)" in text
    assert tgm.REFERENCE == {"nlayers": 1, "max_epochs": 2000,
                             "batch_size": 40, "scheduler": "exponential"}
    assert tconfig.TrainConfig().scheduler == "exponential"
    assert ("1 layer -1.36, 2 layers -0.52, 4 layers -0.31, 4 layers + "
            "20k\n# epochs + batch 256 -0.18") in text
    assert tfs.JAX_GM_GAPS == {"ref": -1.36, "2layer_6k": -0.52,
                               "4layer_6k": -0.31, "4layer_20k_b256": -0.18}


# ------------------------------------------------------- the held-out gap
def tiny_phi4(tmp_path, n_test=37):
    raw = yaml.safe_load((REPO / "configs" / "Phi4.yaml").read_text())
    raw["dataset"].update(L=3, nparticles=9,
                          testing_data=str(tmp_path / "test.npy"))
    raw["prior"]["nparticles"] = 9
    raw["flow"].update(hidden_dim=8, nsplines=4)
    rng = np.random.default_rng(0)
    np.save(tmp_path / "test.npy", rng.normal(size=(n_test, 9)))
    return (tconfig._merge_dataclass(tconfig.Config(), raw),
            jconfig._merge_dataclass(jconfig.Config(), raw))


def test_heldout_gap_equals_the_jax_tools(tmp_path):
    """JAX's params and held-out frames: equal held-out logp; with JAX's
    latents, equal generated logp and gap."""
    cfg, jcfg = tiny_phi4(tmp_path)
    jflow, _, jcfg = jconfig.setup_model(jcfg, "training")
    params = as64(jflow.init(jax.random.PRNGKey(3)))
    flow, _, cfg = tconfig.setup_model(cfg, device="cpu",
                                       dtype=torch.float64)
    tparams.from_jax(flow, params)
    want = jfs.heldout_gap(jflow, params, jcfg)
    z = jax_latents(jflow, params, jax.random.PRNGKey(jcfg.seed + 2), 2000,
                    500)
    got = tfs.heldout_gap(flow, cfg, z=z)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # drawn on the port's own generator: the same held-out logp
    assert tfs.heldout_gap(flow, cfg)[1] == pytest.approx(want[1],
                                                          rel=RTOL)


# --------------------------------------------- the GaussianMixture metrics
def test_gm_gap_and_nf_equal_the_jax_tools(monkeypatch):
    """JAX's run and the twin's on the same flow params, x1 (by JAX's
    latents), q1, x2 and u1, their training stubbed and their rows
    unrounded: equal gap, nf and log-densities."""
    monkeypatch.chdir(REPO)
    overrides = {"hidden_dim": 8, "nsplines": 4}
    seen = {}

    def jtrain(flow, key, potential, **kw):
        # JAX keeps the mixtures' centers and vars in float32 under x64 (and
        # so takes their log in float32): carry the same values in float64
        for dist in (flow.prior, potential):
            dist.centers = jnp.asarray(dist.centers, jnp.float64)
            dist.vars = jnp.asarray(dist.vars, jnp.float64)
        seen.update(jflow=flow, jpot=potential,
                    params=as64(flow.init(jax.random.PRNGKey(11))))
        return seen["params"], {"best_logprob": -1.0}

    monkeypatch.setattr(jgm, "train_flow_fused", jtrain)
    no_round(jgm, monkeypatch)
    want = jgm.run("tiny", {**tgm.REFERENCE, **overrides})
    jflow, jpot, params = seen["jflow"], seen["jpot"], seen["params"]
    key = jax.random.PRNGKey(0 + 2)
    z = torch.from_numpy(np.array(jflow.sample(params, key, 2000)[2]))
    x2 = torch.from_numpy(np.array(jpot.sample(
        jax.random.fold_in(key, 1), 2000)))

    def ttrain(flow, generator, potential, **kw):
        tparams.from_jax(flow, params)
        for mine, theirs in ((flow.prior, jflow.prior), (potential, jpot)):
            for name in ("centers", "vars"):
                getattr(mine, name).copy_(torch.from_numpy(
                    np.array(getattr(theirs, name), np.float64)))
        return {"best_logprob": -1.0}

    monkeypatch.setattr(tgm, "train_flow_fused", ttrain)
    monkeypatch.setattr(tgm, "setup_model", functools.partial(
        tconfig.setup_model, dtype=torch.float64))
    no_round(tgm, monkeypatch)
    got = tgm.run("tiny", overrides, device="cpu", draws={"z": z, "x2": x2})
    for k in ("logp_gen", "logp_test", "gap", "rev_zwanzig_nf"):
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=1e-12), k
    assert got["launches"] == dict.fromkeys(tfs.launch_counts(), 0)


def test_gm_nf_is_float64_on_float32_draws():
    """nf's logsumexp runs in float64 on float32 log-densities."""
    class Fixed(torch.nn.Module):
        """A flow whose draws x and log-densities q are given."""

        def __init__(self, x, q):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))
            self.x, self.q = x, q

        def sample(self, n, generator=None, z=None):
            return self.x, self.q, None

        def log_prob(self, x):
            return self.q

    class Target:
        def log_prob(self, x):
            return x

    q = torch.full((4,), -1e3, dtype=torch.float32)
    u = q + torch.tensor([1e-4, -1e-4, 2e-4, 0.0])
    cfg = tgm.configure({})
    m = tgm.fit_metrics(Fixed(u, q), Target(), cfg, n=4, draws={"x2": u})
    want = (torch.logsumexp(u.double() - q.double(), 0) - math.log(4)) \
        / cfg.dataset.nparticles
    assert m["nf"] == pytest.approx(float(want), rel=1e-12)
    assert m["gap"] == 0.0


# ------------------------------------------------------ site relabeling
def lattice_frames(seed, n, natoms=32, noise=0.15, swaps=3):
    """Seeded frames around data/lj_fcc_ref.xyz's 32-site lattice, with
    noise and `swaps` atom pairs exchanged in every other frame."""
    centers = read_xyz(str(REPO / "data" / "lj_fcc_ref.xyz")).reshape(
        -1, 3).astype(np.float32)[:natoms]
    rng = np.random.default_rng(seed)
    frames = centers + rng.normal(scale=noise, size=(n,) + centers.shape)
    for i in range(0, n, 2):
        for _ in range(swaps):
            a, b = rng.choice(len(centers), 2, replace=False)
            frames[i, [a, b]] = frames[i, [b, a]]
    return frames.astype(np.float32), centers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relabel_to_sites_equals_the_jax_tools_bit_for_bit(seed):
    frames, centers = lattice_frames(seed, 24)
    box = float(2 * (32 / (8 * 1.28)) ** (1 / 3))
    frames = tlp.min_image(frames, box).astype(np.float32)
    got, want = (m.relabel_to_sites(frames, centers, box)
                 for m in (tlp, jlp))
    assert got[0].dtype == want[0].dtype == np.float32
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[1] >= 12 and got[2] > 0  # the swapped frames are found
    np.testing.assert_array_equal(tlp.min_image(frames, box),
                                  jlp.min_image(frames, box))


# ------------------------------------------ the permutation diagnostic
TINY_LJ = """device: cpu
dataset:
  name: LJtiny
  potential: LJ
  training_data: {d}/data/train.npy
  testing_data: {d}/data/test.npy
  type: npy
  nparticles: 4
  kT: 0.5
  rho: 1.28
  cutoff: 1.6
flow:
  type: NSF_AR
  nlayers: 2
  nsplines: 4
  hidden_dim: 8
prior:
  type: EinsteinCrystal
  centers: {d}/lattice.xyz
  alpha: 100
train_parameters:
  max_epochs: 40
  batch_size: 16
  learning_rate: 1e-3
  scheduler: cosine
output:
  training_dir: {d}/training/
  testing_dir: {d}/testing/
  model_dir: {d}/models/
"""


def tiny_lj(tmp_path, n_test=30):
    """The one-cell fcc LJ solid of test_torch_config_apps.py (4 particles
    at rho 1.28, kT 0.5): its config, and held-out frames around the
    lattice with swapped atoms in every other frame."""
    box = 2 * (4 / (8 * 1.28)) ** (1 / 3)
    lattice = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
               * box - box / 4)
    write_xyz(str(tmp_path / "lattice.xyz"), lattice[None], 4)
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_LJ.format(d=tmp_path))
    rng = np.random.default_rng(1)
    frames = lattice + rng.normal(scale=0.08, size=(n_test, 4, 3))
    frames[::2, [0, 1]] = frames[::2, [1, 0]]
    (tmp_path / "data").mkdir()
    np.save(tmp_path / "data" / "test.npy",
            frames.reshape(n_test, 12).astype(np.float32))
    return path


def test_permutation_diagnostic_equals_the_jax_tools(tmp_path, monkeypatch):
    """JAX's main and the twin's diagnose on JAX's params, lattice and
    latents (JAX's evaluate and energies in float64): equal raw and
    relabeled held-out logp, mean energies, generated logp and counts."""
    path = tiny_lj(tmp_path)
    jflow, jpot, jcfg = jconfig.setup_model(jconfig.load_config(str(path)),
                                            "testing")
    params = as64(jflow.init(jax.random.PRNGKey(5)))
    seen = {"lp": [], "u": []}
    real_evaluate, real_generate = jlp.evaluate, jlp.generate_from_nf

    class Energies:
        def potential(self, x):
            u = jpot.potential(jnp.asarray(x, jnp.float64))
            seen["u"].append(u)
            return u

    def evaluate(flow, p, x, batchsize=500):
        lp = real_evaluate(flow, p, jnp.asarray(x, jnp.float64), batchsize)
        seen["lp"].append(lp)
        return lp

    def generate(flow, p, key, n, batchsize=500):
        out = real_generate(flow, p, key, n, batchsize)
        seen["gen"] = out[1]
        return out

    monkeypatch.setattr(jlp, "load_trained",
                        lambda cfg: (jflow, params, Energies(), jcfg))
    monkeypatch.setattr(jlp, "evaluate", evaluate)
    monkeypatch.setattr(jlp, "generate_from_nf", generate)
    assert jlp.main([str(path)]) == 0

    cfg = tconfig.load_config(str(path))
    flow, potential, cfg = tconfig.setup_model(cfg, "testing", device="cpu",
                                               dtype=torch.float64)
    tparams.from_jax(flow, params)
    flow.prior.centers.copy_(torch.from_numpy(
        np.asarray(jflow.prior.centers, np.float64)))
    test = np.load(tmp_path / "data" / "test.npy")
    z = jax_latents(jflow, params, jax.random.PRNGKey(tlp.GEN_SEED),
                    len(test), 500)
    got = tlp.diagnose(flow, potential, test, z=z)

    def mean(a):
        return float(jnp.mean(a))

    want = dict(logp_raw=mean(seen["lp"][0]), logp_rel=mean(seen["lp"][1]),
                logp_gen=mean(seen["gen"]), u_raw=mean(seen["u"][0]),
                u_rel=mean(seen["u"][1]))
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=RTOL), k
    centers = np.asarray(jflow.prior.centers)
    _, n_perm, moved = jlp.relabel_to_sites(
        test.reshape(-1, 4, 3), centers, float(jflow.prior.boxlength))
    assert (got["n_permuted"], got["mean_moved"]) == (n_perm, moved)
    assert got["n_permuted"] >= len(test) // 2
    assert abs(got["u_raw"] - got["u_rel"]) <= 1e-12
    assert got["recovered_pct"] == pytest.approx(
        (want["logp_rel"] - want["logp_raw"])
        / (want["logp_gen"] - want["logp_raw"]) * 100, rel=1e-8)


def test_permutation_cli_on_the_trained_solid(tmp_path, monkeypatch,
                                              capsys):
    """apps.train, then the tool's main with --cpu: the five lines and
    its row under the output directory."""
    from normalizingflow_tpu_torch.apps import train

    path = tiny_lj(tmp_path)
    np.save(tmp_path / "data" / "train.npy",
            np.load(tmp_path / "data" / "test.npy"))
    assert train.main([str(path)]) == 0
    monkeypatch.setattr(tlp, "OUT", tmp_path / "out")
    assert tlp.main([str(path), "--cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("frames: 30  atoms: 4", "non-identity assignment in",
                 "energy invariance:", "mean flow logp: generated",
                 "gap vs generated:"):
        assert line in out
    row = json.loads((tmp_path / "out" / "lj_permutation.json").read_text())
    assert row["card"] is None and row["launches"]["rqs"] == 0
    assert tfs.parse_permutation(out) == pytest.approx(
        {k: row[k] for k in tfs.parse_permutation(out)}, abs=0.051)


# ----------------------------------------- the TPU-precision training
def test_bf16_conditioners_are_the_ports_with_rounded_operands(monkeypatch):
    """tools/torch_bf16_train.py's conditioner forms equal the port's own
    where the rounding is the identity, and round where it is not."""
    from normalizingflow_tpu_torch.bijectors.autoregressive import (
        _MaskedStackedMLPs,
    )
    from tools import torch_bf16_train as tbt

    gen = torch.Generator().manual_seed(0)
    mlps = _MaskedStackedMLPs(6, 5, 16, True, generator=gen,
                              dtype=torch.float64)
    feats = torch.randn(7, mlps.n_feat, generator=gen, dtype=torch.float64)
    one = feats * mlps.feature_mask(3)
    with torch.no_grad():
        want = (mlps.apply_all(feats), mlps.apply_one(one, 3))
        got = (tbt.apply_all(mlps, feats), tbt.apply_one(mlps, one, 3))
    for g, w in zip(got, want):
        assert 1e-6 < float((g - w).abs().max()) < 0.1  # bfloat16 rounding
    monkeypatch.setattr(tbt, "bf16", lambda t: t)
    with torch.no_grad():
        got = (tbt.apply_all(mlps, feats), tbt.apply_one(mlps, one, 3))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-14, atol=1e-14)


# ------------------------------------------------ a quick sweep, the CLI
def test_quick_sweep_of_the_lj_solid_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """--quick (baseline, rkl at 10 steps) on the 4-particle solid trained
    on the port's own HMC data: rows with JAX's keys, written under the
    output directory, and JAX's table."""
    from normalizingflow_tpu_torch.apps import sample_data

    path = tiny_lj(tmp_path)
    assert sample_data.main([str(path), "64"]) == 0
    monkeypatch.setattr(tfs, "OUT", tmp_path / "out")
    monkeypatch.setitem(tfs.VARIANTS, "rkl", ({}, {}, 10))
    assert tfs.main([str(path), "--quick", "--cpu"]) == 0
    rows = json.loads((tmp_path / "out" / "fit_sweep_LJtiny.json")
                      .read_text())
    jax_keys = list(json.loads(
        (REPO / "runs" / "fit_sweep_Phi4.json").read_text())[0])
    assert [r["variant"] for r in rows] == ["baseline", "rkl"]
    for r in rows:
        assert list(r)[:len(jax_keys)] == jax_keys
        assert set(r) - set(jax_keys) == {"card", "launches", "frames"}
        assert math.isfinite(r["gap_per_ptcl"]) and r["epochs"] == 40
        assert r["frames"] == [51, 13] and r["card"] is None
    assert rows[1]["rkl_steps"] == 10 and math.isfinite(
        rows[1]["rkl_final_loss"])
    assert rows[0]["rkl_final_loss"] is None
    printed = capsys.readouterr().out
    assert [json.loads(line) for line in printed.splitlines()
            if line.startswith('{"variant"')] == [
        {k: r[k] for k in jax_keys} for r in rows]
    assert "| variant | layers | bins | hidden | epochs | rkl |" in printed


def test_cli_arguments_follow_the_jax_tool():
    assert tfs.parse_args(["c.yaml", "--quick"]) == (
        "c.yaml", list(jfs.QUICK), "cuda")
    assert tfs.parse_args(["--variants", "wide,deep", "c.yaml", "--cpu"]) \
        == ("c.yaml", ["wide", "deep"], "cpu")
    assert tfs.parse_args([]) == ("configs/Phi4.yaml", list(jfs.VARIANTS),
                                  "cuda")
    with pytest.raises(SystemExit):
        tfs.parse_args(["c.yaml", "--variants", "nosuch"])
    with pytest.raises(SystemExit):
        tgm.main(["nosuch", "--cpu"])


# --------------------------------------------------------- the report
def test_holds_read_the_jax_record_as_its_conclusions():
    """The JAX record meets every hold it has the numbers for: the holds
    state the conclusions that were drawn from it."""
    rec = tfs.jax_record()
    assert rec["phi4_bigdata"]["baseline"]["gap_per_ptcl"] == 0.052
    assert rec["lj"]["rkl"]["gap_per_ptcl"] == 12.9907
    assert rec["lj_bigdata"]["baseline"]["gap_per_ptcl"] == 14.4615
    assert rec["permutation"] == dict(
        frames=2000, atoms=32, box=2.924, n_permuted=911, mean_moved=12.5,
        u_raw=6.22, u_rel=6.22, logp_gen=147.78, logp_raw=-64.74,
        logp_rel=-66.03, recovered_pct=-0.6)
    verdicts = [(h[0], h[3]) for h in tfs.holds(rec)]
    assert verdicts == [("H1", True), ("H2", True), ("H3", True),
                        ("H4", True), ("H5", None), ("H6", None),
                        ("H7", True), ("H8", True), ("H8", None)]


def test_holds_miss_where_a_conclusion_fails():
    rec = tfs.jax_record()
    rec["phi4"]["short"] = dict(rec["phi4"]["short"], gap_per_ptcl=0.9)
    rec["lj"]["baseline"] = {"gap_per_ptcl": 13.5}
    rec["lj_bigdata"]["baseline"] = {"gap_per_ptcl": 12.0}
    rec["gm"] = {k: {"gap": v, "rev_zwanzig_nf": 0.01}
                 for k, v in tfs.JAX_GM_GAPS.items()}
    rec["gm"]["4layer_6k"]["rev_zwanzig_nf"] = 0.2
    verdicts = dict((h[0] + h[1][:3], h[3]) for h in tfs.holds(rec))
    assert verdicts["H1Phi"] is False and verdicts["H5rev"] is False
    assert verdicts["H64x "] is False and verdicts["H8rev"] is False
    assert verdicts["H8dep"] is True


def test_render_puts_each_card_row_beside_the_jax_record(tmp_path):
    """Rows under the output directory (here JAX's own rows, relabeled as
    the card's) beside the JAX record, each hold with its verdict."""
    rec = tfs.jax_record()
    out = tmp_path / "out"
    out.mkdir()
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    la = {"accept_select": 0, "accept_unfused": 0, "rqs": 7, "rqs_vjp": 5}

    def dump(name, rows):
        (out / name).write_text(json.dumps(
            [dict(r, card=card, launches=la) for r in rows]))

    dump("fit_sweep_Phi4.json", rec["phi4"].values())
    dump("fit_sweep_Phi4_bigdata.json", rec["phi4_bigdata"].values())
    dump("fit_sweep_LJ.json", [rec["lj"]["rkl"], dict(
        rec["lj"]["rkl"], variant="baseline", rkl_steps=0,
        gap_per_ptcl=7.5)])
    dump("gm_fit_sweep.json", [
        {"variant": k, "overrides": tgm.VARIANTS[k], "gap": v["gap"],
         "rev_zwanzig_nf": 0.001, "train_s": 1.0}
        for k, v in rec["gm"].items()])
    (out / "lj_permutation.json").write_text(json.dumps(
        dict(rec["permutation"], card=card, launches=la)))
    report = tmp_path / "FIT.md"
    tfs.render(out=out, path=report)
    text = report.read_text()
    assert f"`{card}`" in text
    assert "| H1 |" in text and text.count("| met |") >= 8
    assert "MISSED" not in text and "| H6 |" in text
    assert "\\|ref\\|" in text
    assert "| baseline | 2 | 16 | 128 | 4000 | 0 | — | +0.697 | +0.697 |" \
        in text
    assert "rqs 7, rqs_vjp 5" in text
    assert "| mean atoms off their own site | 12.5 | 12.5 |" in text
    # a second seed's diagnostic beside the first; the notes survive
    (out / "lj_permutation_seed1.json").write_text(json.dumps(
        dict(rec["permutation"], mean_moved=11.0)))
    report.write_text(text + "\n## Notes\n\nH7: by hand.\n")
    tfs.render(out=out, path=report)
    text = report.read_text()
    assert "| card | card, seed1 | JAX |" in text
    assert "| mean atoms off their own site | 12.5 | 11.0 | 12.5 |" in text
    assert text.endswith("\n## Notes\n\nH7: by hand.\n")
    assert text.count("## Notes") == 1
