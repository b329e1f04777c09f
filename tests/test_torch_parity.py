"""tools/torch_parity.py, the port's campaign, against tools/parity.py, the
JAX package's: the parsers on every tracked JAX step log, `status_of` on
every JAX row, the config copies' paths, reconciliation, lineage and the
owned keys on fabricated logs, and both runners end to end on the CPU (a
Gaussian config at 20 epochs; a 4-particle LJ solid through every step of
the LJ row)."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import parity as jparity  # noqa: E402
from tools import torch_parity as tparity  # noqa: E402

torch.set_num_threads(1)

JAX_LOGS = sorted((REPO / "runs" / "parity" / "logs").glob("*.log"))
JAX_ROWS = json.loads((REPO / "runs" / "parity" / "results.json").read_text())
CPU = {"device": "cpu"}


@pytest.mark.parametrize("path", JAX_LOGS, ids=lambda p: p.stem)
def test_parsers_equal_the_jax_campaigns(path):
    out = path.read_text()
    for name in ("parse_fe_testing", "parse_fe_diff", "parse_train"):
        assert getattr(tparity, name)(out) == getattr(jparity, name)(out)
    assert tparity.OWNED_KEYS == jparity.OWNED_KEYS


def test_parsers_read_the_ports_prints():
    out = ("logp of generated data vs testing data: -36.5 -36.25\n"
           "BAR dF over 3 datasets: 9.546000 +/- 0.120000\n"
           "bar=0.000318 md=-0.002132 nf=0.002880 emus=0.000318  (kT per "
           "particle)\n"
           "INFO:normalizingflow_tpu_torch.train:HMC mix at epoch 0: "
           "acceptance 0.935 -> dataset (gate failed)\n"
           "INFO:normalizingflow_tpu_torch.train:HMC mix at epoch 200: "
           "acceptance 0.451 -> relaxed data\n"
           "best logprob: -56.783; checkpoint: m/LJ.pt; Adam mu float32\n")
    assert tparity.parse_fe_testing(out) == dict(
        logp_gen=-36.5, logp_test=-36.25, ntrials=3, bar_mean=9.546,
        bar_std=0.12, bar=0.000318, md=-0.002132, nf=0.00288, emus=0.000318)
    assert tparity.parse_train(out) == dict(
        best_logprob=-56.783, hmc_mix_events=2, hmc_mix_gate_passed=1,
        hmc_mix_acceptances=[0.935, 0.451])
    assert tparity.parse_train(out) == jparity.parse_train(out)


def vary(row):
    """The row, then with a failed step, a partial train, and a bar off
    the exact 0."""
    failed = json.loads(json.dumps(row))
    next(iter(failed["steps"].values()))["ok"] = False
    partial = json.loads(json.dumps(row))
    partial["steps"]["train"]["partial"] = True
    off = dict(row, bar=0.2, md=-0.3)
    return [row, failed, partial, off]


@pytest.mark.parametrize("row", JAX_ROWS, ids=lambda r: r["config"])
def test_status_of_equals_the_jax_campaigns(row):
    for r in vary(row):
        assert tparity.status_of(r) == jparity.status_of(r)
    assert tparity.EXACT_ZERO == jparity.EXACT_ZERO
    assert tparity.NPARTICLES == jparity.NPARTICLES
    assert tparity.ALL == jparity.ALL


def paths_of(raw):
    ds = raw["dataset"]
    return [ds[k] for k in ("training_data", "testing_data") if ds.get(k)] \
        + list(raw["output"].values())


@pytest.mark.parametrize("name", tparity.ALL)
def test_config_copies_write_under_the_campaign_root(tmp_path, name):
    root = tmp_path / "campaign"
    path, raw = tparity.campaign_config(name, root, overrides=CPU)
    own = yaml.safe_load((REPO / "configs" / f"{name}.yaml").read_text())
    assert path == root / "configs" / f"{name}.yaml"
    assert yaml.safe_load(path.read_text()) == raw
    assert raw["device"] == "cpu"
    for p in paths_of(raw):
        p = Path(p)
        assert p.is_absolute() and p.is_relative_to(root), p
        assert not p.is_relative_to(REPO / "runs" / "parity")
        for theirs in paths_of(own):
            assert not p.is_relative_to((REPO / theirs).resolve())
    for section in ("dataset", "prior"):
        for key in ("centers", "input_dir"):
            if isinstance(raw[section].get(key), str):
                assert Path(raw[section][key]).is_file()
    # everything else as shipped
    for key in ("flow", "train_parameters"):
        assert raw[key] == own[key]


def test_config_copies_refuse_paths_outside_runs(tmp_path):
    with pytest.raises(ValueError, match="under runs/"):
        tparity.under_root("data/x.npy", tmp_path)
    with pytest.raises(ValueError, match="under runs/"):
        tparity.under_root("/abs/runs/x.npy", tmp_path)
    assert tparity.under_root("runs/lj/models/", tmp_path) == \
        f"{tmp_path}/lj/models/"
    _, raw = tparity.campaign_config(
        "Gaussian", tmp_path, overrides={"train_parameters": {
            "max_epochs": 20}})
    assert raw["train_parameters"]["max_epochs"] == 20
    assert raw["train_parameters"]["batch_size"] == 60


# ------------------------------------------------ fabricated step logs
RESULT = {
    "train": "best logprob: -36.400; checkpoint: x.pt; Adam mu float32\n",
    "testing": "logp of generated data vs testing data: -36.41 -36.38\n"
               "bar=0.000300 md=-0.006000 nf=0.005000 emus=0.000300\n",
    "fe_diff": "bar=0.000200 md=-0.005000 nf=0.005000 emus=0.000200  (kT "
               "per particle)\n",
}


class FakeRunner:
    """Records the steps it is asked to run; each succeeds with its result
    line, except the steps in `fail`."""

    def __init__(self, fail=()):
        self.calls, self.fail = [], set(fail)

    def __call__(self, argv, timeout):
        step = {"train": "train", "fe": "testing", "test": "fe_diff",
                "sample_data": "data"}[argv[0]]
        self.calls.append([str(a) for a in argv])
        if step in self.fail:
            return 1, "Traceback\nRuntimeError: boom\n", None
        return 0, RESULT.get(step, "wrote frames\n"), dict.fromkeys(
            tparity.LAUNCH_KEYS, 1)


def finished_gaussian(root):
    """A finished Gaussian run under `root`: its checkpoints and step logs."""
    _, raw = tparity.campaign_config("Gaussian", root)
    models = Path(raw["output"]["model_dir"])
    models.mkdir(parents=True)
    (models / "Gaussian.pt").write_bytes(b"best")
    (models / "Gaussian.pt.last").write_bytes(b"state")
    (root / "logs").mkdir()
    for step, text in RESULT.items():
        (root / "logs" / f"Gaussian_{step}.log").write_text(text)
    return models


def test_finished_steps_are_reconciled_from_their_logs(tmp_path):
    finished_gaussian(tmp_path)
    runner = FakeRunner()
    row = tparity.run_config("Gaussian", root=tmp_path, runner=runner)
    assert runner.calls == []
    assert all(s == {"ok": True, "seconds": 0.0, "reused": True}
               for s in row["steps"].values())
    assert row["best_logprob"] == -36.4 and row["bar"] == 0.0002
    assert tparity.status_of(row) == "ok"


def test_an_unfinished_training_resumes_and_renews_the_lineage(tmp_path):
    finished_gaussian(tmp_path)
    (tmp_path / "logs" / "Gaussian_train.log").write_text("Iter: 500\n")
    runner = FakeRunner()
    row = tparity.run_config("Gaussian", root=tmp_path, runner=runner)
    # the testing and fe_diff logs are conclusive, but of the old model
    assert [c[0] for c in runner.calls] == ["train", "fe", "test"]
    assert runner.calls[0][-1] == "--resume"
    assert not any(s.get("reused") for s in row["steps"].values())
    assert row["launches"] == dict.fromkeys(tparity.LAUNCH_KEYS, 3)


def test_a_fresh_data_step_reruns_every_later_step(tmp_path):
    """Phi4: its data is missing, so the data step runs, and the finished
    training and evaluation logs are not reconciled; the training starts
    afresh rather than resuming."""
    _, raw = tparity.campaign_config("Phi4", tmp_path)
    models = Path(raw["output"]["model_dir"])
    models.mkdir(parents=True)
    for suffix in ("", ".last"):
        (models / f"Phi4.pt{suffix}").write_bytes(b"x")
    (tmp_path / "logs").mkdir()
    for step, text in RESULT.items():
        (tmp_path / "logs" / f"Phi4_{step}.log").write_text(text)
    runner = FakeRunner()
    row = tparity.run_config("Phi4", root=tmp_path, runner=runner)
    assert [c[0] for c in runner.calls] == ["sample_data", "train", "fe",
                                            "test"]
    assert runner.calls[0][2] == "10000" and "--resume" not in runner.calls[1]
    assert tparity.status_of(row) == "ok"


def test_the_ntrials_data_sets_lie_where_apps_fe_finds_them(tmp_path):
    _, raw = tparity.campaign_config("LJ", tmp_path)
    runner = FakeRunner()
    tparity.run_config("LJ", root=tmp_path, runner=runner)
    test = Path(raw["dataset"]["testing_data"])
    runs = [c for c in runner.calls if "--test-only" in c]
    assert [c[-1] for c in runs] == [
        str(test.parent.parent / f"run_{i}" / test.name) for i in (1, 2, 3)]
    assert [c[c.index("--seed") + 1] for c in runs] == ["101", "102", "103"]
    assert all(c[2] == "500" for c in runs)
    assert runner.calls[4] == ["train", str(tmp_path / "configs" / "LJ.yaml"),
                               "--hmc-mix"]


def test_a_failed_step_drops_its_keys_and_is_not_retried(tmp_path):
    finished_gaussian(tmp_path)
    prev = tparity.run_config("Gaussian", root=tmp_path, runner=FakeRunner())
    runner = FakeRunner(fail={"fe_diff"})
    row = tparity.run_config("Gaussian", prev, root=tmp_path, runner=runner,
                             force=True)
    assert [c[0] for c in runner.calls] == ["train", "fe", "test"]
    assert row["steps"]["fe_diff"]["ok"] is False
    assert "RuntimeError: boom" in row["steps"]["fe_diff"]["tail"]
    assert not {"bar", "md", "nf", "emus"} & set(row)
    assert row["logp_gen"] == -36.41 and row["best_logprob"] == -36.4
    assert tparity.status_of(row) == "FAIL: fe_diff"
    # a failed training ends the row: nothing is evaluated
    runner = FakeRunner(fail={"train"})
    row = tparity.run_config("Gaussian", row, root=tmp_path, runner=runner,
                             force=True)
    assert [c[0] for c in runner.calls] == ["train"]
    assert "best_logprob" not in row
    assert tparity.status_of(row) == "FAIL: train,fe_diff"


def test_eval_best_marks_a_partial_train(tmp_path):
    finished_gaussian(tmp_path)
    (tmp_path / "logs" / "Gaussian_train.log").write_text("*** TIMEOUT\n")
    for step in ("testing", "fe_diff"):  # the timed-out run got no further
        (tmp_path / "logs" / f"Gaussian_{step}.log").unlink()
    runner = FakeRunner()
    row = tparity.run_config("Gaussian", root=tmp_path, runner=runner,
                             eval_best=True)
    assert [c[0] for c in runner.calls] == ["fe", "test"]
    assert row["steps"]["train"]["partial"] is True
    assert tparity.status_of(row) == "weak-fit: partial train (best-ckpt " \
        "eval)"
    (tmp_path / "logs" / "Gaussian_train.log").write_text(
        "INFO:x:Iter: 500\tLoss: 1.0\nINFO:x:Iter: 1000\tLoss: 0.5\n"
        "*** TIMEOUT after 10s\n")
    report = tmp_path / "report.md"
    tparity.render([row], {}, report, tmp_path / "logs")
    assert "its training log reached epoch 1000" in report.read_text()


def test_a_step_not_run_keeps_the_seconds_of_the_run_that_made_it(tmp_path):
    """--eval-best after a run whose training was cut: the row keeps that
    run's training seconds; a step reconciled from its log keeps the
    seconds of the run that wrote the log."""
    finished_gaussian(tmp_path)
    (tmp_path / "logs" / "Gaussian_train.log").write_text("*** TIMEOUT\n")
    (tmp_path / "logs" / "Gaussian_testing.log").unlink()
    prev = {"config": "Gaussian", "steps": {
        "train": {"ok": False, "seconds": 1500.3, "tail": "*** TIMEOUT"},
        "fe_diff": {"ok": True, "seconds": 9.5}}}
    runner = FakeRunner()
    row = tparity.run_config("Gaussian", prev, root=tmp_path, runner=runner,
                             eval_best=True)
    assert [c[0] for c in runner.calls] == ["fe", "test"]
    train = row["steps"]["train"]
    assert (train["ok"], train["seconds"], train["reused"],
            train["partial"]) == (True, 1500.3, True, True)
    again = tparity.run_config("Gaussian", row, root=tmp_path,
                               runner=FakeRunner(), eval_best=True)
    assert again["steps"]["fe_diff"]["seconds"] == \
        row["steps"]["fe_diff"]["seconds"]
    assert again["steps"]["fe_diff"]["reused"] is True
    report = tmp_path / "report.md"
    tparity.render([row], {}, report, tmp_path / "logs")
    assert "train 1500.3s (earlier run, partial)" in report.read_text()


@pytest.mark.parametrize("row, ok", [
    (dict(config="LJ", bar_mean=9.80), True),
    (dict(config="LJ", bar_mean=9.85), False),
    (dict(config="LJ", bar=9.6), False),
    (dict(config="Fe_400K", bar_mean=-4.05), True),
    (dict(config="Fe_100K", bar=-4.30), False),
    (dict(config="Phi4", bar=-1.06, emus=-1.065), True),
    (dict(config="Phi4", bar=-1.06, emus=-1.08), False),
    (dict(config="Gaussian", bar=0.01, emus=0.01, md=-0.1, nf=0.1), True),
    (dict(config="Einstein", bar=0.01, emus=0.01, md=-0.2, nf=0.1), False),
    (dict(config="Polymer", logp_gen=1.0), None),
    (dict(config="Polymer_rnvp"), None),
])
def test_holds_against_the_jax_record(row, ok):
    records = tparity.jax_rows()
    assert tparity.hold_of(row, records.get(row["config"]))[1] is ok
    assert tparity.holds([row], records)[0]["ok"] is ok


def test_render_puts_the_jax_record_beside_each_row(tmp_path):
    rows = json.loads(json.dumps(JAX_ROWS))
    rows[0]["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    report = tmp_path / "report.md"
    tparity.render(rows, tparity.jax_rows(), report)
    text = report.read_text()
    table = [ln for ln in text.splitlines()
             if ln.startswith("| ") and not ln.startswith("| config")]
    assert len(table) == len(JAX_ROWS)
    assert "`NVIDIA H100 80GB HBM3, 700.00 W`" in text
    assert "| LJ |" in text and "9.5778 ± 0.1195 (n=3)" in text
    assert "Missing (not yet run): Polymer_rnvp." in text
    # every table row has the header's 13 cells: a hold's |x| is escaped
    assert all(ln.replace("\\|", "").count("|") == 14 for ln in table)
    assert "\\|emus - bar\\|" in text and "| report only |" in text


# ------------------------------------------------ the runners on the CPU
def test_in_process_runner_on_gaussian(tmp_path):
    row = tparity.run_config(
        "Gaussian", root=tmp_path, runner=tparity.run_in_process,
        overrides={"device": "cpu", "train_parameters": {"max_epochs": 20}})
    assert list(row["steps"]) == ["train", "testing", "fe_diff"]
    assert all(s["ok"] for s in row["steps"].values()), row["steps"]
    for k in ("best_logprob", "logp_gen", "logp_test", "bar", "md", "nf",
              "emus"):
        assert math.isfinite(row[k]), k
    # the CPU runs the kernels' plain versions: the counters stay at 0
    assert row["launches"] == dict.fromkeys(tparity.LAUNCH_KEYS, 0)
    assert "card" not in row
    assert (tmp_path / "models" / "Gaussian.pt").exists() is False
    assert (tmp_path / "gaussian" / "models" / "Gaussian.pt").exists()
    assert "bar=" in (tmp_path / "logs" / "Gaussian_fe_diff.log").read_text()
    # run again: every step is reconciled
    again = tparity.run_config(
        "Gaussian", row, root=tmp_path, runner=tparity.run_in_process,
        overrides={"device": "cpu", "train_parameters": {"max_epochs": 20}})
    assert all(s.get("reused") for s in again["steps"].values())
    assert again["bar"] == row["bar"]


def test_subprocess_runner_on_gaussian_rnvp(tmp_path):
    """`python -m` a CLI in a process of its own: its output, exit code and
    the launch counters it prints as it exits."""
    cfg, _ = tparity.campaign_config("Gaussian_rnvp", tmp_path, overrides={
        "device": "cpu", "train_parameters": {"max_epochs": 20}})
    code, out, launches = tparity.run_subprocess(["train", cfg], 300)
    assert code == 0, out
    assert tparity.parse_train(out)["best_logprob"] < 0
    assert launches == dict.fromkeys(tparity.LAUNCH_KEYS, 0)
    assert (tmp_path / "gaussian_rnvp" / "models" / "Gaussian_rnvp_2l.pt"
            ).exists()
    code, out, launches = tparity.run_subprocess(["test", "missing.yaml"],
                                                 300)
    assert code != 0 and "FileNotFoundError" in out
    assert launches == dict.fromkeys(tparity.LAUNCH_KEYS, 0)


TINY_LJ = """device: cpu
dataset:
  name: LJ
  potential: LJ
  training_data: runs/tiny/data/train.npy
  testing_data: runs/tiny/data/test.npy
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
  centers: {lattice}
  alpha: 100
train_parameters:
  max_epochs: 100
  batch_size: 16
  output_freq: 100
  learning_rate: 1e-3
  scheduler: cosine
output:
  training_dir: runs/tiny/training/
  testing_dir: runs/tiny/testing/
  model_dir: runs/tiny/models/
"""


def test_a_shrunk_lj_solid_through_every_step(tmp_path):
    """The LJ row's steps on a one-cell fcc solid (4 particles at rho 1.28,
    kT 0.5) on the CPU: data, three independent test sets, training with
    the HMC mixer, apps.fe testing's BAR over the three sets, apps.test
    with relaxation; every parsed key present and finite."""
    from normalizingflow_tpu_torch.io import write_xyz

    box = 2 * (4 / (8 * 1.28)) ** (1 / 3)
    lattice = (np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
               * box - box / 4)
    write_xyz(str(tmp_path / "lattice.xyz"), lattice[None], 4)
    source = tmp_path / "tiny.yaml"
    source.write_text(TINY_LJ.format(lattice=tmp_path / "lattice.xyz"))
    root = tmp_path / "campaign"
    row = tparity.run_config("LJ", root=root, runner=tparity.run_in_process,
                             source=source, frames=64, run_frames=32)
    assert list(row["steps"]) == ["data", "data_run1", "data_run2",
                                  "data_run3", "train", "testing", "fe_diff"]
    assert all(s["ok"] for s in row["steps"].values()), row["steps"]
    assert row["ntrials"] == 3 and row["hmc_mix_events"] >= 1
    for k in ("best_logprob", "logp_gen", "logp_test", "bar_mean", "bar_std",
              "bar", "md", "nf", "emus"):
        assert math.isfinite(row[k]), k
    for i in (1, 2, 3):
        frames = np.load(root / "tiny" / f"run_{i}" / "test.npy")
        assert frames.shape == (32, 12) and np.isfinite(frames).all()
    assert tparity.status_of(row).startswith(("ok", "weak-fit"))


def test_main_refuses_an_unknown_config():
    with pytest.raises(SystemExit):
        tparity.main(["NoSuchConfig"])
