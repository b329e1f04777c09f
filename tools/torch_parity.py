"""The port's end-to-end parity campaign: every shipped config through the
port's CLIs at the config's own depth, beside the JAX package's record.

    python tools/torch_parity.py [configs...] [--force] [--eval-best]
                                 [--train-timeout SECONDS]

The twin of tools/parity.py for normalizingflow_tpu_torch (default: all 11
configs). Each step runs one of the port's CLIs as a user runs it
(`python -m normalizingflow_tpu_torch.apps.{sample_data,train,fe,test,
polymer}`) on a copy of the config whose data and output paths point under
the campaign's root, runs/torch_parity/ (a config's `runs/X` becomes
`runs/torch_parity/X`); its lattice and EAM table paths are made absolute.
So the campaign never writes into runs/parity/ (the JAX campaign's record)
or the configs' own runs/ paths. Per config, as tools/parity.py runs it:

  data        apps.sample_data <cfg> 10000 (LJ, Fe_*, Phi4), or
              apps.polymer <cfg> data 10000 (Polymer; Polymer_rnvp reuses
              those fields and makes them only where they are missing);
  data_run<i> for LJ and Fe_400K, three independent test sets
              (`--seed 100+i --test-only`) in run_<i>/ beside the test
              data, which apps.fe testing finds;
  train       apps.train (LJ with --hmc-mix);
  testing     apps.fe testing (held-out logp gap; BAR over the datasets),
              or apps.polymer testing;
  fe_diff     apps.test (BAR/MBAR/Zwanzig, with relaxation for LJ and Fe).

A step whose log already shows its result is reconciled, not re-run, until
a step runs again: from then on every later step runs (its lineage is
new). A model_dir holding `{name}.pt` and `.pt.last` without a finished
training log is resumed with --resume. A failed step drops the row's keys
it owns, records its output's tail, and is never retried. --force re-runs
every step; --eval-best evaluates the best checkpoint of an unfinished
training run, and marks the row a partial train. Every step has a timeout
that bounds a hang (training: 7200 s). A partial row is made in two runs:
the first with --train-timeout SECONDS, which cuts the training step (it
fails; its best checkpoint and .pt.last are kept), then one with
--eval-best; the row keeps the first run's training seconds.

Writes runs/torch_parity/logs/<config>_<step>.log, runs/torch_parity/
results.json (each row with its steps' seconds, the kernels' launches and
the card) and PARITY_RESULTS_TORCH.md (the rows beside the JAX package's
record in runs/parity/results.json, which is read and never written, and
each row's hold against that record). Exits non-zero if a step failed or a
hold missed. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import logging
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from normalizingflow_tpu_torch.ops import (  # noqa: E402
    LAUNCH_KEYS,
    launch_counts,
)

ROOT = REPO / "runs" / "torch_parity"
REPORT = REPO / "PARITY_RESULTS_TORCH.md"
JAX_RESULTS = REPO / "runs" / "parity" / "results.json"
APP = "normalizingflow_tpu_torch.apps."

DATA_FRAMES, RUN_FRAMES = 10000, 500  # tools/parity.py's frame counts
DATA_CONFIGS = ("LJ", "Fe_100K", "Fe_400K", "Fe_700K", "Phi4")
NTRIALS_CONFIGS = ("LJ", "Fe_400K")
# Seconds a step may take before it counts as hung (tools/parity.py's).
TIMEOUTS = {"data": 3600, "train": 7200, "testing": 3600, "fe_diff": 1800}

FLOAT = r"(-?[\d.]+(?:e[+-]?\d+)?)"


def parse_fe_testing(out):
    d = {}
    m = re.search(
        rf"logp of generated data vs testing data: {FLOAT} {FLOAT}", out)
    if m:
        d["logp_gen"] = float(m.group(1))
        d["logp_test"] = float(m.group(2))
    m = re.search(
        rf"BAR dF over (\d+) datasets: {FLOAT} \+/- {FLOAT}", out)
    if m:
        d["ntrials"] = int(m.group(1))
        d["bar_mean"] = float(m.group(2))
        d["bar_std"] = float(m.group(3))
    d.update(parse_fe_diff(out))
    return d


def parse_fe_diff(out):
    m = re.search(
        rf"bar={FLOAT} md={FLOAT} nf={FLOAT} emus={FLOAT}", out)
    if not m:
        return {}
    return {k: float(m.group(i + 1))
            for i, k in enumerate(("bar", "md", "nf", "emus"))}


# The row's keys each step's parser owns: a step that fails drops them, so
# that no earlier run's numbers stand beside a failed step.
OWNED_KEYS = {
    "train": ("best_logprob", "hmc_mix_events", "hmc_mix_gate_passed",
              "hmc_mix_acceptances"),
    "testing": ("logp_gen", "logp_test", "ntrials", "bar_mean", "bar_std",
                "bar", "md", "nf", "emus"),
    "fe_diff": ("bar", "md", "nf", "emus"),
}


def parse_train(out):
    d = {}
    m = re.search(rf"best logprob: {FLOAT}", out)
    if m:
        d["best_logprob"] = float(m.group(1))
    mixes = re.findall(
        rf"HMC mix at epoch (\d+): acceptance {FLOAT} -> (.+)", out)
    if mixes:
        d["hmc_mix_events"] = len(mixes)
        d["hmc_mix_gate_passed"] = sum(
            1 for _, _, s in mixes if s.startswith("relaxed"))
        d["hmc_mix_acceptances"] = [round(float(a), 3) for _, a, _ in mixes]
    return d


PARSERS = {"train": parse_train, "testing": parse_fe_testing,
           "fe_diff": parse_fe_diff}


# ------------------------------------------------------------ the configs
def under_root(path, root):
    """`runs/X` -> `<root>/X`; a data or output path elsewhere is refused,
    so that the campaign writes nowhere but under its root."""
    parts = Path(path).parts
    if Path(path).is_absolute() or parts[:1] != ("runs",) or len(parts) < 2:
        raise ValueError(f"{path}: a campaign path must lie under runs/")
    return str(Path(root, *parts[1:])) + ("/" if path.endswith("/") else "")


def campaign_config(name, root=ROOT, source=None, overrides=None):
    """Write `<root>/configs/<name>.yaml`, a copy of `source` (default
    configs/<name>.yaml) whose training/testing data and output paths lie
    under `root` and whose lattice and EAM table paths are absolute; each
    entry of `overrides` replaces the top-level key, or updates it where
    both are mappings (`{"device": "cpu", "train_parameters":
    {"max_epochs": 20}}`). Returns (the copy's path, its raw dict)."""
    import yaml

    source = Path(source or REPO / "configs" / f"{name}.yaml")
    raw = yaml.safe_load(source.read_text())
    ds = raw["dataset"]
    for key in ("training_data", "testing_data"):
        if ds.get(key):
            ds[key] = under_root(ds[key], root)
    raw["output"] = {k: under_root(v, root)
                     for k, v in raw["output"].items()}
    for section in ("dataset", "prior"):
        for key in ("centers", "input_dir"):
            if isinstance(raw.get(section, {}).get(key), str):
                raw[section][key] = str(REPO / raw[section][key])
    for key, value in (overrides or {}).items():
        if isinstance(value, dict) and isinstance(raw.get(key), dict):
            raw[key].update(value)
        else:
            raw[key] = value
    path = Path(root, "configs", f"{name}.yaml")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(raw))
    return path, raw


# ------------------------------------------------------------ the runners
LAUNCHES = "kernel launches: "
# `python -m <module> <args>`, with the kernels' launch counters printed as
# the process exits
REPORTING_MAIN = """
import atexit, json, runpy, sys
from normalizingflow_tpu_torch.ops import launch_counts
from tools.torch_parity import LAUNCHES
atexit.register(lambda: print(LAUNCHES + json.dumps(launch_counts()),
                              flush=True))
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def run_subprocess(argv, timeout):
    """`python -m normalizingflow_tpu_torch.apps.<argv[0]> argv[1:]` in a
    process of its own, killed after `timeout` seconds. Returns (exit code,
    stdout and stderr, the kernels' launches)."""
    cmd = [sys.executable, "-c", REPORTING_MAIN, APP + argv[0],
           *map(str, argv[1:])]
    try:
        p = subprocess.run(cmd, cwd=REPO, timeout=timeout,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        out, code = p.stdout, p.returncode
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode() if isinstance(e.stdout, bytes) else (
            e.stdout or "")
        out += f"\n*** TIMEOUT after {timeout}s"
        code = -1
    launches = None
    for line in out.splitlines():
        if line.startswith(LAUNCHES):
            launches = json.loads(line[len(LAUNCHES):])
    return code, out, launches


def run_in_process(argv, timeout=None):
    """`main(argv[1:])` of normalizingflow_tpu_torch.apps.<argv[0]> in this
    process, its stdout, stderr and the port's log records captured, so
    that this process's launch counters see its kernels. No timeout. An
    exception is the step's failure: its traceback is the output's tail."""
    main = importlib.import_module(APP + argv[0]).main
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    logger = logging.getLogger("normalizingflow_tpu_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    before = launch_counts()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            code = main([str(a) for a in argv[1:]])
    except Exception:
        buf.write(traceback.format_exc())
        code = 1
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    after = launch_counts()
    return code, buf.getvalue(), {k: after[k] - before[k] for k in after}


def card():
    """The card's name and power limit as nvidia-smi gives them (None
    without nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# ------------------------------------------------------------ the campaign
def run_config(name, prev=None, *, root=ROOT, runner=run_subprocess,
               force=False, eval_best=False, source=None, overrides=None,
               frames=DATA_FRAMES, run_frames=RUN_FRAMES, timeouts=None):
    """One config through the campaign's steps (module docstring); returns
    its row. `prev`, the config's row of an earlier run, is superseded step
    by step. `source` and `overrides` go to campaign_config; `frames` and
    `run_frames` are the data and independent test sets' frame counts."""
    timeouts = {**TIMEOUTS, **(timeouts or {})}
    logdir = Path(root, "logs")
    logdir.mkdir(parents=True, exist_ok=True)
    cfg, raw = campaign_config(name, root, source, overrides)
    earlier = dict((prev or {}).get("steps") or {})
    row = {"config": name, "steps": dict(earlier)}
    for k, v in (prev or {}).items():
        row.setdefault(k, v)
    row["nparticles"] = raw["dataset"].get("nparticles")
    if str(raw.get("device")).lower() != "cpu":
        row["card"] = card()
    row.pop("launches", None)
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    fresh = [False]  # a step ran: later steps' logs are of another lineage

    def log_of(step_name):
        return logdir / f"{name}_{step_name}.log"

    def kept(step_name, **extra):
        """The record of a step this run does not execute: the seconds of
        the run that made its output (0 where none was recorded)."""
        row["steps"][step_name] = {
            "ok": True, "seconds": (earlier.get(step_name) or {}).get(
                "seconds", 0.0), "reused": True, **extra}

    def reconciled(step_name, need_keys):
        """The parsed result of an existing log that shows one."""
        if force or fresh[0] or not log_of(step_name).exists():
            return None
        d = PARSERS[step_name](log_of(step_name).read_text())
        return d if all(k in d for k in need_keys) else None

    def step(step_name, argv, need_keys=None):
        if need_keys is not None:
            d = reconciled(step_name, need_keys)
            if d is not None:
                print(f"[{name}] {step_name}: reconciled from its log",
                      flush=True)
                kept(step_name)
                row.update(d)
                return True
        print(f"[{name}] {step_name}: {' '.join(map(str, argv))}",
              flush=True)
        t0 = time.perf_counter()
        code, out, counted = runner(argv, timeouts[
            "data" if step_name.startswith("data") else step_name])
        dt = time.perf_counter() - t0
        log_of(step_name).write_text(out)
        ok = code == 0
        print(f"[{name}] {step_name}: {'ok' if ok else f'FAIL({code})'} in "
              f"{dt:.1f}s", flush=True)
        fresh[0] = True
        row["steps"][step_name] = {"ok": ok, "seconds": round(dt, 2),
                                   "launches": counted}
        for k, v in (counted or {}).items():
            launches[k] += v
        row["launches"] = dict(launches)
        if ok and step_name in PARSERS:
            row.update(PARSERS[step_name](out))
        if not ok:
            for k in OWNED_KEYS.get(step_name, ()):
                row.pop(k, None)
            row["steps"][step_name]["tail"] = "\n".join(
                out.strip().splitlines()[-6:])
        return ok

    def have(*paths):
        return not force and all(p and os.path.exists(p) for p in paths)

    ds = raw["dataset"]
    data_paths = (ds.get("training_data"), ds.get("testing_data"))
    if name in DATA_CONFIGS:
        if have(*data_paths):
            kept("data")
        elif not step("data", ["sample_data", cfg, frames]):
            return row
        if name in NTRIALS_CONFIGS:
            test = Path(ds["testing_data"])
            for i in (1, 2, 3):
                out_path = test.parent.parent / f"run_{i}" / test.name
                if have(out_path):
                    kept(f"data_run{i}")
                elif not step(f"data_run{i}", [
                        "sample_data", cfg, run_frames, "--seed", 100 + i,
                        "--test-only", out_path]):
                    return row
    if name.startswith("Polymer"):
        # Polymer and Polymer_rnvp train on the same fields
        if have(*data_paths):
            kept("data")
        elif not step("data", ["polymer", cfg, "data", frames]):
            return row

    # the reference's workflow trains without the HMC mixer; LJ runs it to
    # exercise the acceptance-gated policy end to end
    train_args = ["train", cfg] + (["--hmc-mix"] if name == "LJ" else [])
    ckpt = Path(raw["output"]["model_dir"], f"{ds['name']}.pt")
    last = Path(f"{ckpt}.last")
    if (not force and not fresh[0] and ckpt.exists() and last.exists()
            and reconciled("train", ("best_logprob",)) is None):
        train_args.append("--resume")
    if eval_best and ckpt.exists() and "--resume" in train_args:
        kept("train", partial=True,
             note="evaluating the best checkpoint; training has not "
                  "reached max_epochs (its state is kept in .pt.last)")
    elif not step("train", train_args, need_keys=None if (
            force or not ckpt.exists()) else ("best_logprob",)):
        return row

    if name.startswith("Polymer"):
        step("testing", ["polymer", cfg, "testing"],
             need_keys=("logp_gen", "logp_test"))
    else:
        step("testing", ["fe", cfg, "testing"],
             need_keys=("logp_gen", "logp_test"))
        # relaxation for the particle systems: the reference's default
        step("fe_diff", ["test", cfg], need_keys=("bar", "md", "nf", "emus"))
    return row


# configs whose target potential is a normalized negative log-density: every
# Delta-F estimator must return 0 a particle
EXACT_ZERO = {"Gaussian", "GaussianMixture", "Gaussian_rnvp", "Einstein"}

# nparticles a config (the normalizer of the logp-gap gate)
NPARTICLES = {"Gaussian": 20, "GaussianMixture": 20, "Gaussian_rnvp": 20,
              "Einstein": 32, "LJ": 32, "Fe_100K": 54, "Fe_400K": 54,
              "Fe_700K": 54, "Polymer": 2048, "Polymer_rnvp": 2048,
              "Phi4": 64}
ALL = ["Gaussian", "GaussianMixture", "Gaussian_rnvp", "Einstein",
       "LJ", "Fe_100K", "Fe_400K", "Fe_700K", "Polymer", "Polymer_rnvp",
       "Phi4"]


def status_of(r):
    """A row's verdict: its failed steps; else the held-out logp gap a
    particle (0.05 kT) and, where the exact answer is 0, each estimator
    (the one-sided Zwanzig pair at 0.15, BAR and MBAR at 0.05)."""
    bad_steps = [k for k, s in r["steps"].items() if not s.get("ok")]
    if bad_steps:
        return "FAIL: " + ",".join(bad_steps)
    issues = []
    if any(s.get("partial") for s in r["steps"].values()):
        issues.append("partial train (best-ckpt eval)")
    g, t = r.get("logp_gen"), r.get("logp_test")
    npart = r.get("nparticles") or NPARTICLES.get(r["config"], 1)
    if g is not None and t is not None and abs(g - t) / npart > 0.05:
        issues.append(f"gap={g - t:+.2f} ({(g - t) / npart:+.3f}/ptcl)")
    if r["config"] in EXACT_ZERO:
        for k, tol in (("bar", 0.05), ("emus", 0.05),
                       ("md", 0.15), ("nf", 0.15)):
            if k in r and abs(r[k]) > tol:
                issues.append(f"{k}={r[k]:.3f}")
    return "ok" if not issues else "weak-fit: " + ", ".join(issues)


# Each row's hold against the JAX package's record (runs/parity/
# results.json): the key compared, the record's key, and the tolerance. The
# record's spread sets it: Fe_400K's BAR over three data sets has std
# 0.0006; LJ's 0.1195, so LJ is held at twice that.
HOLDS = {"Fe_100K": ("bar", 0.05), "Fe_700K": ("bar", 0.05),
         "Fe_400K": ("bar_mean", 0.05), "Phi4": ("bar", 0.05),
         "LJ": ("bar_mean", 0.24)}
PHI4_EMUS_BAR = 0.01
EXACT_TOL = (("bar", 0.05), ("emus", 0.05), ("md", 0.15), ("nf", 0.15))


def jax_rows(path=JAX_RESULTS):
    """The JAX package's campaign rows by config."""
    with open(path) as f:
        return {r["config"]: r for r in json.load(f)}


def hold_of(row, record):
    """(the hold's text, True / False / None where a row has no hold or
    lacks a number) of a row against the JAX row `record`."""
    name = row["config"]
    if name in EXACT_ZERO:
        if any(k not in row for k, _ in EXACT_TOL):
            return "exact 0: estimates missing", False
        miss = [f"|{k}| {abs(row[k]):.4f} > {tol}" for k, tol in EXACT_TOL
                if abs(row[k]) > tol]
        return ("exact 0: " + ("; ".join(miss) or "all within "
                               "0.05 (bar, emus) / 0.15 (md, nf)"),
                not miss)
    if name not in HOLDS:
        return "report only", None
    key, tol = HOLDS[name]
    if key not in row or record is None or key not in record:
        return f"{key} missing", False
    gap = row[key] - record[key]
    text = f"{key} {row[key]:.4f} - JAX {record[key]:.4f} = {gap:+.4f} " \
           f"(hold {tol})"
    ok = abs(gap) <= tol
    if name == "Phi4":
        if "emus" not in row:
            return text + "; emus missing", False
        spread = abs(row["emus"] - row["bar"])
        text += f"; |emus - bar| {spread:.4f} (hold {PHI4_EMUS_BAR})"
        ok = ok and spread <= PHI4_EMUS_BAR
    return text, ok


def holds(rows, records):
    """Every row's hold, printed and returned as a list of dicts."""
    out = []
    for r in rows:
        text, ok = hold_of(r, records.get(r["config"]))
        verdict = {True: "held", False: "MISSED", None: "no hold"}[ok]
        print(f"[{r['config']}] hold: {verdict}: {text}", flush=True)
        out.append({"config": r["config"], "hold": text, "ok": ok})
    return out


def reached_epoch(name, logdir):
    """The last epoch the config's training log reports, or None."""
    log = Path(logdir, f"{name}_train.log")
    epochs = re.findall(r"Iter: (\d+)", log.read_text()) if log.exists() \
        else []
    return int(epochs[-1]) if epochs else None


def render(rows, records, path=REPORT, logdir=ROOT / "logs"):
    """PARITY_RESULTS_TORCH.md: each row beside the JAX record's; a
    partial train with the epoch its training log reached."""
    have = {r["config"] for r in rows}
    missing = [n for n in ALL if n not in have]
    cards = sorted({r["card"] for r in rows if r.get("card")})

    def num(r, k, f="{:.4f}"):
        return f.format(r[k]) if r and r.get(k) is not None else "—"

    def marks(step):
        on = [w for w, k in (("earlier run", "reused"),
                             ("partial", "partial")) if step.get(k)]
        return f" ({', '.join(on)})" if on else ""

    def ntrials(r):
        return (f"{r['bar_mean']:.4f} ± {r['bar_std']:.4f} "
                f"(n={r['ntrials']})" if r and "bar_mean" in r else "—")

    lines = [
        "# PARITY_RESULTS_TORCH — the port's campaign, beside the JAX "
        "package's",
        "",
        f"Campaign coverage: {len(have)}/{len(ALL)} configs have rows."
        + (f" Missing (not yet run): {', '.join(missing)}." if missing
           else ""),
        "",
        "Produced by `python tools/torch_parity.py` (one config a call) on "
        + (", ".join(f"`{c}`" for c in cards) or "no card")
        + " (name, power limit, as `nvidia-smi --query-gpu=name,power.limit"
        " --format=csv,noheader` gives them). Every step is one of the "
        "port's CLIs at the config's own depth: data (`apps.sample_data` "
        "HMC, 10000 frames; `apps.polymer data`), three independent test "
        "sets for LJ and Fe_400K, training (`apps.train`; LJ with "
        "`--hmc-mix`), the held-out log-likelihood gap and BAR over the "
        "data sets (`apps.fe testing`, `apps.polymer testing`) and "
        "BAR/MBAR/Zwanzig with relaxation for the particle systems "
        "(`apps.test`). Delta-F in kT a particle; the Gaussian configs and "
        "Einstein have the exact answer 0. The JAX columns are the JAX "
        "package's own campaign (`runs/parity/results.json`, "
        "`PARITY_RESULTS.md`); its timings are a TPU's and are not "
        "repeated here.",
        "",
        "| config | logp(gen) | logp(held-out) | gap | bar | md | nf | "
        "emus | ntrials mean ± std | status | JAX bar | JAX ntrials | "
        "hold |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        rec = records.get(r["config"])
        g, t = r.get("logp_gen"), r.get("logp_test")
        gap = f"{g - t:+.2f}" if g is not None and t is not None else "—"
        text, ok = hold_of(r, rec)
        hold = text if ok is None else \
            f"{'held' if ok else 'MISSED'}: {text}"
        hold = hold.replace("|", "\\|")  # |x| inside a table cell
        lines.append(
            f"| {r['config']} | {num(r, 'logp_gen', '{:.2f}')} | "
            f"{num(r, 'logp_test', '{:.2f}')} | {gap} | {num(r, 'bar')} | "
            f"{num(r, 'md')} | {num(r, 'nf')} | {num(r, 'emus')} | "
            f"{ntrials(r)} | {status_of(r)} | {num(rec, 'bar')} | "
            f"{ntrials(rec)} | {hold} |")
    lines += ["", "## Steps on the card", "",
              "Each step's seconds (host clock around the CLI's process, "
              "its start-up and the kernels' build included) and the "
              "kernels' launches in it (accept_select, rqs, rqs_vjp). A "
              "step this run did not execute (reconciled from its log, its "
              "output reused, or a cut training evaluated with "
              "--eval-best) keeps the seconds of the earlier run that made "
              "it (0 where none was recorded).", ""]
    for r in rows:
        steps = ", ".join(f"{k} {v['seconds']}s{marks(v)}"
                          for k, v in r["steps"].items())
        lines.append(f"- **{r['config']}** on {r.get('card') or 'the CPU'}: "
                     f"{steps}")
        if r.get("launches"):
            lines.append("  - launches: " + ", ".join(
                f"{k} {v}" for k, v in r["launches"].items()
                if k != "accept_unfused"))
        if "hmc_mix_events" in r:
            lines.append(
                f"  - HMC mixer: {r['hmc_mix_events']} calls, gate (0.3, "
                f"0.6) passed {r['hmc_mix_gate_passed']}x; acceptances "
                f"{r['hmc_mix_acceptances']}")
        for k, v in r["steps"].items():
            if v.get("note"):
                epoch = reached_epoch(r["config"], logdir)
                lines.append(f"  - {k}: {v['note']}" + (
                    f"; its training log reached epoch {epoch}"
                    if v.get("partial") and epoch else ""))
            if not v.get("ok") and v.get("tail"):
                lines.append(f"  - {k} failure tail:\n```\n{v['tail']}\n```")
    Path(path).write_text("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*", metavar="CONFIG",
                    help=f"of {', '.join(ALL)} (default: all)")
    ap.add_argument("--force", action="store_true",
                    help="re-run every step, reconciling nothing")
    ap.add_argument("--eval-best", action="store_true",
                    help="evaluate the best checkpoint of an unfinished "
                    "training run (the row is marked a partial train)")
    ap.add_argument("--train-timeout", type=float, default=TIMEOUTS["train"],
                    help="partial rows: cut the training step after this "
                    "many seconds (it fails, its .pt.last kept); a "
                    "following --eval-best run evaluates the best "
                    "checkpoint as a partial train")
    args = ap.parse_args(argv)
    names = args.configs or ALL
    if set(names) - set(ALL):
        ap.error(f"unknown configs {sorted(set(names) - set(ALL))}")
    results = ROOT / "results.json"
    prev = {}
    if results.exists():
        prev = {r["config"]: r for r in json.loads(results.read_text())}
    rows = {n: r for n, r in prev.items() if n not in names}
    records = jax_rows()
    for name in names:
        rows[name] = run_config(name, prev.get(name), force=args.force,
                                eval_best=args.eval_best,
                                timeouts={"train": args.train_timeout})
        print(f"[{name}] status: {status_of(rows[name])}", flush=True)
        ordered = sorted(rows.values(), key=lambda r: ALL.index(r["config"]))
        results.write_text(json.dumps(ordered, indent=1))
        render(ordered, records)
    checked = holds([rows[n] for n in names], records)
    failed = [n for n in names if status_of(rows[n]).startswith("FAIL")]
    missed = [h["config"] for h in checked if h["ok"] is False]
    print(f"report -> {REPORT}; failed: {failed}; holds missed: {missed}",
          flush=True)
    return 1 if failed or missed else 0


if __name__ == "__main__":
    sys.exit(main())
