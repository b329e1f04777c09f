"""Design sweep of a physics config's fit, on the card: the twin of
tools/fit_sweep.py for normalizingflow_tpu_torch.

Trains a grid of architecture and training variants of a config and
reports the reference's own quality metric, the held-out log-density gap
a particle (mean flow log-density of 2000 generated draws minus that of
the config's testing_data), one row a variant. The `rkl` variant finishes
the forward-KL fit with 2000 reverse-KL steps against the config's own
differentiable density. Every variant trains with train_flow_fused
directly, so `baseline` does not apply the config's rkl_finetune_steps.

Usage:
  python tools/torch_fit_sweep.py <config.yaml>              # the grid
  python tools/torch_fit_sweep.py <config.yaml> --quick      # baseline, rkl
  python tools/torch_fit_sweep.py <config.yaml> --variants a,b [--cpu]
  python tools/torch_fit_sweep.py --render     # FIT_STUDIES_TORCH.md

Runs on the card unless --cpu is given (without CUDA it raises). The
training generator is seeded with the config's seed and initialises the
flow's weights, as apps.train does; the held-out draws come from one seeded
with seed + 2. Prints each row as one JSON line with the JAX tool's keys,
then the card and the kernels' launches in that row, and last the JAX
tool's markdown table; exits non-zero if a variant failed. Writes
runs/torch_fit/fit_sweep_<name>.json (the rows with their launches, card
and frame counts), never the JAX tool's runs/fit_sweep_<name>.json.

`--render` writes FIT_STUDIES_TORCH.md from the rows under runs/torch_fit/
(this tool's, tools/torch_gm_fit_sweep.py's gm_fit_sweep.json and
tools/torch_lj_permutation.py's lj_permutation.json; a 4x-data row is the
sweep's file of the 40000-frame run renamed fit_sweep_<name>_bigdata.json),
each beside the JAX package's record of the same study and held to the
conclusion PARITY_RESULTS.md or configs/GaussianMixture.yaml draws from
it. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from normalizingflow_tpu_torch.apps.fe_eval import (  # noqa: E402
    evaluate,
    generate_from_nf,
)
from normalizingflow_tpu_torch.config import (  # noqa: E402
    load_config,
    setup_model,
)
from normalizingflow_tpu_torch.device import entry_device  # noqa: E402
from normalizingflow_tpu_torch.ops import launch_counts  # noqa: E402
from normalizingflow_tpu_torch.train.fused import (  # noqa: E402
    train_flow_fused,
)
from normalizingflow_tpu_torch.train.objectives import (  # noqa: E402
    rkl_finetune,
)
from tools.torch_parity import card  # noqa: E402

OUT = REPO / "runs" / "torch_fit"
REPORT = REPO / "FIT_STUDIES_TORCH.md"

# Each variant: (flow overrides, train overrides, rkl fine-tune steps); the
# overrides multiply the config's value. One axis per hypothesis about the
# gap: capacity (hidden/nlayers/nsplines), optimization length (epochs),
# objective (reverse KL against the density instead of the finite sample).
VARIANTS = {
    "baseline": ({}, {}, 0),
    "short": ({}, {"max_epochs": 0.5}, 0),              # overfit probe
    "long": ({}, {"max_epochs": 3.0}, 0),               # 3x epochs
    "wide": ({"hidden_dim": 2.0}, {}, 0),               # 2x hidden
    "deep": ({"nlayers": 2.0}, {}, 0),                  # 2x layers
    "bins": ({"nsplines": 2.0}, {}, 0),                 # 2x spline bins
    "rkl": ({}, {}, 2000),                              # + reverse-KL tune
    "big_long": ({"hidden_dim": 2.0, "nlayers": 2.0},
                 {"max_epochs": 2.0}, 0),
}
QUICK = ("baseline", "rkl")


def apply_overrides(cfg, flow_ov, train_ov):
    fl = cfg.flow
    for k, mult in flow_ov.items():
        fl = dataclasses.replace(fl, **{k: int(getattr(fl, k) * mult)})
    tp = cfg.train_parameters
    for k, mult in train_ov.items():
        tp = dataclasses.replace(tp, **{k: int(getattr(tp, k) * mult)})
    return dataclasses.replace(cfg, flow=fl, train_parameters=tp)


def heldout_gap(flow, cfg, nsamples=2000, z=None):
    """(mean logp of `nsamples` flow draws, mean logp of the config's
    testing_data, their difference a particle). The draws come from a
    generator on the flow's device seeded with seed + 2, or are pushed from
    the latents `z` (see generate_from_nf)."""
    p = next(flow.parameters())
    gen = torch.Generator(device=p.device).manual_seed(cfg.seed + 2)
    _, q1 = generate_from_nf(flow, nsamples, batchsize=500, generator=gen,
                             z=z)
    test = np.load(os.path.join(REPO, cfg.dataset.testing_data))
    test = torch.as_tensor(test.reshape(len(test), -1), device=p.device,
                           dtype=p.dtype)
    q2 = evaluate(flow, test, batchsize=500)
    gen_lp, held = float(torch.mean(q1)), float(torch.mean(q2))
    return gen_lp, held, (gen_lp - held) / cfg.dataset.nparticles


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def row_extras(name, device, before):
    """What a row records beside the JAX tool's keys, printed on a line of
    its own: the card (None on the CPU) and the kernels' launches since
    `before`."""
    after = launch_counts()
    extras = {"card": card() if device.type == "cuda" else None,
              "launches": {k: after[k] - before[k] for k in after}}
    print(f"{name}: card {extras['card']}; launches "
          f"{json.dumps(extras['launches'])}", flush=True)
    return extras


def run_variant(name, base_cfg, flow_ov, train_ov, rkl_steps,
                device="cuda"):
    """Train one variant on `device` and measure its held-out gap; prints
    the row and returns it with row_extras' keys and the training and test
    frame counts."""
    device = entry_device(device)
    cfg = apply_overrides(base_cfg, flow_ov, train_ov)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    flow, potential, cfg = setup_model(cfg, mode="training", device=device,
                                       generator=generator)
    tp = cfg.train_parameters
    before = launch_counts()
    synchronize(device)
    t0 = time.time()
    hist = train_flow_fused(
        flow, generator, potential, max_epochs=tp.max_epochs,
        batch_size=tp.batch_size, learning_rate=tp.learning_rate,
        scheduler=tp.scheduler, gamma=tp.lr_scheduler_gamma,
        output_freq=tp.output_freq, checkpoint_path=None, device=device)
    rkl_loss = None
    if rkl_steps:
        # the target density for reverse KL: the config's own
        # differentiable potential (log_prob), not the finite sample
        rkl_loss = rkl_finetune(flow, potential, rkl_steps)
    synchronize(device)
    t_train = time.time() - t0
    gen, held, gap = heldout_gap(flow, cfg)
    row = {
        "variant": name,
        "flow": {k: getattr(cfg.flow, k)
                 for k in ("nlayers", "nsplines", "hidden_dim")},
        "epochs": tp.max_epochs,
        "rkl_steps": rkl_steps,
        "rkl_final_loss": rkl_loss,
        "best_logprob": hist["best_logprob"],
        "logp_gen": round(gen, 2),
        "logp_heldout": round(held, 2),
        "gap_per_ptcl": round(gap, 4),
        "train_s": round(t_train, 1),
    }
    print(json.dumps(row), flush=True)
    data = getattr(potential, "dataset", None)
    test = np.load(os.path.join(REPO, cfg.dataset.testing_data),
                   mmap_mode="r")
    return dict(row, **row_extras(name, device, before),
                frames=[None if data is None else len(data), len(test)])


def parse_args(argv):
    """(config path, variant names, device) from the JAX tool's CLI."""
    cpu = "--cpu" in argv
    argv = [a for a in argv if a != "--cpu"]
    names = list(QUICK) if "--quick" in argv else list(VARIANTS)
    positional = []
    it = iter(argv)
    for a in it:
        if a == "--variants":
            names = next(it).split(",")
        elif a != "--quick":
            positional.append(a)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; of {list(VARIANTS)}")
    cfg_path = positional[0] if positional else "configs/Phi4.yaml"
    return cfg_path, names, "cpu" if cpu else "cuda"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv == ["--render"]:
        render()
        print(f"report -> {REPORT}")
        return 0
    cfg_path, names, device = parse_args(argv)
    device = entry_device(device)
    base_cfg = load_config(cfg_path)
    out_path = OUT / f"fit_sweep_{base_cfg.dataset.name}.json"
    rows = []
    for name in names:
        flow_ov, train_ov, rkl_steps = VARIANTS[name]
        try:
            rows.append(run_variant(name, base_cfg, flow_ov, train_ov,
                                    rkl_steps, device=device))
        except Exception as e:  # keep sweeping; report the failure
            rows.append({"variant": name, "error": repr(e)[:300]})
            print(f"{name}: FAILED {e!r}", flush=True)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rows, indent=1))
    print("\n| variant | layers | bins | hidden | epochs | rkl | "
          "gap kT/ptcl | train s |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "error" in r:
            print(f"| {r['variant']} | - | - | - | - | - | ERROR | - |")
            continue
        fl = r["flow"]
        print(f"| {r['variant']} | {fl['nlayers']} | {fl['nsplines']} | "
              f"{fl['hidden_dim']} | {r['epochs']} | {r['rkl_steps']} | "
              f"{r['gap_per_ptcl']:+.3f} | {r['train_s']} |")
    print(f"table data -> {out_path}")
    return 1 if any("error" in r for r in rows) else 0


# ------------------------------------------------------------ the report
RUNS = REPO / "runs"
# configs/GaussianMixture.yaml:7-9 quotes the JAX sweep's gaps (its rows
# were not kept): 1 layer, 2 layers, 4 layers, 4 layers + 20k epochs +
# batch 256.
JAX_GM_GAPS = {"ref": -1.36, "2layer_6k": -0.52, "4layer_6k": -0.31,
               "4layer_20k_b256": -0.18}
PERM_LINES = {
    "frames": r"frames: (\d+)  atoms: (\d+)  box L: ([\d.]+)",
    "moved": r"non-identity assignment in (\d+)/\d+ frames; mean atoms off "
             r"their own site: ([\d.]+)/",
    "energy": r"mean U raw (-?[\d.]+) vs relabeled (-?[\d.]+)",
    "logp": r"generated (-?[\d.]+)  held-out RAW (-?[\d.]+)  held-out "
            r"RELABELED (-?[\d.]+)",
    "recovered": r"recovered (-?[\d.]+)% of the gap",
}


def json_rows(text):
    """The sweep rows a log holds: its lines that are JSON objects with a
    `variant` key."""
    return [json.loads(line) for line in text.splitlines()
            if line.startswith('{"variant"')]


def parse_permutation(text):
    """The permutation diagnostic's numbers from its printed lines, in the
    keys tools/torch_lj_permutation.py writes."""
    m = {k: re.search(p, text) for k, p in PERM_LINES.items()}
    if not all(m.values()):
        return None
    return {"frames": int(m["frames"][1]), "atoms": int(m["frames"][2]),
            "box": float(m["frames"][3]),
            "n_permuted": int(m["moved"][1]),
            "mean_moved": float(m["moved"][2]),
            "u_raw": float(m["energy"][1]), "u_rel": float(m["energy"][2]),
            "logp_gen": float(m["logp"][1]), "logp_raw": float(m["logp"][2]),
            "logp_rel": float(m["logp"][3]),
            "recovered_pct": float(m["recovered"][1])}


def jax_record(runs=RUNS):
    """The JAX package's record of the three studies (TPU v5e):
    {"phi4", "phi4_bigdata", "lj", "lj_bigdata": {variant: row},
    "permutation": numbers, "gm": {variant: gap}}."""
    def by_variant(rows):
        return {r["variant"]: r for r in rows}

    def log_rows(name):
        return by_variant(json_rows((runs / name).read_text()))

    return {
        "phi4": by_variant(json.loads(
            (runs / "fit_sweep_Phi4.json").read_text())),
        "phi4_bigdata": log_rows("fit_sweep_Phi4_bigdata.log"),
        "lj": log_rows("fit_sweep_LJ.log"),
        "lj_bigdata": log_rows("fit_sweep_LJ_bigdata.log"),
        "permutation": parse_permutation(
            (runs / "lj_chain.log").read_text()),
        "gm": {k: {"gap": v} for k, v in JAX_GM_GAPS.items()},
    }


def card_rows(out=OUT):
    """This port's rows under `out`, in jax_record's layout (a study
    without a file is empty)."""
    def read(name):
        path = out / name
        return json.loads(path.read_text()) if path.exists() else None

    def by_variant(rows):
        return {r["variant"]: r for r in rows or () if "error" not in r}

    return {
        "phi4": by_variant(read("fit_sweep_Phi4.json")),
        "phi4_bigdata": by_variant(read("fit_sweep_Phi4_bigdata.json")),
        "lj": by_variant(read("fit_sweep_LJ.json")),
        "lj_bigdata": by_variant(read("fit_sweep_LJ_bigdata.json")),
        "permutation": read("lj_permutation.json"),
        "permutation_runs": {
            p.stem.removeprefix("lj_permutation_"): json.loads(p.read_text())
            for p in sorted(out.glob("lj_permutation_*.json"))},
        "gm": by_variant(read("gm_fit_sweep.json")),
    }


def holds(rec):
    """Each conclusion of PARITY_RESULTS.md and configs/GaussianMixture.yaml
    as an inequality on one record (jax_record's layout): a list of (hold,
    its statement, the numbers, True / False, or None where a number is
    missing)."""
    def gap(study, variant, key="gap_per_ptcl"):
        r = rec[study].get(variant)
        return None if r is None else r[key]

    def check(name, text, numbers, test):
        if any(v is None for v in numbers.values()):
            return (name, text, numbers, None)
        return (name, text, numbers, bool(test(**numbers)))

    phi = {v: gap("phi4", v) for v in VARIANTS}
    gm = {v: gap("gm", v, "gap") for v in JAX_GM_GAPS}
    nf = {v: (rec["gm"].get(v) or {}).get("rev_zwanzig_nf")
          for v in JAX_GM_GAPS}
    perm = rec["permutation"] or {}
    return [
        check("H1", "Phi4 memorizes with epochs: gap(short) < "
              "gap(baseline) < gap(long)",
              {k: phi[k] for k in ("short", "baseline", "long")},
              lambda short, baseline, long: short < baseline < long),
        check("H2", "capacity does not help Phi4: gap(wide), gap(deep), "
              "gap(bins), gap(big_long) >= gap(baseline) - 0.1",
              {k: phi[k] for k in ("baseline", "wide", "deep", "bins",
                                   "big_long")},
              lambda baseline, **cap: all(v >= baseline - 0.1
                                          for v in cap.values())),
        check("H3", "reverse KL closes Phi4's gap: gap(rkl) < 0.1",
              {"rkl": phi["rkl"]}, lambda rkl: rkl < 0.1),
        check("H4", "4x data closes Phi4's gap: gap(40000 frames) < 0.15",
              {"bigdata": gap("phi4_bigdata", "baseline")},
              lambda bigdata: bigdata < 0.15),
        check("H5", "reverse KL worsens LJ: gap(rkl) > gap(baseline)",
              {"rkl": gap("lj", "rkl"), "baseline": gap("lj", "baseline")},
              lambda rkl, baseline: rkl > baseline),
        check("H6", "4x data does not close LJ's gap: gap(40000 frames) >= "
              "gap(baseline)",
              {"bigdata": gap("lj_bigdata", "baseline"),
               "baseline": gap("lj", "baseline")},
              lambda bigdata, baseline: bigdata >= baseline),
        check("H7", "relabeling atoms to their sites leaves U (within "
              "1e-3) and the gap (recovered share within [-5%, +5%]) "
              "where they were",
              {"u_raw": perm.get("u_raw"), "u_rel": perm.get("u_rel"),
               "recovered_pct": perm.get("recovered_pct")},
              lambda u_raw, u_rel, recovered_pct: abs(u_raw - u_rel) <= 1e-3
              and -5.0 <= recovered_pct <= 5.0),
        check("H8", "depth and budget close GaussianMixture's gap: |ref| > "
              "|2layer_6k| > |4layer_6k| >= |4layer_20k_b256| - 0.05",
              gm, lambda **g: abs(g["ref"]) > abs(g["2layer_6k"])
              > abs(g["4layer_6k"]) >= abs(g["4layer_20k_b256"]) - 0.05),
        check("H8", "reverse Zwanzig near 0: |nf| <= 0.05 in each of the "
              "four", nf, lambda **n: all(abs(v) <= 0.05
                                          for v in n.values())),
    ]


def _fmt(v, f="{:+.3f}"):
    return "—" if v is None else f.format(v)


NOTES = "\n## Notes\n"


def render(out=OUT, path=REPORT, runs=RUNS):
    """FIT_STUDIES_TORCH.md from the card's rows under `out` beside the JAX
    record under `runs`. A report already at `path` keeps its section from
    `## Notes` on (the misses' causes, written by hand)."""
    card_rec, jax_rec = card_rows(out), jax_record(runs)
    cards = set()
    for study in ("phi4", "phi4_bigdata", "lj", "lj_bigdata", "gm"):
        cards |= {r.get("card") for r in card_rec[study].values()}
    if card_rec["permutation"]:
        cards.add(card_rec["permutation"].get("card"))
    cards = sorted(c or "the CPU" for c in cards)

    def launches(r):
        la = (r or {}).get("launches")
        if not la:
            return "—"
        return ", ".join(f"{k} {v}" for k, v in la.items()
                         if k != "accept_unfused")

    lines = [
        "# FIT_STUDIES_TORCH — the fit-quality studies on the card, beside "
        "the JAX package's",
        "",
        "Produced by `tools/torch_fit_sweep.py`, "
        "`tools/torch_gm_fit_sweep.py` and `tools/torch_lj_permutation.py`"
        " on " + (", ".join(f"`{c}`" for c in cards) or "no card yet")
        + " (name, power limit, as `nvidia-smi --query-gpu=name,power.limit"
        " --format=csv,noheader` gives them), from the rows under "
        "`runs/torch_fit/`; rendered by `python tools/torch_fit_sweep.py "
        "--render`. Gaps are kT a particle (GaussianMixture: nats a frame, "
        "as the JAX tool reports). The JAX columns are the JAX package's "
        "own runs on a TPU v5e (`runs/fit_sweep_Phi4.json`, "
        "`runs/fit_sweep_*.log`, `runs/lj_chain.log`, and the four gaps "
        "`configs/GaussianMixture.yaml:7-9` quotes); its seconds are a "
        "TPU's and are not compared. Launches are the card's kernels "
        "(accept_select, rqs, rqs_vjp) in the row, training and "
        "evaluation together.",
        "",
        "## Holds",
        "",
        "| hold | statement | card | met | JAX record | met |",
        "|---|---|---|---|---|---|",
    ]
    jax_holds = {(h[0], h[1]): h for h in holds(jax_rec)}
    verdict = {True: "met", False: "MISSED", None: "no row"}
    for name, text, numbers, ok in holds(card_rec):
        jh = jax_holds.get((name, text))
        nums = ", ".join(f"{k} {_fmt(v, '{:.4g}')}"
                         for k, v in numbers.items())
        jnums = "—" if jh is None else ", ".join(
            f"{k} {_fmt(v, '{:.4g}')}" for k, v in jh[2].items())
        text = text.replace("|", "\\|")  # |x| inside a table cell
        lines.append(f"| {name} | {text} | {nums} | {verdict[ok]} | "
                     f"{jnums} | {verdict[None if jh is None else jh[3]]} |")

    def sweep_table(title, study, jax_study, note):
        lines.extend(["", f"## {title}", "", note, "",
                      "| variant | layers | bins | hidden | epochs | rkl | "
                      "frames (train, test) | gap kT/ptcl | JAX gap | "
                      "train s | launches |",
                      "|---|---|---|---|---|---|---|---|---|---|---|"])
        names = list(dict.fromkeys(list(card_rec[study])
                                   + list(jax_rec[jax_study])))
        for v in names:
            r, j = card_rec[study].get(v), jax_rec[jax_study].get(v)
            src = r or j
            fl = src["flow"]
            frames = (r or {}).get("frames")
            lines.append(
                f"| {v} | {fl['nlayers']} | {fl['nsplines']} | "
                f"{fl['hidden_dim']} | {src['epochs']} | "
                f"{src['rkl_steps']} | "
                f"{'—' if not frames else tuple(frames)} | "
                f"{_fmt((r or {}).get('gap_per_ptcl'))} | "
                f"{_fmt((j or {}).get('gap_per_ptcl'))} | "
                f"{(r or {}).get('train_s', '—')} | {launches(r)} |")

    sweep_table("Phi4 (configs/Phi4.yaml: SplineAR dim 64, K = 16)",
                "phi4", "phi4",
                "`python tools/torch_fit_sweep.py <copy of Phi4.yaml>` on "
                "10000 frames of `apps.sample_data` (8000 train, 2000 "
                "test). JAX: `runs/fit_sweep_Phi4.json`.")
    sweep_table("Phi4, 4x data", "phi4_bigdata", "phi4_bigdata",
                "`apps.sample_data <copy> 40000`, then `--variants "
                "baseline`. JAX: `runs/fit_sweep_Phi4_bigdata.log`.")
    sweep_table("LJ (configs/LJ.yaml: 32 atoms, K = 32, hidden 354)",
                "lj", "lj",
                "`--variants baseline,rkl` on 10000 frames, no mixer (as "
                "the JAX tool trains). JAX: `runs/fit_sweep_LJ.log` (its "
                "`rkl` row only).")
    sweep_table("LJ, 4x data", "lj_bigdata", "lj_bigdata",
                "`apps.sample_data <copy> 40000`, then `--variants "
                "baseline`. JAX: `runs/fit_sweep_LJ_bigdata.log`.")

    perm, jperm = card_rec["permutation"] or {}, jax_rec["permutation"] or {}
    runs_ = card_rec["permutation_runs"]
    lines.extend([
        "", "## LJ permutation diagnostic", "",
        "`tools/torch_lj_permutation.py` on LJ trained by `apps.train "
        "--hmc-mix` (8000 epochs) on 10000 frames; the held-out frames' "
        "atoms relabeled to their lattice sites (Hungarian assignment, "
        "minimum image). The hold reads the config's seed (0). Beside it, "
        "`lj_permutation_<label>.json`: the same data trained from another "
        "seed (`seed<N>`, `seed: N` in the config copy) or under "
        "`tools/torch_bf16_train.py` (`bf16`: the conditioners' matmuls at "
        "a TPU's default precision), or the seed-0 flow on 2000 frames of "
        "256 new chains (`independent`: `apps.sample_data <copy> 2000 "
        "--seed 100 --test-only`) in place of the testing_data, whose "
        "frames are the last draws of the training data's own chains. "
        "JAX: `runs/lj_chain.log`.", "",
        "| | card | " + "".join(f"card, {k} | " for k in runs_)
        + "JAX |", "|---|---|" + "---|" * len(runs_) + "---|"])
    for key, label, f in (
            ("frames", "held-out frames", "{}"),
            ("n_permuted", "frames with a non-identity assignment", "{}"),
            ("mean_moved", "mean atoms off their own site", "{:.1f}"),
            ("u_raw", "mean U raw", "{:.3f}"),
            ("u_rel", "mean U relabeled", "{:.3f}"),
            ("logp_gen", "mean flow logp, generated", "{:.2f}"),
            ("logp_raw", "held-out raw", "{:.2f}"),
            ("logp_rel", "held-out relabeled", "{:.2f}"),
            ("recovered_pct", "share of the gap recovered, %", "{:.1f}")):
        lines.append(f"| {label} | {_fmt(perm.get(key), f)} | " + "".join(
            f"{_fmt(r.get(key), f)} | " for r in runs_.values())
            + f"{_fmt(jperm.get(key), f)} |")
    if perm:
        lines.append(f"| launches | {launches(perm)} | " + "".join(
            f"{launches(r)} | " for r in runs_.values()) + "— |")

    lines.extend([
        "", "## GaussianMixture", "",
        "`python tools/torch_gm_fit_sweep.py <variants>`: every variant's "
        "overrides over the reference's hyperparameters (1 layer, 2000 "
        "epochs, batch 40, exponential decay), on which the JAX sweep ran; "
        "the shipped config now carries its winner. Gap: mean flow logp of "
        "2000 flow draws minus that of 2000 exact target draws, nats a "
        "frame; nf: reverse Zwanzig a particle (exact answer 0). JAX: the "
        "four gaps `configs/GaussianMixture.yaml:7-9` quotes.", "",
        "| variant | overrides | gap | JAX gap | nf | train s | launches |",
        "|---|---|---|---|---|---|---|"])
    names = list(dict.fromkeys(list(JAX_GM_GAPS) + list(card_rec["gm"])))
    for v in names:
        r, j = card_rec["gm"].get(v) or {}, jax_rec["gm"].get(v) or {}
        lines.append(
            f"| {v} | {json.dumps(r.get('overrides', '—'))} | "
            f"{_fmt(r.get('gap'))} | {_fmt(j.get('gap'), '{:+.2f}')} | "
            f"{_fmt(r.get('rev_zwanzig_nf'), '{:+.4f}')} | "
            f"{r.get('train_s', '—')} | {launches(r)} |")
    text = "\n".join(lines) + "\n"
    old = Path(path).read_text() if Path(path).exists() else ""
    if NOTES in old:
        text += old[old.index(NOTES):]
    Path(path).write_text(text)


if __name__ == "__main__":
    sys.exit(main())
