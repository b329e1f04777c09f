"""The readings that a cell's limits are set from: the cell's run on many
seeds, with the program, with the reference in its place in the lower
precision (the control), or with a fault planted (nfbench/faults.py), all
in one process; one JSON line a run on stdout.

    python3 -m nfbench.readings --workload <name> --seed <first> \
        --seconds <s> --runs port:12,control:3,half:3 [--device cuda]

Seeds run from --seed up. The benchmark's own runs never do this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nfbench import faults, run
from nfbench.kinds import fkl_train, neutra_hmc, nf_sample, rkl_train

SYSTEMS = {
    "neutra_hmc": {"port": None, "control": neutra_hmc.Reference,
                   "stuck": faults.StuckHMC, "half": faults.HalfBatchHMC,
                   "altered": faults.AlteredHMC},
    "fkl_train": {"port": None, "control": fkl_train.Reference,
                  "stuck": faults.StuckFKL, "half": faults.HalfBatchFKL},
    "rkl_train": {"port": None, "control": rkl_train.Reference,
                  "stuck": faults.StuckRKL, "half": faults.HalfBatchRKL},
    "nf_sample": {"port": None, "control": nf_sample.Reference,
                  "altered": faults.AlteredSample},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--runs", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = run.load_bench()
    seed = args.seed
    for part in args.runs.split(","):
        kind, count = part.split(":")
        for _ in range(int(count)):
            t0 = time.perf_counter()
            cell = run.Cell(bench, args.workload, seed, args.seconds, 0,
                            args.device, t_start=t0)
            systems = SYSTEMS[cell.traffic["kind"]]
            line = run.run_cell(bench, cell, systems[kind])
            print(json.dumps({"seed": seed, "system": kind,
                              "correct": line["correct"],
                              "units": line["attempted"],
                              "metrics": {k: v["value"] for k, v in
                                          line["metrics"].items()},
                              "checks": {k: v["value"] for k, v in
                                         line["checks"].items()},
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            seed += 1
            if cell.device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
