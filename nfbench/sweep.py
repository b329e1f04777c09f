"""The size sweep: one cell at each of several sizes of its traffic's
`size_key` (chains or batch), each a traced run of a short window; one
JSON line a size on stdout: the run's result line, with the size and the
rate of the whole window.

    python3 -m nfbench.sweep --workload <name> --sizes 8192,16384,... \
        --seconds 6 [--seed 1]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nfbench import run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sizes", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    for size in (int(s) for s in args.sizes.split(",")):
        cell = run.Cell(bench, args.workload, args.seed, args.seconds, 1,
                        "cuda", t_start=time.perf_counter())
        key = cell.traffic["size_key"]
        cell.traffic[key] = size
        line = run.run_cell(bench, cell)
        print(json.dumps(dict(
            line, workload=args.workload, size_key=key, size=size,
            units_per_s=line["attempted"] / line["window_s"])), flush=True)
        del cell, line
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
