"""Run one cell of the port's benchmark once.

    python3 -m nfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration file, its traffic file
(nfbench/traffic/<traffic>.json, whose `kind` names a module of
nfbench/kinds), its configuration's plain reference
(nfbench/configs/<config>.py), its limits (nfbench/limits/<cell>.json) and
the readers of its per-layer metrics (nfbench/metrics/<metric>.py) are
found by name.

The last line on stdout is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), `device` and, traced, `breakdown`; last, `checks`: each
number compared with its limit. The same numbers end stderr. Exits non-zero,
printing no result, without a CUDA device for each chip the cell asks for,
and when jax, jaxlib, flax or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "normalizingflow_tpu"}

import torch  # noqa: E402

from nfbench import trace as tracing  # noqa: E402


class Cell:
    """One cell's files and this run's arguments."""

    def __init__(self, bench, workload, seed, seconds, trace, device,
                 t_start=T_START, overrides=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.cfg = json.loads((ROOT / entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        for key, values in (overrides or {}).items():
            getattr(self, key).update(values)
        self.ref = load_file(HERE / "configs" / f"{entry['name']}.py",
                             f"nfbench.configs.{entry['name']}")
        limits = HERE / "limits" / f"{workload}.json"
        self.limits = (json.loads(limits.read_text())["limits"]
                       if limits.exists() else {})
        self.seed, self.seconds, self.trace = int(seed), seconds, bool(trace)
        self.device = torch.device(device)
        self.t_start = self._last = t_start
        self.phases = {}
        self.tracer = tracing.Tracer(self.trace,
                                     self.traffic.get("trace_seconds", 3.0),
                                     self.device)


    def mark(self, phase):
        """Close the set-up phase `phase`: its seconds since the last
        mark (the first counts from the process's start)."""
        now = time.perf_counter()
        self.phases[phase] = now - self._last
        self._last = now


def load_file(path, name):
    """The module in the file `path`, imported under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells_reporting(bench, metric):
    """The cells whose line carries the per-layer `metric`: its
    `workloads`, else every cell that reports the metric it moves."""
    if "workloads" in metric:
        return set(metric["workloads"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}[metric["moves"]]
    return set(e2e.get("workloads", [w["name"] for w in bench["workloads"]]))


def judge(cell, checks):
    """[(name, value, limit)] and whether every value lies within its
    limit (a missing limit or a value that is not finite fails)."""
    rows = [(name, value, cell.limits.get(name)) for name, value in checks]
    ok = all(limit is not None and math.isfinite(value) and value <= limit
             for _, value, limit in rows)
    return rows, ok


def run_cell(bench, cell, system=None):
    """Drive the cell; returns the result line (a dict)."""
    kind = importlib.import_module(
        f"nfbench.kinds.{cell.traffic['kind']}")
    if cell.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell.mark("imports")
    out = kind.run(cell, system)
    rows, ok = judge(cell, out.checks)
    if cell.trace:
        metrics = {}
        ctx = Context(cell, out)
        for m in bench["per_layer"]:
            if cell.name not in cells_reporting(bench, m):
                continue
            reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                               f"nfbench.metrics.{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        metrics = {}
        for m in bench["end_to_end"]:
            if cell.name in m.get("workloads", [cell.name]) and \
                    m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": cell.workload["chips"],
              "memory_peak_bytes": out.memory_peak}
    line = {"correct": ok, "attempted": out.units,
            "failed": sum(1 for _, v, lim in rows
                          if lim is None or not v <= lim),
            "metrics": metrics, "device": device}
    line["setup_parts_s"] = cell.phases
    line["window_s"] = out.window_s
    if out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return line


class Context:
    """What a per-layer metric's reader reads: the traced window's Summary
    (`trace`), the traffic kind's inputs for readers (`layer`), and the
    card's peaks."""

    def __init__(self, cell, outcome):
        from nfbench import yardstick

        # a CPU run measures no device: its readers find nothing to read
        self.trace = outcome.trace if cell.device.type == "cuda" else None
        self.layer = outcome.layer
        name = (torch.cuda.get_device_name(cell.device)
                if cell.device.type == "cuda" else None)
        self.peak_fp32 = yardstick.PEAK_FLOPS.get(name, {}).get("fp32")
        self.hbm = yardstick.HBM_BYTES_PER_S.get(name)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The program builds its CUDA libraries into its own package directory;
    # whatever else keeps a cache keeps it at a fixed place in the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(HERE / "_cache" / sub))
    bench = load_bench()
    cell = Cell(bench, args.workload, args.seed, args.seconds, args.trace,
                "cuda")
    chips = cell.workload["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"nfbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    line = run_cell(bench, cell)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"nfbench: loaded {forbidden}, which the port's benchmark "
              f"must not load", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
