"""Tracing, throughput counters and a debug mode.

Twin of normalizingflow_tpu/utils/profiling.py, on torch.profiler:

  * `trace(log_dir)`: a profile of a region, CPU and CUDA activity,
    written into `log_dir` as a Chrome trace (chrome://tracing, Perfetto);
  * `annotate(name)`: a named range in that trace (record_function);
  * `StepTimer`: wall clock and throughput, each `tick` waiting for the
    device that holds its `result`, as JAX's block_until_ready;
  * `debug_mode()`: autograd anomaly detection, which names the forward
    operation of a backward that made NaN.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the region into `log_dir/trace_<pid>_<ns>.json`. CUDA
    activity is recorded where a card is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name):
    """A named range inside a trace."""
    return torch.profiler.record_function(name)


def _synchronize(result):
    """Wait for every CUDA device that holds a tensor of `result` (a
    tensor, or a tuple, list or dict of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """Throughput counter: call .tick(n_items, result) per step; read
    .rate()."""

    def __init__(self):
        self.t0 = time.time()
        self.items = 0
        self.steps = 0

    def tick(self, n_items=1, result=None):
        if result is not None:
            _synchronize(result)
        self.items += n_items
        self.steps += 1

    def rate(self):
        dt = max(time.time() - self.t0, 1e-9)
        return {"steps_per_s": self.steps / dt,
                "items_per_s": self.items / dt,
                "elapsed_s": dt}


@contextlib.contextmanager
def debug_mode():
    """Autograd anomaly detection over the region: a backward that makes
    NaN raises, naming the forward operation. JAX's debug_mode also turns
    its fused Pallas path off; the port has no such switch, so the CUDA
    kernels stay on."""
    with torch.autograd.set_detect_anomaly(True):
        yield
