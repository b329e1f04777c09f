"""One module a kind of traffic, found by the `kind` key of a traffic
file: it makes the inputs from the seed, drives the program's entry point
through set-up and the measured window, and judges what the window
produced against the configuration's plain reference.

Each module here has `run(cell, system=None) -> Outcome`. `system` is
the class of what stands where the program does, built from the cell and
the benchmark's weights: the module's `Port` (the program) by default, its
`Reference` for the control, a broken Port for the fault tests
(nfbench/faults.py)."""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field

import torch


class WindowClosed(Exception):
    """Raised by a feed of inputs when the window's time is up."""


def sub_seed(seed, *tag):
    """A 63-bit seed for the part `tag` of the run seeded `seed`."""
    digest = hashlib.sha256(repr((int(seed),) + tag).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed, *tag):
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tag))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device):
    """Peak bytes allocated on the card since the process started (0 on
    the CPU, which has no such counter)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


@dataclass
class Outcome:
    units: int                       # units of work completed in the window
    window_s: float
    setup_s: float
    memory_peak: int
    e2e: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)   # (name, value)
    layer: dict = field(default_factory=dict)    # inputs of the readers
    trace: object = None             # trace.Summary of a traced run


class Window:
    """The measured window: opens after set-up (a synchronize, then the
    host clock and the tracer), counts units of work, and closes on a
    synchronize."""

    def __init__(self, cell):
        self.cell = cell
        self.units = 0
        self.t0 = None
        self.setup_s = None

    def open(self):
        sync(self.cell.device)
        self.cell.mark("warm")
        self.setup_s = time.perf_counter() - self.cell.t_start
        self.cell.tracer.start()
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0

    def done(self, n=1):
        """n more units are enqueued; True once the window's time is up."""
        self.units += n
        self.cell.tracer.tick(self.units)
        return self.elapsed() >= self.cell.seconds

    def close(self):
        self.cell.tracer.stop(self.units)
        sync(self.cell.device)
        return self.elapsed()
