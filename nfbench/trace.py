"""The traced window of a `--trace 1` run, and what it reads.

`Tracer` runs torch.profiler (CPU and CUDA activities) from the window's
start over its first `seconds`, stopping at a unit of work's boundary, and
reads the profiler's raw records (no FunctionEvent tree) into a `Summary`:
kernels, device busy time, launches, the benchmark's spans and the
device's idle gaps, each labelled by the span and host operation that
launched the kernel ending it. Spans are the benchmark's own,
`span(name)` around each call into a layer of the program.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from nfbench import yardstick

WINDOW = "nfbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


ANNOTATIONS = {WINDOW}  # the names of every range span() has opened
PROGRAM_RANGES = ("Optimizer.",)  # the program's own: torch.optim's


def span(name):
    """A range the profiler records around a call into the program (a
    no-op while no profiler runs)."""
    ANNOTATIONS.add(name)
    return torch.profiler.record_function(name)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    units: int
    # (name, start_ns, end_ns, launching host op's start_ns)
    kernels: list = field(default_factory=list)
    # (name, start_ns, end_ns) of user ranges: the benchmark's spans and
    # the program's own (torch.optim's Optimizer.step#...)
    ranges: list = field(default_factory=list)
    gaps: dict = field(default_factory=dict)

    @property
    def launches(self):
        return sum(1 for k in self.kernels if k[0] is not None)

    def kernel_seconds(self, pattern):
        """Device seconds of the kernels whose name holds `pattern`, and
        their count."""
        hits = [e - s for name, s, e, _ in self.kernels
                if name and pattern in name]
        return sum(hits) / 1e9, len(hits)

    def seconds_launched_in(self, prefix):
        """Device seconds of the kernels launched while a range whose name
        starts with `prefix` was open on the host."""
        spans = sorted((s, e) for name, s, e in self.ranges
                       if name.startswith(prefix))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0
        for name, s, e, host in self.kernels:
            if name is None or host is None:
                continue
            i = bisect.bisect_right(starts, host) - 1
            if i >= 0 and host <= spans[i][1]:
                total += e - s
        return total / 1e9

    def breakdown(self):
        ops = defaultdict(int)
        for name, s, e, _ in self.kernels:
            ops[name or "memcpy/memset"] += e - s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:64], v / 1e9] for k, v in top],
                "idle_gaps": [[k[:64], v / 1e9] for k, v in gaps]}


class Tracer:
    """Profiles the first `seconds` of the window when `enabled`; a no-op
    otherwise. The traffic's loop calls start() when its window opens and
    tick(n) after each unit of work (n done so far)."""

    def __init__(self, enabled, seconds, device):
        self.enabled = enabled
        self.seconds = seconds
        self.cuda = device.type == "cuda"
        self.prof = None
        self.summary = None
        self._window = None
        self._t0 = None

    @property
    def active(self):
        return self.prof is not None

    def start(self):
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._window = span(WINDOW)
        self._window.__enter__()
        self._t0 = time.perf_counter()

    def tick(self, units):
        if self.active and time.perf_counter() - self._t0 >= self.seconds:
            self.stop(units)

    def stop(self, units):
        if not self.active:
            return
        if self.cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.summary = summarize(self.prof, window_s, units)
        self.prof = None


def _kind(ev):
    """The record's activity: kernel, gpu_memcpy, gpu_memset,
    gpu_user_annotation, user_annotation or a host op. Older torch
    releases have no activity_type(); their records are told apart by
    is_user_annotation() and the copy and set records' names."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    on_host = ev.device_type() == torch.autograd.DeviceType.CPU
    name = ev.name()
    if (getattr(ev, "is_user_annotation", lambda: False)()
            or name in ANNOTATIONS or name.startswith(PROGRAM_RANGES)):
        return "user_annotation" if on_host else "gpu_user_annotation"
    if on_host:
        return "cpu_op"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _times(ev):
    """(start, end) of a record in ns."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.end_ns()
    start = ev.start_us() * 1000
    return start, start + ev.duration_us() * 1000


def summarize(prof, window_s, units):
    """Read the profiler's raw records into a Summary."""
    events = prof.profiler.kineto_results.events()
    host = {}      # correlation id -> (name, start_ns) of host records
    ranges = []
    lo = hi = None
    device = []
    for ev in events:
        kind = _kind(ev)
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            start, end = _times(ev)
            host[ev.correlation_id()] = (ev.name(), start)
            if kind == "user_annotation":
                if ev.name() == WINDOW:
                    lo, hi = start, end
                else:
                    ranges.append((ev.name(), start, end))
        elif kind in DEVICE_ACTIVITIES:
            device.append(ev)
    if lo is None:
        raise RuntimeError("the traced window's range is missing from the "
                           "profiler's records")
    kernels = []
    for ev in device:
        s, e = _times(ev)
        if e <= lo or s >= hi:
            continue
        op = host.get(getattr(ev, "linked_correlation_id", lambda: 0)())
        kernels.append((ev.name() if _kind(ev) == "kernel" else None, s, e,
                        op[1] if op else None, op[0] if op else "-"))
    kernels.sort(key=lambda k: k[1])
    busy = yardstick.union_seconds([(k[1], k[2]) for k in kernels], lo, hi)
    gaps = _idle_gaps(kernels, ranges, lo)
    return Summary(window_s=window_s, busy_s=busy, units=units,
                   kernels=[k[:4] for k in kernels], ranges=ranges,
                   gaps=gaps)


def _idle_gaps(kernels, ranges, lo):
    """Idle device time before each kernel, summed by what the host was
    doing: the benchmark's span holding the launching host op, and that
    op."""
    spans = sorted((s, e, name) for name, s, e in ranges
                   if not name.startswith(PROGRAM_RANGES))
    starts = [s for s, _, _ in spans]
    gaps = defaultdict(int)
    reach = lo
    for name, s, e, host_t, op in kernels:
        if s > reach:
            label = "-"
            if host_t is not None:
                i = bisect.bisect_right(starts, host_t) - 1
                if i >= 0 and host_t <= spans[i][1]:
                    label = spans[i][2]
            gaps[f"{label}/{op}"] += s - reach
        reach = max(reach, e)
    return dict(gaps)

