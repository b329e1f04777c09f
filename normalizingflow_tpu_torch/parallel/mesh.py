"""Process groups and batch sharding on torch.distributed.

Twin of normalizingflow_tpu/parallel/mesh.py. JAX lays a `Mesh` over its
devices and lets XLA insert every collective from sharding annotations.
PyTorch has no such compiler pass, so a `Mesh` here is one rank's view of
a 1-D mesh: its process group, rank, world size and device, and the three
collectives the sharded paths write out by hand (a batch mean, a sum and
an all-gather over the batch axis, plus a broadcast from the mesh's first
rank). A mesh over no process group is one rank with no collective, what a
JAX mesh over one device is.

A batch is sharded by rows: rank r owns rows [r * n / W, (r + 1) * n / W)
of a global batch of n, and n must be a multiple of the world size W
(`pad_to_multiple`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import entry_device


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda"):
    """Join the default process group (no-op for a single process).

    `coordinator_address` is the rendezvous: `host:port` (TCP) or an init
    URL (`tcp://...`, `file://...`). The backend is NCCL on CUDA, gloo when
    `device` is the CPU."""
    if num_processes is None or num_processes <= 1:
        return
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


class Mesh:
    """One rank's view of a 1-D mesh over `group` (None: the default group,
    or one rank with no collective when no group is initialized).

    `device` defaults to `cuda:<local rank>`, the rank modulo the host's
    cards; pass "cpu" for gloo on the CPU."""

    def __init__(self, group=None, axis_name="chains", device=None):
        self.group = group
        self.axis_name = axis_name
        self.distributed = dist.is_available() and dist.is_initialized()
        if self.distributed:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.src = 0 if group is None else dist.get_global_rank(group, 0)
        else:
            self.rank, self.size, self.src = 0, 1, 0
        if device is None:
            device = "cuda"
            if torch.cuda.is_available():
                device = f"cuda:{self.rank % torch.cuda.device_count()}"
        self.device = entry_device(device)

    def __repr__(self):
        return (f"Mesh({self.axis_name!r}, rank {self.rank} of {self.size}, "
                f"{self.device})")

    def rows(self, n):
        """The slice of a global batch of `n` rows this rank owns."""
        if n % self.size:
            raise ValueError(
                f"a batch of {n} does not split over {self.size} ranks; "
                f"pad it to pad_to_multiple({n}, {self.size}) = "
                f"{pad_to_multiple(n, self.size)}")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum(self, t):
        """The SUM all-reduce of `t` (a new tensor)."""
        t = t.clone()
        if self.distributed:
            dist.all_reduce(t, dist.ReduceOp.SUM, group=self.group)
        return t

    def mean(self, x):
        """Mean over the global batch of the rank's rows `x` (dim 0): a SUM
        all-reduce over the global count (gloo has no ReduceOp.AVG). Every
        rank holds as many rows."""
        return self.sum(torch.sum(x, dim=0)) / (x.shape[0] * self.size)

    def all_gather(self, x):
        """The global batch of every rank's rows `x`, in rank order."""
        if not self.distributed:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def broadcast(self, t):
        """The mesh's first rank's `t`, on every rank (a new tensor)."""
        t = t.clone()
        if self.distributed:
            dist.broadcast(t, self.src, group=self.group)
        return t


def make_mesh(axis_name="chains", device=None):
    """A 1-D mesh over the default group, or a one-rank mesh with no
    collective when no group is initialized."""
    return Mesh(None, axis_name, device)


def make_mesh_2d(shape, axis_names=("data", "chains"), device=None):
    """A 2-D mesh of shape (a, b) over the default group's a * b ranks,
    rank = i * b + j: returns {axis name: this rank's 1-D Mesh along it},
    the first axis over the ranks of column j, the second over those of
    row i. Every rank must call it, as `torch.distributed.new_group`
    requires."""
    a, b = shape
    if not (dist.is_available() and dist.is_initialized()):
        if a * b != 1:
            raise ValueError(f"a {a} x {b} mesh needs {a * b} ranks; no "
                             f"process group is initialized")
        return {name: Mesh(None, name, device) for name in axis_names}
    if a * b != dist.get_world_size():
        raise ValueError(f"a {a} x {b} mesh needs {a * b} ranks, the "
                         f"group has {dist.get_world_size()}")
    rank = dist.get_rank()
    cols = [dist.new_group([i * b + j for i in range(a)]) for j in range(b)]
    rows = [dist.new_group([i * b + j for j in range(b)]) for i in range(a)]
    return {axis_names[0]: Mesh(cols[rank % b], axis_names[0], device),
            axis_names[1]: Mesh(rows[rank // b], axis_names[1], device)}


def batch_sharding(mesh, n):
    """The rows [lo, hi) of a global batch of `n` that this rank owns, as a
    slice (JAX: the NamedSharding splitting axis 0 over the mesh)."""
    return mesh.rows(n)


def replicated(mesh, t):
    """`t` as the mesh's first rank holds it, on every rank (JAX: the
    replicated sharding; here the one broadcast that makes it true)."""
    return mesh.broadcast(t)


def shard_batch(mesh, x):
    """This rank's rows of the global batch `x` (batch, ...), on the mesh's
    device. Raises unless the world size divides the batch."""
    return x[mesh.rows(x.shape[0])].to(mesh.device)


def pad_to_multiple(n, k):
    """Smallest multiple of k that is >= n (chain counts must divide the
    mesh axis evenly)."""
    return int(-(-n // k) * k)
