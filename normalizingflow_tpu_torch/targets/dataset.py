"""Trajectory-dataset targets (the reference's `SimData`).
Twin of normalizingflow_tpu/targets/dataset.py.

A trajectory is loaded from .xyz / .npy / .pt into one (frames, flat_dim)
tensor on the dataset's device. `sample` gathers rows there: random rows
with replacement from an explicit `torch.Generator`, given rows `idx` (so a
test can replay the JAX package's indices), or the head of the trajectory.
`TrajectoryTarget` attaches one to a physical target (LJ, EAM, phi^4).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Target


def load_trajectory(path, data_type="xyz"):
    """Load a trajectory file -> np.ndarray (n_frames, flat_dim)."""
    if data_type == "xyz":
        from ..io.xyz import read_xyz

        traj = read_xyz(path)  # (frames, atoms, 3)
        return traj.reshape(len(traj), -1)
    if data_type == "npy":
        arr = np.load(path)
        return arr.reshape(len(arr), -1)
    if data_type == "pt":
        arr = torch.load(path, map_location="cpu")
        arr = arr.detach().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        return arr.reshape(len(arr), -1)
    raise ValueError(f"unknown data_type {data_type!r}")


class TrajectoryDataset:
    """Dataset-backed sampler with the reference's SimData interface."""

    def __init__(self, path=None, data_type="xyz", data=None, device=None,
                 dtype=None):
        self.data_type = data_type
        self.device = torch.device(device or "cpu")
        self.dtype = dtype or torch.get_default_dtype()
        self.traj = None
        if data is not None or path is not None:
            self.update_data(path, data)

    @property
    def dim(self):
        return None if self.traj is None else self.traj.shape[1]

    def _as_rows(self, path, data):
        if data is None:
            data = load_trajectory(path, self.data_type)
        rows = torch.as_tensor(np.asarray(data) if not isinstance(
            data, torch.Tensor) else data)
        return rows.reshape(len(rows), -1).to(self.device, self.dtype)

    def sample(self, nsamples, generator=None, random=True, idx=None):
        """(nsamples, dim) rows: `idx` if given, else random rows with
        replacement (random=True) or the first nsamples."""
        if idx is None and not random:
            return self.traj[:nsamples]
        if idx is None:
            idx = torch.randint(0, self.traj.shape[0], (nsamples,),
                                generator=generator, device=self.device)
        return self.traj[torch.as_tensor(idx, device=self.device)]

    def update_data(self, path=None, data=None, append=False):
        """Replace or append trajectory data."""
        new = self._as_rows(path, data)
        if append and self.traj is not None:
            self.traj = torch.cat([self.traj, new], dim=0)
        else:
            self.traj = new

    def __len__(self):
        return 0 if self.traj is None else int(self.traj.shape[0])


class TrajectoryTarget(Target):
    """A physical target that can carry a trajectory (the reference's
    System + SimData hybrid), so it doubles as the training CLI's data
    source: `sample` draws frames from the attached TrajectoryDataset,
    `update_data` replaces or extends it. Subclasses call `_attach` from
    their constructor."""

    def _attach(self, pos_dir, data_type, device, dtype):
        self.data_type = data_type
        self.data_device, self.data_dtype = device, dtype
        self.dataset = None
        if pos_dir:
            self.update_data(pos_dir)

    def sample(self, nsamples, generator=None, **kw):
        if self.dataset is None:
            raise ValueError(
                f"{type(self).__name__} has no attached trajectory data; "
                f"generate one with apps.sample_data or pass pos_dir")
        return self.dataset.sample(nsamples, generator=generator, **kw)

    def update_data(self, path=None, data=None, append=False):
        if self.dataset is None:
            self.dataset = TrajectoryDataset(
                path, self.data_type, data=data, device=self.data_device,
                dtype=self.data_dtype)
        else:
            self.dataset.update_data(path, data=data, append=append)
