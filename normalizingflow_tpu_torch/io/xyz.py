"""XYZ / LAMMPS coordinate file I/O. Twin of normalizingflow_tpu/io/xyz.py.

`read_xyz` uses the C++ parser (io/cxyz.cpp, built with g++ at first use)
and falls back to the pure-Python one when the library cannot be built or
loaded; both give the same array. This fallback concerns the file parser
only, never the device.

XYZ format per frame:
    <natoms>
    <comment line>
    <symbol-or-type> x y z     (natoms rows)
"""

from __future__ import annotations

import subprocess

import numpy as np


def _read_xyz_python(path):
    frames = []
    with open(path) as fh:
        while True:
            header = fh.readline()
            if not header.strip():
                break
            natoms = int(header)
            fh.readline()  # comment
            frame = np.empty((natoms, 3), dtype=np.float64)
            for i in range(natoms):
                parts = fh.readline().split()
                frame[i] = [float(parts[1]), float(parts[2]), float(parts[3])]
            frames.append(frame)
    return np.stack(frames) if frames else np.empty((0, 0, 3))


def read_xyz(path, native=True):
    """Read an XYZ trajectory -> (n_frames, n_atoms, 3) float64 array."""
    if native:
        from ._build import read_xyz_native

        try:
            return read_xyz_native(path)
        except (OSError, subprocess.CalledProcessError):
            pass  # no compiler or a file the C parser rejects
    return _read_xyz_python(path)


def write_xyz(path, traj, n_particles, append=False):
    """Write frames in the reference's format (atom type column of 1s,
    5-decimal coordinates)."""
    traj = np.asarray(traj).reshape(-1, n_particles, 3)
    with open(path, "a" if append else "w") as fh:
        for frame in traj:
            fh.write(f"{n_particles}\n Atoms\n")
            for row in frame:
                fh.write(f"1 {row[0]:.5f} {row[1]:.5f} {row[2]:.5f}\n")


def write_lammps_coord(path, traj, n_particles, append=True):
    """LAMMPS-style "id type x y z" rows."""
    traj = np.asarray(traj).reshape(-1, n_particles, 3)
    with open(path, "a" if append else "w") as fh:
        for frame in traj:
            for i, row in enumerate(frame):
                fh.write(f"{i + 1} 1 {row[0]:.5f} {row[1]:.5f} {row[2]:.5f}\n")
