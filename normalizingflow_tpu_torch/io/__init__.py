from .xyz import read_xyz, write_lammps_coord, write_xyz

__all__ = ["read_xyz", "write_xyz", "write_lammps_coord"]
