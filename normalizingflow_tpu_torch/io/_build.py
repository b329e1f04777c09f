"""Build of the native XYZ parser (io/cxyz.cpp) at first use.

Twin of normalizingflow_tpu/io/_build.py. g++ compiles the source once per
source hash into the package's `_build/` directory (listed in .gitignore),
which the CUDA kernels share; ctypes loads it. Plain C ABI, no pybind11.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cxyz.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"

_lock = threading.Lock()
_lib = None


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libcxyz-{digest}.so"


def load():
    """Build (if needed) and load the native library. Raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                            str(SOURCE)], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.cxyz_read.restype = ctypes.c_int
        lib.cxyz_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.cxyz_free.restype = None
        lib.cxyz_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return lib


def read_xyz_native(path):
    """Parse an XYZ trajectory with the C++ parser -> (frames, atoms, 3)."""
    lib = load()
    data = ctypes.POINTER(ctypes.c_double)()
    n_frames = ctypes.c_long()
    n_atoms = ctypes.c_long()
    rc = lib.cxyz_read(os.fsencode(path), ctypes.byref(data),
                       ctypes.byref(n_frames), ctypes.byref(n_atoms))
    if rc != 0:
        raise OSError(f"cxyz_read({path!r}) failed with code {rc}")
    n = n_frames.value * n_atoms.value * 3
    try:
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy() if n else \
            np.empty(0)
    finally:
        lib.cxyz_free(data)
    return arr.reshape(n_frames.value, n_atoms.value, 3)
