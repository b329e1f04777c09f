"""Build the package's CUDA kernels with nvcc at first use and load them.

Each `csrc/<name>.cu` exposes a plain C interface and becomes its own
shared library, compiled for sm_90a into `_build/` inside the package
(listed in .gitignore). The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale build is never
loaded. `build` starts one nvcc per missing library, all at once. Another
`source_dir` builds the sources there the same way (tools build edited
copies of a kernel so).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# No --use_fast_math: the kernels rely on IEEE NaN/inf semantics.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBRARIES = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name, source_dir=SOURCE_DIR):
    src = Path(source_dir) / f"{name}.cu"
    digest = hashlib.sha1(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names, source_dir=SOURCE_DIR):
    """Compile every library in `names` (`<source_dir>/<name>.cu`) that is
    not built yet, in parallel.

    Returns {name: nvcc's report (ptxas registers and spills), or "" if the
    library was already built}. Raises if any compile fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name, source_dir)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(Path(source_dir) / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        report, _ = proc.communicate()
        reports[name] = report
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{report}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name, source_dir=SOURCE_DIR):
    """The loaded ctypes library for `<source_dir>/<name>.cu`, built if
    needed."""
    key = (name, str(source_dir))
    lib = _LIBRARIES.get(key)
    if lib is None:
        build([name], source_dir)
        lib = _LIBRARIES[key] = ctypes.CDLL(
            str(library_path(name, source_dir)))
    return lib
