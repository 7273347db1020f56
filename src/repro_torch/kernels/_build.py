"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel source under ``kernels/*/csrc`` has a plain C interface.  On
first use ``nvcc`` compiles it for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (git-ignored), named by a hash of
the source, the shared headers under ``kernels/csrc`` (``hopper.cuh``:
mbarriers, TMA, wgmma) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Nothing here runs at import
time: a host without ``nvcc`` imports every module of the port and only
fails when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
#: headers every kernel source may include (``#include "hopper.cuh"``)
INCLUDE_DIR = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{INCLUDE_DIR}")

_LOCK = threading.Lock()   # guards _BUILD_LOCKS
#: one lock per library, so builds of different libraries run in parallel
_BUILD_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: {"path", "seconds", "log"} of the build that produced it
#: (seconds 0.0 and an empty log when an earlier build was reused)
BUILDS: Dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH, CUDA_HOME or /usr/local/cuda)")


def compile_library(name: str,
                    sources: Sequence[pathlib.Path]) -> pathlib.Path:
    """Compile ``sources`` into ``build/kernels/<name>-<hash>.so``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(INCLUDE_DIR.glob("*.cuh"))]:
        digest.update(pathlib.Path(src).read_bytes())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        BUILDS[name] = {"path": str(out), "seconds": 0.0, "log": ""}
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    BUILDS[name] = {"path": str(out), "seconds": seconds,
                    "log": proc.stdout + proc.stderr}
    return out


def load_library(name: str, sources: Sequence[pathlib.Path]) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; cached per process.
    Threads loading different libraries compile them concurrently."""
    with _LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            path = compile_library(name, sources)
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
