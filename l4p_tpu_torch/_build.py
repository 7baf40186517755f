"""Builds the port's CUDA sources (``csrc/*.cu``) at first use.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
object with a plain C interface and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds. Outputs go to
``l4p_tpu_torch/build/``, named by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused. `build_all` runs one nvcc per library, all at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the build log
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_name_locks: Dict[str, threading.Lock] = {}


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def nvcc_flags() -> tuple:
    """NVCC_FLAGS, plus -DL4P_BARRIER_WATCHDOG under L4P_BARRIER_WATCHDOG=1:
    a debug build whose mbarrier waits trap after 10 s (csrc/sm90.cuh)
    instead of hanging. It is named apart from the main build by its flags."""
    debug = os.environ.get("L4P_BARRIER_WATCHDOG") == "1"
    return NVCC_FLAGS + (("-DL4P_BARRIER_WATCHDOG",) if debug else ())


def nvcc_command(nvcc: str, sources: Sequence[str], out: str, defines: Sequence[str] = ()) -> list:
    return [nvcc, *nvcc_flags(), *(f"-D{d}" for d in defines), "-o", out, *sources]


def library_path(name: str, sources: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(nvcc_flags()).encode())
    for src in [*sources, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, sources: Sequence[str]) -> str:
    """Compiles `sources` (file names under csrc/) unless an up-to-date
    library exists; returns its path. The compiler's output is written
    beside it as ``<library>.log``."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    out = library_path(name, paths)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            nvcc_command(find_nvcc(), paths, tmp), capture_output=True, text=True, check=False
        )
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Builds (if needed) and loads library `name` once per process; two
    libraries build concurrently, one library once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name, sources))
            _loaded[name] = lib
        return lib


def build_all(libraries: Mapping[str, Sequence[str]]) -> Dict[str, float]:
    """Builds and loads every {name: sources} library, each nvcc in its own
    thread, all started together; returns the seconds each took."""
    def one(item):
        t0 = time.perf_counter()
        load(*item)
        return item[0], time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return dict(pool.map(one, libraries.items()))


def build_log(name: str, sources: Sequence[str]) -> str:
    """The compiler output of the current build of `name` ('' if none)."""
    path = library_path(name, [os.path.join(CSRC_DIR, s) for s in sources]) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
