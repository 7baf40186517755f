"""The port's one boundary to native code: it builds, binds and launches it.

Each CUDA library (``csrc/*.cu``) is compiled by ``nvcc`` for Hopper
(``sm_90a``) at first use into a shared object with a plain C interface,
loaded with ``ctypes`` (nothing includes PyTorch's headers, so a build takes
seconds); native/lib.py's host library goes through `compile_library` with
g++. Outputs go to ``l4p_tpu_torch/build/``, named by a hash of the sources,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one is reused. An `Entry` declares one C entry
point and is bound once, at its first call. Every kernel wrapper in ops/
takes the plain version or the kernel by `route` and launches by `launch`;
ops/recompute.py makes their backward.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in the build log
)
# the letters of an Entry's signature: pointer (a device address, a stream or
# None), int, float, and C-contiguous float32 / uint8 numpy arrays
C_TYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "F": np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
           "U": np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")}

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


def hashed_path(name: str, tag: str, inputs: Sequence[str]) -> str:
    """BUILD_DIR/lib<name>-<hash>.so, the hash of `tag` (the compiler's flags)
    and the bytes of the `inputs`."""
    h = hashlib.sha256(tag.encode())
    for src in inputs:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def library_path(name: str, sources: Sequence[str]) -> str:
    return hashed_path(name, " ".join(nvcc_flags()), [*sources, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))])


def compile_library(out: str, command: Callable[[str], list], what: str, log: bool = False) -> str:
    """Compiles `command(path)` to a private path, renamed to `out` (a
    concurrent build never sees a half-written library), unless `out`
    exists; returns `out`. A failed build raises RuntimeError with the
    compiler's output, which `log` also writes to ``<out>.log``."""
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        cmd = command(tmp)
        compiler = os.path.basename(cmd[0])
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        except FileNotFoundError as e:
            raise RuntimeError(f"{compiler} not found: building {what} needs it") from e
        if log:
            with open(out + ".log", "w") as f:
                f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed building {what}:\n{proc.stdout}{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build(name: str, sources: Sequence[str]) -> str:
    """Compiles `sources` (file names under csrc/) unless an up-to-date
    library exists; returns its path. The compiler's output is written
    beside it as ``<library>.log``."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    return compile_library(library_path(name, paths), lambda tmp: nvcc_command(find_nvcc(), paths, tmp), name, log=True)


def load(name: str, build_library: Callable[[], str]) -> ctypes.CDLL:
    """Builds (if needed) and loads library `name` once per process; two
    libraries build concurrently, one library once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build_library())
        return lib


def build_all(libraries: Mapping[str, Sequence[str]]) -> Dict[str, float]:
    """Builds and loads every {name: sources} library, each nvcc in its own
    thread, all started together; returns the seconds each took."""
    def one(item):
        t0 = time.perf_counter()
        load(item[0], functools.partial(build, *item))
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


class Entry:
    """One C entry point: `symbol` of library `name`, which `build_library()`
    builds and returns the path of, taking arguments of the C_TYPES letters
    of `signature` and returning an int (an error code) or, where `result`
    is None, nothing. Calling it calls the C function, bound at the first
    call."""

    def __init__(self, name: str, build_library: Callable[[], str], symbol: str, signature: str,
                 result: Optional[str] = "i"):
        self.name, self.build_library, self.symbol = name, build_library, symbol
        self.argtypes = [C_TYPES[c] for c in signature]
        self.restype = None if result is None else C_TYPES[result]
        self._fn = None

    def bind(self, path: Optional[str] = None):
        """The typed C function, from this entry's library or, given `path`,
        from that library file (another build of the same source)."""
        lib = load(self.name, self.build_library) if path is None else ctypes.CDLL(path)
        fn = getattr(lib, self.symbol)
        fn.argtypes, fn.restype = self.argtypes, self.restype
        return fn

    def __call__(self, *args):
        if self._fn is None:
            self._fn = self.bind()
        return self._fn(*args)


def kernel(name: str, sources: Sequence[str], symbol: str, signature: str) -> Entry:
    """The Entry of a CUDA kernel's launcher in library `name` (built from
    `sources` under csrc/), whose last argument is the stream."""
    return Entry(name, functools.partial(build, name, tuple(sources)), symbol, signature)


def route(name: str, *operands: Optional[torch.Tensor]) -> str:
    """The path a kernel wrapper takes: "plain" when every operand (None ones
    left out) is on the CPU, "kernel" when all lie on one CUDA device; a
    ValueError naming `name` otherwise."""
    devices = {t.device for t in operands if t is not None}
    if devices == {torch.device("cpu")}:
        return "plain"
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return "kernel"
    raise ValueError(f"{name}: operands must all lie on the CPU or on one CUDA device, got "
                     f"{sorted(str(d) for d in devices)}")


def launch_error(err: int) -> str:
    """The text of a non-zero return of a kernel's launcher."""
    if err < 0:
        return f"a TMA tensor map could not be encoded (CUresult {-err})"
    return f"CUDA error {err}"


def launch(owner: Callable, entry: Entry, device: torch.device, *args, counter: str = "launches") -> None:
    """entry(*args, stream) under `device`'s guard on its current stream;
    a non-zero return raises RuntimeError naming `owner` (the wrapper), and
    a launch adds one to `owner.<counter>`."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{owner.__name__}: kernel launch failed: {launch_error(err)} ({entry.symbol})")
    setattr(owner, counter, getattr(owner, counter) + 1)
