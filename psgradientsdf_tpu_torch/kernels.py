"""Builds and loads the package's hand-written native code.

Each source under csrc/ becomes a shared library with a plain C interface,
loaded with ctypes: a CUDA source (.cu: the row copies, the Gauss-Newton
solve, the fusion update, the refinement's residual pass and distance
Jacobian, the distance block's assembled system and CG, its regularizer
operators and update, the pose and light normal equations, the albedo
block's system and CG, the culled fusion's cull and compaction, the scan's
preprocessing, the refinement's energies, the SH light's eigen-solve)
is compiled with nvcc
for sm_90a, a host C++ source (.cpp: the PNG unfilter, marching cubes and
the PLY writers) with g++.  The build happens at first use, from the
sources in this package and nothing else, into build/ beside them (ignored
by git); the library's file name carries a hash of its source (a CUDA
source's with every header under csrc/, *.cuh, that it may include), so an
edited source or header is rebuilt and a built one is reused.  The hash
also covers the compiler's command line and its --version output, so a
changed flag or another compiler (a build directory copied from another
machine) builds anew.  A
build or load failure raises with the compiler's output; nothing falls back
to another path.

Nothing here runs when the module is imported: machines without nvcc import
the package freely and only fail when a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

# the package's CUDA kernels, one source each (csrc/<name>.cu): the first of
# them asked for starts nvcc on every one not yet built, all together
CUDA_LIBRARIES = ("rowcopy", "gn", "fuse", "residual", "distcg", "normaleq",
                  "albedo", "cull", "preprocess", "energy", "distreg",
                  "smallsolve")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


def _find_nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "are compiled from csrc/ at first use and need the CUDA toolkit")


def _find_gxx() -> str:
    cand = shutil.which("g++")
    if cand:
        return cand
    raise KernelBuildError(
        "g++ not found on PATH: the host libraries are compiled from csrc/ "
        "at first use and need a C++17 compiler")


def source_path(name: str) -> str:
    """csrc/<name>.cu or csrc/<name>.cpp, whichever exists."""
    for ext in (".cu", ".cpp"):
        path = os.path.join(CSRC_DIR, name + ext)
        if os.path.isfile(path):
            return path
    raise KernelBuildError(f"no source csrc/{name}.cu or csrc/{name}.cpp")


def _compiler(src: str):
    """(compiler, flags) for a source: nvcc for .cu, g++ for .cpp."""
    if src.endswith(".cu"):
        return _find_nvcc(), NVCC_FLAGS
    return _find_gxx(), GXX_FLAGS


@functools.lru_cache(maxsize=None)
def _compiler_version(compiler: str) -> bytes:
    """`compiler --version`, read once per process."""
    return subprocess.run([compiler, "--version"], capture_output=True,
                          check=True).stdout


def cuda_headers() -> list:
    """The headers the CUDA sources may include (csrc/*.cuh), sorted."""
    return sorted(os.path.join(CSRC_DIR, n) for n in os.listdir(CSRC_DIR)
                  if n.endswith(".cuh"))


def library_path(name: str) -> str:
    """Where the library built from csrc/<name>.cu or .cpp lives: its name
    hashes the source (a CUDA source with every csrc/*.cuh header), the
    compiler's command line and its --version."""
    src = source_path(name)
    compiler, flags = _compiler(src)
    h = hashlib.sha1()
    for path in [src] + (cuda_headers() if src.endswith(".cu") else []):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(flags).encode())
    h.update(_compiler_version(compiler))
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def start_build(name: str):
    """Start nvcc (.cu) or g++ (.cpp) for csrc/<name>; returns (process,
    tmp_path, final_path) or None when the library is already built.  Several
    sources are built in parallel by starting them all before finishing any
    (finish_build)."""
    out = library_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src = source_path(name)
    compiler, flags = _compiler(src)
    cmd = [compiler, *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(name: str, started) -> str:
    if started is None:
        return library_path(name)
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0 or not os.path.isfile(tmp):
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            f"{os.path.basename(proc.args[0])} failed on csrc/"
            f"{os.path.basename(source_path(name))} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes library built from csrc/<name>.cu or .cpp (built on first
    call; a CUDA library's first call builds the other CUDA_LIBRARIES
    beside it, one nvcc process a source)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            group = CUDA_LIBRARIES if name in CUDA_LIBRARIES else (name,)
            started = {n: start_build(n) for n in group}
            built = {n: finish_build(n, job) for n, job in started.items()}
            path = built[name]
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """The SMs of the CUDA device `dev` (a torch.device), read once a device:
    the host plans of the launches are functions of it."""
    import torch

    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)
