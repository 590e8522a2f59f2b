"""Build and load the CUDA kernels: one nvcc process per source in csrc/,
all started together, compiles each to an object; one more links them into
one shared library with a plain C interface, bound with ctypes.

The library, libhulk_kernels.so, lives in the package's build directory
(gitignored). It is built once per process, at first use, and again only
when a source or header is newer than it. No PyTorch header is compiled, so
a build takes seconds, not the minutes of torch.utils.cpp_extension.

Nothing here runs at import time: the CPU tests import every module, and a
machine without a card need not have nvcc.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict[str, object] = {}
# entries of another build of the kernels that entry() gives while bound()
_bound: dict[str, object] = {}
# what this process's build did: its seconds and ptxas's register/spill
# lines; None while the library was current
build_report: tuple[float, str] | None = None


def build_dir() -> str:
    """Where the kernels and the native host runtime are built."""
    return os.path.join(_PKG, "build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the card's machine")


def compile_library(sources: list[str], so: str) -> None:
    """Compile the CUDA sources into the shared library `so`."""
    global build_report
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    link = subprocess.run([_nvcc(), "-shared", "-o", f"{tmp}.so", *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(f"{tmp}.so", so)
    ptxas = "\n".join(
        line.strip() for log in logs for line in log.splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
    )
    build_report = (time.perf_counter() - t0, ptxas)


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if any source is newer."""
    global _lib
    with _lock:
        if _lib is None:
            sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
            headers = glob.glob(os.path.join(CSRC, "*.cuh"))
            so = os.path.join(build_dir(), "libhulk_kernels.so")
            if not os.path.exists(so) or os.path.getmtime(so) < max(
                    os.path.getmtime(s) for s in sources + headers):
                compile_library(sources, so)
            _lib = ctypes.CDLL(so)
        return _lib


def bind(lib: ctypes.CDLL, name: str, argtypes: list):
    """The C entry `name` of the loaded library `lib`, bound with its
    argtypes (ctypes.c_void_p for every pointer and the stream)."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def entry(name: str, argtypes: list):
    """The C entry `name` of the kernel library, bound once."""
    fn = _bound.get(name) or _entries.get(name)
    if fn is None:
        fn = _entries[name] = bind(load(), name, argtypes)
    return fn


@contextlib.contextmanager
def bound(entries: dict):
    """Within the block, entry(name) gives entries[name]: the wrappers then
    launch another build's kernels (scripts/kernel_retime.py times a parent
    build against this one through the same Python)."""
    _bound.update(entries)
    try:
        yield
    finally:
        for name in entries:
            _bound.pop(name, None)


def count_launch(launches: dict, name: str) -> None:
    """launches[name] += 1, under a lock: the sharded stream launches from
    one thread per device."""
    with _count_lock:
        launches[name] += 1


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
