"""Build the port's CUDA sources into shared libraries and load them.

Each ``.cu`` file under a kernel's ``csrc/`` has a plain C interface; it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (named by a hash of the source, the local headers it
includes and the flags, so an edited source or header is rebuilt) at its
first use, and loaded with ``ctypes``.  Nothing here runs
when a module is imported: the CPU tests import every module without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# the kernel packages; each ``<name>/kernel.py`` lists its libraries in
# ``SOURCES`` (library name -> source)
KERNELS = ("flash_attention", "ssd_scan", "rglru_scan")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # library name -> nvcc/ptxas report


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def local_headers(source: Path) -> list[Path]:
    """The files ``source`` includes with ``#include "..."``, and theirs,
    resolved against the including file's directory as nvcc does."""
    found: list[Path] = []
    todo = [Path(source)]
    while todo:
        path = todo.pop()
        for inc in re.findall(r'^#include "([^"]+)"', path.read_text(),
                              flags=re.M):
            header = (path.parent / inc).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def build(source: Path, name: str) -> Path:
    """Compile ``source`` (if its hashed library is missing); returns the path."""
    source = Path(source)
    content = b"".join(p.read_bytes()
                       for p in [source, *local_headers(source)])
    digest = hashlib.sha256(content
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    BUILD_LOG[name] = proc.stdout + proc.stderr
    os.replace(tmp, lib)
    return lib


def load(source: Path, name: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (built on first use, then cached)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(source, name)))
    return _LIBS[name]


def sources() -> dict[str, Path]:
    """Every kernel library's name -> its source."""
    found: dict[str, Path] = {}
    for name in KERNELS:
        mod = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
        found.update(mod.SOURCES)
    return found


def load_all() -> None:
    """Build (one nvcc per missing library, all started together) and load
    every kernel library.  Callers that launch kernels from several threads
    call this first, on one thread: a library is otherwise built at the
    first launch that needs it, and two threads must not both build it."""
    libs = sources()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(build, libs.values(), libs.keys()))
    for name, source in libs.items():
        load(source, name)
