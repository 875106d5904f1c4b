"""Builds the port's CUDA kernels and loads them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ciao_tpu_torch/_build/`` at first use; device code shared by several
kernels lives in ``csrc/*.cuh`` headers. The library's name carries a
hash of the source, the headers it includes (followed through their own
``#include "..."`` lines) and the flags, so an edited source is rebuilt,
a stale library is never loaded, and an edited header rebuilds only the
kernels that include it. Nothing here runs at import time, and
nothing is built on a machine without ``nvcc``: :func:`load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    path, else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of ciao_tpu_torch are "
        "built from source on the machine with the GPU"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def headers(src: Path) -> list[Path]:
    """The ``csrc`` headers that ``src`` includes with ``#include "..."``,
    directly or through other such headers, each once, in the order first
    met."""
    seen: list[Path] = []
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            path = src.parent / inc.decode()
            if path.is_file() and path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path. The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in headers(src):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The compiler's report of the current build of ``name``."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib
