"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources compile with ``nvcc`` straight into a shared library with a
plain C interface, loaded through :mod:`ctypes` (no PyTorch headers, so a
build takes seconds, not minutes).  The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources and flags: a changed source rebuilds, an unchanged one loads
the library already there.  Nothing is built at import time; the first
kernel launch builds.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("nystrom.cu",)
HEADERS = ("affinity_tile.cuh",)
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of nystrom.cu: every pointer and the stream as c_void_p
_SIGNATURES = {
    "rt_quantized_cross_affinity": [_P, _P, _F, _P, _I, _I, _I, _I, _P],
    "rt_nystrom_colsum": [_P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_nystrom_gram": [_P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    "rt_nystrom_extension": [_P, _P, _F, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin"
                          / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(pathlib.Path(on_path))
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels need the CUDA toolkit")


def source_hash() -> str:
    """Hash of every source, header and flag the library is built from."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


class _Library:
    """The loaded kernel library, built on first use (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None   # guarded-by: _lock
        # nvcc's output, with ptxas's registers and spills per kernel
        self.build_log = ""                       # guarded-by: _lock

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, log = _compile()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
                self.build_log = log
            return self._lib


def _compile():
    """nvcc the sources into ``BUILD_DIR``; returns (library path, log)."""
    out = BUILD_DIR / f"librepro_torch_kernels_{source_hash()}.so"
    if out.is_file():
        return out, f"loaded {out.name} (already built)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique temp name + atomic rename: concurrent builders never load a
    # half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


LIBRARY = _Library()


def library() -> ctypes.CDLL:
    """The kernel library, compiled at first call."""
    return LIBRARY.get()


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"(cudaGetLastError)")
