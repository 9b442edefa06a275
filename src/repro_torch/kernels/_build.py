"""Build and load the hand-written CUDA kernels (``csrc/``).

Each source compiles with ``nvcc`` straight into a shared library with a
plain C interface, loaded through :mod:`ctypes` (no PyTorch headers, so a
build takes seconds, not minutes).  The nvcc processes of all sources
start together and run in parallel.  The libraries land in
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
HEADERS = ("affinity_tile.cuh",)
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# the C entry points of each source: every pointer and the stream as
# c_void_p, a stride array as a pointer to c_longlong
_SIGNATURES = {
    "nystrom.cu": {
        "rt_quantized_cross_affinity": [_P, _P, _F, _P, _I, _I, _I, _I, _I,
                                        _P],
        "rt_nystrom_colsum": [_P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
        "rt_nystrom_gram": [_P, _P, _F, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P],
        "rt_nystrom_extension": [_P, _P, _F, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
        "rt_panel_matmul": [_P, _P, _P, _I, _I, _I, _P],
    },
    "affinity.cu": {
        "rt_pairwise_sq_dists": [_P, _P, _P, _I, _I, _I, _I, _P],
        "rt_rbf_cross_affinity": [_P, _P, _F, _P, _I, _I, _I, _I, _P],
        "rt_rbf_affinity": [_P, _F, _P, _I, _I, _I, _P],
    },
    "flash_attention.cu": {
        "rt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _STRIDES, _P],
    },
    "ssd.cu": {
        "rt_ssd_chunk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    },
}
SOURCES = tuple(_SIGNATURES)


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


class Kernels:
    """The C entry points of every loaded library, as attributes."""

    def __init__(self, libraries):
        self.libraries = libraries        # keeps the CDLLs alive
        for source, lib in libraries.items():
            for name, argtypes in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, name, fn)


class _Library:
    """The loaded kernel libraries, built on first use (thread-safe).

    The build runs outside ``_lock``, which guards only the two fields:
    a caller holding another lock (a serving thread's scheduler lock)
    never waits on nvcc under this one.  Two threads that both miss
    build twice; the atomic rename in :func:`_compile` makes that safe,
    and the first library loaded is the one kept.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: Optional[Kernels] = None   # guarded-by: _lock
        # nvcc's output, with ptxas's registers and spills per kernel
        self.build_log = ""                       # guarded-by: _lock

    def get(self) -> Kernels:
        with self._lock:
            kernels = self._kernels
        if kernels is not None:
            return kernels
        paths, log = _compile()
        built = Kernels({src: ctypes.CDLL(str(path))
                         for src, path in paths.items()})
        with self._lock:
            if self._kernels is None:
                self._kernels = built
                self.build_log = log
            return self._kernels


def _compile():
    """nvcc every source into ``BUILD_DIR``, all in parallel; returns
    ({source: library path}, log)."""
    tag = source_hash()
    outs = {src: BUILD_DIR / f"librepro_torch_{pathlib.Path(src).stem}_"
                             f"{tag}.so" for src in SOURCES}
    todo = {src: out for src, out in outs.items() if not out.is_file()}
    logs = [f"loaded {out.name} (already built)"
            for src, out in outs.items() if src not in todo]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        for src, out in todo.items():
            # unique temp name + atomic rename: concurrent builds never
            # load a half-written library
            tmp = out.with_suffix(
                f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs[src] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failures = []
        for src, (cmd, tmp, proc) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed (exit {proc.returncode}): "
                                f"{' '.join(cmd)}\n{stderr}")
                continue
            os.replace(tmp, todo[src])
            logs.append(stdout + stderr)
        if failures:
            raise KernelBuildError("\n".join(failures))
    return outs, "\n".join(logs)


LIBRARY = _Library()


def library() -> Kernels:
    """The kernels' C entry points, compiled at first call."""
    return LIBRARY.get()


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"(cudaGetLastError)")
