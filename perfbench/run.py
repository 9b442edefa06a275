"""Run one cell of the benchmark of the port's cohort-selection service.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  Exits non-zero, printing no result,
without as many CUDA devices as the cell asks for.  Every cache the run
writes (the kernels' nvcc build, and any compiler cache) lies under the
checkout's ``build/``.
"""

import os
import pathlib
import sys
import time


def _process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (both count
    from boot on Linux); the interpreter's own start included."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - age if 0.0 <= age < 60.0 else now
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
ROOT = pathlib.Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(process_start=PROCESS_START))
