#!/usr/bin/env python3
"""Time variants of one hand-written CUDA kernel in turns, on one card.

    python3 scripts/kernel_variants.py ssd [VARIANT ...]
    python3 scripts/kernel_variants.py gram [VARIANT ...]

Each variant is the kernel's source (``src/repro_torch/kernels/csrc``)
with a few text substitutions (``VARIANTS`` below; "base" is the source
as it is).  Every variant is written to ``build/variants/`` and built
with the flags of ``repro_torch.kernels._build`` (one nvcc each, all in
parallel), loaded with ctypes, held to the plain PyTorch version at the
kernel's path shape, then timed in turns (base, v1, ...,
vn, vn, ..., v1, base): the mean device time of 20 calls from
torch.profiler and the median of 20 calls between CUDA events.  Prints
each variant's registers and spills, error and times, and the card's
name and power limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

# kernel -> (source, C entry, {variant: [(old text, new text), ...]})
VARIANTS = {
    "ssd": ("ssd.cu", "rt_ssd_chunk", {
        "base": [],
        # a 3-stage ring: the copies run two steps ahead
        "ring3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        # no register cap: one block an SM when it needs more than 128
        "nocap": [("__launch_bounds__(kThreads, 2)",
                   "__launch_bounds__(kThreads)")],
        # probes of where the time goes (wrong results): the fast, less
        # exact exp; no M.x or state FMAs; no copies of x; no M or
        # B * decay built
        "fastexp": [("expf(csi", "__expf(csi"), ("expf(csl", "__expf(csl")],
        "nofma": [("if (hg < nheads) {\n      const float* xs",
                   "if (hg < 0) {\n      const float* xs")],
        "nox": [("e < kStep * kHeads * XCH; e += kThreads",
                 "e < 0 * kStep * kHeads * XCH; e += kThreads")],
        "nobuild": [("    if constexpr (kState) build_bw<TB, P, N>(smem, s,",
                     "    if (false) build_bw<TB, P, N>(smem, s,"),
                    ("    else build_m<TB, P, N>(smem, s, first",
                     "    else if (false) build_m<TB, P, N>(smem, s, first")],
    }),
    "gram": ("nystrom.cu", "rt_nystrom_gram", {
        "base": [],
        # no register cap: one block an SM when it needs more than 128
        "nocap": [("__launch_bounds__(kGramThreads, 2)",
                   "__launch_bounds__(kGramThreads)")],
    }),
}
REPS = 20


def build(kernel, names):
    """{variant: (library path, ptxas log)}, built in parallel."""
    from repro_torch.kernels import _build

    source, _, variants = VARIANTS[kernel]
    out_dir = REPO / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / source).read_text()
    procs = {}
    for name in names:
        patched = text
        for old, new in variants[name]:
            if old not in patched:
                raise SystemExit(f"variant {name}: {old!r} not in {source}")
            patched = patched.replace(old, new)
        src = out_dir / f"{kernel}_{name}.cu"
        src.write_text(patched)
        lib = out_dir / f"{kernel}_{name}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               "-o", str(lib), str(src)]
        procs[name] = (src, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (src, lib, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{stderr}")
        built[name] = (lib, stdout + stderr)
    return built


def load(kernel, lib_path):
    from repro_torch.kernels import _build

    source, entry, _ = VARIANTS[kernel]
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[source][entry]
    fn.restype = ctypes.c_int
    return fn


def ssd_case():
    """The mamba2-2.7b prefill's B10 call (chip_smoke.SSD_PATH, bf16 B/C):
    (call(fn) -> outputs, plain outputs)."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels._common import stream

    sp = cs.SSD_PATH
    B, c, Q, H, P, G, N = (sp[k] for k in "B c Q H P G N".split())
    rng = np.random.default_rng(cs.SEED + 5)
    xdt = torch.tensor(rng.normal(size=(B, c, Q, H, P)), dtype=torch.float32,
                       device="cuda")
    cs_ = torch.cumsum(-torch.tensor(rng.random((B, c, Q, H)) * 0.1,
                                     dtype=torch.float32, device="cuda"), 2)
    Bm, Cm = (torch.tensor(rng.normal(size=(B, c, Q, G, N)),
                           dtype=torch.bfloat16, device="cuda")
              for _ in range(2))
    y = torch.empty((B, c, Q, H, P), dtype=torch.float32, device="cuda")
    st = torch.empty((B, c, H, P, N), dtype=torch.float32, device="cuda")

    def call(fn):
        err = fn(xdt.data_ptr(), cs_.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), st.data_ptr(), 1, B, c, Q, H,
                 G, P, N, stream(y.device))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return y, st

    return call, ref.ssd_chunk_ref(xdt, cs_, Bm, Cm)


def gram_case():
    """B3 at the cohort server's shape (N=10⁵, d=8, m=512, f32)."""
    import math

    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import nystrom as kn
    from repro_torch.kernels import ref
    from repro_torch.kernels._common import stream

    rng = np.random.default_rng(cs.SEED + 1)
    x, _ = cs.blobs(np.random.default_rng(cs.SEED))
    t = cs._inputs(rng, cs.N, cs.M, cs.D, cs.K, x=x, gamma=0.05)
    n, m, d = cs.N, cs.M, cs.D
    slabs, slab_rows = kn.gram_slabs(n, m)
    tiles = math.ceil(m / 128)
    f32 = dict(dtype=torch.float32, device="cuda")
    r = torch.empty((n,), **f32)
    partial = torch.empty((slabs, tiles * (tiles + 1) // 2, 128, 128), **f32)
    g, tt, out = (torch.empty((m, m), **f32) for _ in range(3))

    def call(fn):
        err = fn(t["x"].data_ptr(), t["z"].data_ptr(), 0.05,
                 t["u"].data_ptr(), t["wis"].data_ptr(), None, r.data_ptr(),
                 partial.data_ptr(), g.data_ptr(), tt.data_ptr(),
                 out.data_ptr(), n, m, d, slabs, slab_rows, 0,
                 stream(out.device))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return (out,)

    return call, (ref.nystrom_gram_ref(t["x"], t["z"], 0.05, t["u"],
                                       t["wis"]),)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    kernel = sys.argv[1]
    names = sys.argv[2:] or list(VARIANTS[kernel][2])
    if names[0] != "base":
        names.insert(0, "base")
    print("card", cs.card_line())
    built = build(kernel, names)
    call, want = (ssd_case if kernel == "ssd" else gram_case)()
    fns = {}
    for name, (lib, log) in built.items():
        for row in cs.ptxas_kernels(log, cs.REDESIGNED):
            print(f"{name:8s} ptxas {row}")
        fns[name] = load(kernel, lib)
        got = call(fns[name])
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        print(f"{name:8s} error {err:.3e} of the largest entry")
    order = names + names[::-1]
    dev = {name: [] for name in names}
    ev = {name: [] for name in names}
    for name in order:
        fn = fns[name]
        dev[name].append(cs.device_ms(lambda: call(fn), reps=REPS))
        ev[name].append(cs.time_ms(lambda: call(fn), reps=REPS))
    for name in names:
        print(f"{name:8s} device {statistics.mean(dev[name]):.4f} ms "
              f"(turns {', '.join(f'{v:.4f}' for v in dev[name])}); "
              f"events {statistics.mean(ev[name]):.4f} ms")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
