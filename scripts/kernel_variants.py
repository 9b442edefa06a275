#!/usr/bin/env python3
"""Time variants of one hand-written CUDA kernel in turns, on one card.

    python3 scripts/kernel_variants.py ssd [VARIANT ...]
    python3 scripts/kernel_variants.py gram [VARIANT ...]
    python3 scripts/kernel_variants.py colsum [--m M] [VARIANT ...]
    python3 scripts/kernel_variants.py extension [--m M] [VARIANT ...]
    python3 scripts/kernel_variants.py b6 [--m M] [VARIANT ...]
    python3 scripts/kernel_variants.py b1 [--m M] [--dtype DT] [VARIANT ...]
    python3 scripts/kernel_variants.py b7 [--case loop|dense] [VARIANT ...]
    python3 scripts/kernel_variants.py b8 [--case loop|dense] [VARIANT ...]

Each variant is the kernel's source (``src/repro_torch/kernels/csrc``,
with ``affinity_tile.cuh`` inlined) with a few text substitutions
(``VARIANTS`` below; "base" is the source as it is).  Every variant is
written to ``build/variants/`` and built
with the flags of ``repro_torch.kernels._build`` (one nvcc each, all in
parallel), loaded with ctypes, held to the plain PyTorch version at the
kernel's path shape (B2 and B4: N = 10⁵, d = 8, k = 8 and m = 512, or
``--m``; B6: N = 10⁵ x m, d = 8; B1: the (m, m) landmark block at
``--dtype``; B7 and B8: chip_smoke.py's phase-2 points of the dense path,
n = 2048, or with ``--case loop`` the fed loop's 100), then timed in
turns (base, v1, ...,
vn, vn, ..., v1, base): the mean device time of 20 calls from
torch.profiler and the median of 20 calls between CUDA events.  Prints
each variant's nvcc wall time, registers and spills, error and times,
and the card's name and power limit.  Exits non-zero without a CUDA device.
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

# B2 without its compile-time d = 8 instance, B4 without its k <= 8 class
RUNTIME_D = [("  const bool ok = dispatch_exact(dtype, d, [&](auto c) {\n"
              "    using C = decltype(c);\n    using Cf = ColsumCfg",
              "  const bool ok = dispatch(dtype, d, [&](auto c) {\n"
              "    using C = decltype(c);\n    using Cf = ColsumCfg")]
NO_K8 = [("    if (k <= 8)\n      launch(extension_kernel<C::kDt, C::kMaxD, "
          "C::kD, 8>, 8);\n    else if (k <= 16)",
          "    if (k <= 16)")]

# B1's and B6's kernel before PR 17's cross_tile_kernel, as text the
# "parent" variants put back: B1 one thread an entry, B6 affinity_kernel's
# RBF epilogue (EPI = 1); both keep the new C signature and ignore `rows`
_B1_PARENT_KERNEL = """
template <int DT, int MAXD>
__global__ void __launch_bounds__(kCrossThreads)
cross_affinity_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      float gamma, float* __restrict__ out, int n, int m,
                      int d) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(n) * m) return;
  const int i = static_cast<int>(e / m), j = static_cast<int>(e % m);
  float xv[MAXD], yv[MAXD];
  float xn, xs, yn, ys;
  prepare_point<DT, MAXD>(x + static_cast<size_t>(i) * d, d, xv, xn, xs);
  prepare_point<DT, MAXD>(y + static_cast<size_t>(j) * d, d, yv, yn, ys);
  out[e] = affinity<DT, MAXD>(xv, 1, xn, xs, yv, 1, yn, ys, d, gamma);
}

}  // namespace rt

using namespace rt;"""
_B1_PARENT_LAUNCH = """  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(dtype, d, [&](auto c) {
    using C = decltype(c);
    cross_affinity_kernel<C::kDt, C::kMaxD>
        <<<blocks_for(static_cast<long long>(n) * m, kCrossThreads),
           kCrossThreads, 0, s>>>(x, y, gamma, out, n, m, d);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
  switch (dtype) {"""
# B6's, B7's and B8's kernel before cross_tile_kernel took them: PR 12's
# affinity_kernel and launch_affinity, as text the "parent" variants put
# into affinity.cu, in a namespace of their own (the Epilogue names are
# the tile kernel's now); their C entries ignore `rows`
_AFFINITY_PARENT_KERNEL = """
namespace rt {
namespace parent {

enum Epilogue : int { kSqDist = 0, kRbf = 1, kRbfZeroDiag = 2 };

constexpr int kAffCols = 128;   // threads = output columns per block
constexpr int kAffRows = 8;     // output rows per block

template <int EPI, int MAXD>
__global__ void __launch_bounds__(kAffCols)
affinity_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float gamma, float* __restrict__ out, int n, int m, int d) {
  const int j = blockIdx.y * kAffCols + threadIdx.x;
  if (j >= m) return;
  float yv[MAXD];
  float yn, ys;
  prepare_point<kF32, MAXD>(y + static_cast<size_t>(j) * d, d, yv, yn, ys);
  const int i0 = blockIdx.x * kAffRows;
  const int i1 = min(n, i0 + kAffRows);
  for (int i = i0; i < i1; ++i) {
    const float* xr = x + static_cast<size_t>(i) * d;
    float v;
    if (EPI == kSqDist) {
      v = 0.f;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (k < d) {
          const float t = xr[k] - yv[k];
          v = fmaf(t, t, v);
        }
      }
    } else {
      float xv[MAXD];
      float xn, xs;
      prepare_point<kF32, MAXD>(xr, d, xv, xn, xs);
      v = affinity<kF32, MAXD>(xv, 1, xn, xs, yv, 1, yn, ys, d, gamma);
      if (EPI == kRbfZeroDiag && i == j) v = 0.f;
    }
    out[static_cast<size_t>(i) * m + j] = v;
  }
}

template <int EPI>
int launch_affinity(const float* x, const float* y, float gamma, float* out,
                    int n, int m, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(n, kAffRows), blocks_for(m, kAffCols));
  if (d >= 1 && d <= 8) {
    affinity_kernel<EPI, 8><<<grid, kAffCols, 0, s>>>(x, y, gamma, out, n,
                                                       m, d);
  } else if (d > 8 && d <= 32) {
    affinity_kernel<EPI, 32><<<grid, kAffCols, 0, s>>>(x, y, gamma, out, n,
                                                        m, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace parent
}  // namespace rt

using namespace rt;"""


def _affinity_parent(entry_return, parent_return):
    """The "parent" variant of an affinity.cu entry: PR 12's kernel text,
    and the entry's return statement replaced by its launch."""
    return [("\nusing namespace rt;", _AFFINITY_PARENT_KERNEL),
            (entry_return, parent_return)]


# plain stores in place of the streaming ones
_PLAIN_STORES = [
    ("constexpr int kCrossThreads = 256;",
     "template <typename T>\n__device__ __forceinline__ void plain_store(T* p, "
     "T v) { *p = v; }\nconstexpr int kCrossThreads = 256;"),
    ("__stcs(reinterpret_cast<float4*>", "plain_store(reinterpret_cast<float4*>"),
    ("__stcs(reinterpret_cast<float2*>", "plain_store(reinterpret_cast<float2*>"),
    ("if (j0 + c < m) __stcs(o + c", "if (j0 + c < m) plain_store(o + c")]
_CROSS_COLS = "kCols = MAXD <= 8 ? 4 : 2;   // columns a thread"
_ROW_LOOP = "#pragma unroll (EPI == kRbfZeroDiag ? 1 : 2)"
# cross_tile_kernel's variants, for B1 and B6 alike
_CROSS = {
    "base": [],
    # plain (write-back) stores
    "plain": _PLAIN_STORES,
    # no register cap (base: 4 blocks an SM at d <= 8, <= 64 registers)
    "nocap": [("kMinBlocks = MAXD <= 8 ? 4 : 1", "kMinBlocks = 1")],
    # 2 columns a thread at d <= 8 (8-byte stores)
    "cols2": [(_CROSS_COLS, "kCols = 2;")],
    # the row loop unrolled by 1 or 4 (base: 2, B8 1)
    "unroll1": [(_ROW_LOOP, "#pragma unroll 1")],
    "unroll4": [(_ROW_LOOP, "#pragma unroll 4")],
}
# B8's zero diagonal: base stores 0 to each diagonal entry after the row
# loop (unrolled by 1 for B8); "loopdiag" compares every entry inside the
# loop instead, unrolled by 2 (the first design); "nodiag" leaves the
# diagonal as it is (a probe: the diagonal is wrong)
_DIAG_BLOCK = "  if constexpr (EPI == kRbfZeroDiag) {\n    // B8's diagonal"
_B8 = {
    "loopdiag": [
        (_DIAG_BLOCK, "  if constexpr (false) {\n    // B8's diagonal"),
        (_ROW_LOOP, "#pragma unroll 2"),
        ("                                  ys[c], d, gamma);\n",
         "                                  ys[c], d, gamma);\n"
         "        if (EPI == kRbfZeroDiag && row0 + t == j0 + c) "
         "v[c] = 0.f;\n")],
    "nodiag": [
        (_DIAG_BLOCK, "  if constexpr (false) {\n    // B8's diagonal")],
}
# the wrapper's rows a tile capped lower: variant -> the cap
CROSS_ROWS = {"rows32": 32, "rows16": 16, "rows8": 8}

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
    "colsum": ("nystrom.cu", "rt_nystrom_colsum", {
        "base": [],
        # landmarks a thread at d <= 8: 2 (twice the threads) or 8
        "cols2": [("kCols = MAXD <= 8 ? 4 : 2", "kCols = MAXD <= 8 ? 2 : 2")],
        "cols8": [("kCols = MAXD <= 8 ? 4 : 2", "kCols = MAXD <= 8 ? 8 : 2")],
        # the row loop unrolled by 1 or 4 (base: 2)
        "unroll1": [("#pragma unroll 2\n  for (int t = 0; t < rows; ++t)",
                     "#pragma unroll 1\n  for (int t = 0; t < rows; ++t)")],
        "unroll4": [("#pragma unroll 2\n  for (int t = 0; t < rows; ++t)",
                     "#pragma unroll 4\n  for (int t = 0; t < rows; ++t)")],
        # the same 512-column tile as 8 landmarks a thread x 64 threads,
        # or 2 x 256 (unrolled by 2 or 4)
        "cols8x64": [("kCols = MAXD <= 8 ? 4 : 2", "kCols = MAXD <= 8 ? 8 : 2"),
                     ("constexpr int kColsumThreads = 128;",
                      "constexpr int kColsumThreads = 64;")],
        "cols2x256": [("kCols = MAXD <= 8 ? 4 : 2",
                       "kCols = MAXD <= 8 ? 2 : 2"),
                      ("constexpr int kColsumThreads = 128;",
                       "constexpr int kColsumThreads = 256;")],
        "cols2x256u4": [("kCols = MAXD <= 8 ? 4 : 2",
                         "kCols = MAXD <= 8 ? 2 : 2"),
                        ("constexpr int kColsumThreads = 128;",
                         "constexpr int kColsumThreads = 256;"),
                        ("#pragma unroll 2\n  for (int t = 0; t < rows; ++t)",
                         "#pragma unroll 4\n  for (int t = 0; t < rows; ++t)")],
        # d a runtime value at d = 8 too (no compile-time d = 8 instance)
        "rund": RUNTIME_D,
        # sum_rows_kernel with 32 columns a block and 256-row tiles, or 8
        # columns and 1024-row tiles
        "sum32": [("constexpr int kSumCols = 16;",
                   "constexpr int kSumCols = 32;"),
                  ("constexpr int kSumChunk = 512;",
                   "constexpr int kSumChunk = 256;")],
        "sum8": [("constexpr int kSumCols = 16;",
                  "constexpr int kSumCols = 8;"),
                 ("constexpr int kSumChunk = 512;",
                  "constexpr int kSumChunk = 1024;")],
    }),
    "extension": ("nystrom.cu", "rt_nystrom_extension", {
        "base": [],
        # rows a thread: 4 (half the blocks); landmarks a ring stage: 32
        "rows4": [("constexpr int kExtRows = 2;",
                   "constexpr int kExtRows = 4;")],
        "chunk32": [("constexpr int kExtChunk = 64;",
                     "constexpr int kExtChunk = 32;")],
        # the landmark loop unrolled by 2 (base: 4)
        "unroll2": [("#pragma unroll 4\n    for (int t = half",
                     "#pragma unroll 2\n    for (int t = half")],
        # no k <= 8 class: k = 8 runs in the k <= 16 class
        "nok8": NO_K8,
        # neither fork: B2 with d a runtime value and no k <= 8 class (the
        # build time of nystrom.cu without them)
        "noforks": RUNTIME_D + NO_K8,
        # 3 blocks an SM (<= 85 registers) in the k <= 16, d <= 8 class
        "lb3": [("template <int DT, int MAXD, int D, int MAXK>\n__global__ "
                 "void __launch_bounds__(kExtThreads)\nextension_kernel(",
                 "template <int DT, int MAXD, int D, int MAXK>\n__global__ "
                 "void __launch_bounds__(kExtThreads, MAXK <= 16 && MAXD <= 8 "
                 "? 3 : 1)\nextension_kernel(")],
        # probe (wrong results): no proj FMAs, only C and C u
        "noproj": [("        if (q < kq) {\n          const float4 pv",
                    "        if (q < 0) {\n          const float4 pv")],
    }),
    "b6": ("affinity.cu", "rt_rbf_cross_affinity", {
        **_CROSS, **{name: [] for name in CROSS_ROWS},
        "parent": _affinity_parent(
            "  return launch_cross_tile<kF32>(x, y, gamma, out, n, m, d, "
            "rows, stream);",
            "  return parent::launch_affinity<parent::kRbf>(x, y, gamma, "
            "out, n, m, d, stream);"),
    }),
    "b7": ("affinity.cu", "rt_pairwise_sq_dists", {
        **_CROSS, **{name: [] for name in CROSS_ROWS},
        "parent": _affinity_parent(
            "  return launch_cross_tile<kF32, kSqDistDiff>(x, y, 0.f, out, "
            "n, m, d, rows,\n                                              "
            "stream);",
            "  return parent::launch_affinity<parent::kSqDist>(x, y, 0.f, "
            "out, n, m, d, stream);"),
    }),
    "b8": ("affinity.cu", "rt_rbf_affinity", {
        **_CROSS, **{name: [] for name in CROSS_ROWS}, **_B8,
        "parent": _affinity_parent(
            "  return launch_cross_tile<kF32, kRbfZeroDiag>(x, x, gamma, out, "
            "n, n, d,\n                                               rows, "
            "stream);",
            "  return parent::launch_affinity<parent::kRbfZeroDiag>(x, x, "
            "gamma, out, n, n, d, stream);"),
    }),
    "b1": ("nystrom.cu", "rt_quantized_cross_affinity", {
        **_CROSS, **{name: [] for name in CROSS_ROWS},
        "parent": [("}  // namespace rt\n\nusing namespace rt;",
                    _B1_PARENT_KERNEL),
                   ("  switch (dtype) {\n    case kF32:\n      return "
                    "launch_cross_tile", _B1_PARENT_LAUNCH
                    + "\n    case kF32:\n      return launch_cross_tile")],
    }),
}
REPS = 20


def build(kernel, names):
    """{variant: (library path, ptxas log)}, built in parallel; prints
    each nvcc's wall time."""
    import re
    import time

    from repro_torch.kernels import _build

    source, _, variants = VARIANTS[kernel]
    out_dir = REPO / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    header = '#include "affinity_tile.cuh"'
    text = (_build.CSRC / source).read_text().replace(
        header, (_build.CSRC / "affinity_tile.cuh").read_text())
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
        log = out_dir / f"{kernel}_{name}.log"
        with open(log, "w") as f:
            procs[name] = (log, lib, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT))
    t0 = time.perf_counter()
    seconds = {}
    while len(seconds) < len(procs):
        for name, (_, _, proc) in procs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.05)
    built = {}
    for name, (log, lib, proc) in procs.items():
        text = log.read_text()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{text}")
        print(f"{name:8s} nvcc {source}: {seconds[name]:.2f} s (all "
              f"{len(procs)} in parallel), "
              f"{len(re.findall(r'Used \d+ registers', text))} kernels")
        built[name] = (lib, text)
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

    def call(fn, variant=None):
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

    def call(fn, variant=None):
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


def _fused_inputs(m):
    """B2's and B4's inputs at the cohort server's shape (chip_smoke's
    phase 2): N = 10⁵ blobs, d = 8, k = 8, f32, no mask."""
    import numpy as np
    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED + 1)
    x, _ = cs.blobs(np.random.default_rng(cs.SEED))
    return cs._inputs(rng, cs.N, m, cs.D, cs.K, x=x, gamma=0.05)


def colsum_case(m):
    """B2 at N=10⁵, d=8, m (512 on the cohort server's path), f32."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import nystrom as kn
    from repro_torch.kernels import ref
    from repro_torch.kernels._common import stream

    t = _fused_inputs(m)
    n, d = cs.N, cs.D
    panels = kn.colsum_grid(n, m, d)[0]
    partial = torch.empty((panels, m), dtype=torch.float32, device="cuda")
    out = torch.empty((m,), dtype=torch.float32, device="cuda")

    def call(fn, variant=None):
        err = fn(t["x"].data_ptr(), t["z"].data_ptr(), 0.05, None,
                 partial.data_ptr(), out.data_ptr(), n, m, d, 0,
                 stream(out.device))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return (out,)

    return call, (ref.nystrom_colsum_ref(t["x"], t["z"], 0.05),)


def extension_case(m):
    """B4 at N=10⁵, d=8, m (512 on the cohort server's path), k=8, f32."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import nystrom as kn
    from repro_torch.kernels import ref
    from repro_torch.kernels._common import stream

    t = _fused_inputs(m)
    n, d, k = cs.N, cs.D, cs.K
    packed = torch.empty((m, kn.extension_row_width(d, k)),
                         dtype=torch.float32, device="cuda")
    out = torch.empty((n, k), dtype=torch.float32, device="cuda")

    def call(fn, variant=None):
        err = fn(t["x"].data_ptr(), t["z"].data_ptr(), 0.05,
                 t["u"].data_ptr(), t["proj"].data_ptr(), None,
                 packed.data_ptr(), out.data_ptr(), n, m, d, k, 0,
                 stream(out.device))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return (out,)

    return call, (ref.nystrom_extension_ref(t["x"], t["z"], 0.05, t["u"],
                                            t["proj"]),)


def cross_rows(variant, n, m, d):
    """Rows a tile of B1's and B6's launch: the wrapper's
    ``cross_tile_plan``, capped at ``CROSS_ROWS[variant]``."""
    from repro_torch.kernels import affinity

    rows = affinity.cross_tile_plan(n, m, d).rows
    return min(rows, CROSS_ROWS.get(variant, rows))


def cross_case(kernel, m, dtype):
    """B6 at N=10⁵ x m (the unfused Nyström path's C at m = 512), f32; or
    B1's (m, m) landmark block W at ``dtype``; d = 8."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels._common import stream

    t = _fused_inputs(m)
    x, y = (t["x"], t["z"]) if kernel == "b6" else (t["z"], t["z"])
    n, d = x.shape[0], cs.D
    if kernel == "b6" and dtype != "f32":
        raise SystemExit("b6 takes f32 only")
    code = () if kernel == "b6" else ({"f32": 0, "bf16": 1, "int8": 2}[dtype],)
    out = torch.empty((n, m), dtype=torch.float32, device="cuda")

    def call(fn, variant=None):
        err = fn(x.data_ptr(), y.data_ptr(), 0.05, out.data_ptr(), n, m, d,
                 *code, cross_rows(variant, n, m, d), stream(out.device))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return (out,)

    return call, (ref.quantized_cross_affinity_ref(x, y, 0.05,
                                                   affinity_dtype=dtype),)


def square_case(kernel, case):
    """B7 (x against itself) or B8 at chip_smoke.py's phase-2 points of
    the dense path (n = 2048) or of the fed loop (n = 100), d = 8, f32,
    gamma 0.05."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels._common import stream

    x_path, _ = cs.blobs(np.random.default_rng(cs.SEED))
    x = cs.slice2_inputs(x_path)[case]
    n, d = x.shape
    out = torch.empty((n, n), dtype=torch.float32, device="cuda")

    def call(fn, variant=None):
        rows = cross_rows(variant, n, n, d)
        if kernel == "b7":
            err = fn(x.data_ptr(), x.data_ptr(), out.data_ptr(), n, n, d,
                     rows, stream(out.device))
        else:
            err = fn(x.data_ptr(), 0.05, out.data_ptr(), n, d, rows,
                     stream(out.device))
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return (out,)

    want = ref.pairwise_sq_dists_ref(x, x) if kernel == "b7" else \
        ref.rbf_affinity_ref(x, 0.05)
    return call, (want,)


def kernel_times(fn, reps=REPS):
    """(mean device ms of one call, {kernel: mean device ms of one call})
    from torch.profiler, over ``reps`` calls after a warm-up."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            short = re.sub(r"^(void )?(rt::)?", "", e.key).split("(")[0]
            by_kernel[short] = by_kernel.get(short, 0.0) + \
                e.self_device_time_total / 1e3 / reps
    return sum(by_kernel.values()), by_kernel


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("kernel", choices=sorted(VARIANTS))
    parser.add_argument("variants", nargs="*")
    parser.add_argument("--m", type=int, default=cs.M,
                        help="landmarks of the colsum, extension, b6 and "
                             "b1 cases")
    parser.add_argument("--dtype", default="f32",
                        choices=("f32", "bf16", "int8"),
                        help="tile precision of the b1 case")
    parser.add_argument("--case", default="dense", choices=("dense", "loop"),
                        help="points of the b7 and b8 cases")
    args = parser.parse_intermixed_args()
    kernel = args.kernel
    names = args.variants or list(VARIANTS[kernel][2])
    if names[0] != "base":
        names.insert(0, "base")
    print("card", cs.card_line())
    built = build(kernel, names)
    cases = {"ssd": ssd_case, "gram": gram_case,
             "colsum": lambda: colsum_case(args.m),
             "extension": lambda: extension_case(args.m),
             "b6": lambda: cross_case("b6", args.m, args.dtype),
             "b1": lambda: cross_case("b1", args.m, args.dtype),
             "b7": lambda: square_case("b7", args.case),
             "b8": lambda: square_case("b8", args.case)}
    call, want = cases[kernel]()
    fns = {}
    for name, (lib, log) in built.items():
        for row in cs.ptxas_kernels(log, cs.REDESIGNED):
            print(f"{name:8s} ptxas {row}")
        fns[name] = load(kernel, lib)
        got = call(fns[name], name)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
        if name == "base":
            base = [g.clone() for g in got]
        same = all(torch.equal(g, b) for g, b in zip(got, base))
        print(f"{name:8s} error {err:.3e} of the largest entry; "
              f"{'bit-identical to' if same else 'differs from'} base")
    order = names + names[::-1]
    dev = {name: [] for name in names}
    ev = {name: [] for name in names}
    split = {name: {} for name in names}
    for name in order:
        fn = fns[name]
        total, by_kernel = kernel_times(lambda: call(fn, name))
        dev[name].append(total)
        for k, v in by_kernel.items():
            split[name].setdefault(k, []).append(v)
        ev[name].append(cs.time_ms(lambda: call(fn, name), reps=REPS))
    if kernel in ("b1", "b6", "b7", "b8"):
        # the same bytes as a write-only stream: PyTorch's fill kernel
        fill, _ = kernel_times(lambda: got[0].fill_(0.5))
        print(f"fill_ of the output ({got[0].numel() * 4 / 1e6:.1f} MB): "
              f"device {fill:.4f} ms")
    for name in names:
        print(f"{name:8s} device {statistics.mean(dev[name]):.4f} ms "
              f"(turns {', '.join(f'{v:.4f}' for v in dev[name])}); "
              f"events {statistics.mean(ev[name]):.4f} ms; by kernel: "
              + ", ".join(f"{k} {statistics.mean(v):.4f}"
                          for k, v in split[name].items()))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
