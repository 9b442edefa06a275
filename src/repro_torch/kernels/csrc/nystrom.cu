// Fused Nystrom kernels for Hopper (sm_90a): C -> S -> S^T S with no (N, m)
// cross-affinity in device memory.
//
// Ports of the five Pallas kernels of src/repro/kernels/nystrom_pallas.py:
//
//   rt_quantized_cross_affinity  <- quantized_cross_affinity_pallas (l.340)
//   rt_nystrom_colsum            <- nystrom_colsum_pallas (l.208)
//   rt_nystrom_gram              <- nystrom_gram_pallas (l.240)
//   rt_nystrom_extension         <- nystrom_extension_pallas (l.275)
//   rt_panel_matmul              <- panel_matmul_pallas (l.311)
//
// The TPU kernels walk the row panels in order on one core and carry the
// column sum / Gram in the output block across grid steps.  Here blocks run
// in parallel on 132 SMs, so every cross-block sum goes through a scratch
// array of per-block partials that a second launch reduces in index order.
// No float atomics anywhere: every sum has a fixed order, so a launch on
// the same inputs is bit-identical (the engine's determinism contract).
//
// Every C entry takes device pointers and a cudaStream_t, launches on that
// stream, allocates nothing (scratch comes from the caller), and returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).
//
// Bounds at the select path's shape (N = 100 000, d = 8, m = 512, k = 8,
// f32) on an H100 (67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s):
//   colsum     N*m = 5.1e7 affinity entries (~1.2 GFLOP) on 3.6 MB read:
//              operation-bound, ~20 us.
//   gram       the upper triangle of S^T S, N*m*(m + 1) = 2.6e10 FLOP in
//              exact f32 (no TF32), plus C once and the rotation:
//              operation-bound, ~0.42 ms; at the m = 4096 engine's shape
//              1.7e12 FLOP, ~29 ms (kernel 3).
//   extension  like colsum twice plus 2*N*m*k FLOP: operation-bound.
//   cross      W = A(z, z), 512 x 512: 1 MB written, launch-bound.
//   panel      the subspace solver's W Q at m = 4096: (4096, 4096) @
//              (4096, 64) is 2.1 GFLOP, operation-bound (~32 us; W alone
//              is 67 MB, ~20 us); with 8 columns it reads W once,
//              byte-bound (~20 us).

#include <cuda_runtime.h>
#include <stdint.h>

#include "affinity_tile.cuh"

namespace rt {

// ---------------------------------------------------------------------------
// dispatch on (affinity dtype, d): d <= 8 and d <= 32 get their own
// register-array bound
// ---------------------------------------------------------------------------

template <int DT, int MAXD>
struct Cfg {
  static constexpr int kDt = DT;
  static constexpr int kMaxD = MAXD;
};

template <int MAXD, typename F>
bool with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kF32: f(Cfg<kF32, MAXD>{}); return true;
    case kBF16: f(Cfg<kBF16, MAXD>{}); return true;
    case kINT8: f(Cfg<kINT8, MAXD>{}); return true;
    default: return false;
  }
}

template <typename F>
bool dispatch(int dtype, int d, F&& f) {
  if (d >= 1 && d <= 8) return with_dtype<8>(dtype, f);
  if (d > 8 && d <= 32) return with_dtype<32>(dtype, f);
  return false;
}

// ---------------------------------------------------------------------------
// shared piece: in-order reduction of per-block partials
// ---------------------------------------------------------------------------

// out[j] = sum_p partial[p, j], p ascending.
__global__ void sum_rows_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int rows,
                                long long cols) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= cols) return;
  float acc = 0.f;
#pragma unroll 8
  for (int p = 0; p < rows; ++p) acc += partial[p * cols + j];
  out[j] = acc;
}

// One float (VEC false) or 16 bytes (VEC true) global -> shared with
// cp.async; `in` false zero-fills the destination.
template <bool VEC>
__device__ __forceinline__ void panel_copy(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0));
}

// ---------------------------------------------------------------------------
// kernel 1: materialized cross-affinity, one thread per output entry
// ---------------------------------------------------------------------------

constexpr int kCrossThreads = 256;

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

// ---------------------------------------------------------------------------
// kernel 2: column sum.  Block (panel, column tile): the panel's rows sit in
// shared memory, each thread owns one landmark column and sums the panel's
// rows in order into partial[panel, j]; sum_rows_kernel then adds the
// panels in index order.
// ---------------------------------------------------------------------------

constexpr int kColsumCols = 128;   // threads = landmark columns per block
constexpr int kColsumRows = 256;   // rows per panel

template <int DT, int MAXD>
__global__ void __launch_bounds__(kColsumCols)
colsum_partial_kernel(const float* __restrict__ x,
                      const float* __restrict__ z, float gamma,
                      const float* __restrict__ mask,
                      float* __restrict__ partial, int n, int m, int d) {
  extern __shared__ float smem[];
  float* xv = smem;                        // d * kColsumRows
  float* xn = xv + d * kColsumRows;
  float* xs = xn + kColsumRows;
  float* xm = xs + kColsumRows;
  const int row0 = blockIdx.x * kColsumRows;
  const int rows = min(kColsumRows, n - row0);
  load_points<DT, MAXD>(x, row0, rows, kColsumRows, d, xv, xn, xs);
  for (int t = threadIdx.x; t < kColsumRows; t += blockDim.x)
    xm[t] = t < rows ? (mask ? mask[row0 + t] : 1.f) : 0.f;
  __syncthreads();
  const int j = blockIdx.y * kColsumCols + threadIdx.x;
  if (j >= m) return;
  float zv[MAXD];
  float zn, zs;
  prepare_point<DT, MAXD>(z + static_cast<size_t>(j) * d, d, zv, zn, zs);
  float acc = 0.f;
  for (int t = 0; t < rows; ++t)
    acc += affinity<DT, MAXD>(xv + t, kColsumRows, xn[t], xs[t], zv, 1, zn,
                              zs, d, gamma) * xm[t];
  partial[static_cast<size_t>(blockIdx.x) * m + j] = acc;
}

// ---------------------------------------------------------------------------
// row kernels: one thread per client row, landmarks streamed through shared
// memory in chunks.  row_degree is pass 1 of both the Gram pre-pass and the
// extension: d^_i = sum_j C_ij u_j, j ascending.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 128;
constexpr int kChunk = 64;         // landmarks per shared-memory chunk

// Every thread of the block calls this (it synchronizes); `live` says
// whether the calling thread owns a real row.
template <int DT, int MAXD>
__device__ __forceinline__ float row_degree(const float* xv, float xn, float xs, bool live,
                            const float* __restrict__ z,
                            const float* __restrict__ u, int m, int d,
                            float gamma, float* smem) {
  float* zv = smem;                  // d * kChunk
  float* zn = zv + d * kChunk;
  float* zs = zn + kChunk;
  float* zu = zs + kChunk;
  float dh = 0.f;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cnt = min(kChunk, m - c0);
    __syncthreads();
    load_points<DT, MAXD>(z, c0, cnt, kChunk, d, zv, zn, zs);
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) zu[t] = u[c0 + t];
    __syncthreads();
    if (live) {
      for (int t = 0; t < cnt; ++t)
        dh = fmaf(affinity<DT, MAXD>(xv, 1, xn, xs, zv + t, kChunk, zn[t],
                                     zs[t], d, gamma),
                  zu[t], dh);
    }
  }
  return dh;
}

// r_i = mask_i * rsqrt(max(mask_i * d^_i, eps)): S = diag(r) C.
template <int DT, int MAXD>
__global__ void __launch_bounds__(kRowThreads)
degree_kernel(const float* __restrict__ x, const float* __restrict__ z,
              float gamma, const float* __restrict__ u,
              const float* __restrict__ mask, float* __restrict__ r, int n,
              int m, int d) {
  extern __shared__ float smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xv[MAXD];
  float xn = 0.f, xs = 1.f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) xv[k] = 0.f;
  if (live)
    prepare_point<DT, MAXD>(x + static_cast<size_t>(i) * d, d, xv, xn, xs);
  const float dh = row_degree<DT, MAXD>(xv, xn, xs, live, z, u, m, d, gamma,
                                        smem);
  if (live) {
    const float mk = mask ? mask[i] : 1.f;
    r[i] = mk * rsqrtf(fmaxf(mk * dh, kEps));
  }
}

// ---------------------------------------------------------------------------
// kernel 3: the S^T S Gram (rt_nystrom_gram), after degree_kernel's r.
// ---------------------------------------------------------------------------
//
// Bound: S^T S is symmetric, so the least work is its upper triangle,
// N*m*(m + 1) FLOP of exact f32 FMAs (2.6e10 at m = 512, 1.7e12 at
// m = 4096: 0.39 and 25 ms at 67 TFLOP/s), beside C once (~1.2 GFLOP at
// m = 512) and the W^-1/2 G W^-1/2 rotation (4 m^3).  Operation-bound.
//
// Every output tile rebuilds the S columns it needs, and 4 x 4 register
// tiles are bound by shared-memory reads (one float for every 4 FMAs), so
// the tiles are large and only the upper triangle is computed:
//   - A block of 256 threads owns one 128 x 128 tile pair (P, Q) with
//     P <= Q of the upper triangle (gram_pair) and one slab of rows: 8 x 8
//     outputs a thread (16 shared-memory floats for 64 FMAs), in two
//     float4 groups half the tile apart so a warp's reads are contiguous
//     or broadcast.  A column of S is rebuilt m/128 + 1 times; a diagonal
//     pair builds its one tile once.
//   - Each thread keeps one landmark of the pair in registers and builds
//     its S column for every row chunk (kGramRows rows), so a chunk's
//     entries are built once, into shared memory.  The rows' raw x and r
//     stream through a 2-stage cp.async ring (4-byte copies: a chunk is
//     kGramRows * d floats); 32 threads round them to the tile precision.
//   - The (pair, slab) partials go to a compact (slabs, pairs, 128, 128)
//     scratch; gram_reduce_kernel adds the slabs in index order and
//     writes each entry of the (m, m) Gram and its mirror, so G is
//     exactly symmetric.  gram_slabs (kernels/nystrom.py) picks the
//     slabs from (n, m) alone: enough (pair, slab) blocks for 4 waves of
//     2 blocks an SM, the scratch capped at 2^25 floats (128 MiB; at
//     m = 4096 two slabs, 69 MB).
//   - The rotation is two launches of rot_tile_kernel, the same 8 x 8
//     design: t = W^-1/2 G, out = t W^-1/2.  W^-1/2 is not taken to be
//     symmetric (the function accepts any (m, m) matrix), so both are
//     general products; each output sums k in ascending order in one
//     accumulator (see rot_tile_kernel).
// Every sum has a fixed order: rows ascending within a slab, slabs in
// index order, k ascending in the rotation.  No atomics.  On the card
// (PERF.md, the kernel table): 1.45 ms at m = 512, 70 ms at m = 4096, of which the
// tile kernel 62 and the rotation 7.3.

constexpr int kGramTile = 128;     // output tile edge
constexpr int kGramRows = 32;      // rows a chunk
constexpr int kGramThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kGramLd = kGramTile + 4;

// Tile pair `idx` of the upper triangle of a T x T tile grid, row by row:
// (0, 0), (0, 1), ..., (0, T - 1), (1, 1), ...  (gram_pair in
// kernels/nystrom.py mirrors it).
__device__ __forceinline__ void gram_pair(int T, int idx, int& P, int& Q) {
  P = 0;
  while (idx >= T - P) {
    idx -= T - P;
    ++P;
  }
  Q = P + idx;
}

// Entry e of the 8 rows (or columns) owner o (0..15) holds in a tile.
__device__ __forceinline__ int gram_idx(int o, int e) {
  return (e / 4) * (kGramTile / 2) + o * 4 + e % 4;
}
__device__ __forceinline__ void gram_load8(const float* p, int o,
                                           float (&v)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 x =
        *reinterpret_cast<const float4*>(p + h * (kGramTile / 2) + o * 4);
    v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z;
    v[4 * h + 3] = x.w;
  }
}

// floats of shared memory: the two S tiles, the raw ring (a chunk's x
// span, then its r), the prepared rows (points, norms, scales, r)
template <int MAXD>
struct GramSmem {
  static constexpr int kTiles = 2 * kGramRows * kGramLd;
  static constexpr int kRaw = kGramRows * (MAXD + 1);
  static constexpr int kPrep = kGramRows * (MAXD + 3);
  static constexpr size_t kBytes = (kTiles + 2 * kRaw + kPrep) * sizeof(float);
};

template <int MAXD>
__device__ __forceinline__ void gram_load_chunk(float* stage, const float* x,
                                                const float* r, int i0,
                                                int rows, int d) {
  for (int e = threadIdx.x; e < rows * d; e += kGramThreads)
    panel_copy<false>(stage + e, x + static_cast<size_t>(i0) * d + e, true);
  for (int e = threadIdx.x; e < rows; e += kGramThreads)
    panel_copy<false>(stage + kGramRows * MAXD + e, r + i0 + e, true);
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int DT, int MAXD>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_tile_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 float gamma, const float* __restrict__ r,
                 float* __restrict__ partial, int n, int m, int d,
                 int slab_rows) {
  using Sm = GramSmem<MAXD>;
  extern __shared__ float4 gram_smem4[];
  float* sp = reinterpret_cast<float*>(gram_smem4);   // S columns of tile P
  float* sq = sp + kGramRows * kGramLd;               // ... of tile Q
  float* raw = sp + Sm::kTiles;
  float* xv = raw + 2 * Sm::kRaw;                     // [t][MAXD]
  float* xn = xv + kGramRows * MAXD;
  float* xs = xn + kGramRows;
  float* xr = xs + kGramRows;

  int P, Q;
  gram_pair((m + kGramTile - 1) / kGramTile, blockIdx.x, P, Q);
  const bool diag = P == Q;
  const int tid = threadIdx.x;
  // the landmark column this thread builds, kept in registers; a
  // diagonal pair has one tile, built by two halves of the rows
  const int col = tid % kGramTile;
  const bool in_p = diag || tid < kGramTile;
  const int j = (in_p ? P : Q) * kGramTile + col;
  float lv[MAXD];
  float ln = 0.f, ls = 1.f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) lv[k] = 0.f;
  if (j < m) prepare_point<DT, MAXD>(z + static_cast<size_t>(j) * d, d, lv, ln, ls);
  float* build = in_p ? sp : sq;
  const int t_begin = diag ? (tid / kGramTile) * (kGramRows / 2) : 0;
  const int t_end = diag ? t_begin + kGramRows / 2 : kGramRows;
  const float* sb = diag ? sp : sq;

  const int warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 2) * 4 + lane / 8;   // output rows gram_idx(ty, .)
  const int tx = (warp % 2) * 8 + lane % 8;   // output columns
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  const int i_begin = blockIdx.y * slab_rows;
  const int i_end = min(n, i_begin + slab_rows);
  const int nchunks = (i_end - i_begin + kGramRows - 1) / kGramRows;
  if (nchunks > 0)
    gram_load_chunk<MAXD>(raw, x, r, i_begin, min(kGramRows, i_end - i_begin),
                          d);
  for (int c = 0; c < nchunks; ++c) {
    const int i0 = i_begin + c * kGramRows;
    const int rows = min(kGramRows, i_end - i0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk c has landed; chunk c - 1 is consumed
    if (c + 1 < nchunks)
      gram_load_chunk<MAXD>(raw + ((c + 1) % 2) * Sm::kRaw, x, r,
                            i0 + kGramRows,
                            min(kGramRows, i_end - i0 - kGramRows), d);
    if (tid < kGramRows) {
      const float* rs = raw + (c % 2) * Sm::kRaw;
      float pv[MAXD];
      float pn = 0.f, ps = 1.f;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) pv[k] = 0.f;
      if (tid < rows) prepare_point<DT, MAXD>(rs + tid * d, d, pv, pn, ps);
#pragma unroll
      for (int k = 0; k < MAXD; ++k) xv[tid * MAXD + k] = pv[k];
      xn[tid] = pn;
      xs[tid] = ps;
      xr[tid] = tid < rows ? rs[kGramRows * MAXD + tid] : 0.f;
    }
    __syncthreads();   // the chunk's rows are prepared
    for (int t = t_begin; t < t_end; ++t)
      build[t * kGramLd + col] =
          affinity<DT, MAXD>(xv + t * MAXD, 1, xn[t], xs[t], lv, 1, ln, ls,
                             d, gamma) * xr[t];
    __syncthreads();   // the chunk's S columns are built
#pragma unroll 4
    for (int t = 0; t < kGramRows; ++t) {
      float av[8], bv[8];
      gram_load8(sp + t * kGramLd, ty, av);
      gram_load8(sb + t * kGramLd, tx, bv);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }
  float* out = partial + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                          blockIdx.x) * kGramTile * kGramTile;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float* row = out + gram_idx(ty, a) * kGramTile;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(row + h * (kGramTile / 2) + tx * 4) =
          make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                      acc[a][4 * h + 3]);
  }
}

// g (m, m) from the (slabs, pairs, 128, 128) partials: block (pair, 32 x 32
// sub-tile) adds the slabs in index order, writes the upper-triangle
// entries, and through shared memory their mirrors, both coalesced.
constexpr int kReduceEdge = 32;

__global__ void __launch_bounds__(kReduceEdge * 8)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ g,
                   int m, int slabs) {
  __shared__ float tile[kReduceEdge][kReduceEdge + 1];
  int P, Q;
  gram_pair((m + kGramTile - 1) / kGramTile, blockIdx.x, P, Q);
  constexpr int kSub = kGramTile / kReduceEdge;
  const int a0 = (blockIdx.y / kSub) * kReduceEdge;
  const int b0 = (blockIdx.y % kSub) * kReduceEdge;
  const size_t pair_stride = static_cast<size_t>(gridDim.x) * kGramTile *
                             kGramTile;
  const float* base = partial + static_cast<size_t>(blockIdx.x) * kGramTile *
                                    kGramTile;
  for (int k = threadIdx.y; k < kReduceEdge; k += 8) {
    const int a = a0 + k, b = b0 + threadIdx.x;
    const float* src = base + a * kGramTile + b;
    float v = 0.f;
    for (int s = 0; s < slabs; ++s) v += src[s * pair_stride];
    tile[k][threadIdx.x] = v;
    const int p = P * kGramTile + a, q = Q * kGramTile + b;
    if (p < m && q < m && (P != Q || a <= b))
      g[static_cast<size_t>(p) * m + q] = v;
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kReduceEdge; k += 8) {
    const int a = a0 + threadIdx.x, b = b0 + k;
    const int p = P * kGramTile + a, q = Q * kGramTile + b;
    if (p < m && q < m && (P != Q || a < b))
      g[static_cast<size_t>(q) * m + p] = tile[threadIdx.x][k];
  }
}

// The rotation t = W^-1/2 G, out = t W^-1/2 (rt_nystrom_gram's last two
// launches): C (m, m) = A (m, m) B (m, m), both row-major and general
// (the function accepts any W^-1/2).  A block of 64 threads owns a 64 x 64
// tile, 8 x 8 outputs a thread: rows ty + 8 a, so a warp's float4 reads of
// A's rows (kRotK + 8 floats apart) hit distinct banks, and columns in two
// float4 groups half the tile apart.  A's rows and B's k-slice stream
// through a 2-stage cp.async ring.  Each output sums k in ascending order
// in one accumulator, the rounding this rotation has always had: the
// cohort server's cold solve draws its k-means++ seeds from the rotated
// Gram's last bits (W^-1/2 is ill-conditioned), and a k-split sum flips
// that draw at the smoke run's table (PERF.md, section 6).
constexpr int kRotTile = 64;
constexpr int kRotK = 32;           // k a ring stage holds
constexpr int kRotThreads = 64;     // 8 x 8 threads, 8 x 8 outputs each
constexpr int kRotLda = kRotK + 8;

template <bool VEC>
__device__ __forceinline__ void rot_load(float* sa, float* sb,
                                         const float* a, const float* b,
                                         int i0, int j0, int k0, int m) {
  constexpr int V = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < kRotTile * kRotK / V; e += kRotThreads) {
    const int row = e / (kRotK / V), kk = (e % (kRotK / V)) * V;
    const bool in = i0 + row < m && k0 + kk < m;
    panel_copy<VEC>(sa + row * kRotLda + kk,
                    in ? a + static_cast<size_t>(i0 + row) * m + k0 + kk : a,
                    in);
  }
  for (int e = threadIdx.x; e < kRotK * kRotTile / V; e += kRotThreads) {
    const int kk = e / (kRotTile / V), col = (e % (kRotTile / V)) * V;
    const bool in = k0 + kk < m && j0 + col < m;
    panel_copy<VEC>(sb + kk * kRotTile + col,
                    in ? b + static_cast<size_t>(k0 + kk) * m + j0 + col : b,
                    in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool VEC>
__global__ void __launch_bounds__(kRotThreads)
rot_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m) {
  __shared__ __align__(16) float sa[2][kRotTile * kRotLda];
  __shared__ __align__(16) float sb[2][kRotK * kRotTile];
  const int i0 = blockIdx.y * kRotTile, j0 = blockIdx.x * kRotTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  const int nk = (m + kRotK - 1) / kRotK;
  rot_load<VEC>(sa[0], sb[0], a, b, i0, j0, 0, m);
  for (int kc = 0; kc < nk; ++kc) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // slice kc has landed; slice kc - 1 is consumed
    if (kc + 1 < nk)
      rot_load<VEC>(sa[(kc + 1) % 2], sb[(kc + 1) % 2], a, b, i0, j0,
                    (kc + 1) * kRotK, m);
    const float* ta = sa[kc % 2];
    const float* tb = sb[kc % 2];
#pragma unroll 2
    for (int k4 = 0; k4 < kRotK; k4 += 4) {
      float av[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(ta + (ty + 8 * r) * kRotLda + k4);
        av[r][0] = v.x; av[r][1] = v.y; av[r][2] = v.z; av[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              tb + (k4 + kk) * kRotTile + h * (kRotTile / 2) + tx * 4);
          bv[4 * h] = v.x; bv[4 * h + 1] = v.y; bv[4 * h + 2] = v.z;
          bv[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[r][q] = fmaf(av[r][kk], bv[q], acc[r][q]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + ty + 8 * r;
    if (i >= m) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + (q / 4) * (kRotTile / 2) + tx * 4 + q % 4;
      if (j < m) c[static_cast<size_t>(i) * m + j] = acc[r][q];
    }
  }
}

int launch_rot(const float* a, const float* b, float* c, int m,
               cudaStream_t s) {
  const dim3 grid(blocks_for(m, kRotTile), blocks_for(m, kRotTile));
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec) rot_tile_kernel<true><<<grid, kRotThreads, 0, s>>>(a, b, c, m);
  else rot_tile_kernel<false><<<grid, kRotThreads, 0, s>>>(a, b, c, m);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// kernel 4: extension, one thread per row.  Pass 1 is row_degree; pass 2
// streams the landmarks again with their proj rows and accumulates
// v = sum_j S_ij proj_j; the row is then normalized with the 1e-12 floor.
// Masked rows have r = 0 and come out 0.
// ---------------------------------------------------------------------------

template <int DT, int MAXD, int MAXK>
__global__ void __launch_bounds__(kRowThreads)
extension_kernel(const float* __restrict__ x, const float* __restrict__ z,
                 float gamma, const float* __restrict__ u,
                 const float* __restrict__ proj,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int n, int m, int d, int k) {
  extern __shared__ float smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float xv[MAXD];
  float xn = 0.f, xs = 1.f;
#pragma unroll
  for (int kk = 0; kk < MAXD; ++kk) xv[kk] = 0.f;
  if (live)
    prepare_point<DT, MAXD>(x + static_cast<size_t>(i) * d, d, xv, xn, xs);
  const float dh = row_degree<DT, MAXD>(xv, xn, xs, live, z, u, m, d, gamma,
                                        smem);
  const float mk = live ? (mask ? mask[i] : 1.f) : 0.f;
  const float r = mk * rsqrtf(fmaxf(mk * dh, kEps));

  float* zv = smem;                  // d * kChunk
  float* zn = zv + d * kChunk;
  float* zs = zn + kChunk;
  float* pj = zs + 2 * kChunk;       // kChunk * k, after row_degree's u slot
  float v[MAXK];
#pragma unroll
  for (int kk = 0; kk < MAXK; ++kk) v[kk] = 0.f;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cnt = min(kChunk, m - c0);
    __syncthreads();
    load_points<DT, MAXD>(z, c0, cnt, kChunk, d, zv, zn, zs);
    for (int e = threadIdx.x; e < cnt * k; e += blockDim.x)
      pj[e] = proj[static_cast<size_t>(c0) * k + e];
    __syncthreads();
    if (live && r != 0.f) {
      for (int t = 0; t < cnt; ++t) {
        const float s = affinity<DT, MAXD>(xv, 1, xn, xs, zv + t, kChunk,
                                           zn[t], zs[t], d, gamma) * r;
#pragma unroll
        for (int kk = 0; kk < MAXK; ++kk)
          if (kk < k) v[kk] = fmaf(s, pj[t * k + kk], v[kk]);
      }
    }
  }
  if (!live) return;
  float sq = 0.f;
#pragma unroll
  for (int kk = 0; kk < MAXK; ++kk)
    if (kk < k) sq = fmaf(v[kk], v[kk], sq);
  const float norm = fmaxf(sqrtf(sq), kEps);
#pragma unroll
  for (int kk = 0; kk < MAXK; ++kk)
    if (kk < k) out[static_cast<size_t>(i) * k + kk] = v[kk] / norm;
}

// ---------------------------------------------------------------------------
// kernel 6: the subspace solver's panel product out = W Q (rt_panel_matmul)
// ---------------------------------------------------------------------------
//
// Bound at the engine's shapes (m = p = 4096, H100): r = 64 is 2.1 GFLOP
// of exact f32 on the CUDA cores, 0.032 ms (W alone is 67 MB, 0.020 ms);
// r = 8 reads W once, 0.020 ms by bytes.
//
// A block of 256 threads owns a short row panel of W (BM rows) and BN
// output columns: every column when r <= BN, column tiles of BN above.
// At m = 4096 that is 128 blocks of 32 rows at r <= 64 and 256 blocks of
// 16 rows at r <= 8 (BN = 8, so no column padding there), where the
// generic 64 x 64 matmul tile gave 64 blocks of mostly padding.  W's rows
// and the matching k-slice of Q (KD x BN) stream through a 3-stage
// cp.async ring (16-byte copies when p and r are multiples of 4 and the
// pointers 16-byte aligned, 4-byte copies otherwise; the same arithmetic
// either way).  The block's threads form kGroups groups; each group holds
// the whole BM x BN tile in registers, TM x TN a thread, and takes a
// fixed kSlice-wide part of every KD-deep chunk: at r <= 64 eight groups
// of one warp, 8 x 8 a thread, 8 of every 64 k (64 FMAs for every 4
// shared-memory reads); at r <= 8 sixteen groups of 16 threads, 4 x 2 a
// thread, 8 of every 128 k.  Summation order, the same for every launch
// and every caller's block_rows: a thread sums its group's k in
// ascending order over the chunks, then the group partials are added in
// group order 0, 1, ... through shared memory.  No atomics.  W's rows sit
// KD + 8 floats apart in shared memory and a thread's TM rows are BM / TM
// apart, so a warp's float4 reads of W hit distinct banks.

constexpr int kPanelThreads = 256;
constexpr int kPanelStages = 3;

template <int BM, int BN, int TM, int TN, int KD>
struct PanelCfg {
  static constexpr int kRowGroups = BM / TM;
  static constexpr int kGroup = kRowGroups * (BN / TN);  // threads a group
  static constexpr int kGroups = kPanelThreads / kGroup;
  static constexpr int kSlice = KD / kGroups;   // k a group takes a chunk
  static constexpr int kLdw = KD + 8;
  static constexpr int kWStage = BM * kLdw;
  static constexpr int kQStage = KD * BN;
  static constexpr size_t kSmem =
      kPanelStages * (kWStage + kQStage) * sizeof(float);
  static_assert(kPanelThreads % kGroup == 0, "groups tile the block");
  static_assert(kSlice % 4 == 0 && kSlice >= 4, "float4 steps of k");
  static_assert(kGroups * BM * BN <= kPanelStages * (kWStage + kQStage),
                "the partials fit the ring");
};

// chunk k0 .. k0 + KD - 1 of W's panel and of Q's column tile into one
// stage; entries past m, p or r are zero-filled
template <int BM, int BN, int KD, int LDW, bool VEC>
__device__ __forceinline__ void panel_load(float* sw, float* sq,
                                           const float* w, const float* q,
                                           int row0, int col0, int k0, int m,
                                           int p, int r) {
  constexpr int V = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < BM * KD / V; e += kPanelThreads) {
    const int row = e / (KD / V), kk = (e % (KD / V)) * V;
    const bool in = row0 + row < m && k0 + kk < p;
    panel_copy<VEC>(sw + row * LDW + kk,
                    in ? w + static_cast<size_t>(row0 + row) * p + k0 + kk
                       : w, in);
  }
  for (int e = threadIdx.x; e < KD * BN / V; e += kPanelThreads) {
    const int kk = e / (BN / V), c = (e % (BN / V)) * V;
    const bool in = k0 + kk < p && col0 + c < r;
    panel_copy<VEC>(sq + kk * BN + c,
                    in ? q + static_cast<size_t>(k0 + kk) * r + col0 + c
                       : q, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// A thread's TN output columns: cg * 2 + j for TN = 2; for TN = 8 two
// float4 groups, cg * 4 + j and BN / 2 + cg * 4 + j, so that the lanes'
// float4 reads of a Q row are contiguous.
template <int BN, int TN>
__device__ __forceinline__ int panel_col(int cg, int j) {
  static_assert(TN == 2 || TN == 8, "TN is 2 or 8");
  if constexpr (TN == 8) return (j / 4) * (BN / 2) + cg * 4 + j % 4;
  return cg * TN + j;
}

template <int BN, int TN>
__device__ __forceinline__ void panel_q_row(const float* p, float (&v)[TN]) {
  if constexpr (TN == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(p + h * (BN / 2));
      v[4 * h] = x.x; v[4 * h + 1] = x.y; v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  }
}

template <int BM, int BN, int TM, int TN, int KD, bool VEC>
__global__ void __launch_bounds__(kPanelThreads)
panel_kernel(const float* __restrict__ w, const float* __restrict__ q,
             float* __restrict__ out, int m, int p, int r) {
  using Cf = PanelCfg<BM, BN, TM, TN, KD>;
  constexpr int LDW = Cf::kLdw;
  extern __shared__ float4 panel_smem4[];
  float* smem = reinterpret_cast<float*>(panel_smem4);
  float* sw = smem;
  float* sq = smem + kPanelStages * Cf::kWStage;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int grp = threadIdx.x / Cf::kGroup, gt = threadIdx.x % Cf::kGroup;
  const int rg = gt / (BN / TN);          // rows rg + i * kRowGroups
  const int cg = gt % (BN / TN);          // columns panel_col(cg, j)
  const int kbeg = grp * Cf::kSlice;
  const int nk = (p + KD - 1) / KD;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kPanelStages - 1; ++st) {
    if (st < nk)
      panel_load<BM, BN, KD, LDW, VEC>(sw + st * Cf::kWStage,
                                       sq + st * Cf::kQStage, w, q, row0,
                                       col0, st * KD, m, p, r);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kc = 0; kc < nk; ++kc) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPanelStages - 2));
    __syncthreads();   // chunk kc has landed; chunk kc - 1 is consumed
    const int pre = kc + kPanelStages - 1;
    const int ps = pre % kPanelStages;
    if (pre < nk)
      panel_load<BM, BN, KD, LDW, VEC>(sw + ps * Cf::kWStage,
                                       sq + ps * Cf::kQStage, w, q, row0,
                                       col0, pre * KD, m, p, r);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    const int cs = kc % kPanelStages;
    const float* tw = sw + cs * Cf::kWStage + rg * LDW + kbeg;
    const float* tq = sq + cs * Cf::kQStage + kbeg * BN +
                      panel_col<BN, TN>(cg, 0);
#pragma unroll
    for (int k4 = 0; k4 < Cf::kSlice; k4 += 4) {
      float wv[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(
            tw + i * Cf::kRowGroups * LDW + k4);
        wv[i][0] = x.x; wv[i][1] = x.y; wv[i][2] = x.z; wv[i][3] = x.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float qv[TN];
        panel_q_row<BN, TN>(tq + (k4 + kk) * BN, qv);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(wv[i][kk], qv[j], acc[i][j]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // the groups' partials, added in group order
  float* part = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      part[(grp * BM + rg + i * Cf::kRowGroups) * BN +
           panel_col<BN, TN>(cg, j)] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += kPanelThreads) {
    const int row = e / BN, c = e % BN;
    if (row0 + row >= m || col0 + c >= r) continue;
    float sum = part[e];
    for (int gi = 1; gi < Cf::kGroups; ++gi) sum += part[gi * BM * BN + e];
    out[static_cast<size_t>(row0 + row) * r + col0 + c] = sum;
  }
}

template <int BM, int BN, int TM, int TN, int KD>
int launch_panel(bool vec, const float* w, const float* q, float* out, int m,
                 int p, int r, cudaStream_t s) {
  using Cf = PanelCfg<BM, BN, TM, TN, KD>;
  const unsigned col_tiles = blocks_for(r, BN);
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(m, BM), col_tiles);
  auto kernel = vec ? panel_kernel<BM, BN, TM, TN, KD, true>
                    : panel_kernel<BM, BN, TM, TN, KD, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cf::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kPanelThreads, Cf::kSmem, s>>>(w, q, out, m, p, r);
  return static_cast<int>(cudaGetLastError());
}

size_t row_smem_bytes(int d) { return (d + 3) * kChunk * sizeof(float); }

}  // namespace rt

using namespace rt;

extern "C" {

int rt_quantized_cross_affinity(const float* x, const float* y, float gamma,
                                float* out, int n, int m, int d, int dtype,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = dispatch(dtype, d, [&](auto c) {
    using C = decltype(c);
    cross_affinity_kernel<C::kDt, C::kMaxD>
        <<<blocks_for(static_cast<long long>(n) * m, kCrossThreads),
           kCrossThreads, 0, s>>>(x, y, gamma, out, n, m, d);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// partial: (ceil(n / 256), m) scratch.
int rt_nystrom_colsum(const float* x, const float* z, float gamma,
                      const float* mask, float* partial, float* out, int n,
                      int m, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned panels = blocks_for(n, kColsumRows);
  const dim3 grid(panels, blocks_for(m, kColsumCols));
  const size_t smem = (d + 3) * kColsumRows * sizeof(float);
  const bool ok = dispatch(dtype, d, [&](auto c) {
    using C = decltype(c);
    colsum_partial_kernel<C::kDt, C::kMaxD>
        <<<grid, kColsumCols, smem, s>>>(x, z, gamma, mask, partial, n, m, d);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<blocks_for(m, 256), 256, 0, s>>>(partial, out, panels, m);
  return static_cast<int>(cudaGetLastError());
}

// out (m, r) = w (m, p) @ q (p, r) in exact f32, one launch of panel_kernel
// (kernel 6).  The TPU kernel walks row panels of block_rows in order to
// bound VMEM residency; here each block owns a short panel, and each
// output entry sums k in one fixed order whatever the panels (see kernel
// 6), so block_rows does not reach the kernel and the product is
// bit-identical for every block_rows.
int rt_panel_matmul(const float* w, const float* q, float* out, int m, int p,
                    int r, void* stream) {
  if (m < 1 || p < 1 || r < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && r % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (r <= 8) return launch_panel<16, 8, 4, 2, 128>(vec, w, q, out, m, p, r, s);
  return launch_panel<32, 64, 8, 8, 64>(vec, w, q, out, m, p, r, s);
}

// r: (n,), partial: (slabs, pairs, 128, 128) with pairs = T (T + 1) / 2 and
// T = ceil(m / 128), g and t: (m, m) scratch.
int rt_nystrom_gram(const float* x, const float* z, float gamma,
                    const float* u, const float* w_isqrt, const float* mask,
                    float* r, float* partial, float* g, float* t, float* out,
                    int n, int m, int d, int slabs, int slab_rows, int dtype,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = blocks_for(m, kGramTile);
  const long long pairs = tiles * (tiles + 1) / 2;
  if (n < 1 || m < 1 || slabs < 1 || slabs > 65535 || slab_rows < 1 ||
      pairs > 0x7fffffffLL ||
      static_cast<long long>(slabs - 1) * slab_rows >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch(dtype, d, [&](auto c) {
    using C = decltype(c);
    degree_kernel<C::kDt, C::kMaxD>
        <<<blocks_for(n, kRowThreads), kRowThreads, row_smem_bytes(d), s>>>(
            x, z, gamma, u, mask, r, n, m, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return;
    gram_tile_kernel<C::kDt, C::kMaxD>
        <<<dim3(static_cast<unsigned>(pairs), slabs), kGramThreads,
           GramSmem<C::kMaxD>::kBytes, s>>>(x, z, gamma, r, partial, n, m, d,
                                            slab_rows);
    err = cudaGetLastError();
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<dim3(static_cast<unsigned>(pairs),
                            (kGramTile / kReduceEdge) * (kGramTile / kReduceEdge)),
                       dim3(kReduceEdge, 8), 0, s>>>(partial, g, m, slabs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // the rotation: t = W^-1/2 G, out = t W^-1/2
  if ((err = static_cast<cudaError_t>(launch_rot(w_isqrt, g, t, m, s))) !=
      cudaSuccess)
    return static_cast<int>(err);
  return launch_rot(t, w_isqrt, out, m, s);
}

int rt_nystrom_extension(const float* x, const float* z, float gamma,
                         const float* u, const float* proj, const float* mask,
                         float* out, int n, int m, int d, int k, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (d + 3 + k) * kChunk * sizeof(float);
  const unsigned grid = blocks_for(n, kRowThreads);
  bool ok;
  if (k >= 1 && k <= 16) {
    ok = dispatch(dtype, d, [&](auto c) {
      using C = decltype(c);
      extension_kernel<C::kDt, C::kMaxD, 16><<<grid, kRowThreads, smem, s>>>(
          x, z, gamma, u, proj, mask, out, n, m, d, k);
    });
  } else if (k > 16 && k <= 64) {
    ok = dispatch(dtype, d, [&](auto c) {
      using C = decltype(c);
      extension_kernel<C::kDt, C::kMaxD, 64><<<grid, kRowThreads, smem, s>>>(
          x, z, gamma, u, proj, mask, out, n, m, d, k);
    });
  } else {
    ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
