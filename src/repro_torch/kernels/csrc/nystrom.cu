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
//   colsum     N*m = 5.1e7 affinity entries (~1.1 GFLOP) on 3.6 MB read:
//              operation-bound, ~17 us (kernel 2).
//   gram       the upper triangle of S^T S, N*m*(m + 1) = 2.6e10 FLOP in
//              exact f32 (no TF32), plus C once and the rotation:
//              operation-bound, ~0.42 ms; at the m = 4096 engine's shape
//              1.7e12 FLOP, ~29 ms (kernel 3).
//   extension  C once, C u and C proj (N*m*(2k + 2) FLOP more):
//              operation-bound, ~31 us (kernel 4).
//   cross      W = A(z, z), 512 x 512: 1 MB written, launch-bound; at
//              m = 4096, 67 MB written, byte-bound (~20 us):
//              cross_tile_kernel of affinity_tile.cuh, shared with B6.
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
// register-array bound; dispatch_exact (kernels 2 and 4) gives d = 8 (the
// cohort path's embedding width) its own instantiation with d known at
// compile time (kD = 8), so the dot's k < d guards fold away: 7-8 % off
// kernel 2 and 12 % off kernel 4 (PERF.md, section 6).  The arithmetic
// is the same either way: k < d selects the same terms in the same
// order.
// ---------------------------------------------------------------------------

template <int DT, int MAXD, int D = 0>
struct Cfg {
  static constexpr int kDt = DT;
  static constexpr int kMaxD = MAXD;
  static constexpr int kD = D;     // 0: d is a runtime value
};

template <int MAXD, int D = 0, typename F>
bool with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kF32: f(Cfg<kF32, MAXD, D>{}); return true;
    case kBF16: f(Cfg<kBF16, MAXD, D>{}); return true;
    case kINT8: f(Cfg<kINT8, MAXD, D>{}); return true;
    default: return false;
  }
}

template <typename F>
bool dispatch(int dtype, int d, F&& f) {
  if (d >= 1 && d <= 8) return with_dtype<8>(dtype, f);
  if (d > 8 && d <= 32) return with_dtype<32>(dtype, f);
  return false;
}

template <typename F>
bool dispatch_exact(int dtype, int d, F&& f) {
  if (d == 8) return with_dtype<8, 8>(dtype, f);
  return dispatch(dtype, d, f);
}

// ---------------------------------------------------------------------------
// shared piece: in-order reduction of per-block partials
// ---------------------------------------------------------------------------

// out[j] = sum_p partial[p, j], p ascending.  A thread has one column and
// many rows, a chain of dependent adds; one load at a time would make it
// wait a memory round trip a row.  So a block owns 16 columns: its 256
// threads copy a tile of kSumChunk rows x 16 columns to shared memory
// (every load in flight at once; one tile at N = 10^5), then one thread a
// column adds the tile's rows in order: the same sum as one row at a time.
constexpr int kSumCols = 16;
constexpr int kSumChunk = 512;
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int rows, long long cols) {
  __shared__ float tile[kSumChunk][kSumCols];
  const long long j0 = static_cast<long long>(blockIdx.x) * kSumCols;
  const int tid = threadIdx.x;
  const int c = tid % kSumCols;
  const bool col_in = j0 + c < cols;
  const float* src = partial + j0 + c;
  float acc = 0.f;
  for (int p0 = 0; p0 < rows; p0 += kSumChunk) {
    const int cnt = min(kSumChunk, rows - p0);
#pragma unroll
    for (int q = 0; q < kSumChunk * kSumCols / kSumThreads; ++q) {
      const int p = q * (kSumThreads / kSumCols) + tid / kSumCols;
      tile[p][c] = p < cnt && col_in ? src[(p0 + p) * cols] : 0.f;
    }
    __syncthreads();
    if (tid < kSumCols) {
#pragma unroll 8
      for (int p = 0; p < cnt; ++p) acc += tile[p][tid];
    }
    __syncthreads();
  }
  if (tid < kSumCols && col_in) out[j0 + tid] = acc;
}

// ---------------------------------------------------------------------------
// kernel 2: column sum (rt_nystrom_colsum)
// ---------------------------------------------------------------------------
//
// Bound at the select path's shape (N = 10^5, d = 8, m = 512): N*m =
// 5.1e7 affinity entries of 2d + 6 operations, 0.017 ms at 67 TFLOP/s;
// by operations.  An entry is ~22 instructions that the order below
// fixes (8 FMAs of the dot, 2 x.z, the norm sum and difference, the
// clamp, the gamma scale, expf's 8, the masked add), so the issue rate,
// not the FMA rate, is the limit (PERF.md, section 6, has the times).
//
// The summation order is the contract, not a choice: the cohort server's
// cold solve amplifies col's last bits through W^-1/2 (PERF.md, section 6), so
// col stays bit-identical to every earlier version of this kernel:
//   - the rows are cut into panels of kColsumRows = 256;
//   - partial[panel, j] sums the panel's rows ascending into one
//     accumulator, acc += affinity(x_t, z_j) * mask_t, the same expression
//     with the same operands (so the same FMA contraction);
//   - sum_rows_kernel adds the panels in index order.
// Within that order:
//   - A block of 128 threads owns one panel and a tile of kCols * 128
//     landmark columns.  Each thread keeps kCols landmarks in registers
//     (columns tid, tid + 128, ...: the partial stores stay coalesced), so
//     every panel row read serves kCols entries and the kCols sums are
//     independent chains.
//   - The panel's raw rows and mask arrive by cp.async (16-byte pieces
//     where x is 16-byte aligned) while the threads prepare their
//     landmarks; then each row is rounded to the tile precision once and
//     packed as (coordinates, |x|^2, mask, int8 scale, 0): MAXD / 4 + 1
//     float4 reads, the same address across the warp (a broadcast).
//   - At m = 512 (d <= 8: kCols = 4, a 512-column tile) that is 391 blocks,
//     all resident at once on 132 SMs; at m = 4096, 3128.

constexpr int kColsumRows = 256;     // rows a panel: the reduction tree
constexpr int kColsumThreads = 128;

template <int MAXD>
struct ColsumCfg {
  static constexpr int kCols = MAXD <= 8 ? 4 : 2;   // landmarks a thread
  static constexpr int kTile = kColsumThreads * kCols;
  static constexpr int kRow = MAXD + 4;              // floats a packed row
  static constexpr int kRawFloats = kColsumRows * MAXD + kColsumRows;
  static constexpr size_t kSmem =
      (size_t)(kRawFloats + kColsumRows * kRow) * sizeof(float);
};

template <int DT, int MAXD, int D>
__global__ void __launch_bounds__(kColsumThreads)
colsum_partial_kernel(const float* __restrict__ x,
                      const float* __restrict__ z, float gamma,
                      const float* __restrict__ mask,
                      float* __restrict__ partial, int n, int m, int d_in) {
  using Cf = ColsumCfg<MAXD>;
  const int d = D ? D : d_in;
  extern __shared__ float4 colsum_smem4[];
  float* raw = reinterpret_cast<float*>(colsum_smem4);   // rows * d, mask
  float* raw_mask = raw + kColsumRows * MAXD;
  float4* packed = colsum_smem4 + Cf::kRawFloats / 4;     // [t][kRow / 4]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kColsumRows;
  const int rows = min(kColsumRows, n - row0);
  const float* xp = x + static_cast<size_t>(row0) * d;
  stage_floats(raw, xp, rows * d,
               reinterpret_cast<uintptr_t>(xp) % 16 == 0);
  if (mask) stage_floats(raw_mask, mask + row0, rows, false);
  asm volatile("cp.async.commit_group;\n" ::);

  // this thread's landmarks, prepared while the panel is in flight
  float zv[Cf::kCols][MAXD], zn[Cf::kCols], zs[Cf::kCols];
  int j[Cf::kCols];
#pragma unroll
  for (int c = 0; c < Cf::kCols; ++c) {
    j[c] = blockIdx.y * Cf::kTile + c * kColsumThreads + tid;
    zn[c] = 0.f;
    zs[c] = 1.f;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) zv[c][k] = 0.f;
    if (j[c] < m)
      prepare_point<DT, MAXD>(z + static_cast<size_t>(j[c]) * d, d, zv[c],
                              zn[c], zs[c]);
  }

  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int t = tid; t < kColsumRows; t += kColsumThreads) {
    float pv[MAXD];
    float pn = 0.f, ps = 1.f;
#pragma unroll
    for (int k = 0; k < MAXD; ++k) pv[k] = 0.f;
    if (t < rows) prepare_point<DT, MAXD>(raw + t * d, d, pv, pn, ps);
    float4* row = packed + t * (Cf::kRow / 4);
#pragma unroll
    for (int q = 0; q < MAXD / 4; ++q)
      row[q] = make_float4(pv[4 * q], pv[4 * q + 1], pv[4 * q + 2],
                           pv[4 * q + 3]);
    const float mk = t < rows ? (mask ? raw_mask[t] : 1.f) : 0.f;
    row[MAXD / 4] = make_float4(pn, mk, ps, 0.f);
  }
  __syncthreads();

  float acc[Cf::kCols];
#pragma unroll
  for (int c = 0; c < Cf::kCols; ++c) acc[c] = 0.f;
#pragma unroll 2
  for (int t = 0; t < rows; ++t) {
    const float4* row = packed + t * (Cf::kRow / 4);
    float xv[MAXD];
#pragma unroll
    for (int q = 0; q < MAXD / 4; ++q) {
      const float4 v = row[q];
      xv[4 * q] = v.x; xv[4 * q + 1] = v.y; xv[4 * q + 2] = v.z;
      xv[4 * q + 3] = v.w;
    }
    const float4 tail = row[MAXD / 4];     // |x|^2, mask, int8 scale
#pragma unroll
    for (int c = 0; c < Cf::kCols; ++c)
      acc[c] += affinity<DT, MAXD>(xv, 1, tail.x, tail.z, zv[c], 1, zn[c],
                                   zs[c], d, gamma) * tail.y;
  }
#pragma unroll
  for (int c = 0; c < Cf::kCols; ++c)
    if (j[c] < m) partial[static_cast<size_t>(blockIdx.x) * m + j[c]] = acc[c];
}

// ---------------------------------------------------------------------------
// the Gram's degree pre-pass: one thread per client row, landmarks
// streamed through shared memory in chunks.  row_degree gives d^_i =
// sum_j C_ij u_j, j ascending.  (Kernel 4 sums its d^ in another order:
// each half of a block takes its landmarks ascending into one
// accumulator, then the first half's sum plus the second's.)
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
// kernel 4: extension (rt_nystrom_extension)
// ---------------------------------------------------------------------------
//
// out_i = v_i / max(|v_i|, 1e-12), v_i = r_i * sum_j C_ij proj_j, with
// d^_i = sum_j C_ij u_j and r_i = mask_i * rsqrt(max(mask_i * d^_i,
// 1e-12)): the function of the TPU kernel, which builds each C tile once
// in VMEM and takes S = diag(r) C.  Masked rows (r = 0) come out 0.
//
// Bound at the select path's shape (N = 10^5, d = 8, m = 512, k = 8):
// C once (2d + 5 a entry), C u and C proj (2 + 2k): 0.031 ms at 67
// TFLOP/s, by operations.  An entry is ~31 instructions (the affinity's
// 21, 9 FMAs, the landmark's loads over two rows), so the issue rate is
// the limit.  On the card (PERF.md, the kernel table): 0.085 ms at
// m = 512, 0.62 ms at m = 4096.
//
// Design:
//   - Each C entry is computed once: d^ and w = sum_j C_ij proj_j
//     accumulate in the same pass, and r scales w at the end (S =
//     diag(r) C, so S proj = r (C proj)).
//   - pack_landmarks_kernel rounds every landmark to the tile precision
//     once and packs it with its u and proj row: (coordinates, |z|^2,
//     int8 scale, u, 0, proj padded to a multiple of 4), a row of
//     MAXD + 4 + kp floats.
//   - A block owns 256 rows and has two halves of 128 threads.  A thread
//     owns two rows (tid and tid + 128 of its half), so every landmark
//     read serves two rows; the two halves take the two halves of every
//     ring stage's landmarks, which doubles the warps an SM holds (an
//     entry is a chain of ~20 dependent instructions, and 12 warps an SM
//     could not hide it).  The packed landmarks stream through a 2-stage
//     cp.async ring of kExtChunk rows (16-byte pieces); a thread reads a
//     landmark as float4 broadcasts.  At the end the second half hands
//     its d^ and w to the first through shared memory, which adds them
//     (first half + second half) and writes the rows.
//   - 391 blocks of 8 warps at N = 10^5, all resident at once on 132 SMs,
//     at m = 512 and at m = 4096 alike.
//   - w lives in registers, MAXK wide: three classes, k <= 8, 16 and 64.
//     At k = 8 the k <= 16 class takes 96 registers (2 blocks an SM, two
//     waves of blocks) where the k <= 8 class takes 64 (all resident):
//     17 % slower (PERF.md, section 6).
// Every sum has a fixed order (each half's landmarks ascending into one
// accumulator, then the halves' sums in order), with no atomics: a repeat
// call is bit-identical.

constexpr int kExtHalf = 128;      // threads of a half
constexpr int kExtThreads = 2 * kExtHalf;
constexpr int kExtRows = 2;        // rows a thread
constexpr int kExtBlockRows = kExtHalf * kExtRows;
constexpr int kExtChunk = 64;      // landmarks a ring stage, 32 a half

// floats of one packed landmark row
__host__ __device__ inline int ext_row_width(int maxd, int k) {
  return maxd + 4 + (k + 3) / 4 * 4;
}

// bytes of shared memory: the ring, or the second half's sums
inline size_t ext_smem_bytes(int maxd, int maxk, int k) {
  const size_t ring = 2 * kExtChunk * ext_row_width(maxd, k);
  const size_t sums = kExtBlockRows * (1 + maxk);
  return (ring > sums ? ring : sums) * sizeof(float);
}

template <int DT, int MAXD, int D>
__global__ void __launch_bounds__(128)
pack_landmarks_kernel(const float* __restrict__ z,
                      const float* __restrict__ u,
                      const float* __restrict__ proj,
                      float* __restrict__ packed, int m, int d_in, int k) {
  const int d = D ? D : d_in;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int lw = ext_row_width(MAXD, k);
  float zv[MAXD];
  float zn, zs;
#pragma unroll
  for (int q = 0; q < MAXD; ++q) zv[q] = 0.f;
  prepare_point<DT, MAXD>(z + static_cast<size_t>(j) * d, d, zv, zn, zs);
  float4* row = reinterpret_cast<float4*>(packed + static_cast<size_t>(j) * lw);
#pragma unroll
  for (int q = 0; q < MAXD / 4; ++q)
    row[q] = make_float4(zv[4 * q], zv[4 * q + 1], zv[4 * q + 2],
                         zv[4 * q + 3]);
  row[MAXD / 4] = make_float4(zn, zs, u[j], 0.f);
  float* pj = packed + static_cast<size_t>(j) * lw + MAXD + 4;
  for (int q = 0; q < lw - MAXD - 4; ++q)
    pj[q] = q < k ? proj[static_cast<size_t>(j) * k + q] : 0.f;
}

template <int DT, int MAXD, int D, int MAXK>
__global__ void __launch_bounds__(kExtThreads)
extension_kernel(const float* __restrict__ x,
                 const float* __restrict__ packed, float gamma,
                 const float* __restrict__ mask, float* __restrict__ out,
                 int n, int m, int d_in, int k) {
  const int d = D ? D : d_in;
  constexpr int KQ = MAXK / 4;      // float4 groups of proj, at most
  extern __shared__ float4 ext_smem4[];
  float* ring = reinterpret_cast<float*>(ext_smem4);
  const int lw = ext_row_width(MAXD, k);
  const int kq = (k + 3) / 4;       // float4 groups of proj, this call
  const int stage_floats_n = kExtChunk * lw;
  const int tid = threadIdx.x;
  const int half = tid / kExtHalf, lt = tid % kExtHalf;
  const int row0 = blockIdx.x * kExtBlockRows;

  // the chunk of landmarks c0 .. c0 + cnt - 1 into ring stage `st`
  auto load_chunk = [&](int st, int c0) {
    const int cnt = min(kExtChunk, m - c0);
    const float* src = packed + static_cast<size_t>(c0) * lw;
    float* dst = ring + st * stage_floats_n;
    for (int e = 4 * tid; e < cnt * lw; e += 4 * kExtThreads)
      panel_copy<true>(dst + e, src + e, true);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_chunk(0, 0);

  float xv[kExtRows][MAXD], xn[kExtRows], xs[kExtRows];
#pragma unroll
  for (int r = 0; r < kExtRows; ++r) {
    const int i = row0 + r * kExtHalf + lt;
    xn[r] = 0.f;
    xs[r] = 1.f;
#pragma unroll
    for (int q = 0; q < MAXD; ++q) xv[r][q] = 0.f;
    if (i < n)
      prepare_point<DT, MAXD>(x + static_cast<size_t>(i) * d, d, xv[r],
                              xn[r], xs[r]);
  }
  float dh[kExtRows], w[kExtRows][MAXK];
#pragma unroll
  for (int r = 0; r < kExtRows; ++r) {
    dh[r] = 0.f;
#pragma unroll
    for (int q = 0; q < MAXK; ++q) w[r][q] = 0.f;
  }

  const int nchunks = (m + kExtChunk - 1) / kExtChunk;
  for (int c = 0; c < nchunks; ++c) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk c has landed; chunk c - 1 is consumed
    if (c + 1 < nchunks) load_chunk((c + 1) % 2, (c + 1) * kExtChunk);
    const float* stage = ring + (c % 2) * stage_floats_n;
    const int cnt = min(kExtChunk, m - c * kExtChunk);
    // this half's landmarks of the chunk
    const int t_end = min(cnt, (half + 1) * (kExtChunk / 2));
#pragma unroll 4
    for (int t = half * (kExtChunk / 2); t < t_end; ++t) {
      const float4* lm = reinterpret_cast<const float4*>(stage + t * lw);
      float zv[MAXD];
#pragma unroll
      for (int q = 0; q < MAXD / 4; ++q) {
        const float4 v = lm[q];
        zv[4 * q] = v.x; zv[4 * q + 1] = v.y; zv[4 * q + 2] = v.z;
        zv[4 * q + 3] = v.w;
      }
      const float4 tail = lm[MAXD / 4];   // |z|^2, scale, u
      float a[kExtRows];
#pragma unroll
      for (int r = 0; r < kExtRows; ++r) {
        a[r] = affinity<DT, MAXD>(xv[r], 1, xn[r], xs[r], zv, 1, tail.x,
                                  tail.y, d, gamma);
        dh[r] = fmaf(a[r], tail.z, dh[r]);
      }
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        if (q < kq) {
          const float4 pv = lm[MAXD / 4 + 1 + q];
#pragma unroll
          for (int r = 0; r < kExtRows; ++r) {
            w[r][4 * q] = fmaf(a[r], pv.x, w[r][4 * q]);
            w[r][4 * q + 1] = fmaf(a[r], pv.y, w[r][4 * q + 1]);
            w[r][4 * q + 2] = fmaf(a[r], pv.z, w[r][4 * q + 2]);
            w[r][4 * q + 3] = fmaf(a[r], pv.w, w[r][4 * q + 3]);
          }
        }
      }
    }
  }

  // the second half's sums to the first, through shared memory
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();     // every half is done with the ring
  float* sums = ring;  // [row slot][1 + MAXK]
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < kExtRows; ++r) {
      float* slot = sums + (r * kExtHalf + lt) * (1 + MAXK);
      slot[0] = dh[r];
#pragma unroll
      for (int q = 0; q < MAXK; ++q)
        if (q < k) slot[1 + q] = w[r][q];
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < kExtRows; ++r) {
    const int i = row0 + r * kExtHalf + lt;
    if (i >= n) continue;
    const float* slot = sums + (r * kExtHalf + lt) * (1 + MAXK);
    const float mk = mask ? mask[i] : 1.f;
    const float rr = mk * rsqrtf(fmaxf(mk * (dh[r] + slot[0]), kEps));
    float v[MAXK];
    float sq = 0.f;
#pragma unroll
    for (int q = 0; q < MAXK; ++q) {
      v[q] = q < k ? (w[r][q] + slot[1 + q]) * rr : 0.f;
      sq = fmaf(v[q], v[q], sq);
    }
    const float norm = fmaxf(sqrtf(sq), kEps);
#pragma unroll
    for (int q = 0; q < MAXK; ++q)
      if (q < k) out[static_cast<size_t>(i) * k + q] = v[q] / norm;
  }
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

// out (n, m) = A(x, y) at the tile precision `dtype`: one launch of
// cross_tile_kernel (affinity_tile.cuh) with the wrapper's rows a tile.
int rt_quantized_cross_affinity(const float* x, const float* y, float gamma,
                                float* out, int n, int m, int d, int dtype,
                                int rows, void* stream) {
  switch (dtype) {
    case kF32:
      return launch_cross_tile<kF32>(x, y, gamma, out, n, m, d, rows, stream);
    case kBF16:
      return launch_cross_tile<kBF16>(x, y, gamma, out, n, m, d, rows,
                                      stream);
    case kINT8:
      return launch_cross_tile<kINT8>(x, y, gamma, out, n, m, d, rows,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// partial: (ceil(n / 256), m) scratch.
int rt_nystrom_colsum(const float* x, const float* z, float gamma,
                      const float* mask, float* partial, float* out, int n,
                      int m, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned panels = blocks_for(n, kColsumRows);
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch_exact(dtype, d, [&](auto c) {
    using C = decltype(c);
    using Cf = ColsumCfg<C::kMaxD>;
    const auto kernel = colsum_partial_kernel<C::kDt, C::kMaxD, C::kD>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Cf::kSmem));
    if (err != cudaSuccess) return;
    kernel<<<dim3(panels, blocks_for(m, Cf::kTile)), kColsumThreads,
             Cf::kSmem, s>>>(x, z, gamma, mask, partial, n, m, d);
    err = cudaGetLastError();
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_rows_kernel<<<blocks_for(m, kSumCols), kSumThreads, 0, s>>>(
      partial, out, panels, m);
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

// packed: (m, ext_row_width(MAXD, k)) scratch, MAXD = 8 for d <= 8 and
// 32 above: the landmarks rounded and packed with u and proj.
int rt_nystrom_extension(const float* x, const float* z, float gamma,
                         const float* u, const float* proj, const float* mask,
                         float* packed, float* out, int n, int m, int d,
                         int k, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || k < 1 || k > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const bool ok = dispatch_exact(dtype, d, [&](auto c) {
    using C = decltype(c);
    pack_landmarks_kernel<C::kDt, C::kMaxD, C::kD>
        <<<blocks_for(m, 128), 128, 0, s>>>(z, u, proj, packed, m, d, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return;
    const unsigned grid = blocks_for(n, kExtBlockRows);
    auto launch = [&](auto kernel, int maxk) {
      const size_t smem = ext_smem_bytes(C::kMaxD, maxk, k);
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return;
      kernel<<<grid, kExtThreads, smem, s>>>(x, packed, gamma, mask, out, n,
                                             m, d, k);
      err = cudaGetLastError();
    };
    if (k <= 8)
      launch(extension_kernel<C::kDt, C::kMaxD, C::kD, 8>, 8);
    else if (k <= 16)
      launch(extension_kernel<C::kDt, C::kMaxD, C::kD, 16>, 16);
    else
      launch(extension_kernel<C::kDt, C::kMaxD, C::kD, 64>, 64);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // extern "C"
